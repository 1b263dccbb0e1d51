#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device    — the card's name, and its name and power limit from nvidia-smi.
2. build     — builds the five kernel libraries from csrc/ (one nvcc per
               source, sm_90a, all started together) and times the build.
3. kernels   — the conv kernel against its plain PyTorch version at every
               distinct conv shape of LeNet and VGG16-CIFAR10 (every bucket
               the server runs, 1-32 rows, batch 128, and LeNet's training
               batch 64), of VGG16-224 (batch 1 and 8, and the training
               batch 128) and VGG16-BN's linear convs (batch 32 and 128),
               plus every fused activation at one shape.
               TF32 is off for the plain and library versions.  At batch
               32, 128 and VGG16-224's 8 and 128, per shape and summed per
               set (every conv of the model's forward, a repeated shape
               as often as it runs): errors, median times of the kernel,
               the plain version,
               the library call (cuDNN conv + activation) in f32 and,
               labelled as the less accurate function, with TF32 on;
               FLOPs (taps inside the image only), bytes, the bound of
               f32-accurate products on the tensor cores (3xTF32) and,
               beside it, the bound of f32 FMAs on the CUDA cores, at the
               published H100 SXM peaks.  The conv library's SASS must
               hold HGMMA (wgmma) instructions; their count is on the
               line.
4. xent_dropout_kernels — the softmax-xent kernel against its plain
               version (loss and gradient, rtol = atol = 1e-5) at [128,
               1000], [256, 512], 997 rows, V = 50,257, V not a multiple
               of 4, rows not 16-byte aligned, one row, both sides of
               the warp path's 2,048, the widest row a cluster's
               registers hold (131,072) and wider rows, whose further
               elements stream (262,144 and an unaligned 131,073), with
               the plan of each (a warp or a cluster per row); timed at
               [128, 1000] and [64, 50257] beside an empty kernel on the
               same grid (the least any launch takes); the dropout
               kernel against its plain version with torch.equal, forward
               and backward, at [128, 25088], [128, 4096], an element count
               that is not a multiple of 4 and an unaligned view, at
               retain 0.5 and 0.8.  Times at the training path's shapes
               beside bytes, bound, plain and library times; dropout's
               forward (input cold in device memory) and backward (the
               gradient warm in L2) are timed apart.  Below the dropout
               gate, the hash kernel's host time against the dense path's.
5. serve     — the main path of serving: LeNet and VGG16-CIFAR10 (seeded
               random weights, written as zips) served by ``Server`` over
               HTTP on localhost: a ``warmup`` RPC per model, then 64
               ``predict`` requests of 1-4 rows per model from 8 client
               threads.  Classes must equal argmax of a direct
               ``output()``; the conv kernel's launch count, zeroed after
               the warm-up just before the requests, must equal the convs
               of the batches served, and no conv may take the dense chain.
6. vgg16_224 — ``output()`` of VGG16 at 224x224, batch 8, three timed
               calls (median reported), checked against a forward through
               the plain conv.
7. train_vgg16_224 — the main path of training: ``vgg16(dropout=0.5)``,
               seeded random weights and data, batch 128, Nesterovs, 3
               ``fit`` steps; every step must launch 13 conv, 1 xent and 4
               dropout kernels (2 layers, forward and backward).  The last
               step is then repeated from the same params, updater state
               and seed words with every kernel replaced by its plain
               version; score and updated params must agree and the
               dropout masks be identical.
8. train_lenet — ``lenet()`` with Adam, batch 64, 16 ``fit`` passes over
               50 batches (800 steps, seconds of training): 2 conv launches
               per step, no xent (vocab 10) and no dropout.  Samples/s is
               all samples over all the time.
8b. train_lenet_pipeline — LeNet + Adam, batch 64, one epoch of
               ``MnistDataSetIterator`` (the 8,192-row stand-in unless
               MNIST's files are cached; the line says which) through an
               ``AsyncDataSetIterator`` that runs ``ImagePreProcessingScaler``
               on its worker and stages each batch onto the card as the
               step takes it (the line names the route: a pageable copy on
               the step's stream under PINNED_STAGING_BYTES, else pinned
               on the side stream): exactly 2 conv launches a step, every
               batch through the pipeline, the most transformed batches
               ever waiting on the host (``ready_high_water``) within the
               staging depth; then
               ``evaluate`` on the test split through the same pipeline
               (2 conv launches a batch, accuracy at least 0.9).  First,
               4 steps of ``fit`` through the default pipeline against the
               same 4 fed synchronously (``pipeline_workers=0``) from the
               same params, under cuDNN's deterministic algorithms: equal
               parameters and score (``torch.equal``).
8c. gateway_fit_evaluate — a LeNet zip and 9 exported ``.npz`` shards of
               64 rows (the last 40) through the gateway over HTTP: ``fit``
               (exactly 2 conv launches a batch), ``evaluate`` (equal to a
               direct ``evaluate()`` of the written zip on the same
               shards), then ``predict``, which must serve the trained
               parameters (within the whole-network tolerance of a direct
               ``output()``, and away from the initial ones).
8d. keras_vgg16_bn — VGG16 with batch normalization for CIFAR-10 (the
               public Keras recipe, ``keras_vgg16_bn_config``; 13 linear
               3x3 convs each followed by relu, BatchNormalization and
               Dropout or a max pool; 14,991,946 params, 9,472 running
               statistics) imported through the port's Keras import from
               its configuration and seeded Keras-layout weight arrays
               (a dict lookup, no h5py; running means off 0, variances in
               [0.5, 1.5]); ``output()`` at batch 32 and 128, five timed
               calls each (median reported): exactly 13 conv launches a
               forward, against a forward through the plain conv within
               the whole-network tolerance; peak memory.
8e. train_keras_vgg16_bn — the imported VGG16-BN, 3 timed ``fit`` steps
               at batch 128 (SGD at the importer's defaults) on a seeded
               CIFAR-shaped batch and a fourth that keeps its layer
               outputs: exactly 13 conv and 20 dropout launches a step
               (10 DropoutLayers, forward and backward); the fourth
               step against the plain step from the same params, updater
               state, BN statistics, seed words, relu masks and
               max-pool argmax (score 1e-4, updates 5e-4 and BN running
               mean and var 1e-4 in relative 2-norm, dropout masks
               identical, and where the plain forward's own relu or
               argmax decision differs, a near tie within 1e-4 of the
               layer's scale); then ``evaluate`` on 1,024
               seeded rows (13 conv launches a batch of 128).
               Samples/s over steps 2-3, step seconds, peak memory over
               steps 1-3.
8f. new_layers — small nets of the layers and preprocessors Keras import
               brought (``new_layer_nets``: ZeroPadding, LRN, batch norm,
               Activation, GlobalPooling over NCHW and over a masked
               sequence, Embedding on indices and on one-hot rows, a
               LossLayer head, RnnToCnn, Composable(CnnToRnn)) on the card
               against the same nets on the CPU in this process, from the
               same params and state: ``output()``, then one ``fit`` step
               with the same seed words (score, params and state, rtol
               1e-4, atol 1e-5).
8g. resnet50_kernels — the conv kernel against its plain version at every
               distinct stride-1 conv shape of ResNet-50 (1x1 and 3x3,
               Cin 64-2,048 at 56/28/14/7 px) at the training batch 128
               and at every bucket of the serve ladder (1-32 rows); at
               batch 128 each shape timed as in phase 3, and the set of
               the 46 stride-1 convs of one forward summed: kernel, plain,
               cuDNN f32 and TF32, and the 3xTF32 and f32 bounds.
8h. serve_resnet50 — ResNet-50 (``resnet50()``: 224x224, 1,000 classes, 174
               vertices, 25,583,592 params, 53,120 running statistics;
               seeded weights, ``resnet_weights``) written as a zip and
               served by one ``Server`` (max_batch 32) over HTTP: a
               ``warmup`` RPC, then 16 ``predict`` requests of 1-2 rows
               from 4 client threads.  Classes must equal argmax of a
               direct ``output()``; exactly 46 conv launches and 7 conv
               fallbacks (the 7x7/2 stem and six 1x1/2 convs) per served
               batch.  Then ``output()`` at batch 32, five timed calls
               (median reported), 46 launches each, against a forward
               through the plain conv within the whole-network tolerance.
8i. train_resnet50 — the main path of graph training: ``resnet50()``
               (Nesterovs, lr 0.1) from the same seeded weights, 3 timed
               ``fit`` steps at batch 128 on seeded synthetic 224x224
               batches through the async pipeline (``AsyncMultiDataSetIterator``
               staging each batch onto the card), cuDNN's TF32 off so the
               7 dense-chain convs compute f32 like the JAX reference:
               exactly 46 conv and 1 xent launches a step.  A fourth step
               keeps its relu outputs and max-pool input and is held to
               the plain graph step from the same params, updater state
               and BN statistics (plain conv, plain xent, relu masks and
               max-pool argmax pinned, padding included): score 1e-4,
               updates 5e-4 and BN running mean and var 1e-4 in relative
               2-norm, and near ties within 1e-4 of a layer's scale where
               the plain forward's own decision differs.  Samples/s over
               steps 2-3, peak memory over steps 1-3.
8j. transfer_vgg16_224 — transfer learning as dl4j-examples 0.8's
               ``EditAtBottleneckOthersFrozen``: ``vgg16(dropout=0.5)``
               with seeded weights written as a zip (timed) and restored,
               then ``TransferLearning.Builder``: Nesterovs lr 5e-5, layers
               0-17 (13 convs, 5 pools) frozen, fc2 cut to 1,024 outputs
               (xavier), the 1,000-class head replaced by Dense(256, relu)
               and a 5-class softmax.  20 ``fit`` steps at batch 32 (2
               epochs of 320 seeded 224x224 images in 5 classes) with
               ScoreIterationListener(5), CollectScoresIterationListener and
               PerformanceListener: exactly 13 conv and 3 dropout launches
               a step (fc1 reads the frozen stack, which takes no gradient,
               so its dropout has no backward), no conv backward
               (``_ConvBiasAct.backwards``), no conv fallback; frozen params
               ``torch.equal`` before and after; 20 collected scores; the
               last step against the plain step (the rules of phase 7).
               Samples/s over steps 2-20 beside phase 7's full step, step
               ms, peak memory.
8k. featurize_vgg16_224 — ``TransferLearningHelper(net, 17)``: the head
               (``unfrozen_network``) on the features of a batch equals the
               whole net on its images (NET_RTOL / NET_ATOL); then the 320
               images featurized at batch 32 (13 conv launches a batch,
               images/s) and the head fit on the features for 2 epochs (3
               dropout launches a step).
8l. early_stop_and_resume — on the featurized head: ``EarlyStoppingTrainer``
               (MaxEpochs(10), ScoreImprovementEpoch(2), a
               ``DataSetLossCalculator`` on the last 64 rows held out, a
               ``LocalFileModelSaver``): the best model's zip read back
               gives the output the saved net gave and ``get_best()``'s,
               scores finite; its host ms a step beside a plain ``fit`` over
               the same batches.  Then, under cuDNN's deterministic
               algorithms, 2 epochs at batch 16 with a CheckpointListener
               every 4 iterations, cut by an exception of the phase's own
               after 10 batches of the second epoch (the phase asserts it
               was raised), and finished by a fresh head under
               ``fault_tolerance(resume=True)``: params and updater state
               ``torch.equal`` to the uncut fit's.
8m. transfer_resnet50 — ``TransferLearning.GraphBuilder`` on phase 8h's
               calibrated ResNet-50: every vertex through ``gap`` frozen,
               ``fc`` replaced by a 5-class ``fc5``; 5 ``fit`` steps at
               batch 32: exactly 46 conv launches and 7 conv fallbacks a
               step, no conv backward, frozen params and batch-norm
               statistics ``torch.equal``; the last step against the plain
               graph step (phase 8i's rules; the statistics equal).
               Samples/s beside phase 8i's, peak memory.
8n. keras_functional — a small functional residual net (Conv2D,
               BatchNormalization, Activation, Add, Concatenate,
               GlobalAveragePooling2D, Dense; ``keras_functional_config``)
               imported as a ComputationGraph from its Keras configuration
               and seeded weight arrays (no h5py): ``output()`` and one
               ``fit`` step on the card against the same graph on the CPU
               (the new_layers rule).
8o. bf16_kernels — the bf16 forms (``precision("bfloat16")``'s kernels):
               the conv's against its plain version (bf16 inputs upcast,
               f32, one rounding) by the bf16 conv rule (BF16_CONV_ATOL:
               equal or one bf16 ulp apart, or within 1e-5 of the output's
               scale), with the shares that differ, on one 32-row batch of
               each served model, VGG16-224 at 8 and 128, ResNet-50's 46
               stride-1 convs at 128 and the text CNN's D = 300 set (the
               full-width route), each distinct shape timed by CUDA events
               and each set replayed from a CUDA graph, beside cuDNN bf16
               and the bf16 bound (FLOPs at PEAK_BF16_FLOPS or 2-byte
               elements); checked untimed on the serving ladders; bf16
               HGMMA in the SASS of all four instances.  Dropout's bf16
               form ``torch.equal`` to its plain version forward and
               backward at VGG16-224's four launches and the edges, its
               masks the f32 form's, timed beside ``F.dropout`` on bf16.
8p. train_vgg16_224_bf16 — phase 7's network under precision("bfloat16"),
               3 timed ``fit`` steps at 128: exactly 13 bf16 conv, 1 (f32)
               xent and 4 bf16 dropout launches a step, 13 conv backwards,
               no conv or dropout fallback; masters, updater state and
               gradients f32.  The third step records its layer outputs:
               the kernel's 13 outputs against the plain version on the
               step's own conv inputs; the step against the plain bf16
               step (max-pool argmax pinned, the same seed words; score,
               updates and near ties by the BF16_* rules, dropout masks
               equal and the f32 form's) and against the f32 kernel step
               from the same state (update cosine at least 0.98).
               Samples/s and peak memory (steps 1-2) beside phase 7's.
8q. train_resnet50_bf16 — phase 8i's graph under precision("bfloat16"),
               from seeded_resnet50(batch_norms=False) with each residual
               branch's last gamma 0 (zero-gamma), 10 timed steps at
               128 and an eleventh: exactly 46 bf16 conv and 1 xent launches
               and 7 dense-chain convs a step; masters, updater state, BN
               statistics and gradients f32; the fourth (cuDNN
               deterministic) against the plain version conv by conv on
               its own inputs, against the plain bf16 graph step (relu
               masks and max-pool argmax pinned; score, updates, BN
               statistics, BN-fed biases' noise and near ties by the BF16_*
               rules), against the f32 kernel step (update cosine at
               least 0.98), and the plain step with its conv summed in
               the kernel's order (no kernel) against the plain step by
               the same rules, that the state allows the comparison.
8r. serve_bf16 — VGG16-224 ``output()`` at 8 and 32 rows and ResNet-50's
               (seeded_resnet50(batch_norms=False)) at 32 under
               precision("bfloat16"): float32 probabilities within
               BF16_PROBS_REL of the f32 net's on the same params (and
               ResNet-50's centred log-probabilities within
               BF16_LOGITS_REL),
               13 and 46 bf16 conv launches a forward, ms and peak memory;
               the bf16 ResNet-50 written as a zip and served by one
               ``Server`` to 4 clients (16 requests of 1-2 rows): exactly
               46 bf16 conv launches and 7 fallbacks a served batch, each
               request's classes those of a direct bf16 ``output()`` of its
               rows at one of the ladder's batch sizes, the rows' classes
               spread over the input.
9. lstm_kernel — the peephole-LSTM step kernel against its plain version
               (c', h', rtol = atol = 1e-5) at (N, H) = (32, 200), (4, 200),
               (1, 200), (3, 8), (5, 24), (64, 256), and at the tiling's
               edges (3, 1024) (four k-chunks a warp), (7, 264) (a ragged
               chunk) and (40, 8) (a ragged row block); a 2-layer ``lstm_scan``
               over 50 steps through the kernel against the same scan
               through the plain step (outputs, final states and every
               param's gradient within 1e-4 relative 2-norm), unmasked,
               masked and reversed; the step timed at the main paths'
               (32, 200), (4, 200) and (1, 200) by replaying a CUDA graph
               of 50 steps, beside the plain step and the bound.
10. train_charrnn — the main path of recurrent training: ``char_rnn(V,
               200, 2)`` (RMSProp, TBPTT 50) on ``CharacterIterator`` over
               the repo's SURVEY.md (V = 107), sequences of 1,000, batch
               32, 8 minibatches (160 segments) through ``fit``; each must
               launch exactly 2,000 lstm steps and no other kernel (V < 128
               keeps the loss dense).  Then one segment through the kernel
               against the same segment through the plain step, from the
               same params, updater and RNN state: score to 1e-5 relative,
               each param's update to 5e-4 relative 2-norm.  Chars/s over
               minibatches 2-8, score per minibatch, peak memory.
11. sample_charrnn — the main path of sampling: ``rnn_time_step`` on 4
               streams for 300 characters (2 launches per call, one per
               layer for all streams), then ``sample_text`` once; then
               ``rnn_time_step`` fed one character at a time must equal
               ``output()`` on the same 50 characters within 1e-5.
12. flash_kernels — the flash forward, dQ and dK/dV kernels against their
               plain versions (rtol = atol = 1e-5, TF32 off) at (B, H, T, D)
               = (4, 8, 8192, 64) causal (the training path's shape),
               (1, 2, 8192, 64) causal, (2, 2, 200, 64) masked from
               position 180, head dims 32, 96 and 128, T = 130, and a batch
               row that is fully masked (out 0, lse -1e30); each kernel
               timed at the training path's (4, 8, 8192, 64), causal (the
               forward with its split pre-pass), beside its plain version,
               its bound, and
               ``F.scaled_dot_product_attention`` f32 (forward, and forward
               + backward; timed only).
13. train_attention — the main path of attention training: ``attention_lm``
               (2 x causal SelfAttentionLayer(512, 8 heads), head dim 64,
               Adam, 1,534,059 params) on ``CharacterIterator`` over
               SURVEY.md (V = 107), 8 ``fit`` steps of 4 x 8,192 characters;
               each step must launch exactly one forward, one dQ and one
               dK/dV kernel per attention layer and nothing else, with no
               attention call on the dense chain; peak memory must stay
               below one dense [4, 8, 8192, 8192] f32 score tensor.  Then
               one step at T = 2,048 through the kernels against the same
               step through the plain versions, from the initial params
               with Wq/Wk x 4 and layer 0's Wv/Wo x 10 (so both layers'
               q/k gradients are well conditioned): the score to 1e-5
               relative, each param's gradient to 1e-4 and Adam update to
               5e-4 in relative 2-norm (bk by output invariance).
14. output_attention — ``output()`` at 4 x 8,192, three timed calls, one
               forward launch per layer each.
15. sample_attention — 4 streams x 300 characters through ``rnn_time_step``
               (the KV ring, no kernel) and ``sample_text``; the streams'
               outputs must equal ``output()`` on the 300-character prefix
               (through the forward kernel) within 1e-5.
16. w2v_step — the embedding trainers' steps (plain torch, no Pallas
               kernel on this path): ``skipgram_step``, ``cbow_step`` (W =
               11) and ``infer_step`` at full width (V = 71,290, text8's
               vocabulary at min count 5; D = 128; B = 2,048; K = 6; HS and
               NS on; C = the seeded vocabulary's longest Huffman code) on
               the card against the port's CPU functions on the same seeded
               inputs (Zipf-heavy duplicates, a padded tail), by
               W2V_STEP_RTOL; CUDA-event ms, host enqueue ms, device
               activities and busy ms a flush (``torch.profiler``), bytes
               and the bytes bound.
17. train_word2vec — the main path: ``Word2Vec.Builder()...build().fit()``
               with bench.py's protocol (layer 128, window 5, 5 negatives,
               no HS, min frequency 1, 1 epoch, batch 2,048) on
               ``text8_scale_corpus`` (1,000,000 seeded tokens in 20-word
               sentences over exactly 71,290 words, 20 planted topics):
               words/s, pairs/s, flushes, host ms of pair generation, peak
               memory, then the first 1,000 sentences again under the
               profiler (idle share, activities and host ms a flush).  The
               50 most frequent topic words' 10 nearest words must share
               their topic at W2V_TOPICAL_MIN or more on the trained
               table, and less on the initial one.
18. embeddings_card_vs_cpu — small ParagraphVectors (DBOW and DM, with
               ``infer_vector``), GloVe and DeepWalk fits on the card
               against the same fits on the CPU (W2V_FIT_RTOL; GloVe's
               loss W2V_GLOVE_LOSS_RTOL), and a ParagraphVectors zip
               written on the card and read on the CPU: equal vocabulary,
               codes, points and tables.
19. textcnn_kernels — the conv kernel's full-width route (a filter as wide
               as its input: OW = 1) at the text CNN's convs, [32, 1, 256,
               D] x [100, 1, h, D] for h = 3, 4, 5 at D = 300 and 128,
               against its plain version and timed as in phase 3 (cuDNN
               f32 and TF32, the 3xTF32 bound), summed per D; the plan
               must be the full-width route's and both of its instances
               must hold HGMMA.
20. train_textcnn — the text CNN (``textcnn_conf``: Kim 2014's three
               branches of 100 maps, max over time, merged, dropout 0.5 on
               the softmax layer's input, Adam lr 0.01) as a
               ComputationGraph over the Word2Vec of phase 17: documents
               of 12 same-topic sentences of its corpus (240 tokens),
               class "low" for topics below 10, batches of 32 from
               ``CnnSentenceDataSetIterator`` (one gather from the
               card's table), ``fit`` through the async pipeline for 3
               epochs: exactly 3 conv and 2 dropout launches a step, no
               conv on the dense chain; step 3 against the plain graph
               step (the same hash dropout masks, the global max pools'
               argmax pinned; score 1e-4, updates 5e-4); ``evaluate`` on
               the held-out fifth, accuracy at least
               TEXTCNN_MIN_ACCURACY.  Samples/s, peak memory, the
               iterator's ms a batch alone and 20 steps under the
               profiler (busy ms and idle share).
21. cluster_tsne — ``KMeansClustering(k=20)`` on the trained table
               (71,290 x 128): seconds, iterations and the share of topic
               words whose cluster's majority is their topic; Lloyd's loop
               from one set of centres on the card and on the CPU (centres
               1e-5; equal assignments but for words whose two clusters
               the centres' difference can swap); exact
               ``Tsne`` of the 10,000 most frequent words at the
               reference's defaults (1,000 iterations): seconds, peak
               memory, the share of each topic word's 10 nearest map
               points in its topic, at least TSNE_KEEP of that share by
               cosine in the table; ``_x2p_dense`` and the loop from one
               y0, card against CPU.
22. nearest_neighbors — the whole table's VPTree (cosine), built and
               timed; a ``NearestNeighborsServer`` over the 2,000 most
               frequent words answers 100 /knn and 100 /knnnew requests
               from 4 clients; each answer against brute force from one
               GEMM on the card, up to ties.

23. fused_lenet — ``fit(fused_steps=8)`` of LeNet + Adam at 64 through the
               async pipeline, 400 steps, against 400 plain steps from the
               same params and generator under cuDNN's deterministic
               algorithms: params, updater state and score torch.equal,
               exactly 2 conv launches a step, no conv fallback, no call
               inside a group that synchronises with the card (torch's
               sync debug mode); the same for a LeNet-shaped
               ComputationGraph at K = 4; samples/s fused and plain in
               turns.
24. pretrain_vae — dl4j-examples' VariationalAutoEncoderExample (784 ->
               256, 256 -> 2 -> 256, 256 -> Bernoulli over 784, RMSProp):
               200 ``pretrain`` steps at 128 on seeded MNIST-like strokes;
               the negative ELBO falls; one step's gradients,
               ``reconstruction_log_probability`` and
               ``generate_at_mean_given_z`` against the CPU's from the same
               params, pixels and ε; a zip written, restored and written
               again byte-equal.
25. pretrain_dbn — dl4j-examples' DeepAutoEncoderExample (binary RBMs 784 ->
               1000 -> 500 -> 250 -> 100 -> 30 and back, an MSE sigmoid
               output, batch 1,000): ``pretrain``, 3 ``fit`` steps, 5
               iterations of ``Solver("LINE_GRADIENT_DESCENT")``; the first
               RBM's reconstruction error and its data's free energy less
               the shuffled pixels' fall, the line search's scores fall and
               its first iteration equals the CPU's.
26. center_loss_lenet — LeNet with a ``CenterLossOutputLayer`` head (alpha
               0.1, lambda 2e-4), Nesterovs, 30 steps at 64: 2 conv
               launches a step, the last step against the plain conv
               chain's (phase 7's rules), the centres nearer their classes'
               feature means.
27. external_gradients_vgg16_224 — phase 7's net: ``backprop_gradient`` at 32
               against autograd of <output, ε> through the plain conv
               chain; the external loop (ε of the xent from
               ``feed_forward(train=True)``, the generator rewound,
               ``backprop_gradient(train=True)``, ``apply_gradients``) at
               128 against one ``fit`` step (phase 7's rules); exactly 13
               conv, then 26 conv and 6 dropout, then 13 conv, 1 xent and 4
               dropout launches.

28. dl4j_zip_serve — VGG16-CIFAR10 and the seeded ResNet-50 exported in the
               Java DL4J schema (``nn/dl4j_migration``) and restored on the
               card by ``load_model``: params equal, a second export
               byte-equal; the migrated VGG16 served to 8 clients (classes
               as a direct ``output()``, 13 conv launches a batch, the
               plain conv chain's output); the five frozen Java fixtures
               on the card against the CPU port.
29. serve_quantized — VGG16-CIFAR10 and ResNet-50 served from zips whose
               configuration sets ``infer_quant`` (int8, fp8) and from a
               dense zip: latency p50 / p99, resident weight bytes, served
               classes against a direct quantized ``output()``, the
               quantized output against the plain conv chain on the same
               dequantized weights, top-1 agreement with the dense net
               (margin-conditioned for VGG16, reported for ResNet-50).
30. graph_tbptt_charrnn — the char-RNN as a ComputationGraph from the
               network's initial params, graph TBPTT on phase 12's 8
               minibatches: updates and scores against the network's,
               lstm launches, chars/s; sampling through the graph's
               ``rnn_time_step`` equal to the network's; stored-state
               activations against the stepped forward.
31. checkpointed_vgg16_224 — one VGG16-224 step at 128 with
               ``gradient_checkpointing`` against one without from the same
               state and seed words: updates, score, dropout masks, peak
               memory, seconds, conv and dropout launches.
32. bucketed_fit — LeNet + Adam on ragged batch sizes and the char-RNN on
               ragged masked lengths, bucketed against unbucketed from the
               same params: updates, training signatures, launches,
               samples/s.
33. decode_charrnn — the char-RNN of phase 12 served by ``Server`` over
               HTTP to 32 concurrent decode sessions (``decode_slots``
               32), opened 15 ms apart, 200 one-token ``decode_step``s
               each, every fourth closing half-way for a new session:
               each stream against ``rnn_time_step`` of that stream
               (LSTM_TOL), exactly two lstm launches a pool dispatch and
               no fallback; tokens/s, p50 / p99 per RPC, the mean joined
               batch.  Then the bf16 char-RNN, 50 steps a session, by
               ``sample_charrnn_bf16``'s rule, on the step's bf16 form.
34. decode_attention — the attention model, 8 sessions x 300 characters
               through a ``DecodePool`` with dense KV rings and with the
               paged arena (blocks of 16): no kernel, paged equal to dense
               and each to ``rnn_time_step`` (ATT_OUT_TOL); KV bytes,
               peak memory, every block free after close.
35. spec_decode — greedy speculative decode of the char-RNN: NGramDraft
               (k = 4) commits plain greedy's 200 tokens (acceptance,
               tokens a dispatch, tokens/s beside plain), ScriptedDraft
               at every acceptance length likewise, sampling equal to
               k = 0 at the same seed; two lstm launches a fed token.
36. decode_migrate_fault — an attention session moved dense -> paged ->
               dense between two ``DecodeManager``s against its twin
               (MIGRATE_TOL); a ``kill`` fault at ``decode.step`` with 4
               sessions in flight: clean failures, slots reclaimed, the
               thread restarted by the next submit.

Then a line with the kernels' summary, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# Published H100 SXM peaks: f32 on the CUDA cores, dense TF32 on the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12
# The f32-accurate products of the conv and flash kernels take three TF32
# products each.
TF32_PRODUCTS_PER_F32 = 3
# Kernel vs plain version: |y - ref| <= ATOL * max|ref| + RTOL * |ref|.
# Both accumulate in f32 over up to 4608 products, in different orders.
RTOL, ATOL = 1e-4, 1e-5
# Whole-network outputs (softmax probabilities) through the kernel vs
# through the plain conv: up to 16 layers of such sums.
NET_RTOL, NET_ATOL = 1e-3, 1e-5
# xent kernel vs plain version: the JAX suite's tolerance for its kernel.
XENT_TOL = 1e-5
# A training step through the kernels vs the same step through the plain
# versions, TF32 off in both.  The score to STEP_RTOL.  The params by the
# step's update: per tensor, |update_kernel - update_plain| over
# |update_plain| (2-norms) at most STEP_UPDATE_RTOL.  The conv kernel and
# cuDNN agree to ~1e-6 relative per layer (sums in another order), which
# grows through 16 layers forward and back; Nesterovs' update is linear in
# the gradient.  On an H100 the worst tensor measured 6.0e-5 (the first
# conv's W); 5e-4 leaves 8x of that and stays under the ~1e-3 that TF32's
# 10-bit mantissa would bring.  VGG16-224 on random labels at lr 0.01
# diverges within 3 steps (score ~25 → ~5,600), so an elementwise
# tolerance on the params themselves would measure the divergence.
STEP_RTOL, STEP_UPDATE_RTOL = 1e-4, 5e-4
VGG_BATCH, VGG_STEPS = 128, 3
# LeNet: 16 passes over 50 batches, 800 steps, a window of seconds
LENET_BATCH, LENET_BATCHES, LENET_EPOCHS = 64, 50, 16
# LeNet through the input pipeline: the first steps against sync fit, equal
# under cuDNN's deterministic algorithms.  After one epoch of the
# class-separable stand-in the test split must be classified better than
# chance by far.
PIPE_CHECK_STEPS = 4
LENET_MIN_ACCURACY = 0.9
# the gateway's fit: 9 exported minibatches of 64 rows, the last 24 short
GATEWAY_SHARDS, GATEWAY_SHORT = 9, 24
SEED = 1234
# The char-RNN recipe (dl4j-examples GravesLSTMCharModellingExample) on the
# repo's SURVEY.md: 2 x GravesLSTM(200), TBPTT 50, sequences of 1,000 at
# batch 32; sampling 4 streams of 300 characters.
CHAR_HIDDEN, CHAR_LAYERS, CHAR_TBPTT = 200, 2, 50
CHAR_SEQ, CHAR_BATCH, CHAR_MINIBATCHES = 1000, 32, 8
SAMPLE_STREAMS, SAMPLE_CHARS = 4, 300
# The lstm kernel against its plain step: the JAX suite's tolerance for its
# kernel (one step, the same f32 math, the product summed in another order).
LSTM_TOL = 1e-5
# A 2-layer scan of 50 steps, kernel vs plain step, forward and backward:
# relative 2-norm of the difference, per output, state and gradient.
LSTM_SCAN_REL = 1e-4
# One TBPTT segment through the kernel vs the plain step: score to 1e-5
# relative; each param's RMSProp update to 5e-4 in relative 2-norm, the
# training step's rule above.
CHAR_SCORE_RTOL, CHAR_UPDATE_RTOL = 1e-5, 5e-4
# The long-context attention model (examples/long_context_attention.py at
# the context and head dim of the JAX suite's flash target): 2 x causal
# SelfAttentionLayer(512, 8 heads), Adam, SURVEY.md characters, 8 fit steps
# of 4 x 8,192; one step at T = 2,048 against the plain versions.
ATT_WIDTH, ATT_HEADS, ATT_LAYERS = 512, 8, 2
ATT_SEQ, ATT_BATCH, ATT_STEPS, ATT_PLAIN_SEQ = 8192, 4, 8, 2048
# Each flash kernel against its plain version: both f32 with the same
# products; the forward's online softmax rescales in another order, and
# lse is ~10 in size.  rtol = atol = 1e-5.
FLASH_TOL = 1e-5
FLASH_MASK_FROM = 180
# The flash kernels' instances in the flash library's SASS (mangled
# flash_fwd<DPAD> for the forward, flash_bwd<DPAD, true> for dq, <DPAD,
# false> for dk/dv)
FLASH_FUNCTIONS = {"flash_forward": r"flash_fwdILi\d+E",
                   "flash_dq": r"flash_bwdILi\d+ELb1E",
                   "flash_dkv": r"flash_bwdILi\d+ELb0E"}
# A step through the flash kernels vs the plain versions: the score to
# 1e-5 relative (the training step's rule above); each param's gradient to
# 1e-4 (the CPU parity tests' rtol) and its Adam update to 5e-4 (the
# training step's rule above), in relative 2-norm.  Outputs (decode vs
# output(), the bk swap) 1e-5.
ATT_SCORE_RTOL, ATT_GRAD_RTOL, ATT_UPDATE_RTOL = 1e-5, 1e-4, 5e-4
ATT_OUT_TOL = 1e-5
# The state that step starts from: the initial params with Wq and Wk of
# both layers times ATT_PEAK_QK and layer 0's Wv and Wo times
# ATT_SPREAD_V (reasons in _attention_step_vs_plain).
ATT_PEAK_QK, ATT_SPREAD_V = 4.0, 10.0
# VGG16 with batch normalization for CIFAR-10, the public Keras recipe
# (geifmany/cifar-vgg cifar10vgg.build_model, Simonyan & Zisserman's
# widths): per block (convs, channels, dropout rate); each conv is
# Conv2D(3x3, same, linear) -> relu -> BatchNormalization -> Dropout, the
# block's last conv MaxPooling2D instead of the Dropout; then Dropout(0.5)
# -> Flatten -> Dense(512) -> relu -> BatchNormalization -> Dropout(0.5)
# -> Dense(10, softmax).  13 convs, 10 Dropout layers, 14,991,946 params
# and 9,472 running statistics.  Served at batch 32 and 128; trained at
# 128 for 3 timed steps and one checked against the plain step, then
# evaluated on 1,024 rows.
VGG_BN_BLOCKS = ((2, 64, 0.3), (2, 128, 0.4), (3, 256, 0.4),
                 (3, 512, 0.4), (3, 512, 0.4))
VGG_BN_HEAD, VGG_BN_CLASSES, VGG_BN_HW = 512, 10, 32
VGG_BN_PARAMS, VGG_BN_STATS = 14_991_946, 9_472
VGG_BN_BATCHES, VGG_BN_TRAIN_BATCH, VGG_BN_STEPS = (32, 128), 128, 3
VGG_BN_EVAL_ROWS = 1024
# A step through the kernels vs the plain step: the score and updates by
# the training step's rule above; BN's running mean and var after the
# step to 1e-4 in relative 2-norm.  A relu passes the gradient of an
# element or not by its sign, and a max pool sends each window's gradient
# to one element: where a pre-activation lies nearer 0, or two elements
# of a window nearer each other, than the two forwards differ, the steps
# may decide apart and an update moves by a whole element's gradient
# (0.8 % of the updates of VGG16-BN, PERF.md).  So the plain step takes
# the kernel step's relu masks and max-pool argmax, and where its own
# decision differs, the pre-activation (or the gap between the two
# elements) must be within TIE_RTOL of the layer input's largest
# magnitude: a near tie, ten times the conv check's ATOL.
BN_STATS_RTOL = 1e-4
TIE_RTOL = 1e-4
# ResNet-50 (He et al. 2015; the JAX package's models/resnet.py, BASELINE
# config 5) at its published widths: 224x224x3, 1,000 classes, 174
# vertices, 53 convs and 53 batch norms.  46 convs are stride 1 and go
# through the conv kernel; the 7x7/2 stem and the six 1x1/2 convs take
# the dense chain.  Served with the ladder up to 32 rows (4 clients, 16
# requests of 1-2 rows), trained at batch 128 (Nesterovs, lr 0.1, the
# recipe's defaults) on seeded synthetic batches: there is no ImageNet
# in the repo.
# A conv whose output goes straight into a training-mode batch norm has
# a bias whose gradient is 0 in exact arithmetic (the norm takes each
# channel's mean off): its update is rounding noise in either step, ~1e-7
# of the conv weight's update in a CPU rehearsal, so the relative rule
# cannot hold it.  Its update is held instead below BN_BIAS_NOISE of the
# weight update's 2-norm, in both steps.
BN_BIAS_NOISE = 1e-5
RESNET_HW, RESNET_CLASSES = 224, 1000
RESNET_VERTICES, RESNET_PARAMS, RESNET_STATS = 174, 25_583_592, 53_120
RESNET_KERNEL_CONVS, RESNET_DENSE_CONVS = 46, 7
RESNET_SERVE_BATCH, RESNET_CLIENTS, RESNET_REQUESTS = 32, 4, 16
RESNET_TRAIN_BATCH, RESNET_STEPS = 128, 3
# train_resnet50_bf16's steps before the one it compares (its docstring).
RESNET_BF16_STEPS = 10
SERVE_LADDER = (1, 2, 4, 8, 16, 32)
# Transfer learning, dl4j-examples 0.8 transferlearning/vgg16
# (EditAtBottleneckOthersFrozen, FeaturizedPreSave / FitFromFeaturized)
# with seeded weights and images in place of ImageNet's weights and
# flower_photos, which are not in the repo: VGG16-224's 13 convs and 5
# pools (layers 0-17) frozen, fc2 cut to 1,024 outputs, then Dense(256)
# and a 5-class softmax; Nesterovs at lr 5e-5; batch 32 over 320 images
# in 5 classes (2 epochs, 20 steps).  fc1 and fc2 keep dropout 0.5.
TRANSFER_CLASSES, TRANSFER_FROZEN, TRANSFER_FC2, TRANSFER_HIDDEN = 5, 17, \
    1024, 256
TRANSFER_HW = 224
TRANSFER_LR, TRANSFER_SEED = 5e-5, 12345
TRANSFER_IMAGES, TRANSFER_BATCH, TRANSFER_EPOCHS = 320, 32, 2
# Early stopping on the featurized head: MaxEpochs(10), ScoreImprovement(2),
# the last 64 featurized images held out; resume: checkpoints every 4
# iterations of 2 epochs at batch 16 (16 batches an epoch), the run cut
# after 10 batches of its second epoch.
EARLY_MAX_EPOCHS, EARLY_PATIENCE, EARLY_HELD = 10, 2, 64
RESUME_BATCH, RESUME_EPOCHS, RESUME_EVERY, RESUME_CUT = 16, 2, 4, 10
# ResNet-50 fine-tuned with everything through the global pool frozen and
# a 5-class head: 5 fit steps at batch 32.
TRANSFER_RESNET_BATCH, TRANSFER_RESNET_STEPS = 32, 5
# The small functional residual net of keras_functional: 16x16x3 inputs,
# batch 64, 10 classes.
FUNC_HW, FUNC_BATCH, FUNC_CLASSES = 16, 64, 10
# new_layers: the same nets on the card and on the CPU, from the same
# params and state: rtol 1e-4 (float32 sums in other orders, conv through
# the kernel on the card), atol 1e-5 for values near zero (the conv
# check's).
NEW_LAYERS_RTOL, NEW_LAYERS_ATOL = 1e-4, 1e-5
# The bf16 tier.  Published dense bf16 peak of the H100 SXM's tensor cores.
PEAK_BF16_FLOPS = 989e12
# The conv kernel's bf16 form against its plain version (bf16 inputs upcast,
# the whole function in f32, one rounding to bf16): both round an f32 sum to
# bf16, and the sums differ by the order of summation, so an element equals
# the plain one or lies one bf16 ulp from it, except where the f32 sums
# themselves differ by more than that ulp: near zero, where a value below
# ~1e-4 of the output's largest magnitude has an ulp smaller than the f32
# check's ATOL floor.  The rule: |y - ref| <= ulp(ref) + ATOL * max|ref|,
# ulp(v) = 2^(e - 7) for |v| in [2^e, 2^(e+1)).  The share of elements
# that differ and the share beyond one ulp are reported.
BF16_CONV_ATOL = ATOL
# A bf16 step's update against the f32 step's from the same state: the
# cosine of the whole-network update vectors at least JAX's 0.98
# (tests/test_precision.py:114-128).
BF16_COSINE_MIN = 0.98
# The bf16 training phases hold their last step against the plain bf16
# step (phase 7's and 8i's comparisons under the policy) by rules set from
# tools/bf16_rule_probe.py on the CPU, before any card run of these phases:
# VGG16's and ResNet-50's layouts at a quarter of their widths, batch 16 and
# 8, the conv replaced by the plain version summed in the kernel's order (64-K
# slices, partials added in f32), third step, worst of 3 seeds.  Measured:
# score 1.75e-3 (ResNet; VGG 4.1e-5), update 0.0512 (ResNet; VGG 0.0372), BN
# running mean and var 2.27e-3, a BN-fed conv bias's update over its
# weight's 1.79e-3, a pinned relu's or pool's near tie 0.0188 of the layer's
# scale (ResNet; VGG 0.0037); the cosine with the f32 step 0.9985 (0.9998).
# Each rule is twice the larger measurement.  A BN-fed conv's bias update
# is rounding noise (0 in exact arithmetic), as in phase 8i; in bf16 its
# size over the weight's update is 2^-9's, not 2^-24's, and grows with the
# width (the probe's 1.79e-3; 2.9e-3 to 3.7e-3 on an H100 at full width,
# kernel and plain step alike), so it is reported, and the kernel step's
# noise is held to the plain step's own: each such bias's update over the
# plain step's, either way up, at most BF16_BN_BIAS_OVER_PLAIN, twice the
# probe's 1.57 (the zero-gamma net's fourth step; third steps 1.14-1.40).
# At full width a ResNet-50 step is more sensitive than at a quarter: on
# an H100 the plain step against itself with the conv in the kernel's
# order, no kernel in either, read updates 0.17-0.30 apart from the
# calibrated and the seeded net and 0.10-0.15 at the zero-gamma net's
# fourth step, at or beyond the update rule.  The rules stay; ResNet-50's
# phase compares the eleventh step of the zero-gamma net, where that
# witness reads 0.05-0.08 and is held too (PERF.md).  The probe at the
# zero-gamma net, fourth step: score 2.1e-3, update 0.0274, BN 9.1e-4,
# ties 6.8e-3, cosine 0.9979.
BF16_STEP_RTOL = 3.5e-3
BF16_UPDATE_RTOL = 0.103
BF16_BN_STATS_RTOL = 4.6e-3
BF16_TIE_RTOL = 0.038
BF16_BN_BIAS_OVER_PLAIN = 3.14
# bf16 output() probabilities against the f32 net's on the same params, in
# relative 2-norm: twice the probe's measurement at the quarter widths from
# the seeded params, VGG16 0.0363 (8 rows), ResNet-50 (batch_norms=False)
# 0.00493 (32 rows).  Near-uniform rows (ResNet-50's largest probability is
# about 1.4 in 1,000) pass that for any classes, so ResNet-50's log-
# probabilities less each row's mean, its logits less theirs, are held
# too, at twice the probe's 0.0553; two unrelated outputs read about 1.4.
# From the calibrated net the probe read 0.455 and 0.702 (top-1 as f32's
# on 1 row in 8): normalized at every layer, that net is chaotic.
BF16_PROBS_REL = {"vgg16_224": 0.073, "resnet50": 0.0099}
BF16_LOGITS_REL = {"resnet50": 0.111}
# bf16 probabilities sum to 1 within twice the worst case of rounding each
# to bf16 (2^-9 relative).
BF16_PROBS_SUM_ATOL = 2 ** -8
# The bf16 sequence models (the char-RNN and the attention model above under
# precision("bfloat16")).  Kernel against plain version, set from the
# arithmetic before any card run: the lstm step's bf16 form and its plain
# version round the same f32 function, summed in other orders, once: the
# bf16 conv rule (|y - ref| <= ulp(ref) + BF16_CONV_ATOL max|ref|).  The
# flash kernels' bf16 forms take P and dS as hi + lo pairs (2^-18 of p
# dropped) and sum on the tensor cores, which truncate as they add: over
# the 1,024 products of a row at T = 8,192 that is up to ~1.2e-4 of the
# row's scale, so out, dq, dk and dv are held to |y - ref| <= ulp(ref) +
# BF16_FLASH_ATOL max|ref|, twice that; lse (f32) to FLASH_TOL.
BF16_FLASH_ATOL = 2.0 ** -12
# The steps, outputs and samples are held to rules from
# ``python3 tools/bf16_rule_probe.py --model charrnn`` and ``--model
# attention`` (CPU, quarter widths, the char-RNN at full width too, worst
# of 3 seeds), set before any card run of these phases: twice the worst
# reading of the plain bf16 step against the kernels' emulation (the lstm
# product in the kernel's order, each sum moved by an f32 rounding; P and
# dS as hi + lo pairs, every product in the kernels' tiles) and against
# itself with only its sums reordered; the f32 cosine's floor twice the
# worst reading's distance from 1 below 1.  Attention, one Adam step at
# T = 512: score 5.89e-6, gradients 4.40e-3, updates 0.0708 (Adam's first
# step is lr sign(g) where |g| >> eps, so a gradient element near 0 that
# changes sign moves its update by 2 lr), f32 cosine 0.99096 (rule JAX's
# 0.98); output() against f32's 0.00916; the KV ring against output()
# 0.00410.  The char-RNN's readings lie far below the f32 phase's own
# rules (score 0, updates 1.78e-6, gradients 3.9e-7; ring and output()
# equal): sums of products of bf16 numbers are exact in f32 more often
# than not, so a reordered sum seldom flips a rounding.  Its rules are
# then the f32 phase's (CHAR_SCORE_RTOL, CHAR_UPDATE_RTOL), and the
# samples' one bf16 rounding (2^-8), not twice 0; its f32 cosine read
# 0.779 (full width: RMSProp divides each gradient by its running size, so
# bf16's roundings move the small ones' updates far) -> 0.55.
CHAR_BF16_MINIBATCHES, ATT_BF16_STEPS = 3, 3
CHAR_BF16_SCORE_RTOL, CHAR_BF16_UPDATE_RTOL = CHAR_SCORE_RTOL, \
    CHAR_UPDATE_RTOL
CHAR_BF16_COSINE_MIN, CHAR_BF16_SAMPLE_REL = 0.55, 2.0 ** -8
ATT_BF16_SCORE_RTOL, ATT_BF16_GRAD_RTOL, ATT_BF16_UPDATE_RTOL = \
    1.2e-5, 8.8e-3, 0.142
ATT_BF16_COSINE_MIN = BF16_COSINE_MIN
ATT_BF16_PROBS_REL, ATT_BF16_SAMPLE_REL = 0.0184, 0.0082
# fit(fused_steps=K) (fused_lenet): LeNet + Adam at LENET_BATCH through
# the async pipeline, FUSED_K = 8, FUSED_BATCHES x FUSED_EPOCHS = 400
# steps, against 400 plain steps from the same params and generator; a
# LeNet-shaped ComputationGraph likewise at FUSED_GRAPH_K = 4.  A group's
# steps are the plain steps' launches, in the same order, on one stream,
# so under cuDNN's deterministic algorithms (its default conv backward is
# not: tools/fit_determinism_probe.py) params, updater state and score are
# torch.equal.  No call inside a group may synchronise with the card
# (torch.cuda.set_sync_debug_mode("warn") counts them): 0.  Samples/s of
# each, in turns plain / fused / fused / plain, default algorithms.
FUSED_K, FUSED_BATCHES, FUSED_EPOCHS = 8, 40, 10
FUSED_GRAPH_K, FUSED_GRAPH_BATCHES, FUSED_GRAPH_EPOCHS = 4, 16, 4
# pretrain_vae: the VAE of dl4j-examples 0.8 VariationalAutoEncoderExample
# (784 -> encoder 256, 256 -> latent 2 -> decoder 256, 256 -> Bernoulli
# (sigmoid) over 784, leaky relu, RMSProp lr 1e-2, l2 1e-4, which reaches
# no VAE param: the penalty's keys are W and b, as in the JAX package),
# VAE_STEPS pretrain steps at batch VAE_BATCH over VAE_BATCHES batches of
# MNIST-like pixels (stroke_pixels: on load_mnist's dense stand-in this
# recipe diverges in the JAX package too, the score 544 -> 203,392 in one
# step).  The DBN below takes the same kind of pixels.  Rules: the negative
# ELBO falls (the mean of the last 10 steps' scores below the first 10's,
# and the loss of one batch at one ε below its initial value); one step's
# gradients, reconstruction_log_probability and generate_at_mean_given_z
# on the card against the CPU from the same params, pixels and ε by the
# conv-free f32 rule, per tensor |y - y_cpu| <= RTOL |y_cpu| + ATOL
# max|y_cpu| (sums of at most 784 products in other orders, the kernel
# checks' rule); a zip written, restored and written again byte-equal.
VAE_BATCH, VAE_BATCHES, VAE_STEPS, VAE_LR = 128, 32, 200, 1e-2
# pretrain_dbn: the stack of dl4j-examples 0.8 DeepAutoEncoderExample,
# binary RBMs 784 -> 1000 -> 500 -> 250 -> 100 -> 30 -> 100 -> 250 -> 500 ->
# 1000 and an MSE sigmoid output of 784, batch DBN_BATCH, SGD lr 0.1 (the
# example's 0.8 defaults), CD-1; pretrain (one epoch of DBN_BATCHES
# batches, every RBM), DBN_FIT_STEPS fit steps, then DBN_LGD_ITERATIONS
# iterations of Solver("LINE_GRADIENT_DESCENT") (the example's
# algorithm).  The card's Bernoulli draws are not the CPU's, so the RBMs
# are held to statistics: the first RBM's reconstruction error falls, and
# so does the data's mean free energy less that of the same pixels
# shuffled within each image.  Line search: the scores do not rise and
# the last is below the first; its first iteration from the same params
# and batch on the CPU takes the same step and reaches the same score
# within STEP_RTOL (a forward of float32 sums in other orders).
DBN_SIZES = (784, 1000, 500, 250, 100, 30)
DBN_BATCH, DBN_BATCHES, DBN_FIT_STEPS, DBN_LGD_ITERATIONS = 1000, 4, 3, 5
# center_loss_lenet: LeNet with LenetMnistExample's Nesterovs (lr 0.01,
# momentum 0.9) and a CenterLossOutputLayer head (alpha 0.1, lambda 2e-4)
# at LENET_BATCH, CENTER_STEPS fit steps through the async pipeline,
# exactly 2 conv launches each; the last step against the same step with
# the conv on the plain chain (cuDNN, TF32 off), by the training-step rule
# (STEP_RTOL, STEP_UPDATE_RTOL: Nesterovs' update is linear in the
# gradient); the centres' distance to their classes' feature means falls.
CENTER_STEPS, CENTER_ALPHA, CENTER_LAMBDA = 30, 0.1, 2e-4
# external_gradients_vgg16_224: phase 7's VGG16-224 with dropout 0.5.
# backprop_gradient (train off) of a seeded ε at EXT_BATCH = 32 through the
# kernels against autograd through the plain conv chain (cuDNN, TF32 off)
# of the kernel path's own softmax backward at its pre-activation, with
# the kernel path's max-pool argmax and dense relu masks (a near tie
# decided the other way sends a gradient elsewhere whole; a conv's relu is
# the plain one's in both, the kernel's backward recomputing the plain
# conv): every param's gradient and dL/dx within
# STEP_UPDATE_RTOL in relative 2-norm (16 layers of f32 sums in other
# orders; the training-step rule for what is linear in the gradient), and
# where the plain forward's own decision differs, a near tie within
# TIE_RTOL of the layer's scale (train_keras_vgg16_bn's rule).  The
# external loop at VGG_BATCH (so the 1,000-way head of the comparison fit
# step takes the xent kernel: at 32 rows the gate's 65,536 elements are
# not reached): ε of the mean xent from feed_forward(train=True)'s output,
# the generator rewound, backprop_gradient(train=True), apply_gradients,
# against one fit step from the same params and generator: the loss
# within STEP_RTOL, each param's update within STEP_UPDATE_RTOL, the
# generator in the same state after.
EXT_BATCH, EXT_HW = 32, 224
# dl4j_zip_serve: VGG16-CIFAR10 (VGG16_CIFAR10_PARAMS) and the seeded,
# calibrated ResNet-50 exported in the Java DL4J schema and restored on the
# card by load_model: params torch.equal, every member of a second export
# byte-equal to the first's; the migrated ResNet-50's output at batch 4
# against the seeded net's within DL4J_FIXTURE_TOL (the same params; only
# the algorithm picks can differ).  The migrated VGG16 served through
# Server to DL4J_CLIENTS clients (DL4J_REQUESTS requests of 1-4 rows):
# classes equal a direct output(), 13 conv launches a served batch, no
# fallback, the output at batch 4 against the plain conv chain by
# NET_RTOL / NET_ATOL.  The five frozen fixtures of tests/regression
# (per-example input shapes DL4J_FIXTURES) restored on the card: params
# equal to the CPU port's, outputs within DL4J_FIXTURE_TOL of them.
VGG16_CIFAR10_PARAMS = 15_245_130
DL4J_REQUESTS, DL4J_CLIENTS, DL4J_FIXTURE_TOL = 64, 8, 1e-5
DL4J_FIXTURES = {"mlp": (3,), "convbn": (1, 6, 6), "bilstm": (5, 2),
                 "cg": (4,), "cg_ustate": (4,)}
# serve_quantized: VGG16-CIFAR10 and ResNet-50 (seeded_resnet50 with
# batch_norms=False: the calibrated net is chaotic, a rounding anywhere
# growing to the output) served from zips whose configuration sets
# infer_quant, int8 and fp8, and from a dense zip, through the gateway:
# QUANT_CLIENTS clients, QUANT_*_REQUESTS requests of 1-2 rows, latency
# p50 / p99 of each.  Rules: the served classes equal a direct quantized
# output(); the codes are int8 / float8_e4m3fn tensors on the card; the
# quantized output through the conv kernel against the plain conv chain
# on the same dequantized weights by NET_RTOL / NET_ATOL.  Top-1 agreement
# with the dense net over QUANT_ROWS seeded rows, JAX's floors (0.95 int8,
# 0.9 fp8; tests/test_precision.py:283-324), counted over the rows whose
# dense log-probability margin between the first and second class is at
# least QUANT_MARGIN nats, which must be at least QUANT_MARGIN_ROWS_MIN of
# the rows; the share over all rows is reported beside it.  Set from a CPU
# run of the port at full width before any card run: VGG16-CIFAR10, 256
# rows, largest probability 0.42, median margin 0.15 nats, 10% of rows
# below 0.029; agreement int8 0.969 (1.0 over the 212 rows above 0.05
# nats), fp8 0.898 (0.929).  The seeded ResNet-50 has no margins to speak
# of (24 rows: largest probability 0.0012 of 1,000 classes, median margin
# 0.013 nats against a largest change of log p of 0.076 int8 and 0.16
# fp8; agreement 0.71 and 0.375; the calibrated net 0.04 and 0.0): its
# top-1 agreement is reported and not gated (QUANT_TOP1_GATED).
QUANT_CLIENTS, QUANT_VGG_REQUESTS, QUANT_RESNET_REQUESTS = 8, 48, 16
QUANT_ROWS = {"vgg16_cifar10": 512, "resnet50": 128}
QUANT_TOP1 = {"int8": 0.95, "fp8": 0.9}
QUANT_TOP1_GATED = ("vgg16_cifar10",)
QUANT_MARGIN, QUANT_MARGIN_ROWS_MIN = 0.05, 0.25
# graph_tbptt_charrnn: the char-RNN of train_charrnn as a ComputationGraph
# of the same layers from the same initial params, trained by graph TBPTT
# on the same 8 minibatches: every update within CHAR_UPDATE_RTOL and every
# minibatch's score within CHAR_SCORE_RTOL of the network's (the char-RNN
# rules), exactly CHAR_LAYERS x CHAR_SEQ lstm launches a minibatch and no
# lstm fallback; SAMPLE_STREAMS streams of GRAPH_SAMPLE_CHARS characters
# sampled through the graph's rnn_time_step equal the network's on the
# trained params (CHAR_LAYERS launches a character);
# rnn_activate_using_stored_state over two chunks against the stepped
# forward within LSTM_TOL.
GRAPH_SAMPLE_CHARS = 100
# checkpointed_vgg16_224: phase 7's net (dropout 0.5 on fc1 and fc2), one
# step at VGG_BATCH from one state and one set of seed words, plain /
# checkpointed / plain: updates within STEP_UPDATE_RTOL and the score
# within STEP_RTOL of the plain step's; the dropout masks of the first
# forward equal the plain step's and every recompute's is one of them; the
# plain step 13 conv, 1 xent, 4 dropout launches; the checkpointed one
# also runs each layer's forward again in the backward: 26 conv and 6
# dropout (fc1's and fc2's forward again), 1 xent.  Peak memory and step
# seconds of each are reported (PERF.md holds the prediction).
CKPT_CONV_LAUNCHES, CKPT_DROPOUT_LAUNCHES = 26, 6
# bucketed_fit: LeNet + Adam on BUCKET_LENET_BATCHES batches of
# BUCKET_ROWS rows (all bucketed to 64), and the char-RNN (standard
# backprop: truncated BPTT is never bucketed) on BUCKET_CHAR_BATCHES
# batches of CHAR_BATCH sequences of BUCKET_TIME characters, each row
# ending at a seeded step past half its length (features and labels
# masks), each fit bucketed and unbucketed from the same params through
# the async pipeline under cuDNN's deterministic algorithms: training
# signatures (the bucketed run's at most the buckets it hit), launches (2
# conv a LeNet step either way), samples/s, and how far the two runs end
# apart, reported: on random labels both trajectories are chaotic (on the
# CPU port at full width a step-1 difference of 6e-7 grew to 0.11 of the
# params' norm by step 40 for LeNet, 0.25 for the char-RNN), so the gate
# is per step: each of the first BUCKET_CHECK_STEPS batches stepped both
# ways from the same state, every update within BUCKET_*_RTOL of the
# unbucketed update (relative 2-norm per param) and the score within
# BUCKET_SCORE_RTOL: the training-step rules, STEP_UPDATE_RTOL and
# STEP_RTOL, each at least twice the CPU port's reading at full width
# before any card run (updates 1.27e-4 LeNet, Adam's first steps being lr
# sign(g); 1.6e-6 char-RNN; scores 1.0e-7 and 0).
BUCKET_ROWS, BUCKET_LENET_BATCHES = (37, 64), 40
BUCKET_TIME, BUCKET_CHAR_BATCHES = (60, 100), 8
BUCKET_CHECK_STEPS = 4
BUCKET_LENET_RTOL = BUCKET_CHAR_RTOL = STEP_UPDATE_RTOL
BUCKET_SCORE_RTOL = STEP_RTOL
# Stateful decode serving: the char-RNN served over HTTP to 32 concurrent
# sessions of 200 one-token steps (the bf16 net 50), the attention model to
# 8 sessions of 300 characters with dense rings and a paged arena of blocks
# of 16, speculative decode with k = 4 drafts over 200 tokens, and a
# migrated attention stream against its twin (1e-6: the same f32 math in
# both managers, the paged arena's delta write off by at most an ulp).
DECODE_SESSIONS, DECODE_STEPS, DECODE_BF16_STEPS = 32, 200, 50
# The bf16 char-RNN's served streams against ``rnn_time_step``: together
# within one bf16 rounding (CHAR_BF16_SAMPLE_REL, ``sample_charrnn_bf16``'s
# rule), and each alone within 2^-6.  On an H100 the streams read 0.0 with
# the clients in four processes, and the worst one 7.3e-3 once with the
# clients as threads of the server's process: twice that, to a power of
# two.  ``tools/decode_bf16_probe.py`` reads the gap in each setting and
# pool-free, a batch shape at a time.
DECODE_BF16_STREAM_REL = 2.0 ** -6
DECODE_ATT_SESSIONS, DECODE_ATT_TOKENS, DECODE_ATT_BLOCK = 8, 300, 16
SPEC_K, SPEC_TOKENS = 4, 200
MIGRATE_TOL = 1e-6
ROOT = Path(__file__).resolve().parent
START = time.perf_counter()


def keras_vgg16_bn_config(blocks=VGG_BN_BLOCKS, head=VGG_BN_HEAD,
                          classes=VGG_BN_CLASSES, hw=VGG_BN_HW) -> dict:
    """The Keras ``model_config`` (Keras 3 Sequential layout) of VGG16
    with batch normalization for CIFAR-10, at the widths given."""
    layers = [{"class_name": "InputLayer",
               "config": {"name": "input", "batch_shape": [None, hw, hw, 3],
                          "dtype": "float32"}}]

    def add(cls, name, **cfg):
        layers.append({"class_name": cls, "config": {"name": name, **cfg}})
    k = 0
    for b, (n_convs, ch, rate) in enumerate(blocks, 1):
        for c in range(1, n_convs + 1):
            k += 1
            add("Conv2D", f"conv{k}", filters=ch, kernel_size=[3, 3],
                strides=[1, 1], padding="same", activation="linear")
            add("Activation", f"relu{k}", activation="relu")
            add("BatchNormalization", f"bn{k}", momentum=0.99, epsilon=1e-3)
            if c < n_convs:
                add("Dropout", f"drop{k}", rate=rate)
            else:
                add("MaxPooling2D", f"pool{b}", pool_size=[2, 2],
                    strides=[2, 2], padding="valid")
    add("Dropout", "drop_head", rate=0.5)
    add("Flatten", "flatten")
    add("Dense", "fc", units=head, activation="linear")
    add("Activation", "relu_fc", activation="relu")
    add("BatchNormalization", "bn_fc", momentum=0.99, epsilon=1e-3)
    add("Dropout", "drop_fc", rate=0.5)
    add("Dense", "predictions", units=classes, activation="softmax")
    return {"class_name": "Sequential",
            "config": {"name": "vgg16_bn_cifar10", "layers": layers}}


def keras_vgg16_bn_weights(config: dict, seed: int) -> dict:
    """Keras-layout weight arrays for ``config``, drawn from a numpy seed:
    He-scaled HWIO conv and [in, out] dense kernels, small biases, BN
    ``gamma`` in [0.8, 1.2], ``beta`` ~ 0.1 N(0, 1), ``moving_mean`` ~
    0.1 N(0, 1) and ``moving_variance`` in [0.5, 1.5], so inference batch
    norm is not the identity.  Keyed by Keras layer name."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    layers = config["config"]["layers"]
    shape = layers[0]["config"]["batch_shape"]
    hw, width = shape[1], shape[3]
    weights = {}
    for ld in layers[1:]:
        cls, cfg = ld["class_name"], ld["config"]
        if cls == "Conv2D":
            cout = cfg["filters"]
            weights[cfg["name"]] = {
                "kernel": (rng.standard_normal((3, 3, width, cout))
                           * np.sqrt(2.0 / (9 * width))).astype(f32),
                "bias": (0.05 * rng.standard_normal(cout)).astype(f32)}
            width = cout
        elif cls == "MaxPooling2D":
            hw //= 2
        elif cls == "Flatten":
            width = width * hw * hw
        elif cls == "Dense":
            units = cfg["units"]
            weights[cfg["name"]] = {
                "kernel": (rng.standard_normal((width, units))
                           * np.sqrt(2.0 / width)).astype(f32),
                "bias": (0.05 * rng.standard_normal(units)).astype(f32)}
            width = units
        elif cls == "BatchNormalization":
            weights[cfg["name"]] = {
                "gamma": rng.uniform(0.8, 1.2, width).astype(f32),
                "beta": (0.1 * rng.standard_normal(width)).astype(f32),
                "moving_mean": (0.1 * rng.standard_normal(width)).astype(f32),
                "moving_variance": rng.uniform(0.5, 1.5, width).astype(f32)}
    return weights


def import_keras_vgg16_bn(device, seed: int = SEED, **widths):
    """VGG16-BN through the port's Keras import: the configuration built
    above, then its weight arrays through ``_load_weights`` with a dict
    lookup (no h5py)."""
    from deeplearning4j_tpu_torch.keras_import import KerasModelImport
    config = keras_vgg16_bn_config(**widths)
    net = KerasModelImport.import_keras_sequential_configuration(
        json.dumps(config), device=device)
    KerasModelImport._load_weights(net, keras_vgg16_bn_weights(config, seed))
    return net


def new_layer_nets():
    """Small nets built with the port's configuration API that cover the
    layers and preprocessors Keras import brought: name -> (conf,
    features, labels, features mask).  ``cnn``: Conv -> ZeroPadding ->
    LRN -> BatchNormalization -> Activation -> GlobalPooling(avg) ->
    Dense -> LossLayer(softmax); ``rnn_pool``: GlobalPooling(max) over a
    masked sequence; ``embedding`` with integer and ``embedding_one_hot``
    with one-hot input; ``preproc``: RnnToCnn -> Conv -> Composable(CnnToRnn)
    -> GlobalPooling(pnorm) over a masked sequence -> BatchNormalization
    -> Output."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import network
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    rng = np.random.default_rng(SEED + 9)
    f32 = np.float32

    def builder():
        return (network.NeuralNetConfiguration.builder().seed(SEED)
                .learning_rate(0.05).updater("nesterovs").list())

    def onehot(n, k):
        return np.eye(k, dtype=f32)[rng.integers(0, k, n)]

    def seq_mask(n, t):
        lengths = rng.integers(1, t + 1, n)
        return (np.arange(t)[None, :] < lengths[:, None]).astype(f32)
    nets = {}
    conf = (builder()
            .layer(L.ConvolutionLayer(n_out=8, kernel=(3, 3),
                                      convolution_mode="same",
                                      activation="identity"))
            .layer(L.ZeroPaddingLayer(pad=(1, 0, 2, 1)))
            .layer(L.LocalResponseNormalization(n=3, alpha=0.5))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer(activation="relu"))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.DenseLayer(n_out=5, activation="identity"))
            .layer(L.LossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional(12, 12, 3)).build())
    nets["cnn"] = (conf, rng.normal(size=(16, 3, 12, 12)).astype(f32),
                   onehot(16, 5), None)
    conf = (builder()
            .layer(L.GlobalPoolingLayer(pooling_type="max"))
            .layer(L.DenseLayer(n_out=6, activation="tanh"))
            .layer(L.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(InputType.recurrent(7, 9)).build())
    nets["rnn_pool"] = (conf, rng.normal(size=(12, 9, 7)).astype(f32),
                        onehot(12, 4), seq_mask(12, 9))
    for name, feats in (("embedding", rng.integers(0, 20, 24)),
                        ("embedding_one_hot", onehot(24, 20))):
        conf = (builder()
                .layer(L.EmbeddingLayer(n_in=20, n_out=8, activation="tanh"))
                .layer(L.DenseLayer(n_out=6, activation="relu"))
                .layer(L.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
                .set_input_type(InputType.feed_forward(20)).build())
        nets[name] = (conf, feats, onehot(24, 3), None)
    T, C, H, W = 5, 2, 6, 6
    conf = (builder()
            .layer(L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                      activation="tanh"))
            .layer(L.GlobalPoolingLayer(pooling_type="pnorm", pnorm=2))
            .layer(L.BatchNormalization())
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .input_pre_processor(0, pp.RnnToCnnPreProcessor(H, W, C))
            .input_pre_processor(1, pp.ComposableInputPreProcessor.compose(
                pp.CnnToRnnPreProcessor(timesteps=T)))
            .set_input_type(InputType.recurrent(C * H * W, T)).build())
    nets["preproc"] = (conf, rng.normal(size=(6, T, C * H * W)).astype(f32),
                       onehot(6, 3), seq_mask(6, T))
    return nets


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, median over ``reps`` replays (CUDA events),
    divided by ``calls``.  For kernels of a few microseconds, where the
    Python around one call takes longer than the kernel and
    :func:`time_ms` would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def conv_shapes(model: str, batch: int):
    """Every conv of a model as (N, Cin, H, W, Cout, K, pad, activation),
    in forward order (repeats included); for ResNet-50 its 46 stride-1
    convs, block by block."""
    if model == "resnet50":
        return resnet50_kernel_convs(batch)
    if model == "lenet":
        return [(batch, 1, 28, 28, 20, 5, 0, "identity"),
                (batch, 20, 12, 12, 50, 5, 0, "identity")]
    from deeplearning4j_tpu_torch.models.vgg import BLOCKS
    hw = 224 if model == "vgg16_224" else 32
    # VGG16-BN's convs are linear: relu comes after them as a layer
    act = "identity" if model == "vgg16_bn_cifar10" else "relu"
    out, cin = [], 3
    for n_convs, ch in BLOCKS:
        for _ in range(n_convs):
            out.append((batch, cin, hw, hw, ch, 3, 1, act))
            cin = ch
        hw //= 2
    return out


def resnet50_kernel_convs(batch: int):
    """ResNet-50's stride-1 convs (those of the conv kernel) as
    (N, Cin, H, W, Cout, K, pad, activation), block by block: a block's
    1x1 ``_a`` (stride 2 in the first block of stages 1-3), 3x3 ``_b``,
    1x1 ``_c`` and, in stage 0's first block, the 1x1 projection."""
    from deeplearning4j_tpu_torch.models.resnet import STAGES
    out, cin, hw = [], 64, 56
    for si, (n_blocks, ch) in enumerate(STAGES):
        for bi in range(n_blocks):
            strided = bi == 0 and si > 0
            if strided:
                hw //= 2
            else:
                out.append((batch, cin, hw, hw, ch, 1, 0, "identity"))
            out.append((batch, ch, hw, hw, ch, 3, 1, "identity"))
            out.append((batch, ch, hw, hw, 4 * ch, 1, 0, "identity"))
            if bi == 0 and not strided:
                out.append((batch, cin, hw, hw, 4 * ch, 1, 0, "identity"))
            cin = 4 * ch
    return out


def valid_taps(size: int, k: int, pad: int, out: int) -> int:
    """Filter taps along one axis that land inside the image, summed
    over the ``out`` output positions (stride 1): products with the zero
    padding are not work the function needs."""
    return sum(min(k, size + pad - o) - max(0, pad - o) for o in range(out))


def check_conv(torch, ck, shape, gen, timed: bool = True,
               replay: bool = False) -> dict:
    """Kernel vs plain version at one shape (N, Cin, H, W, Cout, K, pad,
    activation), K an int or (KH, KW); raises on disagreement.  With
    ``replay``, each timed call is also timed by replaying a CUDA graph
    of 20 calls (``*graph_ms``): for convs of ~0.1 ms, whose single call
    between two events also times the host's launch."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import activations as act_ops
    N, Cin, H, W, Cout, K, p, act = shape
    KH, KW = (K, K) if isinstance(K, int) else K
    dev = torch.device("cuda")
    x = torch.randn((N, Cin, H, W), generator=gen, device=dev)
    w = torch.randn((Cout, Cin, KH, KW), generator=gen, device=dev) * \
        (2.0 / (Cin * KH * KW)) ** 0.5
    b = torch.randn((Cout,), generator=gen, device=dev) * 0.1
    pad = (p, p)
    y = ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation=act)
    ref = ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", act)
    torch.cuda.synchronize()
    diff = (y - ref).abs()
    scale = float(ref.abs().max())
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(ATOL * scale)).max())
    ok = bool((diff <= ATOL * scale + RTOL * ref.abs()).all()) and \
        bool(torch.isfinite(y).all())
    rec = {"shape": [N, Cin, H, W, Cout, K, p], "activation": act,
           "max_abs_err": max_abs, "max_rel_err": max_rel,
           "ref_scale": scale, "ok": ok}
    if not ok:
        raise AssertionError(f"conv kernel disagrees with its plain "
                             f"version: {rec}")
    if not timed:
        return rec
    OH, OW = y.shape[2], y.shape[3]
    flops = 2 * N * Cout * Cin * valid_taps(H, KH, p, OH) * \
        valid_taps(W, KW, p, OW)
    nbytes = 4 * (x.numel() + w.numel() + b.numel() + y.numel())
    # the kernel's bound: f32-accurate products on the tensor cores, three
    # TF32 products each; the f32 FMAs of the CUDA cores bound a kernel
    # that does not use them, and stand beside it
    t_ops = TF32_PRODUCTS_PER_F32 * flops / PEAK_TF32_FLOPS
    t_simt, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    act_fn = act_ops.get(act)

    def library():
        return act_fn(F.conv2d(x, w, b, padding=pad))
    rec.update(
        ms=time_ms(torch, lambda: ck.fused_conv2d_bias_act(
            x, w, b, pad=pad, activation=act)),
        plain_ms=time_ms(torch, lambda: ck.conv2d_bias_act_reference(
            x, w, b, pad, "truncate", act)),
        library_ms=time_ms(torch, library),
        flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_f32_simt_ms=max(t_simt, t_bytes) * 1e3)
    if replay:
        rec.update(
            graph_ms=graph_ms(torch, lambda: ck.fused_conv2d_bias_act(
                x, w, b, pad=pad, activation=act)),
            plain_graph_ms=graph_ms(torch, lambda: ck.conv2d_bias_act_reference(
                x, w, b, pad, "truncate", act)),
            library_graph_ms=graph_ms(torch, library))
    torch.backends.cudnn.allow_tf32 = True
    try:
        rec["library_tf32_ms"] = time_ms(torch, library)
        if replay:
            rec["library_tf32_graph_ms"] = graph_ms(torch, library)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["share_of_f32_simt_bound"] = rec["bound_f32_simt_ms"] / rec["ms"]
    rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def hgmma_count(ck, library, kernel: str, operand: str = "",
                instruction: str = "HGMMA") -> int:
    """HGMMA (wgmma) instructions (with ``operand``, those whose SASS line
    names it, e.g. ``BF16``; with ``instruction`` ``"HMMA"``, mma.sync's) in
    the SASS of every kernel function of ``library`` whose mangled name
    matches the regex ``kernel``; raises if one of them has none."""
    counts = {f: n for f, n in ck.sass_hgmma_counts(
        library, operand, instruction).items() if re.search(kernel, f)}
    if not counts or not all(counts.values()):
        raise AssertionError(f"{kernel} in {library.source.name}: "
                             f"{instruction} counts {counts}; the kernel does "
                             f"not run on the tensor cores")
    return sum(counts.values())


def serialized_wgmmas(library) -> list:
    """ptxas's ``serialized`` notes in ``library``'s build log (the
    performance notes that name a kernel whose wgmmas it serialised, C7518
    and the like): [(code, mangled function)], in the log's order."""
    out = []
    for line in library.build_log.splitlines():
        if "serialized" in line:
            code = re.search(r"\((C\d+)\)", line)
            func = re.search(r"function '([^']+)'", line)
            out.append((code.group(1) if code else "",
                        func.group(1) if func else line.strip()))
    return out


# the bf16 conv's kernel functions (the halo and full-width routes', the
# GEMM route's): each instance must hold bf16 HGMMA, and ptxas may
# serialise the wgmmas of none
BF16_CONV_KERNELS = ("conv_wgmma_bf16_kernel", "conv_gemm_bf16_kernel")


SET_SUMS = ("ms", "plain_ms", "library_ms", "library_tf32_ms", "bound_ms",
            "bound_f32_simt_ms", "flops", "bytes")
GRAPH_SUMS = ("graph_ms", "plain_graph_ms", "library_graph_ms",
              "library_tf32_graph_ms")


def phase_kernels(torch, ck):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # timed: the served ladder's top bucket (32), batch 128, VGG16-224 at
    # its output() batch and at its training batch (the forward convs of a
    # training step); untimed: every other bucket the server runs (1-16
    # rows), VGG16-224's first call at one row, LeNet's training batch and
    # VGG16-224 at 32 (fine-tuning, external gradients), since the
    # kernel's plan (tile, cluster split) depends on the batch
    plan = [("lenet", 32, True), ("vgg16_cifar10", 32, True),
            ("lenet", 128, True), ("vgg16_cifar10", 128, True),
            ("vgg16_224", 8, True), ("vgg16_224", VGG_BATCH, True),
            ("vgg16_224", 1, False), ("lenet", LENET_BATCH, False),
            ("vgg16_224", EXT_BATCH, False)]
    plan += [("vgg16_bn_cifar10", n, False) for n in VGG_BN_BATCHES]
    plan += [(m, n, False) for m in ("lenet", "vgg16_cifar10")
             for n in (1, 2, 4, 8, 16)]
    records, ladder, seen = [], [], set()
    for model, batch, timed in plan:
        for shape in conv_shapes(model, batch):
            if shape in seen:
                continue
            seen.add(shape)
            rec = check_conv(torch, ck, shape, gen, timed=timed)
            rec["model"] = model
            (records if timed else ladder).append(rec)
    acts = sorted(set(ck.CONV_FUSED_ACTS) - {"linear"})
    act_records = [check_conv(torch, ck, (32, 20, 12, 12, 50, 5, 0, a), gen,
                              timed=False) for a in acts]
    # sums over each timed set (a model at one batch): every conv of the
    # model's forward, a repeated shape once for each time it runs
    by_shape = {(tuple(r["shape"]), r["activation"]): r for r in records}
    sets = {}
    for model, batch, timed in plan:
        if not timed:
            continue
        rows = [by_shape[(tuple(s[:7]), s[7])]
                for s in conv_shapes(model, batch)]
        agg = {k: sum(r[k] for r in rows) for k in SET_SUMS}
        agg["convs"] = len(rows)
        agg["tflops"] = agg["flops"] / agg["ms"] / 1e9
        agg["share_of_bound"] = agg["bound_ms"] / agg["ms"]
        sets[f"{model}_{batch}"] = agg
    emit("kernels", tf32=False, rtol=RTOL, atol_scaled=ATOL,
         conv_sass_hgmma=hgmma_count(ck, ck.CONV_LIBRARY,
                                     "conv_wgmma_kernel"),
         timed_sets=sets,
         bound_note="bound_ms: 3 TF32 products per f32 product at "
                    "PEAK_TF32_FLOPS, or bytes; bound_f32_simt_ms: f32 FMAs "
                    "at PEAK_F32_FLOPS, or bytes; library_tf32_ms is cuDNN "
                    "with TF32 on, a less accurate function",
         shapes=records, untimed_shapes=ladder, activations=act_records)
    return records + ladder


def phase_serve(torch, ck):
    from deeplearning4j_tpu_torch.models import lenet, vgg16_cifar10
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)

    models = {
        "lenet": (lenet(device="cuda"), (1, 28, 28)),
        "vgg16_cifar10": (vgg16_cifar10(device="cuda"), (3, 32, 32)),
    }
    rng = np.random.default_rng(SEED)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, (net, _) in models.items():
            net.init(generator=torch.Generator().manual_seed(SEED))
            paths[name] = str(Path(tmp) / f"{name}.zip")
            write_model(net, paths[name])
        requests = {name: [rng.normal(size=(int(rng.integers(1, 5)),) + dims)
                           .astype(np.float32) for _ in range(64)]
                    for name, (_, dims) in models.items()}
        torch.cuda.reset_peak_memory_stats()
        server = Server(DeepLearning4jEntryPoint(device="cuda",
                                                 max_batch=32)).start()
        try:
            url = f"http://127.0.0.1:{server.port}/"
            # load and warm both models through the gateway's own RPC,
            # so the timed requests see resident, warmed models
            warm = {}
            ck.fused_conv2d_bias_act.launches = 0
            for name, (_, dims) in models.items():
                t0 = time.perf_counter()
                w = _rpc(url, "warmup", {"model_path": paths[name],
                                         "feature_dims": list(dims)})
                warm[name] = {"warmup_s": time.perf_counter() - t0,
                              "warmup_buckets": w["buckets"]}
            warm_launches = ck.fused_conv2d_bias_act.launches
            fallbacks = _conv_fallbacks()
            ck.fused_conv2d_bias_act.launches = 0        # main path starts
            for name in models:
                results[name] = _drive(url, paths[name], requests[name])
                results[name].update(warm[name])
            launches = ck.fused_conv2d_bias_act.launches  # main path ends
            fallbacks = _conv_fallbacks() - fallbacks
            stats = server.entry_point.stats()["serving"]
        finally:
            server.stop()
        peak = torch.cuda.max_memory_allocated()

    conv_calls = 0
    for name, (net, _) in models.items():
        res = results[name]
        n_convs = sum(type(l).__name__ == "ConvolutionLayer"
                      for l in net.layers)
        res["batcher"] = {k: stats[str(Path(paths[name]).resolve())][k]
                          for k in ("batches", "rows", "batch_size_hist",
                                    "queue_ms", "compute_ms", "total_ms")}
        conv_calls += n_convs * res["batcher"]["batches"]
        _check_served_classes(name, requests[name], res.pop("answers"),
                              net.output)
        res["classes_equal_direct_output"] = True
        # the same forward alone, host copy included: what the batcher's
        # compute time would be without the HTTP threads beside it
        x16 = np.concatenate(requests[name])[:16]
        res["direct_output_16_rows_ms"] = _host_ms(
            torch, lambda: net.output(x16).cpu())
    if launches != conv_calls or fallbacks:
        raise AssertionError(
            f"served batches made {conv_calls} conv calls: the kernel "
            f"launched {launches} times, the dense chain ran {fallbacks}")
    emit("serve", models=results, conv_launches=launches,
         conv_calls_of_served_batches=conv_calls, conv_fallbacks=fallbacks,
         warmup_conv_launches=warm_launches, max_memory_allocated=peak)
    return launches


def _check_served_classes(name, xs, answers, direct) -> None:
    """Each request's served classes (argmax, or the best of top 3) must
    equal argmax of ``direct(x)``, a direct forward on the card."""
    for x, (mode, answer) in zip(xs, answers):
        want = direct(x).argmax(dim=-1).cpu().numpy().tolist()
        cls = answer["classes"]
        got = cls if mode == "argmax" else [c[0] for c in cls]
        shape = [len(x)] if mode == "argmax" else [len(x), 3]
        if got != want or answer["shape"] != shape:
            raise AssertionError(f"{name}: served {answer} for direct "
                                 f"classes {want}")


def _conv_fallbacks() -> float:
    """Convs that have taken the dense chain in this process so far."""
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_kernel_fallback_total", "ops that took the dense torch chain",
        labels=("op",)).labels(op="conv2d").value


def _host_ms(torch, fn, reps: int = 10) -> float:
    """Median host-clock time of ``fn`` (which ends in a host copy)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _rpc(url, method, params):
    body = json.dumps({"method": method, "params": params}).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["result"]


def _drive(url, path, xs, clients: int = 8):
    """The predict requests ``xs`` from ``clients`` client threads;
    latency per request.
    The request bodies are encoded before the clock starts, so the client
    threads, which share this process with the server, only send and
    wait."""
    modes = ["argmax" if i % 2 == 0 else "top_k" for i in range(len(xs))]
    bodies = []
    for x, mode in zip(xs, modes):
        params = {"model_path": path, "features": x.tolist()}
        if mode == "argmax":
            params["argmax_only"] = True
        else:
            params["top_k"] = 3
        bodies.append(json.dumps({"method": "predict",
                                  "params": params}).encode())
    answers = [None] * len(xs)
    lat = [0.0] * len(xs)
    errors = []

    def client(k):
        for i in range(k, len(xs), clients):
            req = urllib.request.Request(
                url, data=bodies[i],
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers[i] = (modes[i], json.loads(r.read())["result"])
            except Exception as e:  # reported below, after every thread
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors[:3]}")
    return {"requests": len(xs), "rows": int(sum(len(x) for x in xs)),
            "wall_s": wall, "requests_per_s": len(xs) / wall,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "max_ms": float(np.max(lat) * 1e3), "answers": answers}


def _plain_forward(torch, ck, net, x):
    """The network's forward with every conv through the plain version,
    in full f32 whatever an earlier phase left cuDNN's TF32 setting at."""
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    with torch.inference_mode(), ck.full_f32_convs():
        for i, layer in enumerate(net.layers):
            if i in net.conf.preprocessors:
                x, _ = net.conf.preprocessors[i](x)
            p = net.net_params[i]
            if isinstance(layer, ConvolutionLayer):
                x = ck.conv2d_bias_act_reference(
                    x, p["W"], p["b"], tuple(layer.padding),
                    layer.convolution_mode, layer.activation)
            else:
                x, _, _ = layer.forward(p, net.net_state[i], x)
    return x


def phase_vgg16_224(torch, ck):
    from deeplearning4j_tpu_torch.models import vgg16
    net = vgg16(device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    x = torch.randn((8, 3, 224, 224),
                    generator=torch.Generator().manual_seed(SEED + 1))
    x = x.to("cuda")
    net.output(x[:1])        # first call: cuDNN/cuBLAS handles, allocator
    torch.cuda.synchronize()
    # three timed calls: one host-clock sample can catch a host stall
    walls = []
    for _ in range(3):
        before = ck.fused_conv2d_bias_act.launches
        t0 = time.perf_counter()
        out = net.output(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        delta = ck.fused_conv2d_bias_act.launches - before
    if tuple(out.shape) != (8, 1000) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"VGG16-224 output {tuple(out.shape)} not finite")
    row_sums = out.sum(dim=1)
    if not torch.allclose(row_sums, torch.ones_like(row_sums), atol=1e-5):
        raise AssertionError(f"softmax rows do not sum to 1: {row_sums}")
    if delta != 13:
        raise AssertionError(f"{delta} conv kernel launches for 13 convs")
    ref = _plain_forward(torch, ck, net, x)
    torch.testing.assert_close(out, ref, rtol=NET_RTOL, atol=NET_ATOL)
    emit("vgg16_224", batch=8, wall_ms=float(np.median(walls)),
         wall_ms_each=walls, conv_launches=delta,
         max_abs_vs_plain=float((out - ref).abs().max()),
         classes=out.argmax(dim=1).tolist(),
         n_params=net.n_params,
         max_memory_allocated=torch.cuda.max_memory_allocated())


def check_served_models_against_plain(torch, ck):
    """Both served models, kernel path vs plain conv, on a small batch."""
    from deeplearning4j_tpu_torch.models import lenet, vgg16_cifar10
    out = {}
    for name, make, dims in (("lenet", lenet, (1, 28, 28)),
                             ("vgg16_cifar10", vgg16_cifar10, (3, 32, 32))):
        net = make(device="cuda").init(
            generator=torch.Generator().manual_seed(SEED))
        x = torch.randn((4,) + dims,
                        generator=torch.Generator().manual_seed(SEED)).cuda()
        got, ref = net.output(x), _plain_forward(torch, ck, net, x)
        torch.testing.assert_close(got, ref, rtol=NET_RTOL, atol=NET_ATOL)
        out[name] = float((got - ref).abs().max())
    return out


def _bound(nbytes: int, flops: int = 0):
    """(bound ms, what bounds it) at the published H100 SXM peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_xent(torch, ck, N, V, gen, soft=False, timed=False,
               offset=0) -> dict:
    """The xent kernel against its plain version (loss, gradient, and the
    backward of ``softmax_xent_rows``); raises on disagreement.  ``offset``
    takes logits and labels as views that start that many floats into
    their storage (rows not 16-byte aligned)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")

    def view(t):
        flat = torch.empty((N * V + offset,), device=dev)
        flat[offset:] = t.reshape(-1)
        return flat[offset:].reshape(N, V)
    x = view(torch.randn((N, V), generator=gen, device=dev) * 3)
    if soft:
        y = torch.rand((N, V), generator=gen, device=dev)
        y = y * torch.rand((N, 1), generator=gen, device=dev) * 2
    else:
        y = F.one_hot(torch.randint(0, V, (N,), generator=gen, device=dev),
                      V).float()
    y = view(y)
    g = torch.randn((N,), generator=gen, device=dev)
    loss, grad = ck.fused_softmax_xent(x, y)
    ref_loss, ref_grad = ck.softmax_xent_reference(x, y)
    xr = x.clone().requires_grad_()
    ck.softmax_xent_rows(xr, y).backward(g)
    torch.cuda.synchronize()
    for got, want in ((loss, ref_loss), (grad, ref_grad),
                      (xr.grad, ref_grad * g[:, None])):
        torch.testing.assert_close(got, want, rtol=XENT_TOL, atol=XENT_TOL)
    plan = ck.xent_plan(N, V, aligned=offset % 4 == 0)
    rec = {"shape": [N, V], "soft_labels": soft, "offset": offset,
           "plan": plan, "blocks": N * plan["blocks_per_row"],
           "max_abs_err": max(float((loss - ref_loss).abs().max()),
                              float((grad - ref_grad).abs().max()))}
    if timed:
        nbytes = 4 * (3 * N * V + N)      # read x, y; write grad, loss
        xl = x.clone().requires_grad_()

        def library():
            torch.autograd.grad(F.cross_entropy(xl, y, reduction="none"),
                                xl, g)
        lib = ck.XENT_LIBRARY.get()

        def floor():
            # an empty kernel on the same grid: the least any launch takes
            err = lib.dl4j_launch_floor(rec["blocks"], plan["threads"],
                                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"empty kernel: CUDA error {err}")
        rec.update(ms=graph_ms(torch, lambda: ck.fused_softmax_xent(x, y)),
                   call_ms=time_ms(torch, lambda: ck.fused_softmax_xent(x, y)),
                   plain_ms=graph_ms(torch, lambda: ck.softmax_xent_reference(
                       x, y)),
                   library_ms=graph_ms(torch, library),
                   empty_kernel_ms=graph_ms(torch, floor), bytes=nbytes)
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 6 * N * V)
    return rec


def check_dropout(torch, ck, shape, rate, gen, timed=False,
                  offset=0, dtype=None) -> dict:
    """The dropout kernel against its plain version, bit for bit, forward
    and backward; ``offset`` takes x as a view that starts that many
    elements into its storage.  With ``dtype`` bfloat16 the bf16 form, whose
    mask must also be the f32 form's at the same seed words."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    n = int(np.prod(shape))
    x = torch.randn((n + offset,), generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    if dtype is not None:
        x, g = x.to(dtype), g.to(dtype)
    x = x[offset:].reshape(shape)
    seed = tuple(int(v) for v in torch.randint(
        0, 1 << 32, (2,), generator=torch.Generator().manual_seed(n)))
    xr = x.clone().requires_grad_()
    y = ck.fused_threshold_dropout(xr, rate, seed)
    y.backward(g)
    ref = ck.threshold_dropout_reference(x, rate, seed)
    ref_g = ck.threshold_dropout_reference(g, rate, seed)
    torch.cuda.synchronize()
    if not (torch.equal(y, ref) and torch.equal(xr.grad, ref_g)):
        raise AssertionError(f"dropout kernel differs from its plain version "
                             f"at {shape} rate {rate} offset {offset}")
    mask = ck.fused_threshold_dropout(torch.ones_like(x), rate, seed) != 0
    kept = float(mask.float().mean())
    if abs(kept - rate) > 0.01 + 5 / n ** 0.5:
        raise AssertionError(f"dropout kept {kept} of {shape} at {rate}")
    if dtype is not None and not torch.equal(mask, ck.fused_threshold_dropout(
            torch.ones(shape, device=dev), rate, seed) != 0):
        raise AssertionError(f"{dtype} dropout mask differs from the f32 "
                             f"form's at {shape} rate {rate}")
    rec = {"shape": list(shape), "rate": rate, "offset": offset,
           "dtype": str(x.dtype).replace("torch.", ""),
           "kept": kept, "equal_forward": True, "equal_backward": True,
           "max_abs_err": max(float((y.detach() - ref).abs().max()),
                              float((xr.grad - ref_g).abs().max()))}
    if timed:
        nbytes = 2 * x.element_size() * n   # read x, write y
        # forward: successive calls take successive inputs of a ring of
        # more than the 50 MB L2, so each call reads its input from device
        # memory.  Backward: the launch ``_ThresholdDropout.backward``
        # makes, on one gradient every call, which stays in L2 as the
        # gradient the next layer's backward has just written does.
        ring = [x] + [x.clone() for _ in range(
            -(-50_000_000 // (x.element_size() * n)))]
        turn = iter(range(1 << 30))

        def cold(fn):
            return lambda: fn(ring[next(turn) % len(ring)])

        def kernel(t):
            return ck.fused_threshold_dropout(t, rate, seed)

        def plain(t):
            return ck.threshold_dropout_reference(t, rate, seed)
        # F.dropout moves the same bytes but draws its own mask; its
        # backward multiplies the gradient by the saved mask
        _, mask = torch.native_dropout(x, 1 - rate, True)
        rec.update(
            ms_forward=graph_ms(torch, cold(kernel)),
            ms_backward=graph_ms(
                torch, lambda: ck._threshold_dropout(g, rate, seed)),
            call_ms=time_ms(torch, cold(kernel)),
            plain_ms_forward=graph_ms(torch, cold(plain)),
            plain_ms_backward=graph_ms(torch, lambda: plain(g)),
            library_ms_forward=graph_ms(torch, cold(
                lambda t: F.dropout(t, p=1 - rate, training=True))),
            library_ms_backward=graph_ms(
                torch, lambda: torch.ops.aten.native_dropout_backward(
                    g, mask, 1 / rate)),
            bytes=nbytes)
        for key in ("ms", "plain_ms", "library_ms"):
            rec[key] = rec[key + "_forward"] + rec[key + "_backward"]
        # ~12 integer operations per element, at the int32 rate (half the
        # f32 rate) still far below the bytes' time: bound by bytes.  One
        # bound for each direction.
        bound, rec["bound_by"] = _bound(nbytes)
        rec["bound_ms"] = 2 * bound
    return rec


def dense_dropout_timing(torch, ck) -> list:
    """Host-clock time of one dropout call under the kernel's 4,096-element
    gate: the hash kernel against the dense path ``ops/helpers.dropout``
    takes there (a generator seeded per call, ``torch.rand``, a select)."""
    from deeplearning4j_tpu_torch.ops import helpers
    out = []
    for shape in ((1, 500), (8, 500), (4, 1023)):
        x = torch.randn(shape, device="cuda")
        seed = (12345, 67890)
        out.append({
            "shape": list(shape),
            "kernel_host_ms": _host_ms(torch, lambda: float(
                ck.fused_threshold_dropout(x, 0.5, seed).sum()), reps=50),
            "dense_host_ms": _host_ms(torch, lambda: float(
                helpers.dropout(x, 0.5, seed).sum()), reps=50),
            "kernel_ms": graph_ms(
                torch, lambda: ck.fused_threshold_dropout(x, 0.5, seed))})
    return out


def phase_xent_dropout_kernels(torch, ck) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the training path's [128, 1000] and GPT-2's vocabulary, timed; the
    # warp path's widths, V not a multiple of 4, rows not 16-byte aligned,
    # one row, and the cluster path up to its widest row, checked
    xent = [check_xent(torch, ck, VGG_BATCH, 1000, gen, timed=True),
            check_xent(torch, ck, 64, 50257, gen, soft=True, timed=True),
            check_xent(torch, ck, VGG_BATCH, 1000, gen, soft=True),
            check_xent(torch, ck, 256, 512, gen),
            check_xent(torch, ck, 997, 1000, gen),
            check_xent(torch, ck, 130, 1001, gen, soft=True),
            check_xent(torch, ck, VGG_BATCH, 1000, gen, offset=1),
            check_xent(torch, ck, 1, 1000, gen),
            check_xent(torch, ck, 300, 77, gen, soft=True),
            check_xent(torch, ck, 64, 2048, gen, soft=True),
            check_xent(torch, ck, 64, 2047, gen, soft=True),
            check_xent(torch, ck, 64, 2049, gen, soft=True),
            check_xent(torch, ck, 1, 50257, gen, soft=True, offset=3),
            check_xent(torch, ck, 16, ck.XENT_REGISTER_ROW, gen, soft=True),
            check_xent(torch, ck, 4, 2 * ck.XENT_REGISTER_ROW, gen,
                       soft=True),
            check_xent(torch, ck, 2, ck.XENT_REGISTER_ROW + 1, gen,
                       offset=1)]
    fc_in = [(VGG_BATCH, 25088), (VGG_BATCH, 4096)]
    drop = [check_dropout(torch, ck, s, 0.5, gen, timed=True) for s in fc_in]
    drop += [check_dropout(torch, ck, s, r, gen, offset=o)
             for s, r, o in (((VGG_BATCH, 25088), 0.8, 0),
                             ((VGG_BATCH, 4096), 0.8, 0),
                             ((3, 4099), 0.5, 0), ((3, 4099), 0.8, 0),
                             ((VGG_BATCH, 4096), 0.5, 1))]
    emit("xent_dropout_kernels", xent_tol=XENT_TOL, xent=xent, dropout=drop,
         dropout_under_gate=dense_dropout_timing(torch, ck),
         library_note="dropout's library_ms is F.dropout: the same bytes, "
                      "another mask, forward + its mask-multiply backward; "
                      "xent's is F.cross_entropy with probability targets, "
                      "forward + backward")
    return {"xent": xent, "dropout": drop}


def _launchers(ck) -> dict:
    """Every kernel wrapper of the port by its name in the kernels line
    (a bf16 form by its own count)."""
    return {"conv2d_bias_act": ck.fused_conv2d_bias_act,
            "conv2d_bias_act_bf16": ck.fused_conv2d_bias_act.bf16,
            "softmax_xent": ck.fused_softmax_xent,
            "threshold_dropout": ck.fused_threshold_dropout,
            "threshold_dropout_bf16": ck.fused_threshold_dropout.bf16,
            "lstm_step": ck.fused_lstm_step,
            "lstm_step_bf16": ck.fused_lstm_step.bf16,
            "flash_forward": ck.flash_forward,
            "flash_forward_bf16": ck.flash_forward.bf16,
            "flash_dq": ck.flash_dq,
            "flash_dq_bf16": ck.flash_dq.bf16,
            "flash_dkv": ck.flash_dkv,
            "flash_dkv_bf16": ck.flash_dkv.bf16}


def _kernel_counts(ck):
    return {name: fn.launches for name, fn in _launchers(ck).items()}


def _zero_counts(ck):
    for fn in _launchers(ck).values():
        fn.launches = 0


def _want(ck, **launches) -> dict:
    """The launch counts of a path: the given ones, 0 for every other
    kernel."""
    return {name: launches.get(name, 0) for name in _launchers(ck)}


def _random_batch(rng, n, dims, classes):
    x = rng.normal(size=(n,) + dims).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


class _RecordedOutputs:
    """While active, each layer of ``net`` keeps the output of its forward
    (detached) in ``outputs`` by layer index."""

    def __init__(self, net):
        self.net, self.outputs = net, {}

    def __enter__(self):
        for i, layer in enumerate(self.net.layers):
            def forward(*args, _fwd=layer.forward, _i=i, **kw):
                out = _fwd(*args, **kw)
                self.outputs[_i] = out[0].detach()
                return out
            layer.forward = forward       # shadows the class's method
        return self

    def __exit__(self, *exc):
        for layer in self.net.layers:
            del layer.forward


def _pinned(torch, layer, i, h, outputs, ties):
    """The plain step's relu or max pool at layer ``i`` with the kernel
    step's choice: its relu mask (from its output ``outputs[i]``) or its
    max-pool argmax (from its pool input ``outputs[i - 1]``).  Appends to
    ``ties`` the elements or windows where the plain forward's own choice
    differs and the largest gap there, relative to the layer input's
    largest magnitude."""
    kept = outputs[i] if type(layer).__name__ == "ActivationLayer" else \
        outputs[i - 1]
    return _pin(torch, layer, i, h, kept, ties)


def _pin(torch, layer, label, h, kept, ties):
    """A relu ActivationLayer, max-pool SubsamplingLayer or global max
    GlobalPoolingLayer on ``h`` with the kernel step's choice: for a relu,
    ``kept`` is the kernel step's relu output (its mask is kept); for a
    pool, ``kept`` is the kernel step's pool input (its argmax of each
    window, padding included, or of each map is taken).  Appends the near
    ties to ``ties`` (see :func:`_pinned`)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import convolution as conv_ops
    scale = float(h.detach().abs().max())
    if type(layer).__name__ == "ActivationLayer":
        keep = kept > 0
        flips = keep != (h > 0)
        gap = h.abs()[flips]
        out = torch.where(keep, h, 0.0)
    elif type(layer).__name__ == "GlobalPoolingLayer":
        flat = h.flatten(2)
        idx = kept.flatten(2).argmax(2, keepdim=True)
        out = flat.gather(2, idx)[..., 0]
        flips = flat.argmax(2, keepdim=True)[..., 0] != idx[..., 0]
        gap = (flat.amax(2) - out)[flips]
    else:
        k, st = tuple(layer.kernel), tuple(layer.stride)
        (pt, pb), (pl, pr) = conv_ops.explicit_pads(
            h.shape[2:], k, st, tuple(layer.padding), (1, 1),
            layer.convolution_mode)

        def padded(t):
            return F.pad(t, (pl, pr, pt, pb), value=float("-inf"))
        _, idx = F.max_pool2d(padded(kept), k, st, return_indices=True)
        hp = padded(h)
        own, own_idx = F.max_pool2d(hp, k, st, return_indices=True)
        out = hp.flatten(2).gather(2, idx.flatten(2)).view_as(idx)
        flips = own_idx != idx
        gap = (own - out).abs()[flips]
    ties.append({"layer": label, "kind": type(layer).__name__,
                 "elements": int(flips.numel()), "flips": int(flips.sum()),
                 "max_rel_gap": float(gap.max()) / scale if gap.numel()
                 else 0.0})
    return out


def _plain_train_step(torch, ck, net, params, opt_states, x, y, seeds, it,
                      states=None, kernel_outputs=None, policy=None):
    """One training step of ``net`` from ``params`` / ``opt_states`` (and
    the layers' ``states``: batch norm's running statistics) with every
    kernel replaced by its plain version: conv through cuDNN (TF32 off),
    dropout through the plain hash, loss through the plain softmax
    cross-entropy, gradients by autograd; batch norm and the update are
    the network's own (plain PyTorch).  With ``kernel_outputs`` (the
    kernel step's layer outputs, :class:`_RecordedOutputs`) each relu
    layer and max pool takes the kernel step's mask or argmax
    (:func:`_pinned`).  A frozen layer (``FrozenLayerConf``) runs its
    inner layer's inference forward and takes no gradient.  Under a mixed
    precision ``policy`` (``ops/dtypes``) the params and x are cast to the
    compute dtype inside the differentiated function and the output
    layer's pre-activation to the accumulation dtype before the loss, as
    the engine casts them.  Returns (score, new params, dropout inputs,
    new states, near ties)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
        SubsamplingLayer, unfrozen)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import dtypes
    policy = policy or dtypes.FLOAT32
    leaves = [{k: v.detach().clone().requires_grad_(not net.frozen[i])
               for k, v in lp.items()} for i, lp in enumerate(params)]
    dropped = {}
    n = len(net.layers)
    new_states = [dict(s) for s in (states or [{} for _ in net.layers])]
    ties = []
    with ck.full_f32_convs():
        h = policy.cast_to_compute(x)
        cast = policy.cast_to_compute(leaves)
        for i, layer in enumerate(net.layers):
            if i in net.conf.preprocessors:
                h, _ = net.conf.preprocessors[i](h)
            p = cast[i]
            if layer.dropout and 0.0 < layer.dropout < 1.0:
                dropped[i] = h.detach()
                h = ck.threshold_dropout_reference(h, layer.dropout, seeds[i])
            frozen, layer = net.frozen[i], unfrozen(layer)
            if isinstance(layer, ConvolutionLayer):
                h = ck.conv2d_bias_act_reference(
                    h, p["W"], p["b"], tuple(layer.padding),
                    layer.convolution_mode, layer.activation)
            elif i == n - 1:
                h = torch.addmm(p["b"], h, p["W"])
            elif isinstance(layer, DenseLayer):
                h = layer._act(torch.addmm(p["b"], h, p["W"]))
            elif isinstance(layer, BatchNormalization):
                h, ns, _ = layer.forward(p, new_states[i], h,
                                         train=not frozen)
                new_states[i] = {k: v.detach() for k, v in ns.items()}
            elif kernel_outputs is not None and not frozen and (
                    (isinstance(layer, ActivationLayer)
                     and layer.activation == "relu")
                    or (isinstance(layer, SubsamplingLayer)
                        and layer.pooling_type == "max")):
                h = _pinned(torch, layer, i, h, kernel_outputs, ties)
            else:
                h, _, _ = layer.forward(p, {}, h)
        loss, _ = ck.softmax_xent_reference(policy.cast_to_accum(h), y)
        score = loss.mean()
        flat = iter(torch.autograd.grad(
            score, [v for lp in leaves for v in lp.values()
                    if v.requires_grad]))
    grads = [{k: next(flat) for k, v in lp.items() if v.requires_grad}
             for lp in leaves]
    scratch = MultiLayerNetwork(net.conf, device=net.device)
    scratch.net_params = [{k: v.detach().clone() for k, v in lp.items()}
                          for lp in params]
    scratch.opt_states = opt_states
    scratch._apply_updates(grads, it)
    return (float(score.detach()), scratch.net_params, dropped, new_states,
            ties)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_clone_tree(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree.detach().clone()


def phase_train_vgg16_224(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.models import vgg16
    # the training path runs with PyTorch's defaults (cuDNN may use TF32);
    # the port keeps its own conv backward in f32
    torch.backends.cudnn.allow_tf32 = True
    net = vgg16(dropout=0.5, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    x, y = _random_batch(np.random.default_rng(SEED), VGG_BATCH,
                         (3, 224, 224), 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    _zero_counts(ck)                                   # main path starts
    for k in range(VGG_STEPS):
        if k == VGG_STEPS - 1:       # snapshot for the plain-version step
            before = ([{kk: v.clone() for kk, v in lp.items()}
                       for lp in net.net_params], _clone_tree(net.opt_states),
                      net.iteration)
            state = net._generator.get_state()
            seeds = net._draw_seeds().tolist()
            net._generator.set_state(state)
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": k + 1, "score": net.score(), "seconds": dt,
                      "samples_per_s": VGG_BATCH / dt,
                      "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    want = _want(ck, conv2d_bias_act=13, softmax_xent=1, threshold_dropout=4)
    for st in steps:
        if st["launches"] != want or not np.isfinite(st["score"]):
            raise AssertionError(f"VGG16-224 step {st}: launches must be "
                                 f"{want} and the score finite")
    params0, opt0, it = before
    xd, yd = (torch.from_numpy(a).cuda() for a in (x, y))
    plain_score, plain_params, dropped, _, _ = _plain_train_step(
        torch, ck, net, params0, opt0, xd, yd, seeds, it)
    del opt0
    for i, h in dropped.items():             # kernel vs plain on the same
        rate = net.layers[i].dropout          # inputs: identical outputs
        ones = torch.ones_like(h)             # and identical masks
        if not (torch.equal(ck.fused_threshold_dropout(h, rate, seeds[i]),
                            ck.threshold_dropout_reference(h, rate, seeds[i]))
                and torch.equal(
                    ck.fused_threshold_dropout(ones, rate, seeds[i]),
                    ck.threshold_dropout_reference(ones, rate, seeds[i]))):
            raise AssertionError(f"layer {i}: dropout masks differ")
    kernel_score = steps[-1]["score"]
    errs = {}
    for i, (lp, pp, p0) in enumerate(zip(net.net_params, plain_params,
                                         params0)):
        for k in lp:
            errs[f"{i}_{k}"] = float(torch.linalg.vector_norm(lp[k] - pp[k])
                                     / torch.linalg.vector_norm(pp[k] - p0[k]))
    del params0
    res = {"batch": VGG_BATCH, "steps": steps,
           "samples_per_s_after_first": VGG_BATCH * (len(steps) - 1)
           / sum(s["seconds"] for s in steps[1:]),
           "launches": launches, "max_memory_allocated": peak,
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "update_rel_err": errs,
                          "max_update_rel_err": max(errs.values()),
                          "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL,
                          "dropout_masks_identical": sorted(dropped)}}
    emit("train_vgg16_224", **res)
    if res["plain_step"]["score_rel_diff"] > STEP_RTOL or \
            max(errs.values()) > STEP_UPDATE_RTOL:
        raise AssertionError("VGG16-224 step through the kernels disagrees "
                             "with the plain step")
    return res


def phase_train_lenet(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models import lenet
    net = lenet(device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 3)
    # MNIST-scale pixels in [0, 1)
    batches = [DataSet(rng.random((LENET_BATCH, 1, 28, 28), np.float32),
                       np.eye(10, dtype=np.float32)[
                           rng.integers(0, 10, LENET_BATCH)])
               for _ in range(LENET_BATCHES + 1)]
    net.fit(batches[0])                       # first call: handles, allocator
    torch.cuda.synchronize()
    data = ListDataSetIterator(batches[1:])
    epoch_s = []
    _zero_counts(ck)                                   # main path starts
    for _ in range(LENET_EPOCHS):
        t0 = time.perf_counter()
        net.fit(data)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    launches = _kernel_counts(ck)                      # main path ends
    steps = LENET_BATCHES * LENET_EPOCHS
    want = _want(ck, conv2d_bias_act=2 * steps)
    score = net.score()
    dt = sum(epoch_s)
    per_epoch = [LENET_BATCHES * LENET_BATCH / t for t in epoch_s]
    res = {"batch": LENET_BATCH, "steps": steps, "seconds": dt,
           "samples_per_s": steps * LENET_BATCH / dt,
           "epoch_samples_per_s_min_max": [min(per_epoch), max(per_epoch)],
           "ms_per_step": dt / steps * 1e3, "score": score,
           "launches": launches}
    emit("train_lenet", **res)
    if launches != want or not np.isfinite(score):
        raise AssertionError(f"LeNet training launched {launches}, want "
                             f"{want}; score {score}")
    return res

def _pipeline_consumed() -> float:
    """Batches the async input pipeline has handed to a consumer so far."""
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_pipeline_batches_total", labels=("stage",)).labels(
        stage="consumed").value


def _mnist_scaler():
    """The pipeline's normalizer: ``load_mnist`` gives pixels in [0, 1]
    (real or stand-in), which it maps to [-1, 1]."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        ImagePreProcessingScaler)
    return ImagePreProcessingScaler(-1.0, 1.0, max_value=1.0)


def phase_train_lenet_pipeline(torch, ck) -> dict:
    """LeNet + Adam on MNIST through ``fit``'s async input pipeline with
    device staging, then ``evaluate`` on the test split."""
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, ListDataSetIterator, fetchers, iterators)
    from deeplearning4j_tpu_torch.models import lenet
    real = all((fetchers.CACHE_DIR / "mnist" / f).exists()
               for f in fetchers.MNIST_FILES.values())
    scaler = _mnist_scaler()
    train = fetchers.MnistDataSetIterator(LENET_BATCH, train=True, seed=SEED)
    n_batches = len(train._data)
    train_rows = sum(d.num_examples() for d in train._data)
    batch_bytes = train._data[0].features.nbytes + \
        train._data[0].labels.nbytes

    # the first steps through the pipeline against the same steps fed
    # synchronously, from the same params and seed words, bitwise: with
    # cuDNN's deterministic algorithms both runs are, while its default
    # conv backward is not, and Adam can lift that noise past any fixed
    # tolerance (tools/fit_determinism_probe.py)
    first = [scaler.transform(d) for d in train._data[:PIPE_CHECK_STEPS]]
    nets = {}
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for workers in (1, 0):
            net = lenet(device="cuda")
            net.conf.global_conf.pipeline_workers = workers
            net.init(generator=torch.Generator().manual_seed(SEED))
            before = _pipeline_consumed()
            net.fit(ListDataSetIterator(first))
            torch.cuda.synchronize()
            nets[workers] = (net, _pipeline_consumed() - before)
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    (piped, piped_consumed), (sync, sync_consumed) = nets[1], nets[0]
    check = {"steps": PIPE_CHECK_STEPS,
             "rule": "torch.equal, cuDNN deterministic",
             "pipeline_batches": piped_consumed, "sync_batches": sync_consumed,
             "bitwise_equal": bool(torch.equal(piped.params(), sync.params())),
             "score_pipeline": piped.score(), "score_sync": sync.score()}
    del nets, piped, sync
    if not check["bitwise_equal"] or piped_consumed != PIPE_CHECK_STEPS or \
            sync_consumed != 0 or \
            check["score_pipeline"] != check["score_sync"]:
        raise AssertionError(f"fit through the pipeline differs from sync "
                             f"fit: {check}")

    net = lenet(device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    g = net.conf.global_conf
    it = AsyncDataSetIterator(train, queue_size=g.pipeline_prefetch,
                              workers=g.pipeline_workers,
                              staging_depth=g.pipeline_staging_depth,
                              device=net.device, normalizer=scaler)
    consumed = _pipeline_consumed()
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    net.fit(it)
    score = net.score()          # a host copy: waits for the card
    dt = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    consumed = _pipeline_consumed() - consumed
    test = AsyncDataSetIterator(
        fetchers.MnistDataSetIterator(LENET_BATCH, train=False,
                                      shuffle=False),
        queue_size=g.pipeline_prefetch, workers=g.pipeline_workers,
        staging_depth=g.pipeline_staging_depth, device=net.device,
        normalizer=scaler)
    n_test = len(test.underlying._data)
    test_rows = sum(d.num_examples() for d in test.underlying._data)
    _zero_counts(ck)                                   # evaluate starts
    t1 = time.perf_counter()
    ev = net.evaluate(test)
    eval_s = time.perf_counter() - t1
    eval_launches = _kernel_counts(ck)                 # evaluate ends
    test.close()
    res = {"data": "mnist files" if real else "stand-in (load_mnist, "
                                                "no files cached)",
           "batch": LENET_BATCH, "steps": n_batches,
           "rows": train_rows, "seconds": dt,
           "samples_per_s": train_rows / dt,
           "score": score, "launches": launches,
           "pipeline_batches": consumed,
           "batch_bytes": batch_bytes, "staging_route": (
               "pinned" if batch_bytes >= iterators.PINNED_STAGING_BYTES
               else "pageable"),
           "ready_high_water": it.staging_high_water,
           "staging_depth": it.staging_depth, "workers": it.workers,
           "evaluate": {"batches": n_test, "rows": int(
               ev.confusion.matrix.sum()), "accuracy": ev.accuracy(),
               "f1": ev.f1(), "seconds": eval_s,
               "launches": eval_launches},
           "pipeline_vs_sync": check}
    emit("train_lenet_pipeline", **res)
    if launches != _want(ck, conv2d_bias_act=2 * n_batches) or \
            eval_launches != _want(ck, conv2d_bias_act=2 * n_test) or \
            consumed != n_batches or not np.isfinite(score) or \
            not 1 <= it.staging_high_water <= it.staging_depth or \
            res["evaluate"]["rows"] != test_rows or \
            ev.accuracy() < LENET_MIN_ACCURACY:
        raise AssertionError(f"LeNet through the pipeline: {res}")
    return res


def phase_gateway_fit_evaluate(torch, ck) -> dict:
    """The gateway's fit and evaluate RPCs over HTTP on a LeNet zip and
    exported minibatches, then predict with the trained parameters."""
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.models import lenet
    from deeplearning4j_tpu_torch.nn.serialization import (
        restore_multi_layer_network, write_model)
    from deeplearning4j_tpu_torch.scaleout.data import (
        PathDataSetIterator, export_dataset)
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)
    rows = GATEWAY_SHARDS * LENET_BATCH - GATEWAY_SHORT
    data = _mnist_scaler().transform(fetchers.load_mnist(
        train=True, num_examples=rows))
    probe = data.features[:5]
    with tempfile.TemporaryDirectory() as tmp:
        model = str(Path(tmp) / "lenet.zip")
        first = lenet(device="cuda").init(
            generator=torch.Generator().manual_seed(SEED + 5))
        write_model(first, model)
        shards = Path(tmp) / "shards"
        shards.mkdir()
        batches = data.batch_by(LENET_BATCH)
        for i, b in enumerate(batches):
            export_dataset(b, shards / f"b{i}.npz")
        server = Server(DeepLearning4jEntryPoint(device="cuda")).start()
        try:
            url = f"http://127.0.0.1:{server.port}/"
            _zero_counts(ck)                           # main path starts
            t0 = time.perf_counter()
            fit = _rpc(url, "fit", {"model_path": model,
                                    "data_dir": str(shards)})
            fit_s = time.perf_counter() - t0
            launches = _kernel_counts(ck)              # main path ends
            _zero_counts(ck)
            ev = _rpc(url, "evaluate", {"model_path": fit["model_path"],
                                        "data_dir": str(shards)})
            eval_launches = _kernel_counts(ck)
            served = _rpc(url, "predict", {"model_path": model,
                                           "features": probe.tolist(),
                                           "coalesce": False})
        finally:
            server.stop()
        trained = restore_multi_layer_network(fit["model_path"],
                                              device="cuda")
        direct = trained.evaluate(PathDataSetIterator.from_dir(shards))
        want = trained.output(probe).cpu().numpy()
        old = first.output(probe).cpu().numpy()
    got = np.asarray(served["predictions"], np.float32)
    res = {"shards": len(batches), "rows": rows,
           "last_shard_rows": batches[-1].num_examples(),
           "fit": {**fit, "seconds": fit_s,
                   "samples_per_s": rows / fit_s},
           "launches": launches, "evaluate": ev,
           "evaluate_launches": eval_launches,
           "direct_evaluate": {"accuracy": direct.accuracy(),
                               "f1": direct.f1()},
           "predict_after_fit_max_abs": float(np.abs(got - want).max()),
           "predict_moved_from_initial": float(np.abs(got - old).max())}
    emit("gateway_fit_evaluate", **res)
    want_launches = _want(ck, conv2d_bias_act=2 * len(batches))
    if launches != want_launches or eval_launches != want_launches or \
            ev != res["direct_evaluate"] or not np.isfinite(fit["score"]) \
            or not np.allclose(got, want, rtol=NET_RTOL, atol=NET_ATOL) \
            or np.allclose(got, old, rtol=NET_RTOL, atol=NET_ATOL):
        raise AssertionError(f"gateway fit / evaluate: {res}")
    return res


def _vgg_bn_layers(net) -> dict:
    names = [type(l).__name__ for l in net.layers]
    return {k: names.count(k) for k in ("ConvolutionLayer", "DropoutLayer",
                                        "BatchNormalization")}


def _vgg_bn_checked(net) -> dict:
    """The imported VGG16-BN's layer counts and sizes, checked."""
    counts = _vgg_bn_layers(net)
    stats = sum(v.numel() for s in net.net_state for v in s.values())
    if counts != {"ConvolutionLayer": 13, "DropoutLayer": 10,
                  "BatchNormalization": 14} or \
            net.n_params != VGG_BN_PARAMS or stats != VGG_BN_STATS:
        raise AssertionError(f"imported VGG16-BN has {counts}, "
                             f"{net.n_params} params, {stats} statistics")
    return {"layers": counts, "n_params": net.n_params,
            "running_statistics": stats}


def phase_keras_vgg16_bn(torch, ck) -> dict:
    """VGG16-BN for CIFAR-10 imported from its Keras configuration and
    weight arrays (no h5py), served through ``output()`` at batch 32 and
    128: 13 conv launches a forward, against a forward through the plain
    conv."""
    net = import_keras_vgg16_bn("cuda")
    sizes = _vgg_bn_checked(net)
    gen = torch.Generator().manual_seed(SEED + 11)
    xs = {n: torch.randn((n, 3, VGG_BN_HW, VGG_BN_HW), generator=gen).cuda()
          for n in VGG_BN_BATCHES}
    for x in xs.values():           # first calls: handles, allocator
        net.output(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches, outs = {}, {}
    _zero_counts(ck)                                   # main path starts
    for n, x in xs.items():
        walls, per_call = [], []
        for _ in range(5):
            before = ck.fused_conv2d_bias_act.launches
            t0 = time.perf_counter()
            outs[n] = net.output(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            per_call.append(ck.fused_conv2d_bias_act.launches - before)
        batches[n] = {"output_ms": float(np.median(walls)),
                      "output_ms_each": walls,
                      "conv_launches_per_forward": per_call}
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    for n, x in xs.items():
        out, rec = outs[n], batches[n]
        ref = _plain_forward(torch, ck, net, x)
        rec["max_abs_vs_plain"] = float((out - ref).abs().max())
        rec["classes"] = out.argmax(dim=1)[:16].tolist()
        sums = out.sum(dim=1)
        if tuple(out.shape) != (n, VGG_BN_CLASSES) or \
                not bool(torch.isfinite(out).all()) or \
                not torch.allclose(sums, torch.ones_like(sums), atol=1e-5) \
                or set(rec["conv_launches_per_forward"]) != {13}:
            raise AssertionError(f"VGG16-BN output at batch {n}: {rec}")
        torch.testing.assert_close(out, ref, rtol=NET_RTOL, atol=NET_ATOL)
    res = {**sizes, "batches": batches, "launches": launches,
           "max_memory_allocated": peak, "rtol": NET_RTOL, "atol": NET_ATOL}
    if launches != _want(ck, conv2d_bias_act=13 * 5 * len(xs)):
        raise AssertionError(f"VGG16-BN inference launched {launches}")
    emit("keras_vgg16_bn", **res)
    return res


def phase_train_keras_vgg16_bn(torch, ck) -> dict:
    """The imported VGG16-BN trained with ``fit`` (SGD, the importer's
    defaults) at batch 128: 3 timed steps, then one more whose layer
    outputs are kept (``_RecordedOutputs`` keeps a gigabyte of them alive,
    which would cost a timed step its allocations) and which is checked
    against the plain step, BN statistics included; 13 conv and 10
    dropout-forward launches every step (and the 10 backward launches of
    dropout); then ``evaluate`` on 1,024 rows."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    torch.backends.cudnn.allow_tf32 = True
    net = import_keras_vgg16_bn("cuda")
    _vgg_bn_checked(net)
    rng = np.random.default_rng(SEED + 12)
    x, y = _random_batch(rng, VGG_BN_TRAIN_BATCH, (3, VGG_BN_HW, VGG_BN_HW),
                         VGG_BN_CLASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    _zero_counts(ck)                                   # main path starts
    recorded = _RecordedOutputs(net)
    for k in range(VGG_BN_STEPS + 1):
        checked = k == VGG_BN_STEPS
        if checked:                   # snapshot for the plain-version step
            peak = torch.cuda.max_memory_allocated()
            before = (_clone_tree(net.net_params), _clone_tree(net.opt_states),
                      _clone_tree(net.net_state), net.iteration)
            state = net._generator.get_state()
            seeds = net._draw_seeds().tolist()
            net._generator.set_state(state)
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        with recorded if checked else contextlib.nullcontext():
            net.fit(x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": k + 1, "checked": checked,
                      "score": net.score(), "seconds": dt,
                      "samples_per_s": VGG_BN_TRAIN_BATCH / dt,
                      "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    want = _want(ck, conv2d_bias_act=13, threshold_dropout=20)
    for st in steps:
        if st["launches"] != want or not np.isfinite(st["score"]):
            raise AssertionError(f"VGG16-BN step {st}: launches must be "
                                 f"{want} and the score finite")
    params0, opt0, states0, it = before
    xd, yd = (torch.from_numpy(a).cuda() for a in (x, y))
    plain_score, plain_params, dropped, plain_states, ties = \
        _plain_train_step(torch, ck, net, params0, opt0, xd, yd, seeds, it,
                          states0, recorded.outputs)
    del recorded
    del opt0
    for i, h in dropped.items():             # kernel vs plain on the same
        rate = net.layers[i].dropout          # inputs: identical outputs
        ones = torch.ones_like(h)             # and identical masks
        if not (torch.equal(ck.fused_threshold_dropout(h, rate, seeds[i]),
                            ck.threshold_dropout_reference(h, rate, seeds[i]))
                and torch.equal(
                    ck.fused_threshold_dropout(ones, rate, seeds[i]),
                    ck.threshold_dropout_reference(ones, rate, seeds[i]))):
            raise AssertionError(f"layer {i}: dropout masks differ")
    kernel_score = steps[-1]["score"]
    errs, stat_errs, stat_update_errs = {}, {}, {}
    for i, (lp, pp, p0) in enumerate(zip(net.net_params, plain_params,
                                         params0)):
        for k in lp:
            errs[f"{i}_{k}"] = _rel_norm(torch, lp[k] - p0[k], pp[k] - p0[k])
    for i, (s, ps, s0) in enumerate(zip(net.net_state, plain_states,
                                        states0)):
        for k in s:
            stat_errs[f"{i}_{k}"] = _rel_norm(torch, s[k], ps[k])
            stat_update_errs[f"{i}_{k}"] = _rel_norm(torch, s[k] - s0[k],
                                                     ps[k] - s0[k])
    del params0, states0
    eval_rows = [DataSet(*_random_batch(rng, VGG_BN_TRAIN_BATCH,
                                        (3, VGG_BN_HW, VGG_BN_HW),
                                        VGG_BN_CLASSES))
                 for _ in range(VGG_BN_EVAL_ROWS // VGG_BN_TRAIN_BATCH)]
    _zero_counts(ck)                                   # evaluate starts
    t1 = time.perf_counter()
    ev = net.evaluate(ListDataSetIterator(eval_rows))
    eval_s = time.perf_counter() - t1
    eval_launches = _kernel_counts(ck)                 # evaluate ends
    timed = steps[1:VGG_BN_STEPS]
    res = {"batch": VGG_BN_TRAIN_BATCH, "steps": steps,
           "samples_per_s_after_first": VGG_BN_TRAIN_BATCH * len(timed)
           / sum(st["seconds"] for st in timed),
           "launches": launches, "max_memory_allocated": peak,
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "max_update_rel_err": max(errs.values()),
                          "update_rel_err": errs,
                          "max_bn_stats_rel_err": max(stat_errs.values()),
                          "max_bn_stats_update_rel_err": max(
                              stat_update_errs.values()),
                          "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL,
                          "bn_stats_rtol": BN_STATS_RTOL,
                          "near_ties": ties, "tie_rtol": TIE_RTOL,
                          "dropout_masks_identical": sorted(dropped)},
           "evaluate": {"rows": int(ev.confusion.matrix.sum()),
                        "accuracy": ev.accuracy(), "seconds": eval_s,
                        "launches": eval_launches}}
    emit("train_keras_vgg16_bn", **res)
    n_eval = len(eval_rows)
    if res["plain_step"]["score_rel_diff"] > STEP_RTOL or \
            res["plain_step"]["max_update_rel_err"] > STEP_UPDATE_RTOL or \
            res["plain_step"]["max_bn_stats_rel_err"] > BN_STATS_RTOL or \
            len(dropped) != 10 or len(ties) != 5 + 14 or \
            max(t["max_rel_gap"] for t in ties) > TIE_RTOL:
        raise AssertionError("VGG16-BN step through the kernels disagrees "
                             "with the plain step")
    if eval_launches != _want(ck, conv2d_bias_act=13 * n_eval) or \
            res["evaluate"]["rows"] != VGG_BN_EVAL_ROWS:
        raise AssertionError(f"VGG16-BN evaluate: {res['evaluate']}")
    return res


def phase_new_layers(torch, ck) -> dict:
    """The small nets of ``new_layer_nets`` on the card against the same
    nets on the CPU from the same params and state: ``output()``, then one
    ``fit`` step with the same seed words (params, state and score)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    res = {}
    for name, (conf, x, y, mask) in new_layer_nets().items():
        cpu = MultiLayerNetwork(conf, device="cpu").init()
        gpu = MultiLayerNetwork(conf, device="cuda")
        gpu.net_params = [{k: v.to("cuda", copy=True) for k, v in lp.items()}
                          for lp in cpu.net_params]
        gpu.net_state = [{k: v.to("cuda", copy=True) for k, v in s.items()}
                         for s in cpu.net_state]
        errs = {"output": _assert_near(torch, gpu.output(x, mask),
                                       cpu.output(x, mask), name)}
        seeds = np.arange(2 * len(conf.layers)).reshape(-1, 2) + SEED
        ds = DataSet(x, y, mask, None)
        for net in (cpu, gpu):
            net._fit_batch(ds, seeds=seeds)
        errs["score"] = abs(gpu.score() - cpu.score()) / abs(cpu.score())
        if errs["score"] > NEW_LAYERS_RTOL:
            raise AssertionError(f"{name}: scores {gpu.score()} (card) and "
                                 f"{cpu.score()} (CPU)")
        for i, (gl, cl) in enumerate(zip(gpu.net_params + gpu.net_state,
                                         cpu.net_params + cpu.net_state)):
            for k in cl:
                errs[f"{i}_{k}"] = _assert_near(torch, gl[k], cl[k],
                                                f"{name} {i} {k}")
        res[name] = {"layers": [type(l).__name__ for l in conf.layers],
                     "preprocessors": {str(k): type(v).__name__ for k, v in
                                       conf.preprocessors.items()},
                     "max_abs_err": max(errs.values())}
    emit("new_layers", nets=res, rtol=NEW_LAYERS_RTOL, atol=NEW_LAYERS_ATOL)
    return res


def resnet_weights(net, seed: int):
    """Seeded params and batch-norm state for a ResNet graph, as numpy
    dicts by vertex: He-scaled conv and dense weights, biases and BN
    ``beta`` ~ 0.05 N(0, 1), BN ``gamma`` in [0.5, 0.8] (below 1, so the
    residual sums stay near unit scale without batch statistics), running
    means ~ 0.1 N(0, 1) and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params, state = {}, {}
    for name in net.order:
        params[name] = {}
        for k, v in net.net_params[name].items():
            shape = tuple(v.shape)
            if k == "W":
                fan = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
                a = rng.standard_normal(shape) * np.sqrt(2.0 / fan)
            elif k == "gamma":
                a = rng.uniform(0.5, 0.8, shape)
            else:
                a = 0.05 * rng.standard_normal(shape)
            params[name][k] = a.astype(f32)
        state[name] = {
            k: (0.1 * rng.standard_normal(tuple(v.shape)) if k == "mean"
                else rng.uniform(0.5, 1.5, tuple(v.shape))).astype(f32)
            for k, v in net.net_state[name].items()}
    return params, state


def seeded_resnet50(device, seed: int = SEED, batch_norms: bool = True):
    """``resnet50()`` at its published widths with :func:`resnet_weights`'s
    params, calibrated on a seeded batch of 32 images as training would
    leave it, for the running statistics a zip restores (``init``'s: a
    zip holds no layer state, as in the JAX package): each batch norm's
    gamma and beta normalize its input's batch statistics, and the output
    layer's bias takes away the batch's mean of ``W h``.  Without that
    the relus' positive means carry nearly the same logits to every image
    (13 of 16 random rows took one class), and served classes would
    check little.  Without ``batch_norms`` only the output bias is
    calibrated: the batch norms keep :func:`resnet_weights`' gamma and
    beta, and on init's statistics (mean 0, variance 1) scale each channel
    by its gamma, below 1, in place of normalizing it.  The bf16 phases
    take that net: normalized at every layer, the calibrated one is
    chaotic, a rounding anywhere growing through its depth to the output
    (tools/bf16_rule_probe.py, PERF.md)."""
    import torch
    from deeplearning4j_tpu_torch.models import resnet50
    net = resnet50(device=device).init()
    net.load_jax_params(resnet_weights(net, seed)[0])
    inp, out = net.conf.network_inputs[0], net.conf.network_outputs[0]
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(RESNET_SERVE_BATCH, 3, RESNET_HW, RESNET_HW)).astype(
            np.float32)).to(net.device)
    zero = {n: {k: torch.zeros_like(t) for k, t in s.items()}
            for n, s in net.net_state.items()}
    with torch.no_grad():
        batch = net._forward_all(net.net_params, zero, {inp: x}, {},
                                 train=True)[2]
        for n, s in batch.items():
            if not s or not batch_norms:
                continue
            lc = net.conf.vertices[n].layer_conf()
            keep = 1 - lc.decay                 # decay * 0 + (1 - decay) b
            p, r = net.net_params[n], net.net_state[n]
            # gamma (x - mean) / sd + beta == g' (x - r_mean) / r_sd + b'
            sd = torch.sqrt(s["var"] / keep + lc.eps)
            r_sd = torch.sqrt(r["var"] + lc.eps)
            p["beta"].sub_(p["gamma"] * (s["mean"] / keep - r["mean"]) / sd)
            p["gamma"].mul_(r_sd / sd)
        z = net._forward_all(net.net_params, net.net_state, {inp: x}, {},
                             train=False, preout_for=[out])[1][out]
        b = net.net_params[out]["b"]
        b.sub_(z.mean(dim=0) - b)
    return net


def _input_dependent(probs, what: str) -> dict:
    """Raises unless ResNet-50's class probabilities ``probs`` [rows,
    classes] depend on the image: no row's softmax saturated (max below
    0.99) and at least a quarter of the rows' argmax classes distinct."""
    classes = probs.argmax(dim=1)
    res = {"max_probability": float(probs.max()),
           "distinct_classes": int(classes.unique().numel()),
           "rows": len(probs)}
    if res["max_probability"] >= 0.99 or \
            4 * res["distinct_classes"] < res["rows"]:
        raise AssertionError(f"{what}: the output barely depends on the "
                             f"input: {res}")
    return res


def _resnet_checked(net) -> dict:
    """ResNet-50's vertex, conv, batch-norm, param and statistic counts,
    checked."""
    kinds = [type(net.conf.vertices[n].layer_conf()).__name__
             if hasattr(net.conf.vertices[n], "layer_conf") else
             type(net.conf.vertices[n]).__name__ for n in net.order]
    counts = {k: kinds.count(k) for k in ("ConvolutionLayer",
                                          "BatchNormalization")}
    stats = sum(v.numel() for s in net.net_state.values() for v in s.values())
    if len(net.order) != RESNET_VERTICES or net.n_params != RESNET_PARAMS \
            or stats != RESNET_STATS or counts != {
                "ConvolutionLayer": 53, "BatchNormalization": 53}:
        raise AssertionError(f"ResNet-50 has {len(net.order)} vertices, "
                             f"{counts}, {net.n_params} params, {stats} "
                             f"statistics")
    return {"vertices": len(net.order), "layers": counts,
            "n_params": net.n_params, "running_statistics": stats}


def bn_fed_convs(net) -> set:
    """The conv vertices of a graph whose output only a batch norm reads."""
    readers = {}
    for n in net.order:
        for i in net.conf.vertex_inputs[n]:
            readers.setdefault(i, []).append(n)

    def kind(n):
        v = net.conf.vertices[n]
        return type(v.layer_conf()).__name__ if hasattr(v, "layer_conf") \
            else type(v).__name__
    return {n for n in net.order if kind(n) == "ConvolutionLayer"
            and [kind(r) for r in readers.get(n, [])] ==
            ["BatchNormalization"]}


def _plain_graph_forward(torch, ck, net, x):
    """The graph's inference forward with every stride-1 conv through the
    plain version, in full f32."""
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    acts = {net.conf.network_inputs[0]: x}
    with torch.inference_mode(), ck.full_f32_convs():
        for name in net.order:
            v = net.conf.vertices[name]
            ins = [acts[i] for i in net.conf.vertex_inputs[name]]
            layer = v.layer_conf() if hasattr(v, "layer_conf") else None
            p = net.net_params[name]
            if isinstance(layer, ConvolutionLayer) and \
                    tuple(layer.stride) == (1, 1):
                acts[name] = ck.conv2d_bias_act_reference(
                    ins[0], p["W"], p["b"], tuple(layer.padding),
                    layer.convolution_mode, layer.activation)
            else:
                acts[name], _, _ = v.forward(p, net.net_state[name], ins)
    return acts[net.conf.network_outputs[0]]


def _pinned_vertices(net) -> dict:
    """The relu ActivationLayer and max-pool vertices (windows or global)
    of a graph, each with the vertex whose output the pin reads: the relu
    vertex itself, or the pool's input."""
    out = {}
    for name in net.order:
        v = net.conf.vertices[name]
        layer = v.layer_conf() if hasattr(v, "layer_conf") else None
        kind = type(layer).__name__
        if kind == "ActivationLayer" and layer.activation == "relu":
            out[name] = name
        elif kind in ("SubsamplingLayer", "GlobalPoolingLayer") and \
                layer.pooling_type == "max":
            out[name] = net.conf.vertex_inputs[name][0]
    return out


class _RecordedVertexOutputs:
    """While active, the vertices of graph ``net`` named in ``names`` keep
    their forward's output (detached) in ``outputs`` by name."""

    def __init__(self, net, names):
        self.net, self.names, self.outputs = net, set(names), {}

    def __enter__(self):
        for name in self.names:
            v = self.net.conf.vertices[name]

            def forward(*args, _fwd=v.forward, _n=name, **kw):
                out = _fwd(*args, **kw)
                self.outputs[_n] = out[0].detach()
                return out
            v.forward = forward           # shadows the class's method
        return self

    def __exit__(self, *exc):
        for name in self.names:
            del self.net.conf.vertices[name].forward


def reordered_conv(ck, x, w, b, pad=(0, 0), border_mode="truncate",
                   activation="identity"):
    """The plain version's function with the sum over K taken as the conv
    kernel takes it: slices of whole input channels, at most 64 K each
    (one channel where a channel's taps exceed 64), each slice's partial
    apart, the partials added in order in f32; then the bias, the
    activation and one rounding to x's dtype.  No kernel runs: the spread
    between it and the plain version is what the order of an f32 sum
    alone makes."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import activations as act_ops
    dt = x.dtype
    x, w, b = x.float(), w.float(), b.float()
    KH, KW = w.shape[2], w.shape[3]
    (pt, pb), (pl, pr) = ck.conv_pads(KH, KW, pad, border_mode)
    xp = F.pad(x, (pl, pr, pt, pb))
    step = max(1, ck._CONV_BK // (KH * KW))
    y = None
    for c in range(0, x.shape[1], step):
        part = F.conv2d(xp[:, c:c + step], w[:, c:c + step])
        y = part if y is None else y + part
    y = act_ops.get(activation or "identity")(y + b.reshape(1, -1, 1, 1))
    return y.to(dt)


def _plain_graph_step(torch, ck, net, params, opt_states, xs, ys, it,
                      states, kept=None, seeds=None, policy=None,
                      reordered=False):
    """One training step of graph ``net`` (one loss head, softmax +
    mcxent) from ``params`` / ``opt_states`` / ``states`` with every
    kernel replaced by its plain version: stride-1 convs through cuDNN
    (TF32 off), dropout through the plain hash with the step's ``seeds``
    (one pair of words per vertex in topological order, as the kernel
    step took them), the loss through the plain softmax cross-entropy,
    gradients by autograd; batch norm, the strided convs of the dense
    chain and the update are the graph's own.  With ``kept`` (the kernel
    step's outputs, :class:`_RecordedVertexOutputs` over
    :func:`_pinned_vertices`) each relu and max pool takes the kernel
    step's mask or argmax (:func:`_pin`).  A frozen vertex runs its inner
    layer's inference forward (a batch norm on its running statistics) and
    takes no gradient.  A mixed precision ``policy`` casts as in
    :func:`_plain_train_step`.  With ``reordered`` each stride-1 conv
    gives :func:`reordered_conv`'s value and the plain version's gradient:
    the same step with the conv's sum in the kernel's order, no kernel in
    it.  Returns (score, new params, new states, near ties)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        BatchNormalization, ConvolutionLayer, unfrozen)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import dtypes
    policy = policy or dtypes.FLOAT32
    leaves = {n: {k: v.detach().clone().requires_grad_(not net.frozen[n])
                  for k, v in lp.items()} for n, lp in params.items()}
    new_states = {n: dict(s) for n, s in states.items()}
    pins = _pinned_vertices(net) if kept is not None else {}
    out_name = net.conf.network_outputs[0]
    acts = dict(zip(net.conf.network_inputs, policy.cast_to_compute(xs)))
    remaining = dict(net._readers)
    ties = []
    with ck.full_f32_convs():
        for vi, name in enumerate(net.order):
            v = net.conf.vertices[name]
            ins = [acts[i] for i in net.conf.vertex_inputs[name]]
            layer = v.layer_conf() if hasattr(v, "layer_conf") else None
            frozen, layer = net.frozen[name], unfrozen(layer)
            p = policy.cast_to_compute(leaves[name])
            if layer is not None and layer.dropout and not frozen:
                if seeds is None or not (0.0 < layer.dropout < 1.0) or \
                        not ck.dropout_fused_supported(ins[0].shape,
                                                       ins[0].dtype):
                    raise ValueError(f"{name}: the plain graph step drops "
                                     f"out through the hash only")
                ins = [ck.threshold_dropout_reference(
                    ins[0], layer.dropout, seeds[vi])] + ins[1:]
            if name == out_name:
                h = torch.addmm(p["b"], ins[0], p["W"])
            elif isinstance(layer, ConvolutionLayer) and \
                    tuple(layer.stride) == (1, 1):
                h = ck.conv2d_bias_act_reference(
                    ins[0], p["W"], p["b"], tuple(layer.padding),
                    layer.convolution_mode, layer.activation)
                if reordered:
                    h = h + (reordered_conv(
                        ck, ins[0].detach(), p["W"].detach(),
                        p["b"].detach(), tuple(layer.padding),
                        layer.convolution_mode, layer.activation) - h
                    ).detach()
            elif isinstance(layer, BatchNormalization):
                h, ns, _ = layer.forward(p, new_states[name], ins[0],
                                         not frozen)
                new_states[name] = {k: t.detach() for k, t in ns.items()}
            elif name in pins:
                h = _pin(torch, layer, name, ins[0], kept[pins[name]], ties)
            else:
                h, _, _ = v.forward(p, {}, ins, True)
            acts[name] = h
            for i in net.conf.vertex_inputs[name]:
                remaining[i] -= 1
                if remaining[i] == 0:
                    acts.pop(i)
        loss, _ = ck.softmax_xent_reference(
            policy.cast_to_accum(acts[out_name]), ys[0])
        score = loss.mean()
        flat = iter(torch.autograd.grad(
            score, [t for lp in leaves.values() for t in lp.values()
                    if t.requires_grad]))
    grads = {n: {k: next(flat) for k, t in lp.items() if t.requires_grad}
             for n, lp in leaves.items()}
    del acts, leaves
    scratch = ComputationGraph(net.conf, device=net.device)
    scratch.net_params = {n: {k: t.detach().clone() for k, t in lp.items()}
                          for n, lp in params.items()}
    scratch.opt_states = opt_states
    scratch._apply_updates(grads, it)
    return float(score.detach()), scratch.net_params, new_states, ties


def _tf32_off(phase):
    """``phase`` runs with TF32 off in cuDNN and in matmuls; both flags
    are restored when it returns, so later phases run as they would
    without it."""
    @functools.wraps(phase)
    def run(torch, *args):
        flags = torch.backends.cudnn, torch.backends.cuda.matmul
        prev = [f.allow_tf32 for f in flags]
        for f in flags:
            f.allow_tf32 = False
        try:
            return phase(torch, *args)
        finally:
            for f, p in zip(flags, prev):
                f.allow_tf32 = p
    return run


@_tf32_off
def phase_resnet50_kernels(torch, ck) -> tuple:
    """The conv kernel at every distinct stride-1 conv shape of ResNet-50,
    at batch 128 (timed) and the serve ladder (untimed) -> (records, the
    summed set of one batch-128 forward's 46 stride-1 convs)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    records, ladder, seen = [], [], set()
    for batch in (RESNET_TRAIN_BATCH,) + SERVE_LADDER:
        timed = batch == RESNET_TRAIN_BATCH
        for shape in conv_shapes("resnet50", batch):
            if shape in seen:
                continue
            seen.add(shape)
            rec = check_conv(torch, ck, shape, gen, timed=timed)
            rec["model"] = "resnet50"
            (records if timed else ladder).append(rec)
    by_shape = {(tuple(r["shape"]), r["activation"]): r for r in records}
    rows = [by_shape[(tuple(s[:7]), s[7])]
            for s in conv_shapes("resnet50", RESNET_TRAIN_BATCH)]
    agg = {k: sum(r[k] for r in rows) for k in SET_SUMS}
    agg.update(convs=len(rows), tflops=agg["flops"] / agg["ms"] / 1e9,
               share_of_bound=agg["bound_ms"] / agg["ms"])
    if len(rows) != RESNET_KERNEL_CONVS:
        raise AssertionError(f"{len(rows)} stride-1 convs in ResNet-50")
    emit("resnet50_kernels", tf32=False, rtol=RTOL, atol_scaled=ATOL,
         timed_set={f"resnet50_{RESNET_TRAIN_BATCH}": agg},
         bound_note="as in the kernels line", shapes=records,
         untimed_shapes=ladder)
    return records + ladder, agg


@_tf32_off
def phase_serve_resnet50(torch, ck) -> dict:
    """ResNet-50 served from a zip the port wrote: 16 requests of 1-2 rows
    from 4 clients through Server -> predict -> ModelCache ->
    MicroBatcher -> ComputationGraph.output; then output() at batch 32."""
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)
    net = seeded_resnet50("cuda")
    sizes = _resnet_checked(net)
    rng = np.random.default_rng(SEED + 21)
    dims = (3, RESNET_HW, RESNET_HW)
    xs = [rng.normal(size=(int(rng.integers(1, 3)),) + dims).astype(
        np.float32) for _ in range(RESNET_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "resnet50.zip")
        write_model(net, path)
        del net
        server = Server(DeepLearning4jEntryPoint(
            device="cuda", max_batch=RESNET_SERVE_BATCH)).start()
        try:
            url = f"http://127.0.0.1:{server.port}/"
            t0 = time.perf_counter()
            warm = _rpc(url, "warmup", {"model_path": path,
                                        "feature_dims": list(dims)})
            warmup_s = time.perf_counter() - t0
            fallbacks = _conv_fallbacks()
            _zero_counts(ck)                           # main path starts
            drive = _drive(url, path, xs, clients=RESNET_CLIENTS)
            launches = _kernel_counts(ck)              # main path ends
            fallbacks = _conv_fallbacks() - fallbacks
            batcher = server.entry_point.stats()["serving"][
                str(Path(path).resolve())]
            served = server.entry_point.model_cache.get(path)
        finally:
            server.stop()
    peak = torch.cuda.max_memory_allocated()
    # 16 requests check the served classes and the launches; their rate
    # and latencies would measure nothing, so they are not reported
    res = {"requests": drive["requests"], "rows": drive["rows"],
           "batcher": {k: batcher[k] for k in (
               "batches", "rows", "batch_size_hist")}}
    batches = res["batcher"]["batches"]
    _check_served_classes("resnet50", xs, drive["answers"],
                          lambda x: served.output(x)[0])
    spread_served = _input_dependent(served.output(np.concatenate(xs))[0],
                                     "ResNet-50's served rows")
    if launches != _want(ck, conv2d_bias_act=RESNET_KERNEL_CONVS * batches) \
            or fallbacks != RESNET_DENSE_CONVS * batches:
        raise AssertionError(f"{batches} served batches: launches "
                             f"{launches}, {fallbacks} conv fallbacks")
    x32 = torch.randn((RESNET_SERVE_BATCH,) + dims,
                      generator=torch.Generator().manual_seed(SEED + 22))
    x32 = x32.cuda()
    walls, per_call = [], []
    for _ in range(5):
        before = ck.fused_conv2d_bias_act.launches
        t0 = time.perf_counter()
        out = served.output(x32)[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_call.append(ck.fused_conv2d_bias_act.launches - before)
    ref = _plain_graph_forward(torch, ck, served, x32)
    sums = out.sum(dim=1)
    if tuple(out.shape) != (RESNET_SERVE_BATCH, RESNET_CLASSES) or \
            not bool(torch.isfinite(out).all()) or \
            not torch.allclose(sums, torch.ones_like(sums), atol=1e-5) or \
            set(per_call) != {RESNET_KERNEL_CONVS}:
        raise AssertionError(f"ResNet-50 output at batch 32: {per_call}")
    torch.testing.assert_close(out, ref, rtol=NET_RTOL, atol=NET_ATOL)
    spread_32 = _input_dependent(out, "ResNet-50's output at batch 32")
    res.update(sizes, warmup_s=warmup_s, warmup_buckets=warm["buckets"],
               served_rows_spread=spread_served, output_32_spread=spread_32,
               launches=launches, conv_fallbacks=fallbacks,
               classes_equal_direct_output=True,
               output_32_ms=float(np.median(walls)),
               output_32_ms_each=walls, conv_launches_per_forward=per_call,
               output_32_max_abs_vs_plain=float((out - ref).abs().max()),
               classes_32=out.argmax(dim=1)[:16].tolist(),
               max_memory_allocated=peak)
    emit("serve_resnet50", **res)
    return res


@_tf32_off
def phase_train_resnet50(torch, ck) -> dict:
    """ResNet-50 trained with ``fit`` through the async pipeline at batch
    128: 3 timed steps, then one whose relu outputs and pool input are
    kept and which is held to the plain graph step."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    net = seeded_resnet50("cuda")
    _resnet_checked(net)
    rng = np.random.default_rng(SEED + 23)
    dims = (3, RESNET_HW, RESNET_HW)
    data = [DataSet(*_random_batch(rng, RESNET_TRAIN_BATCH, dims,
                                   RESNET_CLASSES))
            for _ in range(RESNET_STEPS + 1)]
    steps = []
    fit_batch = net._fit_batch

    def timed_batch(mds, seeds=None):     # each step, timed and counted
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        fit_batch(mds, seeds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": len(steps) + 1, "score": net.score(),
                      "seconds": dt,
                      "samples_per_s": RESNET_TRAIN_BATCH / dt,
                      "staged_on": str(mds.features[0].device),
                      "launches": {n: after[n] - counts[n] for n in after}})
    net._fit_batch = timed_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(data[:RESNET_STEPS]))
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    before = (_clone_tree(net.net_params), _clone_tree(net.opt_states),
              _clone_tree(net.net_state), net.iteration)
    recorded = _RecordedVertexOutputs(net, set(
        _pinned_vertices(net).values()))
    with recorded:
        net.fit(ListDataSetIterator(data[RESNET_STEPS:]))
    launches = _kernel_counts(ck)                      # main path ends
    del net._fit_batch
    want = _want(ck, conv2d_bias_act=RESNET_KERNEL_CONVS, softmax_xent=1)
    for st in steps:
        if st["launches"] != want or not np.isfinite(st["score"]) or \
                st["staged_on"] != "cuda:0":
            raise AssertionError(f"ResNet-50 step {st}: launches must be "
                                 f"{want}, the batch staged on the card and "
                                 f"the score finite")
    params0, opt0, states0, it = before
    x, y = (torch.from_numpy(a).cuda() for a in (data[-1].features,
                                                  data[-1].labels))
    plain_score, plain_params, plain_states, ties = _plain_graph_step(
        torch, ck, net, params0, opt0, [x], [y], it, states0,
        recorded.outputs)
    del recorded, opt0
    kernel_score = steps[-1]["score"]
    errs, stat_errs, bias_noise = {}, {}, {}
    noise_only = bn_fed_convs(net)
    for n in net.order:
        for k, t in net.net_params[n].items():
            upd = t - params0[n][k]
            plain_upd = plain_params[n][k] - params0[n][k]
            if n in noise_only and k == "b":
                w_upd = float(torch.linalg.vector_norm(
                    plain_params[n]["W"] - params0[n]["W"]))
                bias_noise[f"{n}_b"] = max(
                    float(torch.linalg.vector_norm(upd)),
                    float(torch.linalg.vector_norm(plain_upd))) / w_upd
            else:
                errs[f"{n}_{k}"] = _rel_norm(torch, upd, plain_upd)
        for k, t in net.net_state[n].items():
            stat_errs[f"{n}_{k}"] = _rel_norm(torch, t, plain_states[n][k])
    del params0, states0, plain_params
    timed = steps[1:RESNET_STEPS]
    res = {"batch": RESNET_TRAIN_BATCH, "steps": steps,
           "samples_per_s_after_first": RESNET_TRAIN_BATCH * len(timed)
           / sum(st["seconds"] for st in timed),
           "fit_seconds_3_steps": fit_s,
           "launches": launches, "max_memory_allocated": peak,
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "max_update_rel_err": max(errs.values()),
                          "worst_updates": dict(sorted(
                              errs.items(), key=lambda kv: -kv[1])[:8]),
                          "max_bn_stats_rel_err": max(stat_errs.values()),
                          "bn_fed_conv_biases": len(bias_noise),
                          "max_bn_fed_bias_update_over_w_update": max(
                              bias_noise.values()),
                          "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL,
                          "bn_stats_rtol": BN_STATS_RTOL,
                          "bn_bias_noise": BN_BIAS_NOISE,
                          "near_ties": ties, "tie_rtol": TIE_RTOL}}
    emit("train_resnet50", **res)
    ps = res["plain_step"]
    if ps["score_rel_diff"] > STEP_RTOL or \
            ps["max_update_rel_err"] > STEP_UPDATE_RTOL or \
            len(bias_noise) != 53 or \
            ps["max_bn_fed_bias_update_over_w_update"] > BN_BIAS_NOISE or \
            ps["max_bn_stats_rel_err"] > BN_STATS_RTOL or \
            len(ties) != len(_pinned_vertices(net)) or \
            max(t["max_rel_gap"] for t in ties) > TIE_RTOL:
        raise AssertionError("ResNet-50 step through the kernels disagrees "
                             "with the plain step")
    return res


def _timed_steps(torch, ck, net, snapshot_at=None):
    """Shadow ``net._fit_batch`` (``del net._fit_batch`` restores it):
    each step timed to the end of its kernels, with its launches, conv
    backward calls and conv fallbacks.  Before step ``snapshot_at`` (from
    1) the params, updater state, layer states, iteration, the step's
    seed words and its batch are kept.  -> (steps, snapshot)"""
    steps, snap = [], {}
    fit_batch = net._fit_batch

    def timed(ds, seeds=None):
        if len(steps) + 1 == snapshot_at:
            gen = net._generator.get_state()
            snap.update(params=_clone_tree(net.net_params),
                        opt=_clone_tree(net.opt_states),
                        states=_clone_tree(net.net_state), it=net.iteration,
                        seeds=net._draw_seeds().tolist(), batch=ds)
            net._generator.set_state(gen)
        counts, back = _kernel_counts(ck), ck._ConvBiasAct.backwards
        fallbacks = _conv_fallbacks()
        t0 = time.perf_counter()
        fit_batch(ds, seeds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": len(steps) + 1, "score": net.score(),
                      "seconds": dt,
                      "launches": {n: after[n] - counts[n] for n in after},
                      "conv_backwards": ck._ConvBiasAct.backwards - back,
                      "conv_fallbacks": _conv_fallbacks() - fallbacks})
    net._fit_batch = timed
    return steps, snap


def _check_steps(steps, want, fallbacks, what):
    """Every step launched ``want``, made no conv backward and ``fallbacks``
    conv fallbacks, with a finite score."""
    for st in steps:
        if st["launches"] != want or st["conv_backwards"] != 0 or \
                st["conv_fallbacks"] != fallbacks or \
                not np.isfinite(st["score"]):
            raise AssertionError(f"{what} step {st}: launches must be "
                                 f"{want}, {fallbacks} conv fallbacks, no "
                                 f"conv backward and the score finite")


def _frozen_unmoved(torch, net, before) -> int:
    """Raises unless every frozen entry's params and state equal
    ``before`` (``torch.equal``); returns the tensors compared."""
    n = 0
    for key, (params, state) in before.items():
        for got, want in ((net.net_params[key], params),
                          (net.net_state[key], state)):
            for k, t in want.items():
                if not torch.equal(got[k], t):
                    raise AssertionError(f"frozen {key} {k} moved")
                n += 1
    return n


def _frozen_copy(net) -> dict:
    keys = (range(len(net.layers)) if isinstance(net.frozen, list)
            else net.order)
    return {k: (_clone_tree(net.net_params[k]), _clone_tree(net.net_state[k]))
            for k in keys if net.frozen[k]}


def _update_errs(torch, net, plain_params, params0) -> dict:
    """Per trained param: ||kernel update - plain update|| / ||plain
    update||."""
    keys = (range(len(net.layers)) if isinstance(net.frozen, list)
            else net.order)
    return {f"{k}_{name}": _rel_norm(torch, t - params0[k][name],
                                     plain_params[k][name] - params0[k][name])
            for k in keys if not net.frozen[k]
            for name, t in net.net_params[k].items()}


def transfer_images(seed: int = SEED + 30):
    """TRANSFER_IMAGES seeded 224x224x3 images in TRANSFER_CLASSES classes,
    as DataSets of TRANSFER_BATCH."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((TRANSFER_IMAGES, 3, TRANSFER_HW, TRANSFER_HW),
                            np.float32)
    y = np.eye(TRANSFER_CLASSES, dtype=np.float32)[
        rng.integers(0, TRANSFER_CLASSES, TRANSFER_IMAGES)]
    return [DataSet(x[i:i + TRANSFER_BATCH], y[i:i + TRANSFER_BATCH])
            for i in range(0, TRANSFER_IMAGES, TRANSFER_BATCH)]


@_tf32_off
def phase_transfer_vgg16_224(torch, ck, train_vgg) -> tuple:
    """VGG16-224 with dropout, seeded, through a zip, fine-tuned at the
    bottleneck with its conv stack frozen: 20 ``fit`` steps at batch 32
    with three listeners; the last step against the plain step.
    -> (result, the fine-tuned net, its batches)"""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import vgg16
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DenseLayer, FrozenLayerConf, OutputLayer)
    from deeplearning4j_tpu_torch.nn.listeners import (
        CollectScoresIterationListener, PerformanceListener,
        ScoreIterationListener)
    from deeplearning4j_tpu_torch.nn.serialization import (
        restore_multi_layer_network, write_model)
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    src = vgg16(TRANSFER_HW, TRANSFER_HW, dropout=0.5, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "vgg16_224.zip"
        t0 = time.perf_counter()
        write_model(src, path)
        zip_write_s = time.perf_counter() - t0
        zip_bytes = path.stat().st_size
        del src
        t0 = time.perf_counter()
        src = restore_multi_layer_network(path, device="cuda")
        zip_read_s = time.perf_counter() - t0
    net = (TransferLearning.Builder(src)
           .fine_tune_configuration(FineTuneConfiguration(
               updater="nesterovs", learning_rate=TRANSFER_LR,
               seed=TRANSFER_SEED))
           .set_feature_extractor(TRANSFER_FROZEN)
           .n_out_replace(TRANSFER_FROZEN + 2, TRANSFER_FC2, "xavier")
           .remove_output_layer()
           .add_layer(DenseLayer(n_out=TRANSFER_HIDDEN, activation="relu"))
           .add_layer(OutputLayer(n_out=TRANSFER_CLASSES,
                                  activation="softmax", loss="mcxent"))
           .build())
    del src
    kinds = [type(l).__name__ for l in net.layers]
    if kinds != ["FrozenLayerConf"] * (TRANSFER_FROZEN + 1) + [
            "DenseLayer", "DenseLayer", "DenseLayer", "OutputLayer"] or \
            [l.dropout for l in net.layers[TRANSFER_FROZEN + 1:]] != \
            [0.5, 0.5, 0.0, 0.0] or not all(
                isinstance(l, FrozenLayerConf) for l in
                net.layers[:TRANSFER_FROZEN + 1]):
        raise AssertionError(f"fine-tuned VGG16: {kinds}")
    data = transfer_images()
    before = _frozen_copy(net)
    collect, perf = CollectScoresIterationListener(), PerformanceListener()
    net.set_listeners(ScoreIterationListener(5), collect, perf)
    n_steps = TRANSFER_EPOCHS * len(data)
    steps, snap = _timed_steps(torch, ck, net, snapshot_at=n_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(ck)                                   # main path starts
    net.fit(ListDataSetIterator(data), epochs=TRANSFER_EPOCHS)
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    del net._fit_batch
    # fc1 reads the frozen stack's output, which takes no gradient: its
    # dropout has no backward; fc2's has
    _check_steps(steps, _want(ck, conv2d_bias_act=13, threshold_dropout=3),
                 0, "fine-tuned VGG16-224")
    unmoved = _frozen_unmoved(torch, net, before)
    scores = [s for _, s in collect.scores]
    if len(scores) != n_steps or not np.isfinite(scores).all() or \
            len(perf.history) != n_steps - 1:
        raise AssertionError(f"listeners: {len(scores)} scores, "
                             f"{len(perf.history)} rates")
    x, y = (t if torch.is_tensor(t) else torch.from_numpy(t).cuda()
            for t in (snap["batch"].features, snap["batch"].labels))
    plain_score, plain_params, dropped, _, _ = _plain_train_step(
        torch, ck, net, snap["params"], snap["opt"], x, y, snap["seeds"],
        snap["it"])
    for i, h in dropped.items():
        rate, seed = net.layers[i].dropout, snap["seeds"][i]
        ones = torch.ones_like(h)
        if not (torch.equal(ck.fused_threshold_dropout(h, rate, seed),
                            ck.threshold_dropout_reference(h, rate, seed))
                and torch.equal(ck.fused_threshold_dropout(ones, rate, seed),
                                ck.threshold_dropout_reference(ones, rate,
                                                               seed))):
            raise AssertionError(f"layer {i}: dropout masks differ")
    errs = _update_errs(torch, net, plain_params, snap["params"])
    kernel_score = steps[-1]["score"]
    timed = steps[1:]
    step_ms = [st["seconds"] * 1e3 for st in timed]
    res = {"batch": TRANSFER_BATCH, "steps": len(steps),
           "frozen_layers": TRANSFER_FROZEN + 1, "n_params": net.n_params,
           "zip": {"bytes": zip_bytes, "write_s": zip_write_s,
                   "read_s": zip_read_s},
           "samples_per_s_after_first": TRANSFER_BATCH * len(timed)
           / sum(st["seconds"] for st in timed),
           "step_ms_median": float(np.median(step_ms)),
           "step_ms_min_max": [min(step_ms), max(step_ms)],
           "full_step_samples_per_s_batch_128":
               train_vgg["samples_per_s_after_first"],
           "launches_per_step": steps[-1]["launches"],
           "conv_backwards": sum(st["conv_backwards"] for st in steps),
           "launches": launches, "max_memory_allocated": peak,
           "frozen_tensors_unmoved": unmoved,
           "collected_scores": len(scores),
           "scores_first_last": [scores[0], scores[-1]],
           "listener_samples_per_s_median": float(np.median(
               [r["samples_per_sec"] for r in perf.history])),
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "update_rel_err": errs,
                          "max_update_rel_err": max(errs.values()),
                          "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL,
                          "dropout_masks_identical": sorted(dropped)}}
    emit("transfer_vgg16_224", **res)
    if res["plain_step"]["score_rel_diff"] > STEP_RTOL or \
            max(errs.values()) > STEP_UPDATE_RTOL or \
            sorted(dropped) != [TRANSFER_FROZEN + 1, TRANSFER_FROZEN + 2]:
        raise AssertionError("fine-tuned VGG16-224 step through the kernels "
                             "disagrees with the plain step")
    net.set_listeners()
    return res, net, data


@_tf32_off
def phase_featurize_vgg16_224(torch, ck, net, data) -> tuple:
    """The frozen stack run once over the images
    (``TransferLearningHelper.featurize``), then the unfrozen head fit on
    the features for 2 epochs.  -> (result, helper, features)"""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearningHelper)
    helper = TransferLearningHelper(net, TRANSFER_FROZEN)
    head = helper.unfrozen_network()
    # the head on the features is the whole net on the images
    first = helper.featurize(data[0])
    got, want = head.output(first.features), net.output(data[0].features)
    torch.testing.assert_close(got, want, rtol=NET_RTOL, atol=NET_ATOL)
    head_vs_net = float((got - want).abs().max())
    torch.cuda.synchronize()
    feats, per_batch = [], []
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    for ds in data:
        before = ck.fused_conv2d_bias_act.launches
        feats.append(helper.featurize(ds))
        per_batch.append(ck.fused_conv2d_bias_act.launches - before)
    torch.cuda.synchronize()
    featurize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    head.fit(ListDataSetIterator(feats), epochs=TRANSFER_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    steps = TRANSFER_EPOCHS * len(feats)
    shape = tuple(feats[0].features.shape)
    res = {"images": TRANSFER_IMAGES, "batch": TRANSFER_BATCH,
           "feature_shape": shape, "featurize_s": featurize_s,
           "images_per_s": TRANSFER_IMAGES / featurize_s,
           "conv_launches_per_batch": per_batch,
           "head_vs_net_max_abs": head_vs_net, "rtol": NET_RTOL,
           "atol": NET_ATOL, "head_fit_steps": steps, "head_fit_s": fit_s,
           "head_ms_per_step": fit_s / steps * 1e3,
           "head_score": head.score(), "launches": launches}
    emit("featurize_vgg16_224", **res)
    side = TRANSFER_HW // 32                   # five 2x2 pools
    if set(per_batch) != {13} or shape != (TRANSFER_BATCH, 512, side, side) \
            or \
            launches != _want(ck, conv2d_bias_act=13 * len(data),
                              threshold_dropout=3 * steps) or \
            not np.isfinite(res["head_score"]):
        raise AssertionError(f"featurize: {per_batch} conv launches a "
                             f"batch, features {shape}, launches {launches}")
    return res, helper, feats


def _timed_saves(listener, saves: dict):
    """``listener`` (a CheckpointListener) with each save's seconds and
    size appended to ``saves``."""
    save = listener._save

    def timed(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        saves["save_s"].append(time.perf_counter() - t0)
        saves["bytes"] = path.stat().st_size
        return path
    listener._save = timed
    return listener


@contextlib.contextmanager
def _timed_restore(saves: dict):
    """While active, each ``checkpoint.restore_into`` (``fit``'s resume)
    appends its seconds to ``saves["restore_s"]``."""
    from deeplearning4j_tpu_torch.nn import checkpoint
    restore = checkpoint.restore_into

    def timed(*args, **kw):
        t0 = time.perf_counter()
        meta = restore(*args, **kw)
        saves["restore_s"].append(time.perf_counter() - t0)
        return meta
    checkpoint.restore_into = timed
    try:
        yield
    finally:
        checkpoint.restore_into = restore


class _Interrupted(Exception):
    """The deliberate stop of early_stop_and_resume's interrupted fit."""


def _cut_after(data, limit):
    """A ListDataSetIterator over ``data`` that raises :class:`_Interrupted`
    when its ``limit``-th batch in all is asked for."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    class CutAfter(ListDataSetIterator):
        served = 0

        def next(self):
            self.served += 1
            if self.served == limit:
                raise _Interrupted()
            return super().next()
    return CutAfter(data)


def _rebatch(torch, feats, rows: int, batch: int):
    """The first ``rows`` featurized rows again as DataSets of ``batch``."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    x = torch.cat([f.features for f in feats])[:rows]
    y = np.concatenate([np.asarray(f.labels) for f in feats])[:rows]
    return [DataSet(x[i:i + batch], y[i:i + batch])
            for i in range(0, rows, batch)]


@_tf32_off
def phase_early_stop_and_resume(torch, ck, helper, feats) -> dict:
    """The featurized head (dropout in fc1 and fc2) under
    ``EarlyStoppingTrainer`` with a ``LocalFileModelSaver``, against a
    plain ``fit`` over the same batches; then a fit cut by an exception
    and resumed from its checkpoints, against the same fit uncut."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.nn.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.nn.serialization import (
        restore_multi_layer_network)
    rows = TRANSFER_IMAGES - EARLY_HELD
    train = _rebatch(torch, feats, rows, TRANSFER_BATCH)
    held = _rebatch(torch, feats[rows // TRANSFER_BATCH:], EARLY_HELD,
                    EARLY_HELD)[0]
    head = helper.unfrozen_network()
    spent = {"score_s": 0.0, "save_s": 0.0, "get_best_s": 0.0}
    saved_out = {}
    _zero_counts(ck)                                   # main path starts
    with tempfile.TemporaryDirectory() as tmp:
        saver = LocalFileModelSaver(tmp, device="cuda")
        calc = DataSetLossCalculator(held)
        save_best, get_best, score = (saver.save_best, saver.get_best,
                                      calc.calculate_score)

        def timed_save(model):
            t0 = time.perf_counter()
            save_best(model)
            spent["save_s"] += time.perf_counter() - t0
            saved_out["best"] = model.output(held.features)

        def timed_get_best():
            t0 = time.perf_counter()
            best = get_best()
            spent["get_best_s"] += time.perf_counter() - t0
            return best

        def timed_score(model):
            t0 = time.perf_counter()
            out = score(model)
            spent["score_s"] += time.perf_counter() - t0
            return out
        saver.save_best, saver.get_best = timed_save, timed_get_best
        calc.calculate_score = timed_score
        cfg = EarlyStoppingConfiguration(
            score_calculator=calc, model_saver=saver,
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(EARLY_MAX_EPOCHS),
                ScoreImprovementEpochTerminationCondition(EARLY_PATIENCE)])
        t0 = time.perf_counter()
        result = EarlyStoppingTrainer(cfg, head,
                                      ListDataSetIterator(train)).fit()
        torch.cuda.synchronize()
        es_s = time.perf_counter() - t0
        best_zip = restore_multi_layer_network(Path(tmp) / "bestModel.zip",
                                               device="cuda")
        zip_out = best_zip.output(held.features)
        best_out = result.best_model.output(held.features)
    plain = helper.unfrozen_network()
    t0 = time.perf_counter()
    plain.fit(ListDataSetIterator(train), epochs=result.total_epochs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if plain.iteration != head.iteration:
        raise AssertionError(f"{plain.iteration} plain steps for "
                             f"{head.iteration} early-stopping steps")
    # the trainer's own time a step: its fit calls and score reads
    es_ms = (es_s - spent["score_s"] - spent["save_s"] -
             spent["get_best_s"]) / head.iteration * 1e3
    # resume: the run cut after RESUME_CUT batches of its second epoch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    saves = {"save_s": [], "restore_s": []}
    try:
        data = _rebatch(torch, feats, rows, RESUME_BATCH)
        ref = helper.unfrozen_network()
        ref.fit(ListDataSetIterator(data), epochs=RESUME_EPOCHS)
        with tempfile.TemporaryDirectory() as tmp:
            cut = helper.unfrozen_network()
            cut.set_listeners(_timed_saves(CheckpointListener(
                tmp, save_every_n_iterations=RESUME_EVERY), saves))
            raised = False
            t0 = time.perf_counter()
            try:
                cut.fit(_cut_after(data, len(data) + RESUME_CUT + 1),
                        epochs=RESUME_EPOCHS)
            except _Interrupted:
                raised = True
            cut_s = time.perf_counter() - t0
            if not raised or cut.iteration != len(data) + RESUME_CUT:
                raise AssertionError(f"the cut fit ended at iteration "
                                     f"{cut.iteration}, raised {raised}")
            kept = len(CheckpointListener.checkpoints(tmp))
            resumed = helper.unfrozen_network()
            resumed.conf.global_conf.ft_resume = True
            resumed.set_listeners(_timed_saves(CheckpointListener(
                tmp, save_every_n_iterations=RESUME_EVERY), saves))
            t0 = time.perf_counter()
            with _timed_restore(saves):
                resumed.fit(ListDataSetIterator(data), epochs=RESUME_EPOCHS)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = prev
    launches = _kernel_counts(ck)                      # main path ends
    resumed_from = (len(data) + RESUME_CUT) // RESUME_EVERY * RESUME_EVERY
    steps = (head.iteration + plain.iteration + ref.iteration +
             cut.iteration + resumed.iteration - resumed_from)
    equal = (torch.equal(resumed.params(), ref.params())
             and torch.equal(resumed.updater_state_flat(),
                             ref.updater_state_flat()))
    res = {"early_stopping": {
               "termination_reason": result.termination_reason,
               "termination_details": result.termination_details,
               "total_epochs": result.total_epochs,
               "best_model_epoch": result.best_model_epoch,
               "best_model_score": result.best_model_score,
               "score_vs_epoch": result.score_vs_epoch,
               "iterations": head.iteration, "seconds": es_s,
               "score_s": spent["score_s"], "save_s": spent["save_s"],
               "get_best_s": spent["get_best_s"], "ms_per_step": es_ms,
               "plain_fit_ms_per_step": plain_s / plain.iteration * 1e3,
               "best_zip_equals_saved_output":
                   bool(torch.equal(zip_out, saved_out["best"])),
               "best_zip_equals_get_best":
                   bool(torch.equal(zip_out, best_out))},
           "resume": {"batch": RESUME_BATCH, "epochs": RESUME_EPOCHS,
                      "batches_per_epoch": len(data),
                      "save_every": RESUME_EVERY,
                      "cut_at_iteration": cut.iteration,
                      "checkpoints_kept": kept,
                      "checkpoint_bytes": saves["bytes"],
                      "saves": len(saves["save_s"]),
                      "save_s_each": saves["save_s"],
                      "restore_s": saves["restore_s"],
                      "resumed_from_iteration": resumed_from,
                      "iterations": resumed.iteration, "cut_s": cut_s,
                      "resume_s": resume_s,
                      "cudnn_deterministic": True,
                      "params_and_updater_equal": equal,
                      "params_rel_norm": _rel_norm(torch, resumed.params(),
                                                   ref.params())},
           "launches": launches}
    emit("early_stop_and_resume", **res)
    es_res = res["early_stopping"]
    if not np.isfinite(list(result.score_vs_epoch.values())).all() or \
            not es_res["best_zip_equals_saved_output"] or \
            not es_res["best_zip_equals_get_best"] or not equal or \
            resumed.iteration != ref.iteration or \
            resumed.epoch != ref.epoch or \
            launches != _want(ck, threshold_dropout=3 * steps):
        raise AssertionError("early stopping or resume failed its checks")
    return res


@_tf32_off
def phase_transfer_resnet50(torch, ck, train_resnet) -> dict:
    """ResNet-50 (``seeded_resnet50``) with every vertex through the global
    pool frozen and a 5-class head, 5 ``fit`` steps at batch 32; the last
    against the plain graph step."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearning)
    src = seeded_resnet50("cuda")
    net = (TransferLearning.GraphBuilder(src)
           .set_feature_extractor("gap")
           .remove_vertex_and_connections("fc")
           .add_layer("fc5", OutputLayer(n_out=TRANSFER_CLASSES,
                                         activation="softmax",
                                         loss="mcxent"), "gap")
           .set_outputs("fc5").build())
    states_kept = all(torch.equal(net.net_state[n][k], t)
                      for n, s in src.net_state.items() if n in net.net_state
                      for k, t in s.items())
    del src
    trained = [n for n in net.order
               if not net.frozen[n] and net.net_params[n]]
    if trained != ["fc5"] or not states_kept:
        raise AssertionError(f"ResNet-50 transfer trains {trained}; source "
                             f"statistics kept: {states_kept}")
    rng = np.random.default_rng(SEED + 31)
    data = [DataSet(*_random_batch(rng, TRANSFER_RESNET_BATCH,
                                   (3, RESNET_HW, RESNET_HW),
                                   TRANSFER_CLASSES))
            for _ in range(TRANSFER_RESNET_STEPS)]
    before = _frozen_copy(net)
    steps, snap = _timed_steps(torch, ck, net,
                               snapshot_at=TRANSFER_RESNET_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(ck)                                   # main path starts
    net.fit(ListDataSetIterator(data))
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    del net._fit_batch
    _check_steps(steps, _want(ck, conv2d_bias_act=RESNET_KERNEL_CONVS),
                 RESNET_DENSE_CONVS, "ResNet-50 transfer")
    unmoved = _frozen_unmoved(torch, net, before)
    x, y = (t if torch.is_tensor(t) else torch.from_numpy(t).cuda()
            for t in (snap["batch"].features[0], snap["batch"].labels[0]))
    plain_score, plain_params, plain_states, _ = _plain_graph_step(
        torch, ck, net, snap["params"], snap["opt"], [x], [y], snap["it"],
        snap["states"])
    errs = _update_errs(torch, net, plain_params, snap["params"])
    stats_equal = all(torch.equal(plain_states[n][k], t)
                      for n, s in net.net_state.items()
                      for k, t in s.items())
    timed = steps[1:]
    kernel_score = steps[-1]["score"]
    res = {"batch": TRANSFER_RESNET_BATCH, "steps": len(steps),
           "frozen_vertices": sum(net.frozen.values()),
           "trained": trained, "source_statistics_kept": states_kept,
           "samples_per_s_after_first": TRANSFER_RESNET_BATCH * len(timed)
           / sum(st["seconds"] for st in timed),
           "step_ms": [st["seconds"] * 1e3 for st in steps],
           "full_step_samples_per_s_batch_128":
               train_resnet["samples_per_s_after_first"],
           "full_step_max_memory_allocated":
               train_resnet["max_memory_allocated"],
           "launches_per_step": steps[-1]["launches"],
           "conv_fallbacks_per_step": steps[-1]["conv_fallbacks"],
           "conv_backwards": sum(st["conv_backwards"] for st in steps),
           "launches": launches, "max_memory_allocated": peak,
           "frozen_tensors_unmoved": unmoved,
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "update_rel_err": errs,
                          "max_update_rel_err": max(errs.values()),
                          "bn_stats_equal": stats_equal,
                          "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL}}
    emit("transfer_resnet50", **res)
    ps = res["plain_step"]
    if ps["score_rel_diff"] > STEP_RTOL or \
            ps["max_update_rel_err"] > STEP_UPDATE_RTOL or not stats_equal:
        raise AssertionError("ResNet-50 transfer step through the kernels "
                             "disagrees with the plain step")
    return res


# ---------------------------------------------------------------------------
# The bf16 tier: the bf16 forms of the conv and dropout kernels, and
# VGG16-224 and ResNet-50 trained and served under precision("bfloat16")
# ---------------------------------------------------------------------------

def bf16_ulp(torch, t):
    """The spacing of bf16 numbers at |t|, as f32: 2^(e - 7) for |t| in
    [2^e, 2^(e+1)), and the smallest normal's spacing below it."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    _, e = torch.frexp(a)                     # a = m 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(a), e - 8)


def bf16_conv_compare(torch, y, ref, atol: float = BF16_CONV_ATOL) -> dict:
    """The bf16 conv rule (|y - ref| <= ulp(ref) + ``atol`` max|ref|,
    BF16_CONV_ATOL unless given): the share of elements that differ from
    the plain version's, the share beyond one bf16 ulp, and the largest
    |y - ref| over what the rule allows (``max_excess``, at most 1)."""
    yf, rf = y.float(), ref.float()
    diff = (yf - rf).abs()
    ulp = bf16_ulp(torch, rf)
    scale = float(rf.abs().max())
    excess = float((diff / (ulp + atol * scale)).max())
    n = diff.numel()
    return {"elements": n, "share_differ": float((diff > 0).sum()) / n,
            "share_beyond_one_ulp": float((diff > ulp).sum()) / n,
            "max_excess": excess, "max_abs_err": float(diff.max()),
            "ref_scale": scale,
            "ok": excess <= 1.0 and bool(torch.isfinite(yf).all())}


def check_conv_bf16(torch, ck, shape, gen, timed: bool = True):
    """The conv kernel's bf16 form against its plain version at one shape
    (as :func:`check_conv`; bf16 x, He-scaled w and b), by the bf16 conv
    rule; raises on disagreement -> (record, (kernel, plain, library)
    callables on the same inputs)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import activations as act_ops
    N, Cin, H, W, Cout, K, p, act = shape
    KH, KW = (K, K) if isinstance(K, int) else K
    dev, bf = torch.device("cuda"), torch.bfloat16
    x = torch.randn((N, Cin, H, W), generator=gen, device=dev).to(bf)
    w = (torch.randn((Cout, Cin, KH, KW), generator=gen, device=dev)
         * (2.0 / (Cin * KH * KW)) ** 0.5).to(bf)
    b = (torch.randn((Cout,), generator=gen, device=dev) * 0.1).to(bf)
    pad = (p, p)
    act_fn = act_ops.get(act)

    def kernel():
        return ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation=act)

    def plain():
        return ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", act)

    def library():
        return act_fn(F.conv2d(x, w, b, padding=pad))
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    rec = {"shape": [N, Cin, H, W, Cout, K, p], "activation": act,
           "route": ck.conv_bf16_route(N, Cin, H, W, Cout, KH, KW, p, p),
           "dtype": str(y.dtype).replace("torch.", ""),
           **bf16_conv_compare(torch, y, ref)}
    if y.dtype != bf or not rec["ok"]:
        raise AssertionError(f"the conv kernel's bf16 form disagrees with "
                             f"its plain version: {rec}")
    del y, ref
    if not timed:
        return rec, None
    OH = H + 2 * p - KH + 1
    OW = W + 2 * p - KW + 1
    flops = 2 * N * Cout * Cin * valid_taps(H, KH, p, OH) * \
        valid_taps(W, KW, p, OW)
    nbytes = 2 * (x.numel() + w.numel() + b.numel() + N * Cout * OH * OW)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rec.update(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
               library_ms=time_ms(torch, library), flops=flops,
               bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec, (kernel, plain, library)


BF16_SET_SUMS = ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                 "bytes")


def bf16_conv_set(torch, ck, shapes, gen, graph_calls: int) -> tuple:
    """A set of convs (a model's forward at one batch, a repeated shape as
    often as it runs) through the bf16 form: each distinct shape checked
    and timed by CUDA events, the sums over the set, and the whole set
    replayed from a CUDA graph of ``graph_calls`` passes (kernel, plain
    and library apart) -> (records, sums)."""
    recs, fns = {}, {}
    for s in shapes:
        if s not in recs:
            recs[s], fns[s] = check_conv_bf16(torch, ck, s, gen)
    agg = {k: sum(recs[s][k] for s in shapes) for k in BF16_SET_SUMS}
    for key, i in (("graph_ms", 0), ("plain_graph_ms", 1),
                   ("library_graph_ms", 2)):
        agg[key] = graph_ms(torch, lambda i=i: [fns[s][i]() for s in shapes],
                            calls=graph_calls, reps=3)
    del fns
    torch.cuda.empty_cache()
    elements = sum(recs[s]["elements"] for s in shapes)
    agg.update(
        convs=len(shapes), tflops=agg["flops"] / agg["ms"] / 1e9,
        share_of_bound=agg["bound_ms"] / agg["ms"],
        graph_share_of_bound=agg["bound_ms"] / agg["graph_ms"],
        max_excess=max(r["max_excess"] for r in recs.values()),
        max_abs_err=max(r["max_abs_err"] for r in recs.values()),
        share_differ=sum(recs[s]["share_differ"] * recs[s]["elements"]
                         for s in shapes) / elements,
        share_beyond_one_ulp=sum(recs[s]["share_beyond_one_ulp"]
                                 * recs[s]["elements"] for s in shapes)
        / elements)
    return list(recs.values()), agg


# the timed bf16 conv sets: (name, shapes, CUDA-graph passes); every conv
# of the two served models at 32 rows (the kernels line's set), VGG16-224
# at its serving and training batches, ResNet-50's 46 stride-1 convs at
# its training batch, the text CNN's three full-width convs at D = 300
def bf16_conv_sets():
    return [("lenet_32", conv_shapes("lenet", 32), 10),
            ("vgg16_cifar10_32", conv_shapes("vgg16_cifar10", 32), 5),
            ("vgg16_224_8", conv_shapes("vgg16_224", 8), 2),
            (f"vgg16_224_{VGG_BATCH}", conv_shapes("vgg16_224", VGG_BATCH),
             1),
            (f"resnet50_{RESNET_TRAIN_BATCH}",
             conv_shapes("resnet50", RESNET_TRAIN_BATCH), 1),
            (f"textcnn_{TEXTCNN_D}", textcnn_convs(TEXTCNN_D), 10)]


# the edges of the bf16 form's routes, checked untimed.  The halo route:
# Cout 32, 64 + 1 and 128 + 1 (BN 32 and 64, a ragged last Cout tile); a
# 3x3 at each of ResNet-50's plane sizes, 56, 28, 14 and 7 (x's planes
# 16-, 16-, 8- and 2-byte aligned); several images a tile (7 x 7);
# N = 1 and a cluster split (512 channels at 14 x 14); Cin 3 and 20 (a
# slice of whole channels, K past one slice); a padded 1x1.  The GEMM
# route (a 1x1 with no padding): each plane size (16- and 8-byte copies,
# the pre-pass image at 7 x 7); pixels not a multiple of a tile (10 x
# 10); tiles across images at 14 x 14 and 7 x 7; Cout 32, 64 (64 x 128
# blocks), 65, 129 and 2,048; N = 1 and a cluster split (2,048 channels at
# 7 x 7, 1,024 at 14 x 14); an odd plane (9 x 9, pixels stored one by
# one).  And, on a 3x3 and on an even and an odd 1x1, every activation
BF16_CONV_EDGES = [
    (2, 64, 56, 56, 32, 1, 0, "identity"), (2, 64, 56, 56, 65, 3, 1, "relu"),
    (2, 128, 28, 28, 129, 1, 0, "identity"),
    (2, 128, 28, 28, 64, 3, 1, "relu"),
    (2, 256, 14, 14, 65, 1, 0, "identity"),
    (2, 256, 14, 14, 129, 3, 1, "relu"),
    (3, 512, 7, 7, 129, 1, 0, "identity"), (3, 512, 7, 7, 32, 3, 1, "relu"),
    (1, 512, 14, 14, 512, 3, 1, "relu"),
    (1, 2048, 7, 7, 512, 1, 0, "identity"),
    (1, 3, 9, 9, 32, 3, 1, "relu"), (2, 20, 12, 12, 50, 5, 0, "identity"),
    (2, 64, 14, 14, 96, 1, 1, "relu"),
    (2, 64, 10, 10, 64, 1, 0, "relu"), (3, 256, 14, 14, 128, 1, 0, "relu"),
    (5, 512, 7, 7, 256, 1, 0, "identity"), (2, 64, 56, 56, 64, 1, 0, "relu"),
    (2, 512, 7, 7, 2048, 1, 0, "relu"),
    (1, 1024, 14, 14, 256, 1, 0, "relu"), (2, 40, 9, 9, 70, 1, 0, "relu"),
]


def bf16_conv_edges(ck):
    """:data:`BF16_CONV_EDGES`, then every activation on a 3x3 (the halo
    route) and on a 1x1 of an even and of an odd plane (the GEMM route's
    pair and single stores)."""
    return BF16_CONV_EDGES + [(2, 40, h, h, 70, k, p, act)
                              for h, k, p in ((9, 3, 1), (8, 1, 0), (9, 1, 0))
                              for act in sorted(ck.CONV_FUSED_ACTS)]


@_tf32_off
def phase_bf16_kernels(torch, ck) -> dict:
    """The bf16 forms of the conv and dropout kernels against their plain
    versions: the conv on :func:`bf16_conv_sets` (timed), on the serving
    ladders' other batches and at its routes' edges
    (:func:`bf16_conv_edges`; checked), by the bf16 conv rule; dropout
    ``torch.equal`` forward and backward at VGG16-224's four launches and
    the edges, with masks equal to the f32 form's; bf16 HGMMA in every
    instance of every bf16 conv kernel in the conv library's SASS, and no
    ``serialized`` note of ptxas on any of them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    sets, records = {}, []
    for name, shapes, calls in bf16_conv_sets():
        recs, agg = bf16_conv_set(torch, ck, shapes, gen, calls)
        for r in recs:
            r["set"] = name
        records += recs
        sets[name] = agg
    seen = {tuple(r["shape"]) + (r["activation"],) for r in records}
    untimed = []
    for model, batches in (("resnet50", SERVE_LADDER),
                           ("vgg16_224", (1, 32))):
        for batch in batches:
            for s in conv_shapes(model, batch):
                key = tuple(s[:7]) + (s[7],)
                if key not in seen:
                    seen.add(key)
                    rec, _ = check_conv_bf16(torch, ck, s, gen, timed=False)
                    untimed.append(rec)
    for s in bf16_conv_edges(ck):
        rec, _ = check_conv_bf16(torch, ck, s, gen, timed=False)
        untimed.append(rec)
    bf = torch.bfloat16
    fc_in = [(VGG_BATCH, 25088), (VGG_BATCH, 4096)]
    drop = [check_dropout(torch, ck, s, 0.5, gen, timed=True, dtype=bf)
            for s in fc_in]
    drop += [check_dropout(torch, ck, s, r, gen, offset=o, dtype=bf)
             for s, r, o in (((VGG_BATCH, 25088), 0.8, 0),
                             ((VGG_BATCH, 4096), 0.8, 0),
                             ((3, 4099), 0.5, 0), ((3, 4099), 0.8, 0),
                             ((VGG_BATCH, 4096), 0.5, 1), ((4097,), 0.5, 0))]
    serialized = [f for _, f in serialized_wgmmas(ck.CONV_LIBRARY)
                  if any(k in f for k in BF16_CONV_KERNELS)]
    if serialized:
        raise AssertionError(f"ptxas serialised the wgmmas of bf16 conv "
                             f"instances: {serialized}")
    res = {"sets": sets, "records": records, "untimed": untimed,
           "dropout": drop,
           "sass_bf16_hgmma": hgmma_count(ck, ck.CONV_LIBRARY,
                                          "|".join(BF16_CONV_KERNELS),
                                          "BF16"),
           "full_width_sass_bf16_hgmma": hgmma_count(
               ck, ck.CONV_LIBRARY, r"conv_wgmma_bf16_kernelILi\d+ELb1E",
               "BF16"),
           "halo_sass_bf16_hgmma": hgmma_count(
               ck, ck.CONV_LIBRARY, r"conv_wgmma_bf16_kernelILi\d+ELb0E",
               "BF16"),
           "gemm_sass_bf16_hgmma": hgmma_count(
               ck, ck.CONV_LIBRARY, "conv_gemm_bf16_kernel", "BF16"),
           "serialized_bf16_instances": serialized}
    emit("bf16_kernels", tf32=False, conv_rule="|y - ref| <= ulp_bf16(ref) "
         "+ BF16_CONV_ATOL * max|ref|", conv_atol_scaled=BF16_CONV_ATOL,
         bound_note="bound_ms: FLOPs at PEAK_BF16_FLOPS or 2-byte elements "
                    "at PEAK_BYTES; library_ms: cuDNN bf16 conv + "
                    "activation; dropout's F.dropout on bf16, forward + "
                    "its mask-multiply backward",
         timed_sets=sets, shapes=records, untimed_shapes=untimed,
         dropout=drop, sass_bf16_hgmma=res["sass_bf16_hgmma"],
         full_width_sass_bf16_hgmma=res["full_width_sass_bf16_hgmma"],
         halo_sass_bf16_hgmma=res["halo_sass_bf16_hgmma"],
         gemm_sass_bf16_hgmma=res["gemm_sass_bf16_hgmma"],
         serialized_bf16_instances=serialized,
         routes={r["set"] + " " + str(r["shape"]): r["route"]
                 for r in records})
    return res


def _tensor_leaves(tree):
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str)
                for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if hasattr(tree, "dtype") else []


def _dtypes_of(tree) -> list:
    return sorted({str(t.dtype).replace("torch.", "")
                   for t in _tensor_leaves(tree)})


def _f32_step_cosine(torch, net, snap, bf16_params) -> dict:
    """The bf16 step's update against the f32 kernel step's from the same
    params, updater state, layer states, seed words and batch (``snap``,
    :func:`_timed_steps`): the cosine of the two whole-network update
    vectors, JAX's rule (tests/test_precision.py:114-128), and each one's
    2-norm.  The network is left as it was."""
    g = net.conf.global_conf
    keep = (g.precision, net.net_params, net.opt_states, net.net_state,
            net.iteration, net._score)
    net.net_params = _clone_tree(snap["params"])
    net.opt_states = _clone_tree(snap["opt"])
    net.net_state, net.iteration = _clone_tree(snap["states"]), snap["it"]
    g.precision = None
    try:
        net._fit_batch(snap["batch"], snap["seeds"])
        f32_params = net.net_params
    finally:
        (g.precision, net.net_params, net.opt_states, net.net_state,
         net.iteration, net._score) = keep
    dot = na = nb = 0.0
    for p0, a, b in zip(_tensor_leaves(snap["params"]),
                        _tensor_leaves(bf16_params),
                        _tensor_leaves(f32_params)):
        ua, ub = (a - p0).double(), (b - p0).double()
        dot += float((ua * ub).sum())
        na += float((ua * ua).sum())
        nb += float((ub * ub).sum())
    return {"cosine": dot / (na * nb) ** 0.5, "bf16_update_norm": na ** 0.5,
            "f32_update_norm": nb ** 0.5, "cosine_min": BF16_COSINE_MIN}


def _recording_grad_dtypes(net) -> set:
    """Shadow ``net._apply_updates`` (``del net._apply_updates`` restores
    it): the dtypes of every gradient it is given go into the returned
    set."""
    seen = set()
    apply = net._apply_updates

    def recording(grads, it):
        seen.update(_dtypes_of(grads))
        return apply(grads, it)
    net._apply_updates = recording
    return seen


def _check_bf16_steps(steps, want, conv_backwards, fallbacks, what):
    for st in steps:
        if st["launches"] != want or \
                st["conv_backwards"] != conv_backwards or \
                st["conv_fallbacks"] != fallbacks or \
                not np.isfinite(st["score"]):
            raise AssertionError(f"{what} step {st}: launches must be "
                                 f"{want}, {conv_backwards} conv backwards, "
                                 f"{fallbacks} conv fallbacks and the score "
                                 f"finite")


def _f32_masters(net, what) -> dict:
    """Raises unless params, updater state and layer states are all f32."""
    res = {"params": _dtypes_of(net.net_params),
           "updater_state": _dtypes_of(net.opt_states),
           "layer_states": _dtypes_of(net.net_state)}
    if any(v not in ([], ["float32"]) for v in res.values()):
        raise AssertionError(f"{what}: masters, updater state and layer "
                             f"states must be float32: {res}")
    return res


def phase_train_vgg16_224_bf16(torch, ck, train_vgg) -> dict:
    """VGG16-224 with dropout 0.5 as phase 7, under precision("bfloat16"):
    3 timed ``fit`` steps at batch 128, the last recording its layer
    outputs; the kernel's 13 outputs of that step against the plain version
    on its own conv inputs; the step against the plain bf16 step (max-pool
    argmax pinned) and against the f32 kernel step from the same params."""
    from deeplearning4j_tpu_torch.models import vgg16
    from deeplearning4j_tpu_torch.ops import dtypes
    torch.backends.cudnn.allow_tf32 = True           # as phase 7
    net = vgg16(dropout=0.5, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    net.conf.global_conf.precision = "bfloat16"
    x, y = _random_batch(np.random.default_rng(SEED), VGG_BATCH,
                         (3, 224, 224), 1000)
    steps, snap = _timed_steps(torch, ck, net, snapshot_at=VGG_STEPS)
    grad_dtypes = _recording_grad_dtypes(net)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    drop_fallbacks = _fallbacks("dropout")
    _zero_counts(ck)                                   # main path starts
    for k in range(VGG_STEPS - 1):
        net.fit(x, y)
    peak = torch.cuda.max_memory_allocated()   # steps 1-2: the third keeps
    with _RecordedOutputs(net) as recorded:    # its layer outputs besides
        net.fit(x, y)
    launches = _kernel_counts(ck)                      # main path ends
    drop_fallbacks = _fallbacks("dropout") - drop_fallbacks
    del net._fit_batch, net._apply_updates
    masters = _f32_masters(net, "VGG16-224 bf16")
    want = _want(ck, conv2d_bias_act_bf16=13, softmax_xent=1,
                 threshold_dropout_bf16=4)
    _check_bf16_steps(steps, want, 13, 0, "VGG16-224 bf16")
    xd = net._as_float(snap["batch"].features)
    yd = net._as_float(snap["batch"].labels)
    seeds = snap["seeds"]
    outs = recorded.outputs
    on_path = _path_convs_vs_plain(torch, ck, [
        (i, layer, outs[i - 1] if i else dtypes.BF16.cast_to_compute(xd),
         dtypes.BF16.cast_to_compute(snap["params"][i]), outs[i])
        for i, layer in enumerate(net.layers)
        if type(layer).__name__ == "ConvolutionLayer"])
    plain_score, plain_params, dropped, _, ties = _plain_train_step(
        torch, ck, net, snap["params"], _clone_tree(snap["opt"]), xd, yd,
        seeds, snap["it"], kernel_outputs=recorded.outputs,
        policy=dtypes.BF16)
    del recorded, outs
    masks = {}
    for i, h in dropped.items():                 # bf16 kernel vs plain on
        rate = net.layers[i].dropout             # the same inputs, masks
        ones = torch.ones_like(h)                # equal to the f32 form's
        kmask = ck.fused_threshold_dropout(ones, rate, seeds[i]) != 0
        plain_mask = ck.threshold_dropout_reference(ones, rate, seeds[i]) != 0
        f32_mask = ck.fused_threshold_dropout(ones.float(), rate,
                                              seeds[i]) != 0
        masks[i] = {"dtype": str(h.dtype).replace("torch.", ""),
                    "equal_outputs": torch.equal(
                        ck.fused_threshold_dropout(h, rate, seeds[i]),
                        ck.threshold_dropout_reference(h, rate, seeds[i])),
                    "equal_masks": torch.equal(kmask, plain_mask),
                    "equal_f32_masks": torch.equal(kmask, f32_mask)}
    errs = _update_errs(torch, net, plain_params, snap["params"])
    del plain_params
    kernel_score = steps[-1]["score"]
    cosine = _f32_step_cosine(torch, net, snap, net.net_params)
    res = {"batch": VGG_BATCH, "precision": "bfloat16", "steps": steps,
           "samples_per_s_after_first": VGG_BATCH * (len(steps) - 1)
           / sum(s["seconds"] for s in steps[1:]),
           "f32_samples_per_s_after_first":
               train_vgg["samples_per_s_after_first"],
           "launches": launches, "dropout_fallbacks": drop_fallbacks,
           "max_memory_allocated_steps_1_2": peak,
           "f32_max_memory_allocated": train_vgg["max_memory_allocated"],
           "dtypes": {**masters, "gradients": sorted(grad_dtypes)},
           "convs_on_path_vs_plain": on_path,
           "plain_step": {"score": plain_score, "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "max_update_rel_err": max(errs.values()),
                          "worst_updates": dict(sorted(
                              errs.items(), key=lambda kv: -kv[1])[:6]),
                          "score_rtol": BF16_STEP_RTOL,
                          "update_rtol": BF16_UPDATE_RTOL,
                          "near_ties": ties, "tie_rtol": BF16_TIE_RTOL,
                          "dropout": masks},
           "f32_step": cosine}
    emit("train_vgg16_224_bf16", **res)
    ps = res["plain_step"]
    if ps["score_rel_diff"] > BF16_STEP_RTOL or \
            ps["max_update_rel_err"] > BF16_UPDATE_RTOL or \
            len(ties) != 5 or \
            max(t["max_rel_gap"] for t in ties) > BF16_TIE_RTOL or \
            len(masks) != 2 or \
            not all(all(v for k, v in m.items() if k != "dtype")
                    and m["dtype"] == "bfloat16" for m in masks.values()) or \
            grad_dtypes != {"float32"} or \
            cosine["cosine"] < BF16_COSINE_MIN or drop_fallbacks != 0:
        raise AssertionError("VGG16-224's bf16 step disagrees with the plain "
                             "bf16 step or the f32 step")
    return res


def _path_convs_vs_plain(torch, ck, items) -> dict:
    """The conv kernel's bf16 outputs of a training step against the plain
    version on the same step's inputs (its own activations, not random
    data), by the bf16 conv rule: ``items`` are (name, layer, x, params in
    bf16, kernel output).  Raises on disagreement."""
    worst = {"convs": 0, "elements": 0, "max_excess": 0.0,
             "share_differ": 0.0, "share_beyond_one_ulp": 0.0}
    for name, layer, x, p, y in items:
        ref = ck.conv2d_bias_act_reference(
            x, p["W"], p["b"], tuple(layer.padding), layer.convolution_mode,
            layer.activation)
        rec = bf16_conv_compare(torch, y, ref)
        if not rec["ok"]:
            raise AssertionError(f"conv {name} of the bf16 step disagrees "
                                 f"with the plain version on its own "
                                 f"inputs: {rec}")
        worst["convs"] += 1
        worst["elements"] += rec["elements"]
        for k in ("max_excess", "share_differ", "share_beyond_one_ulp"):
            worst[k] = max(worst[k], rec[k])
    return worst


@_tf32_off
def phase_train_resnet50_bf16(torch, ck, train_resnet) -> dict:
    """ResNet-50 as phase 8i under precision("bfloat16"), from
    ``seeded_resnet50(batch_norms=False)`` with the last batch norm of each
    residual branch at gamma 0, as large-batch ResNet-50 training starts
    (Goyal et al. 2017, "Accurate, Large Minibatch SGD", 5.1):
    RESNET_BF16_STEPS ``fit`` steps at batch 128 through the async
    pipeline, then one more under cuDNN's deterministic algorithms
    recording every vertex's output.  Held: the kernel's 46 outputs
    against the plain version on that step's own conv inputs (the bf16
    conv rule); the step against the plain bf16 graph step from the same
    state (relu masks and max-pool argmax pinned) by the bf16 rules:
    score, updates, BN running statistics, near ties, each BN-fed conv
    bias's update over the plain step's; against the f32 kernel step
    (cosine); and, that the state allows the comparison, the plain step
    with its conv summed in the kernel's order (``reordered``, no kernel
    in it) against the plain step by the same rules.  A bf16 step parts
    from one with its sums in another order as far as bf16 and f32 do in
    phase 8i's calibrated net and in the seeded one with every residual
    branch live (updates 0.17 and 0.30 apart with no kernel in either),
    and at this net's fourth step the stage-3 batch norms' gammas still
    move 0.146; at its eleventh 0.064 (PERF.md)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    from deeplearning4j_tpu_torch.ops import dtypes
    net = seeded_resnet50("cuda", batch_norms=False)
    for n in net.order:                   # zero-gamma residual branches
        if n.endswith("_c_bn"):
            net.net_params[n]["gamma"].zero_()
    net.conf.global_conf.precision = "bfloat16"
    rng = np.random.default_rng(SEED + 23)
    dims = (3, RESNET_HW, RESNET_HW)
    data = [DataSet(*_random_batch(rng, RESNET_TRAIN_BATCH, dims,
                                   RESNET_CLASSES))
            for _ in range(RESNET_BF16_STEPS + 1)]
    steps, snap = _timed_steps(torch, ck, net,
                               snapshot_at=RESNET_BF16_STEPS + 1)
    grad_dtypes = _recording_grad_dtypes(net)
    out_name = net.conf.network_outputs[0]
    recorded = _RecordedVertexOutputs(
        net, [n for n in net.order if n != out_name])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    deterministic = torch.backends.cudnn.deterministic
    try:
        _zero_counts(ck)                               # main path starts
        net.fit(ListDataSetIterator(data[:RESNET_BF16_STEPS]))
        peak = torch.cuda.max_memory_allocated()       # the timed steps
        torch.backends.cudnn.deterministic = True
        with recorded:
            net.fit(ListDataSetIterator(data[RESNET_BF16_STEPS:]))
        launches = _kernel_counts(ck)                  # main path ends
        del net._fit_batch, net._apply_updates
        masters = _f32_masters(net, "ResNet-50 bf16")
        want = _want(ck, conv2d_bias_act_bf16=RESNET_KERNEL_CONVS,
                     softmax_xent=1)
        _check_bf16_steps(steps, want, RESNET_KERNEL_CONVS,
                          RESNET_DENSE_CONVS, "ResNet-50 bf16")
        mds = snap["batch"]
        params0, states0 = snap["params"], snap["states"]
        outs = recorded.outputs
        convs = []
        for n in net.order:
            layer = net.conf.vertices[n].layer_conf() \
                if hasattr(net.conf.vertices[n], "layer_conf") else None
            if isinstance(layer, ConvolutionLayer) and \
                    tuple(layer.stride) == (1, 1):
                convs.append((n, layer, outs[net.conf.vertex_inputs[n][0]],
                              dtypes.BF16.cast_to_compute(params0[n]),
                              outs[n]))
        on_path = _path_convs_vs_plain(torch, ck, convs)
        del convs
        xs = [net._as_float(t) for t in mds.features]
        ys = [net._as_float(t) for t in mds.labels]
        step = (net.score(), net.net_params, net.net_state)
        score, params, states, ties = _plain_graph_step(
            torch, ck, net, params0, _clone_tree(snap["opt"]), xs, ys,
            snap["it"], states0, outs, policy=dtypes.BF16)
        plain = _with_ties(_graph_step_vs(
            torch, net, params0, step, (score, params, states)), ties)
        # the witness: the plain step with the conv summed in the kernel's
        # order, against the plain step; no kernel in either
        w_score, w_params, w_states, w_ties = _plain_graph_step(
            torch, ck, net, params0, _clone_tree(snap["opt"]), xs, ys,
            snap["it"], states0, outs, policy=dtypes.BF16, reordered=True)
        witness = _with_ties(_graph_step_vs(
            torch, net, params0, (w_score, w_params, w_states),
            (score, params, states)), w_ties)
        del params, states, w_params, w_states
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del recorded, outs
    cosine = _f32_step_cosine(torch, net, snap, net.net_params)
    timed = steps[1:RESNET_BF16_STEPS]
    res = {"batch": RESNET_TRAIN_BATCH, "precision": "bfloat16",
           "net": "seeded_resnet50(batch_norms=False), *_c_bn gamma 0",
           "steps": steps,
           "samples_per_s_after_first": RESNET_TRAIN_BATCH * len(timed)
           / sum(st["seconds"] for st in timed),
           "f32_samples_per_s_after_first":
               train_resnet["samples_per_s_after_first"],
           "launches": launches, "max_memory_allocated_timed_steps": peak,
           "f32_max_memory_allocated": train_resnet["max_memory_allocated"],
           "dtypes": {**masters, "gradients": sorted(grad_dtypes)},
           "convs_on_path_vs_plain": on_path,
           "plain_step": {**plain, "score_rtol": BF16_STEP_RTOL,
                          "update_rtol": BF16_UPDATE_RTOL,
                          "bn_stats_rtol": BF16_BN_STATS_RTOL,
                          "bn_bias_over_plain": BF16_BN_BIAS_OVER_PLAIN,
                          "tie_rtol": BF16_TIE_RTOL},
           "reordered_plain_step_vs_plain": witness,
           "f32_step": cosine}
    emit("train_resnet50_bf16", **res)
    pins = len(_pinned_vertices(net))
    bad = [what for what, rec in (("the kernel step", plain),
                                  ("the reordered plain step", witness))
           if rec["score_rel_diff"] > BF16_STEP_RTOL or
           rec["max_update_rel_err"] > BF16_UPDATE_RTOL or
           rec["bn_fed_conv_biases"] != 53 or
           rec["max_bn_fed_bias_update_over_plain"] >
           BF16_BN_BIAS_OVER_PLAIN or
           rec["max_bn_stats_rel_err"] > BF16_BN_STATS_RTOL or
           rec["pinned_vertices"] != pins or
           rec["max_tie_gap"] > BF16_TIE_RTOL]
    if bad or grad_dtypes != {"float32"} or \
            cosine["cosine"] < BF16_COSINE_MIN:
        raise AssertionError(f"ResNet-50's bf16 step: {bad} against the "
                             f"plain bf16 step, gradients {grad_dtypes}, "
                             f"f32 cosine {cosine['cosine']}")
    return res


def _graph_step_vs(torch, net, params0, step, plain) -> dict:
    """A graph's step against a plain step from ``params0``, each given as
    (score, new params, new states): the score, every param's update in
    relative 2-norm but a BN-fed conv's bias, the running statistics, and
    each BN-fed conv bias's update (0 in exact arithmetic, so held apart,
    as phase 8i holds it) over its weight's in both steps and over the
    plain step's, either way up."""
    (score, params, states), (p_score, p_params, p_states) = step, plain
    errs, stat_errs, noise, fed_errs = {}, {}, {}, {}
    fed = bn_fed_convs(net)
    for n in net.order:
        for k, t in params[n].items():
            upd = t - params0[n][k]
            plain_upd = p_params[n][k] - params0[n][k]
            if n not in fed or k != "b":
                errs[f"{n}_{k}"] = _rel_norm(torch, upd, plain_upd)
            else:
                a = float(torch.linalg.vector_norm(upd))
                b = float(torch.linalg.vector_norm(plain_upd))
                fed_errs[f"{n}_{k}"] = max(a / b, b / a)
                w_upd = float(torch.linalg.vector_norm(
                    p_params[n]["W"] - params0[n]["W"]))
                noise[f"{n}_b"] = (
                    float(torch.linalg.vector_norm(upd)) / w_upd,
                    float(torch.linalg.vector_norm(plain_upd)) / w_upd)
        for k, t in states[n].items():
            stat_errs[f"{n}_{k}"] = _rel_norm(torch, t, p_states[n][k])
    return {"score": p_score, "step_score": score,
            "score_rel_diff": abs(p_score - score) / abs(p_score),
            "max_update_rel_err": max(errs.values()),
            "worst_updates": dict(sorted(errs.items(),
                                         key=lambda kv: -kv[1])[:6]),
            "max_bn_stats_rel_err": max(stat_errs.values()),
            "bn_fed_conv_biases": len(noise),
            "max_bn_fed_bias_update_over_w_update": max(
                max(v) for v in noise.values()),
            "worst_bn_fed_biases_step_and_plain": dict(sorted(
                noise.items(), key=lambda kv: -max(kv[1]))[:4]),
            "max_bn_fed_bias_update_over_plain": max(fed_errs.values())}


def _with_ties(rec, ties) -> dict:
    """``rec`` with the near ties' count and largest gap."""
    return {**rec, "pinned_vertices": len(ties),
            "relu_and_pool_flips": sum(t["flips"] for t in ties),
            "max_tie_gap": max(t["max_rel_gap"] for t in ties)}


def _timed_output(torch, ck, fn, calls: int = 3):
    """``calls`` timed calls of ``fn`` (to the end of their kernels) ->
    (last output, wall ms each, bf16 conv launches each)."""
    walls, per_call, out = [], [], None
    for _ in range(calls):
        before = ck.fused_conv2d_bias_act.bf16.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_call.append(ck.fused_conv2d_bias_act.bf16.launches - before)
    return out, walls, per_call


def _probs_vs_f32(torch, net, x, out) -> dict:
    """``out`` against the f32 net's output on the same params and input
    (the network's precision set back after): ||out - f32|| / ||f32||;
    the same of the log-probabilities less each row's mean (the logits
    less theirs), which near-uniform rows cannot pass by being uniform:
    two unrelated outputs of equal spread read about 1.4 apart; and the
    share of rows whose top class is the f32 net's."""
    g = net.conf.global_conf
    prec, g.precision = g.precision, None
    try:
        ref = net.output(x)
    finally:
        g.precision = prec
    ref = ref[0] if isinstance(ref, tuple) else ref

    def centred(p):
        lp = p.double().clamp_min(1e-300).log()
        return lp - lp.mean(dim=1, keepdim=True)
    return {"probs_rel_vs_f32": _rel_norm(torch, out, ref),
            "logits_rel_vs_f32": _rel_norm(torch, centred(out),
                                           centred(ref)),
            "top1_equal_f32": float((out.argmax(1) == ref.argmax(1))
                                    .float().mean())}


def _check_output_bf16(torch, out, rows, classes, per_call, convs, rel,
                       model, what):
    sums = out.sum(dim=1)
    if out.dtype != torch.float32 or tuple(out.shape) != (rows, classes) \
            or not bool(torch.isfinite(out).all()) or \
            not torch.allclose(sums, torch.ones_like(sums),
                               atol=BF16_PROBS_SUM_ATOL) or \
            set(per_call) != {convs} or \
            rel["probs_rel_vs_f32"] > BF16_PROBS_REL[model] or \
            rel["logits_rel_vs_f32"] > BF16_LOGITS_REL.get(model, np.inf):
        raise AssertionError(f"{what}: {out.dtype} {tuple(out.shape)}, "
                             f"launches {per_call}, against the f32 net's "
                             f"{rel}")


def _check_served_classes_bf16(name, xs, answers, direct, ladder) -> list:
    """Each request's served classes (argmax, or the best of top 3) must
    equal those of a direct bf16 ``output()`` of its rows, ordered as the
    gateway orders them, at one of the batch sizes the batcher can have
    served them at: its rows zero-padded to a bucket of ``ladder``.  Rows are independent at inference, but a
    conv's plan, and so its order of summation, follows the batch size,
    and bf16 rounds what that order changes.  -> the bucket each request
    matched first."""
    from deeplearning4j_tpu_torch.server.gateway import DeepLearning4jEntryPoint
    matched = []
    for x, (mode, answer) in zip(xs, answers):
        cls = answer["classes"]
        got = cls if mode == "argmax" else [c[0] for c in cls]
        shape = [len(x)] if mode == "argmax" else [len(x), 3]
        hit = None
        for nb in ladder:
            if nb < len(x):
                continue
            xp = np.zeros((nb,) + x.shape[1:], np.float32)
            xp[:len(x)] = x
            out = direct(xp)[:len(x)].float().cpu().numpy()
            # the best class as the server orders classes: argmax for
            # argmax_only, the gateway's own top-k order for top_k (on
            # classes of exactly equal probability, which bf16 rounding
            # makes common near a uniform output, the two orders differ)
            want = (out.argmax(axis=-1).tolist() if mode == "argmax" else
                    [c[0] for c in DeepLearning4jEntryPoint
                     ._format_predictions(out, top_k=3)["classes"]])
            if want == got:
                hit = nb
                break
        if hit is None or answer["shape"] != shape:
            raise AssertionError(f"{name}: served {answer}, which no direct "
                                 f"bf16 output at {ladder} gives")
        matched.append(hit)
    return matched


@_tf32_off
def phase_serve_bf16(torch, ck) -> dict:
    """Serving under precision("bfloat16"): VGG16-224 ``output()`` at 8 and
    32 rows and ResNet-50's (``seeded_resnet50(batch_norms=False)``) at
    32, each returning f32 within BF16_PROBS_REL of the f32 net's, and
    ResNet-50's within BF16_LOGITS_REL in log-probabilities; then the bf16
    ResNet-50
    written as a zip and served by one ``Server`` to 4 clients, 16
    requests of 1-2 rows."""
    from deeplearning4j_tpu_torch.models import vgg16
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)
    res = {"probs_rel_rule": BF16_PROBS_REL,
           "logits_rel_rule": BF16_LOGITS_REL}
    conv_launches = 0
    torch.cuda.reset_peak_memory_stats()
    net = vgg16(device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    net.conf.global_conf.precision = "bfloat16"
    cpu_gen = torch.Generator().manual_seed(SEED + 41)
    for rows in (8, 32):
        x = torch.randn((rows, 3, 224, 224), generator=cpu_gen).cuda()
        out, walls, per_call = _timed_output(torch, ck,
                                             lambda: net.output(x))
        vs = _probs_vs_f32(torch, net, x, out)
        res[f"vgg16_224_output_{rows}"] = {
            "ms": float(np.median(walls)), "ms_each": walls,
            "conv_launches_per_forward": per_call, "dtype": str(out.dtype),
            **vs}
        _check_output_bf16(torch, out, rows, 1000, per_call, 13, vs,
                           "vgg16_224", f"VGG16-224 bf16 output at {rows}")
        conv_launches += sum(per_call)
    res["vgg16_224_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del net, out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = seeded_resnet50("cuda", batch_norms=False)
    net.conf.global_conf.precision = "bfloat16"
    dims = (3, RESNET_HW, RESNET_HW)
    x32 = torch.randn((RESNET_SERVE_BATCH,) + dims,
                      generator=torch.Generator().manual_seed(SEED + 22))
    x32 = x32.cuda()
    out, walls, per_call = _timed_output(torch, ck,
                                         lambda: net.output(x32)[0], 5)
    vs = _probs_vs_f32(torch, net, x32, out)
    res["resnet50_output_32"] = {
        "ms": float(np.median(walls)), "ms_each": walls,
        "conv_launches_per_forward": per_call, "dtype": str(out.dtype), **vs,
        "spread": _input_dependent(out, "ResNet-50's bf16 output at 32")}
    _check_output_bf16(torch, out, RESNET_SERVE_BATCH, RESNET_CLASSES,
                       per_call, RESNET_KERNEL_CONVS, vs, "resnet50",
                       "ResNet-50 bf16 output at 32")
    res["output_launches"] = {"conv2d_bias_act_bf16":
                              conv_launches + sum(per_call)}
    res["resnet50_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(SEED + 21)
    xs = [rng.normal(size=(int(rng.integers(1, 3)),) + dims).astype(
        np.float32) for _ in range(RESNET_REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "resnet50_bf16.zip")
        write_model(net, path)
        del net, out
        server = Server(DeepLearning4jEntryPoint(
            device="cuda", max_batch=RESNET_SERVE_BATCH)).start()
        try:
            url = f"http://127.0.0.1:{server.port}/"
            warm = _rpc(url, "warmup", {"model_path": path,
                                        "feature_dims": list(dims)})
            fallbacks = _conv_fallbacks()
            _zero_counts(ck)                           # main path starts
            drive = _drive(url, path, xs, clients=RESNET_CLIENTS)
            launches = _kernel_counts(ck)              # main path ends
            fallbacks = _conv_fallbacks() - fallbacks
            batcher = server.entry_point.stats()["serving"][
                str(Path(path).resolve())]
            served = server.entry_point.model_cache.get(path)
        finally:
            server.stop()
    batches = batcher["batches"]
    ladder = [n for n in SERVE_LADDER if n <= RESNET_SERVE_BATCH]
    matched = _check_served_classes_bf16(
        "resnet50 bf16", xs, drive["answers"],
        lambda x: served.output(x)[0], ladder)
    spread = _input_dependent(served.output(np.concatenate(xs))[0],
                              "ResNet-50's bf16 served rows")
    res["serve_resnet50"] = {
        "precision": served.conf.global_conf.precision,
        "requests": drive["requests"], "rows": drive["rows"],
        "warmup_buckets": warm["buckets"],
        "batcher": {k: batcher[k] for k in ("batches", "rows",
                                            "batch_size_hist")},
        "launches": launches, "conv_fallbacks": fallbacks,
        "classes_equal_direct_output_at_bucket": matched,
        "served_rows_spread": spread}
    emit("serve_bf16", **res)
    if served.conf.global_conf.precision != "bfloat16" or launches != _want(
            ck, conv2d_bias_act_bf16=RESNET_KERNEL_CONVS * batches) or \
            fallbacks != RESNET_DENSE_CONVS * batches:
        raise AssertionError(f"{batches} served bf16 batches: launches "
                             f"{launches}, {fallbacks} conv fallbacks")
    del served
    torch.cuda.empty_cache()
    return res


def keras_functional_config() -> dict:
    """The Keras ``model_config`` (Keras 3 functional layout) of a small
    residual net on FUNC_HW x FUNC_HW x 3 images: conv1 -> bn1 -> relu1
    -> conv2 -> bn2 (8 channels), added to relu1 (Add) -> relu2,
    concatenated with a 1x1 conv of itself (Concatenate) ->
    GlobalAveragePooling2D -> Dense(FUNC_CLASSES, softmax)."""
    width = 8
    layers = []

    def tensor(src):
        return {"class_name": "__keras_tensor__",
                "config": {"shape": None, "dtype": "float32",
                           "keras_history": [src, 0, 0]}}

    def add(cls, name, inputs, **cfg):
        args = ([tensor(i) for i in inputs] if len(inputs) > 1
                else tensor(inputs[0]))
        layers.append({"class_name": cls, "name": name,
                       "config": {"name": name, **cfg},
                       "inbound_nodes": [{"args": [args], "kwargs": {}}]})
    layers.append({"class_name": "InputLayer", "name": "input",
                   "config": {"name": "input",
                              "batch_shape": [None, FUNC_HW, FUNC_HW, 3],
                              "dtype": "float32"}, "inbound_nodes": []})
    conv = {"kernel_size": [3, 3], "strides": [1, 1], "padding": "same",
            "activation": "linear"}
    add("Conv2D", "conv1", ["input"], filters=width, **conv)
    add("BatchNormalization", "bn1", ["conv1"], momentum=0.99,
        epsilon=1e-3)
    add("Activation", "relu1", ["bn1"], activation="relu")
    add("Conv2D", "conv2", ["relu1"], filters=width, **conv)
    add("BatchNormalization", "bn2", ["conv2"], momentum=0.99,
        epsilon=1e-3)
    add("Add", "add", ["bn2", "relu1"])
    add("Activation", "relu2", ["add"], activation="relu")
    add("Conv2D", "branch", ["relu2"], filters=width // 2,
        kernel_size=[1, 1], strides=[1, 1], padding="valid",
        activation="relu")
    add("Concatenate", "concat", ["relu2", "branch"], axis=-1)
    add("GlobalAveragePooling2D", "gap", ["concat"])
    add("Dense", "predictions", ["gap"], units=FUNC_CLASSES,
        activation="softmax")
    return {"class_name": "Functional",
            "config": {"name": "residual_cnn", "layers": layers,
                       "input_layers": [["input", 0, 0]],
                       "output_layers": [["predictions", 0, 0]]}}


def keras_functional_weights(config: dict, seed: int) -> dict:
    """Keras-layout weight arrays for :func:`keras_functional_config`,
    drawn from a numpy seed (the shapes of keras_vgg16_bn_weights)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    widths = {"input": 3}
    weights = {}
    for ld in config["config"]["layers"][1:]:
        cls, cfg = ld["class_name"], ld["config"]
        ins = [a["config"]["keras_history"][0] for a in (
            ld["inbound_nodes"][0]["args"][0]
            if isinstance(ld["inbound_nodes"][0]["args"][0], list)
            else [ld["inbound_nodes"][0]["args"][0]])]
        cin = widths[ins[0]]
        if cls == "Conv2D":
            kh, kw = cfg["kernel_size"]
            cout = cfg["filters"]
            weights[cfg["name"]] = {
                "kernel": (rng.standard_normal((kh, kw, cin, cout))
                           * np.sqrt(2.0 / (kh * kw * cin))).astype(f32),
                "bias": (0.05 * rng.standard_normal(cout)).astype(f32)}
            widths[cfg["name"]] = cout
        elif cls == "Dense":
            units = cfg["units"]
            weights[cfg["name"]] = {
                "kernel": (rng.standard_normal((cin, units))
                           * np.sqrt(2.0 / cin)).astype(f32),
                "bias": (0.05 * rng.standard_normal(units)).astype(f32)}
            widths[cfg["name"]] = units
        elif cls == "BatchNormalization":
            weights[cfg["name"]] = {
                "gamma": rng.uniform(0.8, 1.2, cin).astype(f32),
                "beta": (0.1 * rng.standard_normal(cin)).astype(f32),
                "moving_mean": (0.1 * rng.standard_normal(cin)).astype(f32),
                "moving_variance": rng.uniform(0.5, 1.5, cin).astype(f32)}
            widths[cfg["name"]] = cin
        else:
            widths[cfg["name"]] = (sum(widths[i] for i in ins)
                                   if cls == "Concatenate" else cin)
    return weights


def import_keras_functional(device, seed: int = SEED):
    """The functional net through the port's Keras import: its
    configuration, then its weight arrays with a dict lookup (no h5py)."""
    from deeplearning4j_tpu_torch.keras_import import KerasModelImport
    config = keras_functional_config()
    net = KerasModelImport._build(config, {}, device)
    KerasModelImport._load_weights(net, keras_functional_weights(config,
                                                                 seed))
    return net


@_tf32_off
def phase_keras_functional(torch, ck) -> dict:
    """The functional residual net imported on the card and on the CPU
    from the same configuration and weights: ``output()``, then one
    ``fit`` step (score, params and running statistics), card against
    CPU, with the conv launches of the card's run."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    cpu = import_keras_functional("cpu")
    gpu = import_keras_functional("cuda")
    kinds = sorted({type(v).__name__ if not hasattr(v, "layer_conf") else
                    type(v.layer_conf()).__name__
                    for v in gpu.conf.vertices.values()})
    rng = np.random.default_rng(SEED + 24)
    x, y = _random_batch(rng, FUNC_BATCH, (3, FUNC_HW, FUNC_HW),
                         FUNC_CLASSES)
    _zero_counts(ck)                                   # main path starts
    out = gpu.output(x)[0]
    seeds = rng.integers(0, 1 << 32, size=(len(gpu.order), 2))
    gpu._fit_batch(DataSet(x, y), seeds=seeds)
    launches = _kernel_counts(ck)                      # main path ends
    errs = {"output": _assert_near(torch, out, cpu.output(x)[0],
                                   "functional output")}
    cpu._fit_batch(DataSet(x, y), seeds=seeds)
    errs["score"] = abs(gpu.score() - cpu.score()) / abs(cpu.score())
    if errs["score"] > NEW_LAYERS_RTOL:
        raise AssertionError(f"functional net: scores {gpu.score()} (card) "
                             f"and {cpu.score()} (CPU)")
    for n in cpu.order:
        for tree, ctree in ((gpu.net_params, cpu.net_params),
                            (gpu.net_state, cpu.net_state)):
            for k in ctree[n]:
                errs[f"{n}_{k}"] = _assert_near(torch, tree[n][k],
                                                ctree[n][k], f"{n} {k}")
    # 3 convs, each in the forward of output() and of the training step
    if launches != _want(ck, conv2d_bias_act=6):
        raise AssertionError(f"functional net launched {launches}")
    res = {"vertices": len(gpu.order), "kinds": kinds,
           "n_params": gpu.n_params, "launches": launches,
           "max_abs_err": max(errs.values()), "rtol": NEW_LAYERS_RTOL,
           "atol": NEW_LAYERS_ATOL}
    emit("keras_functional", **res)
    return res


def _assert_near(torch, got, want, what) -> float:
    """``got`` (on the card) within NEW_LAYERS_RTOL / _ATOL of ``want``
    (on the CPU); returns the largest absolute difference."""
    got = got.detach().cpu()
    torch.testing.assert_close(got, want.detach(), rtol=NEW_LAYERS_RTOL,
                               atol=NEW_LAYERS_ATOL, msg=lambda m: f"{what}: "
                               f"{m}")
    return float((got - want.detach()).abs().max())


def _rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want|| (2-norms), 0 when both are zero."""
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got - want))
    return num / den if den else num


def _plain_lstm_step(ck):
    """Within the block, ``ops/recurrent.lstm_scan`` takes the plain step
    (``lstm_step_reference``) where it would launch the kernel: the
    network and scan code run unchanged, and no launch is counted."""
    from unittest import mock
    return mock.patch.object(ck, "fused_lstm_step", ck.lstm_step_reference)


def _lstm_bound(N, H, elem: int = 4):
    """(bytes, FLOPs) of one step: zx, h, c, RW, p3 read once, c', h'
    written once, ``elem`` bytes each (2 for the bf16 form); the [N, H] x
    [H, 4H] product and ~20 operations per (n, j) of gate math."""
    nbytes = elem * (N * 4 * H + 2 * N * H + 4 * H * H + 3 * H + 2 * N * H)
    return nbytes, 2 * N * H * 4 * H + 20 * N * H


def check_lstm_step(torch, ck, N, H, gen, timed=False) -> dict:
    """The kernel against its plain version at one (N, H), with zx a row-
    strided view (one time step of [N, 3, 4H]) as ``lstm_scan`` passes it."""
    dev = torch.device("cuda")
    zx = torch.randn((N, 3, 4 * H), generator=gen, device=dev)[:, 1]
    h = torch.randn((N, H), generator=gen, device=dev)
    c = torch.randn((N, H), generator=gen, device=dev)
    rw = torch.randn((H, 4 * H), generator=gen, device=dev) * H ** -0.5
    p3 = torch.randn((3, H), generator=gen, device=dev) * 0.1
    got = ck.fused_lstm_step(zx, h, c, rw, p3)
    want = ck.lstm_step_reference(zx, h, c, rw, p3)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=LSTM_TOL, atol=LSTM_TOL)
    rec = {"shape": [N, H], "max_abs_err": max(
        float((a - e).abs().max()) for a, e in zip(got, want))}
    if timed:
        nbytes, flops = _lstm_bound(N, H)
        rec.update(
            ms=graph_ms(torch, lambda: ck.fused_lstm_step(zx, h, c, rw, p3),
                        calls=50),
            call_ms=time_ms(torch, lambda: ck.fused_lstm_step(
                zx, h, c, rw, p3)),
            plain_ms=graph_ms(torch, lambda: ck.lstm_step_reference(
                zx, h, c, rw, p3), calls=50),
            bytes=nbytes, flops=flops)
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops)
    return rec


def check_lstm_scan(torch, ck, masked: bool, reverse: bool) -> dict:
    """A 2-layer ``lstm_scan`` of the char-RNN's widths over one TBPTT
    segment (N = 32, T = 50, V = 107 -> 200 -> 200) from a nonzero state,
    through the kernel and through the plain step: outputs, final states
    and the gradients of every param."""
    from deeplearning4j_tpu_torch.ops import recurrent as rnn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    N, T, V, H = CHAR_BATCH, CHAR_TBPTT, 107, CHAR_HIDDEN

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    layers = [{"W": randn(n_in, 4 * H, scale=n_in ** -0.5),
               "RW": randn(H, 4 * H, scale=H ** -0.5),
               "b": randn(4 * H, scale=0.1), "pI": randn(H, scale=0.1),
               "pF": randn(H, scale=0.1), "pO": randn(H, scale=0.1)}
              for n_in in (V, H)]
    x = torch.nn.functional.one_hot(torch.randint(
        0, V, (N, T), generator=gen, device="cuda"), V).float()
    inits = [rnn.LSTMState(randn(N, H), randn(N, H)) for _ in layers]
    mask = None
    if masked:
        lens = torch.randint(1, T + 1, (N,), generator=gen, device="cuda")
        mask = (torch.arange(T, device="cuda")[None] < lens[:, None]).float()
    g_out = randn(N, T, H)

    def run():
        leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
                  for p in layers]
        h, finals = x, []
        for p, init in zip(leaves, inits):
            h, fin = rnn.lstm_scan(p, h, init, mask, reverse=reverse)
            finals += list(fin)
        grads = torch.autograd.grad(
            (h * g_out).sum() + sum(f.sum() for f in finals),
            [v for p in leaves for v in p.values()])
        return [h.detach()] + [f.detach() for f in finals] + list(grads)

    before = ck.fused_lstm_step.launches
    got = run()
    launches = ck.fused_lstm_step.launches - before
    with _plain_lstm_step(ck):
        want = run()
    torch.cuda.synchronize()
    errs = [_rel_norm(torch, a, e) for a, e in zip(got, want)]
    rec = {"masked": masked, "reverse": reverse, "launches": launches,
           "max_rel_norm_err": max(errs),
           "max_abs_err_output": float((got[0] - want[0]).abs().max())}
    if launches != 2 * T or max(errs) > LSTM_SCAN_REL:
        raise AssertionError(f"lstm_scan through the kernel disagrees with "
                             f"the plain step: {rec}, errors {errs}")
    return rec


def phase_lstm_kernel(torch, ck) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # timed: every shape a main path runs (training at 32 rows, sampling
    # at 4 streams and sample_text at 1)
    steps = [check_lstm_step(torch, ck, n, CHAR_HIDDEN, gen, timed=True)
             for n in (CHAR_BATCH, SAMPLE_STREAMS, 1)]
    # untimed: small shapes and the tiling's edges (k-chunks of 32 over
    # ceil(H / 8) rows a warp; blocks of 16 rows)
    steps += [check_lstm_step(torch, ck, n, h, gen)
              for n, h in ((3, 8), (5, 24), (64, 256), (3, 1024), (7, 264),
                           (40, 8))]
    scans = [check_lstm_scan(torch, ck, m, r)
             for m, r in ((False, False), (True, False), (False, True))]
    res = {"tol": LSTM_TOL, "scan_rel_norm_tol": LSTM_SCAN_REL,
           "steps": steps, "scans": scans,
           "us_per_step": steps[0]["ms"] * 1e3,
           "plain_us_per_step": steps[0]["plain_ms"] * 1e3,
           "bound_us_per_step": steps[0]["bound_ms"] * 1e3,
           "library_note": "no single PyTorch call computes a peephole LSTM "
                           "step: torch.lstm_cell has no peepholes"}
    emit("lstm_kernel", **res)
    return res


def phase_train_charrnn(torch, ck):
    from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn
    torch.backends.cuda.matmul.allow_tf32 = False
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=CHAR_SEQ, batch=CHAR_BATCH, seed=0)
    net = char_rnn(it.vocab_size, CHAR_HIDDEN, CHAR_LAYERS,
                   tbptt_length=CHAR_TBPTT, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    minibatches = []
    _zero_counts(ck)                                   # main path starts
    for k in range(CHAR_MINIBATCHES):
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(it.next())       # one minibatch, 20 TBPTT segments
        score = net.score()      # a host copy: waits for the card
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        minibatches.append({
            "minibatch": k + 1, "score": score, "seconds": dt,
            "chars_per_s": CHAR_BATCH * CHAR_SEQ / dt,
            "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    want = _want(ck, lstm_step=CHAR_LAYERS * CHAR_SEQ)
    for mb in minibatches:
        if mb["launches"] != want or not np.isfinite(mb["score"]):
            raise AssertionError(f"char-RNN minibatch {mb}: launches must be "
                                 f"{want} and the score finite")
    if net.iteration != CHAR_MINIBATCHES * CHAR_SEQ // CHAR_TBPTT:
        raise AssertionError(f"{net.iteration} TBPTT steps")
    res = {"vocab": it.vocab_size, "batch": CHAR_BATCH, "seq": CHAR_SEQ,
           "tbptt": CHAR_TBPTT, "segments": net.iteration,
           "minibatches": minibatches,
           "chars_per_s_after_first": CHAR_BATCH * CHAR_SEQ
           * (CHAR_MINIBATCHES - 1)
           / sum(m["seconds"] for m in minibatches[1:]),
           "launches": launches, "max_memory_allocated": peak,
           "n_params": net.n_params}
    trained = _clone_tree(net.net_params)
    res["plain_segment"] = _charrnn_segment_vs_plain(torch, ck, net, it)
    emit("train_charrnn", **res)
    # the trained params, for graph_tbptt_charrnn
    res["trained_params"] = trained
    return res, net, it


def _charrnn_segment_vs_plain(torch, ck, net, it) -> dict:
    """One TBPTT segment (grad step + RMSProp update) from the trained
    params, updater state and carried RNN state, through the kernel and
    then, from the same snapshot, through the plain step."""
    ds = it.next()
    x = torch.from_numpy(ds.features[:, :CHAR_TBPTT]).cuda()
    y = torch.from_numpy(ds.labels[:, :CHAR_TBPTT]).cuda()
    snap = (_clone_tree(net.net_params), _clone_tree(net.opt_states),
            _clone_tree(net.net_state), net.iteration)

    def segment():
        net.net_params, net.opt_states, net.net_state = (
            _clone_tree(t) for t in snap[:3])
        score, grads = net._grad_step(x, y, None, None, None)
        net._apply_updates(grads, snap[3])
        return float(score), net.net_params
    k_score, k_params = segment()
    with _plain_lstm_step(ck):
        p_score, p_params = segment()
    errs = {f"{i}_{k}": float(
        torch.linalg.vector_norm(lp[k] - pp[k])
        / torch.linalg.vector_norm(pp[k] - p0[k]))
        for i, (lp, pp, p0) in enumerate(zip(k_params, p_params, snap[0]))
        for k in lp}
    rec = {"kernel_score": k_score, "plain_score": p_score,
           "score_rel_diff": abs(k_score - p_score) / abs(p_score),
           "update_rel_err": errs, "max_update_rel_err": max(errs.values()),
           "score_rtol": CHAR_SCORE_RTOL, "update_rtol": CHAR_UPDATE_RTOL}
    if rec["score_rel_diff"] > CHAR_SCORE_RTOL or \
            rec["max_update_rel_err"] > CHAR_UPDATE_RTOL:
        raise AssertionError(f"char-RNN segment through the kernel disagrees "
                             f"with the plain step: {rec}")
    return rec


def phase_sample_charrnn(torch, ck, net, it) -> dict:
    from deeplearning4j_tpu_torch.models import sample_text
    V = it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(SEED)
    net.rnn_clear_previous_state()
    cur = rng.integers(0, V, SAMPLE_STREAMS)
    picks = []
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    for _ in range(SAMPLE_CHARS):
        out = net.rnn_time_step(eye[cur][:, None, :])[:, -1]
        p = out.double().cpu().numpy()
        cur = np.array([rng.choice(V, p=q / q.sum()) for q in p])
        picks.append(cur)
    stream_s = time.perf_counter() - t0
    stream_launches = ck.fused_lstm_step.launches
    seed_text, length = "The ", 100
    t0 = time.perf_counter()
    text = sample_text(net, it, seed_text, length=length, rng_seed=SEED)
    text_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    want_stream = CHAR_LAYERS * SAMPLE_CHARS
    want = CHAR_LAYERS * (SAMPLE_CHARS + len(seed_text) + length)
    if stream_launches != want_stream or launches["lstm_step"] != want or \
            sum(launches.values()) != want:
        raise AssertionError(f"sampling launched {launches} ({stream_launches}"
                             f" over the streams); want {want_stream} over "
                             f"the streams and {want} lstm steps in all")
    if len(text) != len(seed_text) + length or \
            any(ch not in it.char_to_idx for ch in text):
        raise AssertionError(f"sample_text gave {text!r}")
    # fed one character at a time, rnn_time_step equals output()
    x = it.next().features[:SAMPLE_STREAMS, :CHAR_TBPTT]
    full = net.output(x)
    net.rnn_clear_previous_state()
    steps = torch.cat([net.rnn_time_step(x[:, t:t + 1])
                       for t in range(CHAR_TBPTT)], dim=1)
    torch.testing.assert_close(steps, full, rtol=LSTM_TOL, atol=LSTM_TOL)
    sums = full.sum(dim=-1)
    torch.testing.assert_close(sums, torch.ones_like(sums), rtol=0,
                               atol=1e-5)
    res = {"streams": SAMPLE_STREAMS, "chars": SAMPLE_CHARS,
           "ms_per_char": stream_s / SAMPLE_CHARS * 1e3,
           "stream_launches": stream_launches,
           "sample_text_ms_per_char": text_s / (len(seed_text) + length)
           * 1e3,
           "launches": launches,
           "first_stream": "".join(it.idx_to_char[int(p[0])] for p in picks),
           "sample_text": text,
           "time_step_vs_output_max_abs": float((steps - full).abs().max())}
    emit("sample_charrnn", **res)
    return res

# ---------------------------------------------------------------------------
# flash attention: the long-context attention model
# ---------------------------------------------------------------------------

def _flash_inputs(torch, gen, B, H, T, D, mask="none"):
    q, k, v, g = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                  * 0.5 for _ in range(4))
    km = torch.ones((B, T), device="cuda")
    if mask == "tail":
        km[:, FLASH_MASK_FROM:] = 0.0
    elif mask == "dead_row":
        km[-1] = 0.0
    return q, k, v, g, km


def _flash_work(B, H, T, D, causal, elem: int = 4):
    """(FLOPs, bytes) of the forward, dq and dk/dv kernels on inputs of
    this shape: 2 D FLOPs per (query, key) pair attended and product (2,
    3 and 4 products); each input read once, each output written once;
    q, k, v, dout and the outputs of ``elem`` bytes (2 for the bf16 forms),
    the mask, lse and delta f32."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    big, rows = elem * B * H * T * D, 4 * B * H * T
    mask = 4 * B * T
    return {"flash_forward": (4 * D * pairs, 3 * big + mask + big + rows),
            "flash_dq": (6 * D * pairs, 4 * big + mask + 2 * rows + big),
            "flash_dkv": (8 * D * pairs, 4 * big + mask + 2 * rows
                          + 2 * big)}


def check_flash(torch, ck, gen, B, H, T, D, causal, mask) -> dict:
    """Each flash kernel against its plain version on the same inputs (the
    plain lse and delta feed both backward kernels, so each kernel is held
    alone); a query row with no live key must give out 0 and lse -1e30."""
    q, k, v, g, km = _flash_inputs(torch, gen, B, H, T, D, mask)
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, causal, s)
    rout, rlse = ck.flash_forward_reference(q, k, v, km, causal, s)
    delta = (g * rout).sum(-1)
    dq = ck.flash_dq(q, k, v, km, g, rlse, delta, causal, s)
    dk, dv = ck.flash_dkv(q, k, v, km, g, rlse, delta, causal, s)
    rdq = ck.flash_dq_reference(q, k, v, km, g, rlse, delta, causal, s)
    rdk, rdv = ck.flash_dkv_reference(q, k, v, km, g, rlse, delta, causal, s)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("out", out, rout), ("lse", lse, rlse),
                            ("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL,
                                   msg=lambda m: f"flash {name} at "
                                   f"{(B, H, T, D, causal, mask)}: {m}")
        errs[name] = float((got - want).abs().max())
    if mask == "dead_row" and not (bool((out[-1] == 0).all())
                                   and bool((lse[-1] == ck.NEG_INF).all())):
        raise AssertionError("a fully masked batch row must give out 0 and "
                             "lse -1e30")
    return {"shape": [B, H, T, D], "causal": causal, "mask": mask,
            "max_abs_err": errs}


def phase_flash_kernels(torch, ck) -> dict:
    """The three flash kernels against their plain versions, TF32 off (the
    first case is the training path's shape), then timed at that shape
    beside the plain versions, the bound and
    ``F.scaled_dot_product_attention`` (f32): its forward, its forward +
    backward, and its backward alone.  Each kernel's bound is 3 TF32
    products per f32 product on the tensor cores, the f32 CUDA-core bound
    beside it."""
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, T, D = ATT_BATCH, ATT_HEADS, ATT_SEQ, ATT_WIDTH // ATT_HEADS
    cases = [(B, H, T, D, True, "none"), (1, 2, ATT_SEQ, 64, True, "none"),
             (2, 2, 200, 64, False, "tail"), (2, 2, 200, 64, True, "tail"),
             (2, 2, 256, 32, True, "none"), (2, 2, 256, 96, True, "none"),
             (2, 2, 256, 128, False, "none"), (2, 2, 130, 64, True, "none"),
             (2, 2, 256, 64, True, "dead_row"),
             (2, 2, 200, 128, False, "dead_row")]
    checks = [check_flash(torch, ck, gen, *c) for c in cases]
    torch.cuda.empty_cache()
    # timed at the training path's (B, H, T, D) = (4, 8, 8192, 64), causal
    q, k, v, g, km = _flash_inputs(torch, gen, B, H, T, D)
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, True, s)
    delta = (g * out).sum(-1)
    calls = {
        "flash_forward": (
            lambda: ck.flash_forward(q, k, v, km, True, s),
            lambda: ck.flash_forward_reference(q, k, v, km, True, s)),
        "flash_dq": (
            lambda: ck.flash_dq(q, k, v, km, g, lse, delta, True, s),
            lambda: ck.flash_dq_reference(q, k, v, km, g, lse, delta, True,
                                          s)),
        "flash_dkv": (
            lambda: ck.flash_dkv(q, k, v, km, g, lse, delta, True, s),
            lambda: ck.flash_dkv_reference(q, k, v, km, g, lse, delta, True,
                                           s))}
    work = _flash_work(B, H, T, D, True)
    timed = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = work[name]
        rec = {"ms": time_ms(torch, kernel, reps=5, warmup=1),
               "plain_ms": time_ms(torch, plain, reps=3, warmup=1),
               "flops": flops, "bytes": nbytes}
        torch.cuda.empty_cache()
        simt_ms = _bound(nbytes, flops)[0]
        t_ops = TF32_PRODUCTS_PER_F32 * flops / PEAK_TF32_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        rec["bound_f32_simt_ms"] = simt_ms
        rec["share_of_f32_simt_bound"] = simt_ms / rec["ms"]
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        timed[name] = rec
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qs, ks, vs), g)
    with torch.no_grad():
        lib_fwd = time_ms(torch, sdpa, reps=5, warmup=1)
    lib_both = time_ms(torch, sdpa_fwd_bwd, reps=5, warmup=1)
    lib_graph = sdpa()

    def sdpa_bwd():
        torch.autograd.grad(lib_graph, (qs, ks, vs), g, retain_graph=True)
    lib_bwd = time_ms(torch, sdpa_bwd, reps=5, warmup=1)
    lib_out = lib_graph.detach()
    del lib_graph
    torch.testing.assert_close(out, lib_out, rtol=FLASH_TOL, atol=FLASH_TOL)
    res = {"tol": FLASH_TOL, "checks": checks, "timed_shape": [B, H, T, D],
           "causal": True, "timed": timed,
           "sass_hgmma": {name: hgmma_count(ck, ck.FLASH_LIBRARY, pattern)
                          for name, pattern in FLASH_FUNCTIONS.items()},
           "library_ms_forward": lib_fwd,
           "library_ms_forward_backward": lib_both,
           "library_ms_backward": lib_bwd,
           "kernels_ms_forward_backward": sum(r["ms"]
                                              for r in timed.values()),
           "kernels_ms_backward": timed["flash_dq"]["ms"]
           + timed["flash_dkv"]["ms"],
           "library_max_abs_vs_kernel": float((out - lib_out).abs().max()),
           "library_note": "F.scaled_dot_product_attention (f32, causal), "
                           "timed only: its forward for flash_forward; its "
                           "backward alone (one forward, then autograd.grad "
                           "with retain_graph) computes dq, dk and dv in one "
                           "call, so dq and dk/dv have no call of their own "
                           "and the pair is set against it"}
    emit("flash_kernels", **res)
    return res


def _fallbacks(op: str) -> float:
    """Calls of ``op`` that have taken the dense torch chain so far."""
    from deeplearning4j_tpu_torch import monitor
    return monitor.get_registry().counter(
        "dl4j_kernel_fallback_total", "ops that took the dense torch chain",
        labels=("op",)).labels(op=op).value


def _plain_flash(ck):
    """Within the block, ``_FlashAttention`` runs the plain versions where
    it would launch the kernels: the network and autograd code run
    unchanged, and no launch is counted."""
    from contextlib import ExitStack
    from unittest import mock
    stack = ExitStack()
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        stack.enter_context(mock.patch.object(
            ck, name, getattr(ck, name + "_reference")))
    return stack


def phase_train_attention(torch, ck):
    from deeplearning4j_tpu_torch.models import CharacterIterator, attention_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=ATT_SEQ, batch=ATT_BATCH, seed=0)
    net = attention_lm(it.vocab_size, ATT_WIDTH, ATT_HEADS, ATT_LAYERS,
                       ATT_SEQ, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    start = _clone_tree(net.net_params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    fallbacks = _fallbacks("attention")
    _zero_counts(ck)                                   # main path starts
    for k in range(ATT_STEPS):
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(it.next())
        score = net.score()      # a host copy: waits for the card
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": k + 1, "score": score, "seconds": dt,
                      "chars_per_s": ATT_BATCH * ATT_SEQ / dt,
                      "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    fallbacks = _fallbacks("attention") - fallbacks
    peak = torch.cuda.max_memory_allocated()
    want = _want(ck, flash_forward=ATT_LAYERS, flash_dq=ATT_LAYERS,
                 flash_dkv=ATT_LAYERS)
    for st in steps:
        if st["launches"] != want or not np.isfinite(st["score"]):
            raise AssertionError(f"attention step {st}: launches must be "
                                 f"{want} and the score finite")
    if fallbacks:
        raise AssertionError(f"{fallbacks} attention calls took the dense "
                             f"chain")
    dense_scores = 4 * ATT_BATCH * ATT_HEADS * ATT_SEQ ** 2
    if peak >= dense_scores:
        raise AssertionError(f"peak memory {peak} B is not below one dense "
                             f"score tensor ({dense_scores} B)")
    res = {"vocab": it.vocab_size, "batch": ATT_BATCH, "seq": ATT_SEQ,
           "width": ATT_WIDTH, "heads": ATT_HEADS, "layers": ATT_LAYERS,
           "n_params": net.n_params, "steps": steps,
           "chars_per_s_after_first": ATT_BATCH * ATT_SEQ * (ATT_STEPS - 1)
           / sum(st["seconds"] for st in steps[1:]),
           "launches": launches, "attention_fallbacks": fallbacks,
           "max_memory_allocated": peak,
           "one_dense_score_tensor_bytes": dense_scores,
           "plain_step": _attention_step_vs_plain(torch, ck, net, it,
                                                  start)}
    emit("train_attention", **res)
    return res, net, it


def _attention_step_vs_plain(torch, ck, net, it, start) -> dict:
    """One ``fit`` step (grad step + Adam update) at T = 2,048 with a fresh
    updater, through the kernels and through the plain versions: the score,
    each param's gradient and each param's update, held to one rule for
    every tensor.

    Not from the trained state: the recipe's lr of 0.05 drives this width
    into a saturated state within a step or two (PERF.md), where the
    attention layers' gradients vanish.  Not from the initial params
    either: layer 0's output passes the layers' default sigmoid with
    pre-activations of a few hundredths, so layer 1 sees 0.5 plus a
    variation of about 1 % at every position, its values are near equal,
    and its q and k gradients are differences of near-equal numbers, about
    1e-6 of its other gradients, which any two float32 computations give
    a few % apart.  So the step starts from the initial params with layer
    0's Wv and Wo times ATT_SPREAD_V, which spreads the sigmoid's inputs to
    order 1 and layer 1's values apart, and with Wq and Wk of both layers
    times ATT_PEAK_QK, which sharpens both layers' attention.  There every
    gradient of both layers is well conditioned and one rule holds for all
    of them.  The key bias ``bk`` is held to neither: the softmax ignores a
    bias added to every key of a row, so its gradient is float32 noise in
    every computation; swapping the two steps' ``bk`` must leave the
    output unchanged.  The trained state is put back afterwards."""
    ds = it.next()
    x = torch.from_numpy(ds.features[:, :ATT_PLAIN_SEQ]).cuda()
    y = torch.from_numpy(ds.labels[:, :ATT_PLAIN_SEQ]).cuda()
    trained = (net.net_params, net.opt_states, net.iteration)
    begin = _clone_tree(start)
    for i in range(ATT_LAYERS):
        for k in ("Wq", "Wk"):
            begin[i][k] *= ATT_PEAK_QK
    for k in ("Wv", "Wo"):
        begin[0][k] *= ATT_SPREAD_V

    def step():
        net.net_params = _clone_tree(begin)
        net.opt_states = net._init_opt_states()
        score, grads = net._grad_step(x, y, None, None, None)
        kept = _clone_tree(grads)
        net._apply_updates(grads, 0)
        return float(score), kept, [{k: v - p0[k] for k, v in lp.items()}
                                    for lp, p0 in zip(net.net_params, begin)]
    before = _kernel_counts(ck)
    kernel = step()
    launched = {n: v - before[n] for n, v in _kernel_counts(ck).items()}
    with _plain_flash(ck):
        plain = step()
    if _kernel_counts(ck) != {n: before[n] + launched[n] for n in before}:
        raise AssertionError("a plain step launched a kernel")

    def errors(idx):
        """Per tensor but bk: relative 2-norm of kernel vs plain."""
        return {f"{i}_{k}": _rel_norm(torch, kernel[idx][i][k], lp[k])
                for i, lp in enumerate(plain[idx]) for k in lp if k != "bk"}
    grads, updates = errors(1), errors(2)
    net.net_params = [{k: p0[k] + d for k, d in lp.items()}
                      for lp, p0 in zip(kernel[2], begin)]
    out = net.output(x)
    for i in range(ATT_LAYERS):
        net.net_params[i]["bk"] = begin[i]["bk"] + plain[2][i]["bk"]
    bk_swap = float((net.output(x) - out).abs().max())
    net.net_params, net.opt_states, net.iteration = trained
    bad = sorted([n for n, e in grads.items() if e > ATT_GRAD_RTOL] +
                 [n for n, e in updates.items() if e > ATT_UPDATE_RTOL])
    rec = {"seq": ATT_PLAIN_SEQ, "peak_qk": ATT_PEAK_QK,
           "spread_v": ATT_SPREAD_V, "kernel_score": kernel[0],
           "plain_score": plain[0],
           "score_rel_diff": abs(kernel[0] - plain[0]) / abs(plain[0]),
           "grad_rel_err": grads, "update_rel_err": updates,
           "max_grad_rel_err": max(grads.values()),
           "max_update_rel_err": max(updates.values()),
           "over_tolerance": bad,
           "bk_swap_max_abs_output_change": bk_swap,
           "launches": launched, "score_rtol": ATT_SCORE_RTOL,
           "grad_rtol": ATT_GRAD_RTOL, "update_rtol": ATT_UPDATE_RTOL}
    if launched != _want(ck, flash_forward=ATT_LAYERS, flash_dq=ATT_LAYERS,
                         flash_dkv=ATT_LAYERS) or \
            rec["score_rel_diff"] > ATT_SCORE_RTOL or bad or \
            bk_swap > ATT_OUT_TOL:
        raise AssertionError(f"attention step through the kernels disagrees "
                             f"with the plain step: {rec}")
    return rec


def phase_output_attention(torch, ck, net, it) -> dict:
    ds = it.next()
    x = torch.from_numpy(ds.features).cuda()
    net.output(x)
    torch.cuda.synchronize()
    walls = []
    _zero_counts(ck)                                   # main path starts
    for _ in range(3):
        t0 = time.perf_counter()
        out = net.output(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_counts(ck)                      # main path ends
    if launches != _want(ck, flash_forward=3 * ATT_LAYERS):
        raise AssertionError(f"output() launched {launches}")
    if tuple(out.shape) != (ATT_BATCH, ATT_SEQ, it.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"output {tuple(out.shape)} not finite")
    sums = out.sum(dim=-1)
    torch.testing.assert_close(sums, torch.ones_like(sums), rtol=0,
                               atol=1e-5)
    res = {"batch": ATT_BATCH, "seq": ATT_SEQ, "wall_ms": float(
        np.median(walls)), "wall_ms_each": walls, "launches": launches,
        "chars_per_s": ATT_BATCH * ATT_SEQ / float(np.median(walls)) * 1e3}
    emit("output_attention", **res)
    return res


def phase_sample_attention(torch, ck, net, it) -> dict:
    """4 streams x 300 characters through ``rnn_time_step`` (the KV ring of
    8,192 entries per layer, plain torch: no kernel), ``sample_text``, and
    the ring against ``output()`` on the whole 300-character prefix, which
    takes the flash forward kernel (T = 300 is not a multiple of its
    64-row tiles)."""
    from deeplearning4j_tpu_torch.models import sample_text
    V = it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(SEED)
    net.rnn_clear_previous_state()
    cur = rng.integers(0, V, SAMPLE_STREAMS)
    picks, outs = [cur], []
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    for _ in range(SAMPLE_CHARS):
        out = net.rnn_time_step(eye[cur][:, None, :])[:, -1]
        outs.append(out)
        p = out.double().cpu().numpy()
        cur = np.array([rng.choice(V, p=q / q.sum()) for q in p])
        picks.append(cur)
    stream_s = time.perf_counter() - t0
    seed_text, length = "The ", 100
    t0 = time.perf_counter()
    text = sample_text(net, it, seed_text, length=length, rng_seed=SEED)
    text_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    if any(launches.values()):
        raise AssertionError(f"KV-ring sampling launched {launches}")
    if len(text) != len(seed_text) + length or \
            any(ch not in it.char_to_idx for ch in text):
        raise AssertionError(f"sample_text gave {text!r}")
    # the ring's answers against output() on the whole prefix
    prefix = np.stack(picks[:SAMPLE_CHARS], axis=1)            # [4, 300]
    full = net.output(eye[prefix])
    steps = torch.stack(outs, dim=1)
    torch.testing.assert_close(steps, full, rtol=ATT_OUT_TOL,
                               atol=ATT_OUT_TOL)
    res = {"streams": SAMPLE_STREAMS, "chars": SAMPLE_CHARS,
           "window": net.layers[0].cache_window,
           "ms_per_char": stream_s / SAMPLE_CHARS * 1e3,
           "sample_text_ms_per_char": text_s / (len(seed_text) + length)
           * 1e3,
           "launches": launches,
           "first_stream": "".join(it.idx_to_char[int(p[0])] for p in picks),
           "sample_text": text,
           "time_step_vs_output_max_abs": float((steps - full).abs().max()),
           "tol": ATT_OUT_TOL}
    emit("sample_attention", **res)
    return res


# ---------------------------------------------------------------------------
# the sequence models in bf16
# ---------------------------------------------------------------------------

def _plain_lstm_launch(ck):
    """Within the block the lstm step's autograd Function runs its plain
    version (``lstm_step_reference``) where it would launch the kernel, and
    keeps its backward (``lstm_step_formula`` in the inputs' dtype): the
    plain step of either dtype, no launch counted."""
    from unittest import mock
    return mock.patch.object(ck, "_launch_lstm_step", ck.lstm_step_reference)


def check_lstm_step_bf16(torch, ck, N, H, gen, timed=False) -> dict:
    """The lstm kernel's bf16 form against its plain version at one (N, H),
    zx a row-strided view as ``lstm_scan`` passes it, by the bf16 conv
    rule on c' and h'; the launch counted on the bf16 form's count only."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    zx = torch.randn((N, 3, 4 * H), generator=gen, device=dev).to(bf)[:, 1]
    h = torch.randn((N, H), generator=gen, device=dev).to(bf)
    c = torch.randn((N, H), generator=gen, device=dev).to(bf)
    rw = (torch.randn((H, 4 * H), generator=gen, device=dev)
          * H ** -0.5).to(bf)
    p3 = (torch.randn((3, H), generator=gen, device=dev) * 0.1).to(bf)
    f32_before, before = ck.fused_lstm_step.launches, \
        ck.fused_lstm_step.bf16.launches
    got = ck.fused_lstm_step(zx, h, c, rw, p3)
    want = ck.lstm_step_reference(zx, h, c, rw, p3)
    torch.cuda.synchronize()
    cmp = {n: bf16_conv_compare(torch, a, e)
           for n, a, e in zip(("c", "h"), got, want)}
    rec = {"shape": [N, H], "c": cmp["c"], "h": cmp["h"],
           "max_abs_err": max(r["max_abs_err"] for r in cmp.values())}
    if any(a.dtype != bf for a in got) or \
            not all(r["ok"] for r in cmp.values()) or \
            ck.fused_lstm_step.bf16.launches != before + 1 or \
            ck.fused_lstm_step.launches != f32_before:
        raise AssertionError(f"the lstm kernel's bf16 form disagrees with "
                             f"its plain version: {rec}")
    if timed:
        nbytes, flops = _lstm_bound(N, H, elem=2)   # FLOPs at bf16's peak
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rec.update(
            ms=graph_ms(torch, lambda: ck.fused_lstm_step(zx, h, c, rw, p3),
                        calls=50),
            call_ms=time_ms(torch, lambda: ck.fused_lstm_step(
                zx, h, c, rw, p3)),
            plain_ms=graph_ms(torch, lambda: ck.lstm_step_reference(
                zx, h, c, rw, p3), calls=50),
            bytes=nbytes, flops=flops, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rec


def check_flash_bf16(torch, ck, gen, B, H, T, D, causal, mask) -> dict:
    """Each flash kernel's bf16 form against its plain version on the same
    bf16 inputs (the plain lse and f32 delta feed both backward kernels):
    out, dq, dk and dv by the bf16 flash rule, lse by FLASH_TOL; a query
    row with no live key gives out 0 and lse -1e30."""
    bf = torch.bfloat16
    q, k, v, g, km = _flash_inputs(torch, gen, B, H, T, D, mask)
    q, k, v, g = (t.to(bf) for t in (q, k, v, g))
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, causal, s)
    rout, rlse = ck.flash_forward_reference(q, k, v, km, causal, s)
    delta = ck.flash_delta(g, rout)
    dq = ck.flash_dq(q, k, v, km, g, rlse, delta, causal, s)
    dk, dv = ck.flash_dkv(q, k, v, km, g, rlse, delta, causal, s)
    rdq = ck.flash_dq_reference(q, k, v, km, g, rlse, delta, causal, s)
    rdk, rdv = ck.flash_dkv_reference(q, k, v, km, g, rlse, delta, causal, s)
    torch.cuda.synchronize()
    case = (B, H, T, D, causal, mask)
    rules, errs = {}, {}
    for name, got, want in (("out", out, rout), ("dq", dq, rdq),
                            ("dk", dk, rdk), ("dv", dv, rdv)):
        r = bf16_conv_compare(torch, got, want, BF16_FLASH_ATOL)
        if got.dtype != bf or not r["ok"]:
            raise AssertionError(f"flash bf16 {name} at {case} disagrees "
                                 f"with its plain version: {r}")
        rules[name] = {k: r[k] for k in ("share_differ",
                                         "share_beyond_one_ulp",
                                         "max_excess")}
        errs[name] = r["max_abs_err"]
    torch.testing.assert_close(lse, rlse, rtol=FLASH_TOL, atol=FLASH_TOL,
                               msg=lambda m: f"flash bf16 lse at {case}: {m}")
    errs["lse"] = float((lse - rlse).abs().max())
    if mask == "dead_row" and not (bool((out[-1] == 0).all())
                                   and bool((lse[-1] == ck.NEG_INF).all())):
        raise AssertionError("a fully masked batch row must give out 0 and "
                             "lse -1e30")
    return {"shape": [B, H, T, D], "causal": causal, "mask": mask,
            "max_abs_err": errs, "rule": rules}


def check_flash_dq_bf16_raw(torch, ck, gen, B, H, T, D, causal, mask) -> dict:
    """The bf16 dQ kernel against its plain version where the wrappers'
    gate (T >= 128) does not reach, launched directly on the library
    (``ck._launch_flash``, counted on its count) with the plain lse and
    f32 delta, by the bf16 flash rule.  A ``dead_row`` mask kills the
    last batch row."""
    bf = torch.bfloat16
    q, k, v, g = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                  .mul(0.5).to(bf) for _ in range(4))
    km = torch.ones((B, T), device="cuda")
    if mask == "dead_row":
        km[-1] = 0.0
    s = D ** -0.5
    rout, rlse = ck.flash_forward_reference(q, k, v, km, causal, s)
    delta = ck.flash_delta(g, rout)
    dq = torch.empty_like(q)
    scratch = torch.empty(ck.flash_dq_scratch_bytes(B * H, T, D),
                          dtype=torch.uint8, device="cuda")
    ck._launch_flash(ck.flash_dq, "dq", [q, k, v, km, g, rlse, delta],
                     (dq, scratch), causal, s)
    want = ck.flash_dq_reference(q, k, v, km, g, rlse, delta, causal, s)
    torch.cuda.synchronize()
    r = bf16_conv_compare(torch, dq, want, BF16_FLASH_ATOL)
    case = (B, H, T, D, causal, mask)
    if not r["ok"]:
        raise AssertionError(f"flash bf16 dq at {case} (direct launch) "
                             f"disagrees with its plain version: {r}")
    return {"shape": [B, H, T, D], "causal": causal, "mask": mask,
            "direct_launch": True, "max_abs_err": {"dq": r["max_abs_err"]},
            "rule": {"dq": {k: r[k] for k in ("share_differ",
                                                "share_beyond_one_ulp",
                                                "max_excess")}}}


# the bf16 flash instances in the flash library's SASS (DP 64 and 128; not
# the pre-passes, flash_*_bf16_split) and the tensor-core instruction with
# BF16 operands each must hold: all three on wgmma (HGMMA)
FLASH_BF16_FUNCTIONS = {"flash_forward": (r"flash_fwd_bf16ILi\d+E", "HGMMA"),
                        "flash_dq": (r"flash_dq_bf16ILi\d+E", "HGMMA"),
                        "flash_dkv": (r"flash_dkv_bf16ILi\d+E", "HGMMA")}
# work of the bf16 forms over the one-pass products: P V (forward), dS K
# (dq), P^T dO and dS^T Q (dk/dv) take two products each (hi + lo)
FLASH_BF16_SPLIT_WORK = {"flash_forward": 1.5, "flash_dq": 4 / 3,
                         "flash_dkv": 1.5}


def phase_bf16_sequence_kernels(torch, ck) -> dict:
    """The bf16 forms of the lstm step and the three flash kernels against
    their plain versions: the lstm step at every N the main paths run and
    at ragged edges; flash at the training shape, masked, non-causal, head
    dims 32-128, ragged T and a dead row, and T at the edges of the
    forward's and dk/dv's blocks and tiles (128, 129, 191-193, 257, 385);
    timed at the main paths' shapes beside the bound (one-pass bf16
    products, and the split's work) and ``F.scaled_dot_product_attention``
    on bf16; in every bf16 flash instance's SASS, BF16 HGMMA (wgmma).  dQ
    is also checked at its plan's edges below the wrappers' gate (T = 2,
    63, 65, 127: :func:`check_flash_dq_bf16_raw`)."""
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    steps = [check_lstm_step_bf16(torch, ck, n, CHAR_HIDDEN, gen, timed=True)
             for n in (CHAR_BATCH, SAMPLE_STREAMS, 1)]
    # the f32 form's edges, then the bf16 form's: H past a staged chunk of
    # 224 k, N at the switch from blocks of 4 rows to 8 and not a multiple
    # of either
    steps += [check_lstm_step_bf16(torch, ck, n, h, gen)
              for n, h in ((3, 8), (5, 24), (64, 256), (3, 1024), (7, 264),
                           (40, 8), (17, 200), (9, 16), (2, 8), (17, 232),
                           (33, 200), (8, 456), (9, 200), (1, 8))]
    B, H, T, D = ATT_BATCH, ATT_HEADS, ATT_SEQ, ATT_WIDTH // ATT_HEADS
    cases = [(B, H, T, D, True, "none"), (1, 2, ATT_SEQ, 64, True, "none"),
             (2, 2, 200, 64, False, "tail"), (2, 2, 200, 64, True, "tail"),
             (2, 2, 256, 32, True, "none"), (2, 2, 256, 96, True, "none"),
             (2, 2, 256, 128, False, "none"), (2, 2, 130, 64, True, "none"),
             (2, 2, 256, 64, True, "dead_row"),
             (2, 2, 200, 128, False, "dead_row"),
             (1, 2, ATT_PLAIN_SEQ, 64, True, "none"),
             (1, 2, 300, 64, True, "none")]
    # the edges of the redesigned forms' blocks (forward 192 query rows at
    # DP = 64, 128 at 128; dk/dv 128 keys) and tiles (128 and 64 keys; 64
    # queries in steps of 32), D = 32, 64 and 128
    cases += [(1, 2, 128, 64, True, "none"), (1, 2, 129, 128, True, "none"),
              (1, 2, 191, 32, False, "none"), (1, 2, 192, 64, True, "tail"),
              (1, 2, 193, 64, False, "tail"), (1, 2, 257, 128, True, "tail"),
              (2, 1, 385, 64, True, "dead_row"),
              (2, 1, 129, 32, False, "dead_row")]
    # the edges of dq's plan (128 query rows a block, 64-key tiles): T
    # just under and over both, masked keys, a dead row, D 32, 64, 128
    cases += [(1, 2, 255, 32, True, "tail"), (2, 1, 256, 128, True, "dead_row"),
              (1, 1, 320, 64, False, "tail"), (2, 2, 191, 96, True, "none")]
    checks = [check_flash_bf16(torch, ck, gen, *c) for c in cases]
    # (T = 1 is not among them: with one key p = 1 and dS = dP - delta is
    # 0 by construction, so dq is rounding noise on both sides)
    checks += [check_flash_dq_bf16_raw(torch, ck, gen, *c) for c in (
        (1, 2, 2, 64, True, "none"), (2, 1, 2, 128, False, "dead_row"),
        (1, 2, 63, 32, True, "none"), (2, 2, 65, 64, False, "dead_row"),
        (1, 1, 65, 128, True, "none"), (2, 1, 127, 64, True, "dead_row"))]
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    q, k, v, g, km = _flash_inputs(torch, gen, B, H, T, D)
    q, k, v, g = (t.to(bf) for t in (q, k, v, g))
    s = D ** -0.5
    out, lse = ck.flash_forward(q, k, v, km, True, s)
    delta = ck.flash_delta(g, out)
    calls = {
        "flash_forward": (
            lambda: ck.flash_forward(q, k, v, km, True, s),
            lambda: ck.flash_forward_reference(q, k, v, km, True, s)),
        "flash_dq": (
            lambda: ck.flash_dq(q, k, v, km, g, lse, delta, True, s),
            lambda: ck.flash_dq_reference(q, k, v, km, g, lse, delta, True,
                                          s)),
        "flash_dkv": (
            lambda: ck.flash_dkv(q, k, v, km, g, lse, delta, True, s),
            lambda: ck.flash_dkv_reference(q, k, v, km, g, lse, delta, True,
                                           s))}
    work = _flash_work(B, H, T, D, True, elem=2)
    timed = {}
    for name, (kernel, plain) in calls.items():
        flops, nbytes = work[name]
        rec = {"ms": time_ms(torch, kernel, reps=5, warmup=1),
               "plain_ms": time_ms(torch, plain, reps=3, warmup=1),
               "flops": flops, "bytes": nbytes}
        torch.cuda.empty_cache()
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        rec["split_work"] = FLASH_BF16_SPLIT_WORK[name]
        rec["bound_split_ms"] = max(t_ops * FLASH_BF16_SPLIT_WORK[name],
                                    t_bytes) * 1e3
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        timed[name] = rec
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qs, ks, vs), g)
    with torch.no_grad():
        lib_fwd = time_ms(torch, sdpa, reps=5, warmup=1)
    lib_both = time_ms(torch, sdpa_fwd_bwd, reps=5, warmup=1)
    lib_graph = sdpa()

    def sdpa_bwd():
        torch.autograd.grad(lib_graph, (qs, ks, vs), g, retain_graph=True)
    lib_bwd = time_ms(torch, sdpa_bwd, reps=5, warmup=1)
    lib_out = lib_graph.detach()
    del lib_graph
    lib_vs_kernel = bf16_conv_compare(torch, lib_out, out, BF16_FLASH_ATOL)
    res = {"lstm_rule": "|y - ref| <= ulp_bf16(ref) + BF16_CONV_ATOL * "
                        "max|ref|",
           "flash_rule": "|y - ref| <= ulp_bf16(ref) + BF16_FLASH_ATOL * "
                         "max|ref|; lse FLASH_TOL",
           "flash_atol_scaled": BF16_FLASH_ATOL, "lstm_steps": steps,
           "lstm_us_per_step": steps[0]["ms"] * 1e3,
           "lstm_plain_us_per_step": steps[0]["plain_ms"] * 1e3,
           "lstm_bound_us_per_step": steps[0]["bound_ms"] * 1e3,
           "lstm_library_note": "no single PyTorch call computes a "
                                "peephole LSTM step: torch.lstm_cell has no "
                                "peepholes",
           "flash_checks": checks, "timed_shape": [B, H, T, D],
           "causal": True, "timed": timed,
           "sass_bf16": {
               name: hgmma_count(ck, ck.FLASH_LIBRARY, pattern, "BF16", instr)
               for name, (pattern, instr) in FLASH_BF16_FUNCTIONS.items()},
           "sass_bf16_instruction": {
               name: instr
               for name, (_, instr) in FLASH_BF16_FUNCTIONS.items()},
           "library_ms_forward": lib_fwd,
           "library_ms_forward_backward": lib_both,
           "library_ms_backward": lib_bwd,
           "kernels_ms_forward_backward": sum(r["ms"]
                                              for r in timed.values()),
           "kernels_ms_backward": timed["flash_dq"]["ms"]
           + timed["flash_dkv"]["ms"],
           "library_vs_kernel": lib_vs_kernel,
           "library_note": "F.scaled_dot_product_attention (bf16, causal), "
                           "timed only: its forward for flash_forward; its "
                           "backward alone computes dq, dk and dv in one "
                           "call and is set against the pair"}
    emit("bf16_sequence_kernels", **res)
    return res


def _seq_step_runs(torch, ck, net, x, y, start, modes) -> dict:
    """One gradient step and update of ``net`` on the batch (x, y) per mode,
    each from ``start`` = (params, updater state, layer states, iteration):
    ``modes`` maps a name to (a context manager factory, the precision to
    run under).  -> {name: (score, params, gradients, launches)}; the
    network is left as it was."""
    g = net.conf.global_conf
    keep = (g.precision, net.net_params, net.opt_states, net.net_state,
            net.iteration, net._score)
    runs = {}
    try:
        for name, (ctx, precision) in modes.items():
            net.net_params, net.opt_states, net.net_state = (
                _clone_tree(t) for t in start[:3])
            g.precision = precision
            before = _kernel_counts(ck)
            with ctx():
                score, grads = net._grad_step(x, y, None, None, None)
                kept = _clone_tree(grads)
                net._apply_updates(grads, start[3])
            after = _kernel_counts(ck)
            runs[name] = (float(score), net.net_params, kept,
                          {n: after[n] - before[n] for n in after
                           if after[n] != before[n]})
    finally:
        (g.precision, net.net_params, net.opt_states, net.net_state,
         net.iteration, net._score) = keep
    return runs


def _steps_vs(torch, run, ref, p0, skip=()) -> dict:
    """A step (score, params, gradients) against a reference step from the
    same params ``p0``: the score's relative difference, and per tensor
    (but ``skip``) the relative 2-norm of the gradient's and the update's
    difference; the largest of each and the four worst updates."""
    grads = {f"{i}_{k}": _rel_norm(torch, run[2][i][k], lp[k])
             for i, lp in enumerate(ref[2]) for k in lp if k not in skip}
    updates = {f"{i}_{k}": _rel_norm(torch, run[1][i][k] - p0[i][k],
                                     lp[k] - p0[i][k])
               for i, lp in enumerate(ref[1]) for k in lp if k not in skip}
    return {"score": run[0], "ref_score": ref[0],
            "score_rel_diff": abs(run[0] - ref[0]) / abs(ref[0]),
            "max_grad_rel_err": max(grads.values()),
            "max_update_rel_err": max(updates.values()),
            "grad_rel_err": grads, "update_rel_err": updates,
            "worst_updates": dict(sorted(updates.items(),
                                         key=lambda kv: -kv[1])[:4])}


def _update_cosine(torch, p0, pa, pb) -> float:
    """The cosine of two whole-network updates from ``p0``."""
    dot = na = nb = 0.0
    for t0, a, b in zip(_tensor_leaves(p0), _tensor_leaves(pa),
                        _tensor_leaves(pb)):
        ua, ub = (a - t0).double(), (b - t0).double()
        dot += float((ua * ub).sum())
        na += float((ua * ua).sum())
        nb += float((ub * ub).sum())
    return dot / (na * nb) ** 0.5


def seq_bf16_modes(plain_ctx, kernel_ctx=contextlib.nullcontext):
    """The three runs a bf16 sequence step is held to: through the kernels
    (``kernel_ctx``), through the plain versions (``plain_ctx``), and the
    f32 step."""
    return {"kernel": (kernel_ctx, "bfloat16"),
            "plain": (plain_ctx, "bfloat16"),
            "f32": (contextlib.nullcontext, None)}


def compare_seq_bf16(torch, runs, p0, score_rtol, update_rtol, cosine_min,
                     grad_rtol=None, skip=()) -> dict:
    """The kernel step against the plain bf16 step (score, updates and, with
    ``grad_rtol``, gradients, by the rules given) and against the f32 step
    (the cosine of the updates); ``ok`` says whether all hold."""
    vs_plain = _steps_vs(torch, runs["kernel"], runs["plain"], p0, skip)
    vs_f32 = _steps_vs(torch, runs["kernel"], runs["f32"], p0, skip)
    cos = _update_cosine(torch, p0, runs["kernel"][1], runs["f32"][1])
    ok = (vs_plain["score_rel_diff"] <= score_rtol
          and vs_plain["max_update_rel_err"] <= update_rtol
          and (grad_rtol is None or vs_plain["max_grad_rel_err"] <= grad_rtol)
          and cos >= cosine_min)
    return {"vs_plain": vs_plain,
            "vs_f32": {k: vs_f32[k] for k in ("score", "ref_score",
                                              "score_rel_diff",
                                              "max_grad_rel_err",
                                              "max_update_rel_err")},
            "f32_update_cosine": cos, "score_rtol": score_rtol,
            "update_rtol": update_rtol, "grad_rtol": grad_rtol,
            "cosine_min": cosine_min, "ok": ok}


def phase_train_charrnn_bf16(torch, ck, train_char) -> tuple:
    """The char-RNN of ``train_charrnn`` under precision("bfloat16"):
    CHAR_BF16_MINIBATCHES minibatches of 32 x 1,000 characters, exactly
    2 x 1,000 launches of the lstm kernel's bf16 form each and no other
    kernel, f32 masters and gradients; then one TBPTT segment from the
    trained state through the kernel, through the plain bf16 step and in
    f32, by the rules of the constants."""
    from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn
    torch.backends.cuda.matmul.allow_tf32 = False
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=CHAR_SEQ, batch=CHAR_BATCH, seed=0)
    net = char_rnn(it.vocab_size, CHAR_HIDDEN, CHAR_LAYERS,
                   tbptt_length=CHAR_TBPTT, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    net.conf.global_conf.precision = "bfloat16"
    grad_dtypes = _recording_grad_dtypes(net)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    minibatches = []
    fallbacks = _fallbacks("lstm_step")
    _zero_counts(ck)                                   # main path starts
    for k in range(CHAR_BF16_MINIBATCHES):
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(it.next())
        score = net.score()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        minibatches.append({
            "minibatch": k + 1, "score": score, "seconds": dt,
            "chars_per_s": CHAR_BATCH * CHAR_SEQ / dt,
            "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    fallbacks = _fallbacks("lstm_step") - fallbacks
    peak = torch.cuda.max_memory_allocated()
    del net._apply_updates
    masters = _f32_masters(net, "char-RNN bf16")
    want = _want(ck, lstm_step_bf16=CHAR_LAYERS * CHAR_SEQ)
    for mb in minibatches:
        if mb["launches"] != want or not np.isfinite(mb["score"]):
            raise AssertionError(f"char-RNN bf16 minibatch {mb}: launches "
                                 f"must be {want} and the score finite")
    if fallbacks or grad_dtypes != {"float32"} or \
            net.iteration != CHAR_BF16_MINIBATCHES * CHAR_SEQ // CHAR_TBPTT:
        raise AssertionError(f"char-RNN bf16: {fallbacks} lstm fallbacks, "
                             f"gradients {grad_dtypes}, {net.iteration} "
                             f"TBPTT steps")
    ds = it.next()
    x = torch.from_numpy(ds.features[:, :CHAR_TBPTT]).cuda()
    y = torch.from_numpy(ds.labels[:, :CHAR_TBPTT]).cuda()
    start = (_clone_tree(net.net_params), _clone_tree(net.opt_states),
             _clone_tree(net.net_state), net.iteration)
    runs = _seq_step_runs(torch, ck, net, x, y, start, seq_bf16_modes(
        lambda: _plain_lstm_launch(ck)))
    seg = compare_seq_bf16(torch, runs, start[0], CHAR_BF16_SCORE_RTOL,
                           CHAR_BF16_UPDATE_RTOL, CHAR_BF16_COSINE_MIN)
    seg["launches"] = {n: r[3] for n, r in runs.items()}
    f32_rate = train_char["chars_per_s_after_first"]
    res = {"precision": "bfloat16", "vocab": it.vocab_size,
           "batch": CHAR_BATCH, "seq": CHAR_SEQ, "tbptt": CHAR_TBPTT,
           "segments": net.iteration, "minibatches": minibatches,
           "chars_per_s_after_first": CHAR_BATCH * CHAR_SEQ
           * (CHAR_BF16_MINIBATCHES - 1)
           / sum(m["seconds"] for m in minibatches[1:]),
           "f32_chars_per_s_after_first": f32_rate,
           "launches": launches, "lstm_fallbacks": fallbacks,
           "max_memory_allocated": peak,
           "f32_max_memory_allocated": train_char["max_memory_allocated"],
           "dtypes": {**masters, "gradients": sorted(grad_dtypes)},
           "segment": seg}
    emit("train_charrnn_bf16", **res)
    if not seg["ok"] or seg["launches"]["kernel"] != {
            "lstm_step_bf16": 2 * CHAR_TBPTT} or seg["launches"]["plain"]:
        raise AssertionError(f"char-RNN bf16 segment through the kernel "
                             f"disagrees with the plain bf16 step or the f32 "
                             f"step: {seg}")
    return res, net, it


def phase_sample_charrnn_bf16(torch, ck, net, it) -> dict:
    """``rnn_time_step`` sampling and ``sample_text`` on the bf16 char-RNN:
    2 launches of the bf16 form a step and no other kernel; 50 characters
    fed one at a time against ``output()`` on the same prefix (relative
    2-norm of the probabilities, CHAR_BF16_SAMPLE_REL); probabilities sum
    to 1 within BF16_PROBS_SUM_ATOL."""
    from deeplearning4j_tpu_torch.models import sample_text
    V = it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(SEED)
    net.rnn_clear_previous_state()
    cur = rng.integers(0, V, SAMPLE_STREAMS)
    picks = []
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    for _ in range(SAMPLE_CHARS):
        out = net.rnn_time_step(eye[cur][:, None, :])[:, -1]
        p = out.double().cpu().numpy()
        cur = np.array([rng.choice(V, p=q / q.sum()) for q in p])
        picks.append(cur)
    stream_s = time.perf_counter() - t0
    stream_launches = ck.fused_lstm_step.bf16.launches
    seed_text, length = "The ", 100
    t0 = time.perf_counter()
    text = sample_text(net, it, seed_text, length=length, rng_seed=SEED)
    text_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    want_stream = CHAR_LAYERS * SAMPLE_CHARS
    want = _want(ck, lstm_step_bf16=CHAR_LAYERS * (
        SAMPLE_CHARS + len(seed_text) + length))
    if stream_launches != want_stream or launches != want:
        raise AssertionError(f"bf16 sampling launched {launches} "
                             f"({stream_launches} over the streams); want "
                             f"{want_stream} over the streams and {want}")
    if len(text) != len(seed_text) + length or \
            any(ch not in it.char_to_idx for ch in text):
        raise AssertionError(f"sample_text gave {text!r}")
    x = it.next().features[:SAMPLE_STREAMS, :CHAR_TBPTT]
    full = net.output(x)
    net.rnn_clear_previous_state()
    steps = torch.cat([net.rnn_time_step(x[:, t:t + 1])
                       for t in range(CHAR_TBPTT)], dim=1)
    rel = _rel_norm(torch, steps, full)
    sums = float((full.sum(dim=-1) - 1).abs().max())
    res = {"precision": "bfloat16", "streams": SAMPLE_STREAMS,
           "chars": SAMPLE_CHARS,
           "ms_per_char": stream_s / SAMPLE_CHARS * 1e3,
           "stream_launches": stream_launches,
           "sample_text_ms_per_char": text_s / (len(seed_text) + length)
           * 1e3, "launches": launches,
           "first_stream": "".join(it.idx_to_char[int(p[0])] for p in picks),
           "sample_text": text,
           "time_step_vs_output_rel_norm": rel,
           "time_step_vs_output_max_abs": float((steps - full).abs().max()),
           "sample_rel_rule": CHAR_BF16_SAMPLE_REL,
           "probs_sum_max_err": sums}
    emit("sample_charrnn_bf16", **res)
    if rel > CHAR_BF16_SAMPLE_REL or sums > BF16_PROBS_SUM_ATOL or \
            full.dtype != torch.float32:
        raise AssertionError(f"bf16 char-RNN: rnn_time_step against "
                             f"output() {rel} (rule {CHAR_BF16_SAMPLE_REL}), "
                             f"sums off by {sums}")
    return res


def _attention_start(net, start):
    """The state ``_attention_step_vs_plain`` compares from: the initial
    params with Wq, Wk of both layers times ATT_PEAK_QK and layer 0's Wv,
    Wo times ATT_SPREAD_V (its docstring says why), a fresh updater."""
    begin = _clone_tree(start)
    for i in range(ATT_LAYERS):
        for k in ("Wq", "Wk"):
            begin[i][k] *= ATT_PEAK_QK
    for k in ("Wv", "Wo"):
        begin[0][k] *= ATT_SPREAD_V
    return begin, net._init_opt_states()


def phase_train_attention_bf16(torch, ck, train_att) -> tuple:
    """The attention model of ``train_attention`` under
    precision("bfloat16"): ATT_BF16_STEPS ``fit`` steps of 4 x 8,192
    characters, exactly 2 launches of each bf16 flash form a step, no
    other kernel and no attention fallback, peak memory below one dense
    bf16 score tensor, f32 masters; then one step at ATT_PLAIN_SEQ from
    ``_attention_step_vs_plain``'s state through the kernels, through the
    plain versions in bf16 and in f32, by the rules of the constants (the
    key bias bk held to none: its gradient is rounding noise)."""
    from deeplearning4j_tpu_torch.models import CharacterIterator, attention_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=ATT_SEQ, batch=ATT_BATCH, seed=0)
    net = attention_lm(it.vocab_size, ATT_WIDTH, ATT_HEADS, ATT_LAYERS,
                       ATT_SEQ, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    net.conf.global_conf.precision = "bfloat16"
    start = _clone_tree(net.net_params)
    grad_dtypes = _recording_grad_dtypes(net)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    fallbacks = _fallbacks("attention")
    _zero_counts(ck)                                   # main path starts
    for k in range(ATT_BF16_STEPS):
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(it.next())
        score = net.score()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        steps.append({"step": k + 1, "score": score, "seconds": dt,
                      "chars_per_s": ATT_BATCH * ATT_SEQ / dt,
                      "launches": {n: after[n] - counts[n] for n in after}})
    launches = _kernel_counts(ck)                      # main path ends
    fallbacks = _fallbacks("attention") - fallbacks
    peak = torch.cuda.max_memory_allocated()
    del net._apply_updates
    masters = _f32_masters(net, "attention bf16")
    want = _want(ck, flash_forward_bf16=ATT_LAYERS, flash_dq_bf16=ATT_LAYERS,
                 flash_dkv_bf16=ATT_LAYERS)
    for st in steps:
        if st["launches"] != want or not np.isfinite(st["score"]):
            raise AssertionError(f"attention bf16 step {st}: launches must "
                                 f"be {want} and the score finite")
    dense_scores = 2 * ATT_BATCH * ATT_HEADS * ATT_SEQ ** 2
    if fallbacks or peak >= dense_scores or grad_dtypes != {"float32"}:
        raise AssertionError(f"attention bf16: {fallbacks} fallbacks, peak "
                             f"{peak} B (one dense bf16 score tensor is "
                             f"{dense_scores} B), gradients {grad_dtypes}")
    ds = it.next()
    x = torch.from_numpy(ds.features[:, :ATT_PLAIN_SEQ]).cuda()
    y = torch.from_numpy(ds.labels[:, :ATT_PLAIN_SEQ]).cuda()
    begin, opt0 = _attention_start(net, start)
    runs = _seq_step_runs(torch, ck, net, x, y,
                          (begin, opt0, net.net_state, 0),
                          seq_bf16_modes(lambda: _plain_flash(ck)))
    step = compare_seq_bf16(torch, runs, begin, ATT_BF16_SCORE_RTOL,
                            ATT_BF16_UPDATE_RTOL, ATT_BF16_COSINE_MIN,
                            ATT_BF16_GRAD_RTOL, skip=("bk",))
    step["launches"] = {n: r[3] for n, r in runs.items()}
    step.update(seq=ATT_PLAIN_SEQ, peak_qk=ATT_PEAK_QK,
                spread_v=ATT_SPREAD_V)
    res = {"precision": "bfloat16", "vocab": it.vocab_size,
           "batch": ATT_BATCH, "seq": ATT_SEQ, "width": ATT_WIDTH,
           "heads": ATT_HEADS, "layers": ATT_LAYERS, "steps": steps,
           "chars_per_s_after_first": ATT_BATCH * ATT_SEQ
           * (ATT_BF16_STEPS - 1) / sum(st["seconds"] for st in steps[1:]),
           "f32_chars_per_s_after_first":
               train_att["chars_per_s_after_first"],
           "launches": launches, "attention_fallbacks": fallbacks,
           "max_memory_allocated": peak,
           "f32_max_memory_allocated": train_att["max_memory_allocated"],
           "one_dense_bf16_score_tensor_bytes": dense_scores,
           "dtypes": {**masters, "gradients": sorted(grad_dtypes)},
           "plain_step": step}
    emit("train_attention_bf16", **res)
    res["initial_params"] = start
    kernel_want = {n: ATT_LAYERS for n in ("flash_forward_bf16",
                                           "flash_dq_bf16",
                                           "flash_dkv_bf16")}
    if not step["ok"] or step["launches"]["kernel"] != kernel_want or \
            step["launches"]["plain"]:
        raise AssertionError(f"attention bf16 step through the kernels "
                             f"disagrees with the plain bf16 step or the "
                             f"f32 step: {step}")
    return res, net, it


def _bf16_output_vs_f32(torch, ck, net, x, params) -> dict:
    """``output()`` on ``params`` in bf16 through the kernels, in bf16
    through the plain versions (a kernel-free witness) and in f32:
    relative 2-norms of the probabilities.  The network's params and
    precision are put back."""
    g, keep = net.conf.global_conf, net.net_params
    net.net_params = params
    try:
        out_k = net.output(x)
        with _plain_flash(ck):
            out_p = net.output(x)
        g.precision = None
        out_f = net.output(x)
    finally:
        g.precision, net.net_params = "bfloat16", keep
    return {"kernel_vs_f32": _rel_norm(torch, out_k, out_f),
            "plain_vs_f32": _rel_norm(torch, out_p, out_f),
            "kernel_vs_plain": _rel_norm(torch, out_k, out_p)}


def phase_output_attention_bf16(torch, ck, net, it, initial) -> dict:
    """``output()`` of the bf16 attention model on 4 x 8,192 characters:
    2 launches of the bf16 flash forward a call and no other kernel;
    probabilities f32, finite, summing to 1 within BF16_PROBS_SUM_ATOL.
    Against the f32 network's on the same params, through the kernels and
    through the plain bf16 versions (no kernel): on the trained params
    (reported: 3 steps at the recipe's lr saturate this width, and there
    both bf16 outputs read 0.0764 from f32's and 0 from each other on an
    H100, bf16's own distance), and on the initial params ``initial``,
    where both are held to ATT_BF16_PROBS_REL (relative 2-norm; both read
    0.0042 there)."""
    ds = it.next()
    x = torch.from_numpy(ds.features).cuda()
    net.output(x)
    torch.cuda.synchronize()
    walls = []
    _zero_counts(ck)                                   # main path starts
    for _ in range(3):
        t0 = time.perf_counter()
        out = net.output(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_counts(ck)                      # main path ends
    sums = float((out.sum(dim=-1) - 1).abs().max())
    vs_f32 = {"trained": _bf16_output_vs_f32(torch, ck, net, x,
                                             net.net_params),
              "initial": _bf16_output_vs_f32(torch, ck, net, x, initial)}
    res = {"precision": "bfloat16", "batch": ATT_BATCH, "seq": ATT_SEQ,
           "wall_ms": float(np.median(walls)), "wall_ms_each": walls,
           "launches": launches,
           "chars_per_s": ATT_BATCH * ATT_SEQ / float(np.median(walls)) * 1e3,
           "probs_vs_f32": vs_f32, "probs_rel_rule": ATT_BF16_PROBS_REL,
           "probs_sum_max_err": sums}
    emit("output_attention_bf16", **res)
    held = vs_f32["initial"]
    if launches != _want(ck, flash_forward_bf16=3 * ATT_LAYERS) or \
            tuple(out.shape) != (ATT_BATCH, ATT_SEQ, it.vocab_size) or \
            out.dtype != torch.float32 or \
            not bool(torch.isfinite(out).all()) or \
            sums > BF16_PROBS_SUM_ATOL or \
            max(held["kernel_vs_f32"], held["plain_vs_f32"]) > \
            ATT_BF16_PROBS_REL:
        raise AssertionError(f"bf16 attention output(): {res}")
    return res


def phase_sample_attention_bf16(torch, ck, net, it) -> dict:
    """KV-ring sampling of the bf16 attention model as
    ``sample_attention`` (no kernel: the ring is plain torch in bf16), the
    ring's answers against ``output()`` on the whole 300-character prefix
    (the bf16 flash forward) by ATT_BF16_SAMPLE_REL in relative 2-norm."""
    from deeplearning4j_tpu_torch.models import sample_text
    V = it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(SEED)
    net.rnn_clear_previous_state()
    cur = rng.integers(0, V, SAMPLE_STREAMS)
    picks, outs = [cur], []
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    for _ in range(SAMPLE_CHARS):
        out = net.rnn_time_step(eye[cur][:, None, :])[:, -1]
        outs.append(out)
        p = out.double().cpu().numpy()
        cur = np.array([rng.choice(V, p=q / q.sum()) for q in p])
        picks.append(cur)
    stream_s = time.perf_counter() - t0
    seed_text, length = "The ", 100
    t0 = time.perf_counter()
    text = sample_text(net, it, seed_text, length=length, rng_seed=SEED)
    text_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    if any(launches.values()):
        raise AssertionError(f"bf16 KV-ring sampling launched {launches}")
    if len(text) != len(seed_text) + length or \
            any(ch not in it.char_to_idx for ch in text):
        raise AssertionError(f"sample_text gave {text!r}")
    prefix = np.stack(picks[:SAMPLE_CHARS], axis=1)
    before = ck.flash_forward.bf16.launches
    full = net.output(eye[prefix])
    full_launches = ck.flash_forward.bf16.launches - before
    steps = torch.stack(outs, dim=1)
    rel = _rel_norm(torch, steps, full)
    res = {"precision": "bfloat16", "streams": SAMPLE_STREAMS,
           "chars": SAMPLE_CHARS, "window": net.layers[0].cache_window,
           "ms_per_char": stream_s / SAMPLE_CHARS * 1e3,
           "sample_text_ms_per_char": text_s / (len(seed_text) + length)
           * 1e3, "launches": launches,
           "first_stream": "".join(it.idx_to_char[int(p[0])] for p in picks),
           "sample_text": text, "output_launches": full_launches,
           "time_step_vs_output_rel_norm": rel,
           "time_step_vs_output_max_abs": float((steps - full).abs().max()),
           "sample_rel_rule": ATT_BF16_SAMPLE_REL}
    emit("sample_attention_bf16", **res)
    if rel > ATT_BF16_SAMPLE_REL or full_launches != ATT_LAYERS:
        raise AssertionError(f"bf16 KV ring against output(): {rel} (rule "
                             f"{ATT_BF16_SAMPLE_REL}), {full_launches} "
                             f"forward launches")
    return res


# Word2Vec at text8's vocabulary scale (BASELINE config 4; text8 is not in
# the repo): V = 71,290 words (text8's vocabulary at min count 5), layer
# 128, bench.py's protocol (window 5, 5 negatives, no HS, min frequency 1,
# 1 epoch, flushes of 2,048 pairs).  The corpus is seeded and synthetic:
# 1,000,000 tokens in 20-word sentences; 1,290 shared background words and
# 20 topics of 3,500 words; each sentence belongs to one topic and draws
# each token from its topic's Zipf words (80 % of the tokens) or the
# background's Zipf words.  Topics of 3,500 words hold enough tokens each
# for one epoch to separate them: at a tenth of the scale, 20 topics of 350
# words left the trained table below the initial one on the check below
# (0.024 against 0.054), 2 topics of 3,500 reached 1.0 (CPU rehearsals).
W2V_VOCAB, W2V_LAYER, W2V_BATCH, W2V_WINDOW, W2V_NEGATIVE = (
    71_290, 128, 2_048, 5, 5)
W2V_TOKENS, W2V_SENT, W2V_TOPICS, W2V_BACKGROUND = 1_000_000, 20, 20, 1_290
W2V_TOPIC_SHARE = 0.8
# The step phase at full width: K = 6 negative columns (target + 5), HS
# and NS both on, CBOW windows of W = 2 x 5 + 1 (one PV-DM label slot).
W2V_K, W2V_W = W2V_NEGATIVE + 1, 2 * W2V_WINDOW + 1
# Card vs CPU, one step: relative 2-norm of the difference of the two
# updates (new - old) over the CPU's update, per table.  Both f32; the
# card's index_add_ adds duplicate rows in no fixed order and the dots sum
# in another order.  The CPU port against JAX's XLA step reads ~1e-7, and
# up to 1.8e-6 on a table whose rows take ~30 contributions of both signs
# in a chunk (tests/test_torch_embeddings.py); Zipf-heavy rows at full
# width take more: 5e-5.
W2V_STEP_RTOL = 5e-5
# Whole small fits, card vs CPU: relative 2-norm of the difference of the
# final tables over the CPU fit's change from its initial table.  The CPU
# port against JAX reads <= 4.3e-7 after whole fits (rule 1e-5 there); the
# card's unordered atomics add rounding at every step: 1e-4.  GloVe's last
# epoch loss, a sum of small squared residuals, moves 20x more than its
# table (8.1e-6 for 4.3e-7 on the CPU): 1e-3.
W2V_FIT_RTOL = 1e-4
W2V_GLOVE_LOSS_RTOL = 1e-3
# The dependence check: for the W2V_QUERIES most frequent topic words, the
# share of their W2V_NEAREST nearest words (``words_nearest``) that belong
# to their topic.  Chance is 3,500 / 71,290 = 4.9 %.  CPU rehearsals of
# this corpus at half the scale (10 topics of 3,500, 645 background words,
# 500,000 tokens) read 1.0 trained and 0.10 initial, at a tenth (2 topics)
# 1.0 and 0.50; the check asks for W2V_TOPICAL_MIN on the trained table and
# less on the initial one.
W2V_QUERIES, W2V_NEAREST, W2V_TOPICAL_MIN = 50, 10, 0.5
# flushes under the profiler for the idle share
W2V_TRACE_SENTENCES = 1_000


def text8_scale_corpus(seed: int, vocab: int = W2V_VOCAB,
                       tokens: int = W2V_TOKENS, sent: int = W2V_SENT,
                       topics: int = W2V_TOPICS,
                       background: int = W2V_BACKGROUND):
    """-> (sentences, topic of each word id or -1 for background).

    Word i is "w{i}"; every one of the ``vocab`` words occurs at least
    once: a word the draw missed replaces a background token of a
    sentence of its own topic."""
    rng = np.random.default_rng(seed)
    per_topic = (vocab - background) // topics
    if background + per_topic * topics != vocab:
        raise ValueError("vocab - background must split into the topics")
    n_sent = tokens // sent
    sent_topic = rng.integers(0, topics, n_sent)

    def zipf(n):
        p = 1.0 / np.arange(1, n + 1)
        return p / p.sum()

    topical = rng.random((n_sent, sent)) < W2V_TOPIC_SHARE
    bg = rng.choice(background, size=(n_sent, sent), p=zipf(background))
    tw = (background + sent_topic[:, None] * per_topic
          + rng.choice(per_topic, size=(n_sent, sent), p=zipf(per_topic)))
    ids = np.where(topical, tw, bg)
    missing = np.flatnonzero(np.bincount(ids.ravel(), minlength=vocab) == 0)
    by_topic = [np.flatnonzero(sent_topic == t) for t in range(topics)]
    for word in missing:
        t = (word - background) // per_topic if word >= background else None
        rows = by_topic[t] if t is not None else np.arange(n_sent)
        while True:
            r = rows[rng.integers(rows.size)]
            free = np.flatnonzero(~topical[r])
            if free.size:
                c = free[rng.integers(free.size)]
                ids[r, c], topical[r, c] = word, True
                break
    if np.count_nonzero(np.bincount(ids.ravel(), minlength=vocab)) != vocab:
        raise AssertionError("the corpus does not hold every word")
    topic_of = np.full(vocab, -1)
    topic_of[background:] = np.arange(vocab - background) // per_topic
    words = np.array([f"w{i}" for i in range(vocab)])
    return [" ".join(row) for row in words[ids]], topic_of


def _step_inputs(sv, rng, n_rows):
    """One flush of seeded inputs for the three steps at full width, from
    the port's own batch assembly (``_BatchBuffer._hs_neg_arrays``):
    centers and contexts drawn by frequency (Zipf-heavy duplicates)."""
    from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
        _BatchBuffer)
    B, W = W2V_BATCH, W2V_W
    freqs = np.array([w.element_frequency for w in sv.vocab.vocab_words()])
    p = freqs / freqs.sum()
    points_m, codes_m, cmask_m = sv._code_matrices()
    buf = _BatchBuffer(sv.lookup_table, sv.conf, points_m, codes_m, cmask_m,
                       rng, W)
    center = rng.choice(n_rows, size=B, p=p).astype(np.int32)
    ctx = rng.choice(n_rows, size=B, p=p).astype(np.int32)
    pair_mask = np.ones(B, np.float32)
    pair_mask[-7:] = 0.0                           # a padded tail
    alpha = np.full(B, 0.025, np.float32) * pair_mask
    hs_ns = buf._hs_neg_arrays(center, pair_mask)
    win = rng.choice(n_rows, size=(B, W), p=p).astype(np.int32)
    wmask = (np.arange(W)[None, :]
             < rng.integers(1, W + 1, size=(B, 1))).astype(np.float32)
    wmask *= pair_mask[:, None]
    vec = ((rng.random((B, W2V_LAYER), dtype=np.float32) - 0.5)
           / W2V_LAYER)
    return {"skipgram": (ctx,) + hs_ns + (alpha,),
            "cbow": (win, wmask) + hs_ns + (alpha,),
            "infer": hs_ns + (alpha,), "vec": vec}


def _device_trace(torch, fn) -> dict:
    """One call of ``fn`` under the profiler: wall ms, device activities
    (kernels, copies, memsets), busy ms (union of their intervals) and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, copies = [], 0
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        copies += "memcpy" in ev.name.lower()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e6 / wall, "device_activities":
            len(spans), "copies": copies}


def _step_bytes(B, D, C, K, W=1) -> int:
    """Bytes one step must move: each gathered row read once and written
    once (syn0's W rows a pair, C syn1 rows, K syn1neg rows), and its
    integer and float inputs read once."""
    rows = B * (W + C + K)
    inputs = B * (W * 2 + C * 3 + K * 3 + 1) * 4
    return rows * D * 4 * 2 + inputs


@_tf32_off
def phase_w2v_step(torch) -> dict:
    """``skipgram_step``, ``cbow_step`` and ``infer_step`` at full width on
    the card against the port's CPU functions on the same seeded inputs."""
    from deeplearning4j_tpu_torch.embeddings import (
        SequenceVectors, VectorsConfiguration, kernels)
    from deeplearning4j_tpu_torch.embeddings.lookup import TABLES
    from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
        step_branches, to_device)
    from deeplearning4j_tpu_torch.text import AbstractCache, Huffman
    from deeplearning4j_tpu_torch.text.sequence import VocabWord
    sents, _ = text8_scale_corpus(SEED)
    counts = {}
    for s in sents:
        for tok in s.split():
            counts[tok] = counts.get(tok, 0) + 1
    vocab = AbstractCache()
    for label, n in counts.items():
        vocab.add_token(VocabWord(label, float(n)))
    vocab.build_index()
    Huffman(vocab.vocab_words()).build()
    cuda = torch.device("cuda")
    conf = VectorsConfiguration(
        layer_size=W2V_LAYER, window=W2V_WINDOW, negative=W2V_NEGATIVE,
        use_hierarchic_softmax=True, min_word_frequency=1,
        batch_size=W2V_BATCH, seed=SEED)
    sv = SequenceVectors(conf, vocab=vocab, device=cuda)
    sv.build_vocab()
    rng = np.random.default_rng(SEED)
    t = sv.lookup_table
    V, D = vocab.num_words(), W2V_LAYER
    C = sv._code_matrices()[0].shape[1]
    for name in ("syn1", "syn1neg"):           # nonzero output tables
        n = getattr(t, name).shape[0]
        t.set_array(name, rng.normal(0, 0.1, (n, D)).astype(np.float32))
    start = {name: t.array(name) for name in TABLES}
    inputs = _step_inputs(sv, rng, V)
    branches = step_branches(sv.conf)
    out = {"V": V, "D": D, "B": W2V_BATCH, "C": C, "K": W2V_K, "W": W2V_W}

    def run(kind, device, tables):
        args = to_device(device, *inputs[kind])
        if kind == "infer":
            vec = torch.tensor(inputs["vec"], device=device)
            return lambda: (kernels.infer_step(vec, tables["syn1"],
                                               tables["syn1neg"], *args,
                                               **branches),)
        step = kernels.skipgram_step if kind == "skipgram" \
            else kernels.cbow_step
        return lambda: step(*(tables[n] for n in TABLES), *args, **branches)

    for kind in ("skipgram", "cbow", "infer"):
        tabs = {dev: {n: torch.tensor(a, device=dev)
                      for n, a in start.items()} for dev in ("cpu", "cuda")}
        got = run(kind, cuda, tabs["cuda"])()
        want = run(kind, torch.device("cpu"), tabs["cpu"])()
        names = ("vec",) if kind == "infer" else TABLES
        old = ([torch.tensor(inputs["vec"])] if kind == "infer"
               else [torch.tensor(start[n]) for n in TABLES])
        errs = {}
        for name, g, w, o in zip(names, got, want, old):
            errs[name] = _rel_norm(torch, g.cpu() - o, w - o)
            if not errs[name] <= W2V_STEP_RTOL or not bool(
                    torch.isfinite(g).all()):
                raise AssertionError(
                    f"w2v_step {kind} {name}: card vs CPU {errs[name]:.3g}"
                    f" > {W2V_STEP_RTOL}")
        fn = run(kind, cuda, tabs["cuda"])
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        trace = _device_trace(torch, fn)
        W = W2V_W if kind == "cbow" else (0 if kind == "infer" else 1)
        nbytes = _step_bytes(W2V_BATCH, D, C, W2V_K, W)
        out[kind] = {"rel_err": errs, "rule": W2V_STEP_RTOL,
                     "ms": time_ms(torch, fn, reps=10),
                     "host_enqueue_ms": float(np.median(host)),
                     "launches": trace["device_activities"],
                     "busy_ms": trace["busy_ms"],
                     "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
                     "bound_by": "bytes"}
    emit("w2v_step", **out)
    return out


def _topical_share(model, topic_of, queries) -> float:
    """Share of the queries' nearest words (``words_nearest``) in their
    own topic."""
    hits = 0
    for q in queries:
        near = model.words_nearest(q, top=W2V_NEAREST)
        hits += sum(topic_of[int(w[1:])] == topic_of[int(q[1:])]
                    for w in near)
    return hits / (len(queries) * W2V_NEAREST)


@_tf32_off
def phase_train_word2vec(torch) -> tuple:
    """``Word2Vec.Builder()...build().fit()`` on the card at full width,
    bench.py's protocol, on the seeded text8-scale corpus -> (record, the
    trained model, the corpus's sentences, the topic of each word id)."""
    from deeplearning4j_tpu_torch.embeddings import (
        InMemoryLookupTable, SequenceVectors, Word2Vec, kernels,
        sequencevectors)
    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator
    t0 = time.perf_counter()
    sents, topic_of = text8_scale_corpus(SEED)
    corpus_s = time.perf_counter() - t0

    def builder(sentences):
        return (Word2Vec.Builder()
                .iterate(CollectionSentenceIterator(sentences))
                .layer_size(W2V_LAYER).window_size(W2V_WINDOW)
                .negative_sample(W2V_NEGATIVE)
                .use_hierarchic_softmax(False).min_word_frequency(1)
                .epochs(1).batch_size(W2V_BATCH).seed(7).device("cuda"))

    w2v = builder(sents).build()
    t0 = time.perf_counter()
    w2v.build_vocab()
    vocab_s = time.perf_counter() - t0
    if w2v.vocab_size() != W2V_VOCAB:
        raise AssertionError(f"vocabulary {w2v.vocab_size()} != {W2V_VOCAB}")
    initial = w2v.lookup_table.get_weights()
    counted = {"flushes": 0, "pairs": 0, "pair_s": 0.0}
    pairs_fn, step_fn = sequencevectors.skipgram_pairs, kernels.skipgram_step

    def pairs(*a):
        t = time.perf_counter()
        ctx, ctr = pairs_fn(*a)
        counted["pair_s"] += time.perf_counter() - t
        counted["pairs"] += ctx.size
        return ctx, ctr

    def step(*a, **k):
        counted["flushes"] += 1
        return step_fn(*a, **k)

    sequencevectors.skipgram_pairs, kernels.skipgram_step = pairs, step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        w2v.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        sequencevectors.skipgram_pairs, kernels.skipgram_step = (
            pairs_fn, step_fn)
    peak = torch.cuda.max_memory_allocated() - held
    trained = w2v.lookup_table.get_weights()
    if not np.isfinite(trained).all():
        raise AssertionError("train_word2vec: non-finite vectors")
    # the most frequent topic words
    queries = [w.label for w in w2v.vocab.vocab_words()
               if topic_of[int(w.label[1:])] >= 0][:W2V_QUERIES]
    fresh = SequenceVectors(w2v.conf, vocab=w2v.vocab, device="cuda")
    fresh.lookup_table = InMemoryLookupTable.from_arrays(
        w2v.vocab, initial, device="cuda")
    share = _topical_share(w2v, topic_of, queries)
    share0 = _topical_share(fresh, topic_of, queries)
    if not (share >= W2V_TOPICAL_MIN > share0):
        raise AssertionError(
            f"train_word2vec: topical share {share:.3f} trained, {share0:.3f}"
            f" initial; the check needs >= {W2V_TOPICAL_MIN} and below it")
    # a traced window: the first sentences again, on the trained vocab
    part = builder(sents[:W2V_TRACE_SENTENCES]).vocab_cache(w2v.vocab).build()
    part.build_vocab()
    before = counted["flushes"]
    kernels.skipgram_step = step
    try:
        trace = _device_trace(torch, part.fit)
    finally:
        kernels.skipgram_step = step_fn
    window_flushes = counted["flushes"] - before
    out = {"V": w2v.vocab_size(), "D": W2V_LAYER, "B": W2V_BATCH,
           "tokens": W2V_TOKENS, "sentences": len(sents),
           "corpus_s": corpus_s, "vocab_s": vocab_s, "fit_s": fit_s,
           "words_per_s": W2V_TOKENS / fit_s,
           "pairs": counted["pairs"], "pairs_per_s": counted["pairs"] / fit_s,
           "flushes": counted["flushes"] - window_flushes,
           "pair_generation_host_ms": counted["pair_s"] * 1e3,
           "peak_bytes_above_start": peak, "topical_share": share,
           "topical_share_initial": share0, "topical_min": W2V_TOPICAL_MIN,
           "trace": {**trace, "flushes": window_flushes,
                     "activities_per_flush":
                         trace["device_activities"] / max(window_flushes, 1),
                     "host_ms_per_flush":
                         trace["wall_ms"] / max(window_flushes, 1)}}
    emit("train_word2vec", **out)
    return out, w2v, sents, topic_of


def _two_topic_corpus(seed: int = 42, n: int = 300):
    """Two tight topical clusters of 8-word sentences (the JAX suite's
    word2vec corpus)."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "puppy", "kitten"]
    fruits = ["apple", "banana", "mango", "pear"]
    sents = []
    for _ in range(n):
        group = animals if rng.random() < 0.5 else fruits
        sents.append(" ".join(group[rng.integers(len(group))]
                              for _ in range(8)))
    return sents


def _fit_rel(torch, card, cpu, init) -> float:
    """||card - cpu|| / ||cpu - init|| (2-norms) of two fits' tables."""
    return _rel_norm(torch, torch.from_numpy(card - init),
                     torch.from_numpy(cpu - init))


@_tf32_off
def phase_embeddings_card_vs_cpu(torch) -> dict:
    """Small ParagraphVectors (DBOW and DM, with ``infer_vector``), GloVe
    and DeepWalk fits on the card against the same fits on the CPU, and
    a model zip written on the card and read on the CPU."""
    from deeplearning4j_tpu_torch.embeddings import (
        Glove, ParagraphVectors, WordVectorSerializer)
    from deeplearning4j_tpu_torch.embeddings.lookup import TABLES
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    from deeplearning4j_tpu_torch.text import (
        CollectionSentenceIterator, LabelAwareListSentenceIterator)
    sents = _two_topic_corpus()
    labels = ["animal" if any(w in s for w in ("cat", "dog")) else "fruit"
              for s in sents]
    out, models = {}, {}

    def check(what, card, cpu, init):
        rel = _fit_rel(torch, card, cpu, init)
        if not rel <= W2V_FIT_RTOL or not np.isfinite(card).all():
            raise AssertionError(f"{what}: card vs CPU {rel:.3g} > "
                                 f"{W2V_FIT_RTOL}")
        out[what] = rel

    for algo in ("DBOW", "DM"):
        fits = {}
        for dev in ("cuda", "cpu"):
            pv = (ParagraphVectors.Builder()
                  .iterate(LabelAwareListSentenceIterator(sents, labels))
                  .layer_size(24).window_size(4).epochs(3)
                  .learning_rate(0.05).min_word_frequency(1)
                  .negative_sample(5).batch_size(512).seed(3)
                  .sequence_learning_algorithm(algo).device(dev).build())
            pv.build_vocab()
            init = pv.lookup_table.get_weights()
            pv.fit()
            fits[dev] = pv
        for name in TABLES:
            a = fits["cpu"].lookup_table.array(name)
            check(f"pv_{algo.lower()}_{name}",
                  fits["cuda"].lookup_table.array(name), a,
                  init if name == "syn0" else np.zeros_like(a))
        inferred = {dev: fits[dev].infer_vector(
            "cat dog puppy kitten cat dog", steps=20, learning_rate=0.05)
            for dev in fits}
        check(f"pv_{algo.lower()}_infer_vector", inferred["cuda"],
              inferred["cpu"], np.zeros_like(inferred["cpu"]))
        models[algo] = fits["cuda"]

    glove = {}
    for dev in ("cuda", "cpu"):
        g = (Glove.Builder().iterate(CollectionSentenceIterator(sents))
             .layer_size(16).window_size(4).epochs(20).learning_rate(0.05)
             .min_word_frequency(1).seed(11).device(dev).build())
        glove[dev] = (g.fit(), g.lookup_table.get_weights())
    loss_rel = abs(glove["cuda"][0] - glove["cpu"][0]) / abs(glove["cpu"][0])
    if not loss_rel <= W2V_GLOVE_LOSS_RTOL:
        raise AssertionError(f"glove loss: card vs CPU {loss_rel:.3g}")
    out["glove_loss"] = loss_rel
    check("glove_syn0", glove["cuda"][1], glove["cpu"][1],
          np.zeros_like(glove["cpu"][1]))

    g = Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(0, 6)
    walks = {}
    for dev in ("cuda", "cpu"):
        dw = (DeepWalk.Builder().vector_size(16).window_size(3)
              .learning_rate(0.05).epochs(3).seed(5).device(dev).build())
        dw._walks_per_vertex = 10
        dw.fit_graph(g, walk_length=20, seed=6)
        walks[dev] = dw
    init = (np.random.default_rng(5).random((12, 16), dtype=np.float32)
            - 0.5) / 16
    for name in TABLES:
        a = walks["cpu"].lookup_table.array(name)
        check(f"deepwalk_{name}", walks["cuda"].lookup_table.array(name), a,
              init if name == "syn0" else np.zeros_like(a))

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "pv.zip")
        WordVectorSerializer.write_word2vec_model(models["DM"], path)
        back = WordVectorSerializer.read_word2vec_model(
            path, cls=ParagraphVectors, device="cpu")
    src = models["DM"]
    if back.vocab.words() != src.vocab.words() or any(
            a.codes != b.codes or a.points != b.points
            for a, b in zip(back.vocab.vocab_words(),
                            src.vocab.vocab_words())):
        raise AssertionError("zip: vocabulary differs after the round trip")
    for name in TABLES:
        if not np.array_equal(back.lookup_table.array(name),
                              src.lookup_table.array(name)):
            raise AssertionError(f"zip: {name} differs after the round trip")
    out["zip_round_trip"] = "equal"
    out["rule"] = W2V_FIT_RTOL
    emit("embeddings_card_vs_cpu", **out)
    return out


# ---------------------------------------------------------------------------
# The text CNN, k-means, t-SNE and the nearest-neighbour server
# ---------------------------------------------------------------------------

# Kim (2014, "Convolutional Neural Networks for Sentence Classification",
# §3.1) and dl4j-examples' CnnSentenceClassificationExample: filter heights
# 3, 4 and 5 of 100 maps each over a sentence's word vectors (ReLU), max
# over time, the three merged, dropout 0.5 (retain 0.5) on the output
# layer's input, softmax over 2 classes, Adam at lr 0.01, batch 32,
# sentences of L = 256 tokens.  The kernel checks take D = 300
# (GoogleNews' vectors) on seeded inputs, and D = 128; the trained path
# reads the Word2Vec of train_word2vec (D = 128): neither 300-d vectors nor
# IMDB reviews are in the repo.
TEXTCNN_HEIGHTS, TEXTCNN_MAPS, TEXTCNN_CLASSES = (3, 4, 5), 100, 2
TEXTCNN_BATCH, TEXTCNN_LEN, TEXTCNN_D = 32, 256, 300
TEXTCNN_LR, TEXTCNN_RETAIN = 0.01, 0.5
# A document: 12 sentences of one topic of the text8-scale corpus (240
# tokens, within L); class "low" if its topic is below half the topics.
# 80 % of the documents, cut to whole batches, train for TEXTCNN_EPOCHS
# epochs through the async pipeline; the rest are held out.
TEXTCNN_DOC_SENTENCES, TEXTCNN_TRAIN_SHARE, TEXTCNN_EPOCHS = 12, 0.8, 3
# The held-out accuracy the trained net must reach: the trained table
# puts each topic's words together (train_word2vec's topical share), so
# the topic of 240 words is plain.
TEXTCNN_MIN_ACCURACY = 0.9
# The step of the fit held to the plain graph step: early, while the loss
# is far above the rounding of its logits.  A CPU rehearsal (4 topics) read
# a loss of 8.6e-5 at step 10 and ~1e-8 at the end, where two orders of
# rounding differ by 5e-4 and a third of it.  Not the first step either:
# Adam's first update is lr * sign(g), and an element whose gradient lies
# within rounding of 0 would flip a whole lr.
TEXTCNN_CHECK_STEP = 3
# After the checks, where a step's time goes: the iterator's batches alone
# (the feeder thread's work), then TEXTCNN_TRACE_STEPS fit steps under the
# profiler (busy and idle share of the card).
TEXTCNN_TRACE_STEPS = 20
# k-means on the trained table: one cluster per planted topic; the share
# of topic words whose cluster's majority topic is their own is reported,
# not held to a rule: a CPU rehearsal's table (4 topics, 200,000 tokens)
# points every word one way (mean cosine 0.97 within a topic, 0.97
# across), so euclidean k-means splits it by other directions and read
# chance, 0.25, raw, centred or normalised, while each word's nearest words
# kept their topic.  Held instead, card vs CPU: Lloyd's loop from the
# card's k-means++ centres over the KMEANS_CHECK_ROWS most frequent words:
# the same iterations; the same assignments but for near ties, a word
# whose two nearest centres (the CPU's) lie within KMEANS_TIE of its
# squared distance (an H100 run read one such word of 10,000); the
# centres within KMEANS_RTOL in relative 2-norm (one GEMM and a one-hot
# product summed in other orders; a tied word moves two centres by its
# share of a cluster).
KMEANS_MAX_ITER, KMEANS_CHECK_ROWS = 100, 10_000
KMEANS_TIE, KMEANS_RTOL = 1e-4, 1e-5
# Exact t-SNE of the TSNE_WORDS most frequent words at the reference's
# defaults (perplexity 30, 1,000 iterations, lr 500).  The map must keep
# the table's neighbourhoods: the share of each topic word's 10 nearest
# points in the map that share its topic must reach TSNE_KEEP of the same
# share among its 10 nearest words by cosine in the table (t-SNE keeps
# local neighbourhoods; it cannot make the table's own better).  The
# share itself depends on how well the words are trained: 0.78 in the map
# against 0.69 in the table for 2,000 words of a 4-topic CPU rehearsal,
# 0.35 against 0.40 for 10,000 words of the 20-topic table on an H100.
# Card vs CPU on the TSNE_CHECK_WORDS most frequent words: P by
# tests/test_torch_clustering.py's rule (1e-5 + 1e-4 |P|);
# the loop from one y0 in relative 2-norm, TSNE_LOOP_RTOL, for 3
# iterations at the defaults and for 50 at settings under which the loop
# contracts (lr 20, exaggeration 2, both switches at 25): at the defaults
# the early, exaggerated iterations double any rounding gap every
# iteration (that file's docstring), on either device.
TSNE_WORDS, TSNE_CHECK_WORDS, TSNE_NEAREST, TSNE_KEEP = (
    10_000, 2_000, 10, 0.7)
TSNE_LOOP_RTOL = 1e-4
TSNE_STABLE = dict(n_iter=50, lr=20.0, switch_momentum_iter=25,
                   stop_lying_iter=25, exaggeration=2.0)
# The nearest-neighbour server (cosine, as words_nearest) over the NN_ROWS
# most frequent words of the trained table: NN_QUERIES /knn and as many
# /knnnew requests of NN_K neighbours from NN_CLIENTS threads; each answer
# against brute force, one GEMM on the card: the same distances within
# NN_TOL, in order, and every returned word within NN_TOL of the k-th
# distance (ties).  The VPTree is the JAX package's host recursion, ~40 us
# a node in a CPU rehearsal, and it cannot prune on this table (every word
# points one way, cluster_tsne's note): a query visits every node, ~3 s
# over all 71,290 words.  So the whole table's tree is built and timed,
# and NN_ROWS are served.
NN_ROWS, NN_QUERIES, NN_K, NN_CLIENTS, NN_TOL = 2_000, 100, 10, 4, 1e-5


def textcnn_conf(gc, layers, global_cls, input_type, width=TEXTCNN_D,
                 length=TEXTCNN_LEN, maps=TEXTCNN_MAPS,
                 heights=TEXTCNN_HEIGHTS, classes=TEXTCNN_CLASSES,
                 seed=SEED, **global_kw):
    """The text CNN as a ComputationGraph configuration, with either
    package's modules (``gc`` graph_conf, ``layers``, GlobalConf,
    InputType): per filter height h a ConvolutionLayer of (h, width),
    stride 1, truncate, ReLU, then GlobalPoolingLayer(max); a MergeVertex
    of the pooled maps; an OutputLayer (softmax, mcxent) that drops its
    input.  The example's ConvolutionMode.Same with stride (1, width)
    would send JAX's conv to its dense path; stride 1 with truncate gives
    the same max over time."""
    g = global_cls(seed=seed, learning_rate=TEXTCNN_LR, updater="adam",
                   weight_init="relu", **global_kw)
    b = gc.GraphBuilder(g).add_inputs("words")
    for h in heights:
        b = b.add_layer(f"cnn{h}", layers.ConvolutionLayer(
            n_out=maps, kernel=(h, width), stride=(1, 1),
            activation="relu"), "words")
        b = b.add_layer(f"pool{h}", layers.GlobalPoolingLayer(
            pooling_type="max"), f"cnn{h}")
    b = b.add_vertex("merge", gc.MergeVertex(),
                     *[f"pool{h}" for h in heights])
    b = b.add_layer("out", layers.OutputLayer(
        n_out=classes, activation="softmax", loss="mcxent",
        dropout=TEXTCNN_RETAIN), "merge")
    return b.set_outputs("out").set_input_types(
        input_type.convolutional(length, width, 1)).build()


def textcnn_convs(width: int):
    """The text CNN's convs as check_conv shapes: (N, Cin, H, W, Cout,
    (KH, KW), pad, activation)."""
    return [(TEXTCNN_BATCH, 1, TEXTCNN_LEN, width, TEXTCNN_MAPS, (h, width),
             0, "relu") for h in TEXTCNN_HEIGHTS]


@_tf32_off
def phase_textcnn_kernels(torch, ck) -> dict:
    """The conv kernel's full-width route at the text CNN's shapes, D =
    300 and 128, against its plain version, timed as in phase 3 and by
    CUDA-graph replay."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records, sets = [], {}
    for width in (TEXTCNN_D, W2V_LAYER):
        rows = []
        for shape in textcnn_convs(width):
            N, Cin, H, W, Cout, (KH, KW), _, _ = shape
            plan = ck.conv_plan(N, Cin, KH, KW, Cout, H - KH + 1, 1, sms)
            if plan is None or plan["fw"] != 1:
                raise AssertionError(f"{shape}: plan {plan}, not the "
                                     f"full-width route")
            rec = check_conv(torch, ck, shape, gen, replay=True)
            rec.update(model=f"textcnn_{width}", plan=plan)
            rows.append(rec)
        agg = {k: sum(r[k] for r in rows) for k in SET_SUMS + GRAPH_SUMS}
        agg["graph_share_of_bound"] = agg["bound_ms"] / agg["graph_ms"]
        agg.update(convs=len(rows), tflops=agg["flops"] / agg["ms"] / 1e9,
                   share_of_bound=agg["bound_ms"] / agg["ms"])
        sets[f"textcnn_{width}"] = agg
        records += rows
    res = {"records": records, "sets": sets,
           "sass_hgmma": hgmma_count(ck, ck.CONV_LIBRARY,
                                     r"conv_wgmma_kernelILi\d+ELb1E")}
    emit("textcnn_kernels", tf32=False, rtol=RTOL, atol_scaled=ATOL,
         timed_sets=sets, full_width_sass_hgmma=res["sass_hgmma"],
         bound_note="as in the kernels line", shapes=records)
    return res


def textcnn_documents(sents, topic_of):
    """Documents of TEXTCNN_DOC_SENTENCES sentences of one topic (a
    sentence's topic: the most common among its topic words), shuffled
    -> (documents, labels)."""
    ids = np.array([[int(w[1:]) for w in s.split()] for s in sents])
    topics = topic_of[ids]
    counts = np.stack([(topics == t).sum(1) for t in range(W2V_TOPICS)], 1)
    sent_topic = counts.argmax(1)
    docs, labels = [], []
    for t in range(W2V_TOPICS):
        rows = np.flatnonzero(sent_topic == t)
        for i in range(0, rows.size - TEXTCNN_DOC_SENTENCES + 1,
                       TEXTCNN_DOC_SENTENCES):
            docs.append(" ".join(sents[r] for r in
                                 rows[i:i + TEXTCNN_DOC_SENTENCES]))
            labels.append("low" if t < W2V_TOPICS // 2 else "high")
    order = np.random.default_rng(SEED + 31).permutation(len(docs))
    return [docs[i] for i in order], [labels[i] for i in order]


@_tf32_off
def phase_train_textcnn(torch, ck, w2v, sents, topic_of) -> dict:
    """The text CNN over the trained Word2Vec: ``fit`` through the async
    pipeline on ``CnnSentenceDataSetIterator`` batches, one of its steps
    (TEXTCNN_CHECK_STEP) against the plain graph step, then ``evaluate``
    on held-out documents."""
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.text.cnn_iterator import (
        CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider)
    docs, labels = textcnn_documents(sents, topic_of)
    n_train = int(len(docs) * TEXTCNN_TRAIN_SHARE) // TEXTCNN_BATCH * \
        TEXTCNN_BATCH

    def batches(lo, hi):
        return CnnSentenceDataSetIterator(
            CollectionLabeledSentenceProvider(docs[lo:hi], labels[lo:hi]),
            w2v, batch_size=TEXTCNN_BATCH, max_sentence_length=TEXTCNN_LEN)
    train, held = batches(0, n_train), batches(n_train, len(docs))
    width = w2v.lookup_table.vector_length
    net = ComputationGraph(textcnn_conf(gc, L, GlobalConf, InputType,
                                        width=width), device="cuda").init()
    steps, checked = [], {}
    fit_batch = net._fit_batch
    pins = _pinned_vertices(net)

    def timed_batch(mds, seeds=None):     # each step, timed and counted
        check = len(steps) + 1 == TEXTCNN_CHECK_STEP
        recording = contextlib.nullcontext()
        if check:       # keep its state, seed words and pool inputs
            seeds = net._draw_seeds().tolist()
            checked["before"] = (
                _clone_tree(net.net_params), _clone_tree(net.opt_states),
                _clone_tree(net.net_state), net.iteration, seeds, mds)
            recording = checked["recorded"] = _RecordedVertexOutputs(
                net, set(pins.values()))
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        with recording:
            fit_batch(mds, seeds)
        torch.cuda.synchronize()
        after = _kernel_counts(ck)
        steps.append({"seconds": time.perf_counter() - t0,
                      "score": net.score(),
                      "staged_on": str(mds.features[0].device),
                      "launches": {n: after[n] - counts[n] for n in after}})
        if check:
            checked["after"] = (net.score(), _clone_tree(net.net_params))
    net._fit_batch = timed_batch
    fallbacks = _conv_fallbacks()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(ck)                                   # main path starts
    t0 = time.perf_counter()
    net.fit(train, epochs=TEXTCNN_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    peak = torch.cuda.max_memory_allocated()
    del net._fit_batch
    want = _want(ck, conv2d_bias_act=len(TEXTCNN_HEIGHTS),
                 threshold_dropout=2)
    bad = [st for st in steps if st["launches"] != want
           or st["staged_on"] != "cuda:0"]
    if len(steps) != TEXTCNN_EPOCHS * n_train // TEXTCNN_BATCH or bad:
        raise AssertionError(f"text CNN: {len(steps)} steps; each must "
                             f"launch {want} on the card: {bad[:2]}")
    before = _kernel_counts(ck)
    t0 = time.perf_counter()
    ev = net.evaluate(held)
    eval_s = time.perf_counter() - t0
    after = _kernel_counts(ck)
    eval_launches = {n: after[n] - before[n] for n in after}
    held_batches = -(-(len(docs) - n_train) // TEXTCNN_BATCH)
    accuracy = float(ev.accuracy())
    # the checked step against the plain graph step from its state
    params0, opt0, states0, it, seeds, mds = checked["before"]
    kernel_score, kernel_params = checked["after"]
    plain_score, plain_params, _, ties = _plain_graph_step(
        torch, ck, net, params0, opt0, list(mds.features),
        list(mds.labels), it, states0, checked["recorded"].outputs,
        seeds=seeds)
    errs = {f"{n}_{k}": _rel_norm(torch, t - params0[n][k],
                                  plain_params[n][k] - params0[n][k])
            for n in net.order for k, t in kernel_params[n].items()}
    fallbacks = _conv_fallbacks() - fallbacks
    window = TEXTCNN_TRACE_STEPS * TEXTCNN_BATCH
    etl, t0 = batches(0, window), time.perf_counter()
    while etl.has_next():
        etl.next()
    torch.cuda.synchronize()
    etl_ms = (time.perf_counter() - t0) * 1e3 / TEXTCNN_TRACE_STEPS
    trace = _device_trace(torch, lambda: net.fit(batches(0, window)))
    timed = steps[1:]
    res = {"documents": len(docs), "train_documents": n_train,
           "held_out_documents": len(docs) - n_train,
           "tokens_per_document": TEXTCNN_DOC_SENTENCES * W2V_SENT,
           "D": width, "L": TEXTCNN_LEN, "batch": TEXTCNN_BATCH,
           "steps": len(steps), "fit_s": fit_s,
           "samples_per_s": len(steps) * TEXTCNN_BATCH / fit_s,
           "step_ms_median": float(np.median(
               [st["seconds"] for st in timed])) * 1e3,
           "scores": [st["score"] for st in steps[:10]] + [
               steps[-1]["score"]],
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_step": want, "conv_fallbacks": fallbacks,
           "split": {"iterator_ms_per_batch": etl_ms,
                     "traced_steps": TEXTCNN_TRACE_STEPS,
                     "wall_ms_per_step": trace["wall_ms"]
                     / TEXTCNN_TRACE_STEPS,
                     "busy_ms_per_step": trace["busy_ms"]
                     / TEXTCNN_TRACE_STEPS,
                     "idle_share": trace["idle_share"],
                     "device_activities_per_step":
                         trace["device_activities"] / TEXTCNN_TRACE_STEPS},
           "evaluate": {"seconds": eval_s, "launches": eval_launches,
                        "accuracy": accuracy,
                        "min_accuracy": TEXTCNN_MIN_ACCURACY},
           "plain_step": {"step": TEXTCNN_CHECK_STEP, "score": plain_score,
                          "kernel_score": kernel_score,
                          "score_rel_diff": abs(plain_score - kernel_score)
                          / abs(plain_score),
                          "max_update_rel_err": max(errs.values()),
                          "updates": errs, "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL,
                          "near_ties": ties, "tie_rtol": TIE_RTOL}}
    emit("train_textcnn", **res)
    ps = res["plain_step"]
    if eval_launches != _want(ck, conv2d_bias_act=len(TEXTCNN_HEIGHTS)
                              * held_batches) or fallbacks:
        raise AssertionError(f"text CNN evaluate: launches {eval_launches},"
                             f" {fallbacks} conv fallbacks")
    if accuracy < TEXTCNN_MIN_ACCURACY:
        raise AssertionError(f"text CNN held-out accuracy {accuracy} < "
                             f"{TEXTCNN_MIN_ACCURACY}")
    if ps["score_rel_diff"] > STEP_RTOL or \
            ps["max_update_rel_err"] > STEP_UPDATE_RTOL or \
            len(ties) != len(TEXTCNN_HEIGHTS) or \
            max(t["max_rel_gap"] for t in ties) > TIE_RTOL:
        raise AssertionError("text CNN step through the kernels disagrees "
                             "with the plain step")
    return res


def _topic_rows(w2v, topic_of):
    """The planted topic of each row of the table (-1: background)."""
    return np.array([topic_of[int(w[1:])] for w in w2v.vocab.words()])


@_tf32_off
def phase_cluster_tsne(torch, w2v, topic_of) -> dict:
    """KMeansClustering on the trained table and exact t-SNE of the most
    frequent words on the card, each checked against the CPU."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, kmeans
    from deeplearning4j_tpu_torch.plot import Tsne, tsne
    table = w2v.lookup_table.syn0
    topics = _topic_rows(w2v, topic_of)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = KMeansClustering(W2V_TOPICS, max_iter=KMEANS_MAX_ITER, seed=SEED)
    km.apply_to(table)
    out["kmeans_s"] = time.perf_counter() - t0
    assign, on_topic = km.assignments_, topics >= 0
    majority_hits = sum(
        np.bincount(topics[on_topic & (assign == k)],
                    minlength=W2V_TOPICS).max()
        for k in range(W2V_TOPICS) if (on_topic & (assign == k)).any())
    out.update(kmeans_rows=int(table.shape[0]), k=W2V_TOPICS,
               kmeans_iterations=km.iterations_,
               kmeans_cluster_sizes=np.bincount(
                   assign, minlength=W2V_TOPICS).tolist(),
               kmeans_topic_share=majority_hits / int(on_topic.sum()))
    sub = table[:KMEANS_CHECK_ROWS]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    with kmeans.full_f32_matmul():
        c0 = kmeans.kmeans_pp(sub, W2V_TOPICS, gen)
    card = kmeans.lloyd(sub, c0, KMEANS_MAX_ITER, km.tol)
    cpu = kmeans.lloyd(sub.cpu(), c0.cpu(), KMEANS_MAX_ITER, km.tol)
    c_card, c_cpu = card[0].cpu(), cpu[0]
    differ = (card[1].cpu() != cpu[1]).nonzero()[:, 0]
    d2 = kmeans.dist2(sub.cpu()[differ], c_cpu)
    near = d2.topk(2, dim=1, largest=False).values
    gaps = ((near[:, 1] - near[:, 0]) / near[:, 1].clamp_min(1e-30))
    out["kmeans_card_vs_cpu"] = {
        "rows": KMEANS_CHECK_ROWS, "iterations": [card[2], cpu[2]],
        "assignments_differ": int(differ.numel()),
        "max_tie_gap": float(gaps.max()) if differ.numel() else 0.0,
        "centres_rel_err": _rel_norm(torch, c_card, c_cpu),
        "tie": KMEANS_TIE, "rtol": KMEANS_RTOL}
    chk = out["kmeans_card_vs_cpu"]
    if card[2] != cpu[2] or chk["max_tie_gap"] > KMEANS_TIE or \
            chk["centres_rel_err"] > KMEANS_RTOL:
        raise AssertionError(f"k-means card vs CPU: {chk}")

    x = table[:TSNE_WORDS]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y = Tsne(perplexity=30.0, n_iter=1000, learning_rate=500.0,
             seed=SEED).fit_transform(x.cpu().numpy())
    out["tsne_s"] = time.perf_counter() - t0
    out["tsne_peak_bytes_above_start"] = \
        torch.cuda.max_memory_allocated() - held
    t_sub = topics[:TSNE_WORDS]
    mine = t_sub >= 0

    def topic_share(dist):
        near = dist.fill_diagonal_(float("inf")).topk(
            TSNE_NEAREST, largest=False).indices.cpu().numpy()
        return float((t_sub[near[mine]] == t_sub[mine][:, None]).mean())
    xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    with torch.no_grad():
        share = topic_share(tsne._sq_dists(torch.from_numpy(y).cuda()))
        table_share = topic_share(1.0 - xn @ xn.T)
    counts = np.bincount(t_sub[mine])
    out.update(tsne_words=TSNE_WORDS, tsne_topic_words=int(mine.sum()),
               tsne_map_topic_share=share, tsne_table_topic_share=table_share,
               tsne_chance_share=float((counts ** 2).sum()
                                       / counts.sum() ** 2),
               tsne_keep=TSNE_KEEP)
    if y.shape != (TSNE_WORDS, 2) or not np.isfinite(y).all() or \
            share < TSNE_KEEP * table_share:
        emit("cluster_tsne", **out)
        raise AssertionError(f"t-SNE map: shape {y.shape}, topic share "
                             f"{share} against the table's {table_share}")

    xs = x[:TSNE_CHECK_WORDS]
    p_card = tsne._x2p_dense(xs, 30.0)
    p_cpu = tsne._x2p_dense(xs.cpu(), 30.0)
    p_err = (p_card.cpu() - p_cpu).abs()
    p_excess = float((p_err / (1e-5 + 1e-4 * p_cpu.abs())).max())
    n = TSNE_CHECK_WORDS
    ps = torch.clamp_min((p_cpu + p_cpu.T) / (2.0 * n), 1e-12)
    y0 = torch.from_numpy((1e-4 * np.random.default_rng(SEED + 33).normal(
        size=(n, 2))).astype(np.float32))
    loops = {}
    for name, kw in (("defaults_3", dict(
            n_iter=3, lr=500.0, switch_momentum_iter=100,
            stop_lying_iter=250, exaggeration=12.0)),
            ("contracting_50", TSNE_STABLE)):
        a = tsne._tsne_exact(ps.cuda(), y0.cuda(), **kw).cpu()
        b = tsne._tsne_exact(ps, y0, **kw)
        loops[name] = _rel_norm(torch, a, b)
    out["tsne_card_vs_cpu"] = {"words": n, "p_max_abs_err":
                               float(p_err.max()), "p_excess": p_excess,
                               "loop_rel_err": loops,
                               "loop_rtol": TSNE_LOOP_RTOL}
    emit("cluster_tsne", **out)
    if p_excess > 1.0 or max(loops.values()) > TSNE_LOOP_RTOL:
        raise AssertionError(f"t-SNE card vs CPU: {out['tsne_card_vs_cpu']}")
    return out


def phase_nearest_neighbors(torch, w2v) -> dict:
    """The trained table's VPTree (cosine), built and timed; a
    NearestNeighborsServer over its NN_ROWS most frequent words, queried
    over HTTP by word index (/knn) and by base64 vector (/knnnew); each
    answer against brute force from one GEMM on the card."""
    from deeplearning4j_tpu_torch.clustering import VPTree
    from deeplearning4j_tpu_torch.server import NearestNeighborsServer
    from deeplearning4j_tpu_torch.server.nearestneighbors import (
        ndarray_to_base64)
    full = w2v.lookup_table.get_weights()
    t0 = time.perf_counter()
    VPTree(full, distance="cosine")
    full_build_s = time.perf_counter() - t0
    table = full[:NN_ROWS]
    t0 = time.perf_counter()
    srv = NearestNeighborsServer(table, distance="cosine")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 34)
    words = rng.choice(table.shape[0], size=2 * NN_QUERIES, replace=False)
    bodies = [("/knn", {"ndarrayIndex": int(i), "k": NN_K})
              for i in words[:NN_QUERIES]]
    fresh = table[words[NN_QUERIES:]] + 0.01 * rng.normal(
        size=(NN_QUERIES, table.shape[1])).astype(np.float32)
    bodies += [("/knnnew", {**ndarray_to_base64(q), "k": NN_K})
               for q in fresh]
    answers, latency = [None] * len(bodies), [0.0] * len(bodies)
    base = f"http://{srv.host}:{srv.port}"

    def client(c):
        for j in range(c, len(bodies), NN_CLIENTS):
            route, body = bodies[j]
            req = urllib.request.Request(
                base + route, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                answers[j] = json.loads(r.read())["results"]
            latency[j] = time.perf_counter() - t
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(NN_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        serve_s = time.perf_counter() - t0
    finally:
        srv.stop()
    if any(a is None for a in answers):
        raise AssertionError("nearest_neighbors: a request got no answer")
    t = torch.from_numpy(table).cuda()
    tn = t / t.norm(dim=1, keepdim=True).clamp_min(1e-12)
    q = torch.cat([tn[torch.from_numpy(words[:NN_QUERIES]).cuda()],
                   torch.from_numpy(fresh).cuda()])
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    with torch.no_grad():
        dist = 1.0 - q @ tn.T                                # one GEMM
    dist[torch.arange(NN_QUERIES), torch.from_numpy(
        words[:NN_QUERIES]).cuda()] = float("inf")           # /knn skips i
    best = dist.topk(NN_K, largest=False)
    kth = best.values[:, -1].cpu().numpy()
    ref = best.values.cpu().numpy()
    dist = dist.cpu().numpy()
    worst = 0.0
    for j, res in enumerate(answers):
        idx = [r["index"] for r in res]
        got = np.array([r["distance"] for r in res])
        if len(res) != NN_K or np.any(np.diff(got) < 0):
            raise AssertionError(f"nearest_neighbors: answer {j}: {res}")
        worst = max(worst, float(np.abs(got - ref[j]).max()),
                    float((dist[j, idx] - kth[j]).max()))
    out = {"table_rows": int(full.shape[0]),
           "vptree_build_s_table": full_build_s,
           "rows": int(table.shape[0]), "D": int(table.shape[1]),
           "distance": "cosine", "vptree_build_s": build_s,
           "requests": len(bodies), "clients": NN_CLIENTS, "k": NN_K,
           "serve_s": serve_s, "requests_per_s": len(bodies) / serve_s,
           "latency_ms_p50": float(np.median(latency)) * 1e3,
           "latency_ms_max": float(np.max(latency)) * 1e3,
           "max_gap_to_brute_force": worst, "tol": NN_TOL}
    emit("nearest_neighbors", **out)
    if worst > NN_TOL:
        raise AssertionError(f"nearest_neighbors: answers {worst} from "
                             f"brute force")
    return out


# ---------------------------------------------------------------------------
# fit(fused_steps=K), layerwise pretraining, the centre-loss head and
# external gradients
# ---------------------------------------------------------------------------

def _sync_warnings(torch, fn):
    """``fn()`` under torch's CUDA sync debug mode "warn" -> (its result,
    the messages of the synchronising calls it made)."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def _watch_groups(torch, net) -> dict:
    """Count ``net``'s fused_steps groups and the synchronising calls made
    inside them."""
    seen = {"groups": 0, "syncs": []}
    inner = net._fit_group

    def group(batches):
        seen["groups"] += 1
        seen["syncs"] += _sync_warnings(torch, lambda: inner(batches))[1]
    net._fit_group = group
    return seen


def _mnist_like(rng, n, batch):
    from deeplearning4j_tpu_torch.datasets import DataSet
    return [DataSet(rng.random((batch, 1, 28, 28), np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
            for _ in range(n)]


def lenet_graph(device):
    """LeNet (``models.lenet``'s layers and Adam) as a ComputationGraph."""
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = (gc.GraphBuilder(GlobalConf(seed=12345, learning_rate=0.01,
                                       updater="adam"))
            .add_inputs("in")
            .add_layer("c1", L.ConvolutionLayer(n_out=20, kernel=(5, 5),
                                                activation="identity"), "in")
            .add_layer("p1", L.SubsamplingLayer(pooling_type="max"), "c1")
            .add_layer("c2", L.ConvolutionLayer(n_out=50, kernel=(5, 5),
                                                activation="identity"), "p1")
            .add_layer("p2", L.SubsamplingLayer(pooling_type="max"), "c2")
            .add_layer("d", L.DenseLayer(n_out=500, activation="relu"), "p2")
            .add_layer("out", L.OutputLayer(n_out=10, activation="softmax",
                                            loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.convolutional(28, 28, 1))
            .build())
    return ComputationGraph(conf, device=device)


def _fused_vs_plain(torch, ck, make, data, epochs, k) -> dict:
    """``make()``'s network fit over ``data`` for ``epochs`` plain and with
    ``fused_steps=k`` from the same params and generator under cuDNN's
    deterministic algorithms (equality, launches, groups, syncs), then
    timed in turns, default algorithms."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    steps = len(data) * epochs
    rows = sum(d.num_examples() for d in data) * epochs

    def run(net, fuse):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator(data), epochs=epochs, fused_steps=fuse)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        plain = make()
        run(plain, 1)
        fused = make()
        seen = _watch_groups(torch, fused)
        fallbacks = _conv_fallbacks()
        _zero_counts(ck)                               # main path starts
        run(fused, k)
        launches = _kernel_counts(ck)                  # main path ends
        fallbacks = _conv_fallbacks() - fallbacks
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    res = {"k": k, "steps": steps, "iteration": fused.iteration,
           "groups": seen["groups"], "group_syncs": seen["syncs"][:5],
           "n_group_syncs": len(seen["syncs"]), "launches": launches,
           "conv_fallbacks": fallbacks,
           "rule": "torch.equal, cuDNN deterministic",
           "params_equal": bool(torch.equal(fused.params(), plain.params())),
           "updater_equal": bool(torch.equal(fused.updater_state_flat(),
                                             plain.updater_state_flat())),
           "score_fused": fused.score(), "score_plain": plain.score()}
    del plain, fused
    rates = {"plain": [], "fused": []}
    for mode in ("plain", "fused", "fused", "plain"):
        net = make()
        rates[mode].append(rows / run(net, 1 if mode == "plain" else k))
    res["samples_per_s"] = rates
    return res


@_tf32_off
def phase_fused_lenet(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.models import lenet
    rng = np.random.default_rng(SEED + 20)
    data = _mnist_like(rng, FUSED_BATCHES, LENET_BATCH)
    mln = _fused_vs_plain(
        torch, ck, lambda: lenet(device="cuda").init(
            generator=torch.Generator().manual_seed(SEED)),
        data, FUSED_EPOCHS, FUSED_K)
    graph = _fused_vs_plain(
        torch, ck, lambda: lenet_graph("cuda").init(
            generator=torch.Generator().manual_seed(SEED)),
        data[:FUSED_GRAPH_BATCHES], FUSED_GRAPH_EPOCHS, FUSED_GRAPH_K)
    res = {"batch": LENET_BATCH, "multilayer": mln, "graph": graph,
           "launches": {k: mln["launches"][k] + graph["launches"][k]
                        for k in mln["launches"]}}
    emit("fused_lenet", **res)
    for what, r, batches, epochs, k in (
            ("MultiLayerNetwork", mln, FUSED_BATCHES, FUSED_EPOCHS, FUSED_K),
            ("ComputationGraph", graph, FUSED_GRAPH_BATCHES,
             FUSED_GRAPH_EPOCHS, FUSED_GRAPH_K)):
        if not (r["params_equal"] and r["updater_equal"]
                and r["score_fused"] == r["score_plain"]
                and r["iteration"] == r["steps"]
                and r["groups"] == epochs * (batches // k)
                and r["n_group_syncs"] == 0 and r["conv_fallbacks"] == 0
                and r["launches"] == _want(ck,
                                           conv2d_bias_act=2 * r["steps"])):
            raise AssertionError(f"fused_steps on the {what}: {r}")
    return res


def stroke_pixels(torch, device, seed: int, n: int, hw: int = 28,
                  strokes: int = 3, points: int = 24):
    """MNIST-like seeded images [n, hw * hw]: ``strokes`` soft pen strokes
    of random ends on a blank canvas, pixels in [0, 1], ~80 % of them 0
    (MNIST: ~80 %; ``load_mnist``'s stand-in is dense, every pixel near
    0.5, which no MNIST example was tuned for).  The ends come from a CPU
    generator, so every device draws the same strokes."""
    gen = torch.Generator().manual_seed(seed)
    ends = 4 + (hw - 8) * torch.rand((n, strokes, 2, 2), generator=gen)
    t = torch.linspace(0, 1, points)[:, None]
    pts = (ends[:, :, :1] * (1 - t) + ends[:, :, 1:] * t).reshape(
        n, -1, 2).to(device)
    yy, xx = torch.meshgrid(torch.arange(hw, dtype=torch.float32),
                            torch.arange(hw, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([yy.ravel(), xx.ravel()], 1).to(device)
    out = []
    for chunk in pts.split(1024):
        d2 = ((chunk[:, :, None, :] - grid) ** 2).sum(-1).amin(1)
        out.append(torch.exp(-d2 / 1.5))
    out = torch.cat(out)
    return torch.where(out < 0.05, 0.0, out)


def vae_example_net(device):
    """dl4j-examples 0.8 VariationalAutoEncoderExample's network."""
    from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import (
        VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(SEED)
            .learning_rate(VAE_LR).updater("rmsprop").weight_init("xavier")
            .regularization(True).l2(1e-4).list()
            .layer(VariationalAutoencoder(
                n_in=784, n_out=2, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), activation="leakyrelu",
                pzx_activation="identity",
                reconstruction_distribution={"type": "bernoulli",
                                             "activation": "sigmoid"}))
            .build())
    return MultiLayerNetwork(conf, device=device)


def _rule_errs(torch, got, want) -> float:
    """The worst element of |y - y_cpu| / (RTOL |y_cpu| + ATOL max|y_cpu|)
    over a dict of tensors (1 is the limit)."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].detach().cpu().double()
        w = w.detach().double()
        lim = RTOL * w.abs() + ATOL * w.abs().max()
        worst = max(worst, float(((g - w).abs() / lim.clamp_min(1e-30))
                                 .max()))
    return worst


def _scores(net) -> list:
    """A listener that keeps every step's score (a device tensor, read at
    the end)."""
    from deeplearning4j_tpu_torch.nn.listeners import IterationListener
    kept = []

    class Keep(IterationListener):
        def iteration_done(self, model, iteration):
            kept.append(model._score)
    net.add_listener(Keep())
    return kept


def _zip_round_trip(torch, net) -> dict:
    """``net`` written as a zip, restored on its device and written again:
    the entries, byte for byte, and the params."""
    import zipfile
    from deeplearning4j_tpu_torch.nn import serialization as ser
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a.zip", Path(tmp) / "b.zip"
        ser.write_model(net, a)
        back = ser.load_model(a, device=net.device)
        ser.write_model(back, b)
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            same = {n: za.read(n) == zb.read(n) for n in za.namelist()}
            same["names"] = za.namelist() == zb.namelist()
        return {"entries_equal": same, "bytes": a.stat().st_size,
                "params_equal": bool(torch.equal(back.params(),
                                                 net.params()))}


@_tf32_off
def phase_pretrain_vae(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    pixels = stroke_pixels(torch, "cuda", SEED + 23,
                           VAE_BATCH * VAE_BATCHES)
    batches = [DataSet(x, x) for x in pixels.split(VAE_BATCH)]
    n_batches = len(batches)
    epochs = -(-VAE_STEPS // n_batches)
    net = vae_example_net("cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    layer = net.layers[0]
    x0 = batches[0].features
    eps_gen = torch.Generator().manual_seed(SEED + 1)
    eps0 = torch.randn((1, VAE_BATCH, 2), generator=eps_gen)
    with torch.no_grad():
        before = float(layer.pretrain_loss(net.net_params[0], x0,
                                           {"eps": eps0.cuda()}))
    kept = _scores(net)
    _zero_counts(ck)                                   # main path starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(ListDataSetIterator(batches), epochs=epochs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _kernel_counts(ck)                      # main path ends
    scores = [float(s) for s in kept]
    with torch.no_grad():
        after = float(layer.pretrain_loss(net.net_params[0], x0,
                                          {"eps": eps0.cuda()}))
    # one step's gradients, card against CPU, the same params, x and eps
    cpu = {k: v.detach().cpu() for k, v in net.net_params[0].items()}
    x1 = batches[1].features.cpu()
    eps1 = torch.randn((1, VAE_BATCH, 2), generator=eps_gen)

    def grads(params, x, eps):
        lp = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
        loss = layer.pretrain_loss(lp, x, {"eps": eps})
        return dict(zip(lp, torch.autograd.grad(loss, list(lp.values()))))
    g_card = grads(net.net_params[0], x1.cuda(), eps1.cuda())
    g_cpu = grads(cpu, x1, eps1)
    eps4 = torch.randn((4, VAE_BATCH, 2), generator=eps_gen)
    z = torch.linspace(-2.0, 2.0, 8)
    grid = torch.stack(torch.meshgrid(z, z, indexing="ij"), -1).reshape(-1, 2)
    with torch.no_grad():
        lp_card = layer.reconstruction_log_probability(
            net.net_params[0], x1.cuda(), noise={"eps": eps4.cuda()})
        lp_cpu = layer.reconstruction_log_probability(
            cpu, x1, noise={"eps": eps4})
        gen_card = layer.generate_at_mean_given_z(net.net_params[0], grid)
        gen_cpu = layer.generate_at_mean_given_z(cpu, grid)
    res = {"batch": VAE_BATCH, "steps": len(scores), "seconds": dt,
           "ms_per_step": dt / max(1, len(scores)) * 1e3,
           "samples_per_s": len(scores) * VAE_BATCH / dt,
           "neg_elbo_first10": float(np.mean(scores[:10])),
           "neg_elbo_last10": float(np.mean(scores[-10:])),
           "fixed_batch_loss": {"before": before, "after": after},
           "grad_rule_worst": _rule_errs(torch, g_card, g_cpu),
           "log_prob_rule_worst": _rule_errs(torch, {"lp": lp_card},
                                             {"lp": lp_cpu}),
           "generate_rule_worst": _rule_errs(torch, {"g": gen_card},
                                             {"g": gen_cpu}),
           "log_prob_mean": float(lp_card.mean()),
           "generated": list(gen_card.shape),
           "zip": _zip_round_trip(torch, net), "launches": launches,
           "rule": "RTOL |y_cpu| + ATOL max|y_cpu| (worst <= 1)"}
    emit("pretrain_vae", **res)
    if not (len(scores) == epochs * n_batches >= VAE_STEPS
            and all(np.isfinite(scores))
            and res["neg_elbo_last10"] < res["neg_elbo_first10"]
            and after < before and res["grad_rule_worst"] <= 1.0
            and res["log_prob_rule_worst"] <= 1.0
            and res["generate_rule_worst"] <= 1.0
            and bool(torch.isfinite(lp_card).all())
            and res["generated"] == [64, 784]
            and all(res["zip"]["entries_equal"].values())
            and res["zip"]["params_equal"] and launches == _want(ck)):
        raise AssertionError(f"pretrain_vae: {res}")
    return res


def dbn_example_net(device):
    """dl4j-examples 0.8 DeepAutoEncoderExample's network."""
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import RBM
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    sizes = list(DBN_SIZES) + list(DBN_SIZES[-2:0:-1])
    b = (NeuralNetConfiguration.builder().seed(SEED).learning_rate(0.1)
         .updater("sgd").list())
    for n_in, n_out in zip(sizes, sizes[1:]):
        b.layer(RBM(n_in=n_in, n_out=n_out, hidden_unit="binary",
                    visible_unit="binary", k=1))
    b.layer(OutputLayer(n_in=sizes[-1], n_out=DBN_SIZES[0],
                        activation="sigmoid", loss="mse"))
    return MultiLayerNetwork(b.build(), device=device)


@_tf32_off
def phase_pretrain_dbn(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.solvers import Solver
    pixels = stroke_pixels(torch, "cuda", SEED + 24, DBN_BATCH * DBN_BATCHES)
    batches = [DataSet(x, x) for x in pixels.split(DBN_BATCH)]
    net = dbn_example_net("cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    rbm = net.layers[0]
    x0 = batches[0].features
    order = torch.argsort(torch.rand(
        x0.shape, generator=torch.Generator().manual_seed(SEED)), 1)
    shuffled = torch.gather(x0, 1, order.to(x0.device))

    def stats():
        """The first RBM's reconstruction error, and the data's mean free
        energy less that of the same pixels shuffled within each image."""
        with torch.no_grad():
            p = net.net_params[0]
            return (rbm.reconstruction_error(p, x0),
                    float(rbm.free_energy(p, x0).mean()
                          - rbm.free_energy(p, shuffled).mean()))
    err0, fe0 = stats()
    _zero_counts(ck)                                   # main path starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(ListDataSetIterator(batches))
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    err1, fe1 = stats()
    t1 = time.perf_counter()
    for d in batches[:DBN_FIT_STEPS]:
        net.fit(d)
    fit_score = net.score()
    fit_s = time.perf_counter() - t1
    snapshot = net.params().detach().cpu()
    lgd = Solver("LINE_GRADIENT_DESCENT", max_iterations=DBN_LGD_ITERATIONS)
    t2 = time.perf_counter()
    final = lgd.optimize(net, batches[0])
    lgd_s = time.perf_counter() - t2
    launches = _kernel_counts(ck)                      # main path ends
    hist = lgd.optimizer.score_history
    cpu = dbn_example_net("cpu").init()
    cpu.set_params(snapshot)
    first = Solver("LINE_GRADIENT_DESCENT", max_iterations=1)
    first.optimize(cpu, DataSet(x0.cpu(), x0.cpu()))
    cpu_first = first.optimizer.score_history[0]
    res = {"layers": len(net.layers), "params": net.num_params(),
           "batch": DBN_BATCH, "pretrain_steps": DBN_BATCHES * 9,
           "pretrain_seconds": pretrain_s, "fit_steps": DBN_FIT_STEPS,
           "fit_seconds": fit_s, "fit_score": fit_score,
           "rbm0": {"reconstruction_error": [err0, err1],
                    "free_energy_data_less_shuffled": [fe0, fe1]},
           "lgd": {"iterations": len(hist), "scores": hist, "final": final,
                   "seconds": lgd_s, "cpu_first": cpu_first,
                   "first_rel_diff": abs(hist[0] - cpu_first)
                   / abs(cpu_first)},
           "launches": launches}
    emit("pretrain_dbn", **res)
    if not (err1 < err0 and fe1 < fe0 and np.isfinite(fit_score)
            and len(hist) >= 2 and hist[-1] < hist[0]
            and all(b <= a + 1e-6 for a, b in zip(hist, hist[1:]))
            and res["lgd"]["first_rel_diff"] <= STEP_RTOL
            and launches == _want(ck)):
        raise AssertionError(f"pretrain_dbn: {res}")
    return res


def center_loss_lenet(device):
    """LeNet (LenetMnistExample's Nesterovs) with a centre-loss head."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ConvolutionLayer, DenseLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers_pretrain import (
        CenterLossOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(12345).learning_rate(0.01)
            .updater("nesterovs").weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(CenterLossOutputLayer(n_out=10, activation="softmax",
                                         loss="mcxent", alpha=CENTER_ALPHA,
                                         lambda_=CENTER_LAMBDA))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())
    return MultiLayerNetwork(conf, device=device)


@contextlib.contextmanager
def _plain_conv_chain(ck):
    """Every conv on the dense chain (cuDNN conv, bias, activation) with
    TF32 off: the conv kernel's plain version inside the network's own
    step."""
    supported = ck.conv_fused_supported
    ck.conv_fused_supported = lambda *a, **k: False
    try:
        with ck.full_f32_convs():
            yield
    finally:
        ck.conv_fused_supported = supported


def _center_distance(torch, net, x, y) -> float:
    """Sum over the classes of x of the distance from the class's centre to
    the mean of its features (the output layer's input)."""
    with torch.no_grad():
        acts = net.feed_forward(x)
        feats = acts[-2]
        labels = torch.as_tensor(y).argmax(1).to(feats.device)
        centres = net.net_params[-1]["cL"]
        return float(sum(torch.linalg.vector_norm(
            centres[c] - feats[labels == c].mean(0))
            for c in labels.unique()))


@_tf32_off
def phase_center_loss_lenet(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    rng = np.random.default_rng(SEED + 21)
    data = _mnist_like(rng, CENTER_STEPS, LENET_BATCH)
    net = center_loss_lenet("cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    x, y = data[0].features, data[0].labels
    dist0 = _center_distance(torch, net, x, y)
    fallbacks = _conv_fallbacks()
    _zero_counts(ck)                                   # main path starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(data[:-1]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    before = net.clone()
    net.fit(data[-1])
    launches = _kernel_counts(ck)                      # main path ends
    fallbacks = _conv_fallbacks() - fallbacks
    kernel_score = net.score()
    params0 = [{k: v.clone() for k, v in lp.items()}
               for lp in before.net_params]
    with _plain_conv_chain(ck):
        before.fit(data[-1])
    plain_score = before.score()
    errs = _update_errs(torch, net, before.net_params, params0)
    dist1 = _center_distance(torch, net, x, y)
    res = {"batch": LENET_BATCH, "steps": CENTER_STEPS, "seconds": dt,
           "samples_per_s": (CENTER_STEPS - 1) * LENET_BATCH / dt,
           "launches": launches, "conv_fallbacks": fallbacks,
           "plain_step": {"kernel_score": kernel_score,
                          "plain_score": plain_score,
                          "score_rel_diff": abs(kernel_score - plain_score)
                          / abs(plain_score),
                          "max_update_rel_err": max(errs.values()),
                          "update_rel_err": errs, "score_rtol": STEP_RTOL,
                          "update_rtol": STEP_UPDATE_RTOL},
           "centre_to_class_mean": [dist0, dist1]}
    emit("center_loss_lenet", **res)
    if not (launches == _want(ck, conv2d_bias_act=2 * CENTER_STEPS)
            and fallbacks == 0 and np.isfinite(kernel_score)
            and res["plain_step"]["score_rel_diff"] <= STEP_RTOL
            and res["plain_step"]["max_update_rel_err"] <= STEP_UPDATE_RTOL
            and dist1 < dist0):
        raise AssertionError(f"center_loss_lenet: {res}")
    return res


def _plain_backprop(torch, ck, net, params, x, signal, outputs=None):
    """Autograd through ``net``'s plain forward (the conv's plain version,
    TF32 off; no dropout) of <pre-activation of the output layer,
    ``signal``> -> (gradients of every param and of x, near ties).  With
    ``outputs`` (the kernel path's layer outputs, :class:`_RecordedOutputs`)
    each relu and max pool decides as the kernel path's backward does
    (:func:`_pin`): a max pool by the kernel path's argmax, a dense relu by
    its mask, and a conv's relu by the plain conv of the kernel path's
    input (the conv kernel's backward differentiates that recompute)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, ConvolutionLayer, DenseLayer, SubsamplingLayer)
    relu = ActivationLayer(activation="relu")
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in lp.items()}
              for lp in params]
    h = x = x.detach().clone().requires_grad_()
    ties, n = [], len(net.layers)
    with ck.full_f32_convs(), torch.enable_grad():
        for i, layer in enumerate(net.layers):
            if i in net.conf.preprocessors:
                h, _ = net.conf.preprocessors[i](h)
            p = leaves[i]
            if isinstance(layer, ConvolutionLayer):
                conv = functools.partial(
                    ck.conv2d_bias_act_reference, pad=tuple(layer.padding),
                    border_mode=layer.convolution_mode)
                if outputs is None or layer.activation != "relu":
                    h = conv(h, p["W"], p["b"], activation=layer.activation)
                    continue
                with torch.no_grad():
                    recomputed = conv(outputs[i - 1] if i else x, p["W"],
                                      p["b"], activation="relu")
                h = _pin(torch, relu, i, conv(h, p["W"], p["b"]),
                         recomputed, ties)
                continue
            if isinstance(layer, DenseLayer):
                h = torch.addmm(p["b"], h, p["W"])
            if i == n - 1:
                break
            if isinstance(layer, SubsamplingLayer):
                h = (_pin(torch, layer, i, h, outputs[i - 1], ties)
                     if outputs is not None else layer.forward(p, {}, h)[0])
            elif outputs is not None and layer.activation == "relu":
                h = _pin(torch, relu, i, h, outputs[i], ties)
            else:
                h = layer._act(h)
        flat = [v for lp in leaves for v in lp.values()] + [x]
        got = torch.autograd.grad((h * signal).sum(), flat)
    return list(got), ties


@_tf32_off
def phase_external_gradients_vgg16_224(torch, ck) -> dict:
    from deeplearning4j_tpu_torch.models import vgg16
    net = vgg16(EXT_HW, EXT_HW, dropout=0.5, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 22)
    x32, _ = _random_batch(rng, EXT_BATCH, (3, EXT_HW, EXT_HW), 1000)
    eps = rng.normal(size=(EXT_BATCH, 1000)).astype(np.float32)
    x, y = _random_batch(rng, VGG_BATCH, (3, EXT_HW, EXT_HW), 1000)
    fallbacks = _conv_fallbacks()
    _zero_counts(ck)                                   # main path starts
    grads, dx = net.backprop_gradient(x32, eps)
    counts = {"backprop_gradient": _kernel_counts(ck)}
    # the external loop against one fit step from the same state
    fit = net.clone()
    fit._generator.set_state(net._generator.get_state())
    state = net._generator.get_state()
    out = net.feed_forward(x, train=True)[-1]
    net._generator.set_state(state)
    yd = torch.from_numpy(y).cuda()
    ext_loss = float(-(yd * torch.log(out)).sum(1).mean())
    eps_loop = -yd / (out * VGG_BATCH)
    params0 = [{k: v.clone() for k, v in lp.items()} for lp in net.net_params]
    g_loop, _ = net.backprop_gradient(x, eps_loop, train=True)
    net.apply_gradients(g_loop)
    counts["external_loop"] = {k: v - counts["backprop_gradient"][k]
                               for k, v in _kernel_counts(ck).items()}
    mark = _kernel_counts(ck)
    fit.fit(x, y)
    launches = _kernel_counts(ck)                      # main path ends
    counts["fit_step"] = {k: launches[k] - mark[k] for k in launches}
    fallbacks = _conv_fallbacks() - fallbacks
    fit_score = fit.score()
    errs = _update_errs(torch, net, fit.net_params, params0)
    same_generator = bool(torch.equal(net._generator.get_state(),
                                      fit._generator.get_state()))
    del fit, g_loop, out, eps_loop
    # backprop_gradient against autograd through the plain conv chain, from
    # the same params and the kernel path's softmax backward at its
    # pre-activation (autograd's, bit for bit what backprop_gradient takes),
    # with the kernel path's max-pool argmax and dense relu masks (a near
    # tie decided the other way reroutes a gradient whole)
    net.net_params = params0
    x32_d = torch.from_numpy(x32).cuda()
    with torch.no_grad(), _RecordedOutputs(net) as rec:
        pre = net._forward_to_preout(params0, net.net_state, x32_d, None,
                                     False)[0]
    pre = pre.detach().requires_grad_()
    with torch.enable_grad():
        signal, = torch.autograd.grad(net.layers[-1]._act(pre), pre,
                                      torch.from_numpy(eps).cuda())
    want, ties = _plain_backprop(torch, ck, net, params0, x32_d, signal,
                                 rec.outputs)
    unpinned, _ = _plain_backprop(torch, ck, net, params0, x32_d, signal)
    del rec
    got = [v for g in grads for v in g.values()] + [dx]
    names = [f"{i}_{k}" for i, g in enumerate(grads) for k in g] + ["dx"]

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    grad_errs = dict(zip(names, (rel(g, w) for g, w in zip(got, want))))
    unpinned_errs = [rel(g, w) for g, w in zip(got, unpinned)]
    tie_gap = max(t["max_rel_gap"] for t in ties)
    res = {"backprop_batch": EXT_BATCH, "loop_batch": VGG_BATCH,
           "launches": launches, "launches_by_part": counts,
           "conv_fallbacks": fallbacks,
           "backprop_vs_plain": {"max_rel_err": max(grad_errs.values()),
                                 "rel_err": grad_errs,
                                 "rtol": STEP_UPDATE_RTOL,
                                 "ties": ties, "max_tie_gap": tie_gap,
                                 "tie_rtol": TIE_RTOL,
                                 "unpinned_max_rel_err":
                                     max(unpinned_errs)},
           "loop_vs_fit": {"loss": ext_loss, "fit_score": fit_score,
                           "score_rel_diff": abs(ext_loss - fit_score)
                           / abs(fit_score),
                           "max_update_rel_err": max(errs.values()),
                           "update_rel_err": errs,
                           "same_generator_after": same_generator,
                           "score_rtol": STEP_RTOL,
                           "update_rtol": STEP_UPDATE_RTOL}}
    emit("external_gradients_vgg16_224", **res)
    want_counts = {
        "backprop_gradient": _want(ck, conv2d_bias_act=13),
        "external_loop": _want(ck, conv2d_bias_act=26, threshold_dropout=6),
        "fit_step": _want(ck, conv2d_bias_act=13, softmax_xent=1,
                          threshold_dropout=4)}
    if not (counts == want_counts and fallbacks == 0 and same_generator
            and max(grad_errs.values()) <= STEP_UPDATE_RTOL
            and tie_gap <= TIE_RTOL
            and res["loop_vs_fit"]["score_rel_diff"] <= STEP_RTOL
            and max(errs.values()) <= STEP_UPDATE_RTOL):
        raise AssertionError(f"external_gradients_vgg16_224: {res}")
    return res


# ---------------------------------------------------------------------------
# The rest of the engine: Java DL4J zips, quantized serving, graph TBPTT,
# gradient checkpointing, shape bucketing
# ---------------------------------------------------------------------------

def _zip_members(path) -> dict:
    import zipfile
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _java_round_trip(torch, net, export, tmp, name) -> dict:
    """``net`` exported in the Java DL4J schema (with its updater state,
    made if it has none), restored on the card by ``load_model`` and
    exported again: params equal, every member of the second zip
    (``updaterState.bin`` included) byte-equal to the first's."""
    from deeplearning4j_tpu_torch.nn.serialization import load_model
    if net.opt_states is None:
        net.opt_states = net._init_opt_states()
    first, second = Path(tmp) / f"{name}.zip", Path(tmp) / f"{name}_2.zip"
    t0 = time.perf_counter()
    export(net, first)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_model(first, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    export(back, second)
    rec = {"n_params": back.n_params, "zip_bytes": first.stat().st_size,
           "export_s": export_s, "restore_s": restore_s,
           "params_equal": bool(torch.equal(back.params(), net.params())),
           "reexport_byte_equal": _zip_members(first) == _zip_members(second),
           "on_card": back.params().device.type == "cuda"}
    if not (rec["params_equal"] and rec["reexport_byte_equal"]
            and rec["on_card"]):
        raise AssertionError(f"{name}: Java-schema round trip {rec}")
    return rec, back, str(first)


def phase_dl4j_zip_serve(torch, ck) -> dict:
    """VGG16-CIFAR10 and the seeded ResNet-50 exported in the Java DL4J
    schema and migrated back on the card; the migrated VGG16 served to 8
    clients; the five frozen Java fixtures restored on the card against
    the CPU port."""
    from deeplearning4j_tpu_torch.models import vgg16_cifar10
    from deeplearning4j_tpu_torch.nn import dl4j_migration as mig
    from deeplearning4j_tpu_torch.nn.serialization import load_model
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)
    vgg = vgg16_cifar10(device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 30)
    dims = (3, 32, 32)
    xs = [rng.normal(size=(int(rng.integers(1, 5)),) + dims).astype(
        np.float32) for _ in range(DL4J_REQUESTS)]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["vgg16_cifar10"], served, path = _java_round_trip(
            torch, vgg, mig.export_multi_layer_network, tmp, "vgg16_cifar10")
        resnet = seeded_resnet50("cuda")
        res["resnet50"], back, _ = _java_round_trip(
            torch, resnet, mig.export_computation_graph, tmp, "resnet50")
        # the Java zip carries the running statistics: the migrated graph
        # serves what the seeded one does
        x = torch.randn((4, 3, RESNET_HW, RESNET_HW),
                        generator=torch.Generator().manual_seed(SEED + 31))
        x = x.cuda()
        got, want = back.output(x)[0], resnet.output(x)[0]
        res["resnet50"]["output_max_abs_vs_seeded"] = float(
            (got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=DL4J_FIXTURE_TOL,
                                   atol=DL4J_FIXTURE_TOL)
        del resnet, back
        if (res["vgg16_cifar10"]["n_params"], res["resnet50"]["n_params"]) \
                != (VGG16_CIFAR10_PARAMS, RESNET_PARAMS):
            raise AssertionError(f"Java-schema zips: {res}")
        server = Server(DeepLearning4jEntryPoint(device="cuda",
                                                 max_batch=32)).start()
        try:
            url = f"http://127.0.0.1:{server.port}/"
            _rpc(url, "warmup", {"model_path": path,
                                 "feature_dims": list(dims)})
            fallbacks = _conv_fallbacks()
            _zero_counts(ck)                           # main path starts
            drive = _drive(url, path, xs, clients=DL4J_CLIENTS)
            launches = _kernel_counts(ck)              # main path ends
            fallbacks = _conv_fallbacks() - fallbacks
            batches = server.entry_point.stats()["serving"][
                str(Path(path).resolve())]["batches"]
            cached = server.entry_point.model_cache.get(path)
        finally:
            server.stop()
    _check_served_classes("migrated vgg16_cifar10", xs, drive.pop("answers"),
                          cached.output)
    if launches != _want(ck, conv2d_bias_act=13 * batches) or fallbacks:
        raise AssertionError(f"{batches} served batches of the migrated "
                             f"VGG16: launches {launches}, {fallbacks} "
                             f"conv fallbacks")
    x4 = torch.from_numpy(np.concatenate(xs)[:4]).cuda()
    got, ref = cached.output(x4), _plain_forward(torch, ck, cached, x4)
    torch.testing.assert_close(got, ref, rtol=NET_RTOL, atol=NET_ATOL)
    res["serve"] = {**drive, "batches": batches, "launches": launches,
                    "conv_fallbacks": fallbacks,
                    "classes_equal_direct_output": True,
                    "max_abs_vs_plain": float((got - ref).abs().max())}
    fixtures = {}
    for name, shape in DL4J_FIXTURES.items():
        p = ROOT / "tests" / "regression" / f"dl4j_071_{name}.zip"
        card, cpu = (load_model(p, device=d) for d in ("cuda", "cpu"))
        xf = np.random.default_rng(9).normal(size=(3,) + shape).astype(
            np.float32)
        out_card, out_cpu = (m.output(xf) for m in (card, cpu))
        if isinstance(out_card, tuple):
            out_card, out_cpu = out_card[0], out_cpu[0]
        err = float((out_card.cpu() - out_cpu).abs().max())
        fixtures[name] = {"params_equal": bool(torch.equal(
            card.params().cpu(), cpu.params())), "max_abs_vs_cpu": err}
        if err > DL4J_FIXTURE_TOL or not fixtures[name]["params_equal"]:
            raise AssertionError(f"fixture {name}: {fixtures[name]}")
    res["fixtures"] = fixtures
    res["fixture_tol"] = DL4J_FIXTURE_TOL
    res["launches"] = launches
    emit("dl4j_zip_serve", **res)
    return res


def _quantized_zip(torch, net, tmp, name, mode) -> str:
    """A zip of ``net`` whose configuration asks for ``mode`` serving."""
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    path = str(Path(tmp) / f"{name}_{mode}.zip")
    prev = net.conf.global_conf.precision_infer_quant
    net.conf.global_conf.precision_infer_quant = \
        None if mode == "dense" else mode
    try:
        write_model(net, path)
    finally:
        net.conf.global_conf.precision_infer_quant = prev
    return path


def _top1(torch, dense, q, margin_min) -> dict:
    """Top-1 agreement of ``q`` with ``dense`` (probabilities) over all
    rows and over the rows whose dense log-probability margin between the
    first and second class is at least ``margin_min`` nats."""
    lp = torch.log(dense)
    top2 = torch.topk(lp, 2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = (q.argmax(1) == dense.argmax(1)).float()
    sure = margin >= margin_min
    return {"rows": len(agree), "agreement": float(agree.mean()),
            "margin_rows": int(sure.sum()),
            "margin_agreement": (float(agree[sure].mean())
                                 if bool(sure.any()) else None),
            "max_abs_log_prob_change": float((torch.log(q) - lp).abs().max()),
            "median_margin": float(margin.median())}


def phase_serve_quantized(torch, ck) -> dict:
    """VGG16-CIFAR10 and ResNet-50 served from zips whose configuration
    sets ``infer_quant`` (int8, fp8) and from a dense one, through Server
    -> predict -> ModelCache -> MicroBatcher -> output."""
    from deeplearning4j_tpu_torch.models import vgg16_cifar10
    from deeplearning4j_tpu_torch.ops import quantize as qz
    from deeplearning4j_tpu_torch.server import (
        DeepLearning4jEntryPoint, Server)
    models = {
        "vgg16_cifar10": (vgg16_cifar10(device="cuda").init(
            generator=torch.Generator().manual_seed(SEED)), (3, 32, 32),
            QUANT_VGG_REQUESTS),
        "resnet50": (seeded_resnet50("cuda", batch_norms=False),
                     (3, RESNET_HW, RESNET_HW), QUANT_RESNET_REQUESTS)}
    rng = np.random.default_rng(SEED + 32)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (net, dims, n_req) in models.items():
            graph = hasattr(net, "order")
            xs = [rng.normal(size=(int(rng.integers(1, 3)),) + dims).astype(
                np.float32) for _ in range(n_req)]
            xa = torch.from_numpy(rng.normal(
                size=(QUANT_ROWS[name],) + dims).astype(np.float32)).cuda()
            dense_out = torch.cat([
                (net.output(c)[0] if graph else net.output(c))
                for c in xa.split(32)])
            rec = {}
            for mode in ("dense", "int8", "fp8"):
                path = _quantized_zip(torch, net, tmp, name, mode)
                server = Server(DeepLearning4jEntryPoint(
                    device="cuda", max_batch=32)).start()
                try:
                    url = f"http://127.0.0.1:{server.port}/"
                    _rpc(url, "warmup", {"model_path": path,
                                         "feature_dims": list(dims)})
                    torch.cuda.synchronize()
                    _zero_counts(ck)                   # main path starts
                    drive = _drive(url, path, xs, clients=QUANT_CLIENTS)
                    launches = _kernel_counts(ck)      # main path ends
                    batches = server.entry_point.stats()["serving"][
                        str(Path(path).resolve())]["batches"]
                    served = server.entry_point.model_cache.get(path)
                finally:
                    server.stop()

                def direct(x, served=served, graph=graph):
                    return served.output(x)[0] if graph else served.output(x)
                _check_served_classes(f"{name} {mode}", xs,
                                      drive.pop("answers"), direct)
                convs = (RESNET_KERNEL_CONVS if graph else 13) * batches
                if launches != _want(ck, conv2d_bias_act=convs):
                    raise AssertionError(f"{name} {mode}: {batches} batches "
                                         f"launched {launches}")
                r = {"p50_ms": drive["p50_ms"], "p99_ms": drive["p99_ms"],
                     "requests_per_s": drive["requests_per_s"],
                     "requests": drive["requests"], "batches": batches,
                     "launches": launches,
                     "classes_equal_direct_output": True}
                if mode != "dense":
                    if served._infer_quant != mode:
                        raise AssertionError(f"{name}: served "
                                             f"{served._infer_quant}")
                    q_out = torch.cat([direct(c) for c in xa.split(32)])
                    stats = served._q_stats
                    codes = [r["q"] for r in _tensor_leaves_q(
                        served._q_params)]
                    want = torch.int8 if mode == "int8" else \
                        qz.fp8_dtype()
                    if not codes or any(c.dtype != want
                                        or c.device.type != "cuda"
                                        for c in codes):
                        raise AssertionError(f"{name} {mode}: codes not "
                                             f"{want} on the card")
                    # the kernel path against the plain conv chain on the
                    # same dequantized weights
                    deq = served.clone()
                    deq.quantize_inference(None)
                    deq.net_params = qz.dequantize_params(served._q_params)
                    x8 = xa[:8]
                    got = direct(x8)
                    ref = (_plain_graph_forward(torch, ck, deq, x8) if graph
                           else _plain_forward(torch, ck, deq, x8))
                    torch.testing.assert_close(got, ref, rtol=NET_RTOL,
                                               atol=NET_ATOL)
                    del deq
                    agree = _top1(torch, dense_out, q_out, QUANT_MARGIN)
                    r.update(resident_weight_bytes={
                        "quantized": stats["quantized_bytes"],
                        "dense": stats["dense_bytes"],
                        "ratio": stats["dense_bytes"]
                        / stats["quantized_bytes"]},
                        max_abs_vs_plain_dequantized=float(
                            (got - ref).abs().max()),
                        top1=agree, top1_rule=QUANT_TOP1[mode]
                        if name in QUANT_TOP1_GATED else None)
                    if name in QUANT_TOP1_GATED and (
                            agree["margin_rows"] < QUANT_MARGIN_ROWS_MIN
                            * agree["rows"]
                            or agree["margin_agreement"]
                            < QUANT_TOP1[mode]):
                        raise AssertionError(f"{name} {mode}: top-1 {agree}")
                rec[mode] = r
                del served
            res[name] = rec
            del net
            torch.cuda.empty_cache()
    res["launches"] = _sum_counts(
        [res[m][k]["launches"] for m in models for k in res[m]])
    emit("serve_quantized", margin_nats=QUANT_MARGIN, **res)
    return res


def _tensor_leaves_q(tree):
    """The ``{"q", "s"}`` records of a quantized tree."""
    from deeplearning4j_tpu_torch.ops import quantize as qz
    if qz.is_qleaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [r for v in tree.values() for r in _tensor_leaves_q(v)]
    if isinstance(tree, (list, tuple)):
        return [r for v in tree for r in _tensor_leaves_q(v)]
    return []


def _sum_counts(counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def charrnn_graph(net):
    """The char-RNN ``net`` (a MultiLayerNetwork) as a ComputationGraph of
    the same layers, hyperparameters and TBPTT, holding copies of its
    params."""
    import copy
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    b = gc.GraphBuilder(copy.deepcopy(net.conf.global_conf)).add_inputs("in")
    prev, names = "in", []
    for i, layer in enumerate(net.conf.layers):
        names.append("out" if i == len(net.conf.layers) - 1 else f"lstm{i}")
        b.add_layer(names[-1], layer, prev)
        prev = names[-1]
    conf = (b.set_outputs("out").backprop_type(net.conf.backprop_type)
            .t_bptt_forward_length(net.conf.tbptt_fwd_length)
            .t_bptt_backward_length(net.conf.tbptt_back_length).build())
    graph = ComputationGraph(conf, device=net.device)
    graph.net_params = {n: _clone_tree(lp)
                        for n, lp in zip(names, net.net_params)}
    graph.net_state = {n: {} for n in names}
    return graph, names


def _sample(net, V, streams, chars, seed, graph=False) -> list:
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(seed)
    net.rnn_clear_previous_state()
    cur = rng.integers(0, V, streams)
    picks = []
    for _ in range(chars):
        out = net.rnn_time_step(eye[cur][:, None, :])
        out = (out[0] if graph else out)[:, -1]
        p = out.double().cpu().numpy()
        cur = np.array([rng.choice(V, p=q / q.sum()) for q in p])
        picks.append(cur.tolist())
    return picks


@_tf32_off
def phase_graph_tbptt_charrnn(torch, ck, train_char) -> dict:
    """The char-RNN as a ComputationGraph from the network's initial
    params, trained by graph TBPTT on the same minibatches as
    ``train_charrnn``; sampling and stored-state activations."""
    from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=CHAR_SEQ, batch=CHAR_BATCH, seed=0)
    mln = char_rnn(it.vocab_size, CHAR_HIDDEN, CHAR_LAYERS,
                   tbptt_length=CHAR_TBPTT, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    p0 = _clone_tree(mln.net_params)
    graph, names = charrnn_graph(mln)
    torch.cuda.synchronize()
    lstm_fallbacks = _fallbacks("lstm_step")
    minibatches = []
    _zero_counts(ck)                                   # main path starts
    for k in range(CHAR_MINIBATCHES):
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        graph.fit(it.next())
        score = graph.score()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        minibatches.append({
            "minibatch": k + 1, "score": score, "seconds": dt,
            "chars_per_s": CHAR_BATCH * CHAR_SEQ / dt,
            "launches": {n: after[n] - counts[n] for n in after}})
    train_launches = _kernel_counts(ck)
    lstm_fallbacks = _fallbacks("lstm_step") - lstm_fallbacks
    want = _want(ck, lstm_step=CHAR_LAYERS * CHAR_SEQ)
    if any(m["launches"] != want for m in minibatches) or lstm_fallbacks \
            or graph.iteration != CHAR_MINIBATCHES * CHAR_SEQ // CHAR_TBPTT:
        raise AssertionError(f"graph TBPTT: {minibatches}, {lstm_fallbacks} "
                             f"lstm fallbacks, {graph.iteration} segments")
    # against the network's training (train_charrnn, the same batches)
    trained = train_char["trained_params"]
    errs = {f"{n}_{k}": float(
        torch.linalg.vector_norm(graph.net_params[n][k] - lp[k])
        / torch.linalg.vector_norm(lp[k] - p[k]))
        for n, lp, p in zip(names, trained, p0) for k in lp}
    score_diffs = [abs(g["score"] - m["score"]) / abs(m["score"])
                   for g, m in zip(minibatches, train_char["minibatches"])]
    # sampling: the graph's rnn_time_step against the network's on the
    # trained params
    mln.net_params = [_clone_tree(graph.net_params[n]) for n in names]
    mark = _kernel_counts(ck)
    t0 = time.perf_counter()
    g_chars = _sample(graph, it.vocab_size, SAMPLE_STREAMS,
                      GRAPH_SAMPLE_CHARS, SEED, graph=True)
    g_ms = (time.perf_counter() - t0) / GRAPH_SAMPLE_CHARS * 1e3
    launches = _kernel_counts(ck)                      # main path ends
    sample_launches = {k: launches[k] - mark[k] for k in launches}
    m_chars = _sample(mln, it.vocab_size, SAMPLE_STREAMS, GRAPH_SAMPLE_CHARS,
                      SEED)
    # stored-state activations against the stepped forward
    x = it.next().features[:SAMPLE_STREAMS, :2 * CHAR_TBPTT]
    mln.rnn_clear_previous_state()
    a1 = mln.rnn_activate_using_stored_state(x[:, :CHAR_TBPTT],
                                             store_last_for_tbptt=True)
    a2 = mln.rnn_activate_using_stored_state(x[:, CHAR_TBPTT:])
    mln.rnn_clear_previous_state()
    stepped = torch.cat([mln.rnn_time_step(x[:, t:t + 1])
                         for t in range(2 * CHAR_TBPTT)], dim=1)
    stored = torch.cat([a1[-1], a2[-1]], dim=1)
    stored_err = float((stored - stepped).abs().max())
    tmpl = mln.rnn_carry_template(SAMPLE_STREAMS)
    res = {"segments": graph.iteration, "minibatches": minibatches,
           "chars_per_s_after_first": CHAR_BATCH * CHAR_SEQ
           * (CHAR_MINIBATCHES - 1)
           / sum(m["seconds"] for m in minibatches[1:]),
           "network_chars_per_s_after_first":
               train_char["chars_per_s_after_first"],
           "lstm_fallbacks": lstm_fallbacks,
           "training_launches": train_launches,
           "update_rel_err_vs_network": errs,
           "max_update_rel_err": max(errs.values()),
           "max_score_rel_diff": max(score_diffs),
           "update_rtol": CHAR_UPDATE_RTOL, "score_rtol": CHAR_SCORE_RTOL,
           "sample_launches": sample_launches,
           "graph_sample_ms_per_char": g_ms,
           "samples_equal_network": g_chars == m_chars,
           "stored_state_vs_stepped_max_abs": stored_err,
           "carry_template": [None if c is None else list(c.c.shape)
                              for c in tmpl],
           "launches": launches, "n_params": graph.n_params}
    emit("graph_tbptt_charrnn", **res)
    if res["max_update_rel_err"] > CHAR_UPDATE_RTOL or \
            res["max_score_rel_diff"] > CHAR_SCORE_RTOL or \
            not res["samples_equal_network"] or stored_err > LSTM_TOL or \
            sample_launches != _want(
                ck, lstm_step=CHAR_LAYERS * GRAPH_SAMPLE_CHARS):
        raise AssertionError("graph char-RNN disagrees with the network")
    return res


def _recorded_dropout():
    """A context recording the keep mask of every dropout a layer applies
    (``ops/helpers.dropout``, which still launches and counts the
    kernel)."""
    from unittest import mock
    from deeplearning4j_tpu_torch.ops import helpers
    masks = []
    inner = helpers.dropout

    def rec(x, rate, seed):
        y = inner(x, rate, seed)
        masks.append(((y != 0) | (x == 0)).detach().clone())
        return y
    return masks, mock.patch.object(helpers, "dropout", rec)


@_tf32_off
def phase_checkpointed_vgg16_224(torch, ck) -> dict:
    """One VGG16-224 step (dropout 0.5, batch VGG_BATCH, f32) with
    ``gradient_checkpointing`` against one without, from the same params,
    updater state and seed words: plain, checkpointed, plain."""
    from deeplearning4j_tpu_torch.models import vgg16
    net = vgg16(dropout=0.5, device="cuda").init(
        generator=torch.Generator().manual_seed(SEED))
    x, y = _random_batch(np.random.default_rng(SEED + 33), VGG_BATCH,
                         (3, 224, 224), 1000)
    xd, yd = (torch.from_numpy(a).cuda() for a in (x, y))
    net.opt_states = net._init_opt_states()
    seeds = net._draw_seeds().tolist()
    snap = (_clone_tree(net.net_params), _clone_tree(net.opt_states),
            _clone_tree(net.net_state))

    def step(remat):
        net.net_params, net.opt_states, net.net_state = (
            _clone_tree(t) for t in snap)
        net.conf.global_conf.gradient_checkpointing = remat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts = _kernel_counts(ck)
        masks, patch = _recorded_dropout()
        t0 = time.perf_counter()
        with patch:
            score, grads = net._grad_step(xd, yd, None, None, seeds)
            net._apply_updates(grads, 0)
            del grads
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        return {"seconds": dt, "score": float(score),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "peak_above_start_bytes":
                    torch.cuda.max_memory_allocated() - base,
                "launches": {n: after[n] - counts[n] for n in after}
                }, masks, _clone_tree(net.net_params)
    _zero_counts(ck)                                   # main path starts
    runs = []
    for remat in (False, True, False):
        bw = ck._ConvBiasAct.backwards
        rec, masks, params = step(remat)
        rec["conv_backwards"] = ck._ConvBiasAct.backwards - bw
        runs.append((rec, masks, params))
    launches = _kernel_counts(ck)                      # main path ends
    net.conf.global_conf.gradient_checkpointing = False
    (plain, m_plain, p_plain), (remat, m_remat, p_remat), (again, _, _) = runs
    n_fwd = len(m_plain)
    errs = {f"{i}_{k}": float(
        torch.linalg.vector_norm(lr[k] - lp[k])
        / torch.linalg.vector_norm(lp[k] - l0[k]))
        for i, (lr, lp, l0) in enumerate(zip(p_remat, p_plain, snap[0]))
        for k in lp}
    # the first forward's masks are the plain step's, and every recompute
    # draws one of them again
    masks_equal = len(m_remat) > n_fwd and all(
        torch.equal(a, b) for a, b in zip(m_plain, m_remat[:n_fwd])) and \
        all(any(torch.equal(m, p) for p in m_plain) for m in m_remat[n_fwd:])
    res = {"batch": VGG_BATCH, "plain": plain, "checkpointed": remat,
           "plain_again": again, "update_rel_err": errs,
           "max_update_rel_err": max(errs.values()),
           "score_rel_diff": abs(remat["score"] - plain["score"])
           / abs(plain["score"]),
           "dropout_masks_equal": masks_equal,
           "dropout_mask_launches": [len(m_plain), len(m_remat)],
           "running_statistics": "none (VGG16 has no batch norm)",
           "peak_ratio": remat["peak_bytes"] / plain["peak_bytes"],
           "seconds_ratio": remat["seconds"] / plain["seconds"],
           "update_rtol": STEP_UPDATE_RTOL, "score_rtol": STEP_RTOL,
           "launches": launches}
    emit("checkpointed_vgg16_224", **res)
    if res["max_update_rel_err"] > STEP_UPDATE_RTOL or \
            res["score_rel_diff"] > STEP_RTOL or not masks_equal or \
            plain["launches"] != _want(ck, conv2d_bias_act=13,
                                       softmax_xent=1, threshold_dropout=4) \
            or remat["launches"] != _want(
                ck, conv2d_bias_act=CKPT_CONV_LAUNCHES, softmax_xent=1,
                threshold_dropout=CKPT_DROPOUT_LAUNCHES):
        raise AssertionError("checkpointed VGG16-224 step disagrees with "
                             "the plain step")
    return res


def _ragged_lenet_batches(rng, n):
    from deeplearning4j_tpu_torch.datasets import DataSet
    sizes = rng.integers(BUCKET_ROWS[0], BUCKET_ROWS[1] + 1, n)
    return [DataSet(rng.random((int(s), 1, 28, 28), np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, s)])
            for s in sizes]


def _ragged_char_batches(rng, it, n):
    """Char-RNN batches of ragged lengths, each with a features mask that
    ends some rows early."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    out = []
    for _ in range(n):
        t = int(rng.integers(BUCKET_TIME[0], BUCKET_TIME[1] + 1))
        ds = it.next()
        fm = np.ones((CHAR_BATCH, t), np.float32)
        for r in range(CHAR_BATCH):
            fm[r, rng.integers(t // 2, t + 1):] = 0.0
        out.append(DataSet(ds.features[:, :t], ds.labels[:, :t], fm, fm))
    return out


def _bucketed_steps(torch, make, batches) -> dict:
    """Each of ``batches`` stepped unbucketed and bucketed from the same
    state (the unbucketed run's before it): per param the 2-norm of the
    difference of the two updates over the unbucketed update's, and the
    score's relative difference, worst over the batches."""
    net = make()
    worst_update, worst_score = 0.0, 0.0
    for ds in batches:
        twin = net.clone()
        twin.conf.global_conf.shape_bucketing = True
        before = _clone_tree(net.net_params)
        net._fit_batch(ds)
        twin._fit_batch(ds)
        for lp, tp, bp in zip(net.net_params, twin.net_params, before):
            for k in lp:
                worst_update = max(worst_update, float(
                    torch.linalg.vector_norm(tp[k] - lp[k])
                    / torch.linalg.vector_norm(lp[k] - bp[k])))
        worst_score = max(worst_score, abs(twin.score() - net.score())
                          / abs(net.score()))
        del twin
    return {"steps": len(batches), "max_update_rel_err": worst_update,
            "max_score_rel_diff": worst_score}


def _bucketed_vs_raw(torch, ck, make, batches) -> dict:
    """``make()`` fit over ``batches`` unbucketed and bucketed from the same
    params, through the async pipeline: training signatures, launches,
    samples/s and how far the two runs' params end apart (reported: over
    many steps the runs part as any two float32 orders of summation do);
    then :func:`_bucketed_steps` over the first BUCKET_CHECK_STEPS."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    rows = sum(d.num_examples() for d in batches)
    out, params = {}, {}
    for mode in ("raw", "bucketed"):
        net = make()
        net.conf.global_conf.shape_bucketing = mode == "bucketed"
        torch.cuda.synchronize()
        counts = _kernel_counts(ck)
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator(list(batches)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _kernel_counts(ck)
        snap = net.compile_telemetry.snapshot()
        out[mode] = {"seconds": dt, "samples_per_s": rows / dt,
                     "signatures": snap["by_kind"].get("train_step", 0),
                     "bucket_hits": snap["bucket_hits"],
                     "score": net.score(),
                     "launches": {n: after[n] - counts[n] for n in after}}
        params[mode] = net.params()
        del net
    out.update(batches=len(batches), rows=rows,
               final_params_rel_diff=float(
                   torch.linalg.vector_norm(params["bucketed"]
                                            - params["raw"])
                   / torch.linalg.vector_norm(params["raw"])),
               step_check=_bucketed_steps(torch, make,
                                          batches[:BUCKET_CHECK_STEPS]))
    return out


@_tf32_off
def phase_bucketed_fit(torch, ck) -> dict:
    """LeNet + Adam on ragged batch sizes and the char-RNN (standard
    backprop) on ragged lengths with masks, each bucketed against
    unbucketed from the same params, under cuDNN's deterministic
    algorithms."""
    from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn
    from deeplearning4j_tpu_torch.models import lenet
    rng = np.random.default_rng(SEED + 34)
    lenet_batches = _ragged_lenet_batches(rng, BUCKET_LENET_BATCHES)
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=BUCKET_TIME[1], batch=CHAR_BATCH,
                           seed=1)
    char_batches = _ragged_char_batches(rng, it, BUCKET_CHAR_BATCHES)

    def make_char():
        net = char_rnn(it.vocab_size, CHAR_HIDDEN, CHAR_LAYERS,
                       device="cuda").init(
            generator=torch.Generator().manual_seed(SEED))
        net.conf.backprop_type = "standard"   # TBPTT is not bucketed
        return net
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        _zero_counts(ck)                               # main path starts
        res = {"lenet": _bucketed_vs_raw(
            torch, ck, lambda: lenet(device="cuda").init(
                generator=torch.Generator().manual_seed(SEED)),
            lenet_batches),
            "charrnn": _bucketed_vs_raw(torch, ck, make_char, char_batches)}
        launches = _kernel_counts(ck)                  # main path ends
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    res["launches"] = launches
    res["rules"] = {"lenet": BUCKET_LENET_RTOL, "charrnn": BUCKET_CHAR_RTOL,
                    "score": BUCKET_SCORE_RTOL}
    emit("bucketed_fit", **res)
    lb, cb = res["lenet"]["bucketed"], res["charrnn"]["bucketed"]
    if any(res[m]["step_check"]["max_update_rel_err"] > rtol
           or res[m]["step_check"]["max_score_rel_diff"] > BUCKET_SCORE_RTOL
           for m, rtol in (("lenet", BUCKET_LENET_RTOL),
                           ("charrnn", BUCKET_CHAR_RTOL))) or \
            lb["signatures"] > len({k for k in lb["bucket_hits"]
                                    if k.startswith("train_step:")}) or \
            cb["signatures"] > len({k for k in cb["bucket_hits"]
                                    if k.startswith("train_step:")}) or \
            lb["launches"]["conv2d_bias_act"] != 2 * BUCKET_LENET_BATCHES:
        raise AssertionError("bucketed fit disagrees with the raw fit")
    return res


# ---------------------------------------------------------------------------
# stateful decode serving: the decode pool, the paged KV arena, speculative
# decode, migration and a killed pool thread
# ---------------------------------------------------------------------------

def _decode_clients(spec_path: str, out_path: str) -> None:
    """A client process of ``_decode_streams_over_http``: one thread a
    client of the spec, from the spec's start time; client i opens its
    session ``delay`` s after the start and sends one-token
    ``decode_step`` RPCs, closing and reopening its session at ``cut``.
    Writes the streams (tokens, outputs), the RPC latencies, its end time
    and any errors to ``out_path``."""
    spec = json.loads(Path(spec_path).read_text())
    url, path, V = spec["url"], spec["path"], spec["vocab"]
    eye = np.eye(V, dtype=np.float32)
    streams, lat, errors = [], [], []
    lock = threading.Lock()

    def client(cl):
        try:
            time.sleep(max(0.0, spec["start_at"] + cl["delay"]
                           - time.time()))
            toks, cut = cl["tokens"], cl["cut"]
            for a, b in ((0, cut), (cut, len(toks))):
                if a == b:
                    continue
                sid = _rpc(url, "open_session",
                           {"model_path": path})["session_id"]
                outs = []
                for t in range(a, b):
                    body = {"session_id": sid,
                            "features": eye[toks[t]][None].tolist()}
                    t0 = time.perf_counter()
                    res = _rpc(url, "decode_step", body)
                    dt = time.perf_counter() - t0
                    outs.append(res["predictions"][0])
                    with lock:
                        lat.append(dt)
                _rpc(url, "close_session", {"session_id": sid})
                with lock:
                    streams.append((toks[a:b], outs))
        except Exception as e:  # reported by the parent
            errors.append(f"client: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=client, args=(cl,))
               for cl in spec["clients"]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    Path(out_path).write_text(json.dumps({
        "streams": streams, "lat": lat, "errors": errors,
        "end": time.time()}))


def _decode_streams_over_http(torch, ck, net, it, sessions, steps, seed,
                              kernel, processes=4):
    """``net`` written as a zip and served by ``Server`` over HTTP to
    ``sessions`` clients (``decode_slots`` = sessions) in ``processes``
    client processes (the server's process holds only its handler threads
    and the pool thread, as a deployment's would): client i opens its
    session i x 15 ms after the start and sends ``steps`` one-token
    ``decode_step`` RPCs; every fourth client closes its session half-way
    and opens a new one for the rest.  ``processes=0`` runs the clients as
    threads of this process instead.  Counts zeroed just before the
    clients start and read after the last ends: the ``kernel`` form of the
    lstm step twice (two layers) a pool dispatch, nothing else, no
    fallback.  -> (result, [(tokens, outputs) per stream])."""
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    from deeplearning4j_tpu_torch.server import (DeepLearning4jEntryPoint,
                                                 Server)
    toks = np.random.default_rng(seed).integers(0, it.vocab_size,
                                                (sessions, steps))
    tmp = Path(tempfile.mkdtemp(prefix="chip_decode_"))
    path = str(tmp / "charrnn.zip")
    write_model(net, path)
    ep = DeepLearning4jEntryPoint(device="cuda", decode_slots=sessions,
                                  decode_max_wait_ms=2.0)
    server = Server(ep, port=0).start()
    procs = []
    try:
        start_at = time.time() + 3.0          # after the processes start
        parts = max(1, processes)
        for k in range(parts):
            spec = {"url": f"http://{server.host}:{server.port}/",
                    "path": path, "vocab": it.vocab_size,
                    "start_at": start_at,
                    "clients": [{"tokens": toks[i].tolist(),
                                 "cut": steps // 2 if i % 4 == 3 else steps,
                                 "delay": i * 0.015}
                                for i in range(k, sessions, parts)]}
            (tmp / f"spec{k}.json").write_text(json.dumps(spec))
        fb = _fallbacks("lstm_step")
        _zero_counts(ck)                               # main path starts
        if processes:
            for k in range(processes):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke as c; "
                     "c._decode_clients(sys.argv[1], sys.argv[2])",
                     str(tmp / f"spec{k}.json"), str(tmp / f"out{k}.json")],
                    cwd=str(ROOT)))
            for p in procs:
                p.wait(900)
        else:
            _decode_clients(str(tmp / "spec0.json"), str(tmp / "out0.json"))
        launches = _kernel_counts(ck)                  # main path ends
        fallbacks = _fallbacks("lstm_step") - fb
        (stats,) = ep.decode_stats().values()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    outs = [json.loads((tmp / f"out{k}.json").read_text())
            for k in range(parts)]
    errors = [e for o in outs for e in o["errors"]]
    if errors or any(p.returncode for p in procs):
        raise RuntimeError(f"decode serving failed: {errors[:3]}")
    wall = max(o["end"] for o in outs) - start_at
    lat = [x for o in outs for x in o["lat"]]
    streams = [(np.asarray(t), np.asarray(v, np.float32))
               for o in outs for t, v in o["streams"]]
    want = _want(ck, **{kernel: 2 * stats["batches"]})
    if launches != want or fallbacks:
        raise AssertionError(f"decode launched {launches} with {fallbacks} "
                             f"fallbacks; want {want} and none")
    n = sessions * steps
    res = {"sessions": sessions, "steps": steps, "streams": len(streams),
           "client_processes": processes, "rpcs": len(lat),
           "wall_s": wall, "tokens_per_s": n / wall,
           "p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3),
           "dispatches": stats["batches"],
           "mean_joined_batch": stats["steps_per_batch_mean"],
           "batch_size_hist": stats["batch_size_hist"],
           "pool_step_ms": stats["step_ms"],
           "pool_queue_ms": stats["queue_ms"], "launches": launches,
           "fallbacks": fallbacks}
    return res, streams


def _streams_vs_time_step(torch, net, it, streams):
    """Each stream's served outputs against ``rnn_time_step`` of that
    stream alone, fed its tokens in one call -> (max |diff|, the worst
    stream's relative 2-norm, the relative 2-norm over every stream
    together, [(served, reference)])."""
    eye = np.eye(it.vocab_size, dtype=np.float32)
    pairs = []
    for tok, got in streams:
        net.rnn_clear_previous_state()
        ref = net.rnn_time_step(eye[tok][None])[0].float().cpu()
        pairs.append((torch.from_numpy(got), ref))
    net.rnn_clear_previous_state()
    got = torch.cat([g for g, _ in pairs])
    ref = torch.cat([r for _, r in pairs])
    return (float((got - ref).abs().max()),
            max(_rel_norm(torch, g, r) for g, r in pairs),
            _rel_norm(torch, got, ref), pairs)


def phase_decode_charrnn(torch, ck, net, it, net_bf16) -> dict:
    """The char-RNN served to DECODE_SESSIONS concurrent sessions over
    HTTP (``decode_slots`` 32), DECODE_STEPS one-token steps each, joins
    and leaves as ``_decode_streams_over_http`` schedules them: every
    stream's outputs against ``rnn_time_step`` by ``sample_charrnn``'s rule
    (LSTM_TOL), exact lstm launches, no fallback; then the bf16 char-RNN
    for DECODE_BF16_STEPS steps by ``sample_charrnn_bf16``'s rule
    (CHAR_BF16_SAMPLE_REL, the relative 2-norm over every stream's
    outputs together) and each stream's by DECODE_BF16_STREAM_REL,
    launching the step's bf16 form."""
    torch.backends.cuda.matmul.allow_tf32 = False
    res, streams = _decode_streams_over_http(
        torch, ck, net, it, DECODE_SESSIONS, DECODE_STEPS, SEED + 40,
        "lstm_step")
    (res["max_abs_vs_time_step"], res["worst_stream_rel_vs_time_step"],
     res["rel_vs_time_step"], pairs) = _streams_vs_time_step(
        torch, net, it, streams)
    res["tol"] = LSTM_TOL
    bf, streams = _decode_streams_over_http(
        torch, ck, net_bf16, it, DECODE_SESSIONS, DECODE_BF16_STEPS,
        SEED + 41, "lstm_step_bf16")
    (bf["max_abs_vs_time_step"], bf["worst_stream_rel_vs_time_step"],
     bf["rel_vs_time_step"], _) = _streams_vs_time_step(
        torch, net_bf16, it, streams)
    bf["rel_rule"] = CHAR_BF16_SAMPLE_REL
    bf["worst_stream_rule"] = DECODE_BF16_STREAM_REL
    res["bf16"] = bf
    emit("decode_charrnn", **res)
    for got, ref in pairs:
        torch.testing.assert_close(got, ref, rtol=LSTM_TOL, atol=LSTM_TOL)
    if bf["rel_vs_time_step"] > CHAR_BF16_SAMPLE_REL or \
            bf["worst_stream_rel_vs_time_step"] > DECODE_BF16_STREAM_REL:
        raise AssertionError(
            f"bf16 decode against rnn_time_step: {bf['rel_vs_time_step']} "
            f"over every stream, {bf['worst_stream_rel_vs_time_step']} "
            f"the worst one")
    return res


def _pool_streams(pool, xs, wait=300.0):
    """One client thread per row of ``xs`` [S, T, V]: open a session, step
    its T tokens one at a time, close -> outputs [S, T, V]."""
    outs = [None] * len(xs)
    errors = []
    sids = [pool.open_session() for _ in xs]

    def client(i):
        try:
            outs[i] = np.concatenate([pool.step(sids[i], xs[i, t:t + 1],
                                                timeout=wait)[0]
                                      for t in range(xs.shape[1])])
        except Exception as e:
            errors.append(f"stream {i}: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"decode streams failed: {errors[:3]}")
    return np.stack(outs), sids


def phase_decode_attention(torch, ck, net, it) -> dict:
    """DECODE_ATT_SESSIONS sessions x DECODE_ATT_TOKENS characters of the
    attention model through a ``DecodePool`` with dense KV rings (8,192
    entries per layer and slot) and with the paged arena (blocks of
    DECODE_ATT_BLOCK, the sessions' tokens in whole blocks): no kernel (the
    decode attention is plain torch), paged equal to dense and each equal
    to ``rnn_time_step`` of the 8 streams within ATT_OUT_TOL; the KV bytes
    each holds and the peak memory; every block free after close."""
    from deeplearning4j_tpu_torch.server.decode import DecodePool
    f = it.next().features                 # [4, 8192, V]: two windows a row
    xs = np.concatenate([f[:, :DECODE_ATT_TOKENS],
                         f[:, DECODE_ATT_TOKENS:2 * DECODE_ATT_TOKENS]])
    window = net.layers[0].cache_window
    net.rnn_clear_previous_state()
    torch.cuda.empty_cache()
    res, outs = {"sessions": DECODE_ATT_SESSIONS,
                 "tokens": DECODE_ATT_TOKENS, "window": window,
                 "tol": ATT_OUT_TOL}, {}
    for mode in ("dense", "paged"):
        # the arena holds the sessions' resident tokens in whole blocks
        # (the pool never makes it smaller than one window)
        kw = ({"kv_paged": True, "kv_block": DECODE_ATT_BLOCK,
               "kv_arena_tokens": DECODE_ATT_SESSIONS * DECODE_ATT_BLOCK
               * -(-DECODE_ATT_TOKENS // DECODE_ATT_BLOCK)}
              if mode == "paged" else {})
        pool = DecodePool(net, name=f"attention_{mode}",
                          max_slots=DECODE_ATT_SESSIONS, max_wait_ms=2.0,
                          **kw)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _zero_counts(ck)                           # main path starts
            t0 = time.perf_counter()
            outs[mode], sids = _pool_streams(pool, xs)
            wall = time.perf_counter() - t0
            launches = _kernel_counts(ck)              # main path ends
            peak = torch.cuda.max_memory_allocated() - base
            st = pool.stats()
            for sid in sids:
                pool.close_session(sid)
            arena = pool.stats().get("kv_arena")
        finally:
            pool.stop()
        if any(launches.values()):
            raise AssertionError(f"{mode} attention decode launched "
                                 f"{launches}")
        if arena is not None and arena["blocks_free"] != arena["blocks"]:
            raise AssertionError(f"blocks held after close: {arena}")
        res[mode] = {"wall_s": wall, "tokens_per_s": DECODE_ATT_SESSIONS
                     * DECODE_ATT_TOKENS / wall,
                     "dispatches": st["batches"],
                     "mean_joined_batch": st["steps_per_batch_mean"],
                     "pool_step_ms": st["step_ms"],
                     "kv_bytes": st["kv_cache"]["bytes"],
                     "peak_bytes_over_base": peak, "launches": launches,
                     "arena_after_close": arena}
    dense = torch.from_numpy(outs["dense"])
    paged = torch.from_numpy(outs["paged"])
    res["paged_vs_dense_max_abs"] = float((paged - dense).abs().max())
    ref = net.rnn_time_step(xs).float().cpu()
    net.rnn_clear_previous_state()
    res["dense_vs_time_step_max_abs"] = float((dense - ref).abs().max())
    res["paged_vs_time_step_max_abs"] = float((paged - ref).abs().max())
    res["arena_bytes_over_dense"] = res["paged"]["kv_bytes"] / \
        res["dense"]["kv_bytes"]
    emit("decode_attention", **res)
    torch.testing.assert_close(paged, dense, rtol=ATT_OUT_TOL,
                               atol=ATT_OUT_TOL)
    torch.testing.assert_close(dense, ref, rtol=ATT_OUT_TOL,
                               atol=ATT_OUT_TOL)
    torch.testing.assert_close(paged, ref, rtol=ATT_OUT_TOL,
                               atol=ATT_OUT_TOL)
    return res


def phase_spec_decode(torch, ck, net, it) -> dict:
    """Greedy speculative decode of the char-RNN through a ``DecodePool``:
    SPEC_TOKENS tokens after the prompt "The " plainly (one dispatch a
    token), then with ``NGramDraft`` (k = SPEC_K): the same tokens,
    acceptance, tokens a dispatch and tokens/s beside plain; ``ScriptedDraft``
    pinned at every acceptance length 0..k commits plain greedy's tokens;
    sampling (temperature 0.8) with k = SPEC_K equals k = 0 at the same
    seed.  lstm launches: two a fed token, no fallback."""
    from deeplearning4j_tpu_torch.ops import bucketing
    from deeplearning4j_tpu_torch.server.decode import DecodePool
    from deeplearning4j_tpu_torch.server.speculative import (
        NGramDraft, ScriptedDraft, SpeculativeDecoder, one_hot)
    V = it.vocab_size
    prompt = [it.char_to_idx[c] for c in "The "]
    fed = []
    pool = DecodePool(net, name="spec", max_slots=8, max_wait_ms=0.5)

    def prefill():
        sid = pool.open_session()
        (o,) = pool.step(sid, one_hot(prompt, V), timeout=120)
        fed.append(bucketing.bucket_size(len(prompt)))
        return sid, int(np.argmax(o[-1]))

    def spec(sid, first, n, k, draft, **sampling):
        r = SpeculativeDecoder(pool, vocab=V, k=k, draft=draft,
                               **sampling).generate(sid, first, n)
        fed.append(r["dispatches"] + r["proposed"])
        pool.close_session(sid)
        return r
    try:
        fb = _fallbacks("lstm_step")
        _zero_counts(ck)                               # main path starts
        sid, pending = prefill()
        plain = []
        t0 = time.perf_counter()
        for _ in range(SPEC_TOKENS + SPEC_K + 1):
            plain.append(pending)
            (o,) = pool.step(sid, one_hot([pending], V), timeout=120)
            pending = int(np.argmax(o[-1]))
            fed.append(1)
        plain_s = (time.perf_counter() - t0) * SPEC_TOKENS / len(plain)
        pool.close_session(sid)
        sid, first = prefill()
        t0 = time.perf_counter()
        ngram = spec(sid, first, SPEC_TOKENS, SPEC_K, NGramDraft(order=3))
        ngram_s = time.perf_counter() - t0
        if ngram["tokens"] != plain[:SPEC_TOKENS]:
            raise AssertionError("speculative greedy decode left plain "
                                 "greedy decode's tokens")
        pinned = []
        for a in range(SPEC_K + 1):
            sid, first = prefill()
            chunk = [first] + plain[1:1 + a] + \
                [(t + 1) % V for t in plain[1 + a:1 + SPEC_K]]
            _, picks, acc = pool.spec_step(sid, one_hot(chunk, V), chunk,
                                           timeout=120)
            fed.append(len(chunk))
            pool.close_session(sid)
            if acc != 1 + a or chunk[:acc] != plain[:acc] or \
                    int(picks[acc - 1]) != plain[acc]:
                raise AssertionError(f"acceptance {a}: committed {acc}")
            pinned.append(acc)
        scripted = []
        for a in range(SPEC_K + 1):
            props, i = [], 1
            while i < SPEC_TOKENS // 4:
                p = plain[i:i + SPEC_K]
                p = p[:a] + [(t + 1) % V for t in p[a:]]
                props.append(p)
                i += a + 1
            sid, first = prefill()
            r = spec(sid, first, SPEC_TOKENS // 4, SPEC_K,
                     ScriptedDraft(props))
            if r["tokens"] != plain[:SPEC_TOKENS // 4]:
                raise AssertionError(f"scripted acceptance {a} moved the "
                                     "tokens")
            scripted.append(r["tokens_per_dispatch"])
        sampled = {}
        for k, draft in ((0, "none"), (SPEC_K, NGramDraft(order=3))):
            sid, first = prefill()
            sampled[k] = spec(sid, first, SPEC_TOKENS // 2, k, draft,
                              temperature=0.8, seed=SEED)
        launches = _kernel_counts(ck)                  # main path ends
        fallbacks = _fallbacks("lstm_step") - fb
        st = pool.stats()
    finally:
        pool.stop()
    want = _want(ck, lstm_step=CHAR_LAYERS * sum(fed))
    if launches != want or fallbacks:
        raise AssertionError(f"spec decode launched {launches} with "
                             f"{fallbacks} fallbacks; want {want}")
    if sampled[SPEC_K]["tokens"] != sampled[0]["tokens"]:
        raise AssertionError("speculative sampling left non-speculative "
                             "sampling's trajectory")
    res = {"k": SPEC_K, "tokens": SPEC_TOKENS,
           "plain_tokens_per_s": SPEC_TOKENS / plain_s,
           "ngram_tokens_per_s": SPEC_TOKENS / ngram_s,
           "ngram_dispatches": ngram["dispatches"],
           "ngram_tokens_per_dispatch": ngram["tokens_per_dispatch"],
           "ngram_draft_acceptance": (ngram["accepted"]
                                      - ngram["dispatches"])
           / max(1, ngram["proposed"]),
           "pinned_acceptance": pinned,
           "scripted_tokens_per_dispatch": scripted,
           "sampled_dispatches": {str(k): v["dispatches"]
                                  for k, v in sampled.items()},
           "sampled_tokens_per_dispatch": sampled[SPEC_K][
               "tokens_per_dispatch"],
           "spec_accept_per_dispatch": st["spec_accept_per_dispatch"],
           "text": "".join(it.idx_to_char[t] for t in ngram["tokens"]),
           "launches": launches, "fallbacks": fallbacks}
    emit("spec_decode", **res)
    return res


def phase_decode_migrate_fault(torch, ck, att_net, att_it, char_net,
                               char_it) -> dict:
    """A session of the attention model decodes 96 characters in one
    ``DecodeManager`` (dense rings), is exported, imported into a second
    (paged arena, blocks of DECODE_ATT_BLOCK), decodes 24 more, moves back
    and decodes 24 more: each output within MIGRATE_TOL of an unmigrated
    twin in the first manager.  Then a char-RNN pool with 4 sessions in
    flight and a ``kill`` fault armed at ``decode.step``: every step fails
    with a clean error, every slot is reclaimed, and the next submit
    restarts the thread, whose output equals ``rnn_time_step``'s."""
    from deeplearning4j_tpu_torch.nn.serialization import write_model
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.server import DecodeManager, ModelCache
    from deeplearning4j_tpu_torch.server.decode import DecodePool
    from deeplearning4j_tpu_torch.server.speculative import one_hot
    tmp = tempfile.mkdtemp(prefix="chip_migrate_")
    os.environ["DL4J_FLIGHT_DIR"] = str(Path(tmp) / "flight")
    path = str(Path(tmp) / "attention.zip")
    att_net.rnn_clear_previous_state()
    write_model(att_net, path)
    x = att_it.next().features[0, :144]
    window = att_net.layers[0].cache_window
    dense = DecodeManager(ModelCache(device="cuda"), max_slots=2,
                          max_wait_ms=0.5)
    paged = DecodeManager(ModelCache(device="cuda"), max_slots=2,
                          max_wait_ms=0.5, kv_paged=True,
                          kv_block=DECODE_ATT_BLOCK, kv_arena_tokens=window)
    hops, worst = [], 0.0
    try:
        mig = dense.open_session(path)["session_id"]
        twin = dense.open_session(path)["session_id"]
        for t in range(0, 96, 8):
            dense.decode_step(mig, x[t:t + 8])
            dense.decode_step(twin, x[t:t + 8])
        src, t = dense, 96
        for dst in (paged, dense):
            t0 = time.perf_counter()
            payload = json.loads(json.dumps(src.export_session(mig)))
            dst.import_session(path, payload)
            src.finish_export(mig, ok=True)
            hop_s = time.perf_counter() - t0
            wire = len(json.dumps(payload))
            for _ in range(24):
                (a,) = dst.decode_step(mig, x[t:t + 1])
                (b,) = dense.decode_step(twin, x[t:t + 1])
                worst = max(worst, float(np.abs(a - b).max()))
                t += 1
            hops.append({"to": "paged" if dst is paged else "dense",
                         "seconds": hop_s, "wire_bytes": wire})
            src = dst
        arena = paged.stats()
    finally:
        dense.close()
        paged.close()
    if worst > MIGRATE_TOL:
        raise AssertionError(f"migrated stream {worst} from its twin")
    V = char_it.vocab_size
    # min_batch 4: a dispatch waits (up to 2 s) until the 4 sessions'
    # steps are queued, so the kill meets all four in flight
    pool = DecodePool(char_net, name="fault", max_slots=8,
                      max_wait_ms=2000.0, min_batch=4)
    try:
        fb = _fallbacks("lstm_step")
        _zero_counts(ck)                               # main path starts
        sids = [pool.open_session() for _ in range(4)]
        for f in [pool.submit_step(s, one_hot([1], V)) for s in sids]:
            f.result(120)
        faults.arm({"site": "decode.step", "mode": "kill",
                    "probability": 1.0, "max_injections": 1})
        try:
            futs = [pool.submit_step(s, one_hot([2], V)) for s in sids]
            failed = 0
            for f in futs:
                try:
                    f.result(60)
                except RuntimeError as e:
                    failed += "batcher thread died" in str(e)
        finally:
            faults.reset()
        deadline = time.monotonic() + 30
        while pool.thread_alive and time.monotonic() < deadline:
            time.sleep(0.01)
        reclaimed = pool.stats()["slots_free"]
        sid = pool.open_session()
        (out,) = pool.step(sid, one_hot([3, 4], V), timeout=120)
        launches = _kernel_counts(ck)                  # main path ends
        fallbacks = _fallbacks("lstm_step") - fb
        st = pool.stats()
    finally:
        pool.stop()
    if failed != 4 or reclaimed != 8 or st["restarts"] != 1 or \
            st["deaths"] != 1:
        raise AssertionError(f"killed pool: {failed} clean failures, "
                             f"{reclaimed} slots free, {st['restarts']} "
                             f"restarts")
    char_net.rnn_clear_previous_state()
    ref = char_net.rnn_time_step(one_hot([3, 4], V)[None])[0].cpu().numpy()
    char_net.rnn_clear_previous_state()
    torch.testing.assert_close(torch.from_numpy(out), torch.from_numpy(ref),
                               rtol=LSTM_TOL, atol=LSTM_TOL)
    # the four sessions' joined step, then the new session's two tokens
    want = _want(ck, lstm_step=CHAR_LAYERS * (1 + 2))
    if launches != want or fallbacks:
        raise AssertionError(f"fault phase launched {launches}; want {want}")
    res = {"migration_max_abs": worst, "tol": MIGRATE_TOL, "hops": hops,
           "paged_arena": {k: v.get("kv_arena") for k, v in arena.items()},
           "killed_steps_failed_cleanly": failed,
           "slots_free_after_kill": reclaimed, "restarts": st["restarts"],
           "deaths": st["deaths"], "launches": launches,
           "fallbacks": fallbacks}
    emit("decode_migrate_fault", **res)
    return res


def summary(records, serve_launches, xd, train_vgg, train_lenet, lenet_pipe,
            gateway_fit, keras_vgg, train_keras_vgg, resnet_set, serve_resnet,
            train_resnet, functional, lstm, train_char, sample_char, flash,
            train_att, output_att, sample_att, textcnn, train_tc,
            transfer_paths, bf16, seq_bf16, engine_paths,
            decode_paths) -> dict:
    """One entry per kernel.  Conv: times, bounds and errors sum (max for
    the error) over the convs of one 32-row batch of each served model.
    Xent and dropout: the launches of one VGG16-224 training step (one
    xent at [128, 1000]; dropout forward and backward at [128, 25088] and
    [128, 4096]).  LSTM: one step at the char-RNN's (32, 200).  Flash: one
    launch at the attention model's (4, 8, 8192, 64), causal; each carries
    its 3xTF32 bound, the f32 CUDA-core bound beside it and HGMMA in its
    SASS; dq and dk/dv SDPA f32's backward, which computes the pair in one
    call.  ``launches`` counts every main path's run.  The conv entry
    carries beside it the summed set of ResNet-50's 46 stride-1 convs at
    batch 128 (``resnet50_128``) and of the text CNN's three full-width
    convs at D = 300 and 128 (``textcnn_300``, ``textcnn_128``).  The bf16
    forms have entries of their own: the conv's times, bound (bf16 FLOPs)
    and cuDNN bf16 over the same 32-row batches, with every timed set of
    ``bf16_kernels`` beside them; dropout's over VGG16-224's four launches
    in bf16, ``F.dropout`` on bf16 as the library call.  The bf16 forms
    of the lstm step (one step at (32, 200), 2-byte bytes) and of the flash
    kernels (at (4, 8, 8192, 64), causal: the one-pass bf16 bound, the
    split's work beside it, SDPA bf16, and the BF16 tensor-core
    instruction in the SASS: HGMMA for all three) likewise."""
    served = [s for m in ("lenet", "vgg16_cifar10")
              for s in conv_shapes(m, 32)]
    by_shape = {(tuple(r["shape"]), r["activation"]): r for r in records}
    rows = [by_shape[(tuple(s[:7]), s[7])] for s in served]
    t_ops = TF32_PRODUCTS_PER_F32 * sum(r["flops"] for r in rows) / \
        PEAK_TF32_FLOPS
    t_bytes = sum(r["bytes"] for r in rows) / PEAK_BYTES
    paths = {"serve": {"conv2d_bias_act": serve_launches},
             "train_vgg16_224": train_vgg["launches"],
             "train_lenet": train_lenet["launches"],
             "train_lenet_pipeline": lenet_pipe["launches"],
             "evaluate_lenet": lenet_pipe["evaluate"]["launches"],
             "gateway_fit": gateway_fit["launches"],
             "gateway_evaluate": gateway_fit["evaluate_launches"],
             "keras_vgg16_bn": keras_vgg["launches"],
             "train_keras_vgg16_bn": train_keras_vgg["launches"],
             "evaluate_keras_vgg16_bn":
                 train_keras_vgg["evaluate"]["launches"],
             "serve_resnet50": serve_resnet["launches"],
             "train_resnet50": train_resnet["launches"],
             "keras_functional": functional["launches"],
             "train_charrnn": train_char["launches"],
             "sample_charrnn": sample_char["launches"],
             "train_attention": train_att["launches"],
             "output_attention": output_att["launches"],
             "sample_attention": sample_att["launches"],
             "train_textcnn": train_tc["launches"],
             "evaluate_textcnn": train_tc["evaluate"]["launches"],
             **transfer_paths, **bf16["paths"], **seq_bf16["paths"],
             **engine_paths, **decode_paths}

    def launches(name):
        return sum(p.get(name, 0) for p in paths.values())

    def by_path(name):
        return {k: p.get(name, 0) for k, p in paths.items()}
    xent, xent_wide = xd["xent"][:2]
    drop = [r for r in xd["dropout"] if "ms" in r]   # forward + backward
    bk = bf16["kernels"]
    bsets = bk["sets"]
    bserved = [bsets[k] for k in ("lenet_32", "vgg16_cifar10_32")]
    bdrop = [r for r in bk["dropout"] if "ms" in r]
    sk = seq_bf16["kernels"]
    return {"kernels": [{
        "name": "conv2d_bias_act",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/conv_bias_act.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:577",
        "launches": launches("conv2d_bias_act"),
        "launches_by_path": by_path("conv2d_bias_act"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in records + textcnn["records"]),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_f32_simt_ms": sum(r["bound_f32_simt_ms"] for r in rows),
        "library_ms": sum(r["library_ms"] for r in rows),
        "library_tf32_ms": sum(r["library_tf32_ms"] for r in rows),
        "resnet50_128": {k: resnet_set[k] for k in (
            "convs", "ms", "plain_ms", "library_ms", "library_tf32_ms",
            "bound_ms", "bound_f32_simt_ms", "tflops", "share_of_bound")},
        **{name: {k: agg[k] for k in (
            "convs", "ms", "plain_ms", "library_ms", "library_tf32_ms",
            "bound_ms", "bound_f32_simt_ms", "tflops", "share_of_bound")
            + GRAPH_SUMS + ("graph_share_of_bound",)}
           for name, agg in textcnn["sets"].items()},
        "full_width_sass_hgmma": textcnn["sass_hgmma"],
    }, {
        "name": "softmax_xent",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/softmax_xent.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:466",
        "launches": launches("softmax_xent"),
        "launches_by_path": by_path("softmax_xent"),
        "max_abs_err": max(r["max_abs_err"] for r in xd["xent"]),
        "ms": xent["ms"], "plain_ms": xent["plain_ms"],
        "bound_ms": xent["bound_ms"], "bound_by": xent["bound_by"],
        "library_ms": xent["library_ms"],
        "empty_kernel_ms": xent["empty_kernel_ms"], "plan": xent["plan"],
        "wide": {k: xent_wide[k] for k in (
            "shape", "plan", "blocks", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "empty_kernel_ms")},
    }, {
        "name": "threshold_dropout",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/threshold_dropout.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:827",
        "launches": launches("threshold_dropout"),
        "launches_by_path": by_path("threshold_dropout"),
        "max_abs_err": max(r["max_abs_err"] for r in xd["dropout"]),
        "ms": sum(r["ms"] for r in drop),
        "plain_ms": sum(r["plain_ms"] for r in drop),
        "bound_ms": sum(r["bound_ms"] for r in drop),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in drop),
    }, {
        "name": "conv2d_bias_act_bf16",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/conv_bias_act.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:577",
        "launches": launches("conv2d_bias_act_bf16"),
        "launches_by_path": by_path("conv2d_bias_act_bf16"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in bk["records"] + bk["untimed"]),
        "ms": sum(a["ms"] for a in bserved),
        "plain_ms": sum(a["plain_ms"] for a in bserved),
        "bound_ms": sum(a["bound_ms"] for a in bserved),
        "bound_by": "operations" if sum(a["flops"] for a in bserved)
        / PEAK_BF16_FLOPS >= sum(a["bytes"] for a in bserved) / PEAK_BYTES
        else "bytes",
        "library_ms": sum(a["library_ms"] for a in bserved),
        "sets": bsets,
        "sass_bf16_hgmma": bk["sass_bf16_hgmma"],
        "gemm_sass_bf16_hgmma": bk["gemm_sass_bf16_hgmma"],
    }, {
        "name": "threshold_dropout_bf16",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/threshold_dropout.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:827",
        "launches": launches("threshold_dropout_bf16"),
        "launches_by_path": by_path("threshold_dropout_bf16"),
        "max_abs_err": max(r["max_abs_err"] for r in bk["dropout"]),
        "ms": sum(r["ms"] for r in bdrop),
        "plain_ms": sum(r["plain_ms"] for r in bdrop),
        "bound_ms": sum(r["bound_ms"] for r in bdrop),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in bdrop),
    }, {
        "name": "lstm_step",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_step.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:703",
        "launches": launches("lstm_step"),
        "launches_by_path": by_path("lstm_step"),
        "max_abs_err": max(r["max_abs_err"] for r in lstm["steps"]),
        "ms": lstm["steps"][0]["ms"], "plain_ms": lstm["steps"][0]["plain_ms"],
        "bound_ms": lstm["steps"][0]["bound_ms"],
        "bound_by": lstm["steps"][0]["bound_by"],
        "library_ms": None, "library_note": lstm["library_note"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:{line}",
        "launches": launches(name),
        "launches_by_path": by_path(name),
        "max_abs_err": max(c["max_abs_err"][e] for c in flash["checks"]
                           for e in errs),
        "ms": flash["timed"][name]["ms"],
        "plain_ms": flash["timed"][name]["plain_ms"],
        "bound_ms": flash["timed"][name]["bound_ms"],
        "bound_by": flash["timed"][name]["bound_by"],
        "library_ms": (flash["library_ms_forward"]
                       if name == "flash_forward" else None),
        "library_note": flash["library_note"],
        "bound_f32_simt_ms": flash["timed"][name]["bound_f32_simt_ms"],
        "sass_hgmma": flash["sass_hgmma"][name],
        **({} if name == "flash_forward" else {
            "library_ms_backward_pair": flash["library_ms_backward"]}),
    } for name, line, errs in (("flash_forward", 128, ("out", "lse")),
                               ("flash_dq", 238, ("dq",)),
                               ("flash_dkv", 274, ("dk", "dv")))] + [{
        "name": "lstm_step_bf16",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/lstm_step.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:703",
        "launches": launches("lstm_step_bf16"),
        "launches_by_path": by_path("lstm_step_bf16"),
        "max_abs_err": max(r["max_abs_err"] for r in sk["lstm_steps"]),
        "ms": sk["lstm_steps"][0]["ms"],
        "plain_ms": sk["lstm_steps"][0]["plain_ms"],
        "bound_ms": sk["lstm_steps"][0]["bound_ms"],
        "bound_by": sk["lstm_steps"][0]["bound_by"],
        "library_ms": None, "library_note": sk["lstm_library_note"],
    }] + [{
        "name": f"{name}_bf16",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"deeplearning4j_tpu/ops/pallas_kernels.py:{line}",
        "launches": launches(f"{name}_bf16"),
        "launches_by_path": by_path(f"{name}_bf16"),
        "max_abs_err": max(c["max_abs_err"][e] for c in sk["flash_checks"]
                           for e in errs if e in c["max_abs_err"]),
        "ms": sk["timed"][name]["ms"],
        "plain_ms": sk["timed"][name]["plain_ms"],
        "bound_ms": sk["timed"][name]["bound_ms"],
        "bound_by": sk["timed"][name]["bound_by"],
        "bound_split_ms": sk["timed"][name]["bound_split_ms"],
        "library_ms": (sk["library_ms_forward"]
                       if name == "flash_forward" else None),
        "library_note": sk["library_note"],
        "sass_bf16": sk["sass_bf16"][name],
        "sass_bf16_instruction": sk["sass_bf16_instruction"][name],
        **({} if name == "flash_forward" else {
            "library_ms_backward_pair": sk["library_ms_backward"]}),
    } for name, line, errs in (("flash_forward", 128, ("out", "lse")),
                               ("flash_dq", 238, ("dq",)),
                               ("flash_dkv", 274, ("dk", "dv")))]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    ck.build_libraries()
    emit("build", seconds=time.perf_counter() - t0, libraries={
        lib.path().name: {
            "nvcc_seconds": lib.build_seconds,
            "ptxas": [l.strip() for l in lib.build_log.splitlines()
                      if "registers" in l or "spill" in l],
            "serialized": serialized_wgmmas(lib)}
        for lib in ck.LIBRARIES})

    records = phase_kernels(torch, ck)
    xd = phase_xent_dropout_kernels(torch, ck)
    serve_launches = phase_serve(torch, ck)
    emit("models_vs_plain", max_abs=check_served_models_against_plain(
        torch, ck), rtol=NET_RTOL, atol=NET_ATOL)
    phase_vgg16_224(torch, ck)
    train_vgg = phase_train_vgg16_224(torch, ck)
    train_lenet = phase_train_lenet(torch, ck)
    lenet_pipe = phase_train_lenet_pipeline(torch, ck)
    gateway_fit = phase_gateway_fit_evaluate(torch, ck)
    keras_vgg = phase_keras_vgg16_bn(torch, ck)
    train_keras_vgg = phase_train_keras_vgg16_bn(torch, ck)
    phase_new_layers(torch, ck)
    resnet_records, resnet_set = phase_resnet50_kernels(torch, ck)
    serve_resnet = phase_serve_resnet50(torch, ck)
    train_resnet = phase_train_resnet50(torch, ck)
    transfer_vgg, net, data = phase_transfer_vgg16_224(torch, ck, train_vgg)
    featurize, helper, feats = phase_featurize_vgg16_224(torch, ck, net,
                                                         data)
    early_resume = phase_early_stop_and_resume(torch, ck, helper, feats)
    del net, data, helper, feats
    transfer_resnet = phase_transfer_resnet50(torch, ck, train_resnet)
    torch.cuda.empty_cache()
    bf16_kernels = phase_bf16_kernels(torch, ck)
    train_vgg_bf16 = phase_train_vgg16_224_bf16(torch, ck, train_vgg)
    torch.cuda.empty_cache()
    train_resnet_bf16 = phase_train_resnet50_bf16(torch, ck, train_resnet)
    torch.cuda.empty_cache()
    serve_bf16 = phase_serve_bf16(torch, ck)
    bf16 = {"kernels": bf16_kernels, "paths": {
        "train_vgg16_224_bf16": train_vgg_bf16["launches"],
        "train_resnet50_bf16": train_resnet_bf16["launches"],
        "output_bf16": serve_bf16["output_launches"],
        "serve_resnet50_bf16": serve_bf16["serve_resnet50"]["launches"]}}
    transfer_paths = {
        "transfer_vgg16_224": transfer_vgg["launches"],
        "featurize_vgg16_224": featurize["launches"],
        "early_stop_and_resume": early_resume["launches"],
        "transfer_resnet50": transfer_resnet["launches"]}
    functional = phase_keras_functional(torch, ck)
    lstm = phase_lstm_kernel(torch, ck)
    train_char, net, it = phase_train_charrnn(torch, ck)
    sample_char = phase_sample_charrnn(torch, ck, net, it)
    char_net, char_it = net, it          # the decode phases serve it
    del net
    flash = phase_flash_kernels(torch, ck)
    train_att, net, it = phase_train_attention(torch, ck)
    output_att = phase_output_attention(torch, ck, net, it)
    sample_att = phase_sample_attention(torch, ck, net, it)
    net.rnn_clear_previous_state()
    att_net, att_it = net, it
    del net
    torch.cuda.empty_cache()
    seq_kernels = phase_bf16_sequence_kernels(torch, ck)
    train_char_bf16, net, it = phase_train_charrnn_bf16(torch, ck,
                                                        train_char)
    sample_char_bf16 = phase_sample_charrnn_bf16(torch, ck, net, it)
    char_bf16_net = net
    del net
    torch.cuda.empty_cache()
    train_att_bf16, net, it = phase_train_attention_bf16(torch, ck,
                                                         train_att)
    output_att_bf16 = phase_output_attention_bf16(
        torch, ck, net, it, train_att_bf16.pop("initial_params"))
    sample_att_bf16 = phase_sample_attention_bf16(torch, ck, net, it)
    del net
    torch.cuda.empty_cache()
    seq_bf16 = {"kernels": seq_kernels, "paths": {
        "train_charrnn_bf16": train_char_bf16["launches"],
        "sample_charrnn_bf16": sample_char_bf16["launches"],
        "train_attention_bf16": train_att_bf16["launches"],
        "output_attention_bf16": output_att_bf16["launches"],
        "sample_attention_bf16": sample_att_bf16["launches"]}}
    phase_w2v_step(torch)
    _, w2v, sents, topic_of = phase_train_word2vec(torch)
    phase_embeddings_card_vs_cpu(torch)
    textcnn = phase_textcnn_kernels(torch, ck)
    train_tc = phase_train_textcnn(torch, ck, w2v, sents, topic_of)
    phase_cluster_tsne(torch, w2v, topic_of)
    phase_nearest_neighbors(torch, w2v)
    del w2v
    torch.cuda.empty_cache()
    fused = phase_fused_lenet(torch, ck)
    vae = phase_pretrain_vae(torch, ck)
    dbn = phase_pretrain_dbn(torch, ck)
    center = phase_center_loss_lenet(torch, ck)
    external = phase_external_gradients_vgg16_224(torch, ck)
    torch.cuda.empty_cache()
    dl4j_zip = phase_dl4j_zip_serve(torch, ck)
    torch.cuda.empty_cache()
    quantized = phase_serve_quantized(torch, ck)
    graph_char = phase_graph_tbptt_charrnn(torch, ck, train_char)
    torch.cuda.empty_cache()
    checkpointed = phase_checkpointed_vgg16_224(torch, ck)
    torch.cuda.empty_cache()
    bucketed = phase_bucketed_fit(torch, ck)
    torch.cuda.empty_cache()
    decode_char = phase_decode_charrnn(torch, ck, char_net, char_it,
                                       char_bf16_net)
    phase_decode_attention(torch, ck, att_net, att_it)
    torch.cuda.empty_cache()
    spec_decode = phase_spec_decode(torch, ck, char_net, char_it)
    migrate = phase_decode_migrate_fault(torch, ck, att_net, att_it,
                                         char_net, char_it)
    decode_paths = {"decode_charrnn": decode_char["launches"],
                    "decode_charrnn_bf16": decode_char["bf16"]["launches"],
                    "spec_decode": spec_decode["launches"],
                    "decode_migrate_fault": migrate["launches"]}
    engine_paths = {"fused_lenet": fused["launches"],
                    "pretrain_vae": vae["launches"],
                    "pretrain_dbn": dbn["launches"],
                    "center_loss_lenet": center["launches"],
                    "external_gradients_vgg16_224": external["launches"],
                    "dl4j_zip_serve": dl4j_zip["launches"],
                    "serve_quantized": quantized["launches"],
                    "graph_tbptt_charrnn": graph_char["launches"],
                    "checkpointed_vgg16_224": checkpointed["launches"],
                    "bucketed_fit": bucketed["launches"]}

    print(json.dumps(summary(records + resnet_records, serve_launches, xd,
                             train_vgg, train_lenet, lenet_pipe, gateway_fit,
                             keras_vgg, train_keras_vgg, resnet_set,
                             serve_resnet, train_resnet, functional, lstm,
                             train_char, sample_char, flash, train_att,
                             output_att, sample_att, textcnn, train_tc,
                             transfer_paths, bf16, seq_bf16, engine_paths,
                             decode_paths)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
