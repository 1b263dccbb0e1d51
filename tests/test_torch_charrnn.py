"""The port's recurrent network — the GravesLSTM char-RNN, masks, truncated
BPTT, ``rnn_time_step`` and the recurrent layers, preprocessors and zip —
held against the JAX package on the CPU.

The char-RNN here is ``char_rnn`` cut to a small size: 2 x GravesLSTM(16),
a vocabulary of 12 characters, TBPTT segments of 5 over sequences of 20.
Both packages start from the same params, drawn with numpy (peepholes
included, which the recipe initialises to zero), and take the same
batches: ``CharacterIterator`` draws them with numpy in both.  Where the
JAX side runs forward only, its Pallas LSTM step is forced
(``DL4J_PALLAS_LSTM=1``, interpret mode); its training steps run its
composable cell, which the JAX suite holds to its kernel at 1e-5.

Tolerances, float32 on both sides with sums in other orders:
* forwards, losses and gradients: rtol = atol = 1e-5, the JAX suite's
  tolerance for its LSTM kernel, over up to 20 steps of recurrence;
* params after 2 minibatches of TBPTT ``fit`` (8 RMSProp updates at the
  recipe's lr 0.1): for every param tensor, the 2-norm of the difference
  from JAX's over the 2-norm of how far JAX's moved from the start, at
  most 1e-2; the RMSProp state ``g2`` the same, relative to its own norm;
  the scores after each minibatch at rtol 1e-3.  RMSProp divides a
  gradient by its running magnitude with eps = 1e-8, so near g = 0 it
  turns a gradient difference into an update difference up to
  lr/sqrt(eps) = 1000 times larger, and every later segment starts from
  the differing weights: the first segment's gradients agree to float32
  rounding, yet after 8 updates single elements differ by far more than
  rtol 1e-4, and an elementwise rule would measure that amplification.  The rule still tells a right step
  from a wrong one: training that drops the carried state or cuts
  segments of the wrong length misses it by more than 30x
  (``test_tbptt_parity_rule_catches_a_wrong_step``).
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
import deeplearning4j_tpu.nn.conf.preprocessors as jax_pp
from deeplearning4j_tpu.models import charrnn as jax_charrnn
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import losses as jax_losses
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models import charrnn
from deeplearning4j_tpu_torch.nn import convert
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import losses

TOL = 1e-5
FIT_REL_NORM, FIT_SCORE_RTOL = 1e-2, 1e-3
HIDDEN, LAYERS, TBPTT, SEQ, BATCH = 16, 2, 5, 20, 4
TEXT = "".join(np.random.default_rng(0).choice(list("abcdefghij .\n"[:12]),
                                               size=800))
V = len(set(TEXT))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread, as in the training
    parity tests: multi-threaded float32 reductions have been seen to vary
    from run to run on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(template, seed):
    """Params drawn with numpy for the shapes of a JAX network."""
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=np.shape(v)) * (
        0.3 if np.ndim(v) == 2 else 0.1)).astype(np.float32)
        for k, v in lp.items()} for lp in template]


def _jax_char_rnn(seed=3):
    jnet = jax_charrnn.char_rnn(V, HIDDEN, LAYERS, tbptt_length=TBPTT)
    jnet.init()
    return jnet.init(params=[{k: jnp.asarray(v) for k, v in lp.items()}
                             for lp in _numpy_params(jnet.net_params, seed)])


def _pair(tmp_path, seed=3):
    """A JAX char-RNN and the port's, restored from the JAX zip."""
    jnet = _jax_char_rnn(seed)
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    return jnet, ser.restore_multi_layer_network(tmp_path / "jax.zip",
                                                 device="cpu")


def _batch(seed=0, masked=False):
    ds = charrnn.CharacterIterator(TEXT, SEQ, BATCH, seed=seed).next()
    if not masked:
        return ds.features, ds.labels, None
    lens = np.random.default_rng(seed).integers(3, SEQ + 1, BATCH)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.float32)
    return ds.features, ds.labels, mask


def _np(t):
    return t.detach().cpu().numpy()


def _counter(name, op):
    fam = monitor.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam.samples() if s["labels"]["op"] == op)


def _rel_norm(got, want, ref):
    """||got - want|| / ||want - ref|| (2-norms)."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - ref))


def test_char_rnn_configuration_and_zip_round_trip_both_ways(tmp_path):
    """Both builders give the same configuration JSON; a JAX-written zip
    restores in the port with the same param shapes and rewrites to the
    same ``coefficients.bin``; the port's zip restores in JAX, which
    rewrites it byte for byte too."""
    port = charrnn.char_rnn(V, HIDDEN, LAYERS, tbptt_length=TBPTT,
                            device="cpu")
    jnet, net = _pair(tmp_path)
    assert port.conf.to_dict() == jnet.conf.to_dict() == net.conf.to_dict()
    assert net.conf.backprop_type == "truncatedbptt"
    assert [{k: tuple(v.shape) for k, v in lp.items()}
            for lp in net.net_params] == \
        [{k: tuple(v.shape) for k, v in lp.items()} for lp in jnet.net_params]
    ser.write_model(net, tmp_path / "port.zip")
    back = jax_ser.restore_multi_layer_network(tmp_path / "port.zip")
    jax_ser.write_model(back, tmp_path / "back.zip")
    with zipfile.ZipFile(tmp_path / "jax.zip") as a, \
            zipfile.ZipFile(tmp_path / "port.zip") as b, \
            zipfile.ZipFile(tmp_path / "back.zip") as c:
        assert a.read(ser.COEFFICIENTS_NAME) == \
            b.read(ser.COEFFICIENTS_NAME) == c.read(ser.COEFFICIENTS_NAME)
        assert json.loads(b.read(ser.CONFIG_NAME)) == \
            json.loads(a.read(ser.CONFIG_NAME))
    # the recipe's own init: forget-gate block of b at 1, peepholes at 0
    fresh = charrnn.char_rnn(V, HIDDEN, LAYERS, device="cpu").init()
    b0 = fresh.net_params[0]["b"]
    assert torch.equal(b0[HIDDEN:2 * HIDDEN], torch.ones(HIDDEN))
    assert float(b0[:HIDDEN].abs().sum() + b0[2 * HIDDEN:].abs().sum()) == 0
    assert float(fresh.net_params[1]["pO"].abs().sum()) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_output_matches_jax(masked, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    jnet, net = _pair(tmp_path)
    x, _, mask = _batch(masked=masked)
    want = np.asarray(jnet.output(x, mask=mask))
    got = _np(net.output(x, mask=mask))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if masked:     # the LSTMs output zeros on masked steps: softmax(b)
        row = _np(torch.softmax(net.net_params[-1]["b"], 0))
        np.testing.assert_allclose(got[mask == 0], np.broadcast_to(
            row, got[mask == 0].shape), rtol=TOL, atol=1e-6)


def _bidir_conf(layers, net, input_type):
    return (net.NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("rmsprop").list()
            .layer(layers.GravesBidirectionalLSTM(n_out=8, activation="tanh"))
            .layer(layers.LastTimeStepLayer())
            .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(input_type.recurrent(V, SEQ)).build())


@pytest.mark.parametrize("masked", [False, True])
def test_bidirectional_last_time_step_net_matches_jax(masked, monkeypatch):
    """GravesBidirectionalLSTM (the two directions summed, the backward
    one masked in reversed time) into LastTimeStepLayer (the last unmasked
    step) and a dense softmax head: output, score and every param's
    gradient."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    conf = _bidir_conf(L, network, InputType)
    jconf = _bidir_conf(jax_layers, jax_network, JaxInputType)
    assert conf.to_dict() == jconf.to_dict()
    jnet = JaxNet(jconf).init()
    params = _numpy_params(jnet.net_params, seed=8)
    jnet.init(params=[{k: jnp.asarray(v) for k, v in lp.items()}
                      for lp in params])
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.load_jax_params(params)
    assert sorted(net.net_params[0]) == sorted(
        f"{d}_{k}" for d in "fb" for k in ("W", "RW", "b", "pI", "pF", "pO"))
    x, _, mask = _batch(seed=2, masked=masked)
    y = np.eye(3, dtype=np.float32)[np.arange(BATCH) % 3]
    np.testing.assert_allclose(_np(net.output(x, mask=mask)),
                               np.asarray(jnet.output(x, mask=mask)),
                               rtol=TOL, atol=TOL)
    jm = None if mask is None else jnp.asarray(mask)
    jscore, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(x), jnp.asarray(y), jm,
        None, jax.random.PRNGKey(0))
    score, grads = net._grad_step(torch.from_numpy(x), torch.from_numpy(y),
                                  None if mask is None
                                  else torch.from_numpy(mask), None, None)
    np.testing.assert_allclose(float(score), float(jscore), rtol=TOL)
    for gl, jl in zip(grads, jgrads):
        assert sorted(gl) == sorted(jl)
        for k in jl:
            np.testing.assert_allclose(_np(gl[k]), np.asarray(jl[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


def _ff_between_conf(layers, net, input_type, preprocs):
    return (net.NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("sgd").list()
            .layer(layers.GravesLSTM(n_out=8, activation="tanh"))
            .layer(layers.DenseLayer(n_out=6, activation="tanh"))
            .layer(layers.RnnOutputLayer(n_out=V, activation="softmax",
                                         loss="mcxent"))
            .input_pre_processor(
                2, preprocs.FeedForwardToRnnPreProcessor(timesteps=SEQ))
            .set_input_type(input_type.recurrent(V, SEQ)).build())


def test_builder_inserts_rnn_adapters_and_masks_follow(monkeypatch):
    """A dense layer between recurrent ones: both builders insert
    RnnToFeedForward before it (the FeedForwardToRnn after it is given,
    since a dense layer's output type forgets T in both packages); the
    mask goes [N, T] -> [N·T] -> [N, T] with the activations, and output,
    score and gradients agree with JAX's."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    conf = _ff_between_conf(L, network, InputType, pp)
    jconf = _ff_between_conf(jax_layers, jax_network, JaxInputType, jax_pp)
    assert conf.to_dict() == jconf.to_dict()
    assert [type(conf.preprocessors[i]).__name__ for i in (1, 2)] == \
        ["RnnToFeedForwardPreProcessor", "FeedForwardToRnnPreProcessor"]
    assert conf.preprocessors[2].timesteps == SEQ
    jnet = JaxNet(jconf).init()
    params = _numpy_params(jnet.net_params, seed=4)
    jnet.init(params=[{k: jnp.asarray(v) for k, v in lp.items()}
                      for lp in params])
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.load_jax_params(params)
    x, y, mask = _batch(seed=3, masked=True)
    xm, m = conf.preprocessors[1](torch.zeros(BATCH, SEQ, 8),
                                  torch.from_numpy(mask))
    assert xm.shape == (BATCH * SEQ, 8) and m.shape == (BATCH * SEQ,)
    np.testing.assert_allclose(_np(net.output(x, mask=mask)),
                               np.asarray(jnet.output(x, mask=mask)),
                               rtol=TOL, atol=TOL)
    jscore, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mask), None, jax.random.PRNGKey(0))
    score, grads = net._grad_step(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(mask), None, None)
    np.testing.assert_allclose(float(score), float(jscore), rtol=TOL)
    for gl, jl in zip(grads, jgrads):
        for k in jl:
            np.testing.assert_allclose(_np(gl[k]), np.asarray(jl[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("vocab,fused", [(V, False), (128, True)])
def test_rnn_output_score_with_time_mask_matches_jax(vocab, fused,
                                                     monkeypatch):
    """``RnnOutputLayer.compute_score`` on [N, T, C] with a [N, T] mask (the
    loss gets mask[..., None]) against JAX's.  The xent gate counts N·T
    rows: at V = 128 and N·T = 512 it passes (rows·vocab = 65,536)."""
    monkeypatch.setenv("DL4J_PALLAS_XENT", "1" if fused else "0")
    N, T = 4, 128
    rng = np.random.default_rng(vocab)
    preout = (rng.normal(size=(N, T, vocab)) * 2).astype(np.float32)
    labels = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (N, T))]
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    layer = L.RnnOutputLayer(n_out=vocab, activation="softmax",
                             loss="mcxent")
    jlayer = jax_layers.RnnOutputLayer(n_out=vocab, activation="softmax",
                                       loss="mcxent")
    sel = _counter("dl4j_kernel_selected_total", "softmax_xent")
    got = layer.compute_score(torch.from_numpy(labels),
                              torch.from_numpy(preout), torch.from_numpy(mask))
    want = jlayer.compute_score(jnp.asarray(labels), jnp.asarray(preout),
                                jnp.asarray(mask))
    assert got.shape == (N,)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL)
    assert _counter("dl4j_kernel_selected_total", "softmax_xent") == \
        sel + fused
    dense = losses.mcxent(torch.from_numpy(labels), torch.from_numpy(preout),
                          "softmax", torch.from_numpy(mask)[..., None])
    np.testing.assert_allclose(_np(dense), np.asarray(jax_losses.mcxent(
        jnp.asarray(labels), jnp.asarray(preout), "softmax",
        jnp.asarray(mask)[..., None])), rtol=TOL)


@pytest.fixture(scope="module")
def jax_tbptt(tmp_path_factory):
    """The JAX char-RNN's zip before training, and the network after two
    TBPTT minibatches from it (computed once for the tests below)."""
    path = tmp_path_factory.mktemp("tbptt") / "jax.zip"
    jnet = _jax_char_rnn(seed=6)
    jax_ser.write_model(jnet, path)
    jit = jax_charrnn.CharacterIterator(TEXT, SEQ, BATCH, seed=1)
    scores = []
    for _ in range(2):
        jnet.fit(jit.next())
        scores.append(float(jnet.score()))
    return path, jnet, scores


def _port_tbptt(path, broken=None):
    """The port restored from ``path`` after the same two minibatches;
    ``broken`` trains it wrongly on purpose: 'no_carry' drops the state
    between segments, 'segment_4' cuts segments of 4 steps."""
    net = ser.restore_multi_layer_network(path, device="cpu")
    start = [{k: _np(v).copy() for k, v in lp.items()}
             for lp in net.net_params]
    if broken == "no_carry":
        grad_step = net._grad_step

        def fresh_state_step(*args):
            net.rnn_clear_previous_state()
            return grad_step(*args)
        net._grad_step = fresh_state_step
    elif broken == "segment_4":
        net.conf.tbptt_fwd_length = 4
    it = charrnn.CharacterIterator(TEXT, SEQ, BATCH, seed=1)
    scores = []
    for _ in range(2):
        net.fit(it.next())
        scores.append(net.score())
    return net, start, scores


def _tbptt_errors(net, start, jnet):
    """(largest per-param relative 2-norm error, ``g2``'s) against JAX."""
    worst = 0.0
    for i, (lp, jp) in enumerate(zip(net.net_params, jnet.net_params)):
        assert sorted(lp) == sorted(jp)
        for k in jp:
            worst = max(worst, _rel_norm(_np(lp[k]), np.asarray(jp[k]),
                                         start[i][k]))
    return worst, _rel_norm(_np(net.updater_state_flat()),
                            np.asarray(jnet.updater_state_flat()), 0.0)


def test_tbptt_fit_matches_jax(jax_tbptt, tmp_path):
    """Two minibatches of ``fit`` under truncated BPTT (4 segments of 5
    steps each, RMSProp): the same iterations, scores and params as JAX,
    and the updater state carried over by ``opt_states_from_jax`` and by
    the zip is JAX's to the byte."""
    path, jnet, jscores = jax_tbptt
    net, start, scores = _port_tbptt(path)
    np.testing.assert_allclose(scores, jscores, rtol=FIT_SCORE_RTOL)
    assert net.iteration == jnet.iteration == 2 * SEQ // TBPTT
    params_err, g2_err = _tbptt_errors(net, start, jnet)
    assert params_err <= FIT_REL_NORM and g2_err <= FIT_REL_NORM
    # the state carried between segments is cut from the graph
    for s in net.net_state[:LAYERS]:
        c, h = s["rnn_state"]
        assert c.grad_fn is None and h.grad_fn is None
    carried = convert.opt_states_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.opt_states), device="cpu")
    assert sorted(carried[0]) == ["g2"]
    net.opt_states = carried
    np.testing.assert_array_equal(_np(net.updater_state_flat()),
                                  np.asarray(jnet.updater_state_flat()))
    jax_ser.write_model(jnet, tmp_path / "fit.zip")
    restored = ser.restore_multi_layer_network(tmp_path / "fit.zip",
                                               device="cpu")
    ser.write_model(restored, tmp_path / "refit.zip")
    with zipfile.ZipFile(tmp_path / "fit.zip") as a, \
            zipfile.ZipFile(tmp_path / "refit.zip") as b:
        for name in (ser.COEFFICIENTS_NAME, ser.UPDATER_NAME):
            assert a.read(name) == b.read(name)


@pytest.mark.parametrize("broken", ["no_carry", "segment_4"])
def test_tbptt_parity_rule_catches_a_wrong_step(jax_tbptt, broken):
    """The relative-norm rule is not vacuous: training that drops the
    carried state, or cuts segments of the wrong length, misses it by
    more than 30x in the params and in ``g2``."""
    path, jnet, _ = jax_tbptt
    params_err, g2_err = _tbptt_errors(*_port_tbptt(path, broken)[:2], jnet)
    assert params_err > 30 * FIT_REL_NORM and g2_err > 30 * FIT_REL_NORM


def test_tbptt_clears_state_per_batch_and_standard_fit_strips_it(tmp_path):
    """Each TBPTT minibatch starts from zero state: fitting the same batch
    from the same params gives the same result whatever ran before.  A
    standard step drops the carry after it, as JAX's does."""
    _, net = _pair(tmp_path)
    x, y, _ = _batch(seed=4)
    other, _, _ = _batch(seed=5)
    before = [{k: v.clone() for k, v in lp.items()} for lp in net.net_params]
    net.rnn_time_step(other)                 # leaves a carry behind
    assert "rnn_state" in net.net_state[0]
    net.fit(x, y)
    after_dirty = net.params().clone()
    net.net_params = before
    net.opt_states = None
    net.rnn_clear_previous_state()
    assert all("rnn_state" not in s for s in net.net_state)
    net.fit(x, y)
    assert torch.equal(net.params(), after_dirty)
    std = MultiLayerNetwork(network.MultiLayerConfiguration.from_dict(
        {**net.conf.to_dict(), "backprop_type": "standard"}),
        device="cpu").init()
    std.fit(x, y)
    assert std.iteration == 1
    assert all("rnn_state" not in s for s in std.net_state)


def test_rnn_time_step_char_by_char_equals_output(tmp_path, monkeypatch):
    """Fed one character at a time, and in two uneven chunks,
    ``rnn_time_step`` carries state so that its outputs equal ``output()``
    on the whole sequence, and JAX's."""
    monkeypatch.setenv("DL4J_PALLAS_LSTM", "1")
    jnet, net = _pair(tmp_path)
    x, _, _ = _batch(seed=7)
    want = _np(net.output(x))
    np.testing.assert_allclose(want, np.asarray(jnet.output(x)), rtol=TOL,
                               atol=TOL)
    net.rnn_clear_previous_state()
    steps = np.concatenate([_np(net.rnn_time_step(x[:, t:t + 1]))
                            for t in range(SEQ)], axis=1)
    np.testing.assert_allclose(steps, want, rtol=TOL, atol=TOL)
    net.rnn_clear_previous_state()
    chunks = np.concatenate([_np(net.rnn_time_step(x[:, :7])),
                             _np(net.rnn_time_step(x[:, 7:]))], axis=1)
    np.testing.assert_allclose(chunks, want, rtol=TOL, atol=TOL)
    jnet.rnn_clear_previous_state()
    jsteps = np.concatenate([np.asarray(jnet.rnn_time_step(x[:, t:t + 1]))
                             for t in range(SEQ)], axis=1)
    np.testing.assert_allclose(steps, jsteps, rtol=TOL, atol=TOL)


def test_sample_text_matches_jax(tmp_path):
    """The same params and ``rng_seed`` pick the same string."""
    jnet, net = _pair(tmp_path, seed=9)
    it = charrnn.CharacterIterator(TEXT, SEQ, BATCH)
    jit = jax_charrnn.CharacterIterator(TEXT, SEQ, BATCH)
    got = charrnn.sample_text(net, it, "ab c", length=40, rng_seed=5)
    want = jax_charrnn.sample_text(jnet, jit, "ab c", length=40, rng_seed=5)
    assert got == want and len(got) == 44
    assert got != charrnn.sample_text(net, it, "ab c", length=40, rng_seed=6)


def test_char_rnn_runs_on_cuda_unless_asked_for_the_cpu():
    """Without a device argument the network is built for the CUDA
    device, which raises when there is none."""
    if torch.cuda.is_available():
        assert charrnn.char_rnn(V).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            charrnn.char_rnn(V)
    assert ck.fused_lstm_step.launches == 0 or torch.cuda.is_available()
