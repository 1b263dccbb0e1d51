"""Causal self-attention language model — the net of the JAX package's
``examples/long_context_attention.py`` (``SelfAttentionLayer(causal=True)``
into an ``RnnOutputLayer`` with softmax/mcxent, Adam at lr 0.05, seed 7) at
the long-context target of its flash-attention tests: context 8,192 and
head dim 64.  By default 2 x ``SelfAttentionLayer(n_out=512, n_heads=8)``;
with a vocabulary of 107 characters that is 1,534,059 params.  Characters
come from ``models/charrnn.CharacterIterator``; sampling goes through
``rnn_time_step`` (the KV ring) and ``charrnn.sample_text``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (RnnOutputLayer,
                                                     SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.platform import DeviceLike


def attention_lm(vocab_size: int, width: int = 512, n_heads: int = 8,
                 layers: int = 2, seq_len: int = 8192,
                 learning_rate: float = 0.05, seed: int = 7,
                 device: DeviceLike = None) -> MultiLayerNetwork:
    b = (NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(learning_rate).updater("adam")
         .list())
    for _ in range(layers):
        b.layer(SelfAttentionLayer(n_out=width, n_heads=n_heads,
                                   causal=True))
    b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                           loss="mcxent"))
    conf = b.set_input_type(InputType.recurrent(vocab_size, seq_len)).build()
    return MultiLayerNetwork(conf, device=device)
