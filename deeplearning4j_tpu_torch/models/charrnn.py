"""GravesLSTM character RNN — the port of ``deeplearning4j_tpu/models/charrnn.py``
(dl4j-examples' GravesLSTMCharModellingExample: 2 x GravesLSTM(200) +
RnnOutputLayer with softmax/mcxent, RMSProp, truncated BPTT of 50 both
ways).  ``CharacterIterator`` and ``sample_text`` are copies that draw
with numpy, so the same seeds give the same batches and the same sampled
text in both packages."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.platform import DeviceLike


def char_rnn(vocab_size: int, hidden: int = 200, layers: int = 2,
             learning_rate: float = 0.1, tbptt_length: int = 50,
             seed: int = 12345, device: DeviceLike = None
             ) -> MultiLayerNetwork:
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .learning_rate(learning_rate)
         .updater("rmsprop")
         .weight_init("xavier")
         .list())
    n_in = vocab_size
    for _ in range(layers):
        b.layer(GravesLSTM(n_in=n_in, n_out=hidden, activation="tanh"))
        n_in = hidden
    b.layer(RnnOutputLayer(n_in=hidden, n_out=vocab_size,
                           activation="softmax", loss="mcxent"))
    conf = (b.backprop_type("truncatedbptt")
            .t_bptt_forward_length(tbptt_length)
            .t_bptt_backward_length(tbptt_length)
            .build())
    return MultiLayerNetwork(conf, device=device)


class CharacterIterator(DataSetIterator):
    """Text -> one-hot character sequences [batch, seq_length, vocab]
    (features) and the same sequences one character later (labels), from
    random start offsets drawn by a seeded numpy generator
    (ref: dl4j-examples CharacterIterator)."""

    def __init__(self, text: str, seq_length: int = 100, batch: int = 32,
                 seed: int = 0):
        chars = sorted(set(text))
        self.char_to_idx = {c: i for i, c in enumerate(chars)}
        self.idx_to_char = {i: c for i, c in enumerate(chars)}
        self.vocab_size = len(chars)
        self.seq_length = seq_length
        self.batch = batch
        self.data = np.asarray([self.char_to_idx[c] for c in text], np.int32)
        self._rng = np.random.default_rng(seed)
        self.n_batches_per_epoch = max(
            1, (len(self.data) - seq_length - 1) // (batch * seq_length))
        self._count = 0

    def next(self) -> DataSet:
        starts = self._rng.integers(0, len(self.data) - self.seq_length - 1,
                                    self.batch)
        xs = np.stack([self.data[s:s + self.seq_length] for s in starts])
        ys = np.stack([self.data[s + 1:s + self.seq_length + 1]
                       for s in starts])
        eye = np.eye(self.vocab_size, dtype=np.float32)
        self._count += 1
        return DataSet(eye[xs], eye[ys])

    def has_next(self) -> bool:
        return self._count < self.n_batches_per_epoch

    def reset(self) -> None:
        self._count = 0

    def batch_size(self) -> int:
        return self.batch


def sample_text(net: MultiLayerNetwork, iterator: CharacterIterator,
                seed_text: str, length: int = 200,
                temperature: float = 1.0, rng_seed: int = 0) -> str:
    """Sample ``length`` characters after ``seed_text``, one
    ``rnn_time_step`` per character, drawing each from the softmax output
    with a seeded numpy generator (ref: dl4j-examples
    sampleCharactersFromNetwork)."""
    rng = np.random.default_rng(rng_seed)
    eye = np.eye(iterator.vocab_size, dtype=np.float32)
    net.rnn_clear_previous_state()
    idxs = [iterator.char_to_idx[c] for c in seed_text]
    x = eye[np.asarray(idxs)][None]                    # [1, T, V]
    out = net.rnn_time_step(x).cpu().numpy()[0, -1]
    result = list(seed_text)
    for _ in range(length):
        logits = np.log(np.maximum(out, 1e-9)) / temperature
        p = np.exp(logits - logits.max())
        p /= p.sum()
        nxt = int(rng.choice(iterator.vocab_size, p=p))
        result.append(iterator.idx_to_char[nxt])
        out = net.rnn_time_step(
            eye[np.asarray([nxt])][None]).cpu().numpy()[0, -1]
    return "".join(result)
