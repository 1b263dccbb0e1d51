"""Weight lookup table holding syn0 / syn1 / syn1neg on a device.

Mirrors the reference's ``InMemoryLookupTable`` (ref: models/embeddings/
inmemory/InMemoryLookupTable.java — syn0 init U(-0.5,0.5)/D per word2vec
convention, syn1 zeros for hierarchical softmax, syn1neg zeros lazily for
negative sampling, plus the unigram^0.75 negative-sampling distribution
from makeTable).  Tables are torch tensors on the table's device (CUDA
unless the caller passes ``device="cpu"``); syn0's initial values are
drawn with numpy from the seed, as the JAX package draws them, and then
moved.  The negative-sampling distribution is kept as a host-side cdf
sampled with ``np.searchsorted`` instead of the reference's 100M-entry
lookup table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.platform import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.text.vocab import AbstractCache

TABLES = ("syn0", "syn1", "syn1neg")


class InMemoryLookupTable:

    def __init__(self, vocab: AbstractCache, vector_length: int,
                 seed: int = 12345, use_hs: bool = True,
                 negative: float = 0.0, dtype=torch.float32,
                 device: DeviceLike = None):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.seed = int(seed)
        self.use_hs = bool(use_hs)
        self.negative = float(negative)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        self._neg_cdf: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, vocab: AbstractCache, syn0: np.ndarray,
                    syn1: Optional[np.ndarray] = None,
                    syn1neg: Optional[np.ndarray] = None, *,
                    device: DeviceLike = None, **kwargs
                    ) -> "InMemoryLookupTable":
        """A table holding the given host arrays (for example the JAX
        package's ``syn0``/``syn1``/``syn1neg``) on ``device``; ``kwargs``
        are the constructor's (seed, use_hs, negative)."""
        table = cls(vocab, np.shape(syn0)[1], device=device, **kwargs)
        for name, arr in zip(TABLES, (syn0, syn1, syn1neg)):
            if arr is not None:
                table.set_array(name, arr)
        return table

    def set_array(self, name: str, arr) -> None:
        """Copy a host array into table ``name`` on the table's device."""
        setattr(self, name, torch.tensor(np.asarray(arr), dtype=self.dtype,
                                         device=self.device))

    def array(self, name: str) -> Optional[np.ndarray]:
        """A host copy of table ``name`` (None when absent)."""
        t = getattr(self, name)
        return None if t is None else t.detach().to("cpu", copy=True).numpy()

    def reset_weights(self, reset: bool = True) -> None:
        v = self.vocab.num_words()
        d = self.vector_length
        if reset or self.syn0 is None:
            rng = np.random.default_rng(self.seed)
            # word2vec init: (rand - 0.5) / layer_size
            self.set_array(
                "syn0", (rng.random((v, d), dtype=np.float32) - 0.5) / d)
            # syn1 rows = inner Huffman nodes (v-1); keep >=1 row so the
            # steps' gathers stay shape-stable when HS is off.
            n_inner = max(v - 1, 1)
            self.syn1 = torch.zeros((n_inner if self.use_hs else 1, d),
                                    dtype=self.dtype, device=self.device)
            self.syn1neg = torch.zeros((v if self.negative > 0 else 1, d),
                                       dtype=self.dtype, device=self.device)

    # -- negative sampling -------------------------------------------------
    def neg_sampler(self) -> np.ndarray:
        """Cumulative unigram^0.75 distribution over vocab indices."""
        if self._neg_cdf is None:
            freqs = np.array(
                [max(e.element_frequency, 1.0)
                 for e in self.vocab.vocab_words()], np.float64) ** 0.75
            self._neg_cdf = np.cumsum(freqs / freqs.sum())
        return self._neg_cdf

    def sample_negatives(self, rng: np.random.Generator, shape) -> np.ndarray:
        cdf = self.neg_sampler()
        return np.searchsorted(cdf, rng.random(shape)).astype(np.int32)

    # -- vector access -----------------------------------------------------
    def vector(self, label: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(label)
        if idx < 0 or self.syn0 is None:
            return None
        return self.syn0[idx].detach().to("cpu", copy=True).numpy()

    def get_weights(self) -> np.ndarray:
        return self.array("syn0")

    def set_weights(self, w) -> None:
        self.set_array("syn0", w)
