"""ParagraphVectors (doc2vec) — PV-DM / PV-DBOW.

Mirrors the reference (ref: models/paragraphvectors/ParagraphVectors.java
— label-aware sequences trained with learning/impl/sequence/{DBOW,DM}.java;
``inferVector`` trains a fresh vector against frozen tables).  Document
labels live in the same lookup table as words, exactly as the reference
stores labels in the shared vocab/lookup.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.embeddings import kernels
from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    VectorsConfiguration, step_branches, to_device)
from deeplearning4j_tpu_torch.embeddings.word2vec import Word2Vec
from deeplearning4j_tpu_torch.ops.platform import DeviceLike
from deeplearning4j_tpu_torch.text.sequence import Sequence, VocabWord
from deeplearning4j_tpu_torch.text.sentence_iterators import (
    LabelAwareSentenceIterator, LabelsSource, SentenceIterator)
from deeplearning4j_tpu_torch.text.tokenization import TokenizerFactory


class _LabelledSource:
    """Attach labels (explicit or generated) to tokenized sentences."""

    def __init__(self, sentences: SentenceIterator, tf: TokenizerFactory,
                 labels_source: LabelsSource):
        self.sentences = sentences
        self.tf = tf
        self.labels_source = labels_source

    def __iter__(self):
        self.sentences.reset()
        self.labels_source.reset()
        label_aware = isinstance(self.sentences, LabelAwareSentenceIterator)
        while self.sentences.has_next():
            sentence = self.sentences.next_sentence()
            seq = Sequence()
            for tok in self.tf.create(sentence).get_tokens():
                if tok:
                    seq.add_element(VocabWord(tok))
            if label_aware:
                label = self.sentences.current_label()
                self.labels_source.store_label(label)
            else:
                label = self.labels_source.next_label()
            lbl = VocabWord(label)
            lbl.special = True
            seq.set_sequence_label(lbl)
            yield seq


class ParagraphVectors(Word2Vec):

    def __init__(self, conf: Optional[VectorsConfiguration] = None,
                 device: DeviceLike = None):
        conf = conf or VectorsConfiguration()
        conf.train_sequences = True
        super().__init__(conf, device=device)
        self.labels_source = LabelsSource()

    class Builder(Word2Vec.Builder):
        def __init__(self, configuration: Optional[VectorsConfiguration] = None):
            super().__init__(configuration)
            self._labels_source = LabelsSource()
            # PV-DM is the reference default sequence algorithm
            self.conf.sequence_learning_algorithm = "DM"
            self.conf.train_sequences = True

        def labels_source(self, source: LabelsSource):
            self._labels_source = source
            return self

        def labels(self, labels: List[str]):
            self._labels_source = LabelsSource(labels=labels)
            return self

        def train_word_vectors(self, b: bool):
            self.conf.train_elements = b
            return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(self.conf, device=self._device)
            pv.labels_source = self._labels_source
            if self._sentences is not None:
                pv._sequence_source = _LabelledSource(
                    self._sentences, self._tf, self._labels_source)
            else:
                pv._sequence_source = self._source
            pv.vocab = self._vocab
            return pv

    # -- inference ---------------------------------------------------------
    def infer_vector(self, text_or_tokens, steps: int = 10,
                     learning_rate: float = 0.01) -> np.ndarray:
        """Train a fresh doc vector against the frozen tables
        (ref: ParagraphVectors.inferVector → SkipGram.iterateSample with
        isInference=true updating only inferenceVector)."""
        if isinstance(text_or_tokens, str):
            from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
            tokens = DefaultTokenizerFactory().create(text_or_tokens).get_tokens()
        else:
            tokens = list(text_or_tokens)
        ids = [self.vocab.index_of(t) for t in tokens]
        ids = np.array([i for i in ids if i >= 0], np.int32)
        D = self.conf.layer_size
        rng = np.random.default_rng(self.conf.seed)
        vec0 = (rng.random((1, D), dtype=np.float32) - 0.5) / D
        if ids.size == 0:
            return vec0[0]

        # Every step's (1-row) arrays are drawn first, in the JAX
        # package's order of draws, and copied to the device at once.
        points_m, codes_m, cmask_m = self._code_matrices()
        t = self.lookup_table
        K = max(self.conf.negative, 0) + 1
        centers = np.tile(ids, steps)
        n = centers.size
        cmask = (cmask_m[centers] if self.conf.use_hierarchic_softmax
                 else np.zeros_like(cmask_m[centers]))
        nidx = np.zeros((n, K), np.int32)
        nidx[:, 0] = centers
        nlab = np.zeros((n, K), np.float32)
        nlab[:, 0] = 1.0
        nmask = np.zeros((n, K), np.float32)
        if self.conf.negative > 0:
            for i, center in enumerate(centers):
                negs = t.sample_negatives(rng, (1, K - 1))
                nidx[i, 1:] = negs
                nmask[i] = 1.0
                nmask[i, 1:] = (negs != center).astype(np.float32)
        vec, pts, codes, cm, ni, nl, nm, lr = to_device(
            t.device, vec0, points_m[centers], codes_m[centers], cmask,
            nidx, nlab, nmask, np.array([learning_rate], np.float32))
        branches = step_branches(self.conf)
        for i in range(n):
            s = slice(i, i + 1)
            kernels.infer_step(vec, t.syn1, t.syn1neg, pts[s], codes[s],
                               cm[s], ni[s], nl[s], nm[s], lr, **branches)
        return vec[0].to("cpu", copy=True).numpy()

    # -- label queries ------------------------------------------------------
    def nearest_labels(self, text_or_vec, top: int = 5) -> List[str]:
        if isinstance(text_or_vec, (str, list)):
            vec = self.infer_vector(text_or_vec)
        else:
            vec = np.asarray(text_or_vec)
        labels = [l for l in self.labels_source.get_labels()
                  if self.vocab.contains_word(l)]
        if not labels:
            return []
        table = np.stack([self.word_vector(l) for l in labels])
        table = table / np.maximum(
            np.linalg.norm(table, axis=1, keepdims=True), 1e-12)
        v = vec / max(np.linalg.norm(vec), 1e-12)
        order = np.argsort(-(table @ v))[:top]
        return [labels[i] for i in order]

    def similarity_to_label(self, text_or_vec, label: str) -> float:
        if isinstance(text_or_vec, (str, list)):
            vec = self.infer_vector(text_or_vec)
        else:
            vec = np.asarray(text_or_vec)
        lv = self.word_vector(label)
        if lv is None:
            return float("nan")
        return float(np.dot(vec, lv) /
                     max(np.linalg.norm(vec) * np.linalg.norm(lv), 1e-12))


ParagraphVectors.Builder._vectors_cls = ParagraphVectors
