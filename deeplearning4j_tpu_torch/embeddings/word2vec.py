"""Word2Vec — SequenceVectors over tokenized sentences.

Mirrors the reference's builder surface (ref: models/word2vec/
Word2Vec.java:32 — Builder.iterate(SentenceIterator) + tokenizerFactory,
inherited SequenceVectors hyperparameters).  Sentences are tokenized
lazily into ``Sequence`` streams; vocab filtering/stopwords happen here.
"""

from __future__ import annotations

from typing import Iterable, Optional

from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    SequenceVectors, VectorsConfiguration)
from deeplearning4j_tpu_torch.text.sequence import Sequence, VocabWord
from deeplearning4j_tpu_torch.text.sentence_iterators import SentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory)


class _SentenceSequenceSource:
    """Re-iterable sentence→Sequence adapter (ref: Word2Vec Builder wires a
    SentenceTransformer over the iterator)."""

    def __init__(self, sentences: SentenceIterator,
                 tokenizer_factory: TokenizerFactory,
                 stop_words: Optional[set] = None):
        self.sentences = sentences
        self.tf = tokenizer_factory
        self.stop_words = stop_words or set()

    def __iter__(self):
        self.sentences.reset()
        for sentence in self.sentences:
            tokens = self.tf.create(sentence).get_tokens()
            seq = Sequence()
            for tok in tokens:
                if tok and tok not in self.stop_words:
                    seq.add_element(VocabWord(tok))
            if seq.size() > 0:
                # indices resolve against the built vocab at training time
                yield seq


class Word2Vec(SequenceVectors):

    class Builder(SequenceVectors.Builder):
        def __init__(self, configuration: Optional[VectorsConfiguration] = None):
            super().__init__(configuration)
            self._sentences: Optional[SentenceIterator] = None
            self._tf: TokenizerFactory = DefaultTokenizerFactory()
            self._stop_words: set = set()

        def iterate(self, source):
            if isinstance(source, SentenceIterator):
                self._sentences = source
            else:
                self._source = source
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tf = tf
            return self

        def stop_words(self, words: Iterable[str]):
            self._stop_words = set(words)
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(self.conf, device=self._device)
            if self._sentences is not None:
                w2v._sequence_source = _SentenceSequenceSource(
                    self._sentences, self._tf, self._stop_words)
            else:
                w2v._sequence_source = self._source
            w2v.vocab = self._vocab
            return w2v

Word2Vec.Builder._vectors_cls = Word2Vec
