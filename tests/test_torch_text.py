"""The port's text pipeline (``deeplearning4j_tpu_torch/text/``) and its
pair windowing (``native/io.py``), held against the JAX package's on the
CPU.

Everything here is exact: equal token lists, equal vocabularies (labels,
frequencies, indices), equal Huffman ``codes``/``points``, equal code
matrices and equal (context, center) pairs in the same order.  The cases
of ``tests/test_nlp.py`` for these modules run through the port.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.embeddings import SequenceVectors as JaxSV
from deeplearning4j_tpu.native import io as jax_io
from deeplearning4j_tpu.text import (
    CollectionSentenceIterator as JaxCollection,
    DefaultTokenizerFactory as JaxTokenizerFactory,
    VocabConstructor as JaxVocabConstructor)
from deeplearning4j_tpu.text.sequence import (
    Sequence as JaxSequence, VocabWord as JaxVocabWord)
from deeplearning4j_tpu_torch.embeddings import SequenceVectors
from deeplearning4j_tpu_torch.native.io import skipgram_pairs
from deeplearning4j_tpu_torch.text import (
    BasicLineIterator, CollectionSentenceIterator, CommonPreprocessor,
    DefaultTokenizerFactory, Huffman, LabelAwareListSentenceIterator,
    LabelsSource, NGramTokenizerFactory, StopWords, VocabConstructor,
    VocabWord)
from deeplearning4j_tpu_torch.text.sequence import Sequence
from test_nlp import _corpus


def _zipf_sentences(seed=0, vocab=300, n=400, length=12):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, size=(n, length), p=p / p.sum())
    return [" ".join(f"z{i}" for i in row) for row in ids]


def _vocab(pkg_seq, pkg_word, ctor, sentences, min_freq=1):
    seqs = []
    for s in sentences:
        seq = pkg_seq()
        for tok in s.split():
            seq.add_element(pkg_word(tok))
        seqs.append(seq)
    return ctor(min_element_frequency=min_freq).add_source(seqs) \
        .build_joint_vocabulary()


def _entries(vocab):
    return [(w.label, w.element_frequency, w.index, w.codes, w.points,
             w.special, w.is_label) for w in vocab.vocab_words()]


# ------------------------------------------------------- test_nlp's cases


def test_default_tokenizer_and_preprocessor():
    tf = DefaultTokenizerFactory()
    tf.set_token_pre_processor(CommonPreprocessor())
    toks = tf.create("Hello, World! 123 test.").get_tokens()
    assert toks == ["hello", "world", "test"]


def test_ngram_tokenizer():
    tf = NGramTokenizerFactory(DefaultTokenizerFactory(), 1, 2)
    toks = tf.create("a b c").get_tokens()
    assert "a b" in toks and "b c" in toks and "a" in toks


def test_stopwords():
    assert StopWords.is_stop_word("the")
    assert not StopWords.is_stop_word("convolution")


def test_basic_line_iterator(tmp_path):
    p = tmp_path / "text.txt"
    p.write_text("line one\n\nline two\n")
    it = BasicLineIterator(str(p))
    assert list(it) == ["line one", "line two"]
    assert list(it) == ["line one", "line two"]  # resettable


def test_huffman_codes_prefix_free():
    words = [VocabWord(f"w{i}", freq) for i, freq in
             enumerate([100, 50, 20, 10, 5, 2, 1])]
    Huffman(words).build()
    codes = {tuple(w.codes) for w in words}
    assert len(codes) == len(words)
    for a in codes:
        for b in codes:
            if a != b:
                assert a != b[:len(a)]
    assert len(words[0].codes) == min(len(w.codes) for w in words)
    for w in words:
        assert all(0 <= p < len(words) - 1 for p in w.points)


def test_vocab_constructor_min_frequency():
    cache = _vocab(Sequence, VocabWord, VocabConstructor,
                   ["a a a b b c", "a b d"], min_freq=2)
    assert cache.contains_word("a") and cache.contains_word("b")
    assert not cache.contains_word("c") and not cache.contains_word("d")
    assert cache.index_of("a") == 0  # most frequent first


def test_sentence_iterator_reset_clears_peek():
    it = CollectionSentenceIterator(["a", "b"])
    it.has_next()
    it.reset()
    assert list(it) == ["a", "b"]


def test_prefetch_propagates_errors():
    def bad_source():
        yield Sequence([VocabWord("a")])
        raise RuntimeError("boom")
    sv = (SequenceVectors.Builder()
          .iterate([Sequence([VocabWord("a"), VocabWord("b")])])
          .layer_size(4).min_word_frequency(1).device("cpu").build())
    sv.build_vocab()
    with pytest.raises(RuntimeError, match="boom"):
        list(sv._prefetch(bad_source()))


def test_label_aware_iterator_and_labels_source():
    it = LabelAwareListSentenceIterator(["a b", "c"], ["x", "y"])
    got = []
    while it.has_next():
        got.append((it.next_sentence(), it.current_label()))
    assert got == [("a b", "x"), ("c", "y")]
    src = LabelsSource()
    assert [src.next_label(), src.next_label()] == ["DOC_0", "DOC_1"]


# ------------------------------------------------------ against JAX's


@pytest.mark.parametrize("sentences", [_corpus(), _zipf_sentences()],
                         ids=["two_topics", "zipf"])
def test_tokens_vocab_and_huffman_equal_jax(sentences):
    port_tf, jax_tf = DefaultTokenizerFactory(), JaxTokenizerFactory()
    port_tf.set_token_pre_processor(CommonPreprocessor())
    from deeplearning4j_tpu.text import CommonPreprocessor as JaxPre
    jax_tf.set_token_pre_processor(JaxPre())
    for s in sentences[:50]:
        assert port_tf.create(s).get_tokens() == \
            jax_tf.create(s).get_tokens()
    assert list(CollectionSentenceIterator(sentences)) == \
        list(JaxCollection(sentences))
    port = _vocab(Sequence, VocabWord, VocabConstructor, sentences)
    ref = _vocab(JaxSequence, JaxVocabWord, JaxVocabConstructor, sentences)
    assert _entries(port) == _entries(ref)
    assert port.total_word_count == ref.total_word_count


@pytest.mark.parametrize("sentences", [_corpus(), _zipf_sentences(1)],
                         ids=["two_topics", "zipf"])
def test_code_matrices_equal_jax(sentences):
    port = (SequenceVectors.Builder()
            .iterate([_seq(Sequence, VocabWord, s) for s in sentences])
            .min_word_frequency(1).layer_size(4).device("cpu").build())
    ref = (JaxSV.Builder()
           .iterate([_seq(JaxSequence, JaxVocabWord, s) for s in sentences])
           .min_word_frequency(1).layer_size(4).build())
    port.build_vocab()
    ref.build_vocab()
    for a, b in zip(port._code_matrices(), ref._code_matrices()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _seq(pkg_seq, pkg_word, sentence):
    seq = pkg_seq()
    for tok in sentence.split():
        seq.add_element(pkg_word(tok))
    return seq


@pytest.mark.parametrize("seed", range(4))
def test_skipgram_pairs_equal_jax(seed):
    """Center-major, context ascending, self and equal-id pairs skipped:
    the same pairs in the same order as JAX's (its native ``sg_pairs``
    when the library loads, its numpy form otherwise)."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 40):
        ids = rng.integers(0, 5, n).astype(np.int32)   # many repeats
        for window in (1, 3, 5):
            reduced = rng.integers(0, window, n).astype(np.int32)
            got = skipgram_pairs(ids, window, reduced)
            want = jax_io.skipgram_pairs(ids, window, reduced)
            for g, w in zip(got, want):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)


def test_skipgram_pairs_order():
    ctx, ctr = skipgram_pairs(np.array([1, 2, 3, 2], np.int32), 2,
                              np.zeros(4, np.int32))
    assert list(zip(ctr, ctx)) == [(1, 2), (1, 3), (2, 1), (2, 3),
                                   (3, 1), (3, 2), (3, 2), (2, 3)]
