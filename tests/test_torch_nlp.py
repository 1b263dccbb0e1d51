"""The rest of the port's NLP surface (``deeplearning4j_tpu_torch/text/``:
annotators, CJK tokenizers, the lattice analyzer, the inverted indices,
bag of words and TF-IDF, the CNN sentence iterator) held against the JAX
package on the CPU.

Each case of ``tests/test_nlp.py`` and ``tests/test_lattice.py`` for these
modules is written once over a module lookup and runs through both
packages; the results must be equal (tokens, annotations, morphemes,
dictionary entries, documents).  Vectorizer features are held within
1e-6 (floats computed by the same code; ``math.log`` on both sides).
The CNN iterator reads a Word2Vec that JAX trained and wrote, through the
port's ``WordVectorSerializer``: its features (one gather from ``syn0``),
mask and labels must equal JAX's iterator's (per-token copies), along
the height and along the width.  :func:`jax_word2vec` is that model, and
``tests/test_torch_textcnn.py`` reuses it.
"""

import dataclasses
import functools
import importlib
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.embeddings import Word2Vec as JaxWord2Vec
from deeplearning4j_tpu.embeddings import WordVectorSerializer as JaxSer
from deeplearning4j_tpu.text import CollectionSentenceIterator as JaxSents
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.embeddings import WordVectorSerializer
from deeplearning4j_tpu_torch.text import cnn_iterator
from test_nlp import _corpus

VECTORIZER_TOL = 1e-6
PACKAGES = ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")


def _through_both(case):
    """``case(m)`` with ``m(name)`` importing ``name`` from the JAX package,
    then from the port -> (jax result, port result)."""
    return tuple(case(lambda name, pkg=pkg:
                      importlib.import_module(f"{pkg}.{name}"))
                 for pkg in PACKAGES)


def _plain(obj):
    """Dataclass instances (morphemes, entries, annotations) as tuples of
    their fields, so the two packages' classes compare."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return [_plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _equal(case):
    jax_result, port_result = _through_both(case)
    assert _plain(port_result) == _plain(jax_result)
    return port_result


# ---------------------------------------------------------------------------
# Annotators, CJK, the inverted index (tests/test_nlp.py)
# ---------------------------------------------------------------------------

def test_annotation_pipeline():
    def case(m):
        ctx = m("text.annotators").AnnotationPipeline().annotate(
            "The cats were running quickly. They jumped!")
        sents = ctx.select("sentence")
        toks = ctx.covered("token", sents[0])
        pos = {a.begin: a.value for a in ctx.select("pos")}
        stems = {a.begin: a.value for a in ctx.select("stem")}
        return (ctx.annotations, [t.value for t in toks],
                [pos[t.begin] for t in toks],
                [stems.get(t.begin) for t in toks], len(sents))
    _, toks, pos, stems, n_sents = _equal(case)
    assert n_sents == 2
    assert toks == ["The", "cats", "were", "running", "quickly", "."]
    assert [pos[1], pos[3], pos[4]] == ["NNS", "VBG", "RB"]
    assert stems[1] == "cat" and stems[3] == "run"


def test_porter_stemmer():
    words = {"caresses": "caress", "ponies": "poni", "cats": "cat",
             "feed": "feed", "agreed": "agre", "plastered": "plaster",
             "motoring": "motor", "sing": "sing", "conflated": "conflat",
             "hopping": "hop", "relational": "relat", "happy": "happi",
             "generalization": "gener"}
    stems = _equal(lambda m: {w: m("text.annotators").porter_stem(w)
                              for w in words})
    assert stems == words


def test_japanese_tokenizer():
    def case(m):
        cjk = m("text.cjk")
        tf = cjk.JapaneseTokenizerFactory()
        tf2 = cjk.JapaneseTokenizerFactory(user_dict={"日本語", "勉強"})
        return (tf.create("私は日本語を勉強します。").get_tokens(),
                tf2.create("私は日本語を勉強します").get_tokens(),
                tf.create("TPUでディープラーニング").get_tokens())
    toks, toks2, toks3 = _equal(case)
    assert "は" in toks and "を" in toks and "。" not in "".join(toks)
    assert "".join(toks) == "私は日本語を勉強します"
    assert "日本語" in toks2 and "勉強" in toks2
    assert "TPU" in toks3 and "ディープラーニング" in toks3


def test_korean_tokenizer():
    def case(m):
        cjk = m("text.cjk")
        return (cjk.KoreanTokenizerFactory().create(
                    "고양이는 집에 있다").get_tokens(),
                cjk.KoreanTokenizerFactory(strip_josa=False).create(
                    "고양이는 집에").get_tokens())
    toks, toks2 = _equal(case)
    assert {"고양이", "는", "집", "에"} <= set(toks)
    assert "고양이는" in toks2 and "집에" in toks2


def test_inverted_index():
    def case(m):
        idx = m("text.invertedindex").InMemoryInvertedIndex()
        d0 = idx.add_words_to_doc(None, ["the", "cat", "sat"])
        d1 = idx.add_words_to_doc(None, ["the", "dog", "ran"])
        return ([d0, d1], idx.num_documents(), idx.total_words(),
                idx.documents("the"), idx.documents("cat"), idx.document(d1),
                list(idx.docs()), list(idx.batch_iter(1)))
    ids, n_docs, n_words, the, cat, doc1, docs, batches = _equal(case)
    assert (n_docs, n_words, the, cat) == (2, 6, ids, [ids[0]])
    assert doc1 == ["the", "dog", "ran"]
    assert docs[0] == ["the", "cat", "sat"]
    assert len(batches) == 2 and batches[0] == [["the", "cat", "sat"]]


def test_sampled_inverted_index():
    def case(m):
        idx = m("text.invertedindex").InMemoryInvertedIndex(sample=0.5,
                                                             seed=3)
        for s in _corpus()[:40]:
            idx.add_words_to_doc(None, s.split())
        return list(idx.docs()), list(idx.batch_iter(7)), idx.sample()
    _equal(case)


# ---------------------------------------------------------------------------
# Bag of words and TF-IDF (tests/test_nlp.py)
# ---------------------------------------------------------------------------

def _vectorized(kind, m):
    vz = m("text.vectorizers")
    its = m("text.sentence_iterators")
    sents = ["the cat sat", "the dog sat", "apple banana"]
    labels = ["pets", "pets", "fruit"]
    v = getattr(vz, kind)(its.LabelAwareListSentenceIterator(sents, labels))
    v.fit()
    ds = v.fit_transform_all()
    one = v.vectorize("the cat sat sat", "pets")
    return (v.vocab.words(), v.transform("cat cat dog"),
            v.transform("the cat"), np.asarray(ds.features),
            np.asarray(ds.labels), np.asarray(one.features),
            np.asarray(one.labels), v.index.documents("sat"),
            v.index.doc_frequency("the"), v.index.num_documents)


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers(kind):
    (want, got) = _through_both(functools.partial(_vectorized, kind))
    for w, g in zip(want, got):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, rtol=VECTORIZER_TOL,
                                       atol=VECTORIZER_TOL)
        else:
            assert g == w
    words, cat_dog, the_cat, feats, labels = got[:5]
    assert feats.shape[0] == 3 and labels.shape[1] == 2
    if kind == "BagOfWordsVectorizer":
        assert cat_dog[words.index("cat")] == 2.0
        assert cat_dog[words.index("dog")] == 1.0
    else:   # "the" is in 2 of 3 documents, "cat" in 1
        assert the_cat[words.index("cat")] > the_cat[words.index("the")]


# ---------------------------------------------------------------------------
# The lattice analyzer (tests/test_lattice.py)
# ---------------------------------------------------------------------------

LATTICE_SENTENCES = [
    "これは日本の言葉です", "すもももももももものうち",
    "ここではきものをぬぐ", "JAXは2026年のTPUでうごく", "東京へ行った",
    "深層学習で学ぶ", "鰯龍驟雨abc123鰯", "東京 大阪", "東京!?",
    "言語処理はTPUで、速い。"]


@pytest.mark.parametrize("text", LATTICE_SENTENCES)
def test_viterbi_segment(text):
    def case(m):
        lat = m("text.lattice")
        d = lat.MorphDictionary()
        return (lat.viterbi_segment(text, d), lat.build_lattice(text, d),
                lat.JapaneseLatticeTokenizer(text, d).get_tokens())
    morphemes, _, tokens = _equal(case)
    assert "".join(m.surface for m in morphemes) == text.replace(" ", "")
    assert tokens


def test_lattice_cases_of_the_jax_suite():
    def case(m):
        lat = m("text.lattice")
        from_cjk = m("text.cjk")._longest_match_split(
            "ここではきものをぬぐ",
            {"ここ", "で", "では", "はきもの", "きもの", "を", "ぬぐ"}, 4)
        d = lat.MorphDictionary()
        before = [x.surface for x in lat.viterbi_segment("深層学習で学ぶ", d)]
        d.add_word("深層学習")
        after = [x.surface for x in lat.viterbi_segment("深層学習で学ぶ", d)]
        small = lat.MorphDictionary(seed=False)
        small.add(lat.MorphEntry("ぱぴ", lat.NOUN, 3))
        small.add(lat.MorphEntry("ぱぴ", lat.VERB, 4))
        small.add(lat.MorphEntry("ぷ", lat.AUX, 1))
        tf = lat.JapaneseLatticeTokenizerFactory(user_entries=["言語処理"])
        tf.set_token_pre_processor(type("Lower", (m(
            "text.tokenization").TokenPreProcess,), {
                "pre_process": lambda self, t: t.lower()})())
        pos = [lat.connection_cost(a, b) for a in (lat.NOUN, lat.VERB,
                                                   lat.AUX, lat.PARTICLE)
               for b in (lat.NOUN, lat.PARTICLE, lat.AUX)]
        return (from_cjk, before, after,
                lat.viterbi_segment("ぱぴぷ", small),
                tf.create("言語処理はTPUで、速い。").get_tokens(), pos,
                lat.JapaneseLatticeTokenizer(
                    "東京へ行った", lat.MorphDictionary()).morphemes)
    greedy, before, after, papipu, tokens, _, tokyo = _equal(case)
    assert greedy[:2] == ["ここ", "では"]
    assert "深層学習" not in before and "深層学習" in after
    assert [t.surface for t in papipu] == ["ぱぴ", "ぷ"]
    assert papipu[0].pos == "verb"
    assert "言語処理" in tokens and "tpu" in tokens and "。" not in tokens
    assert {t.surface: t.base_form for t in tokyo}["行った"] == "行く"


IPADIC_CSV = "\n".join([
    "すもも,1285,1285,7546,名詞,一般,*,*,*,*,すもも,スモモ,スモモ",
    "もも,1285,1285,7219,名詞,一般,*,*,*,*,もも,モモ,モモ",
    "も,262,262,4669,助詞,係助詞,*,*,*,*,も,モ,モ",
    "の,368,368,4816,助詞,連体化,*,*,*,*,の,ノ,ノ",
    "うち,1313,1313,5796,名詞,非自立,副詞可能,*,*,*,うち,ウチ,ウチ",
    "は,261,261,3865,助詞,係助詞,*,*,*,*,は,ハ,ハ",
    "いた,729,729,4222,動詞,自立,*,*,一段,連用タ接続,いる,イタ,イタ",
    "です,304,304,2706,助動詞,*,*,*,特殊・デス,基本形,です,デス,デス",
    "大きい,20,20,5219,形容詞,自立,*,*,形容詞・イ段,基本形,大きい,オオキイ,オオキイ",
    "お,560,560,6664,接頭詞,名詞接続,*,*,*,*,お,オ,オ",
    "さん,1678,1678,5576,名詞,接尾,人名,*,*,*,さん,サン,サン",
    "、,76,76,-2435,記号,読点,*,*,*,*,、,、,、",
    '"1,000",1295,1295,3003,名詞,数,*,*,*,*,"1,000",セン,セン',
    "東京,1293,1293,3003,名詞,固有名詞,地域,一般,*,*,東京,トウキョウ,トーキョー",
    "日本経済新聞,日本 経済 新聞,ニホン ケイザイ シンブン,カスタム名詞",
    "#,76,76,100,記号,一般"])


def test_ipadic_loader(tmp_path):
    path = tmp_path / "dict.csv"
    path.write_bytes(b"\xef\xbb\xbf" + IPADIC_CSV.encode("utf-8"))

    def case(m):
        lat = m("text.lattice")
        d = lat.load_ipadic_csv(IPADIC_CSV.splitlines())
        from_file = lat.load_ipadic_csv(path)
        merged = lat.load_ipadic_csv(["固有名詞X,1,1,1000,名詞,固有名詞"],
                                     dictionary=lat.MorphDictionary())
        words = ["すもも", "は", "いたX", "です", "大きい", "おX", "さん", "、",
                 "1,000", "東京", "日本経済新聞を", "#"]
        return ([d.prefixes(w, 0) for w in words],
                [from_file.prefixes(w, 0) for w in words],
                merged.prefixes("固有名詞X", 0), merged.prefixes("です", 0),
                lat.viterbi_segment("すもももももももものうち", d),
                lat.JapaneseLatticeTokenizerFactory(dictionary=d).create(
                    "すももとももです").get_tokens(),
                lat.parse_dictionary_line('"1,000",1295,1295,3003,名詞'),
                lat.parse_dictionary_line('he said ""hi"",1,2,3'),
                [lat._ja_pos_name(n) for n in ("助動詞", "カスタム動詞",
                                               "名詞", "記号")])
    entries, from_file, merged, _, sumomo, tokens, line, quoted, _ = \
        _equal(case)
    assert entries == from_file
    assert entries[0][-1].pos == "noun" and entries[1][-1].pos == "particle"
    assert [t.surface for t in sumomo] == ["すもも", "も", "もも", "も",
                                           "もも", "の", "うち"]
    assert "すもも" in tokens and "です" in tokens
    assert line[0] == "1,000" and quoted[0] == 'he said "hi"'
    assert any(e.surface == "固有名詞X" for e in merged)
    for mod in PACKAGES:
        lat = importlib.import_module(f"{mod}.text.lattice")
        with pytest.raises(ValueError, match="Unmatched quote"):
            lat.parse_dictionary_line('"broken,1,2,3')


# ---------------------------------------------------------------------------
# The CNN sentence iterator over a JAX-trained Word2Vec
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_word2vec():
    """(JAX's Word2Vec, the port's read back from JAX's zip): layer 16,
    negative sampling, one epoch over tests/test_nlp.py's corpus."""
    jw2v = (JaxWord2Vec.Builder()
            .iterate(JaxSents(_corpus())).layer_size(16).window_size(4)
            .epochs(1).learning_rate(0.05).min_word_frequency(1)
            .negative_sample(5).use_hierarchic_softmax(False)
            .batch_size(512).seed(12345).build())
    jw2v.fit()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "w2v.zip")
        JaxSer.write_word2vec_model(jw2v, path)
        w2v = WordVectorSerializer.read_word2vec_model(path, device="cpu")
    return jw2v, w2v


LABELED = [("cat dog puppy", "animal"), ("apple banana mango pear", "fruit"),
           ("kitten zebra cat", "animal"), ("", "fruit"),
           ("dog " * 9, "animal"), ("pear apple", "fruit"),
           ("mango cat kitten dog banana apple pear puppy", "fruit")]


@pytest.mark.parametrize("along_height", [True, False])
def test_cnn_iterator_equals_jax_over_a_jax_trained_word2vec(along_height):
    jw2v, w2v = jax_word2vec()
    np.testing.assert_array_equal(w2v.lookup_table.get_weights(),
                                  np.asarray(jw2v.lookup_table.syn0))
    sents, labels = zip(*LABELED)

    def iterator(mod, vectors):
        cnn = importlib.import_module(f"{mod}.text.cnn_iterator")
        provider = cnn.CollectionLabeledSentenceProvider(
            list(sents), list(labels), seed=5)
        return cnn.CnnSentenceDataSetIterator(
            provider, vectors, batch_size=3, max_sentence_length=6,
            sentences_along_height=along_height)
    jit, it = iterator(PACKAGES[0], jw2v), iterator(PACKAGES[1], w2v)
    assert isinstance(it, DataSetIterator)
    assert it.get_labels() == jit.get_labels() == ["animal", "fruit"]
    assert it.total_examples() == jit.total_examples() == len(LABELED)
    for _ in range(2):                       # an epoch, reset, another
        batches = 0
        while jit.has_next():
            assert it.has_next()
            ds, jds = it.next(), jit.next()
            assert isinstance(ds.features, torch.Tensor)
            np.testing.assert_array_equal(ds.features.numpy(),
                                          np.asarray(jds.features))
            np.testing.assert_array_equal(ds.features_mask,
                                          jds.features_mask)
            np.testing.assert_array_equal(ds.labels, jds.labels)
            shape = (6, 16) if along_height else (16, 6)
            assert ds.features.shape[1:] == (1,) + shape
            batches += 1
        assert not it.has_next() and batches == 3
        it.reset()
        jit.reset()


def test_cnn_iterator_pads_with_exact_zeros():
    _, w2v = jax_word2vec()
    provider = cnn_iterator.CollectionLabeledSentenceProvider(
        ["cat dog", "apple banana mango"], ["a", "f"])
    ds = cnn_iterator.CnnSentenceDataSetIterator(
        provider, w2v, batch_size=4, max_sentence_length=5).next()
    assert tuple(ds.features.shape) == (2, 1, 5, 16)
    assert ds.labels.shape == (2, 2) and ds.features_mask.sum() == 5
    assert bool((ds.features[0, 0, 2:] == 0).all())
    np.testing.assert_array_equal(ds.features[1, 0, 2].numpy(),
                                  w2v.word_vector("mango"))
