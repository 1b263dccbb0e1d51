"""The port's embedding trainers (``deeplearning4j_tpu_torch/embeddings/``)
held against the JAX package's on the CPU, torch on one thread.

Tolerances, float32 on both sides, each a relative 2-norm:
* one step (``skipgram_step``, ``cbow_step``, ``infer_step``):
  ||Δport − Δjax|| ≤ STEP_REL · ||Δjax|| per table, Δ = new − old.  The
  same float32 operations in the same order of chunks; dots and duplicate
  rows sum in another order.  A rehearsal read at most 1.8e-6 (skip-gram's
  syn1 with HS and NS on: ~30 contributions to a row within a chunk, of
  both signs, cancel), ~1e-7 elsewhere; STEP_REL = 1e-5.
* whole fits (Word2Vec skip-gram and CBOW, ParagraphVectors DBOW and DM
  with ``infer_vector``, GloVe, a generic SequenceVectors): every random
  draw is the same numpy stream in both packages, so the fits follow the
  same path and only rounding differs: ||port − jax|| ≤ FIT_REL ·
  ||jax − initial|| per table.  Rehearsals read at most 4.3e-7 (GloVe);
  FIT_REL = 1e-5.  GloVe's returned loss (the last epoch's, a float64
  host sum of float32 batch losses in both) read 8.1e-6 relative: near
  convergence it is a sum of small squared residuals, which the tables'
  4e-7 difference moves relatively more; GLOVE_LOSS_RTOL = 1e-4.
* everything else is exact: vocabularies, Huffman codes and points, the
  serializer's text and binary files and the zip's members (equal bytes).
"""

import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.embeddings import (
    Glove as JaxGlove, ParagraphVectors as JaxPV,
    SequenceVectors as JaxSV, Word2Vec as JaxW2V,
    WordVectorSerializer as JaxSer)
from deeplearning4j_tpu.embeddings import kernels as jk
from deeplearning4j_tpu.text import (
    CollectionSentenceIterator as JaxCollection,
    LabelAwareListSentenceIterator as JaxLabelAware)
from deeplearning4j_tpu.text.sequence import (
    Sequence as JaxSequence, VocabWord as JaxVocabWord)
from deeplearning4j_tpu_torch.embeddings import (
    Glove, InMemoryLookupTable, ParagraphVectors, SequenceVectors, Word2Vec,
    WordVectorSerializer, kernels)
from deeplearning4j_tpu_torch.embeddings.lookup import TABLES
from deeplearning4j_tpu_torch.text import (
    CollectionSentenceIterator, LabelAwareListSentenceIterator)
from deeplearning4j_tpu_torch.text.sequence import Sequence, VocabWord
from test_nlp import _corpus

STEP_REL = 1e-5
FIT_REL = 1e-5
GLOVE_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread (ROADMAP C: its
    multi-threaded float32 reductions differ from run to run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want, base) -> float:
    """||got - want|| / ||want - base||; ||got - want|| where want is
    base."""
    den = np.linalg.norm(np.asarray(want, np.float64) - base)
    num = np.linalg.norm(np.asarray(got, np.float64) - want)
    return float(num / den if den else num)


def _assert_fit_close(port_table, jax_table, init, what):
    for name in TABLES:
        want = getattr(jax_table, name)
        if want is None:
            assert getattr(port_table, name) is None, what
            continue
        want = np.asarray(want)
        got = port_table.array(name)
        assert got.shape == want.shape, (what, name)
        base = init if name == "syn0" else np.zeros_like(want)
        rel = _rel(got, want, base)
        assert rel <= FIT_REL, f"{what} {name}: {rel:.3g} > {FIT_REL}"


def test_chunk_equals_jax():
    """A stray DL4J_W2V_CHUNK in JAX's environment would change its
    chunking; the port has no such override."""
    assert jk.CHUNK == kernels.CHUNK == 64
    assert jk.MAX_EXP == kernels.MAX_EXP


# ------------------------------------------------------------------ steps

V, D, B, C, K, W = 40, 16, 200, 6, 4, 5     # B = 3 chunks of 64 + 8


def _step_case(branches, seed=0):
    """Seeded tables and one padded batch with Zipf-heavy duplicates.
    ``branches``: "both", "hs_only" (1-row syn1neg, NS masked) or
    "ns_only" (1-row syn1, HS masked)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    hs = branches != "ns_only"
    ns = branches != "hs_only"
    syn0 = (rng.random((V, D), dtype=np.float32) - 0.5) / D
    syn1 = rng.normal(0, 0.3, (V - 1 if hs else 1, D)).astype(np.float32)
    syn1neg = rng.normal(0, 0.3, (V if ns else 1, D)).astype(np.float32)
    pair = np.ones(B, np.float32)
    pair[-9:] = 0.0                                  # a flush's padded tail
    center = rng.choice(V, B, p=p).astype(np.int32)
    ctx = rng.choice(V, B, p=p).astype(np.int32)
    points = rng.integers(0, V - 1, (B, C)).astype(np.int32)
    codes = rng.integers(0, 2, (B, C)).astype(np.float32)
    cmask = (np.arange(C)[None] < rng.integers(1, C + 1, (B, 1))
             ).astype(np.float32) * pair[:, None] * hs
    kk = K if ns else 1
    nidx = np.zeros((B, kk), np.int32)
    nidx[:, 0] = center
    nlab = np.zeros((B, kk), np.float32)
    nlab[:, 0] = 1.0
    nmask = np.zeros((B, kk), np.float32)
    if ns:
        nidx[:, 1:] = rng.choice(V, (B, kk - 1), p=p)
        nmask[:] = 1.0
        nmask[:, 1:] = nidx[:, 1:] != center[:, None]
        nmask *= pair[:, None]
    win = rng.choice(V, (B, W), p=p).astype(np.int32)
    wmask = (np.arange(W)[None] < rng.integers(1, W + 1, (B, 1))
             ).astype(np.float32) * pair[:, None]
    alpha = (0.05 * pair).astype(np.float32)
    vec = rng.normal(0, 0.1, (B, D)).astype(np.float32)
    heads = (points, codes, cmask, nidx, nlab, nmask, alpha)
    return {"tables": (syn0, syn1, syn1neg), "vec": vec,
            "skipgram": (ctx,) + heads, "cbow": (win, wmask) + heads,
            "infer": heads}


STEP_CASES = [(kind, branches, skip)
              for kind in ("skipgram", "cbow", "infer")
              for branches, skip in (("both", False), ("hs_only", False),
                                     ("hs_only", True), ("ns_only", False),
                                     ("ns_only", True))]


@pytest.mark.parametrize("kind,branches,skip", STEP_CASES)
def test_step_equals_jax(kind, branches, skip):
    """One step from the same seeded tables and batch: duplicate rows
    inside a chunk, a padded tail, and the off branch either run through
    its all-zero masks over the 1-row placeholder (its indices out of
    range: a clamped gather, a scatter that adds 0) or skipped."""
    case = _step_case(branches)
    flags = {"hs": not (skip and branches == "ns_only"),
             "ns": not (skip and branches == "hs_only")}
    args = case[kind]
    port_args = [torch.from_numpy(a.copy()) for a in args]
    if kind == "infer":
        old = [case["vec"]]
        want = [np.asarray(jk.infer_step(
            jnp.asarray(case["vec"]), *map(jnp.asarray, case["tables"][1:]),
            *map(jnp.asarray, args)))]
        got = [kernels.infer_step(
            torch.from_numpy(case["vec"].copy()),
            *(torch.from_numpy(t.copy()) for t in case["tables"][1:]),
            *port_args, **flags).numpy()]
    else:
        old = case["tables"]
        jax_step = jk.skipgram_step if kind == "skipgram" else jk.cbow_step
        step = (kernels.skipgram_step if kind == "skipgram"
                else kernels.cbow_step)
        want = [np.asarray(t) for t in jax_step(
            *(jnp.asarray(t.copy()) for t in case["tables"]),
            *map(jnp.asarray, args))]
        tables = [torch.from_numpy(t.copy()) for t in case["tables"]]
        got = step(*tables, *port_args, **flags)
        assert all(g is t for g, t in zip(got, tables))      # in place
        got = [g.numpy() for g in got]
    for g, w, o in zip(got, want, old):
        assert g.shape == w.shape
        if np.array_equal(w, o):                 # an off branch's table
            np.testing.assert_array_equal(g, o)
            continue
        rel = _rel(g, w, o)
        assert rel <= STEP_REL, f"{rel:.3g}"


def test_masked_out_of_range_rows_add_exactly_zero():
    """HS off by its masks over a 1-row syn1 that ``points`` index far
    past: the table is bit-for-bit unchanged and syn0's update equals the
    skipped branch's bit for bit."""
    case = _step_case("ns_only")
    runs = []
    for hs in (True, False):
        tables = [torch.from_numpy(t.copy()) for t in case["tables"]]
        kernels.skipgram_step(*tables, *map(torch.from_numpy,
                                            case["skipgram"]), hs=hs)
        runs.append([t.numpy() for t in tables])
    np.testing.assert_array_equal(runs[0][1], case["tables"][1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ whole fits


def _w2v(pkg, **kw):
    W2V, Coll = (JaxW2V, JaxCollection) if pkg == "jax" else (
        Word2Vec, CollectionSentenceIterator)
    b = (W2V.Builder().iterate(Coll(_corpus())).min_word_frequency(1)
         .learning_rate(0.05).window_size(4).epochs(3).batch_size(512)
         .negative_sample(5))
    for k, v in kw.items():
        getattr(b, k)(v)
    if pkg == "port":
        b.device("cpu")
    return b.build()


def _fit_both(make):
    """(port, jax, initial syn0) after the same fit in both packages."""
    port, ref = make("port"), make("jax")
    port.build_vocab()
    init = port.lookup_table.get_weights()
    port.fit()
    ref.fit()
    return port, ref, init


@pytest.fixture(scope="module")
def trained():
    """The JAX suite's ``trained_w2v`` recipe in both packages."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _fit_both(lambda pkg: _w2v(
            pkg, layer_size=32, use_hierarchic_softmax=True, seed=12345))
    finally:
        torch.set_num_threads(n)


def test_word2vec_skipgram_fit_equals_jax(trained):
    port, ref, init = trained
    assert port.vocab.words() == ref.vocab.words()
    _assert_fit_close(port.lookup_table, ref.lookup_table, init, "skipgram")
    # the JAX suite's quality assertions, in the port
    assert port.similarity("cat", "dog") > port.similarity("cat", "banana")
    assert port.similarity("apple", "mango") > \
        port.similarity("apple", "puppy")
    assert set(port.words_nearest("cat", top=3)) <= {"dog", "puppy",
                                                     "kitten"}
    assert port.words_nearest("cat", top=3) == \
        ref.words_nearest("cat", top=3)


def test_word2vec_cbow_fit_equals_jax():
    port, ref, init = _fit_both(lambda pkg: _w2v(
        pkg, layer_size=24, elements_learning_algorithm="CBOW", seed=7))
    _assert_fit_close(port.lookup_table, ref.lookup_table, init, "cbow")
    assert port.similarity("dog", "kitten") > port.similarity("dog", "pear")


def _pv(pkg, algo):
    PV, LA = (JaxPV, JaxLabelAware) if pkg == "jax" else (
        ParagraphVectors, LabelAwareListSentenceIterator)
    sents = _corpus()
    labels = ["animal" if any(w in s for w in ("cat", "dog")) else "fruit"
              for s in sents]
    b = (PV.Builder().iterate(LA(sents, labels)).layer_size(24)
         .window_size(4).epochs(3).learning_rate(0.05).min_word_frequency(1)
         .negative_sample(5).batch_size(512).seed(3)
         .sequence_learning_algorithm(algo))
    if pkg == "port":
        b.device("cpu")
    return b.build()


@pytest.mark.parametrize("algo", ["DBOW", "DM"])
def test_paragraph_vectors_fit_and_infer_equal_jax(algo):
    port, ref, init = _fit_both(lambda pkg: _pv(pkg, algo))
    assert port.vocab.words() == ref.vocab.words()
    _assert_fit_close(port.lookup_table, ref.lookup_table, init, algo)
    text = "cat dog puppy kitten cat dog"
    got = port.infer_vector(text, steps=20, learning_rate=0.05)
    want = ref.infer_vector(text, steps=20, learning_rate=0.05)
    assert got.shape == (24,)
    start = (np.random.default_rng(3).random((1, 24), dtype=np.float32)
             - 0.5)[0] / 24
    assert _rel(got, want, start) <= FIT_REL
    assert (port.similarity_to_label(got, "animal")
            > port.similarity_to_label(got, "fruit"))
    assert port.nearest_labels(got, top=2) == ref.nearest_labels(want, top=2)


def test_infer_vector_without_known_words_is_the_seeded_start():
    port = _pv("port", "DM")
    port.fit()
    ref = _pv("jax", "DM")
    ref.fit()
    np.testing.assert_array_equal(port.infer_vector("zebra"),
                                  ref.infer_vector("zebra"))


def test_glove_fit_equals_jax():
    def make(pkg):
        G, Coll = (JaxGlove, JaxCollection) if pkg == "jax" else (
            Glove, CollectionSentenceIterator)
        b = (G.Builder().iterate(Coll(_corpus())).layer_size(16)
             .window_size(4).epochs(20).learning_rate(0.05)
             .min_word_frequency(1).seed(11))
        if pkg == "port":
            b.device("cpu")
        return b.build()
    port, ref = make("port"), make("jax")
    loss, ref_loss = port.fit(), ref.fit()
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) <= GLOVE_LOSS_RTOL * abs(ref_loss)
    got, want = port.lookup_table.get_weights(), np.asarray(
        ref.lookup_table.syn0)
    assert _rel(got, want, np.zeros_like(want)) <= FIT_REL
    assert port.similarity("cat", "dog") > port.similarity("cat", "banana")


def test_generic_sequencevectors_fit_equals_jax():
    def seqs(pkg_seq, pkg_word):
        rng = np.random.default_rng(0)
        out = []
        for _ in range(100):
            s = pkg_seq()
            group = ["a", "b"] if rng.random() < 0.5 else ["x", "y"]
            for _ in range(6):
                s.add_element(pkg_word(group[rng.integers(2)]))
            out.append(s)
        return out

    def make(pkg):
        SV, args = (JaxSV, (JaxSequence, JaxVocabWord)) if pkg == "jax" \
            else (SequenceVectors, (Sequence, VocabWord))
        b = (SV.Builder().iterate(seqs(*args)).layer_size(8).window_size(2)
             .epochs(2).min_word_frequency(1).negative_sample(2)
             .batch_size(128).seed(5))
        if pkg == "port":
            b.device("cpu")
        return b.build()
    port, ref, init = _fit_both(make)
    _assert_fit_close(port.lookup_table, ref.lookup_table, init, "generic")
    assert port.similarity("a", "b") > port.similarity("a", "x")


# ------------------------------------------------------------ device rule


def test_entry_points_without_device_raise_without_cuda(monkeypatch,
                                                        tmp_path, trained):
    """With no CUDA device, ``device=None`` raises; nothing falls back to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = trained[0]
    path = str(tmp_path / "m.zip")
    WordVectorSerializer.write_word2vec_model(port, path)
    makers = [
        lambda: Word2Vec.Builder().build(),
        lambda: SequenceVectors.Builder().build(),
        lambda: ParagraphVectors.Builder().build(),
        lambda: Glove.Builder().build(),
        lambda: InMemoryLookupTable(port.vocab, 4),
        lambda: WordVectorSerializer.read_word2vec_model(path),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_lookup_table_holds_copies():
    """Tables are copies of the arrays handed in; host views are copies
    of the tables."""
    vocab = _w2v("port", layer_size=4)
    vocab.build_vocab()
    v = vocab.vocab
    syn0 = np.ones((v.num_words(), 4), np.float32)
    t = InMemoryLookupTable.from_arrays(v, syn0, device="cpu")
    t.syn0.add_(1.0)
    assert syn0[0, 0] == 1.0
    row = t.vector(v.word_at_index(0).label)
    row[:] = 7.0
    assert float(t.syn0[0, 0]) == 2.0
    assert t.syn1 is None and t.array("syn1") is None


# ------------------------------------------------------------ serializer


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _vocab_entries(model):
    return [(w.label, w.element_frequency, w.index, w.codes, w.points,
             w.special, w.is_label) for w in model.vocab.vocab_words()]


def test_serializer_jax_writes_port_reads(trained, tmp_path):
    port, ref, _ = trained
    for write, read_port, read_jax, ext in (
            ("write_word_vectors", "read_word_vectors", "read_word_vectors",
             "txt"),
            ("write_binary", "read_binary", "read_binary", "bin")):
        path = str(tmp_path / f"v.{ext}")
        getattr(JaxSer, write)(ref, path)
        got = getattr(WordVectorSerializer, read_port)(path, device="cpu")
        want = getattr(JaxSer, read_jax)(path)
        assert got.vocab.words() == want.vocab.words()
        np.testing.assert_array_equal(got.lookup_table.get_weights(),
                                      np.asarray(want.lookup_table.syn0))
    path = str(tmp_path / "m.zip")
    JaxSer.write_word2vec_model(ref, path)
    got = WordVectorSerializer.read_word2vec_model(path, device="cpu")
    assert _vocab_entries(got) == _vocab_entries(ref)
    assert got.conf == port.conf
    for name in TABLES:
        np.testing.assert_array_equal(
            got.lookup_table.array(name),
            np.asarray(getattr(ref.lookup_table, name)))


def test_serializer_port_writes_jax_reads_byte_equal(trained, tmp_path):
    """The same tables (JAX's, read into the port through its zip) give
    byte-equal text and binary files and zip members in both packages,
    and JAX reads what the port writes."""
    _, ref, _ = trained
    src = str(tmp_path / "jax.zip")
    JaxSer.write_word2vec_model(ref, src)
    port = WordVectorSerializer.read_word2vec_model(src, cls=Word2Vec,
                                                    device="cpu")
    assert isinstance(port, Word2Vec)
    for write in ("write_word_vectors", "write_binary"):
        a, b = tmp_path / f"port.{write}", tmp_path / f"jax.{write}"
        getattr(WordVectorSerializer, write)(port, str(a))
        getattr(JaxSer, write)(ref, str(b))
        assert a.read_bytes() == b.read_bytes(), write
    out = str(tmp_path / "port.zip")
    WordVectorSerializer.write_word2vec_model(port, out)
    assert _members(out) == _members(src)
    back = JaxSer.read_word2vec_model(out)
    assert _vocab_entries(back) == _vocab_entries(ref)
    for name in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(back.lookup_table,
                                                         name)),
                                      np.asarray(getattr(ref.lookup_table,
                                                         name)))


def test_zip_npy_members_are_numpy_saves(trained, tmp_path):
    port = trained[0]
    path = str(tmp_path / "m.zip")
    WordVectorSerializer.write_word2vec_model(port, path)
    members = _members(path)
    for name in TABLES:
        buf = io.BytesIO()
        np.save(buf, port.lookup_table.array(name))
        assert members[f"{name}.npy"] == buf.getvalue()


def test_refit_preserves_weights(tmp_path, trained):
    """fit() on a deserialized model must not wipe loaded weights."""
    path = str(tmp_path / "m.zip")
    WordVectorSerializer.write_word2vec_model(trained[0], path)
    loaded = WordVectorSerializer.read_word2vec_model(path, device="cpu")
    v_before = loaded.lookup_table.vector("cat").copy()
    loaded.build_vocab()   # must be a no-op on weights
    np.testing.assert_array_equal(loaded.lookup_table.vector("cat"), v_before)


def test_text_serializer_tokens_with_spaces(tmp_path):
    sv = (SequenceVectors.Builder()
          .iterate([Sequence([VocabWord("new york"), VocabWord("city")])])
          .layer_size(4).min_word_frequency(1).device("cpu").build())
    sv.build_vocab()
    path = str(tmp_path / "v.txt")
    WordVectorSerializer.write_word_vectors(sv, path)
    loaded = WordVectorSerializer.read_word_vectors(path, device="cpu")
    assert loaded.has_word("new york")
    np.testing.assert_allclose(loaded.word_vector("new york"),
                               sv.word_vector("new york"), atol=1e-5)
