"""The text CNN of chip_smoke.py (``textcnn_conf``: three full-width conv
branches of heights 3, 4 and 5, max over time, merged, an output layer
that drops its input) at a small size, built with JAX's ComputationGraph,
written to a zip and restored in the port, on the CPU; and the conv
kernel's full-width route's gate.

The inputs are ``CnnSentenceDataSetIterator`` batches over the Word2Vec
that JAX trained in ``tests/test_torch_nlp.py`` (D = 16), read back by the
port: sentences of 8 words padded to L = 12, batch 32, 48 maps a height,
so the merged features (32 x 144 = 4,608) take the hash dropout kernel in
both packages (JAX's Pallas kernel in interpret mode, with JAX's seed
words handed to the port, as ``tests/test_torch_graph.py`` does).

Tolerances, those of ``tests/test_torch_graph.py``: outputs rtol = atol =
1e-5; the score rtol 1e-4; the first gradients rtol 1e-4, atol 1e-6; after
2 Adam steps the scores rtol 1e-3 and at least 99.5 % of each tensor's
elements within rtol 1e-4 / atol 1e-5, every one within 5e-3 (half of one
step of size lr = 0.01).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.network import GlobalConf as JaxGlobalConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.text.cnn_iterator import (
    CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider)
from test_nlp import _corpus
from test_torch_nlp import jax_word2vec

OUT_TOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3
D, L, MAPS, BATCH = 16, 12, 48, 32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n_batches=3):
    """Labeled sentences of tests/test_nlp.py's corpus through the port's
    iterator: (features, labels) per batch of BATCH."""
    _, w2v = jax_word2vec()
    sents = _corpus()[:n_batches * BATCH]
    labels = ["animal" if any(w in s for w in ("cat", "dog", "puppy",
                                                "kitten")) else "fruit"
              for s in sents]
    it = CnnSentenceDataSetIterator(
        CollectionLabeledSentenceProvider(sents, labels), w2v,
        batch_size=BATCH, max_sentence_length=L)
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features.numpy(), ds.labels))
    return out


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """(the port's graph restored from JAX's zip, JAX's graph)."""
    jnet = JaxGraph(CS.textcnn_conf(
        jax_gc, jax_layers, JaxGlobalConf, JaxInputType, width=D, length=L,
        maps=MAPS, pipeline_workers=0)).init()
    path = tmp_path_factory.mktemp("textcnn") / "textcnn.zip"
    jax_ser.write_model(jnet, path)
    net = ser.load_model(path, device="cpu")
    assert isinstance(net, ComputationGraph)
    return net, jnet, path


def jax_step_seeds(jnet):
    """JAX's dropout seed words of its next step, one row per vertex in
    topological order (tests/test_torch_graph.py)."""
    _, sub = jax.random.split(jnet._key)
    return np.stack([np.asarray(pk._dropout_seed(jax.random.fold_in(sub, vi))
                                ).reshape(-1)
                     for vi in range(len(jnet.order))])


def test_restored_text_cnn_outputs_and_score_equal_jax(restored):
    net, jnet, _ = restored
    assert net.order == jnet.order
    assert net.num_params() == jnet.num_params() == \
        3 * MAPS + MAPS * D * (3 + 4 + 5) + 3 * MAPS * 2 + 2
    for x, y in _batches(2):
        np.testing.assert_allclose(net.output(x)[0].numpy(),
                                   np.asarray(jnet.output(x)[0]),
                                   rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(net.score(MultiDataSet([x], [y])),
                                   jnet.score(JaxMDS([x], [y])),
                                   rtol=FIT_RTOL)


def test_text_cnn_gradients_and_adam_fit_equal_jax(monkeypatch, tmp_path,
                                                   restored):
    """From JAX's zip: the first step's gradients with JAX's dropout seed
    words, then 2 Adam steps in both packages."""
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")
    _, _, path = restored
    net, jnet = ser.load_model(path, device="cpu"), jax_ser.load_model(path)
    batches = _batches(2)
    x, y = batches[0]
    assert ck.dropout_fused_supported((BATCH, 3 * MAPS), torch.float32)
    seeds = jax_step_seeds(jnet)
    _, sub = jax.random.split(jnet._key)
    _, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, (jnp.asarray(x),),
        (jnp.asarray(y),), None, None, sub)
    _, grads = net._grad_step(net._inputs([x]), [torch.from_numpy(y)],
                              None, None, seeds.tolist())
    for n in net.order:
        assert sorted(grads[n]) == sorted(jgrads[n])
        for k in jgrads[n]:
            np.testing.assert_allclose(grads[n][k].numpy(),
                                       np.asarray(jgrads[n][k]),
                                       rtol=FIT_RTOL, atol=1e-6)
    for x, y in batches:
        seeds = jax_step_seeds(jnet)
        net._fit_batch(MultiDataSet([x], [y]), seeds=seeds)
        jnet.fit(JaxMDS([x], [y]))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=ADAM_SCORE_RTOL)
    for n in net.order:
        for k in jnet.net_params[n]:
            got = net.net_params[n][k].numpy()
            want = np.asarray(jnet.net_params[n][k])
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= ADAM_INSIDE, (n, k, ok.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL)
    assert net.iteration == jnet.iteration == 2
    # and the port's zip of the trained graph restores in JAX
    out = tmp_path / "port.zip"
    ser.write_model(net, out)
    back = jax_ser.load_model(out)
    np.testing.assert_array_equal(np.asarray(back.params()),
                                  net.params().numpy())


# ---------------------------------------------------------------------------
# The full-width route's gate
# ---------------------------------------------------------------------------

def _textcnn_shapes():
    """(x, w) of every conv chip_smoke.py's text CNN runs, and this file's."""
    out = []
    for width, batch in ((CS.TEXTCNN_D, CS.TEXTCNN_BATCH),
                         (CS.W2V_LAYER, CS.TEXTCNN_BATCH),
                         (CS.W2V_LAYER, 1), (D, BATCH)):
        length = L if width == D else CS.TEXTCNN_LEN
        maps = MAPS if width == D else CS.TEXTCNN_MAPS
        for h in CS.TEXTCNN_HEIGHTS:
            out.append(((batch, 1, length, width), (maps, 1, h, width)))
    return out


@pytest.mark.parametrize("x_shape,w_shape", _textcnn_shapes())
def test_gate_takes_every_text_cnn_conv(x_shape, w_shape):
    """The port's gate and JAX's Pallas gate both take the text CNN's
    convs; they go the full-width route (KW past the halo route's 7)."""
    assert ck.conv_fused_supported(x_shape, w_shape, torch.float32,
                                   activation="relu")
    assert pk.conv_fused_supported(x_shape, w_shape, jnp.float32,
                                   activation="relu")
    N, Cin, H, W = x_shape
    Cout, _, KH, KW = w_shape
    assert ck._conv_full_width_supported(N, Cin, KH, KW, Cout,
                                         H - KH + 1, W - KW + 1)
    assert not ck._conv_halo_supported(N, Cin, KH, KW, Cout, H - KH + 1,
                                       W - KW + 1)


def _halo_rule(N, Cin, KH, KW, Cout, OH, OW):
    """The halo route's gate as it stood before the full-width route."""
    if min(N, Cin, Cout, OH, OW, KH, KW) < 1 or max(KH, KW) > 7:
        return False
    if Cin * KH * KW > 2 ** 30:
        return False
    ni = min(N, 128 // (OH * OW)) if OH * OW <= 128 else 1
    if ni * Cin * (OH + KH - 1) * (OW + KW - 1) > 2 ** 31 - 1:
        return False
    return N * OH * OW * -(-Cout // (32 if Cout <= 32 else 64)) <= \
        2 ** 31 - 1


def test_gate_keeps_the_halo_routes_answers():
    """Over a grid of small convs the gate answers as the halo route's
    rule did, except where the output is one column wide (the full-width
    route); the text CNN's pad and mode variants there too."""
    for H in (1, 2, 3, 5, 9):
        for W in (1, 2, 3, 7, 8, 12):
            for KH in (1, 2, 3, 7, 8):
                for KW in (1, 3, 7, 8, 12, 13):
                    for pad in ((0, 0), (1, 0), (0, 2)):
                        OH = H + 2 * pad[0] - KH + 1
                        OW = W + 2 * pad[1] - KW + 1
                        got = ck.conv_fused_supported(
                            (2, 3, H, W), (5, 3, KH, KW), torch.float32,
                            pad=pad)
                        old = _halo_rule(2, 3, KH, KW, 5, OH, OW)
                        assert got == (old or (OW == 1 and OH >= 1)), (
                            H, W, KH, KW, pad)


@pytest.mark.parametrize("x,w,kwargs,accepted", [
    ((32, 1, 256, 300), (100, 1, 5, 300), {}, True),
    ((2, 3, 9, 12), (70, 3, 3, 16), {"pad": (1, 2)}, True),   # width pads
    ((2, 3, 9, 1), (7, 3, 3, 9), {"border_mode": "same"}, True),
    ((2, 3, 9, 12), (7, 3, 3, 12), {"border_mode": "same"}, False),
    ((32, 1, 256, 300), (100, 1, 5, 300), {"stride": (1, 300)}, False),
    ((32, 1, 256, 300), (100, 1, 5, 300), {"dtype": torch.float16}, False),
    ((32, 1, 4, 300), (100, 1, 5, 300), {}, False),           # KH > H
    # K = Cin * KH * KW at most 2^30
    ((1, 2 ** 30 // 1500, 5, 300), (4, 2 ** 30 // 1500, 5, 300), {}, True),
    ((1, 2 ** 30 // 1500 + 1, 5, 300), (4, 2 ** 30 // 1500 + 1, 5, 300),
     {}, False),
    # an offset in an image, Cin (OH + KH - 1) KW, within an int
    ((1, 2 ** 20, 2048, 1), (4, 2 ** 20, 2, 1), {}, False),
    ((1, 2 ** 10, 2048, 1), (4, 2 ** 10, 2, 1), {}, True),
    # M = N OH within an int
    ((2 ** 21, 1, 1025, 8), (4, 1, 2, 8), {}, False),
    # the bf16 form takes the full-width route too
    ((32, 1, 256, 300), (100, 1, 5, 300), {"dtype": torch.bfloat16}, True),
])
def test_full_width_gate_limits(x, w, kwargs, accepted):
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", torch.float32)
    assert ck.conv_fused_supported(x, w, dtype, **kwargs) is accepted


def test_full_width_conv_on_the_cpu_equals_jax():
    """The CPU path of a full-width conv (the plain version) against JAX's
    conv, with width padding."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 2, 9, 12)).astype(np.float32)
    w = (rng.normal(size=(7, 2, 3, 16)) * 0.2).astype(np.float32)
    b = rng.normal(size=7).astype(np.float32)
    from deeplearning4j_tpu.ops import helpers as jax_helpers
    want = np.asarray(jax_helpers.conv2d_bias_act(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad=(1, 2),
        activation="relu"))
    got = ck.fused_conv2d_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), pad=(1, 2),
                                   activation="relu")
    assert tuple(got.shape) == (3, 7, 9, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
