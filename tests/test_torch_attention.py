"""The port's attention path — ``parallel/sequence`` (dense core, strategy
dispatch, KV-ring decode), ``SelfAttentionLayer``, ``rnn_time_step`` and
the zip — held against the JAX package on the CPU.

The network is the long-context model (``models/attention.attention_lm``:
2 x causal ``SelfAttentionLayer`` into a softmax/mcxent ``RnnOutputLayer``)
cut to a small size: width 64 in 2 heads (head dim 32), a vocabulary of 12
characters, context T = 256, so the port's attention takes the flash route
(its plain versions on the CPU), and T = 64, under the flash gate, so it
takes the dense formula.  The JAX network runs its dense core on the CPU;
one output case forces its Pallas flash kernel (``DL4J_PALLAS_FLASH=1``,
interpret mode).  Both start from the same params, drawn with numpy.

Tolerances, float32 on both sides with sums in other orders:
* outputs, ring contents and decode steps: rtol = atol = 1e-5, the JAX
  suite's tolerance for its fused kernels;
* scores and gradients: rtol 1e-4, atol 1e-6 — each gradient sums over
  B * T = 512 positions of two attention layers;
* params after 3 ``fit`` steps under Adam: the rule of
  ``tests/test_torch_fit.py`` (99.5 % of each tensor's elements within
  rtol 1e-4 / atol 1e-5, all within 5e-3, half of one step at lr 0.01;
  scores at rtol 1e-3), for the reason given there: Adam turns a gradient
  that is float32 noise into a step of up to lr.  The key bias ``bk`` is
  the extreme case: it adds q.bk to every score of a query row, which the
  softmax ignores, so its gradient is zero in exact arithmetic and float32
  noise in both frameworks (the gradient test holds it to atol 1e-6), and
  Adam moves it by noise-signed steps of lr.  It is held instead to what
  it is: swapping the port's ``bk`` for JAX's changes no output.

Rows that no key reaches (under a causal left-padding mask, the padded
positions) are 0 in the port's flash route and the mean of V in JAX's
dense core; the layer multiplies its output by the mask, so both give 0
there and the comparisons include those rows.
"""

import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import sequence as jax_seq
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models import CharacterIterator, attention_lm
from deeplearning4j_tpu_torch.nn import convert
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.parallel import sequence as seq

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3
WIDTH, HEADS, V, BATCH = 64, 2, 12, 2
T_FLASH, T_DENSE = 256, 64
LR = 0.01


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread, as in the other parity
    tests: multi-threaded float32 reductions have been seen to vary from
    run to run on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_conf(T, window=None):
    """The JAX package's twin of ``attention_lm(V, WIDTH, HEADS, 2, T)``."""
    b = (jax_network.NeuralNetConfiguration.builder().seed(7)
         .learning_rate(LR).updater("adam").list())
    for _ in range(2):
        b.layer(jax_layers.SelfAttentionLayer(
            n_out=WIDTH, n_heads=HEADS, causal=True, cache_window=window))
    b.layer(jax_layers.RnnOutputLayer(n_out=V, activation="softmax",
                                      loss="mcxent"))
    return b.set_input_type(JaxInputType.recurrent(V, T)).build()


def _port_net(T, window=None):
    net = attention_lm(V, WIDTH, HEADS, 2, T, learning_rate=LR, device="cpu")
    for layer in net.layers[:2]:
        layer.cache_window = window
    return net


def _numpy_params(template, seed):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=np.shape(v)) * (
        0.3 if np.ndim(v) == 2 else 0.1)).astype(np.float32)
        for k, v in lp.items()} for lp in template]


def _pair(T, seed=3, window=None):
    """A JAX network and the port's with the same numpy params (the port
    takes them through ``params_from_jax``)."""
    jnet = JaxNet(_jax_conf(T, window)).init()
    params = _numpy_params(jnet.net_params, seed)
    jnet.init(params=[{k: jnp.asarray(v) for k, v in lp.items()}
                      for lp in params])
    net = _port_net(T, window).init()
    net.net_params = convert.params_from_jax(params, device="cpu")
    return jnet, net


def _batch(T, seed=0, pad=None):
    """One-hot characters [B, T, V], next characters as labels, and with
    ``pad`` a left-padding mask (the first ``pad[b]`` steps of row b)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, V, (BATCH, T + 1))
    eye = np.eye(V, dtype=np.float32)
    mask = None
    if pad is not None:
        mask = (np.arange(T)[None, :] >= np.asarray(pad)[:, None]).astype(
            np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]], mask


def _np(t):
    return t.detach().cpu().numpy()


def _counter(name, op):
    fam = monitor.get_registry().get(name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam.samples() if s["labels"]["op"] == op)


# ---------------------------------------------------------------------------
# the attention core
# ---------------------------------------------------------------------------

def _qkv(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32) * 0.5
            for _ in range(3)]


@pytest.mark.parametrize("T,causal,masked", [
    (64, True, False), (64, False, True), (64, True, True),
    (200, True, False), (200, False, True), (200, True, True)])
def test_dense_attention_and_attention_match_jax(T, causal, masked):
    """Under the flash gate (T = 64) both take the dense formula, dead rows
    included; over it (T = 200) the port's plain flash against JAX's dense
    core, on the query rows that have a live key (a dead row is the mean of
    V in the dense core and 0 in flash)."""
    q, k, v = _qkv(2, 2, T, 32, seed=T)
    km = None
    if masked:
        km = np.ones((2, T), np.float32)
        km[0, :5] = 0.0                   # left padding: dead causal rows
        km[1, T // 2:] = 0.0
    flash_route = T >= ck.FLASH_MIN_T
    sel = _counter("dl4j_kernel_selected_total", "attention")
    jk = None if km is None else jnp.asarray(km)
    for strategy in ("auto", "dense", "ring", "ulysses"):
        want = np.asarray(jax_seq.attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            key_mask=jk, strategy=strategy))
        got = _np(seq.attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            key_mask=None if km is None else torch.from_numpy(km),
            strategy=strategy))
        live = np.ones((2, 1, T, 1), bool)
        if flash_route and km is not None:
            keys = km[:, None, :] > 0
            if causal:
                keys = np.tril(np.ones((T, T), bool))[None] & keys
            live = keys.any(-1)[:, None, :, None] if causal else \
                np.broadcast_to(keys.any(-1)[:, :, None, None], (2, 1, T, 1))
        live = np.broadcast_to(live, got.shape)
        np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)
        assert (got[~live] == 0).all()
    assert _counter("dl4j_kernel_selected_total", "attention") - sel == \
        (4 if flash_route else 0)
    dense = _np(seq.dense_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        key_mask=None if km is None else torch.from_numpy(km),
        allow_flash=False))
    np.testing.assert_allclose(dense, np.asarray(jax_seq.dense_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, key_mask=jk,
        allow_flash=False)), rtol=TOL, atol=TOL)


def test_attention_rejects_an_unknown_strategy():
    q = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="unknown attention strategy"):
        seq.attention(q, q, q, strategy="sideways")
    with pytest.raises(ValueError, match="unknown attention strategy"):
        jax_seq.attention(*(jnp.zeros((1, 1, 4, 8)),) * 3,
                          strategy="sideways")


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def test_attention_net_configuration_and_zip_round_trip_both_ways(tmp_path):
    """Both builders give the same configuration JSON, before init and
    after (init sets ``cache_window`` from the declared timesteps); the
    params' flat order is Wk, Wo, Wq, Wv, bk, bo, bq, bv in both; a
    JAX-written zip restores in the port and rewrites to the same
    ``coefficients.bin``, and the port's zip restores in JAX, which
    rewrites it byte for byte."""
    assert _port_net(T_FLASH).conf.to_dict() == _jax_conf(T_FLASH).to_dict()
    jnet, net = _pair(T_FLASH)
    assert net.layers[0].cache_window == jnet.layers[0].cache_window == \
        T_FLASH
    assert net.conf.to_dict() == jnet.conf.to_dict()
    assert net.n_params == jnet.num_params()
    assert [{k: tuple(v.shape) for k, v in lp.items()}
            for lp in net.net_params] == \
        [{k: tuple(v.shape) for k, v in lp.items()} for lp in jnet.net_params]
    np.testing.assert_array_equal(_np(net.params()),
                                  np.asarray(jnet.params()))
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    restored = ser.restore_multi_layer_network(tmp_path / "jax.zip",
                                               device="cpu")
    ser.write_model(restored, tmp_path / "port.zip")
    back = jax_ser.restore_multi_layer_network(tmp_path / "port.zip")
    jax_ser.write_model(back, tmp_path / "back.zip")
    with zipfile.ZipFile(tmp_path / "jax.zip") as a, \
            zipfile.ZipFile(tmp_path / "port.zip") as b, \
            zipfile.ZipFile(tmp_path / "back.zip") as c:
        assert a.read(ser.COEFFICIENTS_NAME) == \
            b.read(ser.COEFFICIENTS_NAME) == c.read(ser.COEFFICIENTS_NAME)
        assert json.loads(b.read(ser.CONFIG_NAME)) == \
            json.loads(a.read(ser.CONFIG_NAME))
    x, _, _ = _batch(T_FLASH, seed=4)
    np.testing.assert_allclose(_np(restored.output(x)),
                               np.asarray(jnet.output(x)), rtol=TOL, atol=TOL)


def test_attention_lm_default_size_and_device():
    """The model at its own widths: 1,534,059 params at V = 107; without a
    device argument it is built for the CUDA device, which raises when
    there is none."""
    net = attention_lm(107, device="cpu").init()
    assert net.n_params == 1_534_059
    assert [l.n_out // l.n_heads for l in net.layers[:2]] == [64, 64]
    assert net.layers[0].cache_window == 8192
    if torch.cuda.is_available():
        assert attention_lm(107).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            attention_lm(107)


@pytest.mark.parametrize("width,lr,rises", [(512, 0.05, True),
                                             (512, 0.005, False),
                                             (64, 0.05, False)])
def test_attention_lm_recipe_lr_at_width_512(width, lr, rises):
    """The example's recipe (Adam at lr 0.05) does not train the model at
    its width of 512: over 6 ``fit`` steps on SURVEY.md's characters
    (batch 4, T = 128, the plain flash versions) the score more than
    doubles.  A tenth of that lr ends below the first step's score, and
    so does lr 0.05 at width 64.  So a rising score in the 8k training run
    is the recipe's, not the kernels'."""
    text = (Path(__file__).resolve().parents[1] / "SURVEY.md").read_text()
    it = CharacterIterator(text, seq_length=128, batch=4, seed=0)
    net = attention_lm(it.vocab_size, width, 8, 2, 128, learning_rate=lr,
                       device="cpu").init(
        generator=torch.Generator().manual_seed(1234))
    scores = []
    for _ in range(6):
        net.fit(it.next())
        scores.append(net.score())
    assert np.isfinite(scores).all()
    if rises:
        assert scores[-1] > 2 * scores[0], scores
    else:
        assert scores[-1] < scores[0], scores


@pytest.mark.parametrize("T,pad,jax_flash", [
    (T_FLASH, None, False), (T_FLASH, [0, 7], False), (T_DENSE, None, False),
    (T_DENSE, [3, 0], False), (T_FLASH, [0, 7], True)])
def test_attention_net_output_matches_jax(T, pad, jax_flash, monkeypatch):
    """``output()`` with and without a left-padding mask; T = 256 takes the
    port's flash route (one selection per layer), T = 64 its dense core."""
    if jax_flash:
        monkeypatch.setenv("DL4J_PALLAS_FLASH", "1")
    jnet, net = _pair(T)
    x, _, mask = _batch(T, seed=1, pad=pad)
    sel = _counter("dl4j_kernel_selected_total", "attention")
    got = _np(net.output(x, mask=mask))
    assert _counter("dl4j_kernel_selected_total", "attention") - sel == \
        (2 if T >= ck.FLASH_MIN_T else 0)
    want = np.asarray(jnet.output(x, mask=mask))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("T,pad", [(T_FLASH, None), (T_FLASH, [0, 9]),
                                   (T_DENSE, [4, 0])])
def test_attention_net_gradients_match_jax(T, pad):
    """Score and every param's gradient; through the flash route the
    gradient comes from the dQ and dK/dV plain versions."""
    jnet, net = _pair(T, seed=5)
    x, y, mask = _batch(T, seed=2, pad=pad)
    jm = None if mask is None else jnp.asarray(mask)
    jscore, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(x), jnp.asarray(y), jm,
        None, jax.random.PRNGKey(0))
    score, grads = net._grad_step(
        torch.from_numpy(x), torch.from_numpy(y),
        None if mask is None else torch.from_numpy(mask), None, None)
    np.testing.assert_allclose(float(score), float(jscore), rtol=GRAD_RTOL)
    for gl, jl in zip(grads, jgrads):
        assert sorted(gl) == sorted(jl)
        for k in jl:
            np.testing.assert_allclose(_np(gl[k]), np.asarray(jl[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


def test_attention_net_adam_fit_matches_jax():
    """Three Adam ``fit`` steps at T = 256 (flash route), with the updater
    state carried by ``opt_states_from_jax`` in between: scores and params
    under the Adam rule, and the updater state byte-equal in the flat
    layout."""
    jnet, net = _pair(T_FLASH, seed=6)
    for step in range(3):
        x, y, mask = _batch(T_FLASH, seed=10 + step,
                            pad=[0, 5] if step == 1 else None)
        jnet.fit(x, y) if mask is None else jnet.fit(
            _jax_ds(x, y, mask))
        net.fit(x, y) if mask is None else net.fit(_port_ds(x, y, mask))
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=ADAM_SCORE_RTOL)
    for i, (lp, jp) in enumerate(zip(net.net_params, jnet.net_params)):
        for k in jp:
            got, want = _np(lp[k]), np.asarray(jp[k])
            if k == "bk":
                continue
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= ADAM_INSIDE, (i, k, ok.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_ATOL,
                                       err_msg=f"layer {i} param {k}")
    assert net.iteration == jnet.iteration == 3
    x, _, _ = _batch(T_FLASH, seed=20)
    out = _np(net.output(x))
    for i in range(2):
        net.net_params[i]["bk"] = torch.from_numpy(
            np.array(jnet.net_params[i]["bk"]))
    np.testing.assert_allclose(_np(net.output(x)), out, rtol=TOL, atol=TOL)
    carried = convert.opt_states_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.opt_states), device="cpu")
    fresh = _port_net(T_FLASH).init()
    fresh.opt_states = carried
    np.testing.assert_array_equal(_np(fresh.updater_state_flat()),
                                  np.asarray(jnet.updater_state_flat()))


def _jax_ds(x, y, mask):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    return JaxDataSet(x, y, mask, mask)


def _port_ds(x, y, mask):
    from deeplearning4j_tpu_torch.datasets import DataSet
    return DataSet(x, y, mask, mask)


# ---------------------------------------------------------------------------
# decoding through the KV ring
# ---------------------------------------------------------------------------

def _ring(net, layer):
    return net.net_state[layer]["rnn_state"]


def test_rnn_time_step_matches_jax_and_causal_output():
    """130 characters one at a time (window 130, no wraparound) equal
    JAX's ``rnn_time_step`` and ``output()`` on the whole prefix — which at
    T = 130 takes the flash route — and the rings hold JAX's K, V and
    positions; a chunk of several characters equals the same characters
    one at a time."""
    T = 130
    jnet, net = _pair(T, seed=8)
    x, _, _ = _batch(T, seed=3)
    full = _np(net.output(x))
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), rtol=TOL,
                               atol=TOL)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    steps, jsteps = [], []
    for t in range(T):
        steps.append(_np(net.rnn_time_step(x[:, t:t + 1])))
        jsteps.append(np.asarray(jnet.rnn_time_step(x[:, t:t + 1])))
    steps, jsteps = np.concatenate(steps, 1), np.concatenate(jsteps, 1)
    np.testing.assert_allclose(steps, jsteps, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(steps, full, rtol=TOL, atol=TOL)
    for layer in range(2):
        ring, jring = _ring(net, layer), jnet.net_state[layer]["rnn_state"]
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(ring[key]), np.asarray(jring[key]),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(_np(ring["pos"]),
                                      np.asarray(jring["pos"]))
    net.rnn_clear_previous_state()
    chunks = np.concatenate([_np(net.rnn_time_step(x[:, :7])),
                             _np(net.rnn_time_step(x[:, 7:20]))], axis=1)
    np.testing.assert_allclose(chunks, full[:, :20], rtol=TOL, atol=TOL)


def test_rnn_time_step_window_wraps_around_like_jax():
    """A window of 8 over a stream of 20: entries older than the window
    are overwritten and no longer attended, as in JAX's ring; fed in
    chunks (one scan in JAX, one loop in the port) the same."""
    T, W = 20, 8
    jnet, net = _pair(T, seed=9, window=W)
    assert net.layers[0].cache_window == W
    x, _, _ = _batch(T, seed=4)
    for chunk in (1, 5):
        net.rnn_clear_previous_state()
        jnet.rnn_clear_previous_state()
        for t in range(0, T, chunk):
            got = _np(net.rnn_time_step(x[:, t:t + chunk]))
            want = np.asarray(jnet.rnn_time_step(x[:, t:t + chunk]))
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert _ring(net, 0)["k"].shape[2] == W
        assert _np(_ring(net, 1)["pos"]).tolist() == [T, T]
    # past the window the stream no longer equals causal output()
    assert not np.allclose(got, _np(net.output(x))[:, -chunk:], atol=1e-3)


def test_masked_pad_token_advances_nothing_and_clear_restarts():
    """A pad token (mask 0) of one stream writes nothing to its ring and
    advances nothing: that stream's later outputs equal a run without the
    pad, the pad step itself outputs 0, and JAX agrees step by step.
    ``rnn_clear_previous_state`` drops the rings: the next call starts
    afresh."""
    T = 12
    jnet, net = _pair(T, seed=10)
    x, _, _ = _batch(T, seed=5)
    clean = np.concatenate([_np(net.rnn_time_step(x[:, t:t + 1]))
                            for t in range(T)], axis=1)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    pad_at = 4
    outs = []
    for t in range(T + 1):
        src = t if t <= pad_at else t - 1      # stream 1 repeats one input
        xt = np.stack([x[0, min(t, T - 1)], x[1, src]])[:, None]
        m = np.ones((BATCH, 1), np.float32)
        if t == pad_at:
            m[1] = 0.0
        got = _np(net.rnn_time_step(xt, mask=m))
        want = np.asarray(jnet.rnn_time_step(xt, mask=m))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        outs.append(got)
        if t == pad_at:       # the attention layers output 0: softmax(b)
            np.testing.assert_allclose(
                got[1, 0], _np(torch.softmax(net.net_params[-1]["b"], 0)),
                rtol=TOL, atol=1e-6)
            assert _np(_ring(net, 0)["pos"]).tolist() == [t + 1, t]
    stream1 = np.concatenate([o[1:2] for i, o in enumerate(outs)
                              if i != pad_at], axis=1)
    np.testing.assert_allclose(stream1, clean[1:2], rtol=TOL, atol=TOL)
    net.rnn_clear_previous_state()
    assert all("rnn_state" not in s for s in net.net_state)
    first = _np(net.rnn_time_step(x[:, :1]))
    np.testing.assert_allclose(first, clean[:, :1], rtol=TOL, atol=TOL)
    assert _np(_ring(net, 0)["pos"]).tolist() == [1, 1]


def test_decode_scope_is_only_entered_by_rnn_time_step():
    """``output()`` and ``fit`` run the attention core, not the ring, and
    keep no ring; the scope is off again after ``rnn_time_step``."""
    jnet, net = _pair(T_DENSE, seed=11)
    x, y, _ = _batch(T_DENSE, seed=6)
    net.output(x)
    net.fit(x, y)
    assert all("rnn_state" not in s for s in net.net_state)
    net.rnn_time_step(x[:, :2])
    assert not seq.kv_decode_active()
    assert "rnn_state" in net.net_state[0]
    with seq.kv_decode_scope():
        assert seq.kv_decode_active()
    assert isinstance(net, MultiLayerNetwork)
