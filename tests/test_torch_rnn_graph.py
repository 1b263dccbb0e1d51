"""The recurrent extras of the port — truncated BPTT and ``rnn_time_step``
of a ComputationGraph, ``rnn_carry_template`` on both engines and
``MultiLayerNetwork.rnn_activate_using_stored_state`` — held against the
JAX package on the CPU.

The net is the JAX suite's graph char-RNN (``tests/test_cg_rnn_parallel_es
.py``): 2 x GravesLSTM(16) and a softmax RnnOutputLayer over a vocabulary
of 12, TBPTT segments of 4.  Both packages start from JAX's params.

Tolerances, float32 on both sides with sums in other orders over up to 12
steps of recurrence: outputs, activations and scores rtol = atol = 1e-5
(the LSTM suites' rule); params after 2 batches of TBPTT ``fit`` (6 plain
SGD updates, linear in the gradient) rtol = 1e-4, atol = 1e-6.  The
graph's ``rnn_time_step`` against the network's on the same params runs
the same operations in the same order: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models.charrnn import char_rnn as jax_char_rnn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models import charrnn
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.recurrent import LSTMState

V, H, SEG = 12, 16, 4
TOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_graph(tbptt=False, updater="sgd"):
    g = jax_network.GlobalConf(seed=5, learning_rate=0.1, updater=updater,
                               weight_init="xavier")
    b = (jax_gc.GraphBuilder(g).add_inputs("in")
         .add_layer("lstm1", jax_layers.GravesLSTM(n_in=V, n_out=H,
                                                   activation="tanh"), "in")
         .add_layer("lstm2", jax_layers.GravesLSTM(n_in=H, n_out=H,
                                                   activation="tanh"),
                    "lstm1")
         .add_layer("out", jax_layers.RnnOutputLayer(
             n_in=H, n_out=V, activation="softmax", loss="mcxent"), "lstm2")
         .set_outputs("out"))
    if tbptt:
        b.backprop_type("truncatedbptt")
        b.t_bptt_forward_length(SEG).t_bptt_backward_length(SEG)
    return JaxGraph(b.build()).init()


def _pair(**kw):
    jnet = _jax_graph(**kw)
    # JAX's init leaves the peepholes at 0: give them values, so the
    # carried cell state reaches the gates in both packages
    rng = np.random.default_rng(11)
    params = {n: {k: (rng.normal(size=np.shape(v)).astype(np.float32) * 0.3
                      if k in ("pI", "pF", "pO") else np.asarray(v))
                  for k, v in lp.items()}
              for n, lp in jnet.net_params.items()}
    jnet.net_params = {n: {k: jnp.asarray(v) for k, v in lp.items()}
                       for n, lp in params.items()}
    port = ComputationGraph(
        ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
        device="cpu")
    port.load_jax_params(params)
    port.load_jax_state({n: {} for n in jnet.net_state})
    return jnet, port


def _batch(n=4, t=12, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    x = eye[rng.integers(0, V, (n, t))]
    y = eye[rng.integers(0, V, (n, t))]
    fm = lm = None
    if masked:
        fm = np.ones((n, t), np.float32)
        for i in range(n):
            fm[i, rng.integers(t // 2, t + 1):] = 0.0
        lm = fm.copy()
    return x, y, fm, lm


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_graph_tbptt_fit_matches_jax(masked):
    """Two batches of 12 steps in segments of 4: 6 updates, each segment
    from the carries the previous one ended in (masks sliced with the
    features), the carries cleared between batches."""
    jnet, port = _pair(tbptt=True)
    scores_j, scores_p = [], []
    for seed in (1, 2):
        x, y, fm, lm = _batch(seed=seed, masked=masked)
        masks = (None, None) if not masked else ([fm], [lm])
        jnet.fit(JaxMDS([x], [y], *masks))
        port.fit(MultiDataSet([x], [y], *masks))
        scores_j.append(float(jnet.score()))
        scores_p.append(port.score())
    assert port.iteration == jnet.iteration == 6
    np.testing.assert_allclose(scores_p, scores_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.params().numpy(),
                               np.asarray(jnet.params()),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    # the last segment's carries stay stored, as in JAX
    for name in ("lstm1", "lstm2"):
        got = port.net_state[name]["rnn_state"]
        want = jnet.net_state[name]["rnn_state"]
        np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h),
                                   rtol=1e-4, atol=1e-5)


def test_graph_tbptt_clears_carries_between_batches():
    """The JAX suite's rule: a stale carry from the previous batch does
    not leak into the next batch's first segment."""
    _, port = _pair(tbptt=True)
    ref = port.clone()
    x, y, _, _ = _batch(t=8, seed=3)
    port.fit(MultiDataSet([x], [y]))
    assert any("rnn_state" in s for s in port.net_state.values())
    port.fit(MultiDataSet([x], [y]))
    ref.rnn_clear_previous_state()
    ref.fit(MultiDataSet([x], [y]))
    ref.rnn_clear_previous_state()
    ref.fit(MultiDataSet([x], [y]))
    assert port.score() == ref.score()
    assert torch.equal(port.params(), ref.params())


def test_graph_rnn_time_step_matches_jax_output_and_network():
    jnet, port = _pair()
    x, _, _, _ = _batch(t=8, seed=4)
    (full,) = port.output(x)
    jnet.rnn_clear_previous_state()
    port.rnn_clear_previous_state()
    got, want = [], []
    for t0 in range(0, 8, 2):
        (o,) = port.rnn_time_step(x[:, t0:t0 + 2])
        (jo,) = jnet.rnn_time_step(x[:, t0:t0 + 2])
        got.append(o.numpy())
        want.append(np.asarray(jo))
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, np.concatenate(want, axis=1),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, full.numpy(), rtol=TOL, atol=TOL)
    # the MultiLayerNetwork of the same layers and params steps alike
    net = charrnn.char_rnn(vocab_size=V, hidden=H, layers=2,
                           device="cpu")
    net.init()
    net.net_params = [dict(port.net_params[n])
                      for n in ("lstm1", "lstm2", "out")]
    net.rnn_clear_previous_state()
    port.rnn_clear_previous_state()
    for t0 in range(0, 8, 2):
        (o,) = port.rnn_time_step(x[:, t0:t0 + 2])
        assert torch.equal(o, net.rnn_time_step(x[:, t0:t0 + 2]))
    # a cleared state starts again from zeros
    port.rnn_clear_previous_state()
    (again,) = port.rnn_time_step(x[:, :2])
    np.testing.assert_allclose(again.numpy(), got[:, :2], rtol=TOL,
                               atol=TOL)


def _shapes(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_shapes(t) for t in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_carry_templates_match_jax_and_step_from_zeros():
    jnet, port = _pair()
    tmpl = port.rnn_carry_template(3, feature_tails=[(1, V)])
    want = jnet.rnn_carry_template(3, feature_tails=[(1, V)])
    assert _shapes(tmpl) == _shapes(want)
    assert all(isinstance(c, LSTMState) and not c.c.any() and
               c.h.device.type == "cpu" for c in tmpl.values())
    x, _, _, _ = _batch(n=3, t=2, seed=5)
    port.rnn_clear_previous_state()
    (fresh,) = port.rnn_time_step(x)
    port.rnn_clear_previous_state()
    for name, c in tmpl.items():
        port.net_state[name]["rnn_state"] = c
    (from_tmpl,) = port.rnn_time_step(x)
    assert torch.equal(fresh, from_tmpl)

    jmln = jax_char_rnn(vocab_size=8, hidden=8, layers=2)
    jmln.init()
    mln = charrnn.char_rnn(vocab_size=8, hidden=8, layers=2, device="cpu")
    mln.init()
    got = mln.rnn_carry_template(5)
    assert _shapes(got) == _shapes(jmln.rnn_carry_template(5))
    assert got[-1] is None and isinstance(got[0], LSTMState)


def test_rnn_activate_using_stored_state_matches_jax():
    """JAX's rule (tests/test_cg_rnn_parallel_es.py:221): activations from
    the stored carries, continued by a second call, equal the stepped
    forward; without ``store_last_for_tbptt`` the carries do not move."""
    jnet = jax_char_rnn(vocab_size=8, hidden=8, layers=1)
    jnet.init()
    net = charrnn.char_rnn(vocab_size=8, hidden=8, layers=1, device="cpu")
    net.load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                         for lp in jnet.net_params])
    net.net_state = [{} for _ in net.layers]
    eye = np.eye(8, dtype=np.float32)
    x1 = eye[np.random.default_rng(0).integers(0, 8, (2, 3))]
    x2 = eye[np.random.default_rng(1).integers(0, 8, (2, 3))]
    for m in (jnet, net):
        m.rnn_clear_previous_state()
    acts = net.rnn_activate_using_stored_state(x1, store_last_for_tbptt=True)
    jacts = jnet.rnn_activate_using_stored_state(
        x1, store_last_for_tbptt=True)
    assert len(acts) == len(jacts) == len(net.layers)
    for a, ja in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=TOL,
                                   atol=TOL)
    out_b = net.rnn_activate_using_stored_state(x2)[-1].numpy()
    np.testing.assert_allclose(
        out_b, np.asarray(jnet.rnn_activate_using_stored_state(x2)[-1]),
        rtol=TOL, atol=TOL)
    net.rnn_clear_previous_state()
    full = net.rnn_time_step(np.concatenate([x1, x2], axis=1)).numpy()
    np.testing.assert_allclose(out_b, full[:, 3:], rtol=TOL, atol=TOL)
    net.rnn_clear_previous_state()
    a1 = net.rnn_activate_using_stored_state(x1)[-1]
    assert torch.equal(a1, net.rnn_activate_using_stored_state(x1)[-1])
