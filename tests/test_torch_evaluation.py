"""The port's evaluation path — ``nn/evaluation.py``,
``MultiLayerNetwork.evaluate`` and ``score_examples`` — held against the
JAX package on the CPU.

The metric classes get the same seeded labels and predictions in both
packages (numpy, and in the port also torch tensors).  Tolerances: counts
(confusion matrices, true/false positive counts) and ``stats()`` strings
are equal; every float metric agrees within 1e-12, since both accumulate
the same counts in float64 with numpy.

The networks are written by the JAX package as a zip and restored in the
port (LeNet, and a masked char-RNN of 2 x GravesLSTM(16) over 12
characters).  ``score_examples`` agrees within 1e-5 relative, with and
without an l2 penalty: the same float32 forward with sums in another
order.  ``evaluate``'s confusion matrix equals JAX's; that is only a fair
demand where every example's top class beats its second by more than
twice the largest difference between the two packages' outputs, so the
tests assert that margin on the data they use instead of choosing data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.models import charrnn as jax_charrnn
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import evaluation as jax_eval
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import evaluation as port_eval
from deeplearning4j_tpu_torch.nn import serialization as ser

FLOAT_TOL = 1e-12
SCORE_RTOL = 1e-5
C, N = 5, 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread: on a loaded host its
    multi-threaded float32 reductions have been seen to differ from run
    to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _classification(seed, shape=(N,), classes=C):
    """One-hot labels, softmax predictions and a 0/1 mask of ``shape``."""
    rng = np.random.default_rng(seed)
    labels = np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, shape)]
    logits = rng.normal(size=shape + (classes,)) + 2.0 * labels
    e = np.exp(logits - logits.max(-1, keepdims=True))
    preds = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    mask = (rng.random(shape) < 0.7).astype(np.float32)
    return labels, preds, mask


def _assert_floats(got, want):
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def _assert_evaluation_equal(ev, jev):
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.stats() == jev.stats()
    for name in ("accuracy", "precision", "recall", "f1"):
        _assert_floats(getattr(ev, name)(), getattr(jev, name)())
    for c in range(jev.n_classes):
        for name in ("precision", "recall", "f1", "false_positive_rate"):
            _assert_floats(getattr(ev, name)(c), getattr(jev, name)(c))


@pytest.mark.parametrize("case", ["plain", "masked_rows", "time_series",
                                  "masked_time_series"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_evaluation_matches_jax(case, as_tensor):
    shape = (N // 8, 8) if "time_series" in case else (N,)
    labels, preds, mask = _classification(len(case), shape)
    if case == "plain" or case == "time_series":
        mask = None
    meta = [f"record-{i}" for i in range(shape[0])]
    ev, jev = port_eval.Evaluation(), jax_eval.Evaluation()
    # the 2-D row mask is the JAX package's: it is only read for 3-D labels
    jev.eval(labels, preds, mask=mask, record_meta_data=meta)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    ev.eval(conv(labels), conv(preds),
            mask=None if mask is None else conv(mask), record_meta_data=meta)
    _assert_evaluation_equal(ev, jev)
    got = [(p.actual, p.predicted, p.record_meta_data)
           for p in ev.get_prediction_errors()]
    want = [(p.actual, p.predicted, p.record_meta_data)
            for p in jev.get_prediction_errors()]
    assert got == want and len(got) > 0
    for c in range(C):
        assert len(ev.get_predictions_by_actual_class(c)) == \
            len(jev.get_predictions_by_actual_class(c))
        assert len(ev.get_predictions_by_predicted_class(c)) == \
            len(jev.get_predictions_by_predicted_class(c))


def test_evaluation_merge_matches_jax():
    parts = [_classification(s) for s in (1, 2, 3)]
    ev, jev = port_eval.Evaluation(), jax_eval.Evaluation()
    for labels, preds, _ in parts:
        one, jone = port_eval.Evaluation(), jax_eval.Evaluation()
        one.eval(labels, preds)
        jone.eval(labels, preds)
        ev.merge(one)
        jev.merge(jone)
    _assert_evaluation_equal(ev, jev)
    with pytest.raises(ValueError, match="class-count"):
        small = port_eval.Evaluation()
        small.eval(*_classification(4, classes=3)[:2])
        ev.merge(small)


@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_binary_matches_jax(masked):
    rng = np.random.default_rng(7)
    labels = (rng.random((N, 4)) < 0.4).astype(np.float32)
    preds = np.clip(labels * 0.5 + rng.random((N, 4)) * 0.6, 0, 1)
    mask = (rng.random((N, 4)) < 0.8).astype(np.float32) if masked else None
    ev, jev = port_eval.EvaluationBinary(0.5), jax_eval.EvaluationBinary(0.5)
    ev.eval(torch.from_numpy(labels), preds, mask=mask)
    jev.eval(labels, preds, mask=mask)
    for k in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(ev, k), getattr(jev, k))
    for i in range(4):
        for name in ("accuracy", "precision", "recall", "f1"):
            _assert_floats(getattr(ev, name)(i), getattr(jev, name)(i))


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(9)
    ev, jev = port_eval.RegressionEvaluation(), \
        jax_eval.RegressionEvaluation()
    for _ in range(3):
        labels = rng.normal(size=(40, 3)).astype(np.float32)
        preds = (labels + rng.normal(size=(40, 3)) * 0.3).astype(np.float32)
        ev.eval(torch.from_numpy(labels), torch.from_numpy(preds))
        jev.eval(labels, preds)
    assert ev.n == jev.n
    for col in range(3):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "correlation_r2"):
            _assert_floats(getattr(ev, name)(col), getattr(jev, name)(col))


def test_roc_family_matches_jax():
    rng = np.random.default_rng(11)
    labels2, preds2, _ = _classification(12, classes=2)
    roc, jroc = port_eval.ROC(50), jax_eval.ROC(50)
    roc.eval(torch.from_numpy(labels2), preds2)
    jroc.eval(labels2, preds2)
    for got, want in zip(roc.roc_curve(), jroc.roc_curve()):
        _assert_floats(got, want)
    _assert_floats(roc.auc(), jroc.auc())

    labels, preds, _ = _classification(13)
    multi, jmulti = port_eval.ROCMultiClass(40), jax_eval.ROCMultiClass(40)
    multi.eval(labels, torch.from_numpy(preds))
    jmulti.eval(labels, preds)
    for c in range(C):
        _assert_floats(multi.auc(c), jmulti.auc(c))

    ml = (rng.random((N // 8, 8, 3)) < 0.5).astype(np.float32)
    mp = np.clip(ml * 0.4 + rng.random((N // 8, 8, 3)) * 0.7, 0, 1)
    for mask in (None, (rng.random((N // 8, 8)) < 0.7).astype(np.float32),
                 (rng.random(ml.shape) < 0.7).astype(np.float32)):
        rb, jrb = port_eval.ROCBinary(30), jax_eval.ROCBinary(30)
        rb.eval(torch.from_numpy(ml), mp, mask=mask)
        jrb.eval(ml, mp, mask=mask)
        assert rb.num_outputs() == jrb.num_outputs() == 3
        for o in range(3):
            _assert_floats(rb.auc(o), jrb.auc(o))
            for got, want in zip(rb.roc_curve(o), jrb.roc_curve(o)):
                _assert_floats(got, want)


# ---------------------------------------------------------------------------
# MultiLayerNetwork.evaluate and score_examples on JAX-written zips
# ---------------------------------------------------------------------------

def _with_l2(jnet, l2):
    for layer in jnet.conf.layers:
        layer.l2, layer.l2_bias = l2, l2 / 10
    return jnet


def _lenet_pair(tmp_path, l2=0.0):
    jnet = _with_l2(jax_lenet(seed=5), l2).init()
    jax_ser.write_model(jnet, tmp_path / "lenet.zip")
    return jnet, ser.restore_multi_layer_network(tmp_path / "lenet.zip",
                                                 device="cpu")


def _lenet_batches(n=3, batch=24):
    rng = np.random.default_rng(21)
    return [(rng.random((batch, 1, 28, 28), np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
            for _ in range(n)]


def _charrnn_pair(tmp_path, l2=0.0):
    """The masked char-RNN of ``tests/test_torch_charrnn.py`` at its size,
    written by JAX with params drawn by numpy."""
    V, H = 12, 16
    jnet = _with_l2(jax_charrnn.char_rnn(V, H, 2, tbptt_length=5), l2)
    jnet.init()
    rng = np.random.default_rng(3)
    jnet.init(params=[{k: jnp.asarray((rng.normal(size=np.shape(v)) * (
        0.3 if np.ndim(v) == 2 else 0.1)).astype(np.float32))
        for k, v in lp.items()} for lp in jnet.net_params])
    jax_ser.write_model(jnet, tmp_path / "charrnn.zip")
    return jnet, ser.restore_multi_layer_network(tmp_path / "charrnn.zip",
                                                 device="cpu")


def _charrnn_batches(n=2, batch=4, T=20, V=12):
    rng = np.random.default_rng(31)
    out = []
    for _ in range(n):
        eye = np.eye(V, dtype=np.float32)
        x = eye[rng.integers(0, V, (batch, T))]
        y = eye[rng.integers(0, V, (batch, T))]
        lens = rng.integers(3, T + 1, batch)
        mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
        out.append((x, y, mask))
    return out


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_score_examples_matches_jax_lenet(tmp_path, l2):
    jnet, net = _lenet_pair(tmp_path, l2)
    batches = _lenet_batches()
    ds = [DataSet(x, y) for x, y in batches]
    jds = [JaxDataSet(x, y) for x, y in batches]
    for add_reg in (False, True):
        got = net.score_examples(ListDataSetIterator(ds), add_reg)
        want = jnet.score_examples(JaxListIterator(jds), add_reg)
        assert got.shape == (72,)
        np.testing.assert_allclose(got, np.asarray(want), rtol=SCORE_RTOL)
        one = net.score_examples(ds[0], add_reg)
        np.testing.assert_allclose(one, got[:24], rtol=SCORE_RTOL)
    if l2:
        assert not np.allclose(net.score_examples(ds[0], True),
                               net.score_examples(ds[0], False))


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_score_examples_matches_jax_masked_char_rnn(tmp_path, l2):
    jnet, net = _charrnn_pair(tmp_path, l2)
    for x, y, mask in _charrnn_batches():
        for add_reg in (False, True):
            got = net.score_examples(DataSet(x, y, mask, mask), add_reg)
            want = jnet.score_examples(JaxDataSet(x, y, mask, mask), add_reg)
            np.testing.assert_allclose(got, np.asarray(want),
                                       rtol=SCORE_RTOL)


def _top2_margin(out):
    top = np.sort(out.reshape(-1, out.shape[-1]), axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _assert_evaluate_matches(net, jnet, batches, jbatches, outputs):
    """``outputs``: (port, jax) output pairs of every batch."""
    diff = max(float(np.abs(a - b).max()) for a, b in outputs)
    margin = min(_top2_margin(b) for _, b in outputs)
    assert margin > 2 * diff, (margin, diff)
    ev = net.evaluate(ListDataSetIterator(batches))
    jev = jnet.evaluate(JaxListIterator(jbatches))
    _assert_evaluation_equal(ev, jev)


def test_evaluate_matches_jax_lenet(tmp_path):
    jnet, net = _lenet_pair(tmp_path)
    batches = _lenet_batches()
    outputs = [(net.output(x).numpy(), np.asarray(jnet.output(x)))
               for x, _ in batches]
    _assert_evaluate_matches(net, jnet, [DataSet(x, y) for x, y in batches],
                             [JaxDataSet(x, y) for x, y in batches], outputs)
    one = net.evaluate(DataSet(*batches[0]))
    assert one.confusion.matrix.sum() == 24


def test_evaluate_matches_jax_masked_char_rnn(tmp_path):
    jnet, net = _charrnn_pair(tmp_path)
    batches = _charrnn_batches()
    outputs = []
    for x, _, mask in batches:
        keep = mask.astype(bool)
        outputs.append((net.output(x).numpy()[keep],
                        np.asarray(jnet.output(x))[keep]))
    _assert_evaluate_matches(
        net, jnet, [DataSet(x, y, None, m) for x, y, m in batches],
        [JaxDataSet(x, y, None, m) for x, y, m in batches], outputs)
