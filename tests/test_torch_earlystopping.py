"""The port's early stopping (``nn/earlystopping.py``) held against the
JAX package on the CPU.

Both trainers start from the same params and take the same batches; the
termination reason and details, the epoch count, ``best_model_epoch`` and
the scores of ``score_vs_epoch`` must agree.  The scores are held at rtol
1e-3 under Adam and 1e-4 under SGD: the rules of
``tests/test_torch_fit.py`` for those updaters' training scores.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.nn import earlystopping as jax_es
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import earlystopping as es
from test_torch_transfer import (
    base_graph, graph_data, iris_data, iris_net, port_of)

ADAM_SCORE_RTOL, SGD_SCORE_RTOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(conditions, lr=0.05, saver=None, iteration_conditions=(),
              updater="adam"):
    """Both trainers on the iris split of the JAX tests (100 train rows in
    batches of 32, 50 held out) -> (port result, JAX result, port net)."""
    x, y = iris_data()
    jnet = iris_net(lr=lr, updater=updater)
    net = port_of(jnet)
    jcfg = jax_es.EarlyStoppingConfiguration(
        score_calculator=jax_es.DataSetLossCalculator(
            JaxDataSet(x[100:], y[100:])),
        epoch_termination_conditions=conditions(jax_es),
        iteration_termination_conditions=[
            c(jax_es) for c in iteration_conditions])
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(DataSet(x[100:], y[100:])),
        model_saver=saver or es.InMemoryModelSaver(),
        epoch_termination_conditions=conditions(es),
        iteration_termination_conditions=[
            c(es) for c in iteration_conditions])
    jres = jax_es.EarlyStoppingTrainer(
        jcfg, jnet, JaxListIterator(JaxDataSet(x[:100], y[:100]), 32)).fit()
    res = es.EarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(DataSet(x[:100], y[:100]), 32)).fit()
    return res, jres, net


def _assert_results_alike(res, jres, rtol):
    assert res.termination_reason == jres.termination_reason
    assert res.termination_details == jres.termination_details
    assert res.total_epochs == jres.total_epochs
    assert res.best_model_epoch == jres.best_model_epoch
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose(
        [res.score_vs_epoch[e] for e in sorted(res.score_vs_epoch)],
        [jres.score_vs_epoch[e] for e in sorted(jres.score_vs_epoch)],
        rtol=rtol)
    np.testing.assert_allclose(res.best_model_score, jres.best_model_score,
                               rtol=rtol)


def test_max_epochs_termination_matches_jax():
    """TestEarlyStopping.test_max_epochs_termination: MaxEpochs(5) with an
    InvalidScore iteration condition, Adam; the best model is a copy."""
    res, jres, net = _run_both(
        lambda m: [m.MaxEpochsTerminationCondition(5)],
        iteration_conditions=[
            lambda m: m.InvalidScoreIterationTerminationCondition()])
    _assert_results_alike(res, jres, ADAM_SCORE_RTOL)
    assert res.termination_reason == "EpochTerminationCondition"
    assert res.total_epochs == 5 and res.best_model_score < 2.0
    assert res.best_model is not net and net.iteration == 20
    x, y = iris_data()
    np.testing.assert_allclose(res.best_model.score(DataSet(x[100:], y[100:])),
                               res.best_model_score, rtol=1e-6)


def test_score_improvement_termination_matches_jax():
    """TestEarlyStopping.test_score_improvement_termination: lr 0, so no
    epoch improves and ScoreImprovement(2) stops at epoch 3 of 50."""
    res, jres, _ = _run_both(
        lambda m: [m.ScoreImprovementEpochTerminationCondition(2),
                   m.MaxEpochsTerminationCondition(50)], lr=0.0)
    _assert_results_alike(res, jres, SGD_SCORE_RTOL)
    assert res.total_epochs == 4 and res.best_model_epoch == 0


def test_local_file_saver_best_model_matches_get_best(tmp_path):
    """LocalFileModelSaver: the zip of the best epoch, read back on the
    CPU, gives the output the saved network gave; MaxScore stops the run
    at its first iteration, as JAX's does."""
    saver = es.LocalFileModelSaver(tmp_path, device="cpu")
    res, jres, _ = _run_both(
        lambda m: [m.MaxEpochsTerminationCondition(3)], saver=saver,
        updater="sgd")
    _assert_results_alike(res, jres, SGD_SCORE_RTOL)
    best = saver.get_best()
    assert (tmp_path / "bestModel.zip").exists()
    x, _ = iris_data()
    np.testing.assert_array_equal(best.output(x).numpy(),
                                  res.best_model.output(x).numpy())
    res, jres, _ = _run_both(
        lambda m: [m.MaxEpochsTerminationCondition(3)], updater="sgd",
        iteration_conditions=[
            lambda m: m.MaxScoreIterationTerminationCondition(0.0)])
    _assert_results_alike(res, jres, SGD_SCORE_RTOL)
    assert res.termination_reason == "IterationTerminationCondition"
    assert res.best_model_epoch == -1 and res.total_epochs == 1


def test_graph_trainer_matches_jax():
    """EarlyStoppingGraphTrainer on the graph of tests/test_transfer_graph.py,
    with the latest model saved too."""
    jnet = base_graph()
    net = port_of(jnet)
    x, y = graph_data(48)
    held = graph_data(16, seed=1)
    jcfg = jax_es.EarlyStoppingConfiguration(
        score_calculator=jax_es.DataSetLossCalculator(JaxDataSet(*held)),
        epoch_termination_conditions=[
            jax_es.MaxEpochsTerminationCondition(3)],
        save_last_model=True)
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(DataSet(*held)),
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(3)],
        save_last_model=True)
    jres = jax_es.EarlyStoppingGraphTrainer(
        jcfg, jnet, JaxListIterator(JaxDataSet(x, y), 16)).fit()
    res = es.EarlyStoppingGraphTrainer(
        cfg, net, ListDataSetIterator(DataSet(x, y), 16)).fit()
    _assert_results_alike(res, jres, SGD_SCORE_RTOL)
    latest = cfg.model_saver.get_latest()
    assert torch.equal(latest.params(), net.params())


def test_termination_conditions_match_jax():
    """The six conditions decide alike on the same score sequences."""
    scores = [1.0, 0.9, 0.95, 0.91, 0.89, float("nan"), float("inf"), 3.0]
    pairs = [
        (lambda m: m.MaxEpochsTerminationCondition(4), "epoch"),
        (lambda m: m.ScoreImprovementEpochTerminationCondition(1, 0.02),
         "epoch"),
        (lambda m: m.BestScoreEpochTerminationCondition(0.9), "epoch"),
        (lambda m: m.MaxScoreIterationTerminationCondition(2.0), "iter"),
        (lambda m: m.InvalidScoreIterationTerminationCondition(), "iter"),
        (lambda m: m.MaxTimeIterationTerminationCondition(3600.0), "iter"),
    ]
    for make, _ in pairs:
        ours, theirs = make(es), make(jax_es)
        assert [ours.terminate(i, s) for i, s in enumerate(scores)] == \
            [theirs.terminate(i, s) for i, s in enumerate(scores)]
    assert es.MaxTimeIterationTerminationCondition(-1.0).terminate(0, 0.0)
    with pytest.raises(ValueError):
        es.validate_termination_conditions(es.EarlyStoppingConfiguration(
            score_calculator=None))
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=None, evaluate_every_n_epochs=5,
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(3)])
    assert es.check_score_free_epoch_conditions(cfg, 1) is None
    assert es.check_score_free_epoch_conditions(cfg, 2) is not None
    assert math.isinf(es.ScoreImprovementEpochTerminationCondition(1)._best)


def test_loss_calculator_averages_over_an_iterator():
    """DataSetLossCalculator over an iterator of batches: the row-weighted
    mean of the batch scores (or their weighted sum), as JAX's."""
    x, y = iris_data()
    jnet = iris_net()
    net = port_of(jnet)
    for average in (True, False):
        got = es.DataSetLossCalculator(
            ListDataSetIterator(DataSet(x, y), 40), average).calculate_score(
                net)
        want = jax_es.DataSetLossCalculator(
            JaxListIterator(JaxDataSet(x, y), 40), average).calculate_score(
                jnet)
        np.testing.assert_allclose(got, want, rtol=1e-5)
