"""The port's training listeners (``nn/listeners.py``) and both engines'
fit hooks, held against the JAX package on the CPU.

The same listeners ride a JAX network and the port's from the same
params over the same batches: they must fire at the same iterations and
epochs, in the same order, and read the same scores, to rtol 1e-6 (a
few SGD / Nesterovs steps of a small dense net in float32: the scores
agree to about 1e-7 relative; the fit rule of ``tests/test_torch_fit.py``
is 1e-4).  ``ParamAndGradientIterationListener``'s TSV has the same
columns and its magnitudes agree to 1e-5.
"""

import logging

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
import deeplearning4j_tpu.nn.listeners as jax_lst
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.monitor.registry import LatencyHistogram
from deeplearning4j_tpu_torch.nn import listeners as lst
from test_torch_transfer import (
    base_graph, graph_data, iris_data, iris_net, port_of)

SCORE_RTOL = 1e-6
MAGNITUDE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder(base):
    """A TrainingListener class over ``base`` (either package's) that
    logs every hook with the model's iteration and epoch, and the score
    on each iteration."""
    class Recorder(base):
        def __init__(self):
            self.events = []

        def on_epoch_start(self, model):
            self.events.append(("start", model.iteration, model.epoch))

        def on_epoch_end(self, model):
            self.events.append(("end", model.iteration, model.epoch))

        def iteration_done(self, model, iteration):
            self.events.append(("iter", iteration, model.epoch,
                                float(model.score())))
    return Recorder()


def _assert_events_equal(got, want):
    assert [e[:3] for e in got] == [e[:3] for e in want]
    for g, w in zip(got, want):
        if g[0] == "iter":
            np.testing.assert_allclose(g[3], w[3], rtol=SCORE_RTOL)


def test_listeners_fire_as_in_jax(tmp_path, caplog):
    """CollectScores, ScoreIteration, ParamAndGradient (TSV) and a
    TrainingListener on an iris net, 2 epochs of 3 Nesterovs steps, then
    one ``fit(x, y)`` call: the same hooks at the same iterations and
    epochs with the same scores."""
    x, y = iris_data()
    jnet = iris_net(updater="nesterovs")
    net = port_of(jnet)
    jrec, rec = _recorder(jax_lst.TrainingListener), _recorder(
        lst.TrainingListener)
    jcol, col = (jax_lst.CollectScoresIterationListener(2),
                 lst.CollectScoresIterationListener(2))
    jpg = jax_lst.ParamAndGradientIterationListener(
        1, file_path=tmp_path / "jax.tsv")
    pg = lst.ParamAndGradientIterationListener(
        1, file_path=tmp_path / "port.tsv")
    jnet.set_listeners(jrec, jcol, jpg)
    net.set_listeners(rec, col)
    net.add_listener(pg)
    with caplog.at_level(logging.INFO, logger=lst.__name__):
        net.add_listener(lst.ScoreIterationListener(3))
        jnet.fit(JaxListIterator(JaxDataSet(x, y), 50), epochs=2)
        net.fit(ListDataSetIterator(DataSet(x, y), 50), epochs=2)
        jnet.fit(x[:20], y[:20])
        net.fit(x[:20], y[:20])
    _assert_events_equal(rec.events, jrec.events)
    assert [e[0] for e in rec.events[:5]] == ["start", "iter", "iter",
                                              "iter", "end"]
    assert [i for i, _ in col.scores] == [i for i, _ in jcol.scores] == \
        [2, 4, 6]
    np.testing.assert_allclose([s for _, s in col.scores],
                               [s for _, s in jcol.scores], rtol=SCORE_RTOL)
    said = [r.getMessage() for r in caplog.records
            if r.name == lst.__name__]
    assert [m.split(" is ")[0] for m in said] == \
        ["Score at iteration 3", "Score at iteration 6"]
    jrows = (tmp_path / "jax.tsv").read_text().splitlines()
    rows = (tmp_path / "port.tsv").read_text().splitlines()
    assert rows[0] == jrows[0] == "\t".join(pg.COLUMNS)
    assert len(rows) == len(jrows) == 8
    for r, jr in zip(rows[1:], jrows[1:]):
        got, want = r.split("\t"), jr.split("\t")
        assert got[0] == want[0] and (got[3] == "") == (want[3] == "")
        np.testing.assert_allclose([float(v) for v in got[1:] if v],
                                   [float(v) for v in want[1:] if v],
                                   rtol=MAGNITUDE_RTOL)


def test_graph_listeners_fire_as_in_jax():
    """The graph's fit calls the hooks as JAX's does: over an iterator
    (2 epochs), and over one MultiDataSet."""
    jnet = base_graph()
    net = port_of(jnet)
    jrec, rec = _recorder(jax_lst.TrainingListener), _recorder(
        lst.TrainingListener)
    jnet.set_listeners(jrec)
    net.set_listeners(rec)
    x, y = graph_data(24)
    jnet.fit(JaxListIterator(JaxDataSet(x, y), 8), epochs=2)
    net.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=2)
    jnet.fit(x, y, epochs=2)
    net.fit(x, y, epochs=2)
    _assert_events_equal(rec.events, jrec.events)
    assert len([e for e in rec.events if e[0] == "iter"]) == 8
    assert net.last_batch_size == jnet.last_batch_size == 24


def test_tbptt_calls_listeners_once_a_segment():
    """Truncated BPTT steps once a segment of 5 over T = 10: two
    iteration_done calls a batch, as in JAX."""
    def conf(layers, net_mod):
        return (net_mod.NeuralNetConfiguration.builder().seed(4)
                .learning_rate(0.1).updater("sgd").list()
                .layer(layers.GravesLSTM(n_in=3, n_out=4, activation="tanh"))
                .layer(layers.RnnOutputLayer(n_in=4, n_out=2,
                                             activation="softmax",
                                             loss="mcxent"))
                .backprop_type("truncatedbptt").t_bptt_forward_length(5)
                .t_bptt_backward_length(5).build())
    jnet = JaxNet(conf(jax_layers, jax_network)).init()
    net = port_of(jnet)
    jrec, rec = _recorder(jax_lst.TrainingListener), _recorder(
        lst.TrainingListener)
    jnet.set_listeners(jrec)
    net.set_listeners(rec)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 10, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 10))]
    jnet.fit(x, y)
    net.fit(x, y)
    _assert_events_equal(rec.events, jrec.events)
    assert [e[1] for e in rec.events if e[0] == "iter"] == [1, 2]


def test_score_is_read_only_where_a_listener_reads_it(monkeypatch):
    """``score()`` synchronizes with the device: ScoreIterationListener(5)
    over 12 steps reads it twice, and a network without listeners never."""
    x, y = iris_data()
    net = port_of(iris_net(updater="sgd"))
    reads = []
    score = net.score
    monkeypatch.setattr(net, "score", lambda *a: reads.append(1) or
                        score(*a))
    data = ListDataSetIterator(DataSet(x, y), 25)
    net.fit(data, epochs=2)
    assert reads == [] and net.iteration == 12
    net.set_listeners(lst.ScoreIterationListener(5))
    net.fit(data, epochs=2)
    assert len(reads) == 2


def test_performance_listener_reads_batch_and_etl():
    x, y = iris_data()
    net = port_of(iris_net(updater="sgd"))
    perf = lst.PerformanceListener(frequency=2)
    net.set_listeners(perf)
    net.fit(ListDataSetIterator(DataSet(x, y), 30))
    assert [r["iteration"] for r in perf.history] == [2, 4]
    for r in perf.history:
        assert r["samples_per_sec"] > 0 and r["batches_per_sec"] > 0
        assert r["etl_ms"] >= 0.0
        assert abs(r["samples_per_sec"] / r["batches_per_sec"] - 30) < 1e-6
    assert net.last_batch_size == 30


def test_profiler_and_telemetry_listeners(tmp_path):
    """ProfilerListener writes a torch.profiler Chrome trace for each
    window, closed by the window's end or ``close()``;
    CompileTelemetryListener snapshots the engine's telemetry every
    iteration: five batches of one shape are one training signature."""
    x, y = iris_data()
    net = port_of(iris_net(updater="sgd"))
    prof = lst.ProfilerListener(tmp_path, frequency=2, trace_iterations=1)
    tel = lst.CompileTelemetryListener()
    net.set_listeners(prof, tel)
    net.fit(ListDataSetIterator(DataSet(x, y), 30))
    prof.close()
    assert [p.rsplit("/", 1)[-1] for p in prof.trace_dirs] == \
        ["iter2", "iter4"]
    for d in prof.trace_dirs:
        assert (tmp_path / d.rsplit("/", 1)[-1] / "trace.json").stat().st_size
    assert [h["iteration"] for h in tel.history] == [1, 2, 3, 4, 5]
    assert tel.snapshot()["by_kind"] == {"train_step": 1}
    assert tel.snapshot()["retraces"] == 1


def test_latency_histogram_is_the_registry_reservoir():
    """``nn.listeners.LatencyHistogram`` keeps the JAX package's name and
    is the registry's reservoir: exact count, mean and max, percentiles
    of the samples, None while empty."""
    h = lst.LatencyHistogram(capacity=8)
    assert lst.LatencyHistogram is LatencyHistogram
    assert h.percentile(0.5) is None
    ref = jax_lst.LatencyHistogram(capacity=8)
    for v in (0.004, 0.001, 0.003, 0.002):
        h.record(v)
        ref.record(v)
    assert h.snapshot() == ref.snapshot()


def test_set_listeners_replaces_and_returns_the_model():
    net = port_of(iris_net())
    a, b = lst.CollectScoresIterationListener(), lst.PerformanceListener()
    assert net.set_listeners(a, b) is net and net.listeners == [a, b]
    assert net.add_listener(a) is net and net.listeners == [a, b, a]
    graph = port_of(base_graph())
    assert graph.set_listeners(b).add_listener(a).listeners == [b, a]
