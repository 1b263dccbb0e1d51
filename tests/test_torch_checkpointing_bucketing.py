"""Gradient checkpointing and shape bucketing of the port, held against the
JAX package on the CPU.

Checkpointing (``gradient_checkpointing``): each layer's (vertex's) forward
of a training step runs under non-reentrant ``torch.utils.checkpoint`` and
the backward runs it again.  The recompute takes the same inputs and the
same explicit dropout seed words, so on the CPU a checkpointed step equals
the plain one bit for bit: params, updater state, score and batch norm's
running statistics (taken once, from the first forward).  In the JAX
package a remat step equals its plain one at rtol 1e-6 (its own test);
the port's plain step is held to JAX's at rtol = 1e-5, atol = 1e-6 where
no dropout draws differ.

Bucketing (``shape_bucketing``): the cases of ``tests/test_bucketing.py``.
A bucketed ragged stream trains, scores and outputs as the unbucketed one
(rtol 1e-6, atol 1e-7 for dense nets, JAX's rule), and its count of
distinct training signatures is bounded by the buckets it hit.  The
ragged-RNN case (mixed time lengths, masked and unmasked batches, Adam) is
held at JAX's rule, rtol = 1e-5, atol = 1e-6, against JAX's RAW
(unbucketed) fit and against the port's own raw fit: JAX's bucketed fit
misses its own rule there (``test_ragged_rnn_fit_parity_mixed_time_and
_masks`` fails in the JAX suite), the port's meets it.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, ListDataSetIterator, ListMultiDataSetIterator)
from deeplearning4j_tpu_torch.nn import multilayer as mln_mod
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration, ElementWiseVertex, GraphBuilder)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import bucketing

RTOL, ATOL = 1e-5, 1e-6
DENSE_RTOL, DENSE_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jnet, graph=False):
    """The port's network of a JAX network's configuration and params."""
    if graph:
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jnet.conf.to_json()), device="cpu")
        net.load_jax_params({n: {k: np.asarray(v) for k, v in lp.items()}
                             for n, lp in jnet.net_params.items()})
        net.load_jax_state({n: {k: np.asarray(v) for k, v in s.items()}
                            for n, s in jnet.net_state.items()})
        return net
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    net.load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                         for lp in jnet.net_params])
    net.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                        for s in jnet.net_state])
    return net


# ---------------------------------------------------------------------------
# Gradient checkpointing
# ---------------------------------------------------------------------------
def _jax_mln(remat, dropout=0.0, bn=False, updater="sgd"):
    b = (jax_network.NeuralNetConfiguration.builder().seed(4)
         .learning_rate(0.1).updater(updater))
    if remat:
        b.gradient_checkpointing(True)
    lb = (b.list().layer(jax_layers.DenseLayer(
        n_in=4, n_out=16, activation="tanh", dropout=dropout or None)))
    if bn:
        lb.layer(jax_layers.BatchNormalization())
    lb.layer(jax_layers.DenseLayer(n_out=16, activation="relu"))
    lb.layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
    return JaxNet(lb.set_input_type(
        jax_network.InputType.feed_forward(4)).build()).init()


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


class _Counting:
    """Counts calls of ``cls.forward`` while installed."""

    def __init__(self, monkeypatch, cls):
        self.calls = 0
        orig = cls.forward

        def forward(layer, *a, **k):
            self.calls += 1
            return orig(layer, *a, **k)
        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("dropout, bn, updater", [
    (0.0, False, "sgd"), (0.5, False, "adam"), (0.0, True, "nesterovs")],
    ids=["plain", "dropout", "batchnorm"])
def test_checkpointed_multilayer_steps_equal_plain(dropout, bn, updater,
                                                   monkeypatch):
    x, y = _data()
    jplain = _jax_mln(False, dropout, bn, updater)
    jremat = _jax_mln(True, dropout, bn, updater)
    plain, remat = _port(jplain), _port(jplain)
    remat.conf.global_conf.gradient_checkpointing = True
    dense = _Counting(monkeypatch, L.DenseLayer)
    for net in (plain, remat):
        dense.calls = 0
        for _ in range(5):
            net.fit(x, y)
        # 2 hidden dense layers a step; each forward again under remat
        assert dense.calls == (20 if net is remat else 10)
    for _ in range(5):
        jplain.fit(x, y)
        jremat.fit(x, y)
    np.testing.assert_allclose(np.asarray(jremat.params()),
                               np.asarray(jplain.params()), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(remat.params(), plain.params())
    assert torch.equal(remat.updater_state_flat(), plain.updater_state_flat())
    assert remat.score() == plain.score()
    for a, b in zip(remat.net_state, plain.net_state):
        for k in a:
            assert torch.equal(a[k], b[k])
    if not dropout:
        np.testing.assert_allclose(plain.params().numpy(),
                                   np.asarray(jplain.params()),
                                   rtol=RTOL, atol=ATOL)


def test_checkpointed_graph_steps_equal_plain(monkeypatch):
    def build(remat):
        g = jax_network.GlobalConf(seed=9, learning_rate=0.1,
                                   updater="adam",
                                   gradient_checkpointing=remat)
        conf = (jax_gc.GraphBuilder(g).add_inputs("in")
                .add_layer("d1", jax_layers.DenseLayer(
                    n_in=4, n_out=8, activation="tanh", dropout=0.5), "in")
                .add_layer("d2", jax_layers.DenseLayer(
                    n_in=4, n_out=8, activation="relu"), "in")
                .add_vertex("add", jax_gc.ElementWiseVertex(op="add"),
                            "d1", "d2")
                .add_layer("out", jax_layers.OutputLayer(
                    n_in=8, n_out=3, activation="softmax", loss="mcxent"),
                    "add")
                .set_outputs("out").build())
        return JaxGraph(conf).init()
    x, y = _data(seed=5)
    ja, jb = build(False), build(True)
    plain, remat = _port(ja, graph=True), _port(ja, graph=True)
    remat.conf.global_conf.gradient_checkpointing = True
    # the two dense vertices; the sum saves nothing for its backward, so
    # autograd never asks for its recompute
    dense = _Counting(monkeypatch, L.DenseLayer)
    merges = _Counting(monkeypatch, ElementWiseVertex)
    for _ in range(5):
        ja.fit(x, y)
        jb.fit(x, y)
        plain.fit(x, y)
    assert (dense.calls, merges.calls) == (10, 5)
    for _ in range(5):
        remat.fit(x, y)
    assert (dense.calls, merges.calls) == (30, 10)
    np.testing.assert_allclose(np.asarray(jb.params()),
                               np.asarray(ja.params()), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(remat.params(), plain.params())
    assert torch.equal(remat.updater_state_flat(), plain.updater_state_flat())


def test_checkpointing_flag_and_inference_untouched(monkeypatch):
    conf = (NeuralNetConfiguration.builder().gradient_checkpointing(True)
            .list().layer(L.DenseLayer(n_in=4, n_out=4))
            .layer(L.OutputLayer(n_out=2)).build())
    back = MultiLayerConfiguration.from_json(conf.to_json())
    assert back.global_conf.gradient_checkpointing is True
    net = MultiLayerNetwork(back, device="cpu").init()
    dense = _Counting(monkeypatch, L.DenseLayer)
    x, _ = _data()
    net.output(x)
    net.feed_forward(x, train=True)
    # both layers (the head is a DenseLayer too) once a forward: no
    # recompute outside a training step
    assert dense.calls == 4
    calls = []
    monkeypatch.setattr(mln_mod.torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](*a[1:]))
    net.fit(x, np.eye(2, dtype=np.float32)[np.arange(16) % 2])
    assert len(calls) == 1    # the hidden layer; the head's preout is not


# ---------------------------------------------------------------------------
# Shape bucketing: the cases of tests/test_bucketing.py
# ---------------------------------------------------------------------------
def test_primitives_equal_jax():
    from deeplearning4j_tpu.ops import bucketing as jb
    assert [bucketing.bucket_size(n) for n in (1, 2, 3, 5, 8, 9, 100)] == \
        [jb.bucket_size(n) for n in (1, 2, 3, 5, 8, 9, 100)]
    assert bucketing.bucket_size(100, [4, 16, 64]) == 128
    rng = np.random.default_rng(1)
    ds = DataSet(rng.normal(size=(5, 3, 4)).astype(np.float32),
                 rng.normal(size=(5, 3, 2)).astype(np.float32),
                 np.ones((5, 3), np.float32), None)
    g = GlobalConf()
    jg = jax_network.GlobalConf()
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    for scale in (True, False):
        got, b = bucketing.bucket_train_dataset(ds, g, scale_loss=scale)
        want, jbk = jb.bucket_train_dataset(
            JaxDataSet(ds.features, ds.labels, ds.features_mask, None), jg,
            scale_loss=scale)
        assert b == jbk == (8, 4)
        for f in ("features", "labels", "features_mask", "labels_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
        again, _ = bucketing.bucket_train_dataset(got, g)
        assert again is got
    t = torch.from_numpy(ds.features)
    xp, mp, n, tt, bk = bucketing.bucket_inference_features(t, None, g)
    jxp, jmp, *_ = jb.bucket_inference_features(ds.features, None, jg)
    assert isinstance(xp, torch.Tensor) and bk == (8, 4)
    np.testing.assert_array_equal(xp.numpy(), jxp)
    np.testing.assert_array_equal(mp, jmp)
    assert bucketing.unpad_outputs(xp, n, tt, bk[1]).shape == (5, 3, 4)
    per_ex = rng.normal(size=7).astype(np.float32)
    m = bucketing.scaled_mask(None, np.zeros((7, 3)), 7, 8)[:, 0]
    np.testing.assert_allclose((np.append(per_ex, 0) * m).mean(),
                               per_ex.mean(), rtol=1e-6)


def _dense_net(bucketed, seed=7, graph=False):
    if graph:
        g = GlobalConf(seed=seed, learning_rate=0.05)
        g.shape_bucketing = bucketed
        conf = (GraphBuilder(g).add_inputs("in")
                .add_layer("d", L.DenseLayer(n_in=8, n_out=16,
                                             activation="tanh"), "in")
                .add_layer("out", L.OutputLayer(
                    n_in=16, n_out=3, activation="softmax", loss="mcxent"),
                    "d")
                .set_outputs("out").build())
        return ComputationGraph(conf, device="cpu").init()
    b = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.05)
         .updater("sgd"))
    if bucketed:
        b.shape_bucketing(True)
    conf = (b.list()
            .layer(L.DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _ragged(rng, sizes):
    return [DataSet(rng.normal(size=(s, 8)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, s)])
            for s in sizes]


def test_ragged_dense_fit_parity_and_signature_bound():
    rng = np.random.default_rng(0)
    batches = _ragged(rng, [7, 5, 8, 3, 12, 6, 7, 9])
    raw, bucketed = _dense_net(False), _dense_net(True)
    raw.fit(ListDataSetIterator(list(batches)))
    bucketed.fit(ListDataSetIterator(list(batches)))
    np.testing.assert_allclose(raw.params().numpy(),
                               bucketed.params().numpy(),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)
    snap = bucketed.compile_telemetry.snapshot()
    hit = {k for k in snap["bucket_hits"] if k.startswith("train_step:")}
    assert snap["by_kind"]["train_step"] <= len(hit) < \
        raw.compile_telemetry.snapshot()["by_kind"]["train_step"]
    ds = _ragged(rng, [5])[0]
    assert abs(raw.score(ds) - bucketed.score(ds)) < 1e-5


def _rnn_batch(rng, n, t, masked):
    x = rng.normal(size=(n, t, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (n, t))]
    fm = None
    if masked:
        fm = np.ones((n, t), np.float32)
        for i in range(n):
            fm[i, rng.integers(1, t + 1):] = 0.0
    return DataSet(x, y, fm, None)


def _jax_rnn(bucketed, seed=3, bidirectional=False):
    b = (jax_network.NeuralNetConfiguration.builder().seed(seed)
         .learning_rate(0.02).updater("adam"))
    if bucketed:
        b.shape_bucketing(True)
    lstm = (jax_layers.GravesBidirectionalLSTM if bidirectional
            else jax_layers.GravesLSTM)
    conf = (b.list().layer(lstm(n_in=5, n_out=8, activation="tanh"))
            .layer(jax_layers.RnnOutputLayer(n_out=5, activation="softmax",
                                             loss="mcxent"))
            .set_input_type(jax_network.InputType.recurrent(5)).build())
    return JaxNet(conf).init()


def test_ragged_rnn_fit_parity_against_raw_paths():
    """JAX's ragged-RNN case at JAX's rule, against JAX's raw fit and the
    port's raw fit; then score and score_examples on a masked and an
    unmasked ragged batch."""
    rng = np.random.default_rng(1)
    batches = [_rnn_batch(rng, 6, 9, False), _rnn_batch(rng, 3, 13, True),
               _rnn_batch(rng, 8, 9, True), _rnn_batch(rng, 5, 5, False)]
    jraw = _jax_rnn(False)
    raw, bucketed = _port(jraw), _port(jraw)
    bucketed.conf.global_conf.shape_bucketing = True
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    jraw.fit(JaxListIterator([JaxDataSet(d.features, d.labels,
                                         d.features_mask, None)
                              for d in batches]))
    raw.fit(ListDataSetIterator(list(batches)))
    bucketed.fit(ListDataSetIterator(list(batches)))
    np.testing.assert_allclose(bucketed.params().numpy(),
                               np.asarray(jraw.params()), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bucketed.params().numpy(),
                               raw.params().numpy(), rtol=RTOL, atol=ATOL)
    snap = bucketed.compile_telemetry.snapshot()
    assert snap["by_kind"]["train_step"] <= len(snap["bucket_hits"])
    for ds in (batches[1], batches[3]):
        assert abs(raw.score(ds) - bucketed.score(ds)) < 1e-5
        np.testing.assert_allclose(bucketed.score_examples(ds),
                                   raw.score_examples(ds), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["lstm", "bidirectional"])
def test_output_unpadded_and_exact(bidirectional):
    rng = np.random.default_rng(2 + bidirectional)
    jnet = _jax_rnn(False, seed=5, bidirectional=bidirectional)
    raw, bucketed = _port(jnet), _port(jnet)
    bucketed.conf.global_conf.shape_bucketing = True
    ds = _rnn_batch(rng, 3, 7, True)
    out_r = raw.output(ds.features, mask=ds.features_mask)
    out_b = bucketed.output(ds.features, mask=ds.features_mask)
    assert tuple(out_b.shape) == tuple(out_r.shape) == (3, 7, 5)
    np.testing.assert_allclose(out_b.numpy(), out_r.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        out_b.numpy(), np.asarray(jnet.output(ds.features,
                                              mask=ds.features_mask)),
        rtol=RTOL, atol=RTOL)


def test_fused_ragged_group_stays_one_group():
    rng = np.random.default_rng(4)
    batches = _ragged(rng, [7, 5, 8, 6, 7, 8])
    raw, bucketed = _dense_net(False), _dense_net(True)
    raw.fit(ListDataSetIterator(list(batches)))
    bucketed.fit(ListDataSetIterator(list(batches)), fused_steps=3)
    np.testing.assert_allclose(raw.params().numpy(),
                               bucketed.params().numpy(),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)
    kinds = bucketed.compile_telemetry.snapshot()["by_kind"]
    assert any(k.startswith("fused_step_k") for k in kinds), kinds


def test_graph_ragged_parity_fit_output_score():
    rng = np.random.default_rng(5)
    batches = [MultiDataSet([d.features], [d.labels])
               for d in _ragged(rng, [7, 5, 8, 3, 6])]
    raw = _dense_net(False, seed=4, graph=True)
    bucketed = _dense_net(True, seed=4, graph=True)
    raw.fit(ListMultiDataSetIterator(list(batches)))
    bucketed.fit(ListMultiDataSetIterator(list(batches)))
    np.testing.assert_allclose(raw.params().numpy(),
                               bucketed.params().numpy(),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)
    snap = bucketed.compile_telemetry.snapshot()
    assert snap["by_kind"]["train_step"] <= len(snap["bucket_hits"])
    x = batches[0].features[0]
    np.testing.assert_allclose(raw.output(x)[0].numpy(),
                               bucketed.output(x)[0].numpy(),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)
    assert bucketed.output(x)[0].shape[0] == 7
    assert abs(raw.score(batches[0]) - bucketed.score(batches[0])) < 1e-5
    np.testing.assert_allclose(raw.score_examples(batches[0]),
                               bucketed.score_examples(batches[0]),
                               rtol=1e-6, atol=1e-6)


def test_async_iterator_buckets_before_staging():
    rng = np.random.default_rng(7)
    g = GlobalConf()
    it = AsyncDataSetIterator(
        ListDataSetIterator(_ragged(rng, [7, 5, 8, 3])), device="cpu",
        transform=lambda d: bucketing.bucket_train_dataset(d, g)[0])
    seen = []
    try:
        while it.has_next():
            d = it.next()
            assert isinstance(d.features, torch.Tensor)   # staged
            assert d.labels_mask is not None              # mask made
            seen.append(d.features.shape[0])
    finally:
        it.close()
    assert seen == [8, 8, 8, 4]


def test_sum_reduction_is_left_unbucketed():
    """mini_batch=False sums the loss: the target/n rescale would be
    wrong, so bucketing stands down and training is the raw one's."""
    rng = np.random.default_rng(9)
    net, ref = _dense_net(True), _dense_net(False)
    for n in (net, ref):
        n.conf.global_conf.mini_batch = False
    batches = _ragged(rng, [7, 5])
    net.fit(ListDataSetIterator(list(batches)))
    ref.fit(ListDataSetIterator(list(batches)))
    assert torch.equal(net.params(), ref.params())
    assert not net.compile_telemetry.snapshot()["bucket_hits"]
    conf = (NeuralNetConfiguration.builder()
            .shape_bucketing(True, batch_sizes=[8, 32], time_sizes=[16])
            .list().layer(L.DenseLayer(n_in=4, n_out=4))
            .layer(L.OutputLayer(n_in=4, n_out=2)).build())
    rt = MultiLayerConfiguration.from_json(conf.to_json())
    assert (rt.global_conf.shape_bucketing, rt.global_conf.bucket_batch_sizes,
            rt.global_conf.bucket_time_sizes) == (True, [8, 32], [16])
    assert InputType.feed_forward(4).kind == "ff"
