"""``fit(fused_steps=K)`` of both engines on the CPU: the JAX package's
cases (``tests/test_core_engine.py`` ``TestFusedSteps``,
``tests/test_computation_graph.py`` ``TestGraphFusedSteps``).

A group's steps are the same computation as K plain steps (each draws its
own dropout seed words from the network's generator), so params after a
fused fit equal a plain fit's exactly (``torch.equal``), dropout
included.  The listeners' iterations are held to the JAX package's for
the same batches: once a group, the network's first group running its
first batch alone, mixed shapes and the ragged tail step by step.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxList)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.listeners import IterationListener as JaxListener
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ListDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.nn.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.listeners import IterationListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from test_torch_checkpoint import Interrupted, StopsAfter
from test_torch_checkpoint import _batches as resume_batches
from test_torch_checkpoint import _net as resume_net


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(mods, dropout=None, iterations=1):
    net_mod, lay = mods
    b = (net_mod.NeuralNetConfiguration.builder().seed(11).learning_rate(0.1)
         .updater("adam"))
    if iterations > 1:
        b = b.iterations(iterations)
    return (b.list()
            .layer(lay.DenseLayer(n_in=4, n_out=16, activation="relu",
                                  dropout=dropout))
            .layer(lay.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .build())


def _net(**kw):
    return MultiLayerNetwork(_conf((network, L), **kw), device="cpu").init()


def _arrays(sizes, seed=0, masks=()):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = rng.normal(size=(n, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
        out.append((x, y, np.ones((n, 1), np.float32) if i in masks
                    else None))
    return out


def _port_batches(arrays):
    return [DataSet(x, y, labels_mask=m) for x, y, m in arrays]


def _same(a, b):
    assert a.iteration == b.iteration
    assert torch.equal(a.params(), b.params())
    assert torch.equal(a.updater_state_flat(), b.updater_state_flat())


class _Probe(IterationListener):
    def __init__(self):
        self.fired = []

    def iteration_done(self, model, iteration):
        self.fired.append(iteration)


class _JaxProbe(JaxListener):
    def __init__(self):
        self.fired = []

    def iteration_done(self, model, iteration):
        self.fired.append(iteration)


@pytest.mark.parametrize("dropout", [None, 0.5])
@pytest.mark.parametrize("k", [2, 4])
def test_fused_equals_plain_steps(dropout, k):
    """9 batches, then a second epoch: params and updater state equal a
    plain fit's, dropout masks included."""
    data = _port_batches(_arrays([8] * 9))
    a, b = _net(dropout=dropout), _net(dropout=dropout)
    a.fit(ListDataSetIterator(data), epochs=2)
    b.fit(ListDataSetIterator(data), epochs=2, fused_steps=k)
    assert b.iteration == 18
    _same(a, b)
    assert torch.equal(torch.as_tensor(a.score()), torch.as_tensor(b.score()))


def test_fused_lstm_under_standard_backprop():
    """An RNN layer's carry is dropped after every step of a group, as the
    JAX scan body strips it."""
    def build():
        conf = (network.NeuralNetConfiguration.builder().seed(2)
                .learning_rate(0.05).updater("sgd").list()
                .layer(L.GravesLSTM(n_in=5, n_out=8))
                .layer(L.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(1)
    data = [DataSet(rng.normal(size=(4, 7, 5)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))])
            for _ in range(6)]
    a, b = build(), build()
    a.fit(ListDataSetIterator(data))
    b.fit(ListDataSetIterator(data), fused_steps=3)
    _same(a, b)
    assert all("rnn_state" not in s for s in b.net_state)


@pytest.mark.parametrize("sizes,masks,k", [
    ([8] * 7, (), 3),                   # first group's batch alone, tail
    ([8, 8, 5, 8, 8, 8, 8, 8], (), 3),  # a group of mixed shapes
    ([5] * 6, (1, 4), 2),               # mask presence splits groups
    ([8] * 2, (), 4),                   # all tail
])
def test_listener_iterations_equal_jax(sizes, masks, k):
    arrays = _arrays(sizes, masks=masks)
    jnet = JaxNet(_conf((jax_network, jax_layers))).init()
    jprobe = _JaxProbe()
    jnet.set_listeners(jprobe)
    jnet.fit(JaxList([JaxDataSet(x, y, labels_mask=m)
                      for x, y, m in arrays]), fused_steps=k)
    net, plain = _net(), _net()
    probe = _Probe()
    net.set_listeners(probe)
    net.fit(ListDataSetIterator(_port_batches(arrays)), fused_steps=k)
    plain.fit(ListDataSetIterator(_port_batches(arrays)))
    assert probe.fired == jprobe.fired
    assert net.iteration == jnet.iteration == len(sizes)
    _same(net, plain)


def test_group_listener_sees_the_group():
    """Once a group: the last step's score and the group's rows."""
    seen = []

    class Look(IterationListener):
        def iteration_done(self, model, iteration):
            seen.append((iteration, float(model.score()),
                         model.last_batch_size))
    data = _port_batches(_arrays([8] * 7))
    net, plain = _net(), _net()
    net.set_listeners(Look())
    net.fit(ListDataSetIterator(data), fused_steps=3)
    scores = []

    class Keep(IterationListener):
        def iteration_done(self, model, iteration):
            scores.append(float(model.score()))
    plain.set_listeners(Keep())
    plain.fit(ListDataSetIterator(data))
    assert [s[0] for s in seen] == [1, 3, 6, 7]
    assert [s[1] for s in seen] == [scores[i - 1] for i in (1, 3, 6, 7)]
    assert [s[2] for s in seen] == [8, 16, 24, 8]


def test_truncated_bptt_ignores_the_flag():
    def build():
        conf = (network.NeuralNetConfiguration.builder().seed(4)
                .learning_rate(0.05).updater("sgd").list()
                .layer(L.GravesLSTM(n_in=3, n_out=6))
                .layer(L.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
                .backprop_type("truncatedbptt").t_bptt_forward_length(4)
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(5)
    data = [DataSet(rng.normal(size=(2, 10, 3)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 10))])
            for _ in range(4)]
    a, b = build(), build()
    probe = _Probe()
    b.set_listeners(probe)
    a.fit(ListDataSetIterator(data))
    b.fit(ListDataSetIterator(data), fused_steps=2)
    assert b.iteration == 12 and probe.fired == list(range(1, 13))
    _same(a, b)


def test_iterations_above_one_ignore_the_flag():
    data = _port_batches(_arrays([8] * 4))
    a, b = _net(iterations=3), _net(iterations=3)
    a.fit(ListDataSetIterator(data))
    b.fit(ListDataSetIterator(data), fused_steps=2)
    assert b.iteration == 12
    _same(a, b)


def test_resume_skips_batches_not_groups(tmp_path):
    """``fault_tolerance(resume=True)`` under ``fused_steps``: the
    checkpoint's position counts batches, so a fit cut in its second epoch
    and resumed equals the uncut plain fit."""
    data = resume_batches()
    ref = resume_net(dropout=0.5)
    ref.fit(ListDataSetIterator(data), epochs=3)
    crashed = resume_net(dropout=0.5)
    crashed.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=4))
    with pytest.raises(Interrupted):
        crashed.fit(StopsAfter(data, 6 + 5), epochs=3, fused_steps=2)
    assert crashed.iteration == 10
    resumed = resume_net(dropout=0.5, resume=True)
    resumed.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=4))
    resumed.fit(ListDataSetIterator(data), epochs=3, fused_steps=2)
    assert resumed.iteration == ref.iteration == 18
    _same(resumed, ref)


# ---------------------------------------------------------------------------
# ComputationGraph
# ---------------------------------------------------------------------------

def _graph_conf(mod, lay, g_cls):
    return (mod.GraphBuilder(g_cls(seed=4, learning_rate=0.1, updater="adam"))
            .add_inputs("in")
            .add_layer("h", lay.DenseLayer(n_in=4, n_out=12,
                                           activation="tanh", dropout=0.8),
                       "in")
            .add_layer("out", lay.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "h")
            .set_outputs("out")
            .build())


def _graph():
    return ComputationGraph(_graph_conf(gc, L, network.GlobalConf),
                            device="cpu").init()


def _mds(arrays):
    return [MultiDataSet([x], [y], [None], [m]) for x, y, m in arrays]


@pytest.mark.parametrize("sizes,masks,k", [
    ([6] * 7, (), 3), ([5] * 4, (1, 3), 4), ([6, 6, 4, 6, 6], (), 2)])
def test_graph_fused_equals_plain_and_jax_iterations(sizes, masks, k):
    arrays = _arrays(sizes, seed=2, masks=masks)
    jnet = JaxGraph(_graph_conf(jax_gc, jax_layers,
                                jax_network.GlobalConf)).init()
    jprobe = _JaxProbe()
    jnet.set_listeners(jprobe)
    jnet.fit(JaxList([JaxMDS([x], [y], [None], [m]) for x, y, m in arrays]),
             fused_steps=k)
    a, b = _graph(), _graph()
    probe = _Probe()
    b.set_listeners(probe)
    a.fit(ListDataSetIterator(_mds(arrays)))
    b.fit(ListDataSetIterator(_mds(arrays)), fused_steps=k)
    assert probe.fired == jprobe.fired
    assert b.iteration == jnet.iteration == len(sizes)
    _same(a, b)
