"""The port's checkpoints and crash-safe resume (``nn/checkpoint.py``) on
the CPU: every case of ``tests/test_checkpoint_listener.py``, checkpoints
one package writes validated and restored by the other, and ``fit``
under ``fault_tolerance(resume=True)`` against an uninterrupted fit.

A resumed fit of the port equals the uninterrupted one exactly
(``torch.equal``), dropout included: both take the same batches in the
same order from the same params, updater state and generator position.
Across packages the restored params and updater state are equal (the zip
holds their bits), and the trajectory of ``resume_continues_training``
is held at the JAX test's rtol 1e-5 / atol 1e-6.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import checkpoint as jax_ckpt
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.monitor.registry import get_registry
from deeplearning4j_tpu_torch.nn.checkpoint import (
    CheckpointListener, CorruptCheckpointError, last_valid_checkpoint,
    read_manifest, restore_into, resume_from_checkpoint, validate_checkpoint)
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from test_torch_transfer import port_of

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(dropout=None, resume=False, workers=1):
    """The JAX test's net (Adam, dense tanh 8 -> softmax 3); ``dropout``
    on the dense layer's input."""
    b = NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)\
        .updater("adam").input_pipeline(workers=workers)
    if resume:
        b.fault_tolerance(resume=True)
    conf = (b.list()
            .layer(L.DenseLayer(n_in=4, n_out=8, activation="tanh",
                                dropout=dropout))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=CPU).init()


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


# ---------------------------------------------------------------------------
# tests/test_checkpoint_listener.py
# ---------------------------------------------------------------------------

def test_checkpoint_listener_saves_and_prunes(tmp_path):
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2,
                                         keep_last=2))
    x, y = _data()
    for _ in range(9):
        net.fit(x, y)
    ckpts = CheckpointListener.checkpoints(tmp_path)
    assert [p.name for p in ckpts] == ["checkpoint_it6.zip",
                                       "checkpoint_it8.zip"]
    assert CheckpointListener.last_checkpoint(tmp_path) == ckpts[-1]
    assert not list(tmp_path.glob("*.tmp"))
    assert [e["file"] for e in read_manifest(tmp_path)] == \
        [p.name for p in ckpts]


def test_resume_continues_training_trajectory(tmp_path):
    """params, iteration and Adam moments restored: 6 + 4 steps equal 10."""
    x, y = _data(seed=1)
    ref = _net()
    for _ in range(10):
        ref.fit(x, y)
    crashed = _net()
    crashed.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=6))
    for _ in range(7):
        crashed.fit(x, y)
    resumed = resume_from_checkpoint(tmp_path, device=CPU)
    assert resumed is not None and resumed.iteration == 6
    for _ in range(4):
        resumed.fit(x, y)
    assert torch.equal(resumed.params(), ref.params())


def test_resume_empty_dir_returns_none(tmp_path):
    assert resume_from_checkpoint(tmp_path, device=CPU) is None


def test_checkpoint_epoch_mode(tmp_path):
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_epoch=True,
                                         keep_last=5))
    x, y = _data(seed=2)
    net.fit(ListDataSetIterator([DataSet(x, y)]), epochs=3)
    assert len(CheckpointListener.checkpoints(tmp_path)) == 3
    resumed = resume_from_checkpoint(tmp_path, device=CPU)
    assert resumed.epoch == 3 == net.epoch


def _graph(dropout=None, resume=False):
    g = GlobalConf(seed=1, learning_rate=0.05, updater="adam",
                   ft_resume=resume)
    conf = (gc.GraphBuilder(g).add_inputs("in")
            .add_layer("d", L.DenseLayer(n_in=4, n_out=8, activation="tanh",
                                         dropout=dropout), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss="mcxent"), "d")
            .set_outputs("out").build())
    return ComputationGraph(conf, device=CPU).init()


def test_checkpoint_epoch_mode_computation_graph(tmp_path):
    net = _graph()
    net.set_listeners(CheckpointListener(tmp_path, save_every_epoch=True,
                                         keep_last=5))
    x, y = _data(seed=5)
    net.fit(ListDataSetIterator([DataSet(x, y)]), epochs=2)
    assert net.epoch == 2
    assert len(CheckpointListener.checkpoints(tmp_path)) == 2
    resumed = resume_from_checkpoint(tmp_path, device=CPU)
    assert isinstance(resumed, ComputationGraph) and resumed.epoch == 2


def test_resume_without_updater_state(tmp_path):
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2))
    x, y = _data(seed=3)
    for _ in range(4):
        net.fit(x, y)
    fresh = resume_from_checkpoint(tmp_path, load_updater=False, device=CPU)
    warm = resume_from_checkpoint(tmp_path, load_updater=True, device=CPU)
    assert float(warm.updater_state_flat().abs().sum()) > 0
    assert float(fresh.updater_state_flat().abs().sum()) == 0.0


def test_resume_survives_stale_index(tmp_path):
    """A crash between the zip's publish and the index's: the file name
    gives the iteration."""
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2))
    x, y = _data(seed=4)
    for _ in range(4):
        net.fit(x, y)
    (tmp_path / "checkpoint_index.json").write_text(
        json.dumps({"iteration": 2, "epoch": 0}))
    assert resume_from_checkpoint(tmp_path, device=CPU).iteration == 4


# ---------------------------------------------------------------------------
# Corrupt checkpoints and the manifest
# ---------------------------------------------------------------------------

def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """A truncated newest zip fails validation, is counted, and the
    previous checkpoint is restored."""
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2))
    x, y = _data(seed=6)
    for _ in range(4):
        net.fit(x, y)
    newest = CheckpointListener.last_checkpoint(tmp_path)
    newest.write_bytes(newest.read_bytes()[:200])
    with pytest.raises(CorruptCheckpointError):
        validate_checkpoint(newest)
    counter = get_registry().counter(
        "dl4j_resilience_checkpoint_fallbacks_total")
    before = counter.value
    path, meta = last_valid_checkpoint(tmp_path)
    assert path.name == "checkpoint_it2.zip" and meta["iteration"] == 2
    assert resume_from_checkpoint(tmp_path, device=CPU).iteration == 2
    assert counter.value == before + 2
    assert jax_ckpt.resume_from_checkpoint(tmp_path).iteration == 2


def test_restore_into_builds_no_network(tmp_path, monkeypatch):
    """restore_into reads the newest checkpoint's arrays into the model
    without building a network of its own; a newest zip whose
    configuration does not parse is skipped and counted; a checkpoint of
    another model class raises."""
    net = _net()
    net.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2))
    x, y = _data(seed=7)
    for _ in range(4):
        net.fit(x, y)
    newest = CheckpointListener.last_checkpoint(tmp_path)
    with zipfile.ZipFile(newest) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    conf = json.loads(members["configuration.json"])
    conf["layers"][0]["@class"] = "NoSuchLayer"
    members["configuration.json"] = json.dumps(conf).encode()
    with zipfile.ZipFile(newest, "w") as zf:
        for n, b in members.items():
            zf.writestr(n, b)
    want = resume_from_checkpoint(tmp_path, device=CPU)
    assert want.iteration == 2
    fresh = _net()
    built = []
    init = MultiLayerNetwork.init
    monkeypatch.setattr(MultiLayerNetwork, "init",
                        lambda self: built.append(self) or init(self))
    counter = get_registry().counter(
        "dl4j_resilience_checkpoint_fallbacks_total")
    before = counter.value
    meta = restore_into(fresh, tmp_path)
    assert built == [] and counter.value == before + 1
    assert meta["iteration"] == 2 and fresh.iteration == 2
    assert torch.equal(fresh.params(), want.params())
    assert torch.equal(fresh.updater_state_flat(), want.updater_state_flat())
    graph = ComputationGraph(
        gc.GraphBuilder(GlobalConf(seed=1)).add_inputs("in")
        .add_layer("out", L.OutputLayer(n_in=4, n_out=3), "in")
        .set_outputs("out").build(), device=CPU).init()
    with pytest.raises(ValueError, match="holds a MultiLayerNetwork"):
        restore_into(graph, tmp_path)


def test_manifest_has_the_jax_keys(tmp_path):
    """The port's manifest entries carry the JAX package's keys, with
    sharding, dist and precision null."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    x, y = _data(seed=7)
    jnet = _jax_twin()
    jnet.set_listeners(jax_ckpt.CheckpointListener(jdir,
                                                   save_every_n_iterations=1))
    jnet.fit(x, y)
    net = _net()
    net.set_listeners(CheckpointListener(pdir, save_every_n_iterations=1))
    net.fit(x, y)
    (entry,), (jentry,) = read_manifest(pdir), jax_ckpt.read_manifest(jdir)
    assert sorted(entry) == sorted(jentry)
    assert {k: entry[k] for k in ("sharding", "dist", "precision")} == \
        {"sharding": None, "dist": None, "precision": None} == \
        {k: jentry[k] for k in ("sharding", "dist", "precision")}
    assert {k: entry[k] for k in ("file", "iteration", "epoch",
                                  "iteration_in_epoch", "model_class")} == \
        {k: jentry[k] for k in ("file", "iteration", "epoch",
                                "iteration_in_epoch", "model_class")}


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _jax_twin():
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf.network import (
        NeuralNetConfiguration as JaxNNC)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    conf = (JaxNNC.builder().seed(3).learning_rate(0.05).updater("adam")
            .list()
            .layer(jl.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())
    return JaxNet(conf).init()


def test_port_checkpoint_resumes_in_jax_and_back(tmp_path):
    """A checkpoint directory the port wrote validates and restores in the
    JAX package (params, Adam state, iteration, epoch), and both continue
    alike; then the reverse, into a port model through restore_into."""
    x, y = _data(seed=8)
    jnet = _jax_twin()
    net = port_of(jnet)
    net.set_listeners(CheckpointListener(tmp_path / "port",
                                         save_every_n_iterations=3))
    for _ in range(3):
        net.fit(x, y)
    jax_ckpt.validate_checkpoint(CheckpointListener.last_checkpoint(
        tmp_path / "port"))
    jres = jax_ckpt.resume_from_checkpoint(tmp_path / "port")
    # saved inside the third fit call: two epochs complete
    assert jres.iteration == 3 and jres.epoch == 2
    assert resume_from_checkpoint(tmp_path / "port", device=CPU).epoch == 2
    np.testing.assert_array_equal(np.asarray(jres.params()),
                                  net.params().numpy())
    np.testing.assert_array_equal(np.asarray(jres.updater_state_flat()),
                                  net.updater_state_flat().numpy())
    for _ in range(2):
        jres.fit(x, y)
        net.fit(x, y)
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jres.params()), rtol=1e-5,
                               atol=1e-6)
    jres.set_listeners(jax_ckpt.CheckpointListener(tmp_path / "jax",
                                                   save_every_n_iterations=5))
    jres.fit(x, y)                            # iteration 6: no save
    for _ in range(4):
        jres.fit(x, y)                        # iteration 10: a save
    validate_checkpoint(CheckpointListener.last_checkpoint(tmp_path / "jax"))
    fresh = _net()
    meta = restore_into(fresh, tmp_path / "jax")
    assert meta["iteration"] == fresh.iteration == 10
    np.testing.assert_array_equal(fresh.params().numpy(),
                                  np.asarray(jres.params()))
    np.testing.assert_array_equal(fresh.updater_state_flat().numpy(),
                                  np.asarray(jres.updater_state_flat()))
    with zipfile.ZipFile(CheckpointListener.last_checkpoint(
            tmp_path / "jax")) as zf:
        assert json.loads(zf.read("configuration.json"))["@model"] == \
            "MultiLayerNetwork"


# ---------------------------------------------------------------------------
# fit under fault_tolerance(resume=True)
# ---------------------------------------------------------------------------

class Interrupted(Exception):
    """Raised by :class:`StopsAfter` to stand for a crash."""


class StopsAfter(ListDataSetIterator):
    """A ListDataSetIterator that raises :class:`Interrupted` when its
    ``limit``-th batch in all is asked for."""

    def __init__(self, data, limit):
        super().__init__(data)
        self.limit, self.served = limit, 0

    def next(self):
        self.served += 1
        if self.served == self.limit:
            raise Interrupted()
        return super().next()


def _batches(n=6, seed=9):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(128, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)])
            for _ in range(n)]


@pytest.mark.parametrize("engine,workers", [("mln", 1), ("mln", 0),
                                            ("graph", 1)])
def test_resumed_fit_equals_uninterrupted_fit(engine, workers, tmp_path):
    """3 epochs of 6 batches with dropout (the hash, 512 elements a
    batch below the kernel gate's 4,096: the dense masks, from a
    generator seeded with the layer's words), checkpoints every 4
    iterations; the first run is interrupted in its second epoch, after
    4 batches of it (iteration 10); a fresh network under
    ``fault_tolerance(resume=True)`` finishes the fit from iteration 8's
    checkpoint (epoch 1, 2 batches in): params, updater state and score
    equal the uninterrupted fit's."""
    make = (lambda **kw: _net(dropout=0.5, workers=workers, **kw)) \
        if engine == "mln" else (lambda **kw: _graph(dropout=0.5, **kw))
    data = _batches()
    ref = make()
    ref.fit(ListDataSetIterator(data), epochs=3)
    crashed = make()
    crashed.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=4))
    with pytest.raises(Interrupted):
        crashed.fit(StopsAfter(data, 6 + 5), epochs=3)
    assert crashed.iteration == 10
    resumed = make(resume=True)
    resumed.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=4))
    resumed.fit(ListDataSetIterator(data), epochs=3)
    assert resumed.iteration == ref.iteration == 18
    assert resumed.epoch == ref.epoch == 3
    assert torch.equal(resumed.params(), ref.params())
    assert torch.equal(resumed.updater_state_flat(),
                       ref.updater_state_flat())
    assert resumed.score() == ref.score()
    # without resume the same network trains from its first batch
    again = make()
    again.set_listeners(CheckpointListener(tmp_path,
                                           save_every_n_iterations=4))
    again.fit(ListDataSetIterator(data[:1]))
    assert again.iteration == 1


def test_resume_reads_the_configured_directory(tmp_path):
    """``fault_tolerance(resume=True, checkpoint_dir=...)`` resumes from
    that directory without a CheckpointListener, and a network that has
    trained is not rolled back."""
    x, y = _data(seed=10)
    src = _net()
    src.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2))
    for _ in range(2):
        src.fit(x, y)
    b = NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)\
        .updater("adam").fault_tolerance(resume=True,
                                         checkpoint_dir=tmp_path)
    conf = (b.list()
            .layer(L.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent")).build())
    assert conf.global_conf.ft_checkpoint_dir == str(tmp_path)
    net = MultiLayerNetwork(conf, device=CPU).init()
    net.fit(ListDataSetIterator([DataSet(x, y)]), epochs=3)
    assert net.iteration == 3 and net.epoch == 3
    ref = _net()
    for _ in range(3):
        ref.fit(x, y)
    assert torch.equal(net.params(), ref.params())
    net.fit(x, y)
    assert net.iteration == 4
