"""The port's training data path — the asynchronous input pipeline,
normalizers, fetchers, ``.npz`` exports, DropConnect and the gateway's
``fit`` / ``evaluate`` RPCs — held against the JAX package on the CPU.

Tolerances:
* fetched arrays, IDX files, exported files, batch order through the
  pipeline: equal, byte for byte;
* normalizer statistics and transforms: within 1e-6 (float32 on both
  sides; the iterator fit merges float64 batch moments in the same order);
* ``fit`` through the pipeline against ``fit`` fed synchronously in the
  port: equal (``torch.equal``), the same arithmetic on the same batches;
* the port's ``fit`` against JAX's ``fit`` (both through their pipelines):
  LeNet + Adam by the rule of ``tests/test_torch_fit.py`` — at least
  99.5 % of each tensor's elements within rtol 1e-4 / atol 1e-5 and all
  within 5e-3, scores at 1e-3 (Adam turns float32 noise in a gradient into
  steps of up to lr); SGD, whose update is linear in the gradient, every
  element within rtol 1e-4 / atol 1e-5;
* DropConnect at inference: outputs within 1e-5 of JAX's.  In training
  the masks cannot be compared with ``jax.random``'s (ROADMAP C), so the
  tests hold the keep share within 5 binomial standard deviations of the
  retain probability, and check the scaling, the biases and the gradient.
"""

import gc
import gzip
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import fetchers as jax_fetchers
from deeplearning4j_tpu.datasets import normalizers as jax_norm
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import network as jax_network
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.scaleout import data as jax_data
from deeplearning4j_tpu.server.gateway import (
    DeepLearning4jEntryPoint as JaxEntryPoint)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import fetchers
from deeplearning4j_tpu_torch.datasets import normalizers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, DataSetIterator, ExistingDataSetIterator,
    ListDataSetIterator, MultipleEpochsIterator, SamplingDataSetIterator,
    stage_batch)
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout import data as port_data
from deeplearning4j_tpu_torch.server import gateway

NORM_TOL = 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3
DROP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread: on a loaded host its
    multi-threaded float32 reductions have been seen to differ from run
    to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def empty_cache(tmp_path, monkeypatch):
    """Both packages' fetchers pointed at one empty cache directory."""
    for mod in (fetchers, jax_fetchers):
        monkeypatch.setattr(mod, "CACHE_DIR", tmp_path / "cache")
    return tmp_path / "cache"


# ---------------------------------------------------------------------------
# IDX files and fetchers
# ---------------------------------------------------------------------------

def _write_idx(path, arr, gz):
    head = struct.pack(">BBBB", 0, 0, 0x08, arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    blob = head + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        path.write_bytes(blob)


@pytest.mark.parametrize("gz", [True, False])
@pytest.mark.parametrize("shape", [(7, 28, 28), (300,), (2, 3, 4, 5)])
def test_read_idx_byte_equal_to_jax(tmp_path, gz, shape):
    arr = np.random.default_rng(len(shape)).integers(0, 256, shape)
    path = tmp_path / ("x.idx.gz" if gz else "x.idx")
    _write_idx(path, arr, gz)
    got, want = fetchers._read_idx(path), jax_fetchers._read_idx(path)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == shape
    assert got.tobytes() == want.tobytes() == arr.astype(np.uint8).tobytes()


def _assert_ds_equal(got, want):
    assert got.features.tobytes() == np.asarray(want.features).tobytes()
    assert got.labels.tobytes() == np.asarray(want.labels).tobytes()
    assert got.features.shape == want.features.shape


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", [{"num_examples": 200},
                                {"num_examples": 64, "flatten": True}])
def test_load_mnist_stand_in_equals_jax(empty_cache, train, kw):
    _assert_ds_equal(fetchers.load_mnist(train, **kw),
                     jax_fetchers.load_mnist(train, **kw))


def test_load_mnist_full_stand_in_equals_jax(empty_cache):
    got, want = fetchers.load_mnist(False), jax_fetchers.load_mnist(False)
    assert got.num_examples() == 8192
    _assert_ds_equal(got, want)


def test_load_mnist_reads_cached_idx_files_as_jax(empty_cache):
    rng = np.random.default_rng(3)
    (empty_cache / "mnist").mkdir(parents=True)
    for sub, n in (("train", 50), ("test", 20)):
        _write_idx(empty_cache / "mnist" / fetchers.MNIST_FILES[
            f"{sub}_images"], rng.integers(0, 256, (n, 28, 28)), True)
        _write_idx(empty_cache / "mnist" / fetchers.MNIST_FILES[
            f"{sub}_labels"], rng.integers(0, 10, (n,)), True)
    for train in (True, False):
        got = fetchers.load_mnist(train)
        _assert_ds_equal(got, jax_fetchers.load_mnist(train))
        assert got.num_examples() == (50 if train else 20)


def test_other_fetchers_equal_jax(empty_cache):
    _assert_ds_equal(fetchers.load_iris(), jax_fetchers.load_iris())
    assert fetchers.load_iris().features.shape == (150, 4)
    _assert_ds_equal(fetchers.load_cifar10(True, 96),
                     jax_fetchers.load_cifar10(True, 96))
    _assert_ds_equal(fetchers.load_lfw(40, 5, (16, 16)),
                     jax_fetchers.load_lfw(40, 5, (16, 16)))
    _assert_ds_equal(fetchers.load_curves(30), jax_fetchers.load_curves(30))


def test_lfw_reads_a_cached_directory_as_jax(empty_cache):
    rng = np.random.default_rng(5)
    for person in ("ann", "bob", "cy"):
        d = empty_cache / "lfw" / person
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"{i}.npy",
                    rng.integers(0, 256, (12, 10, 3)).astype(np.float32))
    for train in (True, False):
        got = fetchers.load_lfw(20, image_hw=(8, 9), train=train)
        _assert_ds_equal(got, jax_fetchers.load_lfw(20, image_hw=(8, 9),
                                                    train=train))
    assert got.features.shape[1:] == (3, 8, 9)


def test_fetcher_iterators_equal_jax(empty_cache):
    pairs = [
        (fetchers.MnistDataSetIterator(32, 100, seed=4),
         jax_fetchers.MnistDataSetIterator(32, 100, seed=4)),
        (fetchers.IrisDataSetIterator(50), jax_fetchers.IrisDataSetIterator(50)),
        (fetchers.CifarDataSetIterator(16, 40, train=False),
         jax_fetchers.CifarDataSetIterator(16, 40, train=False)),
        (fetchers.LFWDataSetIterator(8, 20, 4, (8, 8)),
         jax_fetchers.LFWDataSetIterator(8, 20, 4, (8, 8))),
        (fetchers.CurvesDataSetIterator(7, 20),
         jax_fetchers.CurvesDataSetIterator(7, 20))]
    for it, jit in pairs:
        got, want = list(it), list(jit)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            _assert_ds_equal(a, b)


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------

def _norm_batches(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [DataSet((rng.normal(size=(9, 2, 3)) * 4 + 1).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)])
            for _ in range(n)]


NORMALIZERS = [("NormalizerStandardize", (), ("mean", "std")),
               ("NormalizerMinMaxScaler", (-1.0, 2.0), ("min", "max")),
               ("ImagePreProcessingScaler", (0.0, 1.0, 10.0), ())]


@pytest.mark.parametrize("name,args,stats", NORMALIZERS)
@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_normalizers_match_jax_and_round_trip(name, args, stats, source):
    batches = _norm_batches()
    jbatches = [JaxDataSet(d.features, d.labels) for d in batches]
    norm = getattr(normalizers, name)(*args)
    jnorm = getattr(jax_norm, name)(*args)
    if source == "dataset":
        norm.fit(DataSet.merge(batches))
        jnorm.fit(JaxDataSet.merge(jbatches))
    else:
        it = ListDataSetIterator(batches)
        it.next()              # a fit over the batches rewinds it first
        norm.fit(it)
        assert it._i == (0 if stats else 1)
        jnorm.fit(JaxListIterator(jbatches))
    for k in stats:
        np.testing.assert_allclose(getattr(norm, k), getattr(jnorm, k),
                                   rtol=NORM_TOL, atol=NORM_TOL)
    x = batches[0].features
    np.testing.assert_allclose(norm.transform(batches[0]).features,
                               jnorm.transform(jbatches[0]).features,
                               rtol=NORM_TOL, atol=NORM_TOL)
    # the dicts are each other's: port -> JAX and JAX -> port
    from_port = jax_norm.Normalizer.from_dict(norm.to_dict())
    from_jax = normalizers.Normalizer.from_dict(jnorm.to_dict())
    assert type(from_jax).__name__ == type(from_port).__name__ == name
    assert norm.to_dict() == jnorm.to_dict()
    for n in (from_port, from_jax):
        np.testing.assert_allclose(n.transform_features(x),
                                   norm.transform_features(x),
                                   rtol=NORM_TOL, atol=NORM_TOL)


def test_normalizer_fit_on_empty_iterator_raises():
    with pytest.raises(ValueError, match="empty"):
        normalizers.NormalizerStandardize().fit(ListDataSetIterator([]))
    assert set(normalizers.NORMALIZER_REGISTRY) == {n for n, _, _ in
                                                   NORMALIZERS}


# ---------------------------------------------------------------------------
# the plain iterators
# ---------------------------------------------------------------------------

def _batches(n=13, rows=6, cols=4, seed=0, masks=False):
    """Batches whose first feature is their index (the identity marker of
    ``tests/test_input_pipeline.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = rng.normal(size=(rows, cols)).astype(np.float32)
        f[0, 0] = i
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]
        fm = rng.integers(0, 2, (rows,)).astype(np.float32) if masks else None
        out.append(DataSet(f, y, fm, None))
    return out


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _ids(batches):
    return [int(d.features[0, 0]) for d in batches]


def test_plain_iterators():
    batches = _batches(n=4)
    ex = ExistingDataSetIterator(lambda: iter(batches))
    assert _ids(_drain(ex)) == [0, 1, 2, 3] and ex.batch_size() == 0
    ex.reset()
    assert ex.batch_size() == 6 and _ids(_drain(ex)) == [0, 1, 2, 3]
    me = MultipleEpochsIterator(3, ListDataSetIterator(batches))
    assert _ids(_drain(me)) == [0, 1, 2, 3] * 3
    me.reset()
    assert len(_drain(me)) == 12
    whole = DataSet.merge(batches)
    sampler = SamplingDataSetIterator(whole, 5, 3, seed=2)
    drawn = _drain(sampler)
    assert [d.num_examples() for d in drawn] == [5, 5, 5]
    idx = np.random.default_rng(2).integers(0, 24, 5)
    np.testing.assert_array_equal(drawn[0].features, whole.features[idx])


# ---------------------------------------------------------------------------
# the async pipeline (the cases of tests/test_input_pipeline.py)
# ---------------------------------------------------------------------------

def _wait_threads(base, timeout=5.0):
    deadline = time.time() + timeout
    while threading.active_count() > base and time.time() < deadline:
        time.sleep(0.02)
    return threading.active_count()


def test_async_order_byte_identical_to_sync():
    batches = _batches(masks=True)
    sync = _drain(ListDataSetIterator(list(batches)))
    for workers in (1, 3):
        it = AsyncDataSetIterator(ListDataSetIterator(list(batches)),
                                  workers=workers, queue_size=3,
                                  staging_depth=2)
        got = _drain(it)
        it.close()
        assert len(got) == len(sync)
        for a, b in zip(got, sync):
            assert a.features.tobytes() == b.features.tobytes()
            assert a.labels.tobytes() == b.labels.tobytes()
            assert a.features_mask.tobytes() == b.features_mask.tobytes()


def test_two_epochs_reset_keeps_order():
    batches = _batches()
    it = AsyncDataSetIterator(ListDataSetIterator(list(batches)), workers=2)
    first = _drain(it)
    it.reset()
    second = _drain(it)
    it.close()
    assert _ids(first) == _ids(second) == list(range(len(batches)))


def test_staging_onto_the_cpu_copies_into_tensors():
    batches = _batches(n=5, masks=True)
    it = AsyncDataSetIterator(ListDataSetIterator(batches), workers=2,
                              device="cpu")
    got = _drain(it)
    it.close()
    for a, b in zip(got, batches):
        assert isinstance(a.features, torch.Tensor)
        assert a.labels_mask is None
        for k in ("features", "labels", "features_mask"):
            t = getattr(a, k)
            assert np.array_equal(t.numpy(), getattr(b, k))
            assert t.data_ptr() != getattr(b, k).ctypes.data
    staged = stage_batch(batches[0], torch.device("cpu"))
    batches[0].features[:] = -1           # the host array changes after
    assert staged.features[0, 0] == 0     # staging: the copy does not


def test_worker_exception_surfaces_at_position():
    def boom(d):
        if int(d.features[0, 0]) == 3:
            raise RuntimeError("etl boom @3")
        return d

    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=8)),
                              workers=3, transform=boom)
    got = []
    with pytest.raises(RuntimeError, match="etl boom"):
        while it.has_next():
            got.append(it.next())
    it.close()
    assert _ids(got) == [0, 1, 2]


def test_one_worker_transforms_on_the_feeder_thread():
    """With one worker the feeder runs the ETL itself (no worker thread,
    no task queue): order, and an ETL exception at its position, as with
    several workers."""
    seen = set()

    def boom(d):
        seen.add(threading.current_thread().name)
        if int(d.features[0, 0]) == 5:
            raise RuntimeError("etl boom @5")
        return d

    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=8)),
                              workers=1, transform=boom)
    got = []
    with pytest.raises(RuntimeError, match="etl boom"):
        while it.has_next():
            got.append(it.next())
    it.close()
    assert _ids(got) == [0, 1, 2, 3, 4]
    assert seen == {"dl4j-pipe-feeder"}


def test_staging_failure_surfaces_at_position():
    """A batch that cannot be staged raises at its position: there is no
    fallback to host arrays."""
    batches = _batches(n=5)
    batches[2] = DataSet(np.array(["not", "numbers"]), batches[2].labels)
    it = AsyncDataSetIterator(ListDataSetIterator(batches), workers=2,
                              device="cpu")
    got = []
    with pytest.raises(TypeError):
        while it.has_next():
            got.append(it.next())
    it.close()
    assert [int(d.features[0, 0]) for d in got] == [0, 1]


def test_feeder_exception_surfaces():
    class ExplodingIterator(DataSetIterator):
        def __init__(self):
            self._i = 0

        def has_next(self):
            return True

        def next(self):
            if self._i == 2:
                raise ValueError("reader died")
            self._i += 1
            return _batches(n=1)[0]

        def reset(self):
            self._i = 0

    it = AsyncDataSetIterator(ExplodingIterator(), workers=2)
    with pytest.raises(ValueError, match="reader died"):
        _drain(it)
    it.close()


class _Infinite(DataSetIterator):
    def has_next(self):
        return True

    def next(self):
        return _batches(n=1)[0]

    def reset(self):
        pass


def test_close_is_idempotent_and_unblocks_producer():
    base = threading.active_count()
    it = AsyncDataSetIterator(_Infinite(), workers=2, queue_size=2,
                              staging_depth=1)
    assert it.has_next()
    it.next()
    # the feeder now waits on a full task queue; close() must still
    # unwind everything promptly
    it.close()
    it.close()
    assert _wait_threads(base) <= base
    it.reset()                # not started after close: must not raise


def test_reset_mid_stream_no_thread_leak():
    base = threading.active_count()
    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=10)), workers=3)
    it.next()
    it.reset()
    assert len(_drain(it)) == 10
    it.close()
    assert _wait_threads(base) <= base


def test_gc_reclaims_pipeline_threads():
    base = threading.active_count()
    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=10)), workers=3)
    it.next()
    del it
    gc.collect()
    assert _wait_threads(base) <= base


def test_staging_depth_bounds_resident_batches():
    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=16)),
                              workers=4, queue_size=8, staging_depth=2)
    while it.has_next():
        it.next()
        time.sleep(0.003)  # slow consumer: workers run ahead to the cap
    hw = it.staging_high_water
    it.close()
    assert 1 <= hw <= 2, hw
    assert it.staging_high_water == hw      # survives close()


def _consumed():
    return monitor.get_registry().counter(
        "dl4j_pipeline_batches_total",
        labels=("stage",)).labels(stage="consumed").value


def test_pipeline_metrics_populated():
    reg = monitor.get_registry()
    before = _consumed()
    it = AsyncDataSetIterator(ListDataSetIterator(_batches(n=5)), workers=2)
    _drain(it)
    it.close()
    assert _consumed() - before == 5
    assert reg.counter("dl4j_pipeline_staged_bytes_total").value > 0
    assert reg.gauge("dl4j_pipeline_workers").value == 2


# ---------------------------------------------------------------------------
# fit through the pipeline
# ---------------------------------------------------------------------------

def _dense_conf(workers, updater="sgd"):
    return (network.NeuralNetConfiguration.builder().seed(7)
            .updater(updater).learning_rate(0.1)
            .input_pipeline(workers=workers, prefetch=3, staging_depth=2)
            .list()
            .layer(L.DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="negativeloglikelihood"))
            .build())


def test_fit_through_the_pipeline_equals_sync_fit():
    batches = _batches(n=6)
    nets = {}
    for w in (0, 1, 3):
        before = _consumed()
        net = MultiLayerNetwork(_dense_conf(w), device="cpu").init()
        net.fit(ListDataSetIterator(list(batches)), epochs=2)
        assert _consumed() - before == (12 if w else 0)
        nets[w] = net
    for w in (1, 3):
        assert nets[w].score() == nets[0].score()
        assert torch.equal(nets[w].params(), nets[0].params())


def test_fit_closes_the_pipeline_when_a_step_raises():
    base = threading.active_count()
    net = MultiLayerNetwork(_dense_conf(2), device="cpu").init()
    bad = _batches(n=4)
    bad[1] = DataSet(bad[1].features[:, :3], bad[1].labels)
    with pytest.raises(RuntimeError):
        net.fit(ListDataSetIterator(bad))
    assert _wait_threads(base) <= base


def _numpy_params(net, seed):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=tuple(v.shape)) * (
        np.sqrt(2.0 / np.prod(v.shape[1:] if v.ndim == 4 else v.shape[:1]))
        if k == "W" else 0.1)).astype(np.float32) for k, v in lp.items()}
        for lp in net.net_params]


def _assert_params_close(net, jnet, inside=1.0, outer_atol=None):
    for i, (lp, jp) in enumerate(zip(net.net_params, jnet.net_params)):
        for k in jp:
            got, want = lp[k].detach().numpy(), np.asarray(jp[k])
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= inside, (i, k, ok.mean())
            if outer_atol is not None:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=outer_atol)


def test_lenet_adam_fit_through_the_pipeline_matches_jax():
    net = lenet(seed=3, device="cpu").init()
    params = _numpy_params(net, 1)
    net.load_jax_params(params)
    jnet = JaxNet(jax_lenet(seed=3).conf).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    rng = np.random.default_rng(0)
    data = [(rng.random((16, 1, 28, 28), np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)])
            for _ in range(4)]
    before = _consumed()
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    jnet.fit(JaxListIterator([JaxDataSet(x, y) for x, y in data]))
    assert _consumed() - before == 4
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=ADAM_SCORE_RTOL)
    _assert_params_close(net, jnet, ADAM_INSIDE, ADAM_ATOL)
    assert net.iteration == jnet.iteration == 4


# ---------------------------------------------------------------------------
# DropConnect
# ---------------------------------------------------------------------------

def _drop_connect_pair(rate=0.6):
    def conf(layers, net):
        return (net.NeuralNetConfiguration.builder().seed(4)
                .updater("sgd").learning_rate(0.05).list()
                .layer(layers.DenseLayer(n_in=6, n_out=32, activation="tanh",
                                         dropout=rate, use_drop_connect=True))
                .layer(layers.OutputLayer(n_in=32, n_out=4,
                                          activation="softmax",
                                          loss="mcxent", dropout=rate,
                                          use_drop_connect=True))
                .build())
    net = MultiLayerNetwork(conf(L, network), device="cpu").init()
    params = _numpy_params(net, 2)
    net.load_jax_params(params)
    jnet = JaxNet(conf(jax_layers, jax_network)).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    return net, jnet


def test_drop_connect_inference_matches_jax():
    net, jnet = _drop_connect_pair()
    x = np.random.default_rng(1).normal(size=(10, 6)).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=DROP_TOL,
                               atol=DROP_TOL)


def test_drop_connect_training_mask():
    rate = 0.6
    layer = L.DenseLayer(n_in=200, n_out=100, dropout=rate,
                         use_drop_connect=True)
    params = {"W": torch.ones(200, 100), "b": torch.full((100,), 3.0)}
    assert layer._maybe_drop_connect(params, False, (1, 2)) is params
    out = layer._maybe_drop_connect(params, True, (1, 2))
    assert out["b"] is params["b"]                       # biases intact
    w = out["W"]
    kept = w != 0
    assert torch.all(w[kept] == 1 / torch.tensor(rate))  # inverted scaling
    n = w.numel()
    share = float(kept.float().mean())
    assert abs(share - rate) <= 5 * np.sqrt(rate * (1 - rate) / n), share
    again = layer._maybe_drop_connect(params, True, (1, 2))["W"]
    other = layer._maybe_drop_connect(params, True, (1, 3))["W"]
    assert torch.equal(again, w) and not torch.equal(other, w)
    # the input is not dropped under DropConnect
    x = torch.ones(3, 200)
    assert layer._maybe_dropout(x, True, (1, 2)) is x


def test_drop_connect_dropped_weights_get_no_gradient():
    rate = 0.5
    layer = L.DenseLayer(n_in=30, n_out=20, activation="tanh", dropout=rate,
                         use_drop_connect=True)
    W = torch.randn(30, 20, generator=torch.Generator().manual_seed(0))
    params = {"W": W.clone().requires_grad_(), "b": torch.zeros(20,
                                                               requires_grad=True)}
    x = torch.randn(8, 30, generator=torch.Generator().manual_seed(1))
    y, _, _ = layer.forward(params, {}, x, train=True, seed=(5, 6))
    y.sum().backward()
    mask = layer._maybe_drop_connect({"W": torch.ones(30, 20)}, True,
                                     (5, 6))["W"] != 0
    assert torch.all(params["W"].grad[~mask] == 0)
    assert torch.count_nonzero(params["W"].grad[mask]) == int(mask.sum())


def test_fit_with_drop_connect_trains_the_kept_weights():
    net, _ = _drop_connect_pair()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    before = [{k: v.clone() for k, v in lp.items()} for lp in net.net_params]
    net.fit(x, y)
    assert np.isfinite(net.score())
    for lp, lb in zip(net.net_params, before):
        moved = lp["W"] != lb["W"]
        assert 0 < float(moved.float().mean()) < 1    # dropped ones stay


# ---------------------------------------------------------------------------
# .npz exports and the gateway's fit / evaluate RPCs
# ---------------------------------------------------------------------------

def _shards(directory, n=5, rows=12, last=5, seed=0):
    """``n`` exported minibatches of a linearly separable 3-class problem,
    the last one short, written by the JAX package."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(5, 3))
    directory.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        k = last if i == n - 1 else rows
        x = rng.normal(size=(k, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
        jax_data.export_dataset(JaxDataSet(x, y), directory / f"b{i}.npz")
    return directory


def test_exports_read_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    ds = DataSet(rng.normal(size=(4, 3)).astype(np.float32),
                 np.eye(2, dtype=np.float32)[[0, 1, 1, 0]],
                 None, np.ones((4,), np.float32))
    port_data.export_dataset(ds, tmp_path / "p")
    back = jax_data.load_dataset(tmp_path / "p.npz")
    assert back.features_mask is None
    np.testing.assert_array_equal(back.labels_mask, ds.labels_mask)
    d = _shards(tmp_path / "shards", n=11)
    got = port_data.PathDataSetIterator.from_dir(d)
    want = jax_data.PathDataSetIterator.from_dir(d)
    assert got.paths == want.paths           # b0..b9 before b10
    for a, b in zip(_drain(got), _drain(want)):
        _assert_ds_equal(a, b)
    with pytest.raises(NotImplementedError, match="A9"):
        port_data.PathDataSetIterator(got.paths, prefetch=True)


def _gateway_model(tmp_path, updater):
    conf = (jax_network.NeuralNetConfiguration.builder()
            .seed(3).learning_rate(0.1).updater(updater).list()
            .layer(jax_layers.DenseLayer(n_in=5, n_out=16,
                                         activation="relu"))
            .layer(jax_layers.OutputLayer(n_in=16, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"))
            .build())
    path = tmp_path / f"{updater}.zip"
    jax_ser.write_model(JaxNet(conf).init(), path)
    return str(path)


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_gateway_fit_and_evaluate_match_jax(tmp_path, updater):
    data = str(_shards(tmp_path / "data"))
    model = _gateway_model(tmp_path, updater)
    ep = gateway.DeepLearning4jEntryPoint(device="cpu")
    jep = JaxEntryPoint()
    got = ep.fit(model, data, epochs=3, save_path=str(tmp_path / "port"))
    want = jep.fit(model, data, epochs=3, save_path=str(tmp_path / "jax"))
    assert got["model_path"] == str(tmp_path / "port.zip")
    trained = ser.restore_multi_layer_network(got["model_path"],
                                              device="cpu")
    jtrained = jax_ser.restore_multi_layer_network(want["model_path"])
    if updater == "sgd":
        np.testing.assert_allclose(got["score"], want["score"], rtol=FIT_RTOL)
        _assert_params_close(trained, jtrained, 1.0)
    else:
        np.testing.assert_allclose(got["score"], want["score"],
                                   rtol=ADAM_SCORE_RTOL)
        _assert_params_close(trained, jtrained, ADAM_INSIDE, ADAM_ATOL)
    # the updater state went into the zip, as JAX's
    np.testing.assert_allclose(ser.read_updater_state(got["model_path"]),
                               np.asarray(jtrained.updater_state_flat()),
                               rtol=1e-3, atol=1e-3)
    # evaluate on one zip: the JAX-trained one, read by both packages
    xs = [d.features for d in _drain(port_data.PathDataSetIterator.from_dir(
        data))]
    out = np.concatenate([trained.output(x).numpy() for x in xs])
    jout = np.concatenate([np.asarray(jtrained.output(x)) for x in xs])
    assert float(np.sort(jout)[:, -1:].min()) > 0
    top = np.sort(jout, axis=1)
    assert (top[:, -1] - top[:, -2]).min() > 2 * np.abs(out - jout).max()
    got_ev = ep.evaluate(want["model_path"], data)
    want_ev = jep.evaluate(want["model_path"], data)
    assert got_ev == want_ev


def test_gateway_fit_invalidates_and_serves_the_trained_model(tmp_path):
    data = str(_shards(tmp_path / "data", seed=2))
    model = _gateway_model(tmp_path, "sgd")
    ep = gateway.DeepLearning4jEntryPoint(device="cpu")
    x = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    before = ep.predict(model, x.tolist())["predictions"]
    res = ep.fit(model, data, epochs=2)
    assert res["model_path"] == model
    after = ep.predict(model, x.tolist())["predictions"]
    want = ser.restore_multi_layer_network(model, device="cpu").output(x)
    np.testing.assert_allclose(after, want.numpy(), rtol=1e-6, atol=1e-7)
    assert not np.allclose(after, before)
    ep.close()


def test_gateway_fit_evaluate_over_http(tmp_path):
    import json
    import urllib.request
    data = str(_shards(tmp_path / "data", seed=3))
    model = _gateway_model(tmp_path, "adam")
    srv = gateway.Server(device="cpu").start()
    try:
        def rpc(method, **params):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/",
                data=json.dumps({"method": method,
                                 "params": params}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())["result"]
        res = rpc("fit", model_path=model, data_dir=data, epochs=20)
        assert np.isfinite(res["score"])
        ev = rpc("evaluate", model_path=res["model_path"], data_dir=data)
        direct = ser.restore_multi_layer_network(
            model, device="cpu").evaluate(
                port_data.PathDataSetIterator.from_dir(data))
        assert ev == {"accuracy": direct.accuracy(), "f1": direct.f1()}
        assert ev["accuracy"] > 0.8
    finally:
        srv.stop()
    assert {"fit", "evaluate"} <= gateway.RPC_METHODS


@pytest.mark.parametrize("layout", ["subdirs", "batch_files"])
def test_gateway_hdf5_layouts_raise_naming_keras_import(tmp_path, layout):
    """The reference's HDF5 layouts go to Keras import's
    ``HDF5MiniBatchDataSetIterator``, as in JAX's gateway: subdirs
    without ``batch_%d.h5`` files raise its FileNotFoundError in both
    packages (reading real files: ``tests/test_torch_keras_import.py``)."""
    from deeplearning4j_tpu_torch.keras_import.hdf5_data import (
        HDF5MiniBatchDataSetIterator)
    d = tmp_path / "h5"
    if layout == "subdirs":
        (d / "features").mkdir(parents=True)
        (d / "labels").mkdir()
        for ep in (gateway.DeepLearning4jEntryPoint, JaxEntryPoint):
            with pytest.raises(FileNotFoundError, match="batch_"):
                ep._data_iterator(str(d))
    else:
        d.mkdir()
        (d / "batch_0.h5").write_bytes(b"")
        it = gateway.DeepLearning4jEntryPoint._data_iterator(str(d))
        assert isinstance(it, HDF5MiniBatchDataSetIterator)
        assert [p.name for p in it._files] == ["batch_0.h5"]
        assert type(JaxEntryPoint._data_iterator(str(d))).__name__ == \
            "HDF5MiniBatchDataSetIterator"
    # a stray .h5 that is not batch_%d.h5 leaves the .npz path in place
    _shards(tmp_path / "npz", n=2)
    (tmp_path / "npz" / "batch_old.h5").write_bytes(b"")
    it = gateway.DeepLearning4jEntryPoint._data_iterator(
        str(tmp_path / "npz"))
    assert len(_drain(it)) == 2
