"""The port's network engine (configuration, params, zip, output) held
against the JAX package on the CPU.

Both packages build the same configurations with the same builder calls;
weights are carried from the JAX network to the port through the zip and
through ``params_from_jax``.  Output tolerance: rtol = atol = 1e-5 in
float32 (the same products summed in another order).  Where the JAX
network runs the Pallas conv kernel, it is forced in interpret mode with
``DL4J_PALLAS_CONV=1``, as the JAX package's own tests do.
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.models import lenet, vgg16, vgg16_cifar10
from deeplearning4j_tpu_torch.nn import convert, params as param_util
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

RTOL = ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _small_vgg_conf(layers, net, input_type):
    """VGG16's recipe narrowed: 2 blocks of two 3x3 pad-1 relu convs at
    8 and 16 channels, 16x16x3 input, fc 32, 10 classes.  Built with
    either package's builder (the same calls)."""
    b = (net.NeuralNetConfiguration.builder().seed(7).learning_rate(0.01)
         .updater("nesterovs").weight_init("relu").list())
    for ch in (8, 16):
        for _ in range(2):
            b.layer(layers.ConvolutionLayer(n_out=ch, kernel=(3, 3),
                                            stride=(1, 1), padding=(1, 1),
                                            activation="relu"))
        b.layer(layers.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                        stride=(2, 2)))
    b.layer(layers.DenseLayer(n_out=32, activation="relu"))
    b.layer(layers.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
    return b.set_input_type(input_type.convolutional(16, 16, 3)).build()


def _jax_conf(name):
    if name == "lenet":
        return jax_lenet(seed=3).conf
    return _small_vgg_conf(jax_layers, jax_network, JaxInputType)


def _jax_param_shapes(conf):
    """The JAX package's own init, traced for shapes only."""
    params = jax.eval_shape(lambda: JaxNet(conf).init().net_params)
    return [{k: tuple(v.shape) for k, v in lp.items()} for lp in params]


def _jax_model(name, seed=1):
    """A JAX network whose weights are drawn with numpy from ``seed``
    (scaled like a relu init), so both packages get the same numbers."""
    conf = _jax_conf(name)
    rng = np.random.default_rng(seed)
    params = []
    for lp in _jax_param_shapes(conf):
        params.append({
            k: jnp.asarray((rng.normal(size=s) * (
                np.sqrt(2.0 / np.prod(s[1:] if len(s) == 4 else s[:1]))
                if k == "W" else 0.1)).astype(np.float32))
            for k, s in lp.items()})
    jnet = JaxNet(conf)
    jnet.net_params = params
    jnet.net_state = [{} for _ in conf.layers]
    return jnet


def _port_conf(name):
    if name == "lenet":
        return lenet(seed=3, device="cpu").conf
    return _small_vgg_conf(L, network, InputType)


def _features(name, n=4, seed=0):
    shape = (n, 1, 28, 28) if name == "lenet" else (n, 3, 16, 16)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_params_np(jnet):
    return [{k: np.asarray(v) for k, v in lp.items()}
            for lp in jnet.net_params]


@pytest.mark.parametrize("name", ["lenet", "vgg_small"])
def test_configuration_parity(name):
    """A JSON written by the JAX package builds the same net in the port,
    and the port's own builder writes that same JSON."""
    jnet = _jax_model(name)
    jax_json = jnet.conf.to_json()
    conf = network.MultiLayerConfiguration.from_json(jax_json)
    assert json.loads(conf.to_json()) == json.loads(jax_json)
    assert json.loads(_port_conf(name).to_json()) == json.loads(jax_json)
    assert [type(l).__name__ for l in conf.layers] == \
        [type(l).__name__ for l in jnet.conf.layers]
    net = MultiLayerNetwork(conf, device="cpu").init()
    shapes = [{k: tuple(v.shape) for k, v in lp.items()}
              for lp in net.net_params]
    assert shapes == _jax_param_shapes(jnet.conf)
    assert net.num_params() == jnet.num_params()


def test_training_only_global_fields_round_trip():
    """Global fields the port does not act on yet are written back."""
    d = json.loads(_port_conf("lenet").to_json())
    d["global"].update(shape_bucketing=True, bucket_batch_sizes=[8, 32],
                       precision="bfloat16", sharding_enabled=True,
                       ft_resume=True, dist_grad_quant="int8")
    conf = network.MultiLayerConfiguration.from_dict(d)
    assert json.loads(conf.to_json()) == d


def test_unported_layer_type_raises_on_load():
    """A layer class of the JAX package that the port lacks (the
    mixture-of-experts layer, ROADMAP A5) raises on load, naming it."""
    assert "MixtureOfExpertsLayer" in jax_layers.LAYER_REGISTRY
    d = json.loads(_port_conf("lenet").to_json())
    d["layers"][1]["@class"] = "MixtureOfExpertsLayer"
    with pytest.raises(NotImplementedError, match="MixtureOfExpertsLayer"):
        network.MultiLayerConfiguration.from_dict(d)


@pytest.mark.parametrize("name", ["lenet", "vgg_small"])
def test_zip_round_trip_is_byte_identical(name, tmp_path):
    jnet = _jax_model(name)
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    net = ser.restore_multi_layer_network(tmp_path / "jax.zip", device="cpu")
    ser.write_model(net, tmp_path / "port.zip")
    with zipfile.ZipFile(tmp_path / "jax.zip") as a, \
            zipfile.ZipFile(tmp_path / "port.zip") as b:
        assert a.read(ser.COEFFICIENTS_NAME) == b.read(ser.COEFFICIENTS_NAME)
        assert json.loads(a.read(ser.CONFIG_NAME)) == \
            json.loads(b.read(ser.CONFIG_NAME))
        # the port's configuration.json parses in the JAX package
        conf_dict = json.loads(b.read(ser.CONFIG_NAME))
    assert conf_dict.pop("@model") == "MultiLayerNetwork"
    back = jax_network.MultiLayerConfiguration.from_dict(conf_dict)
    assert json.loads(back.to_json()) == json.loads(jnet.conf.to_json())


def _bn_conf(layers, net, input_type):
    """Conv -> BatchNormalization -> relu -> dense -> BatchNormalization
    -> softmax output, built with either package's builder."""
    return (net.NeuralNetConfiguration.builder().seed(4).learning_rate(0.1)
            .updater("nesterovs").list()
            .layer(layers.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                           activation="identity"))
            .layer(layers.BatchNormalization(decay=0.5))
            .layer(layers.ActivationLayer(activation="relu"))
            .layer(layers.DenseLayer(n_out=6, activation="tanh"))
            .layer(layers.BatchNormalization(decay=0.5))
            .layer(layers.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(input_type.convolutional(6, 6, 2)).build())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_batch_norm_zip_round_trip_carries_no_running_statistics(writer,
                                                                 tmp_path):
    """A BatchNormalization net trained one step (its running statistics
    moved off 0 and 1) and written by either package restores in both
    with the same params and coefficients.bin; the zip holds the
    configuration, the coefficients and the updater state, and no running
    statistics, so both packages restore them as zeros and ones, as the
    JAX package's ModelSerializer zip does (nn/serialization.py:37-49)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 2, 6, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    if writer == "jax":
        src = JaxNet(_bn_conf(jax_layers, jax_network, JaxInputType)).init()
        src.fit(x, y)
        jax_ser.write_model(src, tmp_path / "bn.zip")
        moved = np.asarray(src.net_state[1]["var"])
    else:
        src = MultiLayerNetwork(_bn_conf(L, network, InputType),
                                device="cpu").init()
        src.fit(x, y)
        ser.write_model(src, tmp_path / "bn.zip")
        moved = src.net_state[1]["var"].numpy()
    assert not np.allclose(moved, 1.0)
    with zipfile.ZipFile(tmp_path / "bn.zip") as zf:
        assert sorted(zf.namelist()) == sorted(
            [ser.CONFIG_NAME, ser.COEFFICIENTS_NAME, ser.UPDATER_NAME])
        coefficients = zf.read(ser.COEFFICIENTS_NAME)
    net = ser.restore_multi_layer_network(tmp_path / "bn.zip", device="cpu")
    jnet = jax_ser.restore_multi_layer_network(tmp_path / "bn.zip")
    np.testing.assert_array_equal(net.params().numpy(),
                                  np.asarray(jnet.params()))
    assert net.params().numpy().astype("<f4").tobytes() == coefficients
    for s, js in zip(net.net_state, jnet.net_state):
        assert sorted(s) == sorted(js)
        for k in s:
            want = 0.0 if k == "mean" else 1.0
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
            assert bool((s[k] == want).all())
    ser.write_model(net, tmp_path / "again.zip")
    with zipfile.ZipFile(tmp_path / "again.zip") as zf:
        assert zf.read(ser.COEFFICIENTS_NAME) == coefficients
    x_new = rng.normal(size=(4, 2, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(net.output(x_new).numpy(),
                               np.asarray(jnet.output(x_new)), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("pallas", ["dense", "pallas"])
@pytest.mark.parametrize("route", ["zip", "params_from_jax"])
@pytest.mark.parametrize("name", ["lenet", "vgg_small"])
def test_output_parity_with_jax(name, route, pallas, tmp_path, monkeypatch):
    if pallas == "pallas":
        monkeypatch.setenv("DL4J_PALLAS_CONV", "1")
    jnet = _jax_model(name)
    if route == "zip":
        jax_ser.write_model(jnet, tmp_path / "m.zip")
        net = ser.load_model(tmp_path / "m.zip", device="cpu")
    else:
        net = MultiLayerNetwork(_port_conf(name), device="cpu")
        net.load_jax_params(_jax_params_np(jnet))
    x = _features(name)
    want = np.asarray(jnet.output(x))
    got = net.output(x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(net.predict(x), np.asarray(jnet.predict(x)))


def test_params_from_jax_keeps_layouts():
    jnet = _jax_model("vgg_small")
    ported = convert.params_from_jax(_jax_params_np(jnet), device="cpu")
    for lp, jp in zip(ported, jnet.net_params):
        for k in jp:
            assert ported is not None and lp[k].dtype == torch.float32
            np.testing.assert_array_equal(lp[k].numpy(), np.asarray(jp[k]))


def test_flat_params_round_trip():
    net = MultiLayerNetwork(_port_conf("vgg_small"), device="cpu").init(
        generator=torch.Generator().manual_seed(1))
    flat = net.params()
    assert flat.shape == (net.n_params,)
    other = MultiLayerNetwork(_port_conf("vgg_small"), device="cpu").init(
        generator=torch.Generator().manual_seed(2))
    assert not torch.equal(other.params(), flat)
    other.set_params(flat)
    x = _features("vgg_small")
    torch.testing.assert_close(other.output(x), net.output(x), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="mismatch"):
        param_util.unflatten(flat[:-1], net.net_params)


def test_init_is_seeded_and_device_independent_of_order():
    a = lenet(device="cpu").init(generator=torch.Generator().manual_seed(5))
    b = lenet(device="cpu").init(generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.params(), b.params())
    c = lenet(device="cpu").init()   # the configuration's seed
    d = lenet(device="cpu").init()
    assert torch.equal(c.params(), d.params())


def test_model_zoo_widths_match_jax():
    """The port's zoo builds the JAX package's configurations."""
    from deeplearning4j_tpu.models import vgg as jax_vgg
    pairs = [(lenet(device="cpu"), jax_lenet()),
             (vgg16_cifar10(device="cpu"), jax_vgg.vgg16_cifar10()),
             (vgg16(device="cpu"), jax_vgg.vgg16())]
    for net, jnet in pairs:
        assert json.loads(net.conf.to_json()) == \
            json.loads(jnet.conf.to_json())


def test_warmup_runs_the_ladder():
    net = lenet(device="cpu").init()
    out = net.warmup_inference((1, 28, 28), max_batch=4)
    assert out["buckets"] == [1, 2, 4]


def test_graph_zip_raises(tmp_path):
    """A ComputationGraph zip no longer raises: ``load_model`` tells it
    apart from a MultiLayerNetwork's by its configuration and restores
    it; JAX's ResNet-18 zip round-trips byte for byte through the port."""
    from deeplearning4j_tpu.models.resnet import resnet18 as jax_resnet18
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    jnet = jax_resnet18(16, 16, 3, 10).init()
    jpath, path = tmp_path / "jax_g.zip", tmp_path / "g.zip"
    jax_ser.write_model(jnet, jpath)
    net = ser.load_model(jpath, device="cpu")
    assert isinstance(net, ComputationGraph)
    assert net.conf.network_inputs == ["in"]
    ser.write_model(net, path)
    with zipfile.ZipFile(jpath) as a, zipfile.ZipFile(path) as b:
        for name in (ser.COEFFICIENTS_NAME, ser.UPDATER_NAME):
            assert a.read(name) == b.read(name)
        assert json.loads(a.read(ser.CONFIG_NAME)) == json.loads(
            b.read(ser.CONFIG_NAME))
    x = _features("vgg_small", 2)
    np.testing.assert_allclose(net.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]),
                               rtol=1e-5, atol=1e-5)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(_port_conf("lenet"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lenet(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax([])


def test_port_imports_no_jax():
    """Importing the port and every submodule loads neither JAX nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'deeplearning4j_tpu'\n"
        "             or n.startswith('deeplearning4j_tpu.'))\n"
        "print(len(mods), bad)\n"
        "print(' '.join(mods))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 10
    walked = proc.stdout.splitlines()[1].split()
    assert {"deeplearning4j_tpu_torch.parallel",
            "deeplearning4j_tpu_torch.parallel.sequence",
            "deeplearning4j_tpu_torch.models.attention",
            "deeplearning4j_tpu_torch.keras_import.importer",
            "deeplearning4j_tpu_torch.keras_import.hdf5_data"} <= set(walked)


def test_port_loads_without_h5py():
    """Keras import, the model cache and the gateway load without h5py
    (the card's machine has none): it is imported only where a ``.h5``
    file is read."""
    code = (
        "import sys\n"
        "import deeplearning4j_tpu_torch.keras_import\n"
        "import deeplearning4j_tpu_torch.server.gateway\n"
        "sys.exit(1 if 'h5py' in sys.modules or 'keras' in sys.modules "
        "else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
