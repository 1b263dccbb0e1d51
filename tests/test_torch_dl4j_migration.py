"""The port's migration of zips the Java DL4J wrote
(``deeplearning4j_tpu_torch/nn/dl4j_migration.py``), held against the JAX
package's (``deeplearning4j_tpu/nn/dl4j_migration.py``) on the CPU.

* Each frozen ``tests/regression/dl4j_071_*.zip`` restores through the
  port's ``load_model`` to params, layer state and updater state equal to
  JAX's restore, element for element, and to outputs within rtol = atol =
  1e-6 (float32 forwards summed in other orders on a seeded input).
* A Java-schema zip the port exports restores in JAX to equal params and
  updater state, and the reverse; re-exporting a restored zip writes the
  same ``coefficients.bin`` and ``updaterState.bin`` bytes.
* A pretrain layer (AutoEncoder, RBM, VariationalAutoencoder) or a
  Nesterovs momentum schedule raises a ValueError naming the layer, on
  restore and on export: DL4J's updater blocks never merge a pretrain
  layer's params and split on a momentum schedule, rules this migration
  does not replay (the JAX package's copy slices such a zip anyway).
"""

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import dl4j_migration as jax_mig
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.nn import dl4j_migration as mig
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain as LP
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

REGRESSION = Path(__file__).resolve().parent / "regression"
OUT_TOL = 1e-6
# fixture -> per-example input shape of its seeded batch
FIXTURES = {"mlp": (3,), "convbn": (1, 6, 6), "bilstm": (5, 2),
            "cg": (4,), "cg_ustate": (4,)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in _leaves(t)]
    return [np.asarray(tree.detach().cpu() if hasattr(tree, "detach")
                       else tree)]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _outputs(net, x):
    out = net.output(x)
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(out.detach().cpu() if hasattr(out, "detach") else out)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_restores_as_jax(name):
    path = REGRESSION / f"dl4j_071_{name}.zip"
    port = ser.load_model(path, device="cpu")
    jnet = jax_ser.load_model(path)
    assert type(port).__name__ == type(jnet).__name__
    np.testing.assert_array_equal(port.params().numpy(),
                                  np.asarray(jnet.params()))
    _equal_trees(port.net_state, jnet.net_state)
    np.testing.assert_array_equal(port.updater_state_flat().numpy(),
                                  np.asarray(jnet.updater_state_flat()))
    x = np.random.default_rng(9).normal(
        size=(3,) + FIXTURES[name]).astype(np.float32)
    np.testing.assert_allclose(_outputs(port, x), _outputs(jnet, x),
                               rtol=OUT_TOL, atol=OUT_TOL)


def _zip_member(path, member):
    """The member's bytes, None when the zip holds none."""
    with zipfile.ZipFile(path) as zf:
        return zf.read(member) if member in zf.namelist() else None


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_export_round_trips_both_ways(name, tmp_path):
    """The port's export restores in JAX, JAX's export in the port, and
    each package re-exports the other's zip byte for byte."""
    src = REGRESSION / f"dl4j_071_{name}.zip"
    port = ser.load_model(src, device="cpu")
    jnet = jax_ser.load_model(src)
    graph = "cg" in name
    port_zip, jax_zip = tmp_path / "port.zip", tmp_path / "jax.zip"
    (mig.export_computation_graph if graph
     else mig.export_multi_layer_network)(port, port_zip)
    (jax_mig.export_computation_graph if graph
     else jax_mig.export_multi_layer_network)(jnet, jax_zip)
    for member in ("coefficients.bin", "updaterState.bin"):
        assert _zip_member(port_zip, member) == _zip_member(jax_zip, member)
    in_jax = jax_ser.load_model(port_zip)
    in_port = ser.load_model(jax_zip, device="cpu")
    np.testing.assert_array_equal(np.asarray(in_jax.params()),
                                  port.params().numpy())
    np.testing.assert_array_equal(in_port.updater_state_flat().numpy(),
                                  np.asarray(jnet.updater_state_flat()))
    again = tmp_path / "again.zip"
    (mig.export_computation_graph if graph
     else mig.export_multi_layer_network)(in_port, again)
    assert _zip_member(again, "coefficients.bin") == \
        _zip_member(jax_zip, "coefficients.bin")


def test_trained_port_net_exports_to_jax(tmp_path):
    """A port network after two Adam steps (updater state made by the port)
    exports a Java zip JAX restores to equal params and Adam moments."""
    conf = (network.NeuralNetConfiguration.builder().seed(5)
            .learning_rate(0.05).updater("adam").list()
            .layer(L.DenseLayer(n_in=6, n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    net.fit(x, y)
    net.fit(x, y)
    path = tmp_path / "java.zip"
    mig.export_multi_layer_network(net, path)
    jnet = jax_ser.load_model(path)
    np.testing.assert_array_equal(np.asarray(jnet.params()),
                                  net.params().numpy())
    np.testing.assert_array_equal(np.asarray(jnet.updater_state_flat()),
                                  net.updater_state_flat().numpy())
    back = ser.load_model(path, device="cpu")
    np.testing.assert_allclose(back.output(x).numpy(), net.output(x).numpy(),
                               rtol=0, atol=0)


def _java_zip(path, layer_json):
    """A one-layer Java-schema zip around ``layer_json`` ({type: json})."""
    top = {"confs": [{"layer": layer_json, "seed": 1}],
           "backprop": True, "pretrain": False}
    buf = io.BytesIO()
    mig.write_nd4j_array(buf, np.zeros((1, 12), np.float32))
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(top))
        zf.writestr("coefficients.bin", buf.getvalue())


@pytest.mark.parametrize("layer_json, match", [
    ({"autoEncoder": {"layerName": "ae0", "nIn": 3, "nOut": 2}},
     "'ae0'.*pretrain"),
    ({"RBM": {"layerName": "rbm0", "nIn": 3, "nOut": 2}}, "'rbm0'.*pretrain"),
    ({"variationalAutoencoder": {"layerName": "vae0", "nIn": 3,
                                 "nOut": 2}}, "'vae0'.*pretrain"),
    ({"dense": {"layerName": "d0", "nIn": 3, "nOut": 3, "updater":
                "NESTEROVS", "momentumSchedule": {"10": 0.5}}},
     "'d0'.*momentum schedule"),
])
def test_restore_refuses_what_it_would_mis_slice(layer_json, match,
                                                 tmp_path):
    path = tmp_path / "java.zip"
    _java_zip(path, layer_json)
    with pytest.raises(ValueError, match=match):
        ser.load_model(path, device="cpu")


@pytest.mark.parametrize("layer", [
    LP.AutoEncoder(name="ae", n_in=4, n_out=3, activation="sigmoid"),
    LP.RBM(name="rbm", n_in=4, n_out=3),
    LP.VariationalAutoencoder(name="vae", n_in=4, n_out=2,
                              encoder_layer_sizes=(3,),
                              decoder_layer_sizes=(3,)),
], ids=["autoencoder", "rbm", "vae"])
def test_export_refuses_pretrain_layers(layer, tmp_path):
    """JAX's exporter slices a pretrain layer as a plain W, b layer and
    drops its other views; the port's raises, naming the layer."""
    conf = (network.NeuralNetConfiguration.builder().seed(3).list()
            .layer(layer)
            .layer(L.OutputLayer(n_out=2, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match=f"'{layer.name}'.*pretrain"):
        mig.export_multi_layer_network(net, tmp_path / "x.zip")


def test_jax_restore_of_a_momentum_schedule_is_what_the_guard_prevents(
        tmp_path):
    """The reference restores a zip with a momentum schedule silently (its
    block rule ignores the schedule); the port's guard refuses it."""
    path = tmp_path / "java.zip"
    _java_zip(path, {"dense": {"layerName": "d0", "nIn": 3, "nOut": 3,
                               "updater": "NESTEROVS",
                               "momentumSchedule": {"10": 0.5}}})
    assert isinstance(jax_ser.load_model(path), JaxNet)
    with pytest.raises(ValueError, match="momentum schedule"):
        mig.restore_multi_layer_network(path, device="cpu")


def test_restore_on_device_and_without_updater():
    """``load_updater=False`` makes no updater state (a served model holds
    none); params land on the asked device as float32."""
    net = ser.load_model(REGRESSION / "dl4j_071_convbn.zip", device="cpu",
                         load_updater=False)
    assert net.opt_states is None
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for lp in net.net_params for v in lp.values())
    assert isinstance(net.layers[1], L.BatchNormalization)
