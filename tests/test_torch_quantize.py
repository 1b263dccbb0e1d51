"""Weight-only int8 / fp8 quantized serving of the port
(``deeplearning4j_tpu_torch/ops/quantize.py``, ``quantize_inference`` on both
engines, the model cache's ``precision_infer_quant``) held against the JAX
package's on the CPU.

* Codes and scales: ``quantize_weight`` gives JAX's codes bit for bit
  (int8 values; fp8 as the bytes of ``float8_e4m3fn``) and equal float32
  scales, on dense [in, out] and OIHW conv weights (scaled per index of
  the last axis in both packages), a zero column and tiny magnitudes.
* Outputs: a quantized network's ``output`` against JAX's quantized
  ``output`` from the same params at rtol = 1e-5, atol = 1e-6: both expand
  the same codes to the same float32 weights, and the forwards sum float32
  products in other orders.
* JAX's own rules (``tests/test_precision.py:283-324``): top-1 agreement
  with the dense network at least 0.95 (int8) and 0.9 (fp8), int8 outputs
  within 0.05 of dense, resident bytes over 3x smaller, and
  ``quantize_inference(None)`` serving dense outputs again bit for bit.
* ``quantize_blocks``, ``dequantize_blocks`` and ``ErrorFeedback`` equal
  JAX's exactly (the same numpy).
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import helpers as jax_helpers
from deeplearning4j_tpu.ops import quantize as jax_qz
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import quantize as qz
from deeplearning4j_tpu_torch.server.model_cache import ModelCache

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _jax_tiers_clean():
    """JAX's tiers as its own tests leave them: validated afresh, none
    killed."""
    jax_helpers.reset_precision_validation()
    jax_qz.reset_disabled()
    yield
    jax_helpers.reset_precision_validation()
    jax_qz.reset_disabled()


def _weights():
    rng = np.random.default_rng(0)
    dense = (rng.normal(size=(24, 10)) * 3).astype(np.float32)
    dense[:, 3] = 0.0                                    # a zero column
    conv = (rng.normal(size=(6, 3, 5, 5)) * 0.2).astype(np.float32)
    tiny = (rng.normal(size=(7, 4)) * 1e-20).astype(np.float32)
    return {"dense": dense, "conv_oihw": conv, "tiny": tiny}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(_weights()))
def test_codes_bit_equal_to_jax(mode, name):
    w = _weights()[name]
    want = jax_qz.quantize_weight(w, mode)
    got = qz.quantize_weight(torch.from_numpy(w), mode)
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"].shape == tuple(np.asarray(want["s"]).shape)
    if mode == "int8":
        assert got["q"].dtype == torch.int8
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    else:
        assert got["q"].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            got["q"].view(torch.uint8).numpy(),
            np.asarray(want["q"]).view(np.uint8))
    np.testing.assert_array_equal(
        qz.dequantize_leaf(got).numpy(),
        np.asarray(jax_qz.dequantize_params(want)))


def _lenet_like():
    """A small conv net: conv 3x3 -> pool -> dense -> softmax, 10 x 10
    inputs, Adam."""
    conf = (jax_network.NeuralNetConfiguration.builder().seed(3)
            .learning_rate(0.01).updater("adam").list()
            .layer(jax_layers.ConvolutionLayer(
                n_out=6, kernel=(3, 3), activation="relu"))
            .layer(jax_layers.SubsamplingLayer(kernel=(2, 2),
                                               stride=(2, 2)))
            .layer(jax_layers.DenseLayer(n_out=32, activation="relu"))
            .layer(jax_layers.OutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(10, 10, 1))
            .build())
    return conf


def _pair():
    jconf = _lenet_like()
    jnet = JaxNet(jconf).init()
    port = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu")
    port.load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                          for lp in jnet.net_params])
    port.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                         for s in jnet.net_state])
    return jnet, port


def _images(n=16, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, 1, 10, 10)).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_multilayer_quantized_output_equals_jax(mode):
    jnet, port = _pair()
    x = _images()
    jnet.quantize_inference(mode)
    port.quantize_inference(mode)
    want = np.asarray(jnet.output(x))
    got = port.output(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert port._q_stats == {k: jnet._q_stats[k] for k in port._q_stats}
    codes = [lp["W"]["q"] for lp in port._q_params if "W" in lp]
    want_dtype = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    assert codes and all(c.dtype == want_dtype for c in codes)
    # biases stay float32 tensors, not records
    assert all(isinstance(lp["b"], torch.Tensor)
               for lp in port._q_params if "b" in lp)


def _graph_pair():
    g = jax_network.GlobalConf(seed=5, learning_rate=0.05)
    jconf = (jax_gc.GraphBuilder(g).add_inputs("in")
             .add_layer("d1", jax_layers.DenseLayer(n_in=8, n_out=16,
                                                    activation="tanh"), "in")
             .add_layer("d2", jax_layers.DenseLayer(n_in=8, n_out=16,
                                                    activation="relu"), "in")
             .add_vertex("add", jax_gc.ElementWiseVertex(op="add"),
                         "d1", "d2")
             .add_layer("out", jax_layers.OutputLayer(
                 n_in=16, n_out=3, activation="softmax", loss="mcxent"),
                 "add")
             .set_outputs("out").build())
    jnet = JaxGraph(jconf).init()
    port = ComputationGraph(
        ComputationGraphConfiguration.from_json(jconf.to_json()),
        device="cpu")
    port.load_jax_params({n: {k: np.asarray(v) for k, v in lp.items()}
                          for n, lp in jnet.net_params.items()})
    port.load_jax_state({n: {k: np.asarray(v) for k, v in s.items()}
                         for n, s in jnet.net_state.items()})
    return jnet, port


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_graph_quantized_output_equals_jax(mode):
    jnet, port = _graph_pair()
    x = np.random.default_rng(2).normal(size=(9, 8)).astype(np.float32)
    jnet.quantize_inference(mode)
    port.quantize_inference(mode)
    np.testing.assert_allclose(port.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]),
                               rtol=RTOL, atol=ATOL)


def _trained_wide_net():
    """JAX's int8 agreement net (test_precision.py:283): 8 -> 128 -> 128 ->
    3, Adam, 10 steps on its toy data."""
    jconf = (jax_network.NeuralNetConfiguration.builder()
             .seed(7).learning_rate(0.1).updater("adam").list()
             .layer(jax_layers.DenseLayer(n_in=8, n_out=128,
                                          activation="relu"))
             .layer(jax_layers.DenseLayer(n_out=128, activation="relu"))
             .layer(jax_layers.OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"))
             .build())
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()),
        device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 1] > 0.5)]
    for _ in range(10):
        net.fit(x, y)
    return net, x


@pytest.mark.parametrize("mode, agree_min", [("int8", 0.95), ("fp8", 0.9)])
def test_top1_agreement_and_dense_restore(mode, agree_min):
    net, x = _trained_wide_net()
    dense = net.output(x).numpy()
    net.quantize_inference(mode)
    q = net.output(x).numpy()
    assert np.all(np.isfinite(q))
    agree = (q.argmax(1) == dense.argmax(1)).mean()
    assert agree >= agree_min, agree
    if mode == "int8":
        assert net._q_stats["dense_bytes"] / \
            net._q_stats["quantized_bytes"] > 3.0
        assert float(np.abs(q - dense).max()) < 0.05
    net.quantize_inference(None)
    np.testing.assert_array_equal(net.output(x).numpy(), dense)


def test_requantizes_after_training_and_rejects_unknown_modes():
    net, x = _trained_wide_net()
    net.quantize_inference("int8")
    net.output(x)
    first = net._q_params[0]["W"]["q"].clone()
    rng = np.random.default_rng(4)
    for _ in range(3):
        net.fit(x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)])
    net.output(x)
    assert net._q_iteration == net.iteration
    want = qz.quantize_weight(net.net_params[0]["W"], "int8")["q"]
    assert torch.equal(net._q_params[0]["W"]["q"], want)
    assert not torch.equal(first, want)
    with pytest.raises(ValueError, match="int4"):
        net.quantize_inference("int4")


def test_model_cache_serves_conf_quantization(tmp_path):
    """A zip whose configuration sets ``infer_quant`` is served quantized
    by the cache: codes on the cache's device, output equal to a direct
    quantized output of the same params, the int8 resident bytes over 3x
    smaller than the dense ones."""
    net, x = _trained_wide_net()
    net.conf.global_conf.precision_infer_quant = "int8"
    path = tmp_path / "q.zip"
    ser.write_model(net, path)
    served = ModelCache(device="cpu").get(path)
    assert served._infer_quant == "int8"
    got = served.output(x)
    assert served._q_params[0]["W"]["q"].dtype == torch.int8
    direct = MultiLayerNetwork(net.conf, device="cpu")
    direct.net_params, direct.net_state = net.net_params, net.net_state
    direct.quantize_inference("int8")
    torch.testing.assert_close(got, direct.output(x), rtol=0, atol=0)


def test_quantized_bf16_is_the_dense_bf16_forward_of_dequantized_weights():
    """Under a bf16 policy the expanded float32 weights are cast as the
    policy casts dense weights."""
    net, x = _trained_wide_net()
    net.conf.global_conf.precision = "bfloat16"
    net.quantize_inference("int8")
    q = net.output(x)
    dense = MultiLayerNetwork(net.conf, device="cpu")
    dense.net_params = qz.dequantize_params(net._q_params)
    dense.net_state = net.net_state
    torch.testing.assert_close(q, dense.output(x), rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_gradient_blocks_equal_jax(n):
    g = (np.random.default_rng(n).normal(size=n) * 0.01).astype(np.float32)
    codes, scales = qz.quantize_blocks(g)
    jc, js = jax_qz.quantize_blocks(g)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales, js)
    np.testing.assert_array_equal(qz.dequantize_blocks(codes, scales),
                                  jax_qz.dequantize_blocks(jc, js))
    ef, jef = qz.ErrorFeedback(), jax_qz.ErrorFeedback()
    for _ in range(4):
        comp, c, s = ef.compensate(g)
        jcomp, jc2, js2 = jef.compensate(g)
        np.testing.assert_array_equal(c, jc2)
        ef.commit(comp, c, s)
        jef.commit(jcomp, jc2, js2)
    np.testing.assert_array_equal(ef.residual, jef.residual)
    ef.reset()
    assert ef.residual is None
