"""The port's training path (``MultiLayerNetwork.fit``, updaters, losses,
dropout, ``updaterState.bin``) held against the JAX package on the CPU.

Both networks start from the same params, drawn with numpy, and take the
same batches.  Where the JAX step runs the Pallas dropout and xent kernels
(``DL4J_PALLAS_DROPOUT=1`` / ``DL4J_PALLAS_XENT=1``, interpret mode), the
port gets the seed words JAX derives for each layer and step —
``_dropout_seed(fold_in(sub, i))`` with ``sub`` the step's split of the
network key — so both draw the same dropout masks.

Tolerances, float32 on both sides with sums in other orders:
* one updater rule, LR schedule or gradient normalization: rtol 1e-5,
  atol 1e-6 — the same elementwise float32 arithmetic;
* gradients and scores: rtol 1e-4 (atol 1e-6 for gradients) — each sums
  thousands of products in another order;
* params after several ``fit`` steps: rtol 1e-4, atol 1e-5 for every
  element under SGD and Nesterovs, whose updates are linear in the
  gradient.  Under Adam at least 99.5 % of each tensor's elements meet
  that, and every element is within 5e-3, half of one step of size
  lr = 0.01: Adam divides a gradient by its own running magnitude, so a
  gradient that is float32 rounding noise (a sum of 16 products that
  cancel; LeNet has a few such among its 431,080) becomes an update of up
  to lr in either framework, and a relu unit sitting at its threshold then
  turns with it.  The score of such a step moves with that unit: on these
  random batches LeNet's loss climbs to ~200 within 3 steps, and the two
  scores agree to 1.2e-4 relative, so the Adam scores are held at 1e-3.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import vgg as jax_vgg
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import serialization as jax_ser
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.ops import updaters as jax_upd
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import lenet, vgg16
from deeplearning4j_tpu_torch.nn import convert
from deeplearning4j_tpu_torch.nn import serialization as ser
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.ops import updaters as upd

RULE_RTOL, RULE_ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
ADAM_INSIDE, ADAM_ATOL, ADAM_SCORE_RTOL = 0.995, 5e-3, 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread: on a loaded host its
    multi-threaded float32 reductions have been seen to differ from run
    to run by more than these tolerances allow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drop_net_conf(layers, net, input_type, updater="nesterovs"):
    """VGG16's recipe narrowed so both kernel gates fire: two 3x3 pad-1
    relu convs (3→4→8 channels) on 8x8 inputs, a 2x2 max pool, a dense
    layer of 64 that drops its [256, 128] input at retain 0.5, and a
    256-class softmax output at batch 256 (rows·vocab = 65,536)."""
    b = (net.NeuralNetConfiguration.builder().seed(11).learning_rate(0.01)
         .updater(updater).weight_init("relu").list())
    for ch in (4, 8):
        b.layer(layers.ConvolutionLayer(n_out=ch, kernel=(3, 3),
                                        stride=(1, 1), padding=(1, 1),
                                        activation="relu"))
    b.layer(layers.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                    stride=(2, 2)))
    b.layer(layers.DenseLayer(n_out=64, activation="relu", dropout=0.5))
    b.layer(layers.OutputLayer(n_out=256, activation="softmax",
                               loss="mcxent"))
    return b.set_input_type(input_type.convolutional(8, 8, 3)).build()


def _numpy_params(net, seed):
    """Params drawn with numpy for the shapes of a port network."""
    rng = np.random.default_rng(seed)
    out = []
    for lp in net.net_params:
        out.append({k: (rng.normal(size=tuple(v.shape)) * (
            np.sqrt(2.0 / np.prod(v.shape[1:] if v.ndim == 4 else
                                  v.shape[:1])) if k == "W" else 0.1)
        ).astype(np.float32) for k, v in lp.items()})
    return out


def _pair(port_conf, jax_conf, seed=1):
    """A port network on the CPU and a JAX network with the same params."""
    net = MultiLayerNetwork(port_conf, device="cpu").init()
    params = _numpy_params(net, seed)
    net.load_jax_params(params)
    jnet = JaxNet(jax_conf).init(
        params=[{k: jnp.asarray(v) for k, v in lp.items()} for lp in params])
    return net, jnet


def _batches(n, batch, dims, classes, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch,) + dims).astype(np.float32),
             np.eye(classes, dtype=np.float32)[
                 rng.integers(0, classes, batch)]) for _ in range(n)]


def _assert_params_close(net, jnet, inside=1.0, outer_atol=None):
    """Every param within FIT_RTOL / FIT_ATOL of JAX's; with ``inside``
    below 1, that share of each tensor's elements, and all of them within
    ``outer_atol``."""
    for i, (lp, jp) in enumerate(zip(net.net_params, jnet.net_params)):
        for k in jp:
            got, want = lp[k].detach().numpy(), np.asarray(jp[k])
            msg = f"layer {i} param {k}"
            if inside == 1.0:
                np.testing.assert_allclose(got, want, rtol=FIT_RTOL,
                                           atol=FIT_ATOL, err_msg=msg)
                continue
            ok = np.abs(got - want) <= FIT_ATOL + FIT_RTOL * np.abs(want)
            assert ok.mean() >= inside, (msg, ok.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=outer_atol,
                                       err_msg=msg)


def _jax_step_seeds(jnet):
    """The per-layer dropout seed words of JAX's next step."""
    _, sub = jax.random.split(jnet._key)
    return np.stack([np.asarray(pk._dropout_seed(jax.random.fold_in(sub, i))
                                ).reshape(-1)
                     for i in range(len(jnet.layers))])


def test_lenet_adam_fit_matches_jax():
    """(a) LeNet + Adam, the BASELINE recipe: the first step's gradients,
    then 4 steps from loaded params on the same batches, with the score
    after every step and the params after the last."""
    net, jnet = _pair(lenet(seed=3, device="cpu").conf, jax_lenet(seed=3).conf)
    batches = _batches(4, 16, (1, 28, 28), 10)
    x, y = batches[0]
    _, _, jgrads = jnet._build_grad_raw()(
        jnet.net_params, jnet.net_state, jnp.asarray(x), jnp.asarray(y),
        None, None, jax.random.PRNGKey(0))
    _, grads = net._grad_step(torch.from_numpy(x), torch.from_numpy(y),
                              None, None, None)
    for gl, jl in zip(grads, jgrads):
        assert sorted(gl) == sorted(jl)
        for k in jl:
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(jl[k]),
                                       rtol=FIT_RTOL, atol=1e-6)
    for x, y in batches:
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=ADAM_SCORE_RTOL)
    _assert_params_close(net, jnet, ADAM_INSIDE, ADAM_ATOL)
    assert net.iteration == jnet.iteration == 4


def test_dropout_xent_net_fit_matches_jax(monkeypatch):
    """(b) Nesterovs, 3 steps, with JAX's dropout and xent kernels forced
    and its seed words handed to the port: both gates fire in both."""
    monkeypatch.setenv("DL4J_PALLAS_DROPOUT", "1")
    monkeypatch.setenv("DL4J_PALLAS_XENT", "1")
    net, jnet = _pair(_drop_net_conf(L, network, InputType),
                      _drop_net_conf(jax_layers, jax_network, JaxInputType))
    launches = (ck.fused_softmax_xent.launches,
                ck.fused_threshold_dropout.launches)
    for x, y in _batches(3, 256, (3, 8, 8), 256, seed=5):
        seeds = _jax_step_seeds(jnet)
        jnet.fit(x, y)
        net._fit_batch(DataSet(x, y), seeds=seeds)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=FIT_RTOL)
    _assert_params_close(net, jnet)
    # the CPU ran the plain versions: no kernel launch was counted
    assert (ck.fused_softmax_xent.launches,
            ck.fused_threshold_dropout.launches) == launches


def test_dropout_is_on_in_training_only():
    """The dropout layer changes the training loss and not ``output``;
    ``fit`` draws each step's words from the network's own generator, so
    two networks from one configuration train alike."""
    conf = _drop_net_conf(L, network, InputType)
    (x, y), = _batches(1, 256, (3, 8, 8), 256, seed=2)
    nets = [MultiLayerNetwork(conf, device="cpu").init() for _ in range(2)]
    out = nets[0].output(x)
    seeds = nets[0]._draw_seeds()
    assert seeds.shape == (len(conf.layers), 2)
    assert int(seeds.min()) >= 0 and int(seeds.max()) < 1 << 32
    nets[0]._generator.manual_seed(conf.global_conf.seed)
    for n in nets:
        n.fit(x, y)
    assert torch.equal(nets[0].params(), nets[1].params())
    assert torch.equal(out, nets[1].output(x)) is False
    a, b = MultiLayerNetwork(conf, device="cpu").init(), \
        MultiLayerNetwork(conf, device="cpu").init()
    a._fit_batch(DataSet(x, y), seeds=np.zeros((len(conf.layers), 2)))
    b._fit_batch(DataSet(x, y), seeds=np.ones((len(conf.layers), 2)))
    assert a.score() != b.score()


def test_every_param_gets_a_gradient_through_the_conv_autograd_wrapper(
        monkeypatch):
    """(c) The conv kernel writes into a fresh tensor, so its output has
    no autograd history of its own.  ``_ConvBiasAct`` gives it one: here
    the launch is stood in for by the plain version under ``no_grad`` (a
    result without history, like the kernel's) and every param's gradient
    must be non-zero and equal to the dense path's."""
    conf = _drop_net_conf(L, network, InputType)
    (x, y), = _batches(1, 256, (3, 8, 8), 256, seed=3)
    seeds = np.arange(2 * len(conf.layers)).reshape(-1, 2)

    def grads_of(net):
        _, grads = net._grad_step(torch.from_numpy(x), torch.from_numpy(y),
                                  None, None, seeds.tolist())
        return grads

    dense = MultiLayerNetwork(conf, device="cpu").init()
    want = grads_of(dense)

    def stand_in_launch(x, w, b, pad, border_mode, act):
        with torch.no_grad():
            return ck.conv2d_bias_act_reference(x, w, b, pad, border_mode,
                                                act)

    def through_wrapper(x, w, b, stride, pad, dilation, border_mode, act):
        return ck._ConvBiasAct.apply(x, w, b, tuple(pad), border_mode, act)

    monkeypatch.setattr(ck, "_launch_conv", stand_in_launch)
    monkeypatch.setattr(helpers, "conv2d_bias_act", through_wrapper)
    net = MultiLayerNetwork(conf, device="cpu").init()
    got = grads_of(net)
    for i, (gl, wl) in enumerate(zip(got, want)):
        assert sorted(gl) == sorted(wl)
        for k in wl:
            assert float(gl[k].abs().max()) > 0, f"layer {i} {k}"
            torch.testing.assert_close(gl[k], wl[k], rtol=1e-5, atol=1e-6)


def test_updater_state_zip_round_trip_and_next_step(tmp_path):
    """(d) JAX fits LeNet with Adam and writes the zip; the port restores
    it — params and updater state — rewrites it byte for byte, and its
    next step matches JAX's.  Neither zip holds the iteration count,
    which Adam's bias correction reads, so the port is handed JAX's."""
    jnet = JaxNet(jax_lenet(seed=3).conf).init()
    batches = _batches(3, 8, (1, 28, 28), 10, seed=7)
    for x, y in batches[:2]:
        jnet.fit(x, y)
    jax_ser.write_model(jnet, tmp_path / "jax.zip")
    net = ser.restore_multi_layer_network(tmp_path / "jax.zip", device="cpu")
    ser.write_model(net, tmp_path / "port.zip")
    with zipfile.ZipFile(tmp_path / "jax.zip") as a, \
            zipfile.ZipFile(tmp_path / "port.zip") as b:
        for name in (ser.COEFFICIENTS_NAME, ser.UPDATER_NAME):
            assert a.read(name) == b.read(name)
        assert len(b.read(ser.UPDATER_NAME)) == 2 * 4 * net.num_params()
    flat = np.asarray(jnet.updater_state_flat())
    np.testing.assert_array_equal(net.updater_state_flat().numpy(), flat)
    net.iteration = jnet.iteration
    x, y = batches[2]
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(net.score(), float(jnet.score()),
                               rtol=FIT_RTOL)
    _assert_params_close(net, jnet, ADAM_INSIDE, ADAM_ATOL)


def test_opt_states_from_jax_and_serving_loads_no_updater(tmp_path):
    jnet = JaxNet(_drop_net_conf(jax_layers, jax_network,
                                 JaxInputType)).init()
    net = MultiLayerNetwork(_drop_net_conf(L, network, InputType),
                            device="cpu")
    net.load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                         for lp in jnet.net_params])
    net.opt_states = convert.opt_states_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.opt_states), device="cpu")
    np.testing.assert_array_equal(net.updater_state_flat().numpy(),
                                  np.asarray(jnet.updater_state_flat()))
    assert net.opt_states[2] == {"v": {}}
    jax_ser.write_model(jnet, tmp_path / "m.zip")
    assert ser.load_model(tmp_path / "m.zip", device="cpu",
                          load_updater=False).opt_states is None
    fresh = MultiLayerNetwork(net.conf, device="cpu").init()
    ser.write_model(fresh, tmp_path / "fresh.zip")   # never trained
    with zipfile.ZipFile(tmp_path / "fresh.zip") as zf:
        assert ser.UPDATER_NAME not in zf.namelist()
    with pytest.raises(ValueError, match="mismatch"):
        net.set_updater_state_flat(np.zeros(3, np.float32))


def test_fit_iterator_epochs_and_score_match_jax():
    """``fit(iterator, epochs=2)`` is one step per batch per epoch, and
    ``score(DataSet)`` (inference forward) agrees with JAX's."""
    net, jnet = _pair(lenet(seed=3, updater="sgd", device="cpu").conf,
                      jax_lenet(seed=3, updater="sgd").conf, seed=4)
    data = _batches(2, 8, (1, 28, 28), 10, seed=9)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]), epochs=2)
    for _ in range(2):
        for x, y in data:
            jnet.fit(x, y)
    assert net.iteration == 4 and net.epoch == 2
    _assert_params_close(net, jnet)
    x, y = data[0]
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=FIT_RTOL)
    with pytest.raises(TypeError, match="DataSetIterator"):
        net.fit([x])


def _global(b):
    return (b.seed(1).learning_rate(0.05).updater("nesterovs").momentum(0.8)
            .regularization(True).l2(1e-3).l1(1e-4)
            .gradient_normalization("ClipL2PerLayer", 0.5).mini_batch(False)
            .iterations(2))


@pytest.mark.parametrize("flavour", ["reg_clip_sum_iter2", "bias_lr"])
def test_fit_options_match_jax(flavour):
    """l1/l2 on weights, per-layer gradient clipping, summed (not mean)
    score, two iterations per batch, and a bias learning rate."""
    def conf(layers, net, _):
        b = net.NeuralNetConfiguration.builder()
        b = _global(b) if flavour != "bias_lr" else (
            b.seed(1).learning_rate(0.1).bias_learning_rate(0.5)
            .updater("sgd"))
        return (b.list()
                .layer(layers.DenseLayer(n_in=12, n_out=16,
                                         activation="tanh"))
                .layer(layers.OutputLayer(n_out=5, activation="softmax",
                                          loss="mcxent"))
                .build())
    net, jnet = _pair(conf(L, network, InputType),
                      conf(jax_layers, jax_network, JaxInputType), seed=8)
    for x, y in _batches(3, 10, (12,), 5, seed=1):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=FIT_RTOL)
    _assert_params_close(net, jnet)
    assert net.iteration == jnet.iteration


@pytest.mark.parametrize("rule", ["sgd", "none", "nesterovs", "adagrad",
                                  "rmsprop", "adadelta", "adam", "adamax"])
def test_updater_rule_matches_jax(rule):
    rng = np.random.default_rng(len(rule))
    shapes = {"W": (5, 7), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    ju = jax_upd.make(rule, epsilon=1e-6) if rule != "nesterovs" \
        else jax_upd.make(rule, momentum=0.8)
    tu = upd.make(rule, **ju.hyper)
    js = ju.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = tu.init({k: torch.from_numpy(v) for k, v in params.items()})
    for t in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jd, js = ju.apply({k: jnp.asarray(v) for k, v in g.items()}, js,
                          jnp.float32(0.01), t)
        td, ts = tu.apply({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                          0.01, t)
        for k in shapes:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=RULE_RTOL, atol=RULE_ATOL)


@pytest.mark.parametrize("policy,kw", [
    (None, {}), ("exponential", {"decay_rate": 0.9}),
    ("inverse", {"decay_rate": 0.1, "power": 0.75}),
    ("poly", {"steps": 50.0, "power": 2.0}),
    ("sigmoid", {"decay_rate": 0.2, "steps": 10.0}),
    ("step", {"decay_rate": 0.5, "steps": 3.0}),
    ("schedule", {"schedule_map": {"0": 0.1, "4": 0.05, "9": 0.01}})])
def test_schedule_lr_matches_jax(policy, kw):
    for it in (0, 1, 4, 7, 12):
        want = float(jax_upd.schedule_lr(0.1, policy, it, **kw))
        assert upd.schedule_lr(0.1, policy, it, **kw) == pytest.approx(
            want, rel=RULE_RTOL)


@pytest.mark.parametrize("mode", [
    None, "RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
    "ClipElementWiseAbsoluteValue", "ClipL2PerLayer", "ClipL2PerParamType"])
def test_gradient_normalization_matches_jax(mode):
    rng = np.random.default_rng(3)
    g = {"W": rng.normal(size=(4, 6)).astype(np.float32),
         "b": rng.normal(size=(6,)).astype(np.float32)}
    want = jax_upd.normalize_gradient(
        {k: jnp.asarray(v) for k, v in g.items()}, mode, 0.5)
    got = upd.normalize_gradient({k: torch.from_numpy(v)
                                  for k, v in g.items()}, mode, 0.5)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RULE_RTOL, atol=RULE_ATOL)


def test_vgg16_with_dropout_builds_the_jax_configuration():
    got = json.loads(vgg16(dropout=0.5, device="cpu").conf.to_json())
    assert got == json.loads(jax_vgg.vgg16(dropout=0.5).conf.to_json())
    dropped = [l["@class"] for l in got["layers"] if l["dropout"] == 0.5]
    assert dropped == ["DenseLayer", "DenseLayer"]
