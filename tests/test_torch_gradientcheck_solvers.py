"""``nn/gradientcheck.py``, ``nn/solvers.py`` and ``nn/evaluation_tools.py``
of the port against the JAX package's on the CPU.

The gradient checks run, as the JAX package's, in float64 on the CPU (the
port on a float64 clone of the network): on the nets, data, seeds and
subsets of ``tests/test_gradientcheck*.py`` and ``tests/test_pretrain.py``
their verdict is the JAX checks' (pass; recomputed here for the cheaper
half, the rest asserted by those JAX tests on the same nets), and a net
whose backward is wrong on purpose (a layer's gradient doubled) must fail.  The
line-search solvers' scores, iteration by iteration, are held to JAX's
from the same params and data at rtol 1e-4 (each iteration moves the
params along a float32 gradient summed in another order, the rule of
``tests/test_torch_fit.py`` for several updates linear in the gradient),
and so are the params they leave (rtol 1e-4, atol 1e-5).  The ROC chart
HTML is equal string for string.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph_conf as jax_gc
import deeplearning4j_tpu.nn.conf.layers as jax_layers
import deeplearning4j_tpu.nn.conf.layers_pretrain as jax_pre
import deeplearning4j_tpu.nn.conf.network as jax_network
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.fetchers import load_iris
from deeplearning4j_tpu.nn import evaluation as jax_eval
from deeplearning4j_tpu.nn import evaluation_tools as jax_tools
from deeplearning4j_tpu.nn import gradientcheck as jax_check
from deeplearning4j_tpu.nn import solvers as jax_solvers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import evaluation
from deeplearning4j_tpu_torch.nn import evaluation_tools as tools
from deeplearning4j_tpu_torch.nn import gradientcheck as check
from deeplearning4j_tpu_torch.nn import solvers
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import layers_pretrain as P
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

SOLVER_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4, 1e-5

PORT = (network, L, P, InputType)
JAX = (jax_network, jax_layers, jax_pre, JaxInputType)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(build, seed=7, input_type=None, reg=False, lr=0.1, updater=None):
    confs = []
    for net_mod, lay, pre, itype in (JAX, PORT):
        b = net_mod.NeuralNetConfiguration.builder().seed(seed)\
            .learning_rate(lr)
        if updater:
            b = b.updater(updater)
        if reg:
            b = b.regularization(True).l1(0.01).l2(0.02)
        b = b.list()
        for layer in build(lay, pre):
            b = b.layer(layer)
        if input_type is not None:
            b = b.set_input_type(input_type(itype))
        confs.append(b.build())
    jnet = JaxNet(confs[0]).init()
    net = MultiLayerNetwork(confs[1], device="cpu").init()
    net.load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                         for lp in jnet.net_params])
    net.load_jax_state([{k: np.asarray(v) for k, v in s.items()}
                        for s in jnet.net_state])
    return jnet, net


def _labels(rng, shape, classes):
    return np.eye(classes)[rng.integers(0, classes, shape)]


def _mlp(act, loss, out_act):
    return lambda lay, pre: [
        lay.DenseLayer(n_in=4, n_out=6, activation=act),
        lay.OutputLayer(n_in=6, n_out=3, activation=out_act, loss=loss)]


def _cases():
    """The nets, data, seeds and subsets of the JAX package's checks
    (``tests/test_gradientcheck.py``, ``tests/test_pretrain.py``): name ->
    (build, conf kwargs, input type, x, y, subset, mask, JAX's verdict
    here).  Where the last is False the JAX verdict is that JAX test's own
    assertion on this very net (True), not recomputed here."""
    def data(seed=0):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(8, 4)), _labels(rng, 8, 3)
    rng4, rng9, rng5 = (np.random.default_rng(s) for s in (4, 9, 5))
    x_bn, y_bn = rng4.normal(size=(4, 2, 6, 6)), _labels(rng4, 4, 2)
    x_seq, y_seq = rng9.normal(size=(3, 5, 4)), _labels(rng9, (3, 5), 3)
    fmask = np.ones((3, 5))
    fmask[0, 3:] = 0
    fmask[2, 2:] = 0
    x_1d, y_1d = rng5.normal(size=(6, 8, 3)), _labels(rng5, 6, 2)
    rng7 = np.random.default_rng(7)
    x_c, y_c = rng7.normal(size=(8, 4)), _labels(rng7, 8, 3)
    return {
        "mlp_tanh_mcxent_l1_l2": (_mlp("tanh", "mcxent", "softmax"),
                                  dict(seed=3, reg=True), None, *data(1),
                                  None, None, True),
        "mlp_relu_mse": (_mlp("relu", "mse", "identity"), dict(seed=7),
                         None, *data(), None, None, False),
        "mlp_sigmoid_xent": (_mlp("sigmoid", "xent", "sigmoid"),
                             dict(seed=7), None, *data(), None, None,
                             False),
        "cnn_bn_lrn": (lambda lay, pre: [
            lay.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                 activation="identity"),
            lay.BatchNormalization(),
            lay.ActivationLayer(activation="relu"),
            lay.LocalResponseNormalization(),
            lay.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            dict(seed=5), lambda it: it.convolutional(6, 6, 2), x_bn, y_bn,
            48, None, False),
        "lstm_masked": (lambda lay, pre: [
            lay.GravesLSTM(n_in=4, n_out=4, activation="tanh"),
            lay.RnnOutputLayer(n_in=4, n_out=3, activation="softmax",
                               loss="mcxent")], dict(seed=17), None, x_seq,
            y_seq, 48, fmask, False),
        "cnn1d": (lambda lay, pre: [
            pre.Convolution1DLayer(n_in=3, n_out=5, kernel=3,
                                   activation="tanh"),
            pre.Subsampling1DLayer(pooling_type="max", kernel=2, stride=2),
            lay.GlobalPoolingLayer(pooling_type="avg"),
            lay.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            dict(seed=3, lr=0.1, updater="sgd"),
            lambda it: it.recurrent(3, 8), x_1d, y_1d, 64, None, False),
        "center_loss": (lambda lay, pre: [
            lay.DenseLayer(n_in=4, n_out=5, activation="tanh"),
            pre.CenterLossOutputLayer(n_in=5, n_out=3, activation="softmax",
                                      loss="mcxent", lambda_=0.5,
                                      gradient_check=True)],
            dict(seed=42, updater="sgd"), None, x_c, y_c, None, None, True),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_check_gradients_verdict_as_jax(name):
    build, conf, itype, x, y, subset, fmask, jax_here = CASES[name]
    jnet, net = _pair(build, input_type=itype, **conf)
    kw = dict(subset=subset, fmask=fmask, lmask=fmask)
    assert check.check_gradients(net, x, y, **kw)
    if jax_here:
        assert jax_check.check_gradients(jnet, x, y, **kw)
    assert net.net_params[0]["W"].dtype == torch.float32


class _DoubledGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


class _BrokenDense(L.DenseLayer):
    """A dense layer whose backward doubles the gradient it passes."""

    def forward(self, params, state, x, train=False, seed=None, mask=None):
        y, state, mask = super().forward(params, state, x, train, seed, mask)
        return _DoubledGradient.apply(y), state, mask


def test_check_gradients_fails_on_a_broken_backward():
    build = _mlp("tanh", "mcxent", "softmax")
    _, net = _pair(build)
    x, y = CASES["mlp_relu_mse"][3:5]
    assert check.check_gradients(net, x, y, subset=None)
    net.layers[0].__class__ = _BrokenDense
    assert not check.check_gradients(net, x, y, subset=None)


def _graph_pair():
    confs = []
    for mod, lay, g_cls in ((jax_gc, jax_layers, jax_network.GlobalConf),
                            (gc, L, network.GlobalConf)):
        g = g_cls(seed=7, learning_rate=0.05, updater="sgd",
                  use_regularization=True, l1=0.01, l2=0.01)
        confs.append(
            mod.GraphBuilder(g).add_inputs("in")
            .add_layer("d1", lay.DenseLayer(n_in=4, n_out=5,
                                            activation="tanh"), "in")
            .add_layer("d2", lay.DenseLayer(n_in=4, n_out=5,
                                            activation="sigmoid"), "in")
            .add_vertex("merge", mod.MergeVertex(), "d1", "d2")
            .add_layer("out1", lay.OutputLayer(n_in=10, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"), "merge")
            .add_layer("out2", lay.OutputLayer(n_in=5, n_out=2,
                                               activation="identity",
                                               loss="mse"), "d1")
            .set_outputs("out1", "out2").build())
    jnet = JaxGraph(confs[0]).init()
    net = ComputationGraph(confs[1], device="cpu").load_jax_params(
        {n: {k: np.asarray(v) for k, v in lp.items()}
         for n, lp in jnet.net_params.items()})
    return jnet, net


def test_check_computation_graph_gradients_verdict_as_jax():
    jnet, net = _graph_pair()
    rng = np.random.default_rng(13)
    x = rng.normal(size=(6, 4))
    ys = [_labels(rng, 6, 3), rng.normal(size=(6, 2))]
    lms = [None, np.ones((6, 1))]
    assert check.check_computation_graph_gradients(net, [x], ys,
                                                   lmasks=lms, subset=32)
    assert jax_check.check_computation_graph_gradients(jnet, [x], ys,
                                                       lmasks=lms, subset=32)
    net.conf.vertices["d1"].layer_conf().__class__ = _BrokenDense
    assert not check.check_computation_graph_gradients(net, [x], ys,
                                                       subset=32)


def _x(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


PRETRAIN_CASES = {
    # test_pretrain.py's nets, init keys, data and subsets: (make, key, x,
    # subset, JAX's verdict recomputed here)
    "autoencoder": (lambda m: m.AutoEncoder(
        n_in=6, n_out=4, activation="sigmoid", corruption_level=0.3,
        loss="mse"), 1, _x(8, 6), None, True),
    **{f"vae_{d['type']}": (lambda m, d=d: m.VariationalAutoencoder(
        n_in=5, n_out=3, encoder_layer_sizes=(7,), decoder_layer_sizes=(7,),
        activation="tanh", pzx_activation="identity",
        reconstruction_distribution=d, num_samples=1), 2,
        (_x(6, 5, 4) > 0).astype(np.float32) if d["type"] == "bernoulli"
        else _x(6, 5, 4), 48, False)
       for d in ({"type": "gaussian", "activation": "identity"},
                 {"type": "bernoulli"},
                 {"type": "loss", "loss": "mse", "activation": "sigmoid"})},
}


@pytest.mark.parametrize("name", list(PRETRAIN_CASES))
def test_check_pretrain_gradients_verdict_as_jax(name):
    import jax
    make, key, x, subset, jax_here = PRETRAIN_CASES[name]
    layer, jlayer = make(P), make(jax_pre)
    jp, _, _ = jlayer.initialize(jax.random.PRNGKey(key),
                                 JaxInputType.feed_forward(layer.n_in))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert check.check_pretrain_gradients(layer, params, x, subset=subset)
    if jax_here:
        assert jax_check.check_pretrain_gradients(jlayer, jp, x,
                                                  subset=subset)
    assert all(v.dtype == torch.float32 and not v.requires_grad
               for v in params.values())


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

def _iris():
    ds = load_iris()
    x = np.asarray(ds.features, np.float64)
    x = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    return x, np.asarray(ds.labels, np.float32)


def _solver_pair(seed=1):
    return _pair(lambda lay, pre: [
        lay.DenseLayer(n_in=4, n_out=12, activation="tanh"),
        lay.OutputLayer(n_in=12, n_out=3, activation="softmax",
                        loss="mcxent")], seed=seed)


@pytest.mark.parametrize("name", ["LineGradientDescent", "ConjugateGradient",
                                  "LBFGS"])
def test_solver_scores_as_jax(name):
    x, y = _iris()
    jnet, net = _solver_pair()
    jopt = getattr(jax_solvers, name)(max_iterations=8)
    opt = getattr(solvers, name)(max_iterations=8)
    jfinal = jopt.optimize(jnet, JaxDataSet(x, y))
    final = opt.optimize(net, DataSet(x, y))
    assert len(opt.score_history) == len(jopt.score_history)
    np.testing.assert_allclose(opt.score_history, jopt.score_history,
                               rtol=SOLVER_RTOL)
    assert np.isclose(final, jfinal, rtol=SOLVER_RTOL)
    assert abs(net.score(DataSet(x, y)) - final) < 1e-5
    np.testing.assert_allclose(net.params().numpy(), np.asarray(jnet.params()),
                               rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_solver_facade():
    x, y = _iris()
    jnet, net = _solver_pair(seed=3)
    s = solvers.Solver("CONJUGATE_GRADIENT", max_iterations=5).optimize(
        net, DataSet(x, y))
    js = jax_solvers.Solver("CONJUGATE_GRADIENT", max_iterations=5).optimize(
        jnet, JaxDataSet(x, y))
    assert np.isclose(s, js, rtol=SOLVER_RTOL)
    with pytest.raises(ValueError, match="unknown optimization"):
        solvers.Solver("NEWTON")
    s2 = solvers.Solver("STOCHASTIC_GRADIENT_DESCENT",
                        max_iterations=3).optimize(net, DataSet(x, y))
    assert np.isfinite(s2) and net.iteration == 3


# ---------------------------------------------------------------------------
# ROC charts
# ---------------------------------------------------------------------------

def test_roc_chart_html_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 200)]
    probs = rng.dirichlet(np.ones(3), 200).astype(np.float32)
    probs = 0.6 * probs + 0.4 * labels
    binary = np.stack([1 - labels[:, 0], labels[:, 0]], 1)
    pairs = [(evaluation.ROC(50), jax_eval.ROC(50), binary,
              np.stack([1 - probs[:, 0], probs[:, 0]], 1), None),
             (evaluation.ROCMultiClass(40), jax_eval.ROCMultiClass(40),
              labels, probs, ["a", "b", "c"]),
             (evaluation.ROCBinary(30), jax_eval.ROCBinary(30), labels,
              probs, None)]
    for roc, jroc, lab, pred, names in pairs:
        roc.eval(torch.from_numpy(lab), torch.from_numpy(pred))
        jroc.eval(lab, pred)
        assert tools.roc_chart_html(roc, names) == \
            jax_tools.roc_chart_html(jroc, names)
        tools.export_roc_charts_to_html_file(roc, str(tmp_path / "p.html"),
                                             names)
        jax_tools.export_roc_charts_to_html_file(
            jroc, str(tmp_path / "j.html"), names)
        assert (tmp_path / "p.html").read_text() == \
            (tmp_path / "j.html").read_text()
