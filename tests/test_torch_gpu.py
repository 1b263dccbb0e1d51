"""Tests of the port that need the CUDA device (marker ``gpu``); they skip
without one.  This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances against the plain versions: conv rtol 1e-4, atol 1e-5
(float32 sums in different orders; TF32 off for the plain version); xent,
the LSTM step and the flash kernels rtol = atol = 1e-5 (the JAX suite's
for its fused kernels, tighter than its flash suite's); dropout bit for
bit.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models import (attention_lm, char_rnn, lenet,
                                             vgg16_cifar10)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf import network
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

# the shape / pad / mode grid of the JAX package's fused-conv parity test
CONV_GRID = [
    ((2, 3, 10, 10), (3, 3), (0, 0), "truncate"),
    ((2, 3, 10, 10), (3, 3), (1, 1), "truncate"),
    ((1, 1, 28, 28), (5, 5), (0, 0), "truncate"),
    ((2, 4, 9, 7), (3, 3), (0, 0), "same"),
    ((2, 2, 8, 8), (2, 2), (0, 0), "same"),
]


@pytest.fixture
def cuda_device():
    """The CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(shape, kernel, device, seed=11, cout=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(cout, shape[1]) + kernel) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.mark.gpu
def test_wrapper_raises_on_cuda_when_the_library_is_missing(
        cuda_device, monkeypatch, tmp_path):
    missing = ck.KernelLibrary(tmp_path / "absent.cu",
                               {"dl4j_conv2d_bias_act_f32": ([], None)})
    monkeypatch.setattr(ck, "CONV_LIBRARY", missing)
    x = torch.zeros((1, 2, 6, 6), device=cuda_device)
    w = torch.zeros((3, 2, 3, 3), device=cuda_device)
    b = torch.zeros((3,), device=cuda_device)
    launches = ck.fused_conv2d_bias_act.launches
    with pytest.raises(FileNotFoundError):
        ck.fused_conv2d_bias_act(x, w, b)
    assert ck.fused_conv2d_bias_act.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("act", sorted(ck.CONV_FUSED_ACTS))
def test_kernel_matches_plain_version_on_the_card(cuda_device, act):
    for shape, kernel, pad, mode in CONV_GRID:
        x, w, b = _conv_inputs(shape, kernel, cuda_device)
        launches = ck.fused_conv2d_bias_act.launches
        y = ck.fused_conv2d_bias_act(x, w, b, pad=pad, border_mode=mode,
                                     activation=act)
        ref = ck.conv2d_bias_act_reference(x, w, b, pad, mode, act)
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-5)
        assert ck.fused_conv2d_bias_act.launches == launches + 1


@pytest.mark.gpu
def test_models_on_the_card_match_the_cpu(cuda_device):
    """LeNet and VGG16-CIFAR10 with the same weights on the card (conv
    kernel) and on the CPU (plain version)."""
    for make, dims in ((lenet, (1, 28, 28)), (vgg16_cifar10, (3, 32, 32))):
        gpu = make(device=cuda_device).init()
        cpu = make(device="cpu").init()
        x = np.random.default_rng(0).normal(size=(3,) + dims).astype(
            np.float32)
        launches = ck.fused_conv2d_bias_act.launches
        got = gpu.output(x).cpu()
        n_convs = sum(type(l).__name__ == "ConvolutionLayer"
                      for l in gpu.layers)
        assert ck.fused_conv2d_bias_act.launches == launches + n_convs
        torch.testing.assert_close(got, cpu.output(x), rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("N,V", [(128, 1000), (256, 512), (997, 130),
                                 (3, 50257)])
def test_xent_kernel_matches_plain_version_on_the_card(cuda_device, N, V):
    rng = np.random.default_rng(N)
    x = torch.from_numpy((rng.normal(size=(N, V)) * 3).astype(np.float32))
    y = torch.from_numpy(rng.random(size=(N, V)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    x, y, g = x.to(cuda_device), y.to(cuda_device), g.to(cuda_device)
    launches = ck.fused_softmax_xent.launches
    xr = x.clone().requires_grad_()
    loss = ck.softmax_xent_rows(xr, y)
    loss.backward(g)
    assert ck.fused_softmax_xent.launches == launches + 1
    ref_loss, ref_grad = ck.softmax_xent_reference(x, y)
    torch.testing.assert_close(loss.detach(), ref_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xr.grad, ref_grad * g[:, None], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096), (3, 4099), (4097,)])
@pytest.mark.parametrize("rate", [0.5, 0.8])
def test_dropout_kernel_is_bit_identical_on_the_card(cuda_device, shape,
                                                     rate):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device)
    seed = (2654435761, 12345)
    launches = ck.fused_threshold_dropout.launches
    xr = x.clone().requires_grad_()
    y = ck.fused_threshold_dropout(xr, rate, seed)
    y.backward(g)
    assert ck.fused_threshold_dropout.launches == launches + 2
    assert torch.equal(y, ck.threshold_dropout_reference(x, rate, seed))
    assert torch.equal(xr.grad, ck.threshold_dropout_reference(g, rate, seed))
    cpu = ck.threshold_dropout_reference(x.cpu(), rate, seed)
    assert torch.equal(y.cpu(), cpu)


@pytest.mark.gpu
def test_conv_backward_runs_in_f32_and_restores_tf32(cuda_device):
    """With cuDNN allowed TF32 (PyTorch's default) the conv kernel's
    gradients still equal the plain conv's in full f32."""
    x, w, b = _conv_inputs((4, 8, 16, 16), (3, 3), cuda_device, cout=16)
    torch.backends.cudnn.allow_tf32 = True
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = ck.fused_conv2d_bias_act(*leaves, pad=(1, 1), activation="relu")
    assert y.grad_fn is not None
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, g)
    assert torch.backends.cudnn.allow_tf32
    with ck.full_f32_convs():
        ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ref = ck.conv2d_bias_act_reference(*ref_leaves, (1, 1), "truncate",
                                           "relu")
        want = torch.autograd.grad(ref, ref_leaves, g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)


def _small_drop_net(device):
    b = (network.NeuralNetConfiguration.builder().seed(11)
         .learning_rate(0.01).updater("nesterovs").weight_init("relu").list())
    for ch in (4, 8):
        b.layer(L.ConvolutionLayer(n_out=ch, kernel=(3, 3), padding=(1, 1),
                                   activation="relu"))
    b.layer(L.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                               stride=(2, 2)))
    b.layer(L.DenseLayer(n_out=64, activation="relu", dropout=0.5))
    b.layer(L.OutputLayer(n_out=256, activation="softmax", loss="mcxent"))
    conf = b.set_input_type(InputType.convolutional(8, 8, 3)).build()
    return MultiLayerNetwork(conf, device=device).init(
        generator=torch.Generator().manual_seed(3))


@pytest.mark.gpu
def test_fit_on_the_card_matches_the_cpu(cuda_device):
    """Two Nesterovs steps of the small dropout net on the card (conv, xent
    and dropout kernels) and on the CPU (plain versions), same params and
    seed words."""
    gpu, cpu = _small_drop_net(cuda_device), _small_drop_net("cpu")
    rng = np.random.default_rng(0)
    before = (ck.fused_conv2d_bias_act.launches,
              ck.fused_softmax_xent.launches,
              ck.fused_threshold_dropout.launches)
    for _ in range(2):
        ds = DataSet(rng.normal(size=(256, 3, 8, 8)).astype(np.float32),
                     np.eye(256, dtype=np.float32)[rng.integers(0, 256, 256)])
        seeds = rng.integers(0, 1 << 32, size=(5, 2))
        gpu._fit_batch(ds, seeds=seeds)
        cpu._fit_batch(ds, seeds=seeds)
        np.testing.assert_allclose(gpu.score(), cpu.score(), rtol=1e-4)
    after = (ck.fused_conv2d_bias_act.launches,
             ck.fused_softmax_xent.launches,
             ck.fused_threshold_dropout.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 4]
    torch.testing.assert_close(gpu.params().cpu(), cpu.params(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("N,H", [(32, 200), (1, 200), (4, 200), (5, 24)])
def test_lstm_kernel_matches_plain_version_on_the_card(cuda_device, N, H):
    """One step, forward and the gradients of all five inputs, with zx a
    time step of a [N, T, 4H] tensor (a row-strided view) as in
    ``lstm_scan``."""
    rng = np.random.default_rng(N * 1000 + H)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device)
    zx = t(N, 3, 4 * H)[:, 1]
    args = [zx, t(N, H), t(N, H), t(H, 4 * H, scale=0.1), t(3, H, scale=0.1)]
    g_c, g_h = t(N, H), t(N, H)
    launches = ck.fused_lstm_step.launches
    leaves = [a.clone().requires_grad_() for a in args]
    c_new, h_new = ck.fused_lstm_step(*leaves)
    assert ck.fused_lstm_step.launches == launches + 1
    grads = torch.autograd.grad((c_new * g_c).sum() + (h_new * g_h).sum(),
                                leaves)
    ref_leaves = [a.clone().requires_grad_() for a in args]
    ref_c, ref_h = ck.lstm_step_reference(*ref_leaves)
    want = torch.autograd.grad((ref_c * g_c).sum() + (ref_h * g_h).sum(),
                               ref_leaves)
    torch.testing.assert_close(c_new, ref_c, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_new, ref_h, rtol=1e-5, atol=1e-5)
    for a, e in zip(grads, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)
    assert ck.fused_lstm_step.launches == launches + 1


@pytest.mark.gpu
def test_char_rnn_on_the_card_matches_the_cpu(cuda_device):
    """One TBPTT minibatch of a small char-RNN on the card (one lstm launch
    per layer and time step) and on the CPU (plain step), then
    ``rnn_time_step``: two launches per call, outputs as on the CPU."""
    V, T = 12, 20
    nets = [char_rnn(V, hidden=16, tbptt_length=5, device=d).init()
            for d in (cuda_device, "cpu")]
    start = nets[1].params().clone()
    rng = np.random.default_rng(1)
    eye = np.eye(V, dtype=np.float32)
    x = eye[rng.integers(0, V, (4, T))]
    y = eye[rng.integers(0, V, (4, T))]
    launches = ck.fused_lstm_step.launches
    for net in nets:
        net.fit(x, y)
    assert ck.fused_lstm_step.launches == launches + 2 * T
    np.testing.assert_allclose(nets[0].score(), nets[1].score(), rtol=1e-4)
    # RMSProp's updates, relative to how far they moved the params (the
    # rule of tests/test_torch_charrnn.py)
    moved = torch.linalg.vector_norm(nets[1].params() - start)
    assert float(torch.linalg.vector_norm(
        nets[0].params().cpu() - nets[1].params()) / moved) <= 1e-2
    nets[0].set_params(nets[1].params())
    launches = ck.fused_lstm_step.launches
    outs = []
    for net in nets:
        net.rnn_clear_previous_state()
        outs.append([net.rnn_time_step(x[:, t:t + 1]).cpu()
                     for t in range(3)])
    assert ck.fused_lstm_step.launches == launches + 2 * 3
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


FLASH_CASES = [
    (2, 2, 200, 64, False, "tail"), (2, 2, 200, 64, True, "tail"),
    (1, 3, 130, 32, True, "none"), (2, 2, 256, 96, True, "none"),
    (1, 2, 256, 128, False, "none"), (2, 2, 256, 64, True, "dead_row"),
    (2, 1, 320, 32, False, "dead_row"),
]


def _flash_inputs(B, H, T, D, mask, device):
    rng = np.random.default_rng(B * 10_000 + T * 10 + D)
    q, k, v, g = (torch.from_numpy(
        (rng.normal(size=(B, H, T, D)) * 0.5).astype(np.float32)).to(device)
        for _ in range(4))
    km = torch.ones((B, T), device=device)
    if mask == "tail":
        km[:, 180:] = 0.0
    elif mask == "dead_row":
        km[-1] = 0.0
    return q, k, v, g, km


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,causal,mask", FLASH_CASES)
def test_flash_kernels_match_plain_versions_on_the_card(cuda_device, B, H,
                                                        T, D, causal, mask):
    """Each of the three kernels against its plain version on the same
    inputs (the plain lse and delta feed both backward kernels): ragged T,
    key masks, a fully masked batch row (out 0, lse -1e30), causal and
    not, head dims 32 to 128."""
    q, k, v, g, km = _flash_inputs(B, H, T, D, mask, cuda_device)
    s = D ** -0.5
    before = (ck.flash_forward.launches, ck.flash_dq.launches,
              ck.flash_dkv.launches)
    out, lse = ck.flash_forward(q, k, v, km, causal, s)
    rout, rlse = ck.flash_forward_reference(q, k, v, km, causal, s)
    delta = (g * rout).sum(-1)
    dq = ck.flash_dq(q, k, v, km, g, rlse, delta, causal, s)
    dk, dv = ck.flash_dkv(q, k, v, km, g, rlse, delta, causal, s)
    assert (ck.flash_forward.launches, ck.flash_dq.launches,
            ck.flash_dkv.launches) == tuple(b + 1 for b in before)
    want = (rout, rlse,
            ck.flash_dq_reference(q, k, v, km, g, rlse, delta, causal, s),
            *ck.flash_dkv_reference(q, k, v, km, g, rlse, delta, causal, s))
    for got, ref in zip((out, lse, dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if mask == "dead_row":
        assert bool((out[-1] == 0).all()) and bool((lse[-1] == -1e30).all())
        assert bool((dk[-1] == 0).all()) and bool((dv[-1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradients_on_the_card_match_the_cpu(cuda_device,
                                                             causal):
    """``flash_attention`` through autograd: the kernels on the card, the
    plain versions on the CPU, one Function for both."""
    q, k, v, g, km = _flash_inputs(2, 2, 200, 64, "tail", "cpu")
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = ck.flash_attention(*leaves, km.to(dev), causal)
        (out * g.to(dev)).sum().backward()
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_attention_fit_step_launch_counts_on_the_card(cuda_device):
    """One ``fit`` step of a small attention LM on the card launches one
    forward, one dQ and one dK/dV kernel per attention layer and nothing
    else, and scores as the CPU does; ``output()`` launches one forward
    per layer; ``rnn_time_step`` (the KV ring) launches none."""
    V, T = 12, 256
    nets = [attention_lm(V, 64, 2, 2, T, learning_rate=0.01,
                         device=d).init() for d in (cuda_device, "cpu")]
    rng = np.random.default_rng(2)
    eye = np.eye(V, dtype=np.float32)
    x = eye[rng.integers(0, V, (2, T))]
    y = eye[rng.integers(0, V, (2, T))]
    names = ("fused_conv2d_bias_act", "fused_softmax_xent",
             "fused_threshold_dropout", "fused_lstm_step", "flash_forward",
             "flash_dq", "flash_dkv")

    def counts():
        return [getattr(ck, n).launches for n in names]
    before = counts()
    nets[0].fit(x, y)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 0, 2, 2, 2]
    nets[1].fit(x, y)
    np.testing.assert_allclose(nets[0].score(), nets[1].score(), rtol=1e-4)
    nets[0].set_params(nets[1].params())
    before = counts()
    got = nets[0].output(x).cpu()
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 0, 0, 2, 0, 0]
    torch.testing.assert_close(got, nets[1].output(x), rtol=1e-5, atol=1e-5)
    before = counts()
    steps = torch.cat([nets[0].rnn_time_step(x[:, t:t + 1]).cpu()
                       for t in range(8)], dim=1)
    assert counts() == before
    torch.testing.assert_close(steps, got[:, :8], rtol=1e-5, atol=1e-5)
