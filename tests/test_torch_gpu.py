"""Tests of the port that need the CUDA device (marker ``gpu``); they skip
without one.  This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerances against the plain versions: conv rtol 1e-4, atol 1e-5
(float32 sums in different orders; TF32 off for the plain version); xent,
the LSTM step and the flash kernels rtol = atol = 1e-5 (the JAX suite's
for its fused kernels, tighter than its flash suite's); dropout bit for
bit.  The word2vec steps and a small Word2Vec fit, card against CPU:
chip_smoke.py's W2V_STEP_RTOL and W2V_FIT_RTOL (relative 2-norms; the
card's ``index_add_`` adds duplicate rows in no fixed order).  The text
CNN's step and k-means from the same centres, card against CPU, rtol
1e-4 / 1e-5; t-SNE's P by 1e-5 + 1e-4 |P| and its loop by chip_smoke.py's
TSNE_LOOP_RTOL (tests/test_torch_clustering.py says why).
"""

import contextlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator, DataSet, ListDataSetIterator, iterators)
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


# Shapes where the conv kernel's plan branches: (x shape, w shape, pad).
CONV_BRANCHES = {
    "cin1_k25_cout20": ((2, 1, 28, 28), (20, 1, 5, 5), 0),
    "lenet_cout50_cluster": ((4, 20, 12, 12), (50, 20, 5, 5), 0),
    "map2x2_batch1": ((1, 512, 2, 2), (512, 512, 3, 3), 1),
    "map2x2_batch32": ((32, 512, 2, 2), (512, 512, 3, 3), 1),
    "map4x4_batch1": ((1, 256, 4, 4), (512, 256, 3, 3), 1),
    "map4x4_batch32": ((32, 512, 4, 4), (512, 512, 3, 3), 1),
    "k7": ((2, 5, 13, 11), (8, 5, 7, 7), 3),
    "odd_hw": ((3, 16, 15, 9), (70, 16, 3, 3), 1),
    "k1_32_channels_a_slice": ((2, 40, 3, 3), (10, 40, 1, 1), 0),
    "vgg16_224_first": ((2, 3, 224, 224), (64, 3, 3, 3), 1),
}


def _he_inputs(x_shape, w_shape, device, seed=5):
    """x ~ N(0, 1), He-scaled weights, bias ~ N(0, 0.01): the magnitudes of
    chip_smoke.py's conv checks."""
    rng = np.random.default_rng(seed)
    fan_in = w_shape[1] * w_shape[2] * w_shape[3]
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    b = (rng.normal(size=w_shape[0]) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


def _assert_conv_close(y, ref):
    """chip_smoke.py's conv rule: |y - ref| <= 1e-5 max|ref| + 1e-4 |ref|
    (f32 sums of up to 4,608 products in different orders)."""
    allow = 1e-5 * ref.abs().max() + 1e-4 * ref.abs()
    excess = float(((y - ref).abs() / allow).max())
    assert excess <= 1.0 and bool(torch.isfinite(y).all()), excess


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_BRANCHES))
def test_kernel_matches_plain_version_where_the_plan_branches(cuda_device,
                                                              case):
    x_shape, w_shape, pad = CONV_BRANCHES[case]
    x, w, b = _he_inputs(x_shape, w_shape, cuda_device)
    launches = ck.fused_conv2d_bias_act.launches
    y = ck.fused_conv2d_bias_act(x, w, b, pad=(pad, pad), activation="relu")
    ref = ck.conv2d_bias_act_reference(x, w, b, (pad, pad), "truncate",
                                       "relu")
    _assert_conv_close(y, ref)
    assert ck.fused_conv2d_bias_act.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("act", sorted(ck.CONV_FUSED_ACTS))
def test_every_activation_through_the_cluster_split(cuda_device, act):
    """Every activation on the cluster path (the K split's reduction
    applies bias and activation), at LeNet's second conv."""
    x, w, b = _he_inputs((4, 20, 12, 12), (50, 20, 5, 5), cuda_device)
    y = ck.fused_conv2d_bias_act(x, w, b, activation=act)
    _assert_conv_close(y, ck.conv2d_bias_act_reference(
        x, w, b, (0, 0), "truncate", act))


def _main_path_convs():
    """(N, Cin, H, Cout, K, pad) of every conv of LeNet, VGG16-CIFAR10 and
    VGG16-224, and of ResNet-50's stride-1 convs, at every batch a main
    path runs."""
    cs = _chip_smoke()
    out = {(n, cin, h, cout, k, pad)
           for n in cs.SERVE_LADDER + (cs.RESNET_TRAIN_BATCH,)
           for n, cin, h, _, cout, k, pad, _ in cs.conv_shapes("resnet50",
                                                                n)}
    for n in (1, 2, 4, 8, 16, 32, 64, 128):
        out |= {(n, 1, 28, 20, 5, 0), (n, 20, 12, 50, 5, 0)}
    for hw, batches in ((32, (1, 2, 4, 8, 16, 32, 128)), (224, (1, 8, 128))):
        for n in batches:
            cin, size = 3, hw
            for n_convs, ch in ((2, 64), (2, 128), (3, 256), (3, 512),
                                (3, 512)):
                for _ in range(n_convs):
                    out.add((n, cin, size, ch, 3, 1))
                    cin = ch
                size //= 2
    return sorted(out)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.gpu
def test_kernels_plan_covers_every_main_path_conv(cuda_device):
    """For every main-path conv the gate accepts, the kernel library's own
    plan on this card exists, covers the whole output and all of K, and
    keeps its tile, halo, cluster, shared memory and grid within the
    kernel's limits."""
    sms = _sms(cuda_device)
    for N, Cin, H, Cout, K, pad in _main_path_convs():
        assert ck.conv_fused_supported((N, Cin, H, H), (Cout, Cin, K, K),
                                       torch.float32, pad=(pad, pad))
        O = H + 2 * pad - K + 1
        p = ck.conv_plan(N, Cin, K, K, Cout, O, O, sms)
        assert p is not None
        assert p["ni"] * p["th"] * p["tw"] <= ck._CONV_BM
        assert p["ni"] * p["tiles_n"] >= N and p["th"] * p["tiles_h"] >= O
        assert p["tw"] * p["tiles_w"] >= O and p["bn"] * p["tiles_c"] >= Cout
        assert p["slices"] * ck._CONV_BK >= Cin * K * K
        assert p["cs"] * p["per_rank"] >= p["slices"] and p["cs"] <= 8
        assert p["nch"] * p["ni"] * p["hr"] * p["hp"] <= p["halo_floats"]
        assert p["smem"] <= 227 * 1024 and p["blocks"] <= 2 ** 31 - 1


@pytest.mark.gpu
def test_conv_library_runs_on_the_tensor_cores(cuda_device):
    """The conv library's SASS holds HGMMA (wgmma) instructions."""
    assert sum(ck.sass_hgmma_counts(ck.CONV_LIBRARY).values()) > 0


@pytest.mark.gpu
def test_flash_kernels_run_on_the_tensor_cores(cuda_device):
    """Every instance of the forward (flash_fwd<DPAD>) and of the dq and
    dk/dv kernel (flash_bwd<DPAD, DQ>), DPAD 64 and 128, holds HGMMA in the
    flash library's SASS."""
    counts = ck.sass_hgmma_counts(ck.FLASH_LIBRARY)
    fwd = {f: n for f, n in counts.items() if "flash_fwdILi" in f}
    bwd = {f: n for f, n in counts.items() if "flash_bwd" in f}
    assert len(fwd) == 2 and all(fwd.values()), counts
    assert len(bwd) == 4 and all(bwd.values()), counts


@pytest.mark.gpu
def test_bf16_flash_kernels_run_on_the_tensor_cores(cuda_device):
    """In the flash library's SASS every instance of the bf16 forward, dQ
    and dK/dV (flash_fwd_bf16<DP>, flash_dq_bf16<DP>, flash_dkv_bf16<DP>,
    DP 64 and 128; not their pre-passes) holds BF16 HGMMA (wgmma) and no
    HMMA."""
    hgmma = ck.sass_hgmma_counts(ck.FLASH_LIBRARY, "BF16")
    hmma = ck.sass_hgmma_counts(ck.FLASH_LIBRARY, "BF16", "HMMA")
    for kernel in ("flash_fwd_bf16ILi", "flash_dkv_bf16ILi",
                   "flash_dq_bf16ILi"):
        found = {f: n for f, n in hgmma.items() if kernel in f}
        assert len(found) == 2 and all(found.values()), (kernel, found)
        assert not any(n for f, n in hmma.items() if kernel in f), kernel


def _emulate_conv_kernel(x, w, pad, sms):
    """The kernel's indexing, block by block, in numpy (float64): the
    tiles of the library's own plan, the cluster ranks' K slices, the
    staged halo with its zero fill, the K-offset table and the gather of A
    rows from the halo.
    Returns y with NaN where no block wrote and raises if a block writes
    an output twice."""
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = w.shape
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    p = ck.conv_plan(N, Cin, KH, KW, Cout, OH, OW, sms)
    taps, BK = KH * KW, ck._CONV_BK
    kpad = p["slices"] * BK
    ws = np.zeros((-(-Cout // 128) * 128, kpad))
    ws[:Cout, :Cin * taps] = w.reshape(Cout, -1)
    ni, th, tw, hr, hp = (p[k] for k in ("ni", "th", "tw", "hr", "hp"))
    plane = ni * hr * hp
    tap_off = np.array([(t // KW) * hp + t % KW for t in range(taps)])
    xpad = np.zeros((N + ni, Cin + p["nch"], H + 2 * hr, W + 2 * hp))
    xpad[:N, :Cin, hr:hr + H, hp:hp + W] = x     # zero around the image
    y = np.full((N, Cout, OH, OW), np.nan)
    r = np.arange(ck._CONV_BM)
    rn, rh, rw = r // (th * tw), r % (th * tw) // tw, r % tw
    rbase = (rn * hr + rh) * hp + rw
    for block in range(p["blocks"] // p["cs"]):
        t, acc = block, 0.0
        ct, t = t % p["tiles_c"], t // p["tiles_c"]
        ow0, t = t % p["tiles_w"] * tw, t // p["tiles_w"]
        oh0, n0 = t % p["tiles_h"] * th, t // p["tiles_h"] * ni
        co0 = ct * p["bn"]
        live = ((r < ni * th * tw) & (n0 + rn < N) & (oh0 + rh < OH)
                & (ow0 + rw < OW))
        rows = np.where(live, rbase, 0)         # dead rows read offset 0
        for rank in range(p["cs"]):
            for sl in range(rank * p["per_rank"],
                            min(p["slices"], (rank + 1) * p["per_rank"])):
                k0 = sl * BK
                c_lo = k0 // taps
                halo = xpad[n0:n0 + ni, c_lo:c_lo + p["nch"],
                            hr + oh0 - pad:hr + oh0 - pad + hr,
                            hp + ow0 - pad:hp + ow0 - pad + hp]
                halo = halo.transpose(1, 0, 2, 3).reshape(-1)
                assert halo.size == p["nch"] * plane <= p["halo_floats"]
                k = k0 + np.arange(BK)
                koff = (k // taps - c_lo) * plane + tap_off[k % taps]
                a = halo[rows[:, None] + koff[None]]
                acc = acc + a @ ws[co0:co0 + p["bn"], k0:k0 + BK].T
        co = co0 + np.arange(p["bn"])
        for i in np.flatnonzero(live):
            out = y[n0 + rn[i], co[co < Cout], oh0 + rh[i], ow0 + rw[i]]
            assert np.isnan(out).all(), "an output written twice"
            y[n0 + rn[i], co[co < Cout], oh0 + rh[i], ow0 + rw[i]] = \
                acc[i, co < Cout]
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,w_shape,pad", [
    ((2, 1, 28, 28), (20, 1, 5, 5), 0),       # one slice, 5 row tiles
    ((3, 20, 12, 12), (50, 20, 5, 5), 0),     # two images a tile, cluster
    ((1, 64, 2, 2), (96, 64, 3, 3), 1),       # 2x2 map at batch 1
    ((3, 16, 4, 4), (70, 16, 3, 3), 1),       # 4x4 maps, Cout not 8k
    ((1, 5, 13, 11), (8, 5, 7, 7), 3),        # 7x7, odd H and W
    ((2, 40, 3, 3), (10, 40, 1, 1), 0),       # 1x1: 32 channels a slice
    ((2, 2048, 7, 7), (24, 2048, 1, 1), 0),   # ResNet-50's K = 2,048
])
def test_kernel_tiling_writes_every_output_once(cuda_device, x_shape,
                                                w_shape, pad):
    rng = np.random.default_rng(3)
    x, w = rng.normal(size=x_shape), rng.normal(size=w_shape)
    y = _emulate_conv_kernel(x, w, pad, _sms(cuda_device))
    assert not np.isnan(y).any()
    ref = torch.nn.functional.conv2d(torch.from_numpy(x),
                                     torch.from_numpy(w), padding=pad)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-12, atol=1e-12)


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
@pytest.mark.parametrize("N,V,offset", [
    (128, 1000, 0), (256, 512, 0), (997, 130, 0), (3, 50257, 0),
    (130, 1001, 0),                  # V % 4 != 0: single-float loads
    (128, 1000, 1), (64, 50257, 3),  # rows not 16-byte aligned
    (1, 1000, 0), (1, 50257, 0),     # one row
    (300, 77, 0), (64, 2048, 0), (64, 2047, 0), (64, 2049, 0),
    (64, 50257, 0), (16, 131072, 0),
    (4, 262144, 0), (2, 300001, 1)])  # wider than the registers: streamed
def test_xent_kernel_matches_plain_version_on_the_card(cuda_device, N, V,
                                                       offset):
    """Both paths of the kernel (a warp per row, a cluster per row), each
    load width, views whose rows start off a 16-byte boundary, and rows
    wider than a cluster's registers hold."""
    rng = np.random.default_rng(N + V)

    def on_card(a):
        flat = torch.empty((a.size + offset,), device=cuda_device)
        flat[offset:] = torch.from_numpy(a.reshape(-1)).to(cuda_device)
        return flat[offset:].reshape(a.shape)
    x = on_card((rng.normal(size=(N, V)) * 3).astype(np.float32))
    y = on_card(rng.random(size=(N, V)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    g = g.to(cuda_device)
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
def test_xent_plan_reads_each_row_on_enough_sms(cuda_device):
    """The plan the built library makes: a warp per row at the training
    path's [128, 1000], float4 loads only where the rows are aligned, and
    more than 64 blocks pulling at [64, 50257]."""
    plan = ck.xent_plan(128, 1000)
    assert plan == {"vec": 4, "per_thread": 32, "threads": 32,
                    "blocks_per_row": 1}
    assert ck.xent_plan(128, 1000, aligned=False)["vec"] == 1
    assert ck.xent_plan(128, 1001)["vec"] == 1
    wide = ck.xent_plan(64, 50257)
    assert wide["threads"] == 512 and 64 * wide["blocks_per_row"] > 64
    assert wide["blocks_per_row"] * 512 * 32 >= 50257
    widest = ck.xent_plan(1, 4 * ck.XENT_REGISTER_ROW)
    assert widest == {"vec": 4, "per_thread": 32, "threads": 512,
                      "blocks_per_row": 8}
    assert widest["blocks_per_row"] * 512 * 32 == ck.XENT_REGISTER_ROW
    with pytest.raises(ValueError):
        ck.xent_plan(1, 0)


def _staging_batches(n, rows, cols, seed=0, masks=True):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(rows, cols)).astype(np.float32),
                    rng.random((rows, 3)).astype(np.float32),
                    rng.random((rows,)).astype(np.float32) if masks
                    else None, None) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(32, 17), (1024, 512)])
def test_staged_batches_equal_their_host_copies(cuda_device, rows, cols):
    """Batches under PINNED_STAGING_BYTES (a pageable copy on the
    consumer's stream) and over it (pinned, on the side stream)."""
    batches = _staging_batches(6, rows, cols)
    nbytes = sum(a.nbytes for a in (batches[0].features, batches[0].labels,
                                    batches[0].features_mask))
    assert (nbytes >= iterators.PINNED_STAGING_BYTES) == (rows == 1024)
    it = AsyncDataSetIterator(ListDataSetIterator(batches), workers=2,
                              device=cuda_device, staging_depth=2)
    got = []
    while it.has_next():
        got.append(it.next())
    it.close()
    assert len(got) == 6
    for a, b in zip(got, batches):
        assert a.labels_mask is None
        for k in ("features", "labels", "features_mask"):
            t = getattr(a, k)
            assert t.device.type == "cuda"
            assert torch.equal(t.cpu(), torch.from_numpy(getattr(b, k)))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(4096, 16384), (64, 256)])
def test_consumer_stream_waits_for_the_staging_copy(cuda_device, rows,
                                                    cols):
    """A 256 MB batch (pinned, side stream) and a 64 KB one (pageable,
    the consumer's stream), each staged while the consumer's stream is
    busy: the moment ``next()`` returns, the host array is overwritten and
    the staged tensor is compared on the consumer's stream; it must hold
    the batch as it was when staged."""
    host = np.random.default_rng(1).random((rows, cols), np.float32)
    want = torch.from_numpy(host).to(cuda_device)
    torch.cuda.synchronize()
    for _ in range(3):
        it = AsyncDataSetIterator(
            ListDataSetIterator([DataSet(host, host[:, :1])]),
            device=cuda_device)
        it.has_next()
        torch.cuda._sleep(20_000_000)   # ~10 ms of the consumer's stream
        staged = it.next()
        host[:] = -1.0
        same = torch.equal(staged.features, want)
        it.close()
        host[:] = want.cpu().numpy()
        assert same


@pytest.mark.gpu
def test_fit_through_the_pipeline_on_the_card_equals_sync(cuda_device):
    def conf(workers):
        return (network.NeuralNetConfiguration.builder().seed(7)
                .updater("adam").learning_rate(0.01)
                .input_pipeline(workers=workers, staging_depth=2).list()
                .layer(L.DenseLayer(n_in=17, n_out=32, activation="relu"))
                .layer(L.OutputLayer(n_in=32, n_out=3, activation="softmax",
                                     loss="mcxent"))
                .build())
    batches = _staging_batches(8, 32, 17, seed=3, masks=False)
    nets = []
    for workers in (0, 2):
        net = MultiLayerNetwork(conf(workers), device=cuda_device).init()
        net.fit(ListDataSetIterator(batches), epochs=2)
        nets.append(net)
    assert torch.equal(nets[0].params(), nets[1].params())
    assert nets[0].score() == nets[1].score()


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
@pytest.mark.parametrize("N,H", [(32, 200), (3, 24)])
def test_bf16_lstm_kernel_unaligned_inputs_on_the_card(cuda_device, N, H):
    """h and RW off a 16-byte boundary: the bf16 kernel stages them by
    2-byte loads and agrees with the plain version by chip_smoke.py's bf16
    rule."""
    cs = _chip_smoke()
    rng = np.random.default_rng(N + H)

    def t(*shape, scale=1.0, offset=0):
        flat = torch.zeros(int(np.prod(shape)) + offset, device=cuda_device,
                           dtype=torch.bfloat16)
        view = flat[offset:].view(shape)
        view.copy_(torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device))
        return view
    zx = t(N, 3, 4 * H)[:, 1]
    h, rw = t(N, H, offset=1), t(H, 4 * H, scale=0.1, offset=3)
    assert h.data_ptr() % 16 and rw.data_ptr() % 16
    args = (zx, h, t(N, H), rw, t(3, H, scale=0.1))
    bf16 = ck.fused_lstm_step.bf16.launches
    got = ck.fused_lstm_step(*args)
    want = ck.lstm_step_reference(*args)
    assert ck.fused_lstm_step.bf16.launches == bf16 + 1
    for a, e in zip(got, want):
        rec = cs.bf16_conv_compare(torch, a, e)
        assert a.dtype == torch.bfloat16 and rec["ok"], rec


@pytest.mark.gpu
@pytest.mark.parametrize("N,H", [(32, 200), (1, 200), (4, 200), (5, 24),
                                 (3, 1024), (40, 8), (7, 264), (70, 128)])
def test_lstm_kernel_matches_plain_version_on_the_card(cuda_device, N, H):
    """One step, forward and the gradients of all five inputs, with zx a
    time step of a [N, T, 4H] tensor (a row-strided view) as in
    ``lstm_scan``.  At the tiling's edges: H = 1024 gives each of the 8
    warps four k-chunks of 32; H = 264 a range of 33 (a chunk of 32, then
    one of 1); H = 8 one k a warp; N = 40 and 70 span row blocks of 16 with
    a ragged last block."""
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
    # the edges of the bf16 forward's blocks (192 query rows at D <= 64,
    # 128 above) and of dK/dV's (128 keys, tiles of 64 queries)
    (1, 2, 128, 64, True, "none"), (1, 2, 129, 128, True, "none"),
    (1, 2, 191, 32, False, "none"), (1, 2, 193, 64, True, "tail"),
    (2, 1, 385, 64, True, "dead_row"),
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


def _chip_smoke():
    """The repo's chip_smoke.py as a module (its Keras VGG16-BN builders
    and the new-layer nets); it imports only the standard library and
    numpy at load."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 48), (16, 8, 12, 12)])
def test_batch_norm_on_the_card_matches_the_cpu(cuda_device, shape):
    """Training batch norm (output, running statistics, gradients) and
    inference batch norm on the card against the CPU: outputs and
    statistics rtol 1e-5, gradients rtol 1e-4 (a second reduction over
    the upstream gradient), atol 1e-6 (reductions in another order; the
    CPU parity tests' tolerances)."""
    from deeplearning4j_tpu_torch.ops import normalization as norm
    rng = np.random.default_rng(7)
    c = shape[1]
    arrays = [rng.normal(size=shape) * 2 + 0.5, rng.uniform(0.5, 1.5, c),
              rng.normal(size=c), rng.normal(size=c), rng.uniform(0.5, 1.5, c)]
    r = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        x, g, b, m, v = (torch.from_numpy(a.astype(np.float32)).to(dev)
                         for a in arrays)
        leaves = [t.requires_grad_() for t in (x, g, b)]
        y, nm, nv = norm.batch_norm_train(*leaves, m, v, decay=0.99, eps=1e-3)
        grads = torch.autograd.grad((y * r.to(dev)).sum(), leaves)
        yi = norm.batch_norm_infer(x.detach(), g.detach(), b.detach(), m, v)
        results.append([t.detach().cpu() for t in (y, nm, nv, yi, *grads)])
    for n, (a, b) in enumerate(zip(*results)):
        torch.testing.assert_close(a, b, rtol=1e-5 if n < 4 else 1e-4,
                                   atol=1e-6)


@pytest.mark.gpu
def test_imported_vgg16_bn_on_the_card_matches_the_cpu(cuda_device):
    """A thin VGG16-BN through the port's Keras import (chip_smoke's
    configuration and seeded weights): ``output()`` through the conv
    kernel (13 launches) within the whole-network tolerance of the CPU's;
    then one ``fit`` step with the same seed words: 13 conv and 20
    dropout launches, the score rtol 1e-4 and the running statistics
    rtol 1e-4, atol 1e-5 (both continuous in the forward; the kernel
    step's updates against the plain step's, relu masks and max pools
    pinned, are chip_smoke's train_keras_vgg16_bn)."""
    cs = _chip_smoke()
    widths = {"blocks": ((2, 8, 0.3), (2, 16, 0.4), (3, 16, 0.4),
                         (3, 32, 0.4), (3, 32, 0.4)), "head": 32}
    gpu = cs.import_keras_vgg16_bn(cuda_device, **widths)
    cpu = cs.import_keras_vgg16_bn("cpu", **widths)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(128, 3, 32, 32)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]
    before = ck.fused_conv2d_bias_act.launches
    out = gpu.output(x).cpu()
    assert ck.fused_conv2d_bias_act.launches - before == 13
    torch.testing.assert_close(out, cpu.output(x), rtol=cs.NET_RTOL,
                               atol=cs.NET_ATOL)
    seeds = rng.integers(0, 1 << 32, size=(len(gpu.layers), 2))
    before = (ck.fused_conv2d_bias_act.launches,
              ck.fused_threshold_dropout.launches)
    gpu._fit_batch(DataSet(x, y), seeds=seeds)
    assert (ck.fused_conv2d_bias_act.launches - before[0],
            ck.fused_threshold_dropout.launches - before[1]) == (13, 20)
    cpu._fit_batch(DataSet(x, y), seeds=seeds)
    np.testing.assert_allclose(gpu.score(), cpu.score(), rtol=1e-4)
    for gs, cs_ in zip(gpu.net_state, cpu.net_state):
        for k in cs_:
            torch.testing.assert_close(gs[k].cpu(), cs_[k], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.gpu
def test_new_layer_nets_on_the_card_match_the_cpu(cuda_device):
    """chip_smoke's ``new_layers`` phase: ZeroPadding, LRN, batch norm,
    Activation, GlobalPooling (NCHW and masked sequences), Embedding
    (indices and one-hot), a LossLayer head and the three new
    preprocessors, ``output()`` and one ``fit`` step, card against CPU."""
    res = _chip_smoke().phase_new_layers(torch, ck)
    assert set(res) == {"cnn", "rnn_pool", "embedding", "embedding_one_hot",
                        "preproc"}


def _thin_resnet(device, classes=512):
    """A thin bottleneck ResNet graph (``models/resnet``'s blocks: a 3x3
    stem, a 3x3/2 max pool padded by 1, two stages of two bottlenecks of
    4 and 8 channels, the second strided) on 16x16 inputs, with 512
    classes so a batch of 128 takes the xent kernel."""
    from deeplearning4j_tpu_torch.models import resnet as rm
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = network.GlobalConf(seed=3, learning_rate=0.01, updater="nesterovs",
                           weight_init="relu")
    b = GraphBuilder(g).add_inputs("in")
    x = rm._conv_bn(b, "stem", "in", 8, (3, 3), (1, 1), padding=(1, 1))
    b.add_layer("stem_pool", L.SubsamplingLayer(
        pooling_type="max", kernel=(3, 3), stride=(2, 2), padding=(1, 1)), x)
    x = "stem_pool"
    for si, ch in enumerate((4, 8)):
        for bi in range(2):
            stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
            x = rm._bottleneck(b, f"s{si}b{bi}", x, ch, stride,
                               project=(bi == 0))
    b.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", L.OutputLayer(n_out=classes, activation="softmax",
                                    loss="mcxent"), "gap")
    conf = (b.set_outputs("fc")
            .set_input_types(InputType.convolutional(16, 16, 3)).build())
    return ComputationGraph(conf, device=device)


@pytest.mark.gpu
def test_graph_on_the_card_matches_the_cpu(cuda_device):
    """A thin ResNet graph with chip_smoke's seeded weights on the card
    and on the CPU: ``output()`` through the conv kernel (one launch per
    stride-1 conv, 13 of 15) within the whole-network tolerance; one
    ``fit`` step at batch 128 with 13 conv and 1 xent launches, the score
    rtol 1e-4 and the running statistics rtol 1e-4, atol 1e-5 (both
    continuous in the forward; the updates against the plain step, with
    relu masks and the max pool pinned, are chip_smoke's
    train_resnet50)."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    cs = _chip_smoke()
    cpu = _thin_resnet("cpu").init()
    params, state = cs.resnet_weights(cpu, 7)
    cpu.load_jax_params(params).load_jax_state(state)
    gpu = _thin_resnet(cuda_device).init()
    gpu.load_jax_params(params).load_jax_state(state)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(128, 3, 16, 16)).astype(np.float32)
    y = np.eye(512, dtype=np.float32)[rng.integers(0, 512, 128)]
    before = ck.fused_conv2d_bias_act.launches
    out = gpu.output(x)[0].cpu()
    assert ck.fused_conv2d_bias_act.launches - before == 13
    torch.testing.assert_close(out, cpu.output(x)[0], rtol=cs.NET_RTOL,
                               atol=cs.NET_ATOL)
    before = (ck.fused_conv2d_bias_act.launches,
              ck.fused_softmax_xent.launches)
    gpu.fit(MultiDataSet([x], [y]))
    assert (ck.fused_conv2d_bias_act.launches - before[0],
            ck.fused_softmax_xent.launches - before[1]) == (13, 1)
    cpu.fit(MultiDataSet([x], [y]))
    np.testing.assert_allclose(gpu.score(), cpu.score(), rtol=1e-4)
    for n in cpu.order:
        for k, t in cpu.net_state[n].items():
            torch.testing.assert_close(gpu.net_state[n][k].cpu(), t,
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_graph_fit_through_the_pipeline_stages_on_the_card(cuda_device):
    """``ComputationGraph.fit`` over an iterator wraps it in the async
    pipeline, which stages every batch onto the card; the score equals a
    synchronous fit's (``pipeline_workers=0``) under cuDNN's
    deterministic algorithms."""
    from deeplearning4j_tpu_torch.datasets import ListMultiDataSetIterator
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    cs = _chip_smoke()
    rng = np.random.default_rng(10)
    data = [MultiDataSet([rng.normal(size=(32, 3, 16, 16)).astype(
        np.float32)], [np.eye(512, dtype=np.float32)[
            rng.integers(0, 512, 32)]]) for _ in range(3)]
    scores, seen = [], []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for workers in (1, 0):
            net = _thin_resnet(cuda_device).init()
            net.conf.global_conf.pipeline_workers = workers
            params, state = cs.resnet_weights(net, 7)
            net.load_jax_params(params).load_jax_state(state)
            fit_batch = net._fit_batch

            def spy(mds, seeds=None, _f=fit_batch):
                f = mds.features[0]
                seen.append(isinstance(f, torch.Tensor) and f.is_cuda)
                _f(mds, seeds)
            net._fit_batch = spy
            net.fit(ListMultiDataSetIterator(data))
            scores.append(net.score())
    finally:
        torch.backends.cudnn.deterministic = prev
    assert seen == [True] * 3 + [False] * 3
    assert scores[0] == scores[1]


def _w2v_case(device, seed=3, V=300, D=32, B=512, C=9, K=6, W=11):
    """Tables and one flush of seeded inputs (Zipf-heavy duplicates, a
    padded tail) for the word2vec steps, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    pair = np.ones(B, np.float32)
    pair[-5:] = 0.0
    center = rng.choice(V, B, p=p)
    nidx = np.concatenate([center[:, None], rng.choice(V, (B, K - 1), p=p)],
                          1)
    nmask = np.ones((B, K), np.float32)
    nmask[:, 1:] = nidx[:, 1:] != center[:, None]
    arrays = {
        "tables": [((rng.random((V, D)) - 0.5) / D).astype(np.float32),
                   rng.normal(0, 0.1, (V - 1, D)).astype(np.float32),
                   rng.normal(0, 0.1, (V, D)).astype(np.float32)],
        "ctx": rng.choice(V, B, p=p), "win": rng.choice(V, (B, W), p=p),
        "wmask": (np.arange(W)[None] < rng.integers(1, W + 1, (B, 1))
                  ).astype(np.float32) * pair[:, None],
        "heads": [rng.integers(0, V - 1, (B, C)),
                  rng.integers(0, 2, (B, C)).astype(np.float32),
                  (np.arange(C)[None] < rng.integers(1, C + 1, (B, 1))
                   ).astype(np.float32) * pair[:, None],
                  nidx, (np.arange(K) == 0).astype(np.float32)[None].repeat(
                      B, 0), nmask * pair[:, None],
                  (0.025 * pair).astype(np.float32)]}

    def put(a):
        a = np.asarray(a)
        return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a, device=device)
    return {k: ([put(a) for a in v] if isinstance(v, list) else put(v))
            for k, v in arrays.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["skipgram", "cbow"])
def test_w2v_step_on_cuda_matches_cpu(cuda_device, kind):
    """One ``skipgram_step`` / ``cbow_step`` on the card against the same
    step on the CPU: per table, the relative 2-norm of the difference of
    the two updates within chip_smoke.py's W2V_STEP_RTOL (5e-5; the card
    adds duplicate rows in no fixed order, so equality is not expected)."""
    from deeplearning4j_tpu_torch.embeddings import kernels
    cs = _chip_smoke()
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        case = _w2v_case(dev)
        old = [t.clone() for t in case["tables"]]
        if kind == "skipgram":
            kernels.skipgram_step(*case["tables"], case["ctx"],
                                  *case["heads"])
        else:
            kernels.cbow_step(*case["tables"], case["win"], case["wmask"],
                              *case["heads"])
        runs[dev.type] = [(t - o).cpu() for t, o in zip(case["tables"], old)]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert cs._rel_norm(torch, got, want) <= cs.W2V_STEP_RTOL


@pytest.mark.gpu
def test_word2vec_fit_on_cuda_matches_cpu(cuda_device):
    """A small Word2Vec fit (skip-gram, HS and 5 negatives) on the card
    against the same fit on the CPU: per table, ||card - cpu|| within
    chip_smoke.py's W2V_FIT_RTOL (1e-4) of the CPU fit's change."""
    from deeplearning4j_tpu_torch.embeddings import Word2Vec
    from deeplearning4j_tpu_torch.embeddings.lookup import TABLES
    from deeplearning4j_tpu_torch.text import CollectionSentenceIterator
    cs = _chip_smoke()
    fits = {}
    for dev in ("cuda", "cpu"):
        w2v = (Word2Vec.Builder()
               .iterate(CollectionSentenceIterator(cs._two_topic_corpus()))
               .layer_size(32).window_size(4).epochs(3).learning_rate(0.05)
               .min_word_frequency(1).negative_sample(5)
               .use_hierarchic_softmax(True).batch_size(512).seed(12345)
               .device(dev).build())
        w2v.build_vocab()
        init = w2v.lookup_table.get_weights()
        w2v.fit()
        fits[dev] = w2v
    for name in TABLES:
        want = fits["cpu"].lookup_table.array(name)
        base = init if name == "syn0" else np.zeros_like(want)
        rel = cs._fit_rel(torch, fits["cuda"].lookup_table.array(name),
                          want, base)
        assert rel <= cs.W2V_FIT_RTOL, (name, rel)
    assert set(fits["cuda"].words_nearest("cat", top=3)) == \
        set(fits["cpu"].words_nearest("cat", top=3))


# ---------------------------------------------------------------------------
# The conv kernel's full-width route, k-means and t-SNE on the card
# ---------------------------------------------------------------------------

# (x shape, w shape, pad): filters as wide as the padded input (OW = 1)
CONV_FULL_WIDTH = {
    "textcnn_300_h3": ((32, 1, 256, 300), (100, 1, 3, 300), (0, 0)),
    "textcnn_300_h5": ((32, 1, 256, 300), (100, 1, 5, 300), (0, 0)),
    "textcnn_128_h4": ((32, 1, 256, 128), (100, 1, 4, 128), (0, 0)),
    "one_sentence_dead_rows": ((1, 1, 40, 300), (100, 1, 5, 300), (0, 0)),
    "w13_four_byte_copies_cout20": ((3, 2, 17, 13), (20, 2, 4, 13), (0, 0)),
    "height_and_width_padding": ((2, 3, 9, 12), (70, 3, 3, 16), (1, 2)),
    "kh8_narrow": ((5, 4, 30, 7), (9, 4, 8, 7), (0, 0)),
    "channels_k_past_a_slice": ((4, 6, 33, 20), (40, 6, 6, 20), (2, 0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_FULL_WIDTH))
def test_full_width_route_matches_plain_version(cuda_device, case):
    x_shape, w_shape, pad = CONV_FULL_WIDTH[case]
    x, w, b = _he_inputs(x_shape, w_shape, cuda_device)
    N, Cin, H, W = x_shape
    Cout, _, KH, KW = w_shape
    OH = H + 2 * pad[0] - KH + 1
    plan = ck.conv_plan(N, Cin, KH, KW, Cout, OH, 1, _sms(cuda_device))
    assert plan["fw"] == 1
    assert plan["tiles_h"] * ck._CONV_BM >= N * OH
    assert plan["bn"] * plan["tiles_c"] >= Cout
    assert plan["slices"] * ck._CONV_BK >= Cin * KH * KW
    assert plan["smem"] <= 227 * 1024
    launches = ck.fused_conv2d_bias_act.launches
    y = ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation="relu")
    ref = ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", "relu")
    assert tuple(y.shape) == (N, Cout, OH, 1)
    _assert_conv_close(y, ref)
    assert ck.fused_conv2d_bias_act.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("act", sorted(ck.CONV_FUSED_ACTS))
def test_full_width_route_every_activation(cuda_device, act):
    x, w, b = _he_inputs((6, 2, 21, 24), (36, 2, 5, 24), cuda_device)
    y = ck.fused_conv2d_bias_act(x, w, b, activation=act)
    _assert_conv_close(y, ck.conv2d_bias_act_reference(
        x, w, b, (0, 0), "truncate", act))


@pytest.mark.gpu
def test_full_width_route_unaligned_input(cuda_device):
    """An input that starts off a 16-byte boundary takes the 4-byte
    copies."""
    x, w, b = _he_inputs((2, 1, 20, 64), (16, 1, 3, 64), cuda_device)
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    xs = flat[1:].view_as(x)
    xs.copy_(x)
    assert xs.data_ptr() % 16
    _assert_conv_close(ck.fused_conv2d_bias_act(xs, w, b),
                       ck.conv2d_bias_act_reference(x, w, b))


@pytest.mark.gpu
def test_full_width_route_runs_on_the_tensor_cores(cuda_device):
    """Both full-width instances, conv_wgmma_kernel<BN, true>, hold HGMMA
    in the conv library's SASS."""
    counts = ck.sass_hgmma_counts(ck.CONV_LIBRARY)
    fw = {f: n for f, n in counts.items()
          if "conv_wgmma_kernel" in f and "Lb1E" in f}
    assert len(fw) == 2 and all(fw.values()), counts


def _emulate_full_width(x, w, pad, sms):
    """The full-width route's indexing in numpy (float64): the library's
    plan, each block's rows of M = N*OH, the cluster ranks' K slices, A's
    rows copied from x at row offset + K offset with zeros in the padding.
    Returns y with NaN where no block wrote; raises on a double write."""
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = w.shape
    OH = H + 2 * pad[0] - KH + 1
    p = ck.conv_plan(N, Cin, KH, KW, Cout, OH, 1, sms)
    BK, BM = ck._CONV_BK, ck._CONV_BM
    K = Cin * KH * KW
    ws = np.zeros((-(-Cout // 64) * 64 + 64, p["slices"] * BK))
    ws[:Cout, :K] = w.reshape(Cout, -1)
    flat = x.reshape(-1)
    y = np.full((N, Cout, OH, 1), np.nan)
    for block in range(p["blocks"] // p["cs"]):
        ct, t = block % p["tiles_c"], block // p["tiles_c"]
        m = t * BM + np.arange(BM)
        live = m < N * OH
        n, oh = m // OH, m % OH
        row_off = n * Cin * H * W + (oh - pad[0]) * W
        acc = 0.0
        for rank in range(p["cs"]):
            for sl in range(rank * p["per_rank"],
                            min(p["slices"], (rank + 1) * p["per_rank"])):
                k = sl * BK + np.arange(BK)
                c, kh, iw = k // (KH * KW), k % (KH * KW) // KW, \
                    k % KW - pad[1]
                koff = c * H * W + kh * W + iw
                ok = ((k < K) & (iw >= 0) & (iw < W))[None, :] & live[:, None] \
                    & (oh[:, None] - pad[0] + kh[None, :] >= 0) \
                    & (oh[:, None] - pad[0] + kh[None, :] < H)
                src = np.where(ok, row_off[:, None] + koff[None, :], 0)
                a = np.where(ok, flat[src], 0.0)
                co0 = ct * p["bn"]
                acc = acc + a @ ws[co0:co0 + p["bn"], sl * BK:(sl + 1) * BK].T
        co = ct * p["bn"] + np.arange(p["bn"])
        for r in np.flatnonzero(live):
            out = y[n[r], co[co < Cout], oh[r], 0]
            assert np.isnan(out).all(), "an output written twice"
            y[n[r], co[co < Cout], oh[r], 0] = acc[r, co < Cout]
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_FULL_WIDTH))
def test_full_width_tiling_writes_every_output_once(cuda_device, case):
    x_shape, w_shape, pad = CONV_FULL_WIDTH[case]
    if x_shape[0] * x_shape[2] * w_shape[0] > 300_000:
        x_shape = (2,) + x_shape[1:]           # the indexing, not the size
    rng = np.random.default_rng(4)
    x, w = rng.normal(size=x_shape), rng.normal(size=w_shape)
    y = _emulate_full_width(x, w, pad, _sms(cuda_device))
    assert not np.isnan(y).any()
    ref = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                     padding=pad)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_text_cnn_step_on_the_card_matches_the_cpu(cuda_device):
    """chip_smoke.py's text CNN at D = 32, one fit step on the card (3
    full-width conv and 2 dropout launches) against the same step on the
    CPU with the same seed words: score rtol 1e-4, params 1e-4 / 1e-5."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    cs = _chip_smoke()
    nets = {dev: ComputationGraph(cs.textcnn_conf(
        gc, L, GlobalConf, InputType, width=32, length=40, maps=64,
        pipeline_workers=0), device=dev).init() for dev in ("cuda", "cpu")}
    nets["cuda"].set_params(nets["cpu"].params())
    rng = np.random.default_rng(7)
    x = rng.normal(size=(32, 1, 40, 32)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    seeds = nets["cpu"]._draw_seeds()
    conv0 = ck.fused_conv2d_bias_act.launches
    drop0 = ck.fused_threshold_dropout.launches
    for net in nets.values():
        net._fit_batch(MultiDataSet([x], [y]), seeds=seeds)
    assert ck.fused_conv2d_bias_act.launches - conv0 == 3
    assert ck.fused_threshold_dropout.launches - drop0 == 2
    assert nets["cuda"].score() == pytest.approx(nets["cpu"].score(),
                                                 rel=1e-4)
    torch.testing.assert_close(nets["cuda"].params().cpu(),
                               nets["cpu"].params(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kmeans_and_tsne_on_the_card_match_the_cpu(cuda_device):
    """Lloyd's loop from the same centres and t-SNE's P and loop (the
    contracting settings of tests/test_torch_clustering.py) on the card
    against the CPU."""
    from deeplearning4j_tpu_torch.clustering import kmeans
    from deeplearning4j_tpu_torch.plot import tsne
    cs = _chip_smoke()
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(size=(300, 16)) + c
                        for c in (0, 6, -6)]).astype(np.float32)
    xt = torch.from_numpy(x)
    c0 = xt[[0, 300, 600, 5]]
    card = kmeans.lloyd(xt.cuda(), c0.cuda(), 100, 1e-4)
    cpu = kmeans.lloyd(xt, c0, 100, 1e-4)
    assert card[2] == cpu[2]
    assert torch.equal(card[1].cpu(), cpu[1])
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)
    p_card, p_cpu = tsne._x2p_dense(xt.cuda(), 30.0), tsne._x2p_dense(xt, 30.0)
    torch.testing.assert_close(p_card.cpu(), p_cpu, rtol=1e-4, atol=1e-5)
    ps = torch.clamp_min((p_cpu + p_cpu.T) / (2.0 * len(x)), 1e-12)
    y0 = torch.from_numpy((1e-4 * rng.normal(size=(len(x), 2))).astype(
        np.float32))
    a = tsne._tsne_exact(ps.cuda(), y0.cuda(), **cs.TSNE_STABLE).cpu()
    b = tsne._tsne_exact(ps, y0, **cs.TSNE_STABLE)
    assert cs._rel_norm(torch, a, b) <= cs.TSNE_LOOP_RTOL


def _frozen_cnn(device, dropout=None, resume=False):
    """Two 3x3 relu convs frozen under a trained dense layer (dropout on
    its input) and a softmax head, on 8x8x3 images."""
    b = (network.NeuralNetConfiguration.builder().seed(21)
         .learning_rate(0.05).updater("nesterovs").weight_init("relu"))
    if resume:
        b.fault_tolerance(resume=True)
    b = b.list()
    b.layer(L.ConvolutionLayer(n_out=8, kernel=(3, 3), padding=(1, 1),
                               activation="relu"))
    b.layer(L.ConvolutionLayer(n_out=8, kernel=(3, 3), padding=(1, 1),
                               activation="relu"))
    b.layer(L.DenseLayer(n_out=32, activation="relu", dropout=dropout))
    b.layer(L.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
    conf = b.set_input_type(InputType.convolutional(8, 8, 3)).build()
    conf.layers = [L.FrozenLayerConf.wrap(l) if i < 2 else l
                   for i, l in enumerate(conf.layers)]
    return MultiLayerNetwork(conf, device=device).init()


def _frozen_batches(n=6, rows=64, seed=5):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(rows, 3, 8, 8)).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.integers(0, 4, rows)])
            for _ in range(n)]


@pytest.mark.gpu
def test_frozen_convs_record_no_backward(cuda_device):
    """Frozen convs launch their kernel forward and never its backward;
    their params do not move while the dense layers train."""
    net = _frozen_cnn(cuda_device)
    frozen = [{k: v.clone() for k, v in net.net_params[i].items()}
              for i in (0, 1)]
    launches, backwards = (ck.fused_conv2d_bias_act.launches,
                           ck._ConvBiasAct.backwards)
    before = net.net_params[2]["W"].clone()
    net.fit(ListDataSetIterator(_frozen_batches(3)))
    torch.cuda.synchronize()
    assert ck.fused_conv2d_bias_act.launches - launches == 2 * 3
    assert ck._ConvBiasAct.backwards == backwards
    for i, p in zip((0, 1), frozen):
        for k, v in p.items():
            assert torch.equal(net.net_params[i][k], v)
    assert not torch.equal(net.net_params[2]["W"], before)
    # unfrozen, the same convs take their backward
    conf = net.conf
    conf.layers = [L.unfrozen(l) for l in conf.layers]
    MultiLayerNetwork(conf, device=cuda_device).init().fit(
        ListDataSetIterator(_frozen_batches(1)))
    assert ck._ConvBiasAct.backwards == backwards + 2


@pytest.mark.gpu
def test_resumed_fit_on_the_card_equals_uninterrupted(cuda_device,
                                                      tmp_path):
    """On the card, with the dropout kernel on the dense layer's input and
    cuDNN deterministic: a fit cut by an exception after 8 of 12 batches
    and resumed from its checkpoint (every 4 iterations) ends with the
    params and updater state of the uncut fit (``torch.equal``)."""
    from deeplearning4j_tpu_torch.nn.checkpoint import CheckpointListener

    class Cut(Exception):
        pass

    class CutAfter(ListDataSetIterator):
        served = 0

        def next(self):
            self.served += 1
            if self.served == 9:
                raise Cut()
            return super().next()
    data = _frozen_batches()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        drops = ck.fused_threshold_dropout.launches
        ref = _frozen_cnn(cuda_device, dropout=0.5)
        ref.fit(ListDataSetIterator(data), epochs=2)
        assert ck.fused_threshold_dropout.launches - drops == 12
        cut = _frozen_cnn(cuda_device, dropout=0.5)
        cut.set_listeners(CheckpointListener(tmp_path,
                                             save_every_n_iterations=4))
        with pytest.raises(Cut):
            cut.fit(CutAfter(data), epochs=2)
        assert cut.iteration == 8
        resumed = _frozen_cnn(cuda_device, dropout=0.5, resume=True)
        resumed.set_listeners(CheckpointListener(tmp_path,
                                                 save_every_n_iterations=4))
        resumed.fit(ListDataSetIterator(data), epochs=2)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert resumed.iteration == ref.iteration == 12
    assert torch.equal(resumed.params(), ref.params())
    assert torch.equal(resumed.updater_state_flat(),
                       ref.updater_state_flat())


# ---------------------------------------------------------------------------
# The bf16 forms of the conv and dropout kernels
# ---------------------------------------------------------------------------

def _bf16_inputs(x_shape, w_shape, device, seed=5):
    """_he_inputs' magnitudes, rounded to bf16."""
    return (t.to(torch.bfloat16) for t in _he_inputs(x_shape, w_shape,
                                                      device, seed))


def _assert_bf16_conv_close(y, ref):
    """chip_smoke.py's bf16 conv rule: equal, one bf16 ulp apart, or within
    1e-5 of the output's largest magnitude (f32 sums in two orders)."""
    rec = _chip_smoke().bf16_conv_compare(torch, y, ref)
    assert y.dtype == torch.bfloat16 and rec["ok"], rec


# the edges of the bf16 form's halo route (chip_smoke.BF16_CONV_EDGES):
# 32, 64 + 1 and 128 + 1 output channels, 1x1 and 3x3 at each of
# ResNet-50's plane sizes, several images a tile, N = 1, a cluster split,
# Cin 3 and 20
CONV_BF16_EDGES = {
    "p56_k1_cout32": ((2, 64, 56, 56), (32, 64, 1, 1), 0),
    "p56_k3_cout65": ((2, 64, 56, 56), (65, 64, 3, 3), 1),
    "p28_k1_cout129": ((2, 128, 28, 28), (129, 128, 1, 1), 0),
    "p28_k3_cout64": ((2, 128, 28, 28), (64, 128, 3, 3), 1),
    "p14_k1_cout65": ((2, 256, 14, 14), (65, 256, 1, 1), 0),
    "p14_k3_cout129": ((2, 256, 14, 14), (129, 256, 3, 3), 1),
    "p7_k1_images_a_tile": ((3, 512, 7, 7), (129, 512, 1, 1), 0),
    "p7_k3_images_a_tile": ((3, 512, 7, 7), (32, 512, 3, 3), 1),
    "p14_n1_cluster": ((1, 512, 14, 14), (512, 512, 3, 3), 1),
    "p7_n1_cluster_k1": ((1, 2048, 7, 7), (512, 2048, 1, 1), 0),
    "cin3": ((1, 3, 9, 9), (32, 3, 3, 3), 1),
    "cin20_k5": ((2, 20, 12, 12), (50, 20, 5, 5), 0),
    # the GEMM route (1x1, no padding): pixels not a multiple of a tile
    # (10 x 10, 2 images); tiles across images at 14 x 14 (8-byte copies)
    # and 7 x 7 (the pre-pass image); Cout 64 (64 x 128 blocks), 65 and
    # 2,048; N = 1 with a cluster split at 14 x 14; an odd plane (odd
    # pixel stores); a padded 1x1, which stays on the halo route
    "gemm_p10_ragged": ((2, 64, 10, 10), (64, 64, 1, 1), 0),
    "gemm_p14_images": ((3, 256, 14, 14), (128, 256, 1, 1), 0),
    "gemm_p7_images": ((5, 512, 7, 7), (256, 512, 1, 1), 0),
    "gemm_p56_cout64": ((2, 64, 56, 56), (64, 64, 1, 1), 0),
    "gemm_p28_cout65": ((2, 128, 28, 28), (65, 128, 1, 1), 0),
    "gemm_p7_cout2048": ((2, 512, 7, 7), (2048, 512, 1, 1), 0),
    "gemm_p14_n1_cluster": ((1, 1024, 14, 14), (256, 1024, 1, 1), 0),
    "gemm_p9_odd_cin40": ((2, 40, 9, 9), (70, 40, 1, 1), 0),
    "k1_padded_halo": ((2, 64, 14, 14), (96, 64, 1, 1), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_BRANCHES) +
                         sorted(CONV_FULL_WIDTH) + sorted(CONV_BF16_EDGES))
def test_bf16_conv_matches_plain_version_on_the_card(cuda_device, case):
    """Both routes of the bf16 form, where the plan branches, and the halo
    route's edges, against the plain version (bf16 inputs upcast, f32, one
    rounding); the launch is counted on the bf16 form's own count."""
    x_shape, w_shape, pad = {**CONV_BRANCHES, **CONV_FULL_WIDTH,
                             **CONV_BF16_EDGES}[case]
    pad = (pad, pad) if isinstance(pad, int) else pad
    x, w, b = _bf16_inputs(x_shape, w_shape, cuda_device)
    f32, bf16 = (ck.fused_conv2d_bias_act.launches,
                 ck.fused_conv2d_bias_act.bf16.launches)
    y = ck.fused_conv2d_bias_act(x, w, b, pad=pad, activation="relu")
    ref = ck.conv2d_bias_act_reference(x, w, b, pad, "truncate", "relu")
    _assert_bf16_conv_close(y, ref)
    assert ck.fused_conv2d_bias_act.launches == f32
    assert ck.fused_conv2d_bias_act.bf16.launches == bf16 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("act", sorted(ck.CONV_FUSED_ACTS))
def test_bf16_conv_every_activation_both_routes(cuda_device, act):
    for xs, ws in (((4, 20, 12, 12), (50, 20, 5, 5)),
                   ((2, 40, 9, 9), (70, 40, 3, 3)),
                   ((6, 2, 21, 24), (36, 2, 5, 24)),
                   ((2, 40, 8, 8), (70, 40, 1, 1)),
                   ((2, 40, 9, 9), (70, 40, 1, 1))):
        x, w, b = _bf16_inputs(xs, ws, cuda_device)
        _assert_bf16_conv_close(
            ck.fused_conv2d_bias_act(x, w, b, activation=act),
            ck.conv2d_bias_act_reference(x, w, b, (0, 0), "truncate", act))


@pytest.mark.gpu
def test_bf16_conv_unaligned_full_width_input(cuda_device):
    """A full-width input off an 8-byte boundary takes 2-byte loads."""
    x, w, b = _bf16_inputs((2, 1, 20, 64), (16, 1, 3, 64), cuda_device)
    flat = torch.empty(x.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    xs = flat[1:].view_as(x)
    xs.copy_(x)
    assert xs.data_ptr() % 8
    _assert_bf16_conv_close(ck.fused_conv2d_bias_act(xs, w, b),
                            ck.conv2d_bias_act_reference(x, w, b))


@pytest.mark.gpu
def test_bf16_conv_gradients_are_the_plain_versions_in_bf16(cuda_device):
    """The bf16 form's backward recomputes the plain version in f32 from
    the upcast bf16 inputs: its gradients are bf16 and equal the plain
    version's autograd, with cuDNN's TF32 allowed or not."""
    x, w, b = _bf16_inputs((4, 8, 16, 16), (16, 8, 3, 3), cuda_device)
    torch.backends.cudnn.allow_tf32 = True
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = ck.fused_conv2d_bias_act(*leaves, pad=(1, 1), activation="relu")
    g = torch.randn(y.shape, device=cuda_device).to(torch.bfloat16)
    got = torch.autograd.grad(y, leaves, g)
    with ck.full_f32_convs():
        ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ref = ck.conv2d_bias_act_reference(*ref_leaves, (1, 1), "truncate",
                                           "relu")
        want = torch.autograd.grad(ref, ref_leaves, g)
    for a, e in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, e)


@pytest.mark.gpu
def test_bf16_conv_rejects_mixed_dtypes(cuda_device):
    x, w, b = _bf16_inputs((2, 3, 8, 8), (4, 3, 3, 3), cuda_device)
    with pytest.raises(ValueError):
        ck.fused_conv2d_bias_act(x, w.float(), b)


# the bf16 conv's kernel functions and their instances: the halo and
# full-width routes' (BN 32 and 64 each), the GEMM route's (blocks of 64
# Cout x 128 pixels and of 128 x 64)
BF16_CONV_KERNELS = {"conv_wgmma_bf16_kernel": 4, "conv_gemm_bf16_kernel": 2}


@pytest.mark.gpu
def test_bf16_conv_runs_bf16_products_on_the_tensor_cores(cuda_device):
    """Every instance of every bf16 conv kernel, both routes, holds bf16
    HGMMA in the conv library's SASS."""
    counts = ck.sass_hgmma_counts(ck.CONV_LIBRARY, "BF16")
    for name, instances in BF16_CONV_KERNELS.items():
        mine = {f: n for f, n in counts.items() if name in f}
        assert len(mine) == instances and all(mine.values()), (name, counts)


@pytest.mark.gpu
def test_bf16_conv_wgmmas_are_not_serialised(cuda_device):
    """ptxas serialised no bf16 conv instance's wgmmas: the library's build
    log (kept beside it) names none of them in a ``serialized`` line."""
    ck.CONV_LIBRARY.get()
    log = ck.CONV_LIBRARY.build_log
    assert "ptxas" in log, "the conv library's build log is missing"
    lines = [line for line in log.splitlines() if "serialized" in line and
             any(name in line for name in BF16_CONV_KERNELS)]
    assert not lines, lines


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096), (128, 25088), (3, 4099),
                                   (4097,)])
@pytest.mark.parametrize("rate", [0.5, 0.8])
def test_bf16_dropout_is_bit_identical_on_the_card(cuda_device, shape,
                                                   rate):
    """The bf16 form against its plain version with torch.equal, forward
    and backward, its mask the f32 form's, on the bf16 count."""
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device).to(bf)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device).to(bf)
    seed = (2654435761, 12345)
    f32, bf16 = (ck.fused_threshold_dropout.launches,
                 ck.fused_threshold_dropout.bf16.launches)
    xr = x.clone().requires_grad_()
    y = ck.fused_threshold_dropout(xr, rate, seed)
    y.backward(g)
    assert (ck.fused_threshold_dropout.launches,
            ck.fused_threshold_dropout.bf16.launches) == (f32, bf16 + 2)
    assert y.dtype == xr.grad.dtype == bf
    assert torch.equal(y, ck.threshold_dropout_reference(x, rate, seed))
    assert torch.equal(xr.grad, ck.threshold_dropout_reference(g, rate, seed))
    assert torch.equal(y.cpu(), ck.threshold_dropout_reference(x.cpu(), rate,
                                                               seed))
    ones = torch.ones(shape, device=cuda_device)
    assert torch.equal(ck.fused_threshold_dropout(ones.to(bf), rate, seed)
                       != 0, ck.fused_threshold_dropout(ones, rate, seed) != 0)


@pytest.mark.gpu
def test_bf16_dropout_unaligned_view(cuda_device):
    x = torch.randn(4097, device=cuda_device).to(torch.bfloat16)
    view = x[1:]
    assert view.data_ptr() % 16
    assert torch.equal(ck.fused_threshold_dropout(view, 0.5, (3, 4)),
                       ck.threshold_dropout_reference(view, 0.5, (3, 4)))


@pytest.mark.gpu
def test_bf16_net_fit_on_the_card_launches_the_bf16_forms(cuda_device):
    """A small conv + dropout net under precision("bfloat16") trains on the
    card through the bf16 forms only, its masters, updater state and
    output float32."""
    b = (network.NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
         .updater("nesterovs").precision("bfloat16").list()
         .layer(L.ConvolutionLayer(n_out=16, kernel=(3, 3), padding=(1, 1),
                                   activation="relu"))
         .layer(L.SubsamplingLayer(pooling_type="max"))
         .layer(L.DenseLayer(n_out=64, activation="relu", dropout=0.5))
         .layer(L.OutputLayer(n_out=10, activation="softmax",
                              loss="mcxent"))
         .set_input_type(InputType.convolutional(16, 16, 3)))
    net = MultiLayerNetwork(b.build(), device=cuda_device).init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 3, 16, 16)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]
    conv, drop = (ck.fused_conv2d_bias_act, ck.fused_threshold_dropout)
    before = (conv.launches, conv.bf16.launches, drop.launches,
              drop.bf16.launches)
    net.fit(x, y)
    assert (conv.launches, conv.bf16.launches, drop.launches,
            drop.bf16.launches) == (before[0], before[1] + 1, before[2],
                                    before[3] + 2)
    assert np.isfinite(net.score())
    leaves = [t for lp in net.net_params for t in lp.values()]
    assert all(t.dtype == torch.float32 for t in leaves)
    out = net.output(x[:4])
    assert out.dtype == torch.float32 and out.shape == (4, 10)


# The bf16 forms of the lstm step and the flash kernels

@pytest.mark.gpu
@pytest.mark.parametrize("N,H", [(32, 200), (3, 24)])
def test_bf16_lstm_kernel_unaligned_inputs_on_the_card(cuda_device, N, H):
    """h and RW off a 16-byte boundary: the bf16 kernel stages them by
    2-byte loads and agrees with the plain version by chip_smoke.py's bf16
    rule."""
    cs = _chip_smoke()
    rng = np.random.default_rng(N + H)

    def t(*shape, scale=1.0, offset=0):
        flat = torch.zeros(int(np.prod(shape)) + offset, device=cuda_device,
                           dtype=torch.bfloat16)
        view = flat[offset:].view(shape)
        view.copy_(torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device))
        return view
    zx = t(N, 3, 4 * H)[:, 1]
    h, rw = t(N, H, offset=1), t(H, 4 * H, scale=0.1, offset=3)
    assert h.data_ptr() % 16 and rw.data_ptr() % 16
    args = (zx, h, t(N, H), rw, t(3, H, scale=0.1))
    bf16 = ck.fused_lstm_step.bf16.launches
    got = ck.fused_lstm_step(*args)
    want = ck.lstm_step_reference(*args)
    assert ck.fused_lstm_step.bf16.launches == bf16 + 1
    for a, e in zip(got, want):
        rec = cs.bf16_conv_compare(torch, a, e)
        assert a.dtype == torch.bfloat16 and rec["ok"], rec


@pytest.mark.gpu
@pytest.mark.parametrize("N,H", [(32, 200), (1, 200), (4, 200), (5, 24),
                                 (3, 1024), (40, 8), (7, 264), (17, 200),
                                 (9, 16), (2, 8), (17, 232), (33, 200),
                                 (8, 456), (9, 200), (1, 8)])
def test_bf16_lstm_kernel_matches_plain_version_on_the_card(cuda_device, N,
                                                            H):
    """The lstm kernel's bf16 form at the tiling's edges (blocks of 8 units
    by 4 rows up to N = 8, by 8 rows beyond; H past a staged chunk of 224
    k), zx a row-strided view: c' and h' by chip_smoke.py's bf16 rule
    against the plain version (the five inputs upcast, the step in f32, one
    rounding), counted on the bf16 form's count only; the gradients, which
    both paths take from ``lstm_step_formula`` on the same saved inputs,
    equal."""
    from unittest import mock
    cs = _chip_smoke()
    rng = np.random.default_rng(N * 1000 + H)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda_device).to(torch.bfloat16)
    zx = t(N, 3, 4 * H)[:, 1]
    args = [zx, t(N, H), t(N, H), t(H, 4 * H, scale=0.1), t(3, H, scale=0.1)]
    g_c, g_h = t(N, H), t(N, H)
    f32, bf16 = ck.fused_lstm_step.launches, ck.fused_lstm_step.bf16.launches
    runs = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_() for a in args]
        with (mock.patch.object(ck, "_launch_lstm_step",
                                ck.lstm_step_reference) if plain
              else contextlib.nullcontext()):
            c_new, h_new = ck.fused_lstm_step(*leaves)
            grads = torch.autograd.grad((c_new, h_new), leaves, (g_c, g_h))
        runs.append((c_new, h_new, grads))
    assert ck.fused_lstm_step.bf16.launches == bf16 + 1
    assert ck.fused_lstm_step.launches == f32
    for got, ref in zip(runs[0][:2], runs[1][:2]):
        rec = cs.bf16_conv_compare(torch, got, ref)
        assert got.dtype == torch.bfloat16 and rec["ok"], rec
    for a, e in zip(runs[0][2], runs[1][2]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,causal,mask", FLASH_CASES)
def test_bf16_flash_kernels_match_plain_versions_on_the_card(
        cuda_device, B, H, T, D, causal, mask):
    """The three flash kernels' bf16 forms against their plain versions on
    bf16 inputs, by chip_smoke.py's bf16 flash rule (``check_flash_bf16``:
    out, dq, dk, dv one ulp + BF16_FLASH_ATOL of the scale, lse 1e-5, a dead
    row 0 and -1e30), each counted on its bf16 form's count only."""
    cs = _chip_smoke()
    names = ("flash_forward", "flash_dq", "flash_dkv")
    f32 = [getattr(ck, n).launches for n in names]
    bf16 = [getattr(ck, n).bf16.launches for n in names]
    gen = torch.Generator(device=cuda_device).manual_seed(B * 1000 + T + D)
    rec = cs.check_flash_bf16(torch, ck, gen, B, H, T, D, causal, mask)
    assert [getattr(ck, n).launches for n in names] == f32
    assert [getattr(ck, n).bf16.launches for n in names] == \
        [b + 1 for b in bf16]
    assert set(rec["max_abs_err"]) == {"out", "lse", "dq", "dk", "dv"}


@pytest.mark.gpu
def test_bf16_sequence_nets_launch_the_bf16_forms_on_the_card(cuda_device):
    """A bf16 TBPTT minibatch of a small char-RNN launches the lstm step's
    bf16 form once a layer and time step in every segment, the f32 form
    never; a bf16 attention ``fit`` step launches each bf16 flash form once
    a layer; ``output()`` the bf16 forward; masters and outputs f32."""
    V, T = 12, 20
    net = char_rnn(V, hidden=16, tbptt_length=5, device=cuda_device)
    net.conf.global_conf.precision = "bfloat16"
    net.init()
    rng = np.random.default_rng(3)
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[rng.integers(0, V, (4, T))], eye[rng.integers(0, V, (4, T))]
    f32, bf16 = ck.fused_lstm_step.launches, ck.fused_lstm_step.bf16.launches
    net.fit(x, y)
    assert ck.fused_lstm_step.bf16.launches == bf16 + 2 * T
    assert ck.fused_lstm_step.launches == f32
    assert np.isfinite(net.score())
    assert all(p.dtype == torch.float32 for lp in net.net_params
               for p in lp.values())
    Ta = 256
    att = attention_lm(V, 64, 2, 2, Ta, learning_rate=0.01,
                       device=cuda_device)
    att.conf.global_conf.precision = "bfloat16"
    att.init()
    xa, ya = eye[rng.integers(0, V, (2, Ta))], eye[rng.integers(0, V, (2, Ta))]
    names = ("flash_forward", "flash_dq", "flash_dkv")
    before = [getattr(ck, n).bf16.launches for n in names]
    f32 = [getattr(ck, n).launches for n in names]
    att.fit(xa, ya)
    assert [getattr(ck, n).bf16.launches - b
            for n, b in zip(names, before)] == [2, 2, 2]
    out = att.output(xa)
    assert ck.flash_forward.bf16.launches == before[0] + 4
    assert [getattr(ck, n).launches for n in names] == f32
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_forward_on_the_card(cuda_device, mode):
    """``quantize_inference`` keeps int8 / float8_e4m3fn codes on the card,
    the codes equal the CPU's bit for bit, and the quantized LeNet's output
    through the conv kernel (2 launches a forward) equals the plain conv
    chain on the dequantized weights within the conv rule."""
    from deeplearning4j_tpu_torch.ops import quantize as qz
    net = lenet(device=cuda_device).init(
        generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(6).random(
        (16, 1, 28, 28), np.float32)).to(cuda_device)
    net.quantize_inference(mode)
    before = ck.fused_conv2d_bias_act.launches
    out = net.output(x)
    assert ck.fused_conv2d_bias_act.launches == before + 2
    want = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    for lp, dense in zip(net._q_params, net.net_params):
        for k, leaf in lp.items():
            if qz.is_qleaf(leaf):
                assert leaf["q"].dtype == want and leaf["q"].is_cuda
                cpu = qz.quantize_weight(dense[k].cpu(), mode)
                assert torch.equal(leaf["q"].cpu().view(torch.uint8),
                                   cpu["q"].view(torch.uint8))
                assert torch.equal(leaf["s"].cpu(), cpu["s"])
    plain = MultiLayerNetwork(net.conf, device=cuda_device)
    plain.net_params = qz.dequantize_params(net._q_params)
    plain.net_state = net.net_state
    with ck.full_f32_convs():
        h = x
        for i, layer in enumerate(plain.layers):
            if i in plain.conf.preprocessors:
                h, _ = plain.conf.preprocessors[i](h)
            p = plain.net_params[i]
            if isinstance(layer, L.ConvolutionLayer):
                h = ck.conv2d_bias_act_reference(
                    h, p["W"], p["b"], tuple(layer.padding),
                    layer.convolution_mode, layer.activation)
            else:
                h, _, _ = layer.forward(p, {}, h)
    torch.testing.assert_close(out, h, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_checkpointed_step_on_the_card(cuda_device):
    """A LeNet step with ``gradient_checkpointing`` launches the conv kernel
    twice a conv (forward and recompute), makes the same conv backwards,
    and equals the plain step's updates within the training-step rule
    (5e-4 relative 2-norm) from the same state."""
    rng = np.random.default_rng(7)
    x = rng.random((64, 1, 28, 28), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    nets = []
    for remat in (False, True):
        net = lenet(device=cuda_device).init(
            generator=torch.Generator().manual_seed(5))
        net.conf.global_conf.gradient_checkpointing = remat
        conv, bw = ck.fused_conv2d_bias_act.launches, \
            ck._ConvBiasAct.backwards
        net.fit(x, y)
        torch.cuda.synchronize()
        nets.append((net, ck.fused_conv2d_bias_act.launches - conv,
                     ck._ConvBiasAct.backwards - bw))
    (plain, conv_p, bw_p), (remat, conv_r, bw_r) = nets
    assert (conv_p, conv_r, bw_p, bw_r) == (2, 4, 2, 2)
    start = lenet(device=cuda_device).init(
        generator=torch.Generator().manual_seed(5))
    for lp, lr, l0 in zip(plain.net_params, remat.net_params,
                          start.net_params):
        for k in lp:
            err = torch.linalg.vector_norm(lr[k] - lp[k]) / \
                torch.linalg.vector_norm(lp[k] - l0[k])
            assert float(err) <= 5e-4, (k, float(err))


@pytest.mark.gpu
def test_decode_pool_keeps_carries_on_the_card_and_launches_lstm(
        cuda_device):
    """A CUDA ``DecodePool`` serving three char-RNN sessions keeps every
    carry leaf on the card, launches the LSTM step kernel once per layer
    and dispatch with no fallback, and each session's outputs equal a
    one-stream ``rnn_time_step`` on the same inputs (rtol = atol = 1e-5)."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.server.decode import DecodePool, tree_leaves
    V, T = 20, 6
    net = char_rnn(V, 64, 2, device=cuda_device).init(
        generator=torch.Generator().manual_seed(3))
    x = np.eye(V, dtype=np.float32)[
        np.random.default_rng(5).integers(0, V, (3, T))]
    fallbacks = monitor.get_registry().counter(
        "dl4j_kernel_fallback_total", "ops that took the dense torch chain",
        labels=("op",)).labels(op="lstm_step")
    pool = DecodePool(net, max_slots=4, max_wait_ms=0.5)
    try:
        sids = [pool.open_session() for _ in range(3)]
        launches, fb = ck.fused_lstm_step.launches, fallbacks.value
        outs = [[] for _ in sids]
        for t in range(T):
            futs = [pool.submit_step(s, x[i, t:t + 1])
                    for i, s in enumerate(sids)]
            for i, f in enumerate(futs):
                outs[i].append(f.result(60)[0])
        assert all(leaf.is_cuda for leaf in tree_leaves(pool._pool))
        assert ck.fused_lstm_step.launches - launches == \
            2 * pool.stats()["batches"]
        assert fallbacks.value == fb
    finally:
        pool.stop()
    for i in range(3):
        net.rnn_clear_previous_state()
        ref = torch.cat([net.rnn_time_step(x[i:i + 1, t:t + 1])[0]
                         for t in range(T)]).cpu()
        torch.testing.assert_close(torch.from_numpy(np.concatenate(outs[i])),
                                   ref, rtol=1e-5, atol=1e-5)
