#!/usr/bin/env python3
"""The spread a one-ulp flip of the bf16 conv makes, measured on the CPU at
small width: the source of chip_smoke.py's bf16 rules.

    python tools/bf16_rule_probe.py [--seeds 3] [--out probe.json]
    python tools/bf16_rule_probe.py --full-width [--states calibrated,seeded]

On the card the conv kernel's bf16 form and its plain version round two f32
sums of the same products, taken in different orders, to bf16; where the
sum lies near a rounding boundary the two land one bf16 ulp apart.  This
script emulates that on the CPU: an "emulated kernel" conv computes the
plain version's function with the sum taken in the kernel's order (the K
index c*KH*KW + tap in slices of at most 64, here whole channels: each
slice's partial sum apart, the partials added one after another in f32) and
rounds once, with the plain version's gradient (the kernel's backward is the
plain version's).
Then:

1. ``conv``: the emulated kernel against the plain version, element by
   element (chip_smoke.bf16_conv_compare), at the distinct stride-1 conv
   shapes of VGG16, ResNet-50 and the text CNN at full channel counts (so K
   is the real one) on 8x8 maps (7x7 for ResNet-50's) and 2 rows.
2. ``vgg``: VGG16's 13 convs and 5 pools at a quarter of the width (16-128
   channels), 64x64 inputs, fc 256 with dropout 0.5 (4,096 elements a
   dropout, the kernel's gate), 1,000 classes, Nesterovs lr 0.01, batch
   16: two bf16 steps, then a third through the emulated kernel held to
   chip_smoke's plain bf16 step (max-pool argmax pinned) and to the f32
   step from the same state (cosine of the update), as chip_smoke.py
   compares its third step.  ``at_init`` is the same comparison at the
   first step, reported only: a batch-norm ResNet at its random initial
   params is chaotic (its gradient grows toward the stem, and f32 against
   f64 already differs), and bf16's roundoff, 2^15 times f32's, leaves the
   update's direction to that chaos there.
3. ``resnet``: ResNet-50's depth (stages of 3, 4, 6 and 3 bottlenecks; 53
   convs, 53 batch norms) at a quarter of the width (bottlenecks of 16-128,
   64-512 out; K up to 1,152, 18 slices), 64x64 inputs, 1,000 classes,
   calibrated as ``chip_smoke.seeded_resnet50``, batch 8: as 2, with relu
   masks pinned too, plus batch norm's running statistics and the BN-fed
   conv biases' updates over their weights' and over the plain step's
   (apart from the others, as chip_smoke holds them).  ``resnet_<state>_step4`` is the same at the
   fourth step, as chip_smoke compares ResNet-50's, from each of
   :data:`STATES`: ``calibrated``; ``centred`` (the same function, the
   batch means taken away in the conv biases); ``seeded`` (only the output
   bias calibrated: chip_smoke's bf16 phases' net); ``init`` (the engine's
   initializer).
4. each net's bf16 ``output()`` probabilities against the f32 net's
   (relative 2-norm; the same of the log-probabilities less each row's
   mean; top-1 agreement), VGG's at 8 rows from its initial params,
   ResNet's at 32 fresh rows from the state's.

With ``--model charrnn`` or ``--model attention`` it measures the bf16
sequence models instead, the source of the rules of chip_smoke.py's
``train_charrnn_bf16``, ``sample_charrnn_bf16``, ``train_attention_bf16``,
``output_attention_bf16`` and ``sample_attention_bf16``:

5. ``charrnn``: ``char_rnn`` at a quarter of its width (2 x GravesLSTM(48),
   the multiple of 8 the kernel takes),
   batch 8, sequences of 1,000 characters of SURVEY.md, TBPTT 50, RMSProp
   at the recipe's lr, trained in bf16 for 3 minibatches (60 segments, as
   chip_smoke trains it); then one segment from that state through the
   plain bf16 step, through the lstm kernel's emulation (the plain step
   with the recurrent product summed in the kernel's order: 8 ranges of k,
   the partial sums added to zx one after another, each element of z then
   moved by an f32 rounding at random; the same arithmetic otherwise, so
   it is also the step with its sums reordered) and in f32:
   the score, each param's update (relative 2-norm) and the cosine of the
   whole update with the f32 step's.  Then ``rnn_time_step`` fed one
   character at a time against ``output()`` on 4 rows of 50, and
   ``output()`` against itself through the emulated kernel (relative
   2-norm of the probabilities).  ``charrnn_full_width`` is the same at the
   recipe's widths (2 x 200 units, batch 32): the char-RNN is small enough
   to train on the CPU, and there a rounding flip of the reordered sum is
   as likely per element as on the card and 17 times as many elements
   can flip.
6. ``attention``: ``attention_lm`` at a quarter of its width (128 wide, 2
   heads of 64, 2 layers), batch 2: one Adam step at T = 512 from
   chip_smoke's ``_attention_step_vs_plain`` state (Wq, Wk times
   ATT_PEAK_QK, layer 0's Wv, Wo times ATT_SPREAD_V) through the plain bf16
   flash versions, through the kernels' emulation (P and dS fed as bf16 hi
   + lo pairs, every product summed over blocks of the kernels' tiles) and
   through the plain versions with only their sums reordered that way, and
   in f32: score, gradients and updates but the key bias's (relative
   2-norm), the f32 cosine; then 3 bf16 ``fit`` steps at T = 2,048 and
   ``output()`` against the f32 network's on the same params, the KV ring
   against ``output()`` on a 300-character prefix, and ``output()`` against
   itself through the emulated kernels.

With ``--full-width`` it runs only 3's fourth-step case, ResNet-50 at its
published widths on the card (batch 128, 224x224, TF32 off, cuDNN
deterministic), one seed, in each of ``--states``: the plain bf16 step
against itself with the conv summed in the kernel's order, no conv kernel
in either, so the spread it reads is bf16's own at that state.

Each measure is the largest over ``--seeds`` seeds.  chip_smoke.py's rules
are twice these (the numbers and the rules are in its constants' comment
and in PERF.md).  Runs in a minute or two on a few CPU threads.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.datasets import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.models import resnet as resnet_mod  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as L  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: E402
    GlobalConf, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from deeplearning4j_tpu_torch.ops import dtypes  # noqa: E402
from deeplearning4j_tpu_torch.ops import helpers  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
BF = torch.bfloat16


def reordered_conv(x, w, b, pad=(0, 0), border_mode="truncate",
                   activation="identity"):
    """chip_smoke.reordered_conv: the plain version summed in the kernel's
    order."""
    return CS.reordered_conv(ck, x, w, b, pad, border_mode, activation)


@contextmanager
def emulated_kernel():
    """Within the block the layers' convs that the conv kernel takes give
    :func:`reordered_conv`'s value with the plain version's gradient, as
    the kernel's bf16 form would on the card."""
    original = helpers.conv2d_bias_act

    def conv(x, w, b, stride=(1, 1), pad=(0, 0), dilation=(1, 1),
             border_mode="truncate", activation="identity"):
        act = (activation or "identity").lower()
        if not ck.conv_fused_supported(x.shape, w.shape, x.dtype, stride,
                                       dilation, act, pad, border_mode):
            return original(x, w, b, stride, pad, dilation, border_mode,
                            activation)
        y = ck.conv2d_bias_act_reference(x, w, b, pad, border_mode, act)
        y_r = reordered_conv(x.detach(), w.detach(), b.detach(), pad,
                             border_mode, act)
        return y + (y_r - y).detach()
    with mock.patch.object(helpers, "conv2d_bias_act", conv):
        yield


def conv_case(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    shapes = set()
    for model in ("vgg16_224", "resnet50"):
        for s in CS.conv_shapes(model, 2):
            hw = 7 if model == "resnet50" else 8
            shapes.add((2, s[1], hw, hw, s[4], s[5], s[6], s[7]))
    shapes |= {(2, 1, 64, CS.TEXTCNN_D, CS.TEXTCNN_MAPS, (h, CS.TEXTCNN_D),
                0, "relu") for h in CS.TEXTCNN_HEIGHTS}
    worst = {"share_differ": 0.0, "share_beyond_one_ulp": 0.0,
             "max_excess": 0.0}
    elements = 0
    for N, Cin, H, W, Cout, K, p, act in sorted(shapes, key=str):
        KH, KW = (K, K) if isinstance(K, int) else K
        x = torch.randn((N, Cin, H, W), generator=gen).to(BF)
        w = (torch.randn((Cout, Cin, KH, KW), generator=gen)
             * (2.0 / (Cin * KH * KW)) ** 0.5).to(BF)
        b = (torch.randn((Cout,), generator=gen) * 0.1).to(BF)
        ref = ck.conv2d_bias_act_reference(x, w, b, (p, p), "truncate", act)
        got = reordered_conv(x, w, b, (p, p), "truncate", act)
        r = CS.bf16_conv_compare(torch, got, ref)
        elements += r["elements"]
        for k in worst:
            worst[k] = max(worst[k], r[k])
    worst.update(shapes=len(shapes), elements=elements)
    return worst


def thin_vgg():
    b = (NeuralNetConfiguration.builder().seed(12345).learning_rate(0.01)
         .updater("nesterovs").weight_init("relu").precision("bfloat16")
         .list())
    for n_convs, ch in [(2, 16), (2, 32), (3, 64), (3, 128), (3, 128)]:
        for _ in range(n_convs):
            b.layer(L.ConvolutionLayer(n_out=ch, kernel=(3, 3),
                                       padding=(1, 1), activation="relu"))
        b.layer(L.SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                   stride=(2, 2)))
    b.layer(L.DenseLayer(n_out=256, activation="relu", dropout=0.5))
    b.layer(L.DenseLayer(n_out=256, activation="relu", dropout=0.5))
    b.layer(L.OutputLayer(n_out=1000, activation="softmax", loss="mcxent"))
    conf = b.set_input_type(InputType.convolutional(64, 64, 3)).build()
    return MultiLayerNetwork(conf, device="cpu")


STATES = ("calibrated", "centred", "seeded", "zero_gamma", "init")


def calibrate(net, seed: int, batch_norms: str = "beta"):
    """``chip_smoke.seeded_resnet50``'s params for graph ``net`` (any widths
    of ResNet-50's vertex names): ``chip_smoke.resnet_weights``, then each
    batch norm's gamma and beta set so that, on the init's running
    statistics, it normalizes a seeded batch of 32 as its batch statistics
    would (``batch_norms`` "beta", seeded_resnet50's default), and the
    output bias takes away the batch's mean of ``W h``.  ``batch_norms``
    "conv_bias" takes the batch mean away in the feeding conv's bias, not
    in beta (the same function, its conv outputs centred); "none" leaves
    the batch norms as resnet_weights made them (seeded_resnet50 without
    ``batch_norms``)."""
    net.load_jax_params(CS.resnet_weights(net, seed)[0])
    inp, out = net.conf.network_inputs[0], net.conf.network_outputs[0]
    t = net.conf.input_types[0]
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(CS.RESNET_SERVE_BATCH, t.channels, t.height, t.width)).astype(
            np.float32)).to(net.device)
    zero = {n: {k: torch.zeros_like(v) for k, v in st.items()}
            for n, st in net.net_state.items()}
    with torch.no_grad():
        batch = net._forward_all(net.net_params, zero, {inp: x}, {},
                                 train=True)[2]
        for n, st in batch.items():
            if not st or batch_norms == "none":
                continue
            lc = net.conf.vertices[n].layer_conf()
            keep = 1 - lc.decay
            p, r = net.net_params[n], net.net_state[n]
            sd = torch.sqrt(st["var"] / keep + lc.eps)
            r_sd = torch.sqrt(r["var"] + lc.eps)
            if batch_norms == "conv_bias":
                conv = net.net_params[net.conf.vertex_inputs[n][0]]
                conv["b"].sub_(st["mean"] / keep)
                p["beta"].add_(p["gamma"] * r["mean"] / sd)
            else:
                p["beta"].sub_(p["gamma"] * (st["mean"] / keep - r["mean"])
                               / sd)
            p["gamma"].mul_(r_sd / sd)
        z = net._forward_all(net.net_params, net.net_state, {inp: x}, {},
                             train=False, preout_for=[out])[1][out]
        b = net.net_params[out]["b"]
        b.sub_(z.mean(dim=0) - b)
    return net


def resnet_net(seed: int, state: str, full: bool, device: str):
    """ResNet-50 in bf16: at its published widths (``full``) or at a
    quarter of them (bottlenecks of 16-128, 64-512 out, K up to 1,152, 18
    slices; 64x64 inputs), in one of three states: ``calibrated`` (as
    chip_smoke.seeded_resnet50), ``centred`` (calibrated, the batch means
    taken away in the conv biases), ``seeded`` (only the output bias
    calibrated, as chip_smoke's bf16 phases take it) or ``init`` (the
    engine's own initializer from the seed)."""
    if full:
        from deeplearning4j_tpu_torch.models import resnet50
        net = resnet50(device=device)
    else:
        g = GlobalConf(seed=12345, learning_rate=0.1, updater="nesterovs",
                       weight_init="relu")
        b = GraphBuilder(g).add_inputs("in")
        x = resnet_mod._conv_bn(b, "stem", "in", 16, (7, 7), (2, 2),
                                padding=(3, 3))
        b.add_layer("stem_pool", L.SubsamplingLayer(
            pooling_type="max", kernel=(3, 3), stride=(2, 2),
            padding=(1, 1)), x)
        x = "stem_pool"
        for si, (n_blocks, ch) in enumerate(zip((3, 4, 6, 3),
                                                (16, 32, 64, 128))):
            for bi in range(n_blocks):
                stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
                x = resnet_mod._bottleneck(b, f"s{si}b{bi}", x, ch, stride,
                                           project=(bi == 0))
        net = resnet_mod._head(b, x, 64, 64, 3, 1000, device)
    net.init(generator=torch.Generator().manual_seed(seed))
    net.conf.global_conf.precision = "bfloat16"
    if state == "init":
        return net
    net = calibrate(net, seed, {"calibrated": "beta", "centred": "conv_bias",
                                "seeded": "none", "zero_gamma": "none"}[state])
    if state == "zero_gamma":
        for n in net.order:
            if n.endswith("_c_bn"):
                net.net_params[n]["gamma"].zero_()
    return net


def _snapshot(net, ds):
    gen = net._generator.get_state()
    snap = {"params": CS._clone_tree(net.net_params),
            "opt": CS._clone_tree(net.opt_states),
            "states": CS._clone_tree(net.net_state), "it": net.iteration,
            "seeds": net._draw_seeds().tolist(), "batch": ds}
    net._generator.set_state(gen)
    return snap


def vgg_case(seed: int, before: int = 0) -> dict:
    net = thin_vgg().init(generator=torch.Generator().manual_seed(seed))
    x, y = CS._random_batch(np.random.default_rng(seed), 16, (3, 64, 64),
                            1000)
    ds = DataSet(torch.from_numpy(x), torch.from_numpy(y))
    net.opt_states = net._init_opt_states()
    with emulated_kernel():
        for _ in range(before):
            net._fit_batch(ds)
        snap = _snapshot(net, ds)
        with CS._RecordedOutputs(net) as rec:
            net._fit_batch(ds, snap["seeds"])
    kernel_score = net.score()
    plain_score, plain_params, _, _, ties = CS._plain_train_step(
        torch, ck, net, snap["params"], CS._clone_tree(snap["opt"]),
        ds.features, ds.labels, snap["seeds"], snap["it"],
        kernel_outputs=rec.outputs, policy=dtypes.BF16)
    errs = CS._update_errs(torch, net, plain_params, snap["params"])
    cos = CS._f32_step_cosine(torch, net, snap, net.net_params)
    net.net_params = snap["params"]
    out = net.output(x[:8])
    return {"score_rel_diff": abs(plain_score - kernel_score)
            / abs(plain_score),
            "max_update_rel_err": max(errs.values()),
            "max_tie_gap": max(t["max_rel_gap"] for t in ties),
            "cosine_vs_f32": cos["cosine"],
            **CS._probs_vs_f32(torch, net, torch.from_numpy(x[:8]), out)}


def resnet_case(seed: int, before: int = 0, state: str = "calibrated",
                full: bool = False, device: str = "cpu") -> dict:
    """``before`` bf16 steps through the emulated kernel, then one more
    held to chip_smoke's plain bf16 graph step (relu masks and max-pool
    argmax pinned) and to the f32 step from the same state; on a fresh
    net in the same state, bf16 ``output()`` against f32's."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    net = resnet_net(seed, state, full, device)
    batch, hw = (CS.RESNET_TRAIN_BATCH, CS.RESNET_HW) if full else (8, 64)
    x, y = CS._random_batch(np.random.default_rng(seed + 1), batch,
                            (3, hw, hw), 1000)
    mds = MultiDataSet([torch.from_numpy(x).to(device)],
                       [torch.from_numpy(y).to(device)])
    net.opt_states = net._init_opt_states()
    out_name = net.conf.network_outputs[0]
    with emulated_kernel():
        for _ in range(before):
            net._fit_batch(mds)
        snap = _snapshot(net, mds)
        rec = CS._RecordedVertexOutputs(
            net, [n for n in net.order if n != out_name])
        with rec:
            net._fit_batch(mds, snap["seeds"])
    score, params, states, ties = CS._plain_graph_step(
        torch, ck, net, snap["params"], CS._clone_tree(snap["opt"]),
        list(mds.features), list(mds.labels), snap["it"], snap["states"],
        rec.outputs, policy=dtypes.BF16)
    del rec
    vs = CS._with_ties(CS._graph_step_vs(
        torch, net, snap["params"],
        (net.score(), net.net_params, net.net_state),
        (score, params, states)), ties)
    del params, states
    res = {k: vs[k] for k in ("score_rel_diff", "max_update_rel_err",
                              "max_bn_stats_rel_err",
                              "max_bn_fed_bias_update_over_w_update",
                              "max_bn_fed_bias_update_over_plain",
                              "max_tie_gap")}
    if full:
        res["worst_bn_fed_biases_step_and_plain"] = \
            vs["worst_bn_fed_biases_step_and_plain"]
    with emulated_kernel():
        cos = CS._f32_step_cosine(torch, net, snap, net.net_params)
    del net, snap
    served = resnet_net(seed, state, full, device)
    xo = torch.from_numpy(np.random.default_rng(seed + 7).normal(
        size=(CS.RESNET_SERVE_BATCH, 3, hw, hw)).astype(np.float32)).to(
            device)
    with emulated_kernel():
        out = served.output(xo)[0]
        return {**res, "cosine_vs_f32": cos["cosine"],
                **CS._probs_vs_f32(torch, served, xo, out)}


# ---------------------------------------------------------------------------
# the bf16 sequence models
# ---------------------------------------------------------------------------

_JITTER = torch.Generator().manual_seed(0)


def reordered_lstm_step(zx, h, c, rw, p3):
    """``ck.lstm_step_reference`` with h RW summed in the kernel's order
    (the k range in 8 parts of ceil(H / 8), each part's product apart, the
    parts added to zx one after another in f32), and then every element of
    z moved by one f32 ulp up, down or not at random; c' and h' rounded
    once.  Products of bf16 numbers are exact in f32 and their sums often
    are, so two orders of summing seldom differ (the order alone moved no
    update of a full-width segment on the CPU); the jitter gives every
    element the rounding that another order may give it, and so c' and h'
    as many bf16 rounding flips as sums of f32 numbers would."""
    dt = c.dtype
    zx, h, c, rw, p3 = (t.float() for t in (zx, h, c, rw, p3))
    H = h.shape[1]
    r = -(-H // 8)
    z = zx
    for k0 in range(0, H, r):
        z = z + h[:, k0:k0 + r] @ rw[k0:k0 + r]
    step = torch.randint(-1, 2, z.shape, generator=_JITTER).float()
    z = z + step * torch.ldexp(torch.ones_like(z),
                               torch.frexp(z)[1] - 24)
    zi, zf, zo, zc = z.chunk(4, dim=-1)
    i = torch.sigmoid(zi + c * p3[0])
    f = torch.sigmoid(zf + c * p3[1])
    g = torch.tanh(zc)
    c_new = f * c + i * g
    o = torch.sigmoid(zo + c_new * p3[2])
    return c_new.to(dt), (o * torch.tanh(c_new)).to(dt)


def emulated_lstm():
    """Within the block the lstm step's forward (on the CPU: its plain
    version) is :func:`reordered_lstm_step`; its backward stays."""
    return mock.patch.object(ck, "lstm_step_reference", reordered_lstm_step)


def _blocked(a, b, block):
    """a @ b with the contraction summed in blocks of ``block``, the
    blocks' products added one after another (the kernels' tile order)."""
    out = None
    for k0 in range(0, a.shape[-1], block):
        part = a[..., k0:k0 + block] @ b[..., k0:k0 + block, :]
        out = part if out is None else out + part
    return out


def _hi_lo(x):
    """x as the bf16 flash kernels feed it: hi = x to the nearest bf16, lo =
    x - hi to the nearest bf16, the pair's sum (exact in f32)."""
    hi = x.to(BF).float()
    return hi + (x - hi).to(BF).float()


def _flash_math(split):
    """The three flash plain versions with every product summed in the
    kernels' blocks and, with ``split``, P and dS fed as :func:`_hi_lo`
    pairs: the kernels' arithmetic (``split``) or the plain versions' sums
    reordered.  S and dP sum over 16 of D (one k16 product); the forward's
    P V and dQ's dS K over their steps of keys and dK/dV's products over
    its steps of queries (``ck.flash_bf16_plan``)."""
    sp = _hi_lo if split else (lambda x: x)

    def mm(a, b, block):
        return _blocked(a, b, block)

    def probs(q, k, key_mask, lse, causal, scale):
        s = mm(q, k.transpose(-1, -2), 16) * scale
        live = ck._flash_live(key_mask, q.shape[2], causal) & \
            (lse > ck.NEG_INF * 0.5)[..., None]
        return torch.exp(torch.where(live, s - lse[..., None],
                                     float("-inf")))

    def forward(q, k, v, key_mask, causal, scale):
        dt = q.dtype
        q, k, v = q.float(), k.float(), v.float()
        s = mm(q, k.transpose(-1, -2), 16) * scale
        s = s.masked_fill(~ck._flash_live(key_mask, q.shape[2], causal),
                          float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        row_live = m > float("-inf")
        p = torch.exp(s - torch.where(row_live, m, torch.zeros_like(m)))
        l = p.sum(dim=-1, keepdim=True)
        out = mm(sp(p), v, ck.flash_bf16_plan(q.shape[-1])["fwd_step"]) / \
            torch.where(row_live, l, torch.ones_like(l))
        lse = torch.where(row_live, m + torch.log(l),
                          torch.full_like(m, ck.NEG_INF))
        return out.to(dt), lse.squeeze(-1)

    def dq(q, k, v, key_mask, dout, lse, delta, causal, scale):
        dt = q.dtype
        q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
        p = probs(q, k, key_mask, lse, causal, scale)
        ds = p * (mm(dout, v.transpose(-1, -2), 16) - delta[..., None])
        step = ck.flash_bf16_plan(q.shape[-1])["dq_step"]
        return (mm(sp(ds), k, step) * scale).to(dt)

    def dkv(q, k, v, key_mask, dout, lse, delta, causal, scale):
        kt, vt = k.dtype, v.dtype
        q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
        p = probs(q, k, key_mask, lse, causal, scale)
        ds = p * (mm(dout, v.transpose(-1, -2), 16) - delta[..., None])
        step = ck.flash_bf16_plan(q.shape[-1])["dkv_step"]
        return ((mm(sp(ds).transpose(-1, -2), q, step) * scale).to(kt),
                mm(sp(p).transpose(-1, -2), dout, step).to(vt))
    return {"flash_forward": forward, "flash_dq": dq, "flash_dkv": dkv}


@contextmanager
def flash_math(split: bool):
    """Within the block the flash wrappers compute :func:`_flash_math`."""
    with contextlib.ExitStack() as stack:
        for name, fn in _flash_math(split).items():
            stack.enter_context(mock.patch.object(ck, name, fn))
        yield


INF_RULES = dict(score_rtol=float("inf"), update_rtol=float("inf"),
                 cosine_min=-1.0)


def _seq_readings(runs, p0, skip=()):
    """compare_seq_bf16's readings of the kernel run against the plain and
    the f32 runs, rules off."""
    cmp = CS.compare_seq_bf16(torch, runs, p0, grad_rtol=float("inf"),
                              skip=skip, **INF_RULES)
    return {"score_rel_diff": cmp["vs_plain"]["score_rel_diff"],
            "max_grad_rel_err": cmp["vs_plain"]["max_grad_rel_err"],
            "max_update_rel_err": cmp["vs_plain"]["max_update_rel_err"],
            "f32_update_cosine": cmp["f32_update_cosine"],
            "f32_score_rel_diff": cmp["vs_f32"]["score_rel_diff"]}


def _no_ctx():
    return contextlib.nullcontext()


# A quarter of the char-RNN's 200 units, to the multiple of 8 the lstm
# kernel's gate takes.
CHAR_PROBE_HIDDEN = 48


def charrnn_case(seed: int, full: bool = False) -> dict:
    from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn
    hidden, batch = (CS.CHAR_HIDDEN, CS.CHAR_BATCH) if full else \
        (CHAR_PROBE_HIDDEN, 8)
    it = CharacterIterator((ROOT / "SURVEY.md").read_text(),
                           seq_length=CS.CHAR_SEQ, batch=batch, seed=seed)
    net = char_rnn(it.vocab_size, hidden, CS.CHAR_LAYERS,
                   tbptt_length=CS.CHAR_TBPTT, device="cpu").init(
        generator=torch.Generator().manual_seed(seed))
    net.conf.global_conf.precision = "bfloat16"
    for _ in range(CS.CHAR_BF16_MINIBATCHES):
        net.fit(it.next())
    ds = it.next()
    x = torch.from_numpy(ds.features[:, :CS.CHAR_TBPTT])
    y = torch.from_numpy(ds.labels[:, :CS.CHAR_TBPTT])
    start = (CS._clone_tree(net.net_params), CS._clone_tree(net.opt_states),
             CS._clone_tree(net.net_state), net.iteration)
    runs = CS._seq_step_runs(torch, ck, net, x, y, start, CS.seq_bf16_modes(
        _no_ctx, kernel_ctx=emulated_lstm))
    res = _seq_readings(runs, start[0])
    xs = ds.features[:4, :CS.CHAR_TBPTT]
    full = net.output(xs)
    net.rnn_clear_previous_state()
    steps = torch.cat([net.rnn_time_step(xs[:, t:t + 1])
                       for t in range(CS.CHAR_TBPTT)], dim=1)
    with emulated_lstm():
        emul = net.output(xs)
    res.update(sample_rel=CS._rel_norm(torch, steps, full),
               output_emulated_rel=CS._rel_norm(torch, emul, full))
    return res


def attention_case(seed: int) -> dict:
    from deeplearning4j_tpu_torch.models import CharacterIterator, attention_lm
    width, heads, T, Tfit = CS.ATT_WIDTH // 4, CS.ATT_HEADS // 4, 512, 2048
    text = (ROOT / "SURVEY.md").read_text()
    it = CharacterIterator(text, seq_length=T, batch=2, seed=seed)
    net = attention_lm(it.vocab_size, width, heads, CS.ATT_LAYERS, Tfit,
                       device="cpu").init(
        generator=torch.Generator().manual_seed(seed))
    net.conf.global_conf.precision = "bfloat16"
    ds = it.next()
    x, y = torch.from_numpy(ds.features), torch.from_numpy(ds.labels)
    begin, opt0 = CS._attention_start(net, CS._clone_tree(net.net_params))
    start = (begin, opt0, net.net_state, 0)
    modes = CS.seq_bf16_modes(_no_ctx, kernel_ctx=lambda: flash_math(True))
    runs = CS._seq_step_runs(torch, ck, net, x, y, start, modes)
    res = _seq_readings(runs, begin, skip=("bk",))
    modes["kernel"] = (lambda: flash_math(False), "bfloat16")
    runs = CS._seq_step_runs(torch, ck, net, x, y, start, modes)
    res.update({f"witness_{k}": v for k, v in
                _seq_readings(runs, begin, skip=("bk",)).items()
                if not k.startswith("f32")})
    fit_it = CharacterIterator(text, seq_length=Tfit, batch=2, seed=seed)
    for _ in range(CS.ATT_BF16_STEPS):
        net.fit(fit_it.next())
    xo = torch.from_numpy(fit_it.next().features)
    out = net.output(xo)
    with flash_math(True):
        emul = net.output(xo)
    g = net.conf.global_conf
    g.precision = None
    f32 = net.output(xo)
    g.precision = "bfloat16"
    V = it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, V, (4, 300))
    net.rnn_clear_previous_state()
    steps = torch.cat([net.rnn_time_step(eye[prefix[:, t:t + 1]])
                       for t in range(prefix.shape[1])], dim=1)
    full = net.output(eye[prefix])
    res.update(probs_vs_f32_rel=CS._rel_norm(torch, out, f32),
               output_emulated_rel=CS._rel_norm(torch, emul, out),
               sample_rel=CS._rel_norm(torch, steps, full))
    return res


def _worst(cases):
    """Per key, the largest value over the cases (the smallest cosine)."""
    out = {}
    for k in cases[0]:
        vals = [c[k] for c in cases]
        if isinstance(vals[0], dict):
            continue
        out[k] = min(vals) if "cosine" in k or k.startswith("top1") else \
            max(vals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--full-width", action="store_true",
                    help="ResNet-50 at its published widths on the card, "
                         "one seed, in each of --states")
    ap.add_argument("--states", default=",".join(STATES))
    ap.add_argument("--before", default="3",
                    help="with --full-width: the steps before the one "
                         "compared, one count for each of --states")
    ap.add_argument("--model", default="cnn",
                    choices=("cnn", "charrnn", "attention"),
                    help="the conv networks (1-4), the char-RNN (5) or the "
                         "attention model (6)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = {}
    if args.model != "cnn":
        torch.set_num_threads(min(4, torch.get_num_threads()))
        seeds = [CS.SEED + i for i in range(args.seeds)]
        runs = [(args.model, {"charrnn": charrnn_case,
                              "attention": attention_case}[args.model], {})]
        if args.model == "charrnn":
            runs.append(("charrnn_full_width", charrnn_case, {"full": True}))
    elif args.full_width:
        for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
            flags.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        seeds = [CS.SEED]
        states = args.states.split(",")
        befores = [int(b) for b in args.before.split(",")]
        befores += befores[-1:] * (len(states) - len(befores))
        runs = [(f"resnet50_{st}_step{b + 1}", resnet_case,
                 {"before": b, "state": st, "full": True, "device": "cuda"})
                for st, b in zip(states, befores)]
    else:
        torch.set_num_threads(min(4, torch.get_num_threads()))
        seeds = [CS.SEED + i for i in range(args.seeds)]
        runs = [("conv", conv_case, {}), ("vgg", vgg_case, {"before": 2}),
                ("resnet", resnet_case, {"before": 2}),
                ("vgg_at_init", vgg_case, {}),
                ("resnet_at_init", resnet_case, {})]
        runs += [(f"resnet_{st}_step4", resnet_case,
                  {"before": 3, "state": st})
                 for st in args.states.split(",")]
    for name, fn, kw in runs:
        cases = [fn(s, **kw) for s in seeds]
        res[name] = {"worst": _worst(cases), "cases": cases}
        print(json.dumps({name: res[name]["worst"]}), flush=True)
        if args.full_width:
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["device"] = torch.cuda.get_device_name(0) if args.full_width \
        else "cpu"
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"seconds": res["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
