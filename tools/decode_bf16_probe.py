#!/usr/bin/env python3
"""Where the bf16 char-RNN's served decode parts from ``rnn_time_step``,
on one GPU.

    python3 tools/decode_bf16_probe.py [--repeats N]

Trains the f32 and bf16 char-RNNs as ``chip_smoke.py`` does, then holds
32 streams of 50 one-hot tokens (``phase_decode_charrnn``'s bf16 seed)
against their reference, ``rnn_time_step`` of each stream alone fed its
tokens in one call, in four settings:

* ``http``: the decode pool served over HTTP as ``phase_decode_charrnn``
  serves it, the clients as threads of the server's process
  (``processes=0``) and as four client processes, ``--repeats`` times
  each, alternating;
* ``pool``: the ``DecodePool`` alone, 32 client threads, no HTTP;
* ``batch``: no pool: the 32 streams in groups of b rows, one token a
  ``rnn_time_step`` call, for each b of the slot ladder and a few b off
  it (what batch shape alone does to the arithmetic);
* ``chunk``: one stream, one token a call, against the same tokens in
  one call (what the chunk length alone does);
* ``cause``: for groups of 1 and of 2 rows, the worst stream's group
  replayed one token a step through the network's own forward with every
  layer's output kept, beside the one-call reference: at each step
  whether each LSTM layer's output is bit-equal, the steps whose outputs
  differ, and at the first of them the output layer's pre-activations
  (``h2 @ W + b``, bf16) computed at the row count of each run, in bf16
  ulps.

For each it prints one JSON line: the worst stream's relative 2-norm, the
relative 2-norm over every stream together, the max |diff|, the streams
that differ at all, and for the worst stream its first differing step,
the largest difference there in units of the bf16 ulp of the reference
value, and the mean joined batch of the served runs.  The outputs of a
bf16 model are bf16 values widened to f32, so a one-ulp flip shows as a
difference of exactly one ulp.
"""

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repo's phases and helpers)


def _ulps(diff, ref):
    """|diff| in units of the bf16 ulp of |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(diff) / ulp


def _held(pairs):
    """[(served [T, V], reference [T, V])] -> the readings of one run."""
    rel = [float(np.linalg.norm(g - r) / np.linalg.norm(r))
           for g, r in pairs]
    got = np.concatenate([g for g, _ in pairs])
    ref = np.concatenate([r for _, r in pairs])
    w = int(np.argmax(rel))
    g, r = pairs[w]
    bad = np.nonzero(np.any(g != r, axis=-1))[0]
    first = None
    if len(bad):
        t = int(bad[0])
        first = {"step": t, "of": len(g),
                 "max_abs": float(np.abs(g[t] - r[t]).max()),
                 "max_ulps": float(_ulps(g[t] - r[t], r[t]).max()),
                 "entries_differing": int(np.sum(g[t] != r[t]))}
    return {"streams": len(pairs), "worst_stream": w,
            "worst_stream_steps_differing": int(len(bad)),
            "streams_differing": int(sum(x > 0 for x in rel)),
            "worst_stream_rel": max(rel),
            "rel_all": float(np.linalg.norm(got - ref)
                             / np.linalg.norm(ref)),
            "max_abs": float(np.abs(got - ref).max()),
            "worst_stream_first_divergence": first}


def _forward_acts(torch, net, x, state=None):
    """One forward of the bf16 network as ``rnn_time_step`` runs it, from
    ``state`` (fresh when None), keeping every layer's output -> (output,
    [layer outputs], new state)."""
    policy = net._policy()
    base = [{k: v for k, v in s.items() if k != "rnn_state"}
            for s in net.net_state]
    if state is not None:
        base = [dict(b, rnn_state=c) if c is not None else b
                for b, c in zip(base, state)]
    acts = []
    with torch.no_grad():
        pc, xc = policy.cast_to_compute(
            (net.net_params, torch.from_numpy(x).to(net.device)))
        out, ns, _ = net._forward(pc, base, xc, None, stateful_rnn=True,
                                  acts=acts)
    return out, acts, [n.get("rnn_state") if isinstance(n, dict) else None
                       for n in ns]


def _cause(torch, net, toks, eye, b, batch_outs):
    """The worst stream of the groups of ``b`` rows, replayed a token a
    step with every layer's output kept, against the one-call reference
    (see the module docstring)."""
    w = batch_outs["worst_stream"]
    g0 = w - w % b
    rows = toks[g0:g0 + b]
    r = w - g0
    ref_out, ref_acts, _ = _forward_acts(torch, net, eye[toks[w]][None])
    T = toks.shape[1]
    state, outs, acts = None, [], []
    for t in range(T):
        o, a, state = _forward_acts(torch, net, eye[rows[:, t]][:, None],
                                    state)
        outs.append(o[:, 0])
        acts.append(a)                           # [b, 1, width] a layer
    out = torch.stack([o[r] for o in outs])
    ref = ref_out[0]
    differ = [t for t in range(T) if not torch.equal(out[t], ref[t])]
    hidden = len(ref_acts) - 1                   # the LSTM layers
    res = {"rows": b, "stream": int(w), "steps_differing": differ,
           "replay_equals_batch_run": bool(np.array_equal(
               out.float().cpu().numpy(), batch_outs["got"][w]))}
    for li in range(hidden):
        res[f"lstm{li}_steps_differing"] = [
            t for t in range(T)
            if not torch.equal(acts[t][li][r, 0], ref_acts[li][0, t])]
    if differ:
        t = differ[0]
        head = net.layers[-1]
        pc = net._policy().cast_to_compute(net.net_params[-1])
        h = acts[t][hidden - 1]                  # the head's input, b rows
        with torch.no_grad():
            z_b = head.preoutput(pc, h)[r, 0]            # b rows
            z_one = head.preoutput(pc, h[r:r + 1])[0, 0]  # one row
            z_ref = head.preoutput(pc, ref_acts[hidden - 1])[0, t]  # T rows
        zb, z1, zr = (z.float().cpu().numpy() for z in (z_b, z_one, z_ref))
        res["first_step"] = t
        res["head_input_equal"] = bool(torch.equal(
            h[r, 0], ref_acts[hidden - 1][0, t]))
        for name, z in (("preout_rows_b", zb), ("preout_one_row", z1)):
            res[name + "_vs_reference"] = {
                "entries_differing": int(np.sum(z != zr)),
                "max_ulps": float(_ulps(z - zr, zr).max()),
                "max_abs": float(np.abs(z - zr).max())}
        res["largest_preout"] = float(np.abs(zr).max())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.nn.serialization import (load_model,
                                                           write_model)
    from deeplearning4j_tpu_torch.server.decode import DecodePool
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    ck.build_libraries()
    cs.emit("build", seconds=time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = False
    train_char, _, it = cs.phase_train_charrnn(torch, ck)
    _, bnet, _ = cs.phase_train_charrnn_bf16(torch, ck, train_char)
    S, T, V = cs.DECODE_SESSIONS, cs.DECODE_BF16_STEPS, it.vocab_size
    eye = np.eye(V, dtype=np.float32)
    toks = np.random.default_rng(cs.SEED + 41).integers(0, V, (S, T))

    def one_call(tok):
        bnet.rnn_clear_previous_state()
        out = bnet.rnn_time_step(eye[tok][None])[0].float().cpu().numpy()
        bnet.rnn_clear_previous_state()
        return out
    refs = [one_call(t) for t in toks]

    ok = True
    for rep in range(args.repeats):
        for procs in (0, 4):
            res, streams = cs._decode_streams_over_http(
                torch, ck, bnet, it, S, T, cs.SEED + 41, "lstm_step_bf16",
                processes=procs)
            pairs = [(np.asarray(g, np.float32), one_call(tok))
                     for tok, g in streams]
            cs.emit("probe_http", repeat=rep, client_processes=procs,
                    mean_joined_batch=res["mean_joined_batch"],
                    batch_size_hist=res["batch_size_hist"],
                    launches=res["launches"]["lstm_step_bf16"],
                    **_held(pairs))

    path = str(Path(tempfile.mkdtemp(prefix="bf16probe_")) / "c.zip")
    write_model(bnet, path)
    for rep in range(args.repeats):
        pool = DecodePool(load_model(path, device="cuda"), max_slots=S,
                          max_wait_ms=2.0)
        outs = [None] * S
        try:
            sids = [pool.open_session() for _ in range(S)]

            def client(i):
                outs[i] = np.concatenate(
                    [pool.step(sids[i], eye[toks[i, t]][None],
                               timeout=120)[0] for t in range(T)])
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(S)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            st = pool.stats()
        finally:
            pool.stop()
        if any(o is None for o in outs):
            ok = False
            continue
        cs.emit("probe_pool", repeat=rep,
                mean_joined_batch=st["steps_per_batch_mean"],
                **_held(list(zip(outs, refs))))

    by_rows = {}
    for b in (1, 2, 3, 4, 7, 8, 16, 29, 32):
        got = [None] * S
        for g0 in range(0, S, b):
            rows = toks[g0:g0 + b]
            bnet.rnn_clear_previous_state()
            steps = [bnet.rnn_time_step(eye[rows[:, t]][:, None])
                     .float().cpu().numpy() for t in range(T)]
            bnet.rnn_clear_previous_state()
            seq = np.concatenate(steps, axis=1)
            for i in range(len(rows)):
                got[g0 + i] = seq[i]
        held = _held(list(zip(got, refs)))
        by_rows[b] = dict(held, got=got)
        cs.emit("probe_batch", rows=b, **held)
    for b in (1, 2):
        if by_rows[b]["streams_differing"]:
            cs.emit("probe_cause", **_cause(torch, bnet, toks, eye, b,
                                            by_rows[b]))

    bnet.rnn_clear_previous_state()
    per_token = np.concatenate(
        [bnet.rnn_time_step(eye[toks[0, t]][None, None])[0]
         .float().cpu().numpy() for t in range(T)])
    bnet.rnn_clear_previous_state()
    cs.emit("probe_chunk", **_held([(per_token, refs[0])]))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
