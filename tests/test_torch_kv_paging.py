"""The port's paged KV arena (``parallel/sequence.attend_paged``,
``restore_paged``, the paged ``DecodePool``) and session migration between
the two packages' pools, on the CPU.

* ``attend_paged`` against the JAX package's on the same seeded inputs,
  with ring wraparound, a logical window shorter than the block-rounded
  one, masked pad tokens, an all-scratch pad row and the undo journal:
  outputs within 1e-6, positions, arena contents and journal equal.
* The paged pool against the dense pool (and JAX's paged pool) within
  1e-6, blocks freed on close, arena exhaustion shed retryably, block
  ownership disjoint after churn and while two pools and a micro-batcher
  step at once, a bf16 arena within 1e-6 of JAX's bf16 arena and within
  one bf16 rounding (relative 2-norm 2^-8) of the f32 dense pool.
* Migration JAX -> port and port -> JAX, dense and paged on either side,
  in the v2 binary and v1 JSON payloads: the migrated stream continues
  within 1e-6 of an unmigrated twin in the destination pool; a bf16 carry
  crosses bit for bit.
"""

import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import sequence as jax_seq
from deeplearning4j_tpu.server.decode import DecodePool as JaxPool
from deeplearning4j_tpu.server.decode import (
    _decode_carry_leaf as jax_decode_leaf)
from deeplearning4j_tpu_torch.parallel import sequence as seq
from deeplearning4j_tpu_torch.resilience.errors import OverloadedError
from deeplearning4j_tpu_torch.server import DecodePool
from deeplearning4j_tpu_torch.server.decode import _decode_carry_leaf

from test_torch_decode import (WAIT, jax_attention_mln, jax_lstm_mln,
                               port_of, tokens)
from deeplearning4j_tpu.nn import serialization as jax_ser

W, BS = 8, 4          # cache window, arena block: 2 blocks a window
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_FLIGHT_DIR", str(tmp_path / "flight"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pools():
    made = []
    yield made
    for p in made:
        p.stop()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX attention net of window 8, its zip; JAX char-RNN, its zip)."""
    d = tmp_path_factory.mktemp("paging_zips")
    out = {}
    for kind, jnet in (("attention", jax_attention_mln(seed=21, window=W)),
                       ("lstm", jax_lstm_mln(seed=9))):
        path = d / f"{kind}.zip"
        jax_ser.write_model(jnet, path)
        out[kind] = (jnet, str(path))
    return out


@pytest.fixture(scope="module")
def jax_pools(models):
    """Module-wide JAX pools (dense and paged attention, f32 and bf16
    char-RNN carries): their compiled steps are reused across cases."""
    jnet = models["attention"][0]
    lnet = models["lstm"][0]
    made = {"dense": JaxPool(jnet, name="jd", max_slots=4, max_wait_ms=0.5),
            "paged": JaxPool(jnet, name="jpg", max_slots=4, max_wait_ms=0.5,
                             kv_paged=True, kv_block=BS),
            "paged_bf16": JaxPool(jnet, name="jpb", max_slots=2,
                                  max_wait_ms=0.5, kv_paged=True,
                                  kv_block=BS, kv_dtype="bfloat16"),
            "bf16": JaxPool(lnet, name="jbf", max_slots=4, max_wait_ms=0.5,
                            carry_dtype="bfloat16")}
    yield made
    for p in made.values():
        p.stop()


def _paged(net, pools, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 0.5)
    pool = DecodePool(net, kv_paged=True, kv_block=BS, **kw)
    pools.append(pool)
    return pool


def _dense(net, pools, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 0.5)
    pool = DecodePool(net, **kw)
    pools.append(pool)
    return pool


def _ownership_ok(pool):
    """Every arena block is on the free list or held by exactly one live
    session, never both, never twice."""
    with pool._cond:
        for li, free in enumerate(pool._kv_free):
            held = [b for s in pool._sessions.values()
                    if s.kv_blocks is not None for b in s.kv_blocks[li]]
            assert len(set(free)) == len(free), "a block freed twice"
            assert len(set(held)) == len(held), "a block held twice"
            assert not set(free) & set(held), "a block held and free"
            assert set(free) | set(held) == \
                set(range(pool._arena_blocks[li]))


# ---------------------------------------------------------------------------
# attend_paged and the undo journal against JAX's
# ---------------------------------------------------------------------------

def _paged_inputs(seed=0):
    """B=3 streams, H=2, D=4, block 4, 3 blocks a stream (w_eff 12) and a
    logical window of 10; stream 0 wraps, stream 1 holds two blocks and
    the scratch block, stream 2 is an all-scratch pad row, fully masked."""
    rng = np.random.default_rng(seed)
    B, H, T, D, nb = 3, 2, 5, 4, 10
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    arena = {n: rng.normal(size=(nb + 1, H, BS, D)).astype(np.float32)
             for n in ("k", "v")}
    tbl = np.array([[2, 5, 7], [1, 3, nb], [nb, nb, nb]], np.int32)
    pos = np.array([9, 2, 0], np.int32)
    mask = np.array([[1, 1, 0, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                    np.float32)
    return q, k, v, arena, tbl, pos, mask


@pytest.mark.parametrize("undo", [False, True], ids=["plain", "undo"])
def test_attend_paged_matches_jax(undo):
    q, k, v, arena, tbl, pos, mask = _paged_inputs()
    want = jax_seq.attend_paged(
        *(jnp.asarray(a) for a in (q, k, v, pos, tbl)),
        {n: jnp.asarray(a) for n, a in arena.items()}, window=10,
        key_mask=jnp.asarray(mask), undo=undo)
    ar = {n: torch.from_numpy(a.copy()) for n, a in arena.items()}
    got = seq.attend_paged(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(pos).long(), torch.from_numpy(tbl).long(), ar,
        window=10, key_mask=torch.from_numpy(mask), undo=undo)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    assert got[1].tolist() == np.asarray(want[1]).tolist() == [13, 7, 0]
    for n in ("k", "v"):              # the arena is written in place
        np.testing.assert_array_equal(ar[n].numpy(),
                                      np.asarray(want[2][n]))
    if undo:
        for n in ("pb", "o", "k", "v"):
            np.testing.assert_array_equal(got[2][n].numpy(),
                                          np.asarray(want[3][n]))


def test_restore_paged_rolls_rejected_writes_back_bit_for_bit():
    """Rolling every step back restores the arena bit for bit; rolling
    back steps j >= accept[b] equals the JAX verify program's rollback
    (``where(j >= accept, old, current)`` scattered per layer)."""
    q, k, v, arena, tbl, pos, mask = _paged_inputs(seed=1)
    ar = {n: torch.from_numpy(a.copy()) for n, a in arena.items()}
    args = (*(torch.from_numpy(a) for a in (q, k, v)),
            torch.from_numpy(pos).long(), torch.from_numpy(tbl).long())
    _, _, journal = seq.attend_paged(*args, ar, window=10,
                                     key_mask=torch.from_numpy(mask),
                                     undo=True)
    written = {n: t.clone() for n, t in ar.items()}
    seq.restore_paged(ar, journal, torch.ones((5, 3), dtype=torch.bool))
    for n in ("k", "v"):
        np.testing.assert_array_equal(ar[n].numpy(), arena[n])
    accept = np.array([2, 4, 1])
    ar = {n: t.clone() for n, t in written.items()}
    reject = torch.arange(5)[:, None] >= torch.from_numpy(accept)[None, :]
    seq.restore_paged(ar, journal, reject)
    jm = np.arange(5)[:, None] >= accept[None, :]
    for n in ("k", "v"):
        cur = jnp.asarray(written[n].numpy())
        pb, o = (jnp.asarray(journal[x].numpy()) for x in ("pb", "o"))
        old = jnp.asarray(journal[n].numpy())
        want = cur.at[pb, :, o, :].set(
            jnp.where(jnp.asarray(jm)[..., None, None], old,
                      cur[pb, :, o, :]))
        np.testing.assert_array_equal(ar[n].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

def test_paged_pool_matches_dense_and_jax_with_wraparound(models, pools,
                                                          jax_pools):
    jnet, path = models["attention"]
    net = port_of(path)
    x = tokens(1, 14, seed=11)                 # 14 tokens through W = 8
    dense, paged = _dense(net, pools), _paged(net, pools)
    jp = jax_pools["paged"]
    a, b, c = dense.open_session(), paged.open_session(), jp.open_session()
    t = 0
    try:
        for n in (3, 1, 4, 1, 5):
            (ref,) = dense.step(a, x[0, t:t + n], timeout=WAIT)
            (got,) = paged.step(b, x[0, t:t + n], timeout=WAIT)
            (jgot,) = jp.step(c, x[0, t:t + n], timeout=WAIT)
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5,
                                       atol=1e-5)
            t += n
    finally:
        jp.close_session(c)
    st = paged.stats()["kv_arena"]
    assert st["block_size"] == BS and st["tokens_resident"] == W
    assert paged.stats()["kv_cache"]["paged"] is True
    _ownership_ok(paged)


def test_paged_blocks_free_on_close(models, pools):
    net = port_of(models["attention"][1])
    pool = _paged(net, pools, max_slots=3)
    x = tokens(1, 9, seed=5)
    a, b = pool.open_session(), pool.open_session()
    for t in range(5):
        pool.step(a, x[0, t:t + 1], timeout=WAIT)
    for t in range(9):
        pool.step(b, x[0, t:t + 1], timeout=WAIT)
    st = pool.stats()["kv_arena"]
    # per layer: a holds 2 blocks, b (wrapped) 2; two attention layers
    assert st["blocks"] - st["blocks_free"] == 2 * 4
    assert st["tokens_resident"] == 5 + W
    pool.close_session(a)
    pool.close_session(b)
    st = pool.stats()["kv_arena"]
    assert st["blocks_free"] == st["blocks"] and st["tokens_resident"] == 0
    _ownership_ok(pool)


def test_arena_exhaustion_sheds_retryably_and_close_unblocks(models, pools):
    net = port_of(models["attention"][1])
    pool = _paged(net, pools, max_slots=3, kv_arena_tokens=W)
    x = tokens(1, 8, seed=9)
    a = pool.open_session()
    for t in range(8):
        pool.step(a, x[0, t:t + 1], timeout=WAIT)
    assert pool.stats()["kv_arena"]["blocks_free"] == 0
    b = pool.open_session()
    with pytest.raises(OverloadedError) as ei:
        pool.step(b, x[0, 0:1], timeout=WAIT)
    assert ei.value.retry_after_s > 0
    pool.close_session(a)
    (out,) = pool.step(b, x[0, 0:1], timeout=WAIT)
    assert np.isfinite(out).all()
    _ownership_ok(pool)


def test_block_ownership_stays_disjoint_through_churn(models, pools):
    """Random opens, chunked steps, closes, sheds and an export / reinstate
    on an arena of 3 windows: after every operation each block is free or
    held by exactly one session."""
    net = port_of(models["attention"][1])
    pool = _paged(net, pools, max_slots=4, kv_arena_tokens=3 * W)
    rng = np.random.default_rng(0)
    live, shed = [], 0
    for i in range(60):
        op = rng.integers(0, 4)
        if op == 0 and len(live) < 4:
            live.append(pool.open_session())
        elif op == 1 and live:
            sid = live.pop(rng.integers(0, len(live)))
            pool.close_session(sid)
        elif op == 3 and live:
            sid = live[rng.integers(0, len(live))]
            pool.export_session(sid, timeout=WAIT)
            pool.finish_export(sid, ok=bool(rng.integers(0, 2)))
            if sid not in pool.session_ids():
                live.remove(sid)
        elif live:
            sid = live[rng.integers(0, len(live))]
            n = int(rng.integers(1, 4))
            try:
                pool.step(sid, tokens(1, n, seed=i)[0], timeout=WAIT)
            except OverloadedError:
                shed += 1
        _ownership_ok(pool)
    for sid in live:
        pool.close_session(sid)
    _ownership_ok(pool)
    st = pool.stats()["kv_arena"]
    assert st["blocks_free"] == st["blocks"]


def test_concurrent_clients_keep_block_ownership_disjoint(models, pools):
    """More client threads than cores open, step (chunks of 1-3 tokens,
    some shed by the arena of 3 windows) and close sessions at once, with
    the interpreter switching threads every 10 us: every step resolves,
    and afterwards every block is free exactly once."""
    net = port_of(models["attention"][1])
    pool = _paged(net, pools, max_slots=6, kv_arena_tokens=3 * W)
    errors = []

    def client(i):
        rng = np.random.default_rng(i)
        for r in range(4):
            try:
                sid = pool.open_session()
            except OverloadedError:
                continue
            try:
                for n in rng.integers(1, 4, 3):
                    try:
                        pool.step(sid, tokens(1, int(n), seed=i * 10 + r)[0],
                                  timeout=WAIT)
                    except OverloadedError:
                        pass
            except Exception as e:
                errors.append(repr(e))
            finally:
                pool.close_session(sid)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range((os.cpu_count() or 4) + 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    _ownership_ok(pool)
    st = pool.stats()["kv_arena"]
    assert st["blocks_free"] == st["blocks"] and pool.held_slots == 0


def test_pools_and_batcher_step_at_once_without_crossing(models, pools):
    """A dense pool, a paged pool and a ``MicroBatcher`` whose
    ``output()`` runs full attention over more tokens than the window, all
    on one attention net and all stepping at once with the interpreter
    switching threads every 10 us: the decode switch and the paged tape
    are per thread, so each answer equals the one it gives alone (dense
    and paged streams ``rnn_time_step`` of the same tokens within 1e-6,
    the batcher's ``output()`` exactly), and every arena block is owned
    once afterwards."""
    from deeplearning4j_tpu_torch.server.batcher import MicroBatcher
    net = port_of(models["attention"][1])
    ref_net = port_of(models["attention"][1])
    n_tok, reps = 14, 6
    xa, xb = tokens(1, n_tok, seed=31)[0], tokens(1, n_tok, seed=32)[0]
    xf = tokens(2, W + 4, seed=33)                # past the window
    want = {}
    for key, x in (("dense", xa), ("paged", xb)):
        ref_net.rnn_clear_previous_state()
        want[key] = np.concatenate(
            [ref_net.rnn_time_step(x[None, t:t + 1])[0].numpy()
             for t in range(n_tok)])
    want["batcher"] = ref_net.output(xf).numpy()
    dense, paged = _dense(net, pools), _paged(net, pools)
    mb = MicroBatcher(lambda x: net.output(x), max_batch=4, name="att")
    got = {"dense": [], "paged": [], "batcher": []}
    errors = []

    def stream(key, pool, x):
        try:
            for _ in range(reps):
                sid = pool.open_session()
                got[key].append(np.concatenate(
                    [pool.step(sid, x[t:t + 1], timeout=WAIT)[0]
                     for t in range(n_tok)]))
                pool.close_session(sid)
        except Exception as e:
            errors.append(f"{key}: {e!r}")

    def batched():
        try:
            for _ in range(3 * reps):
                got["batcher"].append(mb.predict(xf, timeout=WAIT))
        except Exception as e:
            errors.append(f"batcher: {e!r}")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=stream, args=("dense", dense, xa)),
                   threading.Thread(target=stream, args=("paged", paged, xb)),
                   threading.Thread(target=batched)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        mb.stop()
    assert errors == []
    assert len(got["dense"]) == len(got["paged"]) == reps
    assert len(got["batcher"]) == 3 * reps
    for key in ("dense", "paged"):
        for out in got[key]:
            np.testing.assert_allclose(out, want[key], rtol=TOL, atol=TOL)
    for out in got["batcher"]:
        np.testing.assert_array_equal(out, want["batcher"])
    _ownership_ok(paged)
    st = paged.stats()["kv_arena"]
    assert st["blocks_free"] == st["blocks"]


def test_bf16_arena_within_jax_bound(models, pools, jax_pools):
    """The port's bf16 arena against JAX's bf16 arena on the same zip and
    tokens (wrapping the window): within 1e-6 (both round the same f32
    pages to bf16 and sum the scores in f32; read 4.5e-8 to 2.1e-7 over
    three seeds).  And the bf16 arena against the f32 dense pool within
    one bf16 rounding, a relative 2-norm of 2^-8 (read 3.1e-4 to 3.8e-4,
    where a typical probability is 1/16)."""
    net = port_of(models["attention"][1])
    dense = _dense(net, pools, max_slots=2)
    half = _paged(net, pools, max_slots=2, kv_dtype="bfloat16")
    jp = jax_pools["paged_bf16"]
    x = tokens(1, 14, seed=7)
    a, b, c = dense.open_session(), half.open_session(), jp.open_session()
    ref, got, jgot = [], [], []
    try:
        for t in range(14):
            ref.append(dense.step(a, x[0, t:t + 1], timeout=WAIT)[0])
            got.append(half.step(b, x[0, t:t + 1], timeout=WAIT)[0])
            jgot.append(np.asarray(jp.step(c, x[0, t:t + 1],
                                           timeout=WAIT)[0]))
    finally:
        jp.close_session(c)
    ref, got, jgot = map(np.concatenate, (ref, got, jgot))
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)
    assert np.linalg.norm(got - ref) <= 2.0 ** -8 * np.linalg.norm(ref)
    assert not np.array_equal(got, ref)        # the pages were rounded
    assert half._arenas[0]["k"].dtype == torch.bfloat16
    assert half.stats()["kv_cache"]["dtype"] == "bfloat16"


def test_import_sheds_when_arena_cannot_hold_the_carry(models, pools):
    net = port_of(models["attention"][1])
    src = _paged(net, pools)
    dst = _paged(net, pools, kv_arena_tokens=W)
    x = tokens(1, 8, seed=17)
    filler = dst.open_session()
    for t in range(8):
        dst.step(filler, x[0, t:t + 1], timeout=WAIT)
    sid = src.open_session()
    for t in range(5):
        src.step(sid, x[0, t:t + 1], timeout=WAIT)
    wire = json.loads(json.dumps(src.export_session(sid, timeout=WAIT)))
    with pytest.raises(OverloadedError):
        dst.import_session(wire)
    src.finish_export(sid, ok=False)
    (out,) = src.step(sid, x[0, 5:6], timeout=WAIT)
    assert np.isfinite(out).all()
    st = dst.stats()["kv_arena"]
    assert st["blocks"] - st["blocks_free"] == 2 * 2    # filler's, 2 layers
    _ownership_ok(dst)


# ---------------------------------------------------------------------------
# migration between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["v2", "v1"])
@pytest.mark.parametrize("src_paged,dst_paged", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["dense-dense", "dense-paged", "paged-dense", "paged-paged"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_migration_continues_within_1e6_of_unmigrated_twin(
        direction, src_paged, dst_paged, wire, models, pools, jax_pools,
        monkeypatch):
    """A session decodes 5 tokens in one package's pool, migrates through
    the JSON wire, and decodes 6 more (wrapping the window) in the other's;
    a twin fed all 11 tokens in the destination pool from the start agrees
    within 1e-6."""
    if wire == "v1":
        monkeypatch.setenv("DL4J_CARRY_PAYLOAD", "json")
    net = port_of(models["attention"][1])
    port_pool = (_paged if (dst_paged if direction == "jax_to_port"
                            else src_paged) else _dense)(net, pools)
    jp = jax_pools["paged" if (src_paged if direction == "jax_to_port"
                               else dst_paged) else "dense"]
    src, dst = (jp, port_pool) if direction == "jax_to_port" \
        else (port_pool, jp)
    x = tokens(1, 11, seed=13)
    mig = src.open_session()
    twin = dst.open_session()
    try:
        for t in range(5):
            src.step(mig, x[0, t:t + 1], timeout=WAIT)
            dst.step(twin, x[0, t:t + 1], timeout=WAIT)
        wire_payload = json.loads(json.dumps(src.export_session(mig)))
        assert wire_payload["version"] == (2 if wire == "v2" else 1)
        assert [leaf["dtype"] for leaf in wire_payload["carry"]["leaves"]] \
            == ["float32", "int32", "float32"] * 2
        assert dst.import_session(wire_payload) == mig
        src.finish_export(mig, ok=True)
        for t in range(5, 11):
            (a,) = dst.step(mig, x[0, t:t + 1], timeout=WAIT)
            (b,) = dst.step(twin, x[0, t:t + 1], timeout=WAIT)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=TOL, atol=TOL)
    finally:
        for p, s in ((src, mig), (dst, mig), (dst, twin)):
            p.close_session(s)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_carry_migrates_bit_for_bit(direction, models, pools,
                                         jax_pools):
    """A bf16 carry pool's leaves cross the v2 wire as raw bf16 bits both
    ways: exported, imported by the other package and exported again, the
    leaves are the same bits."""
    jp = jax_pools["bf16"]
    pp = _dense(port_of(models["lstm"][1]), pools, carry_dtype="bfloat16")
    src, dst = (jp, pp) if direction == "jax_to_port" else (pp, jp)
    x = tokens(1, 4, seed=3)
    sid = src.open_session()
    try:
        src.step(sid, x[0], timeout=WAIT)
        first = json.loads(json.dumps(src.export_session(sid)))
        assert {leaf["dtype"] for leaf in first["carry"]["leaves"]} == \
            {"bfloat16"}
        dst.import_session(first)
        second = json.loads(json.dumps(dst.export_session(sid)))
        for a, b in zip(first["carry"]["leaves"],
                        second["carry"]["leaves"]):
            ta, tb = _decode_carry_leaf(a), _decode_carry_leaf(b)
            assert ta.dtype == torch.bfloat16
            assert torch.equal(ta.view(torch.int16), tb.view(torch.int16))
            ja = np.asarray(jax_decode_leaf(b)).view(np.int16)
            np.testing.assert_array_equal(ja, ta.view(torch.int16).numpy())
    finally:
        src.close_session(sid)
        dst.close_session(sid)
