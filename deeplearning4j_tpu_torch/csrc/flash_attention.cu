// Flash attention, forward and both backward kernels, f32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// deeplearning4j_tpu/ops/pallas_kernels.py:
//   flash_fwd             <- `_flash_fwd_kernel` :128 (launched by `_flash_fwd` :196)
//   flash_bwd<DPAD, true> <- `_flash_dq_kernel`  :238 (launched by `_flash_bwd` :341)
//   flash_bwd<DPAD, false><- `_flash_dkv_kernel` :274 (launched by `_flash_bwd` :357)
// Layout [B*H, T, D] row-major for q, k, v, out, dout, dq, dk, dv; lse and
// delta [B*H, T]; the key mask [B, T] (> 0 keeps a key), shared by the H heads
// of a batch row.  For query row r and key c, with scale s:
//   live(r, c) = mask[c] > 0 and (not causal or c <= r)
//   forward:  out_r = sum_c p_rc v_c, p_rc = softmax_c(s q_r.k_c) over live c,
//             lse_r = log sum_c exp(s q_r.k_c) over live c
//   backward: p_rc recomputed from lse, ds_rc = p_rc (dout_r.v_c - delta_r),
//             dq_r = s sum_c ds_rc k_c,  dk_c = s sum_r ds_rc q_r,
//             dv_c = sum_r p_rc dout_r
// with delta_r = dout_r.out_r computed by the caller.  A query row with no
// live key gets out = 0 and lse = -1e30; the backward treats lse <= -5e29 as
// such a row and sets its p to 0 by clamping the exponent (never the result,
// so no 0 * inf reaches dk or dv), as `_recompute_p` (:219) does.  dq and
// dk/dv are two kernels, so no atomics are needed and the result is
// deterministic.  The [T, T] score matrix never reaches device memory.  Any
// T works (the last tile is masked); any head dim D with D % 4 == 0 and
// D <= 128 works (DPAD = 64 or 128 is D rounded up, the padding zero).
//
// What bounds them on this card.  At the long-context model's shape (B = 4,
// H = 8, T = 8192, D = 64, causal) the forward does 275 GFLOP and reads 268
// MB, so operations bound all three kernels.
//
// The forward: S = Q K^T and P V, both on the tensor cores, f32-accurate by
// 3xTF32 (as the backward, below), with the online softmax in f32 on the
// CUDA cores between them.  Its bound is 3 x 275 GFLOP over the 494.7
// TFLOP/s TF32 peak, 1.67 ms at that shape (4.1 ms of f32 FMAs on the CUDA
// cores).
//  * A split pre-pass, flash_fwd_split, writes every 64-key tile (32 at
//    DPAD = 128) once into the scratch as the products read it: K and V^T
//    split into tf32 hi and lo K-major images in the 128-byte swizzle, and
//    a key bias (0, or -inf for a masked key or one past T).  Each tile is
//    read by up to T / 128 query blocks, so splitting it in every block
//    would repeat the same CUDA-core work that many times; the pre-pass
//    reads K and V once and writes twice their bytes (269 MB at that
//    shape), and the kernel does no split, transpose or mask test for them.
//  * P V takes P as A straight from the S accumulators (layout (b)): the
//    accumulator holds a row's keys 2t, 2t + 1 of each 8 where the A
//    fragment wants K indices t, t + 4, so the V^T image stores each 8 keys
//    in that order, and P never goes through shared memory.  B = V^T needs
//    V transposed, which the pre-pass does for free.  (Computing O^T = V^T
//    P^T instead, as the backward's phase 2, would gather and split V in
//    every block and store P to shared memory per tile.)
//  * A block is NWG consumer warpgroups of 64 query rows (two at DPAD = 64,
//    one at 128, for shared memory) and one producer warpgroup, one thread
//    of which brings each tile (64 KB) in one bulk copy into a ring of two
//    stages, counted on mbarriers: no block barrier in the loop, so one
//    warpgroup's softmax runs while the other's products do.  The producer
//    hands its registers to the consumers (setmaxnreg).  Q is split once
//    into hi and lo K-major images and read by wgmma from shared memory.
//  * The first product into a fresh accumulator is D = A B with D an output
//    only (`init`): with D an input, its dead value stayed live and ptxas
//    serialised the wgmmas for want of registers.
//  * Accuracy.  The backward's ds = p (dP - delta) cancels where attention
//    is sharp, and delta = dout.out comes from this kernel's out, so a bias
//    in out (or lse) of a few 1e-7 shows in every q and k gradient: with the
//    backward's split (low bits cleared, lo of v's sign) and one P V
//    accumulator a tile, the attention training step's Adam updates went
//    3.1e-3 to 6.6e-3 from the plain versions' (limit 5e-4) on an H100, though
//    every kernel check passed at 3 % of FLASH_TOL.  So the forward splits
//    to the nearest tf32 (split_rn: lo of either sign) and gives P V's hi.hi
//    a fresh accumulator every k-step, added on the CUDA cores rounding to
//    nearest: the gradients then sit as close to the plain versions' as
//    with the plain forward (4e-6).  S keeps one hi.hi and one cross
//    accumulator a tile.  The softmax works in the log2 domain (exp2f,
//    scale folded in by log2 e), and lse comes out as the natural log the
//    backward recomputes p from.
//  * The grid is (B*H, query blocks), so that every head's last query rows,
//    which visit the most key tiles, go out first (as the backward).
//
// The backward: per tile of the [T, T] scores it computes S and dP (two
// products that reduce over D) and then two products (dk/dv: dk, dv) or one
// (dq) that reduce over rows.  One template, flash_bwd<DPAD, DQ>, is both
// kernels.  A block of two warpgroups owns BLOCK rows (64, or 32 at DPAD =
// 128) of one side -- keys for dk/dv, queries for dq -- keeps them in
// shared memory, and streams 64-row tiles of the other side, copied by
// cp.async into a ring of two stages (row stride DPAD + 4, zero past T).
// Every product but dP runs on the tensor cores, f32-accurate by 3xTF32 as
// the conv (conv_bias_act.cu): a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, where hi
// is x with its low 13 bits cleared (tf32) and lo = x - hi, exact in f32,
// of which the tensor cores read the top 19 bits.  Clearing bits is one
// integer op where the conv's cvt.rna costs more (dk/dv 16.9 -> 14.4 ms on
// an H100 at that shape); the dropped terms stay below 2^-20 of a product.
//  * tf32 wgmma takes B only from shared memory and only K-major, and A
//    from registers only as a fragment.  A is gathered from the raw tiles
//    and split in registers; the B operands are split once into hi and lo
//    K-major tiles in the 128-byte swizzle.
//  * Phase 1, each warpgroup NH = BLOCK / 2 of the block's rows, in wgmma's
//    accumulator layout: S = streamed0 . fixed0^T on the tensor cores
//    (m64nNH, K = DPAD), and dP = streamed1 . fixed1^T on the CUDA cores in
//    f32, summed over d in ascending order as a plain f32 matmul sums it;
//    each 8-deep step issues its S products and then does the dP FMAs of
//    the same 8 columns while they run.  ds = p (dP - delta) cancels where
//    the softmax is sharp (delta = sum_c p_c dP_c comes from the caller),
//    so an error in dP is an error in ds many times its size: on an H100,
//    dP on the tensor cores, which truncate as they add, put the attention
//    training step's Adam updates 1.9e-3 from the plain versions' (the
//    check allows 5e-4), S on the CUDA cores changed nothing, dP on the
//    CUDA cores gave 1.9e-4.  Then p and ds in f32 on the CUDA cores,
//    stored split into K-major tiles [block row][streamed row]: the
//    accumulator's rows become the K index, so the transpose costs
//    nothing.  K index t of each 8 holds streamed row 2t
//    and t + 4 holds 2t + 1, so that phase 2's gathers meet no bank
//    conflict.
//  * Phase 2: out^T[d][block row] += sum over the tile's rows of
//    streamed^T[d][row] . tile[block row][row]: dk^T += q^T dS and dv^T +=
//    dout^T P, or dq^T += k^T dS^T, wgmma.m64n32k8, K = 64, A gathered from
//    the raw tile transposed; each warpgroup takes 32 block rows (DPAD =
//    64) or 64 head dims (DPAD = 128).  A tile's phase-2 products run on
//    into the next tile's phase 1; the block waits for them only before
//    it overwrites the p and ds tiles.
//  * The tensor cores truncate as they add: one accumulator over thousands
//    of rows drifts ~1e-4 relative (measured on the conv).  So each tile's
//    products go into fresh accumulators, hi.hi and cross products apart,
//    which the CUDA cores add to the running f32 sums with rounding to
//    nearest.
//  * The grid is (B*H, blocks) so that every head's longest blocks go out
//    first: under `causal`, dq blocks start with the last query rows, dk/dv
//    blocks with the first keys.
// Its bound, every product on the tensor cores, is 3 x FLOPs over the 494.7
// TFLOP/s TF32 peak: dq 2.50 ms, dk/dv 3.33 ms at that shape; dP on the
// CUDA cores alone takes 2.05 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "hopper_tf32.cuh"

namespace {

constexpr float kDeadLse = -1e30f;
constexpr int kSmemMax = 232448;   // a block's dynamic shared memory

// Byte offset of element (row n, k) in a K-major tile of `rows` rows stored
// as [k / 32][rows][32 f32] atoms in the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw_off(int rows, int n, int k) {
  return (k >> 5) * (rows * 128) + n * 128 +
         ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// The inverse of sw_off: the (row n, k) of 4-byte word w of such a tile.
__device__ __forceinline__ void sw_pos(int rows, int w, int& n, int& k) {
  const int atom = w / (rows * 32), rem = w - atom * rows * 32;
  n = rem >> 5;
  k = atom * 32 + ((((rem & 31) >> 2) ^ (n & 7)) << 2) + (rem & 3);
}

// v = hi + lo with hi = v truncated to tf32 and lo = v - hi exact in f32
// (the tensor cores read lo's top 19 bits).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// v = hi + lo with hi = v rounded to the nearest tf32 and lo = v - hi exact
// in f32, of either sign: what the tensor cores then drop (lo's low 13 bits,
// lo.lo) has no bias, where split's lo, of v's sign, is always cut the same
// way.  The forward's out feeds the backward's delta = dout.out, from which
// ds = p (dP - delta) cancels, so a bias in out shows in every gradient.
__device__ __forceinline__ void split_rn(float v, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// Forward: a split pre-pass, then the product kernel on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwdStages = 2;      // the ring of key tiles
constexpr int kSplitThreads = 256;

// The forward's plan.  A block of NWG consumer warpgroups (64 query rows
// each) and one producer warpgroup; key tiles of KT keys.
template <int DPAD>
struct Fwd {
  static constexpr int NWG = DPAD == 64 ? 2 : 1;
  static constexpr int ROWS = 64 * NWG;              // query rows of a block
  static constexpr int KT = DPAD == 64 ? 64 : 32;    // keys of a tile
  static constexpr int NS = KT / 2;                  // S accumulators
  static constexpr int IMG = KT * DPAD * 4;          // bytes of one image
  static constexpr int VCH = KT * 64 * 4;            // a 64-dim V^T chunk
  // a tile in the scratch: K hi, K lo, V^T hi, V^T lo, the key bias
  static constexpr int TILE = 4 * IMG + KT * 4;
  static constexpr int STAGE = (TILE + 1023) / 1024 * 1024;
  static constexpr int QIMG = 64 * DPAD * 4;         // a warpgroup's Q hi
  static constexpr int RING = NWG * 2 * QIMG;
  static constexpr int BARS = RING + kFwdStages * STAGE;
  static constexpr int THREADS = 128 * NWG + 128;
  static constexpr int SMEM = BARS + 16 * kFwdStages + 1024;
  static_assert(SMEM <= kSmemMax, "the plan exceeds a block's shared memory");
  static_assert(TILE % 16 == 0 && TILE < (1 << 20), "one bulk copy a tile");
};

// Key position p of a V^T image holds key perm(p) of its tile: within each
// 8, position t holds key 2t and t + 4 holds key 2t + 1, the order in which
// a thread's S accumulators hold a row's keys, so that P serves as the A
// fragment of P V straight from them.
__device__ __forceinline__ int perm(int p) {
  return (p & ~7) + ((p & 7) < 4 ? 2 * (p & 7) : 2 * (p & 7) - 7);
}

// The pre-pass: tile `blockIdx.x` of head `blockIdx.y` into the scratch as
// the products read it, zero past T and in [D, DPAD): K (its rows the B
// operand of S, K-major) and V^T (the B operand of P V: [d][key], keys in
// perm order) split into tf32 hi and lo in the 128-byte swizzle, then the
// key bias, 0 for a live key and -inf for a masked key or one past T.
template <int DPAD>
__global__ void __launch_bounds__(kSplitThreads)
flash_fwd_split(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ mask, uint8_t* __restrict__ scratch,
                int H, int T, int D) {
  using P = Fwd<DPAD>;
  constexpr int KT = P::KT, LD = DPAD + 1;
  __shared__ float ks[KT][LD], vs[KT][LD];
  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int k0 = tile * KT;
  const size_t base = static_cast<size_t>(bh) * T * D;
  for (int e = tid; e < KT * DPAD; e += kSplitThreads) {
    const int r = e / DPAD, d = e - r * DPAD;
    const bool ok = k0 + r < T && d < D;
    const size_t src = base + static_cast<size_t>(k0 + r) * D + d;
    ks[r][d] = ok ? __ldg(k + src) : 0.0f;
    vs[r][d] = ok ? __ldg(v + src) : 0.0f;
  }
  __syncthreads();
  uint32_t* out = reinterpret_cast<uint32_t*>(
      scratch + (static_cast<size_t>(bh) * gridDim.x + tile) * P::TILE);
  constexpr int W = P::IMG / 4;
  for (int w = tid; w < W; w += kSplitThreads) {
    int n, kk;
    sw_pos(KT, w, n, kk);                  // K[key n][d kk]
    uint32_t hi, lo;
    split_rn(ks[n][kk], hi, lo);
    out[w] = hi;
    out[W + w] = lo;
    const int ch = w / (P::VCH / 4), wc = w - ch * (P::VCH / 4);
    sw_pos(64, wc, n, kk);                 // V^T[d 64 ch + n][position kk]
    split_rn(vs[perm(kk)][64 * ch + n], hi, lo);
    out[2 * W + w] = hi;
    out[3 * W + w] = lo;
  }
  if (tid < KT) {
    const int key = k0 + tid;
    const bool live =
        key < T && mask[static_cast<size_t>(bh / H) * T + key] > 0.0f;
    reinterpret_cast<float*>(out + 4 * W)[tid] = live ? 0.0f : -INFINITY;
  }
}

template <int DPAD>
__global__ void __launch_bounds__(Fwd<DPAD>::THREADS, 1)
flash_fwd(const float* __restrict__ q, const uint8_t* __restrict__ scratch,
          float* __restrict__ out, float* __restrict__ lse, int T, int D,
          int causal, float scale) {
  using P = Fwd<DPAD>;
  constexpr int KT = P::KT, NS = P::NS, NWG = P::NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's 1 KB
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + P::BARS, empty = full + 8 * kFwdStages;

  // every head's last query rows, which visit the most key tiles, first
  const int bh = blockIdx.x, qb = gridDim.y - 1 - blockIdx.y;
  const int r0 = qb * P::ROWS;
  const int ntiles = (T + KT - 1) / KT;
  const int n_tiles = causal ? min(ntiles, (r0 + P::ROWS - 1) / KT + 1)
                             : ntiles;
  const uint8_t* tiles =
      scratch + static_cast<size_t>(bh) * ntiles * P::TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the producer warpgroup gives its registers to the consumers (a block
  // of 384 threads gets 168 a thread; the consumers need ~200): one thread
  // brings in one tile a bulk copy
  if (warp >= 4 * NWG) {
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NWG)
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kFwdStages;
        mbar_wait(empty + 8 * st, ((it / kFwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * st, P::TILE);
        bulk_copy(base + P::RING + st * P::STAGE,
                  tiles + static_cast<size_t>(it) * P::TILE, P::TILE,
                  full + 8 * st);
      }
    return;
  }
  if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // a consumer warpgroup: query rows q0 + [0, 64); this thread's rows
  // q0 + g and q0 + g + 8, and the accumulators' columns 8 j + 2 t + {0, 1}
  const int wg = warp >> 2, t = lane & 3;
  const int g = 16 * (warp & 3) + (lane >> 2);
  const int q0 = r0 + 64 * wg;
  const size_t base_td = static_cast<size_t>(bh) * T * D;
  const uint32_t qh = base + wg * 2 * P::QIMG, ql = qh + P::QIMG;
  {
    // the warpgroup's Q rows, zero past T and in [D, DPAD), split into tf32
    // hi and lo K-major tiles: S's A operand, read from shared memory
    constexpr int C4 = DPAD / 4;
    for (int e = tid & 127; e < 64 * C4; e += 128) {
      const int n = e / C4, c4 = e - n * C4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q0 + n < T && 4 * c4 < D)
        x = __ldg(reinterpret_cast<const float4*>(
            q + base_td + static_cast<size_t>(q0 + n) * D + 4 * c4));
      uint4 hi, lo;
      split_rn(x.x, hi.x, lo.x);
      split_rn(x.y, hi.y, lo.y);
      split_rn(x.z, hi.z, lo.z);
      split_rn(x.w, hi.w, lo.w);
      const uint32_t off = wg * 2 * P::QIMG + sw_off(64, n, 4 * c4);
      *reinterpret_cast<uint4*>(smem + off) = hi;
      *reinterpret_cast<uint4*>(smem + off + P::QIMG) = lo;
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  const float scale_log2e = scale * 1.4426950408889634f;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[DPAD / 2], s_hh[NS], s_x[NS], o_ha[32], o_x[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kFwdStages, k0 = it * KT;
    mbar_wait(full + 8 * st, (it / kFwdStages) & 1);
    if (causal && k0 > q0 + 63) {      // no live key for these rows
      mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t stage = base + P::RING + st * P::STAGE;

    // S = Q K^T on the tensor cores, 3xTF32, hi.hi and the cross products
    // in fresh accumulators apart
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_operand(s_hh[i]);
      fence_operand(s_x[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DPAD / 8; ++kk) {
      const int step = 2 * (kk & 3);
      const uint64_t ah = sw128_desc(qh + (kk >> 2) * (64 * 128)) + step;
      const uint64_t al = sw128_desc(ql + (kk >> 2) * (64 * 128)) + step;
      const uint32_t kb = stage + (kk >> 2) * (KT * 128);
      const uint64_t bh_ = sw128_desc(kb) + step;
      const uint64_t bl = sw128_desc(kb + P::IMG) + step;
      if (kk == 0) {
        WgmmaSS<KT>::init(s_hh, ah, bh_);
        WgmmaSS<KT>::init(s_x, ah, bl);
      } else {
        WgmmaSS<KT>::mma(s_hh, ah, bh_, 1);
        WgmmaSS<KT>::mma(s_x, ah, bl, 1);
      }
      WgmmaSS<KT>::mma(s_x, al, bh_, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // the online softmax in f32 on the CUDA cores, in the log2 domain: x =
    // s scale log2(e) + bias; the row max over the 4 threads of a row
    const float* bias =
        reinterpret_cast<const float*>(smem + P::RING + st * P::STAGE +
                                       4 * P::IMG);
    const bool diag = causal && k0 + KT - 1 > q0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_operand(s_hh[i]);
      fence_operand(s_x[i]);
      const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
      float x = fmaf(s_hh[i] + s_x[i], scale_log2e, bias[col]);
      if (diag && k0 + col > q0 + g + 8 * h) x = -INFINITY;
      s_hh[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m2[h], mx[h]);
      mu[h] = m_new == -INFINITY ? 0.0f : m_new;   // no live key yet: p = 0
      alpha[h] = exp2f(m2[h] - mu[h]);             // 0 while m2 is -inf
      m2[h] = m_new;
      l[h] *= alpha[h];                            // this thread's share
    }
    // p, split in place into tf32 hi (s_hh) and lo (s_x): the A fragments
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2f(s_hh[i] - mu[h]);
      l[h] += p;
      uint32_t hi, lo;
      split_rn(p, hi, lo);
      s_hh[i] = __uint_as_float(hi);
      s_x[i] = __uint_as_float(lo);
    }

    // P V on the tensor cores, 3xTF32, per 64 head dims: A = P from the
    // registers (K index t holds key 2t, t + 4 key 2t + 1, as the V^T
    // image).  hi.hi goes into a fresh accumulator every k-step, which the
    // CUDA cores add, rounding to nearest, to the rescaled running sum; the
    // cross products, 2^-11 the size, into one accumulator over the tile.
    // The tensor cores truncate as they add: summed over the tile, hi.hi's
    // truncation biased out enough to show in the gradients.  Each k-step
    // waits for its products (a second buffer in turn cost the registers
    // that keep ptxas from serialising the wgmmas, and was slower); the
    // other warpgroup's products fill the tensor cores meanwhile.
#pragma unroll
    for (int i = 0; i < NS; ++i) {     // P is written before the fences
      fence_operand(s_hh[i]);
      fence_operand(s_x[i]);
    }
#pragma unroll
    for (int ch = 0; ch < DPAD / 64; ++ch) {
      float* oc = o + 32 * ch;
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        const uint32_t ah[4] = {
            __float_as_uint(s_hh[4 * kk]), __float_as_uint(s_hh[4 * kk + 2]),
            __float_as_uint(s_hh[4 * kk + 1]),
            __float_as_uint(s_hh[4 * kk + 3])};
        const uint32_t al[4] = {
            __float_as_uint(s_x[4 * kk]), __float_as_uint(s_x[4 * kk + 2]),
            __float_as_uint(s_x[4 * kk + 1]),
            __float_as_uint(s_x[4 * kk + 3])};
        const int step = 2 * (kk & 3);
        const uint32_t vb =
            stage + 2 * P::IMG + ch * P::VCH + (kk >> 2) * (64 * 128);
        const uint64_t bh_ = sw128_desc(vb) + step;
        const uint64_t bl = sw128_desc(vb + P::IMG) + step;
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(o_ha[i]);
        wgmma_fence();
        Wgmma<64>::init(o_ha, ah, bh_);
        if (kk == 0)
          Wgmma<64>::init(o_x, ah, bl);
        else
          Wgmma<64>::mma(o_x, ah, bl, 1);
        Wgmma<64>::mma(o_x, al, bh_, 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(o_ha[i]);
          if (kk == 0) oc[i] *= alpha[(i >> 1) & 1];
          oc[i] += o_ha[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(o_x[i]);
        oc[i] += o_x[i];
      }
    }
    mbar_arrive(empty + 8 * st);       // this thread is done with the stage
  }

  // out = o / l and lse = (m2 + log2 l) ln 2 for the thread's two rows; a
  // row with no live key gives 0 and kDeadLse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = q0 + g + 8 * h;
    if (r >= T) continue;
    const bool live = l[h] > 0.0f;
    const float inv = live ? 1.0f / l[h] : 0.0f;
    float* row = out + base_td + static_cast<size_t>(r) * D;
#pragma unroll
    for (int i = 2 * h; i < DPAD / 2; i += 4) {
      // elements i, i + 1: head dims 64 (i / 32) + 8 ((i % 32) / 4) + 2 t
      const int d = 64 * (i >> 5) + 8 * ((i & 31) >> 2) + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(row + d) =
            make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if (t == 0)
      lse[static_cast<size_t>(bh) * T + r] =
          live ? (m2[h] + log2f(l[h])) * 0.6931471805599453f : kDeadLse;
  }
}

// ---------------------------------------------------------------------------
// Backward: dq and dk/dv on the tensor cores (wgmma, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;   // two warpgroups; 16 x 16 in phase 1
constexpr int kS = 64;             // rows of a streamed tile

// The backward's plan.  DQ: the dq kernel, whose block rows are queries and
// whose streamed rows are keys; else the dk/dv kernel, the other way round.
template <int DPAD, bool DQ>
struct Bwd {
  static constexpr int BLOCK = DPAD == 64 ? 64 : 32;   // block rows
  static constexpr int NH = BLOCK / 2;   // phase-1 columns of a warpgroup
  static constexpr int LD = DPAD + 4;    // row stride of a raw tile, floats
  static constexpr int OUT1 = BLOCK * kS * 4;    // bytes of a phase-1 tile
  static constexpr int NOUT = DQ ? 1 : 2;        // dS, and P for dk/dv
  static constexpr int VEC = DQ ? 1 : 2;         // mask, or lse and delta
  static constexpr int OUTS = 2 * NOUT * OUT1;   // hi and lo
  static constexpr int FIX0 = BLOCK * DPAD * 4;  // bytes of fixed0 hi or lo
  static constexpr int FIX1 = (BLOCK * LD * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE =
      (2 * kS * LD * 4 + VEC * kS * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM = OUTS + 2 * FIX0 + FIX1 + 2 * STAGE + 1024;
  static_assert(SMEM <= kSmemMax, "the plan exceeds a block's shared memory");
};

template <int DPAD, bool DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ mask,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ out0,
          float* __restrict__ out1, int H, int T, int D, int causal,
          float scale) {
  using P = Bwd<DPAD, DQ>;
  constexpr int BLOCK = P::BLOCK, NH = P::NH, LD = P::LD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's 1 KB
  uint8_t* smem = smem_raw + (base - raw_addr);
  // after the p and ds tiles: fixed0 split [hi, lo][DPAD / 32][BLOCK][32],
  // fixed1 f32 [BLOCK][LD], then the ring
  constexpr int kFix0 = P::OUTS, kFix1 = kFix0 + 2 * P::FIX0;
  constexpr int kRing = kFix1 + P::FIX1;
  float* fixed1 = reinterpret_cast<float*>(smem + kFix1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3) + (lane >> 2);   // accumulator rows m0, m0+8
  const int bh = blockIdx.x, b = bh / H;
  const int blk = DQ ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b0 = blk * BLOCK;                     // the block's first row
  const size_t base_td = static_cast<size_t>(bh) * T * D;
  const size_t base_t = static_cast<size_t>(bh) * T;
  const float* maskb = mask + static_cast<size_t>(b) * T;
  const float scale_log2e = scale * 1.4426950408889634f;   // p = 2^(...)
  // fixed: the block's rows of (q, dout) for dq, (k, v) for dk/dv;
  // streamed: (k, v) for dq, (q, dout) for dk/dv
  const float* fix0 = (DQ ? q : k) + base_td;
  const float* fix1 = (DQ ? dout : v) + base_td;
  const float* str0 = (DQ ? k : q) + base_td;
  const float* str1 = (DQ ? v : dout) + base_td;

  // the fixed rows, zero past T and in [D, DPAD): fixed0 split into tf32
  // hi and lo K-major tiles, fixed1 in f32
  {
    constexpr int C4 = DPAD / 4;
    for (int e = tid; e < BLOCK * C4; e += kBwdThreads) {
      const int n = e / C4, c4 = e - n * C4;
      const bool ok = b0 + n < T && 4 * c4 < D;
      const size_t src = static_cast<size_t>(b0 + n) * D + 4 * c4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) x = __ldg(reinterpret_cast<const float4*>(fix1 + src));
      *reinterpret_cast<float4*>(fixed1 + n * LD + 4 * c4) = x;
      x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) x = __ldg(reinterpret_cast<const float4*>(fix0 + src));
      uint4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      const uint32_t off = kFix0 + sw_off(BLOCK, n, 4 * c4);
      *reinterpret_cast<uint4*>(smem + off) = hi;
      *reinterpret_cast<uint4*>(smem + off + P::FIX0) = lo;
    }
    fence_proxy_async();
  }

  // this thread's phase-1 columns, block rows wg * NH + 8 (j / 2) + 2 t +
  // j % 2 (wgmma's accumulator layout): whether each is live, and for dq
  // its lse and delta
  constexpr int JC = NH / 4;
  bool col_live[JC];
  float col_lse[JC], col_delta[JC];
#pragma unroll
  for (int j = 0; j < JC; ++j) {
    const int n = b0 + wg * NH + 8 * (j >> 1) + 2 * t + (j & 1);
    if (DQ) {
      col_lse[j] = n < T ? lse[base_t + n] : kDeadLse;
      col_delta[j] = n < T ? delta[base_t + n] : 0.0f;
      col_live[j] = col_lse[j] > 0.5f * kDeadLse;
    } else {
      col_lse[j] = col_delta[j] = 0.0f;
      col_live[j] = n < T && maskb[n] > 0.0f;
    }
  }

  // the streamed tiles this block visits
  const int ns = (T + kS - 1) / kS;
  const int first = DQ || !causal ? 0 : b0 / kS;
  const int last = DQ && causal ? min(ns - 1, (b0 + BLOCK - 1) / kS)
                                : ns - 1;
  const int n_tiles = last - first + 1;

  // copies of streamed tile `tile` into ring stage `st`: the two raw
  // [kS][LD] tiles (zero past T and in the columns [D, DPAD)), then the
  // row vectors (zero past T)
  auto load = [&](int tile, int st) {
    constexpr int C4 = DPAD / 4;
    const int r0 = tile * kS;
    const uint32_t sa = base + kRing + st * P::STAGE;
    for (int e = tid; e < kS * C4; e += kBwdThreads) {
      const int r = e / C4, c4 = e - r * C4;
      const bool ok = r0 + r < T && 4 * c4 < D;
      const size_t src = ok ? static_cast<size_t>(r0 + r) * D + 4 * c4 : 0;
      const uint32_t dst = sa + (r * LD + 4 * c4) * 4;
      cp_async16_zfill(dst, str0 + src, ok ? 16 : 0);
      cp_async16_zfill(dst + kS * LD * 4, str1 + src, ok ? 16 : 0);
    }
    if (tid < P::VEC * kS) {
      const int r = tid % kS;
      const bool ok = r0 + r < T;
      const int row = ok ? r0 + r : 0;
      const float* src = DQ ? maskb + row
                            : (tid < kS ? lse : delta) + base_t + row;
      cp_async4(sa + 2 * kS * LD * 4 + tid * 4, src, ok ? 4 : 0);
    }
  };

  // phase 2: a warpgroup takes head dims d0 + [0, 64) and block rows
  // n0 + [0, 32); accumulator element i is head dim d0 + m0 + 8 ((i / 2) %
  // 2), block row n0 + 8 (i / 4) + 2 t + i % 2.  Running sums dk (or dq)
  // and dv; a tile's fresh accumulators, hi.hi and cross products apart,
  // which run on into the next tile's phase 1.
  const int d0 = DPAD == 128 ? 64 * wg : 0;
  const int n0 = DPAD == 64 ? 32 * wg : 0;
  float acc0[16], acc1[16], f0h[16], f0x[16], f1h[16], f1x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    acc0[i] = acc1[i] = f0h[i] = f0x[i] = f1h[i] = f1x[i] = 0.0f;
  auto add_phase2 = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_operand(f0h[i]);
      fence_operand(f0x[i]);
      acc0[i] += f0h[i] + f0x[i];
      if (!DQ) {
        fence_operand(f1h[i]);
        fence_operand(f1x[i]);
        acc1[i] += f1h[i] + f1x[i];
      }
    }
  };

  load(first, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int tile = first + it;
    const int st = it & 1;
    cp_async_wait<0>();                // this thread's copies of the tile
    __syncthreads();                   // everyone's; the other stage is free
    if (it + 1 < n_tiles) load(tile + 1, st ^ 1);
    cp_async_commit();
    const float* raw0 =
        reinterpret_cast<const float*>(smem + kRing + st * P::STAGE);
    const float* raw1 = raw0 + kS * LD;
    const float* vec = raw1 + kS * LD;
    const int r0 = tile * kS;

    // Phase 1, in wgmma's accumulator layout, NH block rows a warpgroup:
    // S = raw0 . fixed0^T on the tensor cores (3xTF32), and dP = raw1 .
    // fixed1^T on the CUDA cores in f32, summed over d in ascending order as
    // a plain f32 matmul sums it: ds = p (dP - delta) cancels where the
    // softmax is sharp, and delta comes from the caller.  Each 8-deep step
    // issues its S products, then does the dP FMAs of the same 8 columns
    // while they run.
    float s_hh[NH / 2], s_x[NH / 2], dp[NH / 2] = {};
    {
      const uint32_t fb = base + kFix0 + wg * NH * 128;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < DPAD / 8; ++kk) {
        if (kk >= 2) wgmma_wait<1>();  // step kk-2's registers are free
        const int c = 8 * kk + t;
        const float x[4] = {raw0[m0 * LD + c], raw0[(m0 + 8) * LD + c],
                            raw0[m0 * LD + c + 4],
                            raw0[(m0 + 8) * LD + c + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) split(x[j], ah[kk & 1][j], al[kk & 1][j]);
        wgmma_fence();
        const uint32_t at = fb + (kk >> 2) * (BLOCK * 128);
        const int step = 2 * (kk & 3);
        const uint64_t dh = sw128_desc(at) + step;
        const uint64_t dl = sw128_desc(at + P::FIX0) + step;
        Wgmma<NH>::mma(s_hh, ah[kk & 1], dh, kk > 0);
        Wgmma<NH>::mma(s_x, ah[kk & 1], dl, kk > 0);
        Wgmma<NH>::mma(s_x, al[kk & 1], dh, 1);
        wgmma_commit();
#pragma unroll
        for (int d = 8 * kk; d < 8 * kk + 8; d += 4) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(raw1 + m0 * LD + d);
          const float4 a1 =
              *reinterpret_cast<const float4*>(raw1 + (m0 + 8) * LD + d);
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const float4 bv = *reinterpret_cast<const float4*>(
                fixed1 + (wg * NH + 8 * (j >> 1) + 2 * t + (j & 1)) * LD + d);
            // element i = 4 (j / 2) + 2 h + j % 2 is row m0 + 8 h
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4& av = h ? a1 : a0;
              float& e = dp[4 * (j >> 1) + 2 * h + (j & 1)];
              e = fmaf(av.x, bv.x, e);
              e = fmaf(av.y, bv.y, e);
              e = fmaf(av.z, bv.z, e);
              e = fmaf(av.w, bv.w, e);
            }
          }
        }
      }
    }
    wgmma_wait<0>();                   // S, and the last tile's phase 2
    if (it > 0) add_phase2();
    __syncthreads();                   // both warpgroups' phase 2 is done

    // p and ds in f32 on the CUDA cores (ds cancels), stored split as
    // phase 2's K-major operands [block row][streamed row]: K index t of
    // each 8 holds streamed row 2t and t + 4 holds 2t + 1, the order phase
    // 2 gathers in
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      fence_operand(s_hh[i]);
      fence_operand(s_x[i]);
      const int r = m0 + 8 * ((i >> 1) & 1), sr = r0 + r;
      const int j = 2 * (i >> 2) + (i & 1);
      const int n = wg * NH + 8 * (i >> 2) + 2 * t + (i & 1), br = b0 + n;
      const int kx = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
      float l, dl;
      bool live;
      if (DQ) {          // rows are keys, columns queries
        l = col_lse[j];
        dl = col_delta[j];
        live = col_live[j] && sr < T && vec[r] > 0.0f &&
               (!causal || sr <= br);
      } else {           // rows are queries, columns keys
        l = vec[r];
        dl = vec[kS + r];
        live = col_live[j] && sr < T && l > 0.5f * kDeadLse &&
               (!causal || br <= sr);
      }
      const float pv = exp2f(live ? (s_hh[i] + s_x[i]) * scale_log2e -
                                        l * 1.4426950408889634f
                                  : -INFINITY);
      const float ds = pv * (dp[i] - dl);
      uint8_t* o = smem + sw_off(BLOCK, n, kx);
      uint32_t hi, lo;
      split(ds, hi, lo);
      *reinterpret_cast<uint32_t*>(o) = hi;
      *reinterpret_cast<uint32_t*>(o + P::OUT1) = lo;
      if (!DQ) {
        split(pv, hi, lo);
        *reinterpret_cast<uint32_t*>(o + 2 * P::OUT1) = hi;
        *reinterpret_cast<uint32_t*>(o + 3 * P::OUT1) = lo;
      }
    }
    fence_proxy_async();
    __syncthreads();

    // Phase 2 on the tensor cores: out^T[d][n] += sum over the tile's
    // streamed rows of raw^T[d][row] . tile[n][row] (m64n32, K = 64):
    // dk/dv: dk^T += q^T dS, dv^T += dout^T P; dq: dq^T += k^T dS^T.
    {
      uint32_t ah[4][2][4], al[4][2][4];
#pragma unroll
      for (int kk = 0; kk < kS / 8; ++kk) {
        if (kk >= 4) wgmma_wait<3>();  // step kk-4's registers are free
        uint32_t (&h)[2][4] = ah[kk & 3];
        uint32_t (&l)[2][4] = al[kk & 3];
        const int ra = 8 * kk + 2 * t;   // streamed rows of K index t, t+4
#pragma unroll
        for (int f = 0; f < (DQ ? 1 : 2); ++f) {
          const float* src = (f ? raw1 : raw0) + d0 + m0;
          const float x[4] = {src[ra * LD], src[ra * LD + 8],
                              src[(ra + 1) * LD], src[(ra + 1) * LD + 8]};
#pragma unroll
          for (int j = 0; j < 4; ++j) split(x[j], h[f][j], l[f][j]);
        }
        wgmma_fence();
        const uint32_t at = base + (kk >> 2) * (BLOCK * 128) + n0 * 128;
        const int step = 2 * (kk & 3);
        const uint64_t dsh = sw128_desc(at) + step;
        const uint64_t dsl = sw128_desc(at + P::OUT1) + step;
        Wgmma<32>::mma(f0h, h[0], dsh, kk > 0);
        Wgmma<32>::mma(f0x, h[0], dsl, kk > 0);
        Wgmma<32>::mma(f0x, l[0], dsh, 1);
        if (!DQ) {
          const uint64_t dph = sw128_desc(at + 2 * P::OUT1) + step;
          const uint64_t dpl = sw128_desc(at + 3 * P::OUT1) + step;
          Wgmma<32>::mma(f1h, h[1], dph, kk > 0);
          Wgmma<32>::mma(f1x, h[1], dpl, kk > 0);
          Wgmma<32>::mma(f1x, l[1], dph, 1);
        }
        wgmma_commit();
      }
    }
  }
  if (n_tiles > 0) add_phase2();
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = d0 + m0 + 8 * ((i >> 1) & 1);
    const int br = b0 + n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (d < D && br < T) {
      const size_t o = base_td + static_cast<size_t>(br) * D + d;
      out0[o] = acc0[i] * scale;
      if (!DQ) out1[o] = acc1[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forms: the forward, dq and dk/dv on wgmma, each after a split
// pre-pass
// ---------------------------------------------------------------------------
//
// The TPU kernels under precision("bfloat16") take bf16 q, k, v and dout,
// upcast them, keep the scores, the softmax, lse, delta, p and ds in f32,
// and round out, dq, dk and dv once (:133-177, :238-318).  Here every
// product whose operands are bf16 tensors (S = q k^T, dP = dout v^T, and the
// k, q, dout sides of the products with p and ds) is a bf16 product with
// f32 sums: a bf16 x bf16 product is exact in f32.  P and dS are f32
// intermediates: rounded to bf16 they would put outputs a bf16 ulp from the
// reference's function in ~12 % of elements, so each goes in as a bf16 hi
// + lo pair (hi = p to the nearest bf16, lo = p - hi to the nearest bf16),
// two products into one f32 sum, what 3xTF32 is to the f32 forms; the
// dropped lo.lo term is below 2^-16 of p.  The scale is applied to S in f32
// after the product.
//   flash_fwd_bf16<DP>  <- `_flash_fwd_kernel` :128 (launched by `_flash_fwd` :196)
//   flash_dq_bf16<DP>   <- `_flash_dq_kernel`  :238 (launched by `_flash_bwd` :341)
//   flash_dkv_bf16<DP>  <- `_flash_dkv_kernel` :274 (launched by `_flash_bwd` :357)
//
// Their bound at the long-context model's shape (B = 4, H = 8, T = 8192,
// D = 64, causal): 275, 412 and 550 GFLOP of one-pass bf16 products for
// the forward, dq and dk/dv, 0.28, 0.42 and 0.56 ms at the 989 TFLOP/s
// bf16 peak; the hi + lo split makes the work 1.5, 1.33 and 1.5 times that
// (0.42, 0.56 and 0.83 ms).  Operations bound all three: the forward's
// inputs and outputs are 136 MB, 0.04 ms at 3.35 TB/s.
//
// The three carry the f32 forward's plan over to bf16:
//  * Every product is one wgmma.m64nNk16 bf16 with f32 accumulators, issued by
//    the four warps of a warpgroup: mma.sync, the warp-level product, is a
//    fraction of the card's bf16 rate.  A warpgroup owns 64 rows (queries in
//    the forward and dq, keys in dk/dv) and streams the other side's tiles
//    through a ring of stages in shared memory, each tile one bulk copy counted
//    on mbarriers (B16Ring).  Nothing synchronises the block inside the loop.
//    No warp is set aside to load: ptxas gives a thread of a block with a
//    producer warpgroup 168 registers whatever setmaxnreg asks, so thread 0
//    loads between its own waits, never blocking on a stage.
//  * A split pre-pass (flash_fwd_bf16_split, flash_dq_bf16_split,
//    flash_dkv_bf16_split) writes each streamed tile once into a scratch as the
//    products read it, in K-major images with the 128-byte swizzle: the
//    forward's K [key][d] (B of S = Q K^T), V^T [d][key] (B of P V), the key
//    bias (0, or -inf for a masked key or one past T) and whether the tile has
//    such a key; dq's K and V [key][d] (B of S = Q K^T and dP = dO V^T), K^T
//    [d][key] (B of dQ += dS K), the key bias and the flag; dk/dv's Q and dO
//    [query][d] (B of S^T = K Q^T and dP^T = V dO^T), Q^T and dO^T [d][query]
//    (B of dK += dS^T Q and dV += P^T dO), lse log2(e) (+inf on a dead row, so
//    its p is 2^-inf = 0 with no test) and delta.  This, and not a
//    transposed-B wgmma on MN-major tiles, because dq and dk/dv read K or Q
//    and dO both ways and a plain bulk copy makes neither swizzled layout; a
//    TMA tensor map would, but needs 16-byte row strides (D % 8 == 0) where
//    the gate takes D % 4 == 0.  The pre-pass also zero-fills past T and in
//    [D, DP), so the loop does no bounds test; it costs 0.05 (forward) and
//    0.07 ms (dk/dv) at that shape on an H100.
//  * The block's own rows are A fragments in registers (Q in the forward;
//    Q and dO in dq, K and V in dk/dv at DP = 64), or K-major images in
//    shared memory (dq's Q and dO, dk/dv's K and V at DP = 128).  For
//    bf16 k16 the accumulator layout is the register-A fragment layout (a
//    thread's elements 8 j + 2 m and 8 j + 2 m + 1 are its A register m of
//    k-step j), so P, dS, P^T and dS^T go from the S, dP, S^T and dP^T
//    accumulators to A with only the hi + lo split (split_bf16x2): no
//    permutation, as the tf32 form needs, and no trip through shared
//    memory.
//  * The forward: three warpgroups (192 query rows) a block at DP = 64,
//    two at 128 (registers: S 32 + P hi, lo 32 + O 32 or 64 + Q 16 or 32
//    a thread); key tiles of 128 keys (64 at DP = 128), three stages,
//    taken in steps of 64 keys.  Each warpgroup issues step j's S with
//    step j - 1's P V behind it and waits for S alone, so the online
//    softmax of step j (f32, log2 domain) runs while the tensor cores do
//    P V.  O accumulates on the tensor cores over the row, rescaled by the
//    CUDA cores between steps; lse comes out as the natural log.
//  * dk/dv: 128 keys a block, 64 a warpgroup; tiles of 64 queries (three
//    stages at DP = 64, two at 128) in steps of 32.  Each step issues its
//    S^T and dP^T with the last step's dV += P^T_hi dO + P^T_lo dO and
//    dK += dS^T_hi Q + dS^T_lo Q behind them, and p^T and ds^T run on the
//    CUDA cores while those do.  dK is scaled once, then rounded once.
//  * dq: 128 queries a block, 64 a warpgroup; tiles of 64 keys (three
//    stages at DP = 64, two at 128), one step a tile.  Each step issues its
//    S = Q K^T and dP = dO V^T (m64n64) with the last step's dQ += dS_hi K
//    + dS_lo K behind them, and p = 2^(s scale log2(e) - lse log2(e)) and
//    dS = p (dP - delta) run on the CUDA cores while those do.  A thread's
//    two rows keep lse log2(e) (+inf on a dead row or past T, so p = 0
//    with no test) and delta in registers.  dQ accumulates on the tensor
//    cores over the row, and is scaled once, then rounded once.
//  * The softmax was the bottleneck, not the products (H100, that shape):
//    exp2f's guard for results below 2^-126 (a test, two multiplies) and
//    the bias and mask on every element made it ~17 instructions an
//    element and serialised the exponentials; ex2.approx.ftz, a step with
//    no masked key and off the diagonal taking p = 2^(s c - max) in one
//    FMA, and fences that keep the arithmetic before the next wait took
//    the forward from 1.45 to 1.0 ms and dk/dv from 2.1 to 1.9.  Issuing
//    S a step ahead (two S accumulators) made ptxas serialise the wgmmas;
//    the warpgroups taking turns on named barriers gained nothing.
//  * Causal: a warpgroup waits for and releases the tiles past its
//    diagonal without work, and masks only on diagonal steps.  The grid
//    sends each head's longest blocks first (the forward's and dq's last
//    query rows, dk/dv's first keys).

// Byte offset of element (row n, k) in a K-major bf16 image of `rows` rows
// stored as [k / 64][rows][64 bf16] atoms in the 128-byte swizzle (sw_off's
// layout with 2-byte elements).
__device__ __forceinline__ uint32_t sw16_off(int rows, int n, int k) {
  return (k >> 6) * (rows * 128) + n * 128 +
         ((((k & 63) >> 3) ^ (n & 7)) << 4) + (k & 7) * 2;
}

// The inverse of sw16_off: the row n and the first of the 8 k of 16-byte
// chunk c of such an image.
__device__ __forceinline__ void sw16_pos(int rows, int c, int& n, int& k) {
  const int atom = c / (rows * 8), rem = c - atom * rows * 8;
  n = rem >> 3;
  k = atom * 64 + (((rem & 7) ^ (n & 7)) << 3);
}

// The descriptor of k-step kk (16 deep, 32 bytes) of such an image at
// shared address `img`, all its rows.
__device__ __forceinline__ uint64_t img_desc(uint32_t img, int rows, int kk) {
  return sw128_desc(img + (kk >> 2) * (rows * 128)) + 2 * (kk & 3);
}

// Rows r0 + [0, R) of a [T][D] bf16 matrix into a [R][LD] tile in shared
// memory, zero past T and in [D, DP): 8-byte loads (D % 4 == 0, the base
// 16-byte aligned).
template <int R, int DP, int LD>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src,
                                           int r0, int T, int D, int i,
                                           int stride) {
  constexpr int C4 = DP / 4;
  for (int e = i; e < R * C4; e += stride) {
    const int r = e / C4, c4 = e - r * C4;
    uint2 x = make_uint2(0u, 0u);
    if (r0 + r < T && 4 * c4 < D)
      x = __ldg(reinterpret_cast<const uint2*>(
          src + static_cast<size_t>(r0 + r) * D + 4 * c4));
    *reinterpret_cast<uint2*>(dst + r * LD + 4 * c4) = x;
  }
}

// Chunk c of the K-major image of a [R][LD] bf16 tile in shared memory:
// the tile itself (image rows = its rows, k its columns) or, with `trans`,
// its transpose (image rows = its columns, k its rows).
template <int LD>
__device__ __forceinline__ uint4 image_chunk(const uint16_t* tile, int rows,
                                             int c, bool trans) {
  int n, k;
  sw16_pos(rows, c, n, k);
  if (!trans) return *reinterpret_cast<const uint4*>(tile + n * LD + k);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = tile[(k + 2 * j) * LD + n] |
           (static_cast<uint32_t>(tile[(k + 2 * j + 1) * LD + n]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows r0 + [0, 64) of a [T][D] bf16 matrix into a K-major image of 64 rows
// at `img` in shared memory, zero past T and in [D, DP), by the 128 threads
// of a warpgroup (i its thread); the caller fences and syncs.
template <int DP>
__device__ __forceinline__ void load_image64(uint8_t* img, const uint16_t* src,
                                             int r0, int T, int D, int i) {
  constexpr int C4 = DP / 4;
  for (int e = i; e < 64 * C4; e += 128) {
    const int n = e / C4, c4 = e - n * C4;
    uint2 x = make_uint2(0u, 0u);
    if (r0 + n < T && 4 * c4 < D)
      x = __ldg(reinterpret_cast<const uint2*>(
          src + static_cast<size_t>(r0 + n) * D + 4 * c4));
    *reinterpret_cast<uint2*>(img + sw16_off(64, n, 4 * c4)) = x;
  }
}

// Two f32 as the bf16 pair of one 32-bit store (the lower index low).
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
  return float_to_bf16_bits(x0) |
         (static_cast<uint32_t>(float_to_bf16_bits(x1)) << 16);
}

// 2^x by one MUFU.EX2 (ex2.approx.ftz.f32: relative error below 2^-22, a
// result below 2^-126 flushed to 0).  exp2f wraps each in a test and two
// multiplies for results below 2^-126, which cost the softmax a third of
// its instructions and serialise the exponentials.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the ring of streamed tiles ------------------------------------------

// Whether the phase of `bar` with this parity has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// A ring of ST stages of streamed tiles in shared memory, each tile one
// bulk copy counted on its stage's `full` mbarrier, released by every
// thread of the block on its `empty` one.  No warp is set aside to load:
// ptxas gives a thread of a block of 288 or 384 threads 168 registers
// whatever setmaxnreg asks, where two consumer warpgroups need ~200, so a
// block is its consumer warpgroups alone, and thread 0 issues the copies
// without ever blocking on a stage: tile `next` goes out once its stage's
// last tile is released, tried at every wait of thread 0 for a tile.
// Warpgroup 0 waits for every tile, so every tile is loaded.
template <int ST>
struct B16Ring {
  uint32_t ring, full, empty, tile_bytes, stage_bytes;
  const uint8_t* src;
  int n, next;

  __device__ __forceinline__ bool try_load() {
    if (next >= n) return false;
    const int st = next % ST;
    if (!mbar_test(empty + 8 * st, ((next / ST) & 1) ^ 1)) return false;
    mbar_arrive_expect_tx(full + 8 * st, tile_bytes);
    bulk_copy(ring + st * stage_bytes,
              src + static_cast<size_t>(next) * tile_bytes, tile_bytes,
              full + 8 * st);
    ++next;
    return true;
  }
  // Waits until tile `it` has arrived; the loading thread keeps the ring
  // filling meanwhile (and traps after a second of clock cycles, as
  // mbar_wait does).
  __device__ __forceinline__ void wait(int it, bool loads) {
    const uint32_t bar = full + 8 * (it % ST), parity = (it / ST) & 1;
    if (!loads) {
      mbar_wait(bar, parity);
      return;
    }
    const long long start = clock64();
    for (;;) {
      while (try_load()) {
      }
      if (mbar_test(bar, parity)) return;
      if (clock64() - start > 2000000000LL) __trap();
    }
  }
  __device__ __forceinline__ void release(int it) {
    mbar_arrive(empty + 8 * (it % ST));
  }
};

// Initialises a ring's mbarriers (thread 0), then the block syncs.
template <int ST>
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, blockDim.x);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The A fragments of rows r0 + g, r0 + g + 8 of a [T][D] bf16 matrix, all
// DP / 16 k-steps: register m of k-step kk holds head dims 16 kk + 2 t +
// 8 (m / 2) and the next, of row r0 + g + 8 (m % 2); zero past T and D.
template <int DP>
__device__ __forceinline__ void load_frags(uint32_t (&f)[DP / 16][4],
                                           const uint16_t* src, int r0,
                                           int T, int D, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = r0 + g + 8 * (m & 1), d = 16 * kk + 2 * t + 8 * (m >> 1);
      f[kk][m] = r < T && d < D ? __ldg(reinterpret_cast<const uint32_t*>(
                                      src + static_cast<size_t>(r) * D + d))
                                : 0u;
    }
}

// ---- the forward ----------------------------------------------------------

// The forward's plan: a block of NWG warpgroups of 64 query rows; key
// tiles of KT keys (the unit of the pre-pass and of a bulk copy), taken in
// steps of NK = 64.  Three warpgroups at DP = 64, where a thread's S, P and
// O take ~145 registers and a block of 384 threads gets 168: more warps to
// hide the softmax's latency; two at DP = 128 (~190 registers).
template <int DP>
struct FwdB16 {
  static constexpr int NWG = DP == 64 ? 3 : 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int ROWS = 64 * NWG;              // query rows of a block
  static constexpr int KT = DP == 64 ? 128 : 64;     // keys of a tile
  static constexpr int NK = 64;                      // keys of a step
  static constexpr int SPT = KT / NK;                // steps a tile
  static constexpr int NS = NK / 2;                  // S accumulators
  static constexpr int NO = DP / 2;                  // O accumulators
  static constexpr int KIMG = KT * DP * 2;           // the K or V^T image
  // a tile in the scratch: K, V^T, the key bias, and (16 bytes) whether
  // any key of the tile is masked or past T
  static constexpr int TILE = 2 * KIMG + KT * 4 + 16;
  static constexpr int STAGE = (TILE + 1023) / 1024 * 1024;
  static constexpr int STAGES = 3;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;
  static_assert(SMEM <= kSmemMax, "the plan exceeds a block's shared memory");
  static_assert(TILE % 16 == 0 && TILE < (1 << 20), "one bulk copy a tile");
  static_assert(KIMG % 1024 == 0, "images on the swizzle's 1 KB");
};

// The pre-pass: key tile `blockIdx.x` of head `blockIdx.y` into the
// scratch: K and V^T images, zero past T and in [D, DP), and the key bias.
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
flash_fwd_bf16_split(const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const float* __restrict__ mask,
                     uint8_t* __restrict__ scratch, int H, int T, int D) {
  using P = FwdB16<DP>;
  constexpr int KT = P::KT, LD = DP + 8, CH = P::KIMG / 16;
  __shared__ __align__(16) uint16_t ks[KT * LD], vs[KT * LD];
  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int k0 = tile * KT;
  const size_t base = static_cast<size_t>(bh) * T * D;
  stage_rows<KT, DP, LD>(ks, k + base, k0, T, D, tid, kSplitThreads);
  stage_rows<KT, DP, LD>(vs, v + base, k0, T, D, tid, kSplitThreads);
  __syncthreads();
  uint8_t* out =
      scratch + (static_cast<size_t>(bh) * gridDim.x + tile) * P::TILE;
  uint4* img = reinterpret_cast<uint4*>(out);
  for (int c = tid; c < CH; c += kSplitThreads) {
    img[c] = image_chunk<LD>(ks, KT, c, false);        // K [key][d]
    img[CH + c] = image_chunk<LD>(vs, DP, c, true);    // V^T [d][key]
  }
  const int key = k0 + tid;
  const bool live = tid < KT && key < T &&
                    mask[static_cast<size_t>(bh / H) * T + key] > 0.0f;
  if (tid < KT)
    reinterpret_cast<float*>(out + 2 * P::KIMG)[tid] = live ? 0.0f : -INFINITY;
  const int any_dead = __syncthreads_or(tid < KT && !live);
  if (tid == 0)
    *reinterpret_cast<int*>(out + 2 * P::KIMG + KT * 4) = any_dead;
}

template <int DP>
__global__ void __launch_bounds__(FwdB16<DP>::THREADS, 1)
flash_fwd_bf16(const uint16_t* __restrict__ q,
               const uint8_t* __restrict__ scratch, uint16_t* __restrict__ out,
               float* __restrict__ lse, int T, int D, int causal,
               float scale) {
  using P = FwdB16<DP>;
  constexpr int KT = P::KT, NK = P::NK, SPT = P::SPT, NS = P::NS;
  constexpr int NO = P::NO, ST = P::STAGES;
  constexpr int KS = NK / 16;                        // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's 1 KB
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + P::BARS, empty = full + 8 * ST;

  // every head's last query rows, which visit the most key tiles, first
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * P::ROWS;
  const int ntiles = (T + KT - 1) / KT;
  const int n_tiles = causal ? min(ntiles, (r0 + P::ROWS - 1) / KT + 1)
                             : ntiles;
  init_ring<ST>(full, empty);
  B16Ring<ST> ring{base, full, empty, P::TILE, P::STAGE,
                   scratch + static_cast<size_t>(bh) * ntiles * P::TILE,
                   n_tiles, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool loads = tid == 0;
  if (loads)
    while (ring.try_load()) {
    }

  // a warpgroup: query rows q0 + [0, 64); this thread's rows q0 + g and
  // q0 + g + 8, and the accumulators' columns 8 j + 2 t + {0, 1}; Q as the
  // A fragments of S = Q K^T, from registers
  const int wg = warp >> 2, t = lane & 3;
  const int g = 16 * (warp & 3) + (lane >> 2);
  const int q0 = r0 + 64 * wg;
  const size_t base_td = static_cast<size_t>(bh) * T * D;
  uint32_t qf[DP / 16][4];
  load_frags<DP>(qf, q + base_td, q0, T, D, g, t);

  const float sl2 = scale * 1.4426950408889634f;   // the log2 domain
  // the steps with a live key for these rows under `causal`
  const int n_steps =
      causal ? min(n_tiles * SPT, (q0 + 63) / NK + 1) : n_tiles * SPT;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[NO], s[NS], alpha[2];
  uint32_t ph[KS][4], pl[KS][4];     // the last step's P, hi and lo
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;

  auto stage_at = [&](int u) { return ((u / SPT) % ST) * P::STAGE; };
  auto fence_o_p = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_operand(o[i]);
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fence_reg(ph[j][m]);
        fence_reg(pl[j][m]);
      }
  };
  // S = Q K^T of step u into a fresh accumulator: B = rows (u % SPT) NK +
  // [0, NK) of the tile's K image
  auto issue_s = [&](int u) {
    const uint32_t kimg = base + stage_at(u) + (u % SPT) * NK * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t db = img_desc(kimg, KT, kk);
      if (kk == 0)
        WgmmaBf16<NK>::init(s, qf[kk], db);
      else
        WgmmaBf16<NK>::mma(s, qf[kk], db, 1);
    }
    wgmma_commit();
  };
  // O += P V of step u: A = P hi, then P lo, from registers; B = its
  // k-steps of the tile's V^T image
  auto issue_pv = [&](int u) {
    const uint32_t vt = base + stage_at(u) + P::KIMG;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t db = img_desc(vt, DP, (u % SPT) * KS + kk);
      WgmmaBf16<DP>::mma(o, ph[kk], db, 1);
      WgmmaBf16<DP>::mma(o, pl[kk], db, 1);
    }
    wgmma_commit();
  };
  // The online softmax of step u in f32 on the CUDA cores, in the log2
  // domain: x = s scale log2(e) + bias, the row max over the 4 threads of a
  // row, p = 2^(x - max) in place of s, alpha the rescale.  A step with no
  // masked key off the diagonal (most of them) skips the bias and the mask
  // and takes p = 2^(s scale log2(e) - max) in one FMA.
  auto softmax = [&](int u) {
    const int k0 = u * NK;
    const uint8_t* tile = smem + stage_at(u) + 2 * P::KIMG;
    const float* bias = reinterpret_cast<const float*>(tile) + (u % SPT) * NK;
    const bool diag = causal && k0 + NK - 1 > q0;
    const bool plain =
        !diag && !*reinterpret_cast<const int*>(tile + KT * 4) && sl2 > 0.0f;
    float mx[2] = {-INFINITY, -INFINITY};
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        fence_operand(s[i]);
        fence_operand(s[i + 1]);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fmaxf(s[i], s[i + 1]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[h] *= sl2;
    } else {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        fence_operand(s[i]);
        fence_operand(s[i + 1]);
        const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        float x0 = fmaf(s[i], sl2, b.x), x1 = fmaf(s[i + 1], sl2, b.y);
        if (diag && k0 + col > q0 + g + 8 * h) x0 = -INFINITY;
        if (diag && k0 + col + 1 > q0 + g + 8 * h) x1 = -INFINITY;
        s[i] = x0;
        s[i + 1] = x1;
        mx[h] = fmaxf(mx[h], fmaxf(x0, x1));
      }
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m2[h], mx[h]);
      mu[h] = m_new == -INFINITY ? 0.0f : m_new;   // no live key yet: p = 0
      alpha[h] = ex2(m2[h] - mu[h]);               // 0 while m2 is -inf
      m2[h] = m_new;
      l[h] *= alpha[h];                            // this thread's share
    }
    // p, and the row sums a pair at a time (elements i, i + 1 share a row)
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int h = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], sl2, -mu[h]));
        s[i + 1] = ex2(fmaf(s[i + 1], sl2, -mu[h]));
        l[h] += s[i] + s[i + 1];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int h = (i >> 1) & 1;
        s[i] = ex2(s[i] - mu[h]);
        s[i + 1] = ex2(s[i + 1] - mu[h]);
        l[h] += s[i] + s[i + 1];
      }
    }
  };
  // The wait asm orders memory, not registers: without these fences the
  // compiler sinks the softmax's arithmetic below the next wait, out of
  // the window where it overlaps the products.
  auto pin_softmax = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_operand(s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fence_operand(l[h]);
      fence_operand(alpha[h]);
      fence_operand(m2[h]);
    }
  };
  // O rescaled, then P as the A fragments of P V: elements 8 j + 2 m and
  // 8 j + 2 m + 1 are register m of k-step j
  auto rescale_split = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        split_bf16x2(s[8 * j + 2 * m], s[8 * j + 2 * m + 1], ph[j][m],
                     pl[j][m]);
  };

  // step 0 alone; then each step's S goes out with the last step's P V
  // behind it, and the softmax runs while the tensor cores do P V
  ring.wait(0, loads);
  issue_s(0);
  wgmma_wait<0>();
  softmax(0);
  rescale_split();
  for (int u = 1; u < n_steps; ++u) {
    if (u % SPT == 0) ring.wait(u / SPT, loads);
    fence_o_p();
    issue_s(u);
    issue_pv(u - 1);
    wgmma_wait<1>();                   // S
    softmax(u);
    pin_softmax();                     // done before the wait, not after
    wgmma_wait<0>();                   // the last step's P V
    fence_o_p();
    if (u % SPT == 0) ring.release(u / SPT - 1);   // its tile is done
    rescale_split();
  }
  fence_o_p();
  issue_pv(n_steps - 1);
  wgmma_wait<0>();
  fence_o_p();
  // the last tile these rows use, then those past their diagonal: waited
  // for and released
  ring.release((n_steps - 1) / SPT);
  for (int it = (n_steps - 1) / SPT + 1; it < n_tiles; ++it) {
    ring.wait(it, loads);
    ring.release(it);
  }

  // out = o / l and lse = (m2 + log2 l) ln 2 for the thread's two rows; a
  // row with no live key gives 0 and kDeadLse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = q0 + g + 8 * h;
    if (r >= T) continue;
    const bool live = l[h] > 0.0f;
    const float inv = live ? 1.0f / l[h] : 0.0f;
    uint16_t* row = out + base_td + static_cast<size_t>(r) * D;
#pragma unroll
    for (int i = 2 * h; i < NO; i += 4) {
      const int d = 8 * (i >> 2) + 2 * t;   // elements i, i + 1
      if (d < D)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack_bf16x2(o[i] * inv, o[i + 1] * inv);
    }
    if (t == 0)
      lse[static_cast<size_t>(bh) * T + r] =
          live ? (m2[h] + log2f(l[h])) * 0.6931471805599453f : kDeadLse;
  }
}

// ---- dk/dv ----------------------------------------------------------------

// The dk/dv kernel's plan: a block of two warpgroups of 64 keys; query
// tiles of QT queries, taken in steps of NQ: S^T and dP^T are m64n32, so
// that one step's P^T and dS^T fragments and the next step's scores fit in
// the registers beside dK and dV.  K and V are A fragments in registers at
// DP = 64 (KVR), K-major images in shared memory at DP = 128.
template <int DP>
struct DkvB16 {
  static constexpr int KEYS = 128;                   // keys of a block
  static constexpr int QT = 64;                      // queries of a tile
  static constexpr int NQ = 32;                      // queries of a step
  static constexpr int SPT = QT / NQ;                // steps a tile
  static constexpr int KQ = NQ / 16;                 // k-steps of a step
  static constexpr int NO = DP / 2;                  // dK, dV accumulators
  static constexpr bool KVR = DP == 64;
  static constexpr int IMG = QT * DP * 2;            // one image of a tile
  // a tile in the scratch: Q and dO [query][d], Q^T and dO^T [d][query],
  // lse and delta
  static constexpr int TILE = 4 * IMG + 2 * QT * 4;
  static constexpr int STAGE = (TILE + 1023) / 1024 * 1024;
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr int FIX = 64 * DP * 2;            // a warpgroup's K or V
  static constexpr int RING = KVR ? 0 : 2 * 2 * FIX;
  static constexpr int THREADS = 256;                // two warpgroups
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;
  static_assert(SMEM <= kSmemMax, "the plan exceeds a block's shared memory");
  static_assert(TILE % 16 == 0 && TILE < (1 << 20), "one bulk copy a tile");
  static_assert(IMG % 1024 == 0 && FIX % 1024 == 0 && NQ % 8 == 0,
                "images on the swizzle's 1 KB");
};

// The pre-pass: query tile `blockIdx.x` of head `blockIdx.y` into the
// scratch: Q, dO, Q^T and dO^T images, zero past T and in [D, DP), then
// lse log2(e) (+inf for a dead row or past T) and delta (0 past T).
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
flash_dkv_bf16_split(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     uint8_t* __restrict__ scratch, int T, int D) {
  using P = DkvB16<DP>;
  constexpr int QT = P::QT, LD = DP + 8, CH = P::IMG / 16;
  __shared__ __align__(16) uint16_t qs[QT * LD], gs[QT * LD];
  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int q0 = tile * QT;
  const size_t base = static_cast<size_t>(bh) * T * D;
  stage_rows<QT, DP, LD>(qs, q + base, q0, T, D, tid, kSplitThreads);
  stage_rows<QT, DP, LD>(gs, dout + base, q0, T, D, tid, kSplitThreads);
  __syncthreads();
  uint8_t* out =
      scratch + (static_cast<size_t>(bh) * gridDim.x + tile) * P::TILE;
  uint4* img = reinterpret_cast<uint4*>(out);
  for (int c = tid; c < CH; c += kSplitThreads) {
    img[c] = image_chunk<LD>(qs, QT, c, false);          // Q [query][d]
    img[CH + c] = image_chunk<LD>(gs, QT, c, false);     // dO
    img[2 * CH + c] = image_chunk<LD>(qs, DP, c, true);  // Q^T [d][query]
    img[3 * CH + c] = image_chunk<LD>(gs, DP, c, true);  // dO^T
  }
  if (tid < QT) {
    const bool ok = q0 + tid < T;
    const size_t r = static_cast<size_t>(bh) * T + q0 + tid;
    const float l = ok ? lse[r] : kDeadLse;
    float* vec = reinterpret_cast<float*>(out + 4 * P::IMG);
    // lse log2(e), and +inf for a row with no live key: its p = 2^-inf = 0
    vec[tid] = l > 0.5f * kDeadLse ? l * 1.4426950408889634f : INFINITY;
    vec[QT + tid] = ok ? delta[r] : 0.0f;
  }
}

template <int DP>
__global__ void __launch_bounds__(DkvB16<DP>::THREADS, 1)
flash_dkv_bf16(const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
               const float* __restrict__ mask,
               const uint8_t* __restrict__ scratch, uint16_t* __restrict__ dk,
               uint16_t* __restrict__ dv, int H, int T, int D, int causal,
               float scale) {
  using P = DkvB16<DP>;
  constexpr int QT = P::QT, NQ = P::NQ, SPT = P::SPT, KQ = P::KQ;
  constexpr int NO = P::NO, ST = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's 1 KB
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + P::BARS, empty = full + 8 * ST;

  // every head's first keys, which see the most query tiles, first
  const int bh = blockIdx.x, b0 = blockIdx.y * P::KEYS;
  const int ntq = (T + QT - 1) / QT;
  const int first = causal ? b0 / QT : 0;
  const int n_tiles = ntq - first;
  init_ring<ST>(full, empty);
  B16Ring<ST> ring{base + P::RING, full, empty, P::TILE, P::STAGE,
                   scratch + (static_cast<size_t>(bh) * ntq + first) * P::TILE,
                   n_tiles, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool loads = tid == 0;
  if (loads)
    while (ring.try_load()) {
    }

  // a warpgroup: keys kw0 + [0, 64); this thread's keys kw0 + g and
  // kw0 + g + 8, and the accumulators' columns 8 j + 2 t + {0, 1} (queries
  // in S^T and dP^T, head dims in dK and dV); K and V as the A operands of
  // S^T and dP^T
  const int wg = warp >> 2, t = lane & 3;
  const int g = 16 * (warp & 3) + (lane >> 2);
  const int kw0 = b0 + 64 * wg;
  const size_t base_td = static_cast<size_t>(bh) * T * D;
  constexpr int KF = P::KVR ? DP / 16 : 1;
  uint32_t kf[KF][4], vf[KF][4];
  const uint32_t kimg = base + wg * 2 * P::FIX, vimg = kimg + P::FIX;
  if constexpr (P::KVR) {
    load_frags<DP>(kf, k + base_td, kw0, T, D, g, t);
    load_frags<DP>(vf, v + base_td, kw0, T, D, g, t);
  } else {
    load_image64<DP>(smem + wg * 2 * P::FIX, k + base_td, kw0, T, D,
                     tid & 127);
    load_image64<DP>(smem + wg * 2 * P::FIX + P::FIX, v + base_td, kw0, T, D,
                     tid & 127);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  const float* maskb = mask + static_cast<size_t>(bh / H) * T;
  bool key_live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    key_live[h] = key < T && maskb[key] > 0.0f;
  }
  // whether a key of this warp's 16 is masked or past T (warp-uniform)
  const bool warp_dead = __any_sync(0xffffffffu, !key_live[0] || !key_live[1]);
  const float sl2 = scale * 1.4426950408889634f;   // the log2 domain
  float adk[NO], adv[NO], s[NQ / 2], dp[NQ / 2];
  uint32_t ph[KQ][4], pl[KQ][4], dh[KQ][4], dl[KQ][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) adk[i] = adv[i] = 0.0f;

  // under `causal` the tiles before it0 hold only queries before these
  // keys: waited for and released; then U steps of NQ queries
  const int it0 = causal ? min(n_tiles, (kw0 - b0) / QT) : 0;
  for (int it = 0; it < it0; ++it) {
    ring.wait(it, loads);
    ring.release(it);
  }
  const int U = (n_tiles - it0) * SPT;
  auto stage_at = [&](int u) {
    return base + P::RING + ((it0 + u / SPT) % ST) * P::STAGE;
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      fence_operand(adk[i]);
      fence_operand(adv[i]);
    }
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fence_reg(ph[j][m]);
        fence_reg(pl[j][m]);
        fence_reg(dh[j][m]);
        fence_reg(dl[j][m]);
      }
  };
  // S^T = K Q^T and dP^T = V dO^T of step u into fresh accumulators: B =
  // rows (u % SPT) NQ + [0, NQ) of the Q and dO images
  auto issue_sdp = [&](int u) {
    const uint32_t stage = stage_at(u) + (u % SPT) * NQ * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dqb = img_desc(stage, QT, kk);
      const uint64_t ddo = img_desc(stage + P::IMG, QT, kk);
      if constexpr (P::KVR) {
        if (kk == 0) {
          WgmmaBf16<NQ>::init(s, kf[kk], dqb);
          WgmmaBf16<NQ>::init(dp, vf[kk], ddo);
        } else {
          WgmmaBf16<NQ>::mma(s, kf[kk], dqb, 1);
          WgmmaBf16<NQ>::mma(dp, vf[kk], ddo, 1);
        }
      } else {
        const uint64_t dka = img_desc(kimg, 64, kk);
        const uint64_t dva = img_desc(vimg, 64, kk);
        if (kk == 0) {
          WgmmaBf16SS<NQ>::init(s, dka, dqb);
          WgmmaBf16SS<NQ>::init(dp, dva, ddo);
        } else {
          WgmmaBf16SS<NQ>::mma(s, dka, dqb, 1);
          WgmmaBf16SS<NQ>::mma(dp, dva, ddo, 1);
        }
      }
    }
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q of step u, hi and lo each: B = its
  // k-steps of the dO^T and Q^T images
  auto issue_dkv = [&](int u) {
    const uint32_t stage = stage_at(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int kg = (u % SPT) * KQ + kk;
      const uint64_t dgt = img_desc(stage + 3 * P::IMG, DP, kg);
      const uint64_t dqt = img_desc(stage + 2 * P::IMG, DP, kg);
      WgmmaBf16<DP>::mma(adv, ph[kk], dgt, 1);
      WgmmaBf16<DP>::mma(adv, pl[kk], dgt, 1);
      WgmmaBf16<DP>::mma(adk, dh[kk], dqt, 1);
      WgmmaBf16<DP>::mma(adk, dl[kk], dqt, 1);
    }
    wgmma_commit();
  };
  // p^T from lse, the exponent clamped on dead pairs and rows (0, never
  // inf), and ds^T = p^T (dP^T - delta) of step u, in f32 in place of s
  // and dp (row = key, column = query)
  // A step off the diagonal whose warp has no dead key (most of them)
  // skips the mask: lse log2(e) is +inf on dead rows.
  auto probs = [&](int u) {
    const int q0 = (first + it0 + u / SPT) * QT + (u % SPT) * NQ;
    const float* qlse = reinterpret_cast<const float*>(
        smem + (stage_at(u) - base) + 4 * P::IMG) + (u % SPT) * NQ;
    const float* qdelta = qlse + QT;
    const bool diag = causal && q0 < kw0 + 63;
    if (!diag && !warp_dead) {
#pragma unroll
      for (int i = 0; i < NQ / 2; i += 2) {
        fence_operand(s[i]);
        fence_operand(s[i + 1]);
        fence_operand(dp[i]);
        fence_operand(dp[i + 1]);
        const int col = 8 * (i >> 2) + 2 * t;
        const float2 ql = *reinterpret_cast<const float2*>(qlse + col);
        const float2 dl = *reinterpret_cast<const float2*>(qdelta + col);
        const float p0 = ex2(fmaf(s[i], sl2, -ql.x));
        const float p1 = ex2(fmaf(s[i + 1], sl2, -ql.y));
        s[i] = p0;
        s[i + 1] = p1;
        dp[i] = p0 * (dp[i] - dl.x);
        dp[i + 1] = p1 * (dp[i + 1] - dl.y);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {
        fence_operand(s[i]);
        fence_operand(dp[i]);
        const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
        const bool live =
            key_live[h] && (!diag || kw0 + g + 8 * h <= q0 + col);
        const float p = ex2(live ? fmaf(s[i], sl2, -qlse[col]) : -INFINITY);
        s[i] = p;
        dp[i] = p * (dp[i] - qdelta[col]);
      }
    }
  };
  // P^T and dS^T as the A fragments: elements 8 j + 2 m and 8 j + 2 m + 1
  // are register m of k-step j
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < KQ; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        split_bf16x2(s[8 * j + 2 * m], s[8 * j + 2 * m + 1], ph[j][m],
                     pl[j][m]);
        split_bf16x2(dp[8 * j + 2 * m], dp[8 * j + 2 * m + 1], dh[j][m],
                     dl[j][m]);
      }
  };

  // step 0 alone; then each step's S^T and dP^T go out with the last
  // step's dV and dK products behind them, and p^T and ds^T run while the
  // tensor cores do those
  if (U > 0) {
    ring.wait(it0, loads);
    issue_sdp(0);
    wgmma_wait<0>();
    probs(0);
    split();
    for (int u = 1; u < U; ++u) {
      if (u % SPT == 0) ring.wait(it0 + u / SPT, loads);
      fence_acc();
      issue_sdp(u);
      issue_dkv(u - 1);
      wgmma_wait<1>();                 // S^T and dP^T
      probs(u);
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {   // done before the wait, not after
        fence_operand(s[i]);
        fence_operand(dp[i]);
      }
      wgmma_wait<0>();                 // the last step's dV and dK
      fence_acc();
      if (u % SPT == 0) ring.release(it0 + (u - 1) / SPT);
      split();
    }
    fence_acc();
    issue_dkv(U - 1);
    wgmma_wait<0>();
    fence_acc();
    ring.release(it0 + (U - 1) / SPT);
  }

  // dk = adk scale and dv = adv, each rounded once, for the thread's keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    if (key >= T) continue;
    const size_t row = base_td + static_cast<size_t>(key) * D;
#pragma unroll
    for (int i = 2 * h; i < NO; i += 4) {
      const int d = 8 * (i >> 2) + 2 * t;   // elements i, i + 1
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dk + row + d) =
            pack_bf16x2(adk[i] * scale, adk[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + d) =
            pack_bf16x2(adv[i], adv[i + 1]);
      }
    }
  }
}

// ---- dq -------------------------------------------------------------------

// The dq kernel's plan: a block of two warpgroups of 64 query rows; key
// tiles of KT = 64 keys, one step a tile: S and dP are m64n64, and a
// thread's S, dP, dS hi + lo and dQ take ~130 registers at DP = 64, ~160 at
// 128, beside Q and dO in registers at DP = 64 (QR), K-major images in
// shared memory at DP = 128.
template <int DP>
struct DqB16 {
  static constexpr int ROWS = 128;                   // queries of a block
  static constexpr int KT = 64;                      // keys of a tile
  static constexpr int NS = KT / 2;                  // S, dP accumulators
  static constexpr int KK = KT / 16;                 // k-steps of dS K
  static constexpr int NO = DP / 2;                  // dQ accumulators
  static constexpr bool QR = DP == 64;
  static constexpr int IMG = KT * DP * 2;            // one image of a tile
  // a tile in the scratch: K and V [key][d], K^T [d][key], the key bias,
  // and (16 bytes) whether any key of the tile is masked or past T
  static constexpr int TILE = 3 * IMG + KT * 4 + 16;
  static constexpr int STAGE = (TILE + 1023) / 1024 * 1024;
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr int FIX = 64 * DP * 2;            // a warpgroup's Q or dO
  static constexpr int RING = QR ? 0 : 2 * 2 * FIX;
  static constexpr int THREADS = 256;                // two warpgroups
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;
  static_assert(SMEM <= kSmemMax, "the plan exceeds a block's shared memory");
  static_assert(TILE % 16 == 0 && TILE < (1 << 20), "one bulk copy a tile");
  static_assert(IMG % 1024 == 0 && FIX % 1024 == 0,
                "images on the swizzle's 1 KB");
};

// The pre-pass: key tile `blockIdx.x` of head `blockIdx.y` into the
// scratch: K, V and K^T images, zero past T and in [D, DP), then the key
// bias and the flag.
template <int DP>
__global__ void __launch_bounds__(kSplitThreads)
flash_dq_bf16_split(const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const float* __restrict__ mask,
                    uint8_t* __restrict__ scratch, int H, int T, int D) {
  using P = DqB16<DP>;
  constexpr int KT = P::KT, LD = DP + 8, CH = P::IMG / 16;
  __shared__ __align__(16) uint16_t ks[KT * LD], vs[KT * LD];
  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int k0 = tile * KT;
  const size_t base = static_cast<size_t>(bh) * T * D;
  stage_rows<KT, DP, LD>(ks, k + base, k0, T, D, tid, kSplitThreads);
  stage_rows<KT, DP, LD>(vs, v + base, k0, T, D, tid, kSplitThreads);
  __syncthreads();
  uint8_t* out =
      scratch + (static_cast<size_t>(bh) * gridDim.x + tile) * P::TILE;
  uint4* img = reinterpret_cast<uint4*>(out);
  for (int c = tid; c < CH; c += kSplitThreads) {
    img[c] = image_chunk<LD>(ks, KT, c, false);          // K [key][d]
    img[CH + c] = image_chunk<LD>(vs, KT, c, false);     // V [key][d]
    img[2 * CH + c] = image_chunk<LD>(ks, DP, c, true);  // K^T [d][key]
  }
  const int key = k0 + tid;
  const bool live = tid < KT && key < T &&
                    mask[static_cast<size_t>(bh / H) * T + key] > 0.0f;
  if (tid < KT)
    reinterpret_cast<float*>(out + 3 * P::IMG)[tid] = live ? 0.0f : -INFINITY;
  const int any_dead = __syncthreads_or(tid < KT && !live);
  if (tid == 0)
    *reinterpret_cast<int*>(out + 3 * P::IMG + KT * 4) = any_dead;
}

template <int DP>
__global__ void __launch_bounds__(DqB16<DP>::THREADS, 1)
flash_dq_bf16(const uint16_t* __restrict__ q,
              const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const uint8_t* __restrict__ scratch, uint16_t* __restrict__ dq,
              int T, int D, int causal, float scale) {
  using P = DqB16<DP>;
  constexpr int KT = P::KT, NS = P::NS, KK = P::KK, NO = P::NO;
  constexpr int ST = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;   // the swizzle's 1 KB
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + P::BARS, empty = full + 8 * ST;

  // every head's last query rows, which visit the most key tiles, first
  const int bh = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * P::ROWS;
  const int ntiles = (T + KT - 1) / KT;
  const int n_tiles = causal ? min(ntiles, (r0 + P::ROWS - 1) / KT + 1)
                             : ntiles;
  init_ring<ST>(full, empty);
  B16Ring<ST> ring{base + P::RING, full, empty, P::TILE, P::STAGE,
                   scratch + static_cast<size_t>(bh) * ntiles * P::TILE,
                   n_tiles, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool loads = tid == 0;
  if (loads)
    while (ring.try_load()) {
    }

  // a warpgroup: query rows q0 + [0, 64); this thread's rows q0 + g and
  // q0 + g + 8, and the accumulators' columns 8 j + 2 t + {0, 1} (keys in
  // S and dP, head dims in dQ); Q and dO as the A operands of S and dP
  const int wg = warp >> 2, t = lane & 3;
  const int g = 16 * (warp & 3) + (lane >> 2);
  const int q0 = r0 + 64 * wg;
  const size_t base_td = static_cast<size_t>(bh) * T * D;
  constexpr int QF = P::QR ? DP / 16 : 1;
  uint32_t qf[QF][4], of[QF][4];
  const uint32_t qimg = base + wg * 2 * P::FIX, oimg = qimg + P::FIX;
  if constexpr (P::QR) {
    load_frags<DP>(qf, q + base_td, q0, T, D, g, t);
    load_frags<DP>(of, dout + base_td, q0, T, D, g, t);
  } else {
    load_image64<DP>(smem + wg * 2 * P::FIX, q + base_td, q0, T, D,
                     tid & 127);
    load_image64<DP>(smem + wg * 2 * P::FIX + P::FIX, dout + base_td, q0, T,
                     D, tid & 127);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  // the rows' lse log2(e), +inf on a dead row or past T (p = 2^-inf = 0
  // with no test), and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + g + 8 * h;
    const float l = r < T ? lse[static_cast<size_t>(bh) * T + r] : kDeadLse;
    lse2[h] = l > 0.5f * kDeadLse ? l * 1.4426950408889634f : INFINITY;
    dlt[h] = r < T ? delta[static_cast<size_t>(bh) * T + r] : 0.0f;
  }
  const float sl2 = scale * 1.4426950408889634f;   // the log2 domain
  float acc[NO], s[NS], dp[NS];
  uint32_t dh[KK][4], dl[KK][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;

  // the steps with a live key for these rows under `causal` (none for rows
  // past T); the tiles after them are waited for and released
  const int U = q0 >= T ? 0 : causal ? min(n_tiles, q0 / KT + 1) : n_tiles;
  auto stage_at = [&](int u) { return base + P::RING + (u % ST) * P::STAGE; };
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int j = 0; j < KK; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        fence_reg(dh[j][m]);
        fence_reg(dl[j][m]);
      }
  };
  // S = Q K^T and dP = dO V^T of step u into fresh accumulators: B = the
  // tile's K and V images
  auto issue_sdp = [&](int u) {
    const uint32_t stage = stage_at(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dkb = img_desc(stage, KT, kk);
      const uint64_t dvb = img_desc(stage + P::IMG, KT, kk);
      if constexpr (P::QR) {
        if (kk == 0) {
          WgmmaBf16<KT>::init(s, qf[kk], dkb);
          WgmmaBf16<KT>::init(dp, of[kk], dvb);
        } else {
          WgmmaBf16<KT>::mma(s, qf[kk], dkb, 1);
          WgmmaBf16<KT>::mma(dp, of[kk], dvb, 1);
        }
      } else {
        const uint64_t dqa = img_desc(qimg, 64, kk);
        const uint64_t doa = img_desc(oimg, 64, kk);
        if (kk == 0) {
          WgmmaBf16SS<KT>::init(s, dqa, dkb);
          WgmmaBf16SS<KT>::init(dp, doa, dvb);
        } else {
          WgmmaBf16SS<KT>::mma(s, dqa, dkb, 1);
          WgmmaBf16SS<KT>::mma(dp, doa, dvb, 1);
        }
      }
    }
    wgmma_commit();
  };
  // dQ += dS K of step u, hi and lo: B = the k-steps of the tile's K^T
  // image
  auto issue_dq = [&](int u) {
    const uint32_t kt = stage_at(u) + 2 * P::IMG;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t db = img_desc(kt, DP, kk);
      WgmmaBf16<DP>::mma(acc, dh[kk], db, 1);
      WgmmaBf16<DP>::mma(acc, dl[kk], db, 1);
    }
    wgmma_commit();
  };
  // p from lse, the exponent clamped on dead pairs (0, never inf), and
  // dS = p (dP - delta) of step u, in f32 in place of dp (row = query,
  // column = key).  A step off the diagonal whose tile has no masked key
  // (most of them) takes p in one FMA and an EX2.
  auto probs = [&](int u) {
    const int k0 = u * KT;
    const uint8_t* tile = smem + (stage_at(u) - base) + 3 * P::IMG;
    const float* bias = reinterpret_cast<const float*>(tile);
    const bool diag = causal && k0 + KT - 1 > q0;
    if (!diag && !*reinterpret_cast<const int*>(tile + KT * 4)) {
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        fence_operand(s[i]);
        fence_operand(s[i + 1]);
        fence_operand(dp[i]);
        fence_operand(dp[i + 1]);
        const int h = (i >> 1) & 1;
        const float p0 = ex2(fmaf(s[i], sl2, -lse2[h]));
        const float p1 = ex2(fmaf(s[i + 1], sl2, -lse2[h]));
        dp[i] = p0 * (dp[i] - dlt[h]);
        dp[i + 1] = p1 * (dp[i + 1] - dlt[h]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        fence_operand(s[i]);
        fence_operand(dp[i]);
        const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
        const bool live =
            bias[col] == 0.0f && (!diag || k0 + col <= q0 + g + 8 * h);
        const float p = ex2(live ? fmaf(s[i], sl2, -lse2[h]) : -INFINITY);
        dp[i] = p * (dp[i] - dlt[h]);
      }
    }
  };
  // dS as the A fragments: elements 8 j + 2 m and 8 j + 2 m + 1 are
  // register m of k-step j
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < KK; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        split_bf16x2(dp[8 * j + 2 * m], dp[8 * j + 2 * m + 1], dh[j][m],
                     dl[j][m]);
  };

  // step 0 alone; then each step's S and dP go out with the last step's
  // dQ products behind them, and p and dS run while the tensor cores do
  // those
  if (U > 0) {
    ring.wait(0, loads);
    issue_sdp(0);
    wgmma_wait<0>();
    probs(0);
    split();
    for (int u = 1; u < U; ++u) {
      ring.wait(u, loads);
      fence_acc();
      issue_sdp(u);
      issue_dq(u - 1);
      wgmma_wait<1>();                 // S and dP
      probs(u);
#pragma unroll
      for (int i = 0; i < NS; ++i) {   // done before the wait, not after
        fence_operand(s[i]);
        fence_operand(dp[i]);
      }
      wgmma_wait<0>();                 // the last step's dQ
      fence_acc();
      ring.release(u - 1);
      split();
    }
    fence_acc();
    issue_dq(U - 1);
    wgmma_wait<0>();
    fence_acc();
    ring.release(U - 1);
  }
  for (int it = U; it < n_tiles; ++it) {
    ring.wait(it, loads);
    ring.release(it);
  }

  // dq = acc scale, rounded once, for the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + g + 8 * h;
    if (r >= T) continue;
    uint16_t* row = dq + base_td + static_cast<size_t>(r) * D;
#pragma unroll
    for (int i = 2 * h; i < NO; i += 4) {
      const int d = 8 * (i >> 2) + 2 * t;   // elements i, i + 1
      if (d < D)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack_bf16x2(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

bool bad_shape(int BH, int H, int T, int D) {
  return BH < 1 || H < 1 || BH % H != 0 || BH > 65535 || T < 1 || D < 4 ||
         D > 128 || D % 4 != 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DPAD>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* mask, float* out, float* lse, uint8_t* scratch,
               int BH, int H, int T, int D, int causal, float scale,
               cudaStream_t stream) {
  using P = Fwd<DPAD>;
  const int ntiles = (T + P::KT - 1) / P::KT;
  const int nq = (T + P::ROWS - 1) / P::ROWS;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_split<DPAD><<<dim3(ntiles, BH), kSplitThreads, 0, stream>>>(
      k, v, mask, scratch, H, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_fwd<DPAD>, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd<DPAD><<<dim3(BH, nq), P::THREADS, P::SMEM, stream>>>(
      q, scratch, out, lse, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD, bool DQ>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* mask, const float* dout, const float* lse,
               const float* delta, float* out0, float* out1, int BH, int H,
               int T, int D, int causal, float scale, cudaStream_t stream) {
  using P = Bwd<DPAD, DQ>;
  const int blocks = (T + P::BLOCK - 1) / P::BLOCK;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_bwd<DPAD, DQ>, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, blocks);
  flash_bwd<DPAD, DQ><<<grid, kBwdThreads, P::SMEM, stream>>>(
      q, k, v, mask, dout, lse, delta, out0, out1, H, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fwd_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                    const float* mask, uint16_t* out, float* lse,
                    uint8_t* scratch, int BH, int H, int T, int D, int causal,
                    float scale, cudaStream_t stream) {
  using P = FwdB16<DP>;
  const int ntiles = (T + P::KT - 1) / P::KT;
  const int nq = (T + P::ROWS - 1) / P::ROWS;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_bf16_split<DP><<<dim3(ntiles, BH), kSplitThreads, 0, stream>>>(
      k, v, mask, scratch, H, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_fwd_bf16<DP>, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16<DP><<<dim3(BH, nq), P::THREADS, P::SMEM, stream>>>(
      q, scratch, out, lse, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                   const float* mask, const uint16_t* dout, const float* lse,
                   const float* delta, uint16_t* dq, uint8_t* scratch, int BH,
                   int H, int T, int D, int causal, float scale,
                   cudaStream_t stream) {
  using P = DqB16<DP>;
  const int ntiles = (T + P::KT - 1) / P::KT;
  const int blocks = (T + P::ROWS - 1) / P::ROWS;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_dq_bf16_split<DP><<<dim3(ntiles, BH), kSplitThreads, 0, stream>>>(
      k, v, mask, scratch, H, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_dq_bf16<DP>, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_bf16<DP><<<dim3(BH, blocks), P::THREADS, P::SMEM, stream>>>(
      q, dout, lse, delta, scratch, dq, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                    const float* mask, const uint16_t* dout, const float* lse,
                    const float* delta, uint16_t* dk, uint16_t* dv,
                    uint8_t* scratch, int BH, int H, int T, int D, int causal,
                    float scale, cudaStream_t stream) {
  using P = DkvB16<DP>;
  const int ntq = (T + P::QT - 1) / P::QT;
  const int blocks = (T + P::KEYS - 1) / P::KEYS;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_dkv_bf16_split<DP><<<dim3(ntq, BH), kSplitThreads, 0, stream>>>(
      q, dout, lse, delta, scratch, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_dkv_bf16<DP>, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_bf16<DP><<<dim3(BH, blocks), P::THREADS, P::SMEM,
                                                   stream>>>(
      k, v, mask, scratch, dk, dv, H, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [BH, T, D] and lse [BH, T] from q, k, v [BH, T, D] and the key mask
// [BH / H, T]; all f32, contiguous, on the device.  `scratch` holds
// BH * ceil(T / KT) tiles of TILE bytes (Fwd<DPAD>: KT = 64 and TILE =
// 65,792 for D <= 64, else 32 and 65,664), 16-byte aligned, for the split
// pre-pass; it is overwritten.  Launches the pre-pass and the kernel on
// `stream` and returns a CUDA error code (0 on success).
int dl4j_flash_fwd_f32(const float* q, const float* k, const float* v,
                       const float* mask, float* out, float* lse,
                       void* scratch, int BH, int H, int T, int D, int causal,
                       float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  return D <= 64 ? launch_fwd<64>(q, k, v, mask, out, lse, sc, BH, H, T, D,
                                  causal, scale, s)
                 : launch_fwd<128>(q, k, v, mask, out, lse, sc, BH, H, T, D,
                                   causal, scale, s);
}

// dq [BH, T, D] from q, k, v, dout [BH, T, D], the key mask [BH / H, T], and
// lse, delta [BH, T].
int dl4j_flash_dq_f32(const float* q, const float* k, const float* v,
                      const float* mask, const float* dout, const float* lse,
                      const float* delta, float* dq, int BH, int H, int T,
                      int D, int causal, float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_bwd<64, true>(q, k, v, mask, dout, lse, delta, dq,
                                        nullptr, BH, H, T, D, causal, scale,
                                        s)
                 : launch_bwd<128, true>(q, k, v, mask, dout, lse, delta, dq,
                                         nullptr, BH, H, T, D, causal, scale,
                                         s);
}

// dk, dv [BH, T, D] from the same inputs as dl4j_flash_dq_f32.
int dl4j_flash_dkv_f32(const float* q, const float* k, const float* v,
                       const float* mask, const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int BH, int H,
                       int T, int D, int causal, float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_bwd<64, false>(q, k, v, mask, dout, lse, delta, dk,
                                         dv, BH, H, T, D, causal, scale, s)
                 : launch_bwd<128, false>(q, k, v, mask, dout, lse, delta,
                                          dk, dv, BH, H, T, D, causal, scale,
                                          s);
}

// The bf16 forms: q, k, v (and dout) bf16 [BH, T, D], the key mask, lse and
// delta f32; out (dq, dk, dv) bf16, lse f32.  Each takes a scratch for its
// split pre-pass, 16-byte aligned, overwritten: the forward BH * ceil(T /
// KT) tiles of FwdB16<DP>::TILE bytes (KT = 128 and TILE = 33,280 for
// D <= 64, else 64 and 33,024), dq BH * ceil(T / 64) tiles of
// DqB16<DP>::TILE bytes (24,848 for D <= 64, else 49,424), dk/dv
// BH * ceil(T / 64) tiles of DkvB16<DP>::TILE bytes (33,280 for D <= 64,
// else 66,048).
int dl4j_flash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const float* mask, uint16_t* out,
                        float* lse, void* scratch, int BH, int H, int T, int D,
                        int causal, float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  return D <= 64 ? launch_fwd_bf16<64>(q, k, v, mask, out, lse, sc, BH, H, T,
                                       D, causal, scale, s)
                 : launch_fwd_bf16<128>(q, k, v, mask, out, lse, sc, BH, H, T,
                                        D, causal, scale, s);
}

int dl4j_flash_dq_bf16(const uint16_t* q, const uint16_t* k,
                       const uint16_t* v, const float* mask,
                       const uint16_t* dout, const float* lse,
                       const float* delta, uint16_t* dq, void* scratch,
                       int BH, int H, int T, int D, int causal, float scale,
                       void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  return D <= 64 ? launch_dq_bf16<64>(q, k, v, mask, dout, lse, delta, dq,
                                      sc, BH, H, T, D, causal, scale, s)
                 : launch_dq_bf16<128>(q, k, v, mask, dout, lse, delta, dq,
                                       sc, BH, H, T, D, causal, scale, s);
}

int dl4j_flash_dkv_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const float* mask,
                        const uint16_t* dout, const float* lse,
                        const float* delta, uint16_t* dk, uint16_t* dv,
                        void* scratch, int BH, int H, int T, int D, int causal,
                        float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  return D <= 64 ? launch_dkv_bf16<64>(q, k, v, mask, dout, lse, delta, dk,
                                       dv, sc, BH, H, T, D, causal, scale, s)
                 : launch_dkv_bf16<128>(q, k, v, mask, dout, lse, delta, dk,
                                        dv, sc, BH, H, T, D, causal, scale,
                                        s);
}

}  // extern "C"
