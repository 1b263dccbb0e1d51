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
// The forward is a CUDA-core design: its bound is 4.1 ms of f32 FMAs at 67
// TFLOP/s.  A block of 256 threads owns one 64-row tile of queries and walks
// the 64-row key tiles in a loop, which takes the place of the TPU kernel's
// sequential grid axis; with `causal` it skips the tiles past the diagonal.
// Every tile sits in shared memory row-major with a row stride of DPAD + 4
// floats, so a warp's float4 loads of 8 different rows land on 32 different
// banks.  Thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 score
// entries of rows ty + 16 i and columns tx + 16 j; the row statistics of the
// online softmax are reduced across the 16 threads of a row by warp
// shuffles; P V goes through a 64 x 64 tile in shared memory.  Blocks start
// with the last query tiles, which have the most key tiles to visit.
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

#include "hopper_tf32.cuh"

namespace {

constexpr int kB = 64;            // rows of a query or key tile (forward)
constexpr int kThreads = 256;     // 16 x 16 (forward)
constexpr int kLP = kB + 4;       // row stride of a [64, 64] tile of p
constexpr float kDeadLse = -1e30f;

template <int DPAD>
struct Plan {
  static constexpr int LD = DPAD + 4;      // row stride of a [64, DPAD] tile
  static constexpr int TILE = kB * LD;     // floats in one such tile
  static constexpr int DW = DPAD / 16;     // output columns per thread
};

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The max and the sum over the 16 threads that share a row (lanes that differ
// in their low 4 bits).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[64][LD] <- rows [r0, r0 + 64) of the row-major [T, D] matrix g; zeros past
// T and in the columns [D, DPAD).
template <int DPAD>
__device__ __forceinline__ void load_tile(float* __restrict__ s,
                                          const float* __restrict__ g, int r0,
                                          int T, int D) {
  constexpr int LD = Plan<DPAD>::LD, C4 = DPAD / 4;
  for (int e = threadIdx.x; e < kB * C4; e += kThreads) {
    const int r = e / C4, c = (e - r * C4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < T && c < D)
      x = __ldg(reinterpret_cast<const float4*>(
          g + static_cast<size_t>(r0 + r) * D + c));
    *reinterpret_cast<float4*>(s + r * LD + c) = x;
  }
}

// acc[i][j] += sum_d a[ty + 16 i][d] b[tx + 16 j][d], a and b [64][LD].
template <int DPAD>
__device__ __forceinline__ void dot_rows(const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx, float (&acc)[4][4]) {
  constexpr int LD = Plan<DPAD>::LD;
#pragma unroll 4
  for (int d = 0; d < DPAD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_c p[ty + 16 i][c] m[c][64 jj + 4 tx + e],
// p [64][kLP], m [64][LD].
template <int DPAD>
__device__ __forceinline__ void mul_tile(const float* __restrict__ p,
                                         const float* __restrict__ m, int ty,
                                         int tx,
                                         float (&acc)[4][Plan<DPAD>::DW]) {
  constexpr int LD = Plan<DPAD>::LD, NJ = DPAD / 64;
#pragma unroll 2
  for (int c = 0; c < kB; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kLP + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 mv = *reinterpret_cast<const float4*>(
            m + (c + e) * LD + 64 * jj + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = comp(pv[i], e);
          acc[i][4 * jj + 0] = fmaf(w, mv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(w, mv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(w, mv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(w, mv.w, acc[i][4 * jj + 3]);
        }
      }
  }
}

// row r of the row-major [T, D] matrix g <- mul * acc[i] for this thread's
// columns; r < T is the caller's check.
template <int DPAD>
__device__ __forceinline__ void store_row(float* __restrict__ g, int r, int D,
                                          int tx, const float* acc,
                                          float mul) {
#pragma unroll
  for (int jj = 0; jj < DPAD / 64; ++jj) {
    const int d = 64 * jj + 4 * tx;
    if (d < D)
      *reinterpret_cast<float4*>(g + static_cast<size_t>(r) * D + d) =
          make_float4(acc[4 * jj] * mul, acc[4 * jj + 1] * mul,
                      acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}

template <int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ mask,
          float* __restrict__ out, float* __restrict__ lse, int H, int T,
          int D, int causal, float scale) {
  constexpr int TILE = Plan<DPAD>::TILE, DW = Plan<DPAD>::DW;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + TILE;
  float* v_s = k_s + TILE;
  float* p_s = v_s + TILE;
  float* live_s = p_s + kB * kLP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kB;
  const size_t base = static_cast<size_t>(bh) * T * D;

  load_tile<DPAD>(q_s, q + base, q0, T, D);
  float m[4], l[4], acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[i][e] = 0.0f;
  }
  const int nk = (T + kB - 1) / kB;
  const int n_live = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                 // the last tile's readers are done
    load_tile<DPAD>(k_s, k + base, k0, T, D);
    load_tile<DPAD>(v_s, v + base, k0, T, D);
    if (tid < kB)
      live_s[tid] = (k0 + tid < T &&
                     mask[static_cast<size_t>(b) * T + k0 + tid] > 0.0f)
                        ? 1.0f : 0.0f;
    __syncthreads();
    float s[4][4] = {};
    dot_rows<DPAD>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool live = live_s[tx + 16 * j] > 0.0f && (!causal || c <= r);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float alpha = 1.0f, sum = 0.0f;
      if (m_new != -INFINITY) {      // a live key has been seen in this row
        alpha = expf(m[i] - m_new);  // 0 while m[i] is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);   // 0 for a dead entry
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DW; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    mul_tile<DPAD>(p_s, v_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
    const bool row_live = l[i] > 0.0f;
    store_row<DPAD>(out + base, r, D, tx, acc[i],
                    row_live ? 1.0f / l[i] : 0.0f);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * T + r] =
          row_live ? m[i] + logf(l[i]) : kDeadLse;
  }
}

// ---------------------------------------------------------------------------
// Backward: dq and dk/dv on the tensor cores (wgmma, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;   // two warpgroups; 16 x 16 in phase 1
constexpr int kS = 64;             // rows of a streamed tile
constexpr int kSmemMax = 232448;   // a block's dynamic shared memory

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

// Byte offset of element (row n, k) in a K-major tile of `rows` rows stored
// as [k / 32][rows][32 f32] atoms in the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw_off(int rows, int n, int k) {
  return (k >> 5) * (rows * 128) + n * 128 +
         ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// v = hi + lo with hi = v truncated to tf32 and lo = v - hi exact in f32
// (the tensor cores read lo's top 19 bits).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

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
               const float* mask, float* out, float* lse, int BH, int H,
               int T, int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (3 * Plan<DPAD>::TILE + kB * kLP + kB) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd<DPAD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_fwd<DPAD><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse,
                                                    H, T, D, causal, scale);
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

}  // namespace

extern "C" {

// out [BH, T, D] and lse [BH, T] from q, k, v [BH, T, D] and the key mask
// [BH / H, T]; all f32, contiguous, on the device.  Launches on `stream` and
// returns a CUDA error code (0 on success).
int dl4j_flash_fwd_f32(const float* q, const float* k, const float* v,
                       const float* mask, float* out, float* lse, int BH,
                       int H, int T, int D, int causal, float scale,
                       void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_fwd<64>(q, k, v, mask, out, lse, BH, H, T, D,
                                  causal, scale, s)
                 : launch_fwd<128>(q, k, v, mask, out, lse, BH, H, T, D,
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

}  // extern "C"
