// Flash attention, forward and both backward kernels, f32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// deeplearning4j_tpu/ops/pallas_kernels.py:
//   flash_fwd  <- `_flash_fwd_kernel` :128 (launched by `_flash_fwd` :196)
//   flash_dq   <- `_flash_dq_kernel`  :238 (launched by `_flash_bwd` :341)
//   flash_dkv  <- `_flash_dkv_kernel` :274 (launched by `_flash_bwd` :357)
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
// deterministic.  The [T, T] score matrix never reaches device memory: each
// block holds one 64 x 64 tile of it in shared memory at a time.
//
// What bounds it on this card.  At the long-context model's shape (B = 4,
// H = 8, T = 8192, D = 64, causal) the forward does 275 GFLOP and reads 268
// MB: 4.1 ms on the CUDA cores' 67 TFLOP/s against 0.08 ms of HBM time, so
// operations bound all three kernels.  The TPU kernels hold a whole [T, D] K
// and V in VMEM and feed the MXU; here a block has 227 KB of shared memory
// and f32 has no tensor-core path in this design, so the work is CUDA-core
// FMAs fed from shared memory.
//
// What the design does about it (right and simple first; wgmma, TMA and bf16
// are later work).  A block of 256 threads owns one 64-row tile of queries
// (forward, dq) or keys (dk/dv) and walks the other side's 64-row tiles in a
// loop, which takes the place of the TPU kernels' sequential grid axis; with
// `causal` it skips the tiles past the diagonal.  Every tile sits in shared
// memory row-major with a row stride of DPAD + 4 floats (DPAD = 64 or 128, the
// head dim rounded up, padded columns zero), so a warp's float4 loads of 8
// different rows land on 32 different banks.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns the 4 x 4 score entries of rows ty + 16 i and columns
// tx + 16 j; each step of 4 along d loads 8 float4 and does 64 FMAs.  The
// row statistics of the online softmax are reduced across the 16 threads of
// a row by warp shuffles.  The second product of each kernel (P V, dS K,
// P^T dO, dS^T Q) goes through a 64 x 64 tile in shared memory and gives each
// thread 4 rows by DPAD / 16 output columns, accumulated in registers.
// Forward and dq blocks start with the last query tiles, which have the most
// key tiles to visit under `causal`; dk/dv blocks start with the first key
// tiles for the same reason.  Any T works (the last tile is masked); any head
// dim D with D % 4 == 0 and D <= 128 works.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kB = 64;            // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kLP = kB + 4;       // row stride of a [64, 64] tile of p or ds
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

template <int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ mask,
         const float* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dq, int H,
         int T, int D, int causal, float scale) {
  constexpr int TILE = Plan<DPAD>::TILE, DW = Plan<DPAD>::DW;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + TILE;
  float* k_s = do_s + TILE;
  float* v_s = k_s + TILE;
  float* ds_s = v_s + TILE;
  float* live_s = ds_s + kB * kLP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kB;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;

  load_tile<DPAD>(q_s, q + base, q0, T, D);
  load_tile<DPAD>(do_s, dout + base, q0, T, D);
  float lse_r[4], delta_r[4], acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < T ? lse[row_base + r] : kDeadLse;
    delta_r[i] = r < T ? delta[row_base + r] : 0.0f;
#pragma unroll
    for (int e = 0; e < DW; ++e) acc[i][e] = 0.0f;
  }
  const int nk = (T + kB - 1) / kB;
  const int n_live = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<DPAD>(k_s, k + base, k0, T, D);
    load_tile<DPAD>(v_s, v + base, k0, T, D);
    if (tid < kB)
      live_s[tid] = (k0 + tid < T &&
                     mask[static_cast<size_t>(b) * T + k0 + tid] > 0.0f)
                        ? 1.0f : 0.0f;
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_rows<DPAD>(q_s, k_s, ty, tx, s);
    dot_rows<DPAD>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const bool row_live = lse_r[i] > 0.5f * kDeadLse;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool live = row_live && live_s[tx + 16 * j] > 0.0f &&
                          (!causal || c <= r);
        const float p = expf(live ? s[i][j] * scale - lse_r[i] : -INFINITY);
        ds_s[(ty + 16 * i) * kLP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    mul_tile<DPAD>(ds_s, k_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < T) store_row<DPAD>(dq + base, r, D, tx, acc[i], scale);
  }
}

template <int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ mask,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dk,
          float* __restrict__ dv, int H, int T, int D, int causal,
          float scale) {
  constexpr int TILE = Plan<DPAD>::TILE, DW = Plan<DPAD>::DW;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + TILE;
  float* q_s = v_s + TILE;
  float* do_s = q_s + TILE;
  float* pt_s = do_s + TILE;
  float* dst_s = pt_s + kB * kLP;
  float* lse_s = dst_s + kB * kLP;
  float* delta_s = lse_s + kB;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H;
  const int kt = blockIdx.x;
  const int k0 = kt * kB;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;

  load_tile<DPAD>(k_s, k + base, k0, T, D);
  load_tile<DPAD>(v_s, v + base, k0, T, D);
  bool key_live[4];
  float dk_acc[4][DW], dv_acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    key_live[i] = c < T && mask[static_cast<size_t>(b) * T + c] > 0.0f;
#pragma unroll
    for (int e = 0; e < DW; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;
  }
  const int nq = (T + kB - 1) / kB;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();
    load_tile<DPAD>(q_s, q + base, q0, T, D);
    load_tile<DPAD>(do_s, dout + base, q0, T, D);
    if (tid < kB) {
      const int r = q0 + tid;
      lse_s[tid] = r < T ? lse[row_base + r] : kDeadLse;
      delta_s[tid] = r < T ? delta[row_base + r] : 0.0f;
    }
    __syncthreads();
    // transposed tiles: rows are this block's keys, columns the queries
    float st[4][4] = {}, dpt[4][4] = {};
    dot_rows<DPAD>(k_s, q_s, ty, tx, st);
    dot_rows<DPAD>(v_s, do_s, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + tx + 16 * j;
        const float lr = lse_s[tx + 16 * j];
        const bool live = key_live[i] && lr > 0.5f * kDeadLse &&
                          (!causal || c <= r);
        const float p = expf(live ? st[i][j] * scale - lr : -INFINITY);
        pt_s[(ty + 16 * i) * kLP + tx + 16 * j] = p;
        dst_s[(ty + 16 * i) * kLP + tx + 16 * j] =
            p * (dpt[i][j] - delta_s[tx + 16 * j]);
      }
    }
    __syncthreads();
    mul_tile<DPAD>(pt_s, do_s, ty, tx, dv_acc);
    mul_tile<DPAD>(dst_s, q_s, ty, tx, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= T) continue;
    store_row<DPAD>(dk + base, c, D, tx, dk_acc[i], scale);
    store_row<DPAD>(dv + base, c, D, tx, dv_acc[i], 1.0f);
  }
}

bool bad_shape(int BH, int H, int T, int D) {
  return BH < 1 || H < 1 || BH % H != 0 || BH > 65535 || T < 1 || D < 4 ||
         D > 128 || D % 4 != 0;
}

// Dynamic shared memory of each kernel, in bytes.
template <int DPAD> constexpr size_t fwd_smem() {
  return (3 * Plan<DPAD>::TILE + kB * kLP + kB) * sizeof(float);
}
template <int DPAD> constexpr size_t dq_smem() {
  return (4 * Plan<DPAD>::TILE + kB * kLP + kB) * sizeof(float);
}
template <int DPAD> constexpr size_t dkv_smem() {
  return (4 * Plan<DPAD>::TILE + 2 * kB * kLP + 2 * kB) * sizeof(float);
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
  const size_t smem = fwd_smem<DPAD>();
  cudaError_t err = allow_smem(flash_fwd<DPAD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_fwd<DPAD><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, lse,
                                                    H, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_dq(const float* q, const float* k, const float* v,
              const float* mask, const float* dout, const float* lse,
              const float* delta, float* dq, int BH, int H, int T, int D,
              int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<DPAD>();
  cudaError_t err = allow_smem(flash_dq<DPAD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_dq<DPAD><<<grid, kThreads, smem, stream>>>(
      q, k, v, mask, dout, lse, delta, dq, H, T, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* mask, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, int BH, int H, int T,
               int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<DPAD>();
  cudaError_t err = allow_smem(flash_dkv<DPAD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kB - 1) / kB, BH);
  flash_dkv<DPAD><<<grid, kThreads, smem, stream>>>(
      q, k, v, mask, dout, lse, delta, dk, dv, H, T, D, causal, scale);
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
  return D <= 64 ? launch_dq<64>(q, k, v, mask, dout, lse, delta, dq, BH, H,
                                 T, D, causal, scale, s)
                 : launch_dq<128>(q, k, v, mask, dout, lse, delta, dq, BH, H,
                                  T, D, causal, scale, s);
}

// dk, dv [BH, T, D] from the same inputs as dl4j_flash_dq_f32.
int dl4j_flash_dkv_f32(const float* q, const float* k, const float* v,
                       const float* mask, const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int BH, int H,
                       int T, int D, int causal, float scale, void* stream) {
  if (bad_shape(BH, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dkv<64>(q, k, v, mask, dout, lse, delta, dk, dv, BH,
                                  H, T, D, causal, scale, s)
                 : launch_dkv<128>(q, k, v, mask, dout, lse, delta, dk, dv,
                                   BH, H, T, D, causal, scale, s);
}

}  // extern "C"
