// One peephole-LSTM step (Graves LSTM), f32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lstm_step_kernel`
// (deeplearning4j_tpu/ops/pallas_kernels.py:703, launched by `_lstm_forward`
// :730 through `fused_lstm_step` :754).  Inputs: the pre-projected input
// zx [N, 4H] (x_t W + b, bias included), the carried h, c [N, H], the
// recurrent weights RW [H, 4H] and the peepholes p3 [3, H] (rows pI, pF, pO).
// Gate layout [i, f, o, c] in blocks of H:
//   z  = zx + h RW
//   i  = sigmoid(z_i + c pI),  f = sigmoid(z_f + c pF),  g = tanh(z_c)
//   c' = f c + i g
//   o  = sigmoid(z_o + c' pO),  h' = o tanh(c')
// The [N, 4H] pre-activation z never reaches device memory: the recurrent
// product is computed here, in the kernel's own body, and consumed by the
// gate math in registers.
//
// What bounds it on this card.  At the char-RNN's shape (N = 32, H = 200) one
// step moves 847,200 bytes (RW alone is 640 KB) and does 10.2 MFLOP: 0.25 us
// of HBM time against 0.15 us of f32 FMA time, so bytes on paper.  In fact
// RW stays in the 50 MB L2 from step to step, and what bounds one step is
// latency: the launch, and the L2 round trips that lie in series on the way
// from the inputs to h'.  (The first design walked k in seven dependent
// chunks per block on 28 blocks and took 22 us whatever N was.)
//
// What the design does about it.  A block owns kJB = 2 hidden units (all
// four gates: 8 RW columns) for kNB = 16 rows, so H = 200 gives 100 blocks
// per 16 rows, 200 at the char-RNN's N = 32 (there, on an H100, blocks of
// 32 rows took 8.4 us, of 16 5.4 us, of 8 7.3 us).  Its 8 warps split k:
// warp w sums k in its own range of ceil(H / 8) rows, in chunks of kKC =
// 32.  For a chunk, each lane first
// issues every load it needs at once -- the 32 RW values of its column and
// its share of h[rows, chunk], which the warp stages in its own slice of
// shared memory -- so a chunk costs one L2 round trip, and H = 200 is one
// chunk per warp; no block barrier lies inside the loop.  Lane = column c
// (0..7) + 8 x row group (0..3), 4 rows a lane.  The warps' partial sums
// meet once in shared memory; after one barrier, thread (unit, row) adds
// them and does the gate math with zx, c and the peepholes, which it loaded
// before the product.  The sum over k is taken in another order than the
// plain version's (within LSTM_TOL).  Ragged edges are masked: N not a
// multiple of 16, a k range not a multiple of the chunk.  H is otherwise
// unbounded (nothing of RW is staged); the grid's y extent (N / 16 <=
// 65,535) is the only shape limit, checked by the Python predicate.
//
// zx may be a row-strided view (a time step of a [N, T, 4H] tensor): ld_zx is
// its row stride in floats; everything else is contiguous.
//
// The bf16 form, lstm_step_bf16, computes the step as the TPU kernel runs
// it under precision("bfloat16") (its body, :708-725): zx, h, c, RW and p3
// are read as bf16 and upcast, the product is summed and the gates are
// computed in f32, h' comes from the unrounded c', and c' and h' are each
// rounded once to bf16 (to nearest, ties to even).  ld_zx counts 2-byte
// elements.  It moves half the f32 form's bytes (423,600 at the char-RNN's
// shape, 0.126 us of HBM time), and what bounds it is the same latency.
// Run on the f32 form's plan with 2-byte loads it took 7.35 us at (32, 200)
// on an H100, against the f32 form's 5.35: each lane issued 32 scattered
// 2-byte loads down an RW column and 16 more of h.  Its own plan: a
// block owns kJB16 = 8 units, so that a gate's slice of an RW row is 16
// contiguous bytes, by NB rows (8; 4 where N <= 8, which doubles the
// blocks of a few streams); the block stages RW's 32 columns and h's rows,
// upcast to f32, in shared memory by 16-byte loads that are all issued
// before any is stored (one round trip for H up to 224; 2-byte loads where
// h or RW is not 16-byte aligned, or H not a multiple of 8, which the
// wrapper's gate refuses), then each warp sums its k range from shared
// memory, lane = column, all NB rows at once.  The sum over k is the f32
// form's, term for term: each warp's range of ceil(H / 8) k in order, the
// warps' partials added to zx in warp order, so c' and h' are bit for bit
// those of the f32 form's plan run on the same bf16 inputs with 2-byte
// loads (checked on an H100).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"

namespace {

constexpr int kJB = 2;               // hidden units per block
constexpr int kCols = 4 * kJB;       // RW columns per block (4 gates)
constexpr int kNB = 16;              // rows per block
constexpr int kWarps = 8;            // the k split
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 32;              // k-chunk of one warp
constexpr int kGroups = 32 / kCols;  // row groups of a warp
constexpr int kRows = kNB / kGroups; // rows of one lane
static_assert(kJB * kNB <= kThreads, "one thread per (unit, row) output");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_step_f32(const float* __restrict__ zx, int ld_zx,
              const float* __restrict__ h, const float* __restrict__ c,
              const float* __restrict__ rw, const float* __restrict__ p3,
              float* __restrict__ c_out, float* __restrict__ h_out,
              int N, int H) {
  __shared__ float h_s[kWarps][kNB][kKC + 1];   // each warp's h chunk
  __shared__ float part[kWarps][kCols][kNB];    // the warps' partial sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJB, n0 = blockIdx.y * kNB;
  const size_t G = 4 * static_cast<size_t>(H);

  // the gate-math thread's inputs, loaded before the product
  const int oj = j0 + tid % kJB, on = n0 + tid / kJB;
  const bool owner = tid < kJB * kNB && oj < H && on < N;
  float zg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cv = 0.0f, pi = 0.0f, pf = 0.0f,
        po = 0.0f;
  if (owner) {
    const float* z = zx + static_cast<size_t>(on) * ld_zx;
#pragma unroll
    for (int g = 0; g < 4; ++g) zg[g] = __ldg(z + g * H + oj);
    cv = __ldg(c + static_cast<size_t>(on) * H + oj);
    pi = __ldg(p3 + oj);
    pf = __ldg(p3 + H + oj);
    po = __ldg(p3 + 2 * H + oj);
  }

  // lane's column (gate g, unit j0 + u) and rows n0 + rg + kGroups * i
  const int col = lane % kCols, rg = lane / kCols;
  const int cg = col / kJB, cu = j0 + col % kJB;
  const bool col_ok = cu < H;
  const float* rw_col = rw + static_cast<size_t>(cg) * H + cu;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;

  const int range = (H + kWarps - 1) / kWarps;
  const int k_begin = warp * range, k_end = min(H, k_begin + range);
  for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
    const int kn = min(kKC, k_end - k0);
    // every load of the chunk at once: this lane's RW column ...
    float w[kKC];
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
      w[kk] = (kk < kn && col_ok)
                  ? __ldg(rw_col + static_cast<size_t>(k0 + kk) * G) : 0.0f;
    // ... and h[n0 + r, k0 + lane] for the warp's slice
#pragma unroll 8
    for (int r = 0; r < kNB; ++r)
      h_s[warp][r][lane] = (lane < kn && n0 + r < N)
          ? __ldg(h + static_cast<size_t>(n0 + r) * H + k0 + lane) : 0.0f;
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(h_s[warp][rg + kGroups * i][kk], w[kk], acc[i]);
    __syncwarp();                  // the slice is free for the next chunk
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) part[warp][col][rg + kGroups * i] = acc[i];
  __syncthreads();
  if (!owner) return;

  const int u = tid % kJB, r = tid / kJB;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = zg[g];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][g * kJB + u][r];
    z[g] = s;
  }
  const float ig = sigmoid(z[0] + cv * pi);
  const float fg = sigmoid(z[1] + cv * pf);
  const float gg = tanhf(z[3]);
  const float cn = fg * cv + ig * gg;
  const float og = sigmoid(z[2] + cn * po);
  const size_t o = static_cast<size_t>(on) * H + oj;
  c_out[o] = cn;
  h_out[o] = og * tanhf(cn);
}

// The bf16 form (the header's last paragraph): a block of kJB16 = 8 units
// (32 RW columns) by NB rows (8, or 4 where N <= kSmallN); the block
// stages RW's columns and h's rows, upcast to f32, in one round trip, then
// each warp sums its k range.
constexpr int kJB16 = 8;                // hidden units per block
constexpr int kCols16 = 4 * kJB16;      // RW columns per block: a warp's lanes
constexpr int kSmallN = 8;              // rows up to which blocks take 4
constexpr int kKCH = 224;               // k rows staged at once
constexpr int kRwVec = kKCH * 4 / kThreads + 1;   // 16-byte RW loads a thread
static_assert(kKCH % 8 == 0, "a staged chunk is whole 16-byte h vectors");

template <int NB>
__global__ void __launch_bounds__(kThreads)
lstm_step_bf16(const uint16_t* __restrict__ zx, int ld_zx,
               const uint16_t* __restrict__ h, const uint16_t* __restrict__ c,
               const uint16_t* __restrict__ rw,
               const uint16_t* __restrict__ p3, uint16_t* __restrict__ c_out,
               uint16_t* __restrict__ h_out, int N, int H, int ubx, int vec) {
  static_assert(kJB16 * NB <= kThreads, "one thread per (unit, row)");
  static_assert(NB * kKCH / 8 <= kThreads, "one h vector a thread");
  static_assert(NB % 4 == 0, "rows are read four at a time");
  __shared__ __align__(16) float rw_s[kKCH][kCols16];  // RW[k][gate, unit]
  __shared__ __align__(16) float h_s[kKCH][NB];     // h[row][k], as [k][row]
  __shared__ float part[kWarps][kCols16][NB];       // the warps' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = (blockIdx.x % ubx) * kJB16, n0 = (blockIdx.x / ubx) * NB;
  const size_t G = 4 * static_cast<size_t>(H);

  // the gate-math thread's inputs, loaded before the product
  const int oj = j0 + tid % kJB16, on = n0 + tid / kJB16;
  // (every thread loads, at a clamped index, so that no load sits under a
  // condition; only the owners' values are used)
  const bool owner = tid < kJB16 * NB && oj < H && on < N;
  const int lj = min(oj, H - 1);
  const size_t ln = static_cast<size_t>(min(on, N - 1));
  const uint16_t* zrow = zx + ln * ld_zx;
  float zg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    zg[g] = bf16_bits_to_float(__ldg(zrow + g * H + lj));
  const float cv = bf16_bits_to_float(__ldg(c + ln * H + lj));
  const float pi = bf16_bits_to_float(__ldg(p3 + lj));
  const float pf = bf16_bits_to_float(__ldg(p3 + H + lj));
  const float po = bf16_bits_to_float(__ldg(p3 + 2 * H + lj));

  // warp w sums k in [k_begin, k_end), the f32 form's ranges, in order
  const int range = (H + kWarps - 1) / kWarps;
  const int k_begin = warp * range, k_end = min(H, k_begin + range);
  float acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < H; c0 += kKCH) {
    const int kn = min(kKCH, H - c0);
    if (c0 > 0) __syncthreads();        // the last chunk is consumed
    if (vec) {
      // 16-byte loads, all issued before any is stored: RW row k's eight
      // units of gate g, and eight k of one h row.  Each load is
      // unconditional, from a row clamped into range: a load under a
      // condition is merged with its other value after it returns, and
      // that merge would wait for each load in turn.
      uint4 rv[kRwVec];
#pragma unroll
      for (int m = 0; m < kRwVec; ++m) {
        const int it = tid + m * kThreads, k = min(it >> 2, kn - 1);
        rv[m] = __ldg(reinterpret_cast<const uint4*>(
            rw + static_cast<size_t>(c0 + k) * G +
            static_cast<size_t>(it & 3) * H + j0));
      }
      const int hn = tid / (kKCH / 8), hk = 8 * (tid % (kKCH / 8));
      const bool h_ok = hn < NB && n0 + hn < N && hk < kn;
      const uint4 hv = __ldg(reinterpret_cast<const uint4*>(
          h + static_cast<size_t>(min(n0 + hn, N - 1)) * H + c0 +
          min(hk, kn - 8)));
#pragma unroll
      for (int m = 0; m < kRwVec; ++m) {
        const int it = tid + m * kThreads, k = it >> 2, g = it & 3;
        if (k < kn) {
          const uint32_t w4[4] = {rv[m].x, rv[m].y, rv[m].z, rv[m].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            rw_s[k][g * kJB16 + 2 * q] = __uint_as_float(w4[q] << 16);
            rw_s[k][g * kJB16 + 2 * q + 1] =
                __uint_as_float(w4[q] & 0xFFFF0000u);
          }
        }
      }
      if (hn < NB && hk < kn) {
        const uint32_t h4[4] = {h_ok ? hv.x : 0u, h_ok ? hv.y : 0u,
                                h_ok ? hv.z : 0u, h_ok ? hv.w : 0u};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h_s[hk + 2 * q][hn] = __uint_as_float(h4[q] << 16);
          h_s[hk + 2 * q + 1][hn] = __uint_as_float(h4[q] & 0xFFFF0000u);
        }
      }
    } else {
      // 2-byte loads where a tensor is not 16-byte aligned (or H is not a
      // multiple of 8)
      for (int it = tid; it < kn * kCols16; it += kThreads) {
        const int k = it / kCols16, col = it % kCols16;
        const int u = j0 + col % kJB16;
        rw_s[k][col] = u < H ? bf16_bits_to_float(__ldg(
                                   rw + static_cast<size_t>(c0 + k) * G +
                                   static_cast<size_t>(col / kJB16) * H + u))
                             : 0.0f;
      }
      for (int it = tid; it < kn * NB; it += kThreads) {
        const int k = it / NB, r = it % NB;
        h_s[k][r] = n0 + r < N ? bf16_bits_to_float(__ldg(
                                     h + static_cast<size_t>(n0 + r) * H +
                                     c0 + k))
                               : 0.0f;
      }
    }
    __syncthreads();
    // lane = column (gate lane / 8, unit lane % 8), all NB rows
    const int ka = max(k_begin, c0), kb = min(k_end, c0 + kn);
    for (int k = ka; k < kb; ++k) {
      const float w = rw_s[k - c0][lane];
#pragma unroll
      for (int i = 0; i < NB; i += 4) {
        const float4 hq = *reinterpret_cast<const float4*>(&h_s[k - c0][i]);
        acc[i] = fmaf(hq.x, w, acc[i]);
        acc[i + 1] = fmaf(hq.y, w, acc[i + 1]);
        acc[i + 2] = fmaf(hq.z, w, acc[i + 2]);
        acc[i + 3] = fmaf(hq.w, w, acc[i + 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) part[warp][lane][i] = acc[i];
  __syncthreads();
  if (!owner) return;

  const int u = tid % kJB16, r = tid / kJB16;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = zg[g];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][g * kJB16 + u][r];
    z[g] = s;
  }
  const float ig = sigmoid(z[0] + cv * pi);
  const float fg = sigmoid(z[1] + cv * pf);
  const float gg = tanhf(z[3]);
  const float cn = fg * cv + ig * gg;
  const float og = sigmoid(z[2] + cn * po);
  const size_t o = static_cast<size_t>(on) * H + oj;
  c_out[o] = float_to_bf16_bits(cn);
  h_out[o] = float_to_bf16_bits(og * tanhf(cn));
}

}  // namespace

extern "C" {

// c_out, h_out [N, H] from zx [N, 4H] (row stride ld_zx >= 4H floats),
// h, c [N, H], rw [H, 4H], p3 [3, H]; all f32 on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int dl4j_lstm_step_f32(const float* zx, int ld_zx, const float* h,
                       const float* c, const float* rw, const float* p3,
                       float* c_out, float* h_out, int N, int H,
                       void* stream) {
  if (N < 1 || H < 1 || ld_zx < 4 * H ||
      (N + kNB - 1) / kNB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + kJB - 1) / kJB, (N + kNB - 1) / kNB);
  lstm_step_f32<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      zx, ld_zx, h, c, rw, p3, c_out, h_out, N, H);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: every tensor bf16, ld_zx >= 4H in 2-byte elements.
int dl4j_lstm_step_bf16(const uint16_t* zx, int ld_zx, const uint16_t* h,
                        const uint16_t* c, const uint16_t* rw,
                        const uint16_t* p3, uint16_t* c_out, uint16_t* h_out,
                        int N, int H, void* stream) {
  if (N < 1 || H < 1 || ld_zx < 4 * H ||
      (N + kNB - 1) / kNB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows a block: 4 for a few streams (more blocks, half the FMAs a lane
  // of the longest warp), else 8 (RW's columns read by half as many
  // blocks); the sum's order is the same
  const int nb = N <= kSmallN ? 4 : 8;
  const int ubx = (H + kJB16 - 1) / kJB16;
  const long long blocks = static_cast<long long>(ubx) * ((N + nb - 1) / nb);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = H % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(rw) |
                   reinterpret_cast<uintptr_t>(h)) % 16 == 0;
  auto kernel = nb == 4 ? lstm_step_bf16<4> : lstm_step_bf16<8>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(zx, ld_zx, h, c, rw, p3, c_out,
                                                h_out, N, H, ubx, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
