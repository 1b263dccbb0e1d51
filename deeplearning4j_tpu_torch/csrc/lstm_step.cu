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
// The bf16 form, lstm_step_bf16, is the same plan on 2-byte inputs, as the
// TPU kernel runs under precision("bfloat16") (its body, :708-725): zx, h,
// c, RW and p3 are read as bf16 and upcast, the product is summed and the
// gates are computed in f32, h' comes from the unrounded c', and c' and h'
// are each rounded once to bf16 (to nearest, ties to even).  ld_zx counts
// 2-byte elements.  It moves half the f32 form's bytes (423,600 at the
// char-RNN's shape, 0.126 us of HBM time), and what bounds it is the same
// latency.

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

// The f32 form's plan on bf16 inputs (the header's last paragraph).
__global__ void __launch_bounds__(kThreads)
lstm_step_bf16(const uint16_t* __restrict__ zx, int ld_zx,
               const uint16_t* __restrict__ h, const uint16_t* __restrict__ c,
               const uint16_t* __restrict__ rw,
               const uint16_t* __restrict__ p3, uint16_t* __restrict__ c_out,
               uint16_t* __restrict__ h_out, int N, int H) {
  __shared__ float h_s[kWarps][kNB][kKC + 1];   // each warp's h chunk, f32
  __shared__ float part[kWarps][kCols][kNB];    // the warps' partial sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJB, n0 = blockIdx.y * kNB;
  const size_t G = 4 * static_cast<size_t>(H);

  const int oj = j0 + tid % kJB, on = n0 + tid / kJB;
  const bool owner = tid < kJB * kNB && oj < H && on < N;
  float zg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cv = 0.0f, pi = 0.0f, pf = 0.0f,
        po = 0.0f;
  if (owner) {
    const uint16_t* z = zx + static_cast<size_t>(on) * ld_zx;
#pragma unroll
    for (int g = 0; g < 4; ++g) zg[g] = bf16_bits_to_float(__ldg(z + g * H + oj));
    cv = bf16_bits_to_float(__ldg(c + static_cast<size_t>(on) * H + oj));
    pi = bf16_bits_to_float(__ldg(p3 + oj));
    pf = bf16_bits_to_float(__ldg(p3 + H + oj));
    po = bf16_bits_to_float(__ldg(p3 + 2 * H + oj));
  }

  const int col = lane % kCols, rg = lane / kCols;
  const int cg = col / kJB, cu = j0 + col % kJB;
  const bool col_ok = cu < H;
  const uint16_t* rw_col = rw + static_cast<size_t>(cg) * H + cu;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;

  const int range = (H + kWarps - 1) / kWarps;
  const int k_begin = warp * range, k_end = min(H, k_begin + range);
  for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
    const int kn = min(kKC, k_end - k0);
    float w[kKC];
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
      w[kk] = (kk < kn && col_ok)
                  ? bf16_bits_to_float(
                        __ldg(rw_col + static_cast<size_t>(k0 + kk) * G))
                  : 0.0f;
#pragma unroll 8
    for (int r = 0; r < kNB; ++r)
      h_s[warp][r][lane] =
          (lane < kn && n0 + r < N)
              ? bf16_bits_to_float(
                    __ldg(h + static_cast<size_t>(n0 + r) * H + k0 + lane))
              : 0.0f;
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(h_s[warp][rg + kGroups * i][kk], w[kk], acc[i]);
    __syncwarp();
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
  const dim3 grid((H + kJB - 1) / kJB, (N + kNB - 1) / kNB);
  lstm_step_bf16<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      zx, ld_zx, h, c, rw, p3, c_out, h_out, N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
