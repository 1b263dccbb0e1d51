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
// this design is far from both: RW stays in the 50 MB L2 from step to step,
// and on the H100 the step's time barely moves with N (PERF.md), so what
// bounds it is each block's serial chain of k-chunks (L2 load latency, then
// two barriers, with one block per SM), and in training the host's launch
// rate bounds it long before that.
//
// What the design does about it (right and simple first).  One thread owns
// one (row n, hidden unit j) pair and accumulates the four gate columns
// j, H+j, 2H+j, 3H+j of h[n,:] RW, so all the gate math of that pair is local
// and no block exchanges anything with another.  A block is 32 hidden units
// (threadIdx.x, a warp, neighbouring threads on neighbouring RW columns) by
// 8 rows (threadIdx.y).  It walks k in chunks of 32: it stages h[rows, k-chunk]
// and the four matching RW column slices (16 KB) in shared memory, then does
// f32 FMAs on the CUDA cores; inside a warp the h value is a broadcast and
// the RW reads are consecutive banks.  Ragged edges are masked on load and
// store: H = 200 is not a multiple of 32, and sampling runs N = 1 and N = 4.
// Tiling over k means no limit on H; the grid's y extent (N / 8 <= 65,535)
// is the only shape limit, checked by the Python predicate.  The TPU
// kernel's VMEM budget has no counterpart here.
//
// zx may be a row-strided view (a time step of a [N, T, 4H] tensor): ld_zx is
// its row stride in floats; everything else is contiguous.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBJ = 32;   // hidden units per block (threadIdx.x)
constexpr int kBN = 8;    // rows per block (threadIdx.y)
constexpr int kKC = 32;   // k-chunk of the recurrent product
constexpr int kThreads = kBJ * kBN;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_step_f32(const float* __restrict__ zx, int ld_zx,
              const float* __restrict__ h, const float* __restrict__ c,
              const float* __restrict__ rw, const float* __restrict__ p3,
              float* __restrict__ c_out, float* __restrict__ h_out,
              int N, int H) {
  __shared__ float h_s[kBN][kKC];
  __shared__ float rw_s[kKC][4][kBJ];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kBJ + tx;
  const int j0 = blockIdx.x * kBJ, n0 = blockIdx.y * kBN;
  const int j = j0 + tx, n = n0 + ty;
  const size_t G = 4 * static_cast<size_t>(H);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < H; k0 += kKC) {
    {  // h[n0 : n0+8, k0 : k0+32], one element per thread
      const int nn = t / kKC, kk = t % kKC;
      const int gn = n0 + nn, gk = k0 + kk;
      h_s[nn][kk] = (gn < N && gk < H)
                        ? h[static_cast<size_t>(gn) * H + gk] : 0.0f;
    }
    // RW[k0 : k0+32, g*H + j0 : g*H + j0+32] for the four gates
    for (int e = t; e < kKC * 4 * kBJ; e += kThreads) {
      const int kk = e / (4 * kBJ), r = e % (4 * kBJ);
      const int g = r / kBJ, jj = r % kBJ;
      const int gk = k0 + kk, gj = j0 + jj;
      rw_s[kk][g][jj] =
          (gk < H && gj < H)
              ? rw[static_cast<size_t>(gk) * G + static_cast<size_t>(g) * H + gj]
              : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float hv = h_s[ty][kk];
      acc[0] = fmaf(hv, rw_s[kk][0][tx], acc[0]);
      acc[1] = fmaf(hv, rw_s[kk][1][tx], acc[1]);
      acc[2] = fmaf(hv, rw_s[kk][2][tx], acc[2]);
      acc[3] = fmaf(hv, rw_s[kk][3][tx], acc[3]);
    }
    __syncthreads();
  }
  if (n >= N || j >= H) return;

  const float* __restrict__ z = zx + static_cast<size_t>(n) * ld_zx;
  const size_t o = static_cast<size_t>(n) * H + j;
  const float cv = c[o];
  const float ig = sigmoid(z[j] + acc[0] + cv * p3[j]);
  const float fg = sigmoid(z[H + j] + acc[1] + cv * p3[H + j]);
  const float gg = tanhf(z[3 * H + j] + acc[3]);
  const float cn = fg * cv + ig * gg;
  const float og = sigmoid(z[2 * H + j] + acc[2] + cn * p3[2 * H + j]);
  c_out[o] = cn;
  h_out[o] = og * tanhf(cn);
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
      (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + kBJ - 1) / kBJ, (N + kBN - 1) / kBN);
  lstm_step_f32<<<grid, dim3(kBJ, kBN), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      zx, ld_zx, h, c, rw, p3, c_out, h_out, N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
