// Fused softmax cross-entropy, loss and gradient, f32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_softmax_xent_kernel`
// (deeplearning4j_tpu/ops/pallas_kernels.py:466, launched by
// `fused_softmax_xent` :500).  For each row of logits x [N, V] and labels
// y [N, V]:
//   m = max x,  z = sum exp(x - m),
//   loss = -sum y * ((x - m) - log z),
//   grad = softmax(x) * sum y - y,
// which is the exact gradient of the loss for soft (unnormalised) label rows
// too.  The [N, V] probabilities never reach device memory: x is read, grad
// and one loss per row are written.
//
// What bounds it on this card: bytes.  Per element it reads 8 bytes (x, y),
// writes 4 (grad) and does one exp and a few FLOPs, far below the card's
// balance point, so the limit is HBM bandwidth (3.35 TB/s).
//
// What the design does about it.  The TPU kernel takes blocks of rows sized
// to its 10 MB VMEM budget and pads N to the block height; both are TPU
// artifacts.  Here one thread block owns one row and needs no padding: pass 1
// reduces max x and sum y over the row, pass 2 sum exp(x - m) and
// sum y * (x - m), each with warp shuffles and one shared-memory exchange
// between warps, and pass 3 writes the gradient once.  Passes 2 and 3 read
// the row again; at the slice's shapes (a row of 1,000 to 50,257 floats) it
// is still in L1/L2, so device memory sees about one read of x and y.  The
// block has 128 to 1024 threads by V (the wrapper chooses), so a thread walks
// a handful of elements per pass with neighbouring threads on neighbouring
// addresses.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;

// Sum or max of v over the block; every thread gets the result.  `smem`
// holds one float per warp and is free again when the function returns.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* smem) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < n_warps ? smem[lane] : (kMax ? -INFINITY : 0.0f);
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();   // smem may be reused by the next reduction
  return v;
}

__global__ void __launch_bounds__(1024)
softmax_xent_f32(const float* __restrict__ logits,
                 const float* __restrict__ labels, float* __restrict__ loss,
                 float* __restrict__ grad, int V) {
  __shared__ float smem[kWarp];
  const size_t off = static_cast<size_t>(blockIdx.x) * V;
  const float* __restrict__ x = logits + off;
  const float* __restrict__ y = labels + off;
  float* __restrict__ g = grad + off;

  float m = -INFINITY, sy = 0.0f;
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    m = fmaxf(m, x[j]);
    sy += y[j];
  }
  m = block_reduce<true>(m, smem);
  sy = block_reduce<false>(sy, smem);

  float z = 0.0f, syd = 0.0f;
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    const float d = x[j] - m;
    z += expf(d);
    syd += y[j] * d;
  }
  z = block_reduce<false>(z, smem);
  syd = block_reduce<false>(syd, smem);

  if (threadIdx.x == 0) loss[blockIdx.x] = -(syd - sy * logf(z));
  for (int j = threadIdx.x; j < V; j += blockDim.x)
    g[j] = expf(x[j] - m) / z * sy - y[j];
}

}  // namespace

extern "C" {

// loss[N] and grad[N, V] from logits[N, V] and labels[N, V], all contiguous
// f32 on the device; `threads` is a multiple of 32 in [32, 1024].  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int dl4j_softmax_xent_f32(const float* logits, const float* labels,
                          float* loss, float* grad, int n_rows, int V,
                          int threads, void* stream) {
  if (n_rows < 1 || V < 1 || threads < kWarp || threads > 1024 ||
      threads % kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  softmax_xent_f32<<<n_rows, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      logits, labels, loss, grad, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
