// Counter-hash threshold dropout, f32 and bf16, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dropout_kernel`
// (deeplearning4j_tpu/ops/pallas_kernels.py:827, launched by
// `_dropout_forward` :841) with the same math as `_mix32` and
// `_threshold_dropout_math` (:797-824): element e of the C-order flattened x
// gets the hash h = mix32(e, s0, s1), an xxhash-style avalanche over uint32;
// it is kept iff (h >> 8) < thresh, with thresh = round(rate * 2^24) and rate
// the RETAIN probability, and a kept element becomes x * inv, where inv is
// float32(1 / rate) computed on the host.  A dropped element becomes 0.  The
// output is bit-identical to the plain version and to the JAX reference
// `threshold_dropout_reference` (:907) for the same two seed words.  The
// backward pass is this same kernel applied to the incoming gradient with
// the same seed: no mask tensor is ever written.
//
// What bounds it on this card: bytes.  Per element it reads 4 bytes, writes
// 4 and does ~12 integer operations, far below the card's balance point, so
// the limit is HBM bandwidth (3.35 TB/s).
//
// What the design does about it.  The TPU kernel views x as [rows, 128]
// lanes in blocks of 1024 rows; here the hash is computed from the flat
// element id directly, so x needs no padding or reshaping.  Each thread of a
// grid-stride loop moves 16 bytes per load and per store (float4), which
// keeps enough bytes in flight to stream at full bandwidth, and the grid is
// capped at a few waves of blocks per SM.  The n % 4 tail elements are done
// one by one by the first threads of block 0.  The wrapper passes 16-byte
// aligned pointers.
//
// The bf16 form (`threshold_dropout_bf16`) applies the same hash of the same
// global element id and the same 24-bit threshold, so its masks are bit for
// bit the f32 form's at the same seed words; a kept element is upcast to f32,
// multiplied there by the same f32 `inv` and rounded once to the nearest
// bf16, ties to even, as the TPU kernel does (x.astype(f32) * inv, cast
// back, :811-824).  It moves 2 + 2 bytes an element, 16 bytes (eight
// elements) per load and per store; the n % 8 tail goes one by one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of an H100 SXM

__device__ __forceinline__ uint32_t mix32(uint32_t idx, uint32_t s0,
                                          uint32_t s1) {
  uint32_t h = idx * 2654435761u;
  h ^= s0;
  h *= 2246822519u;
  h ^= h >> 13;
  h ^= s1;
  h *= 3266489917u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float drop(float v, uint32_t idx, uint32_t s0,
                                      uint32_t s1, uint32_t thresh,
                                      float inv) {
  return (mix32(idx, s0, s1) >> 8) < thresh ? __fmul_rn(v, inv) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
threshold_dropout_f32(const float* __restrict__ x, float* __restrict__ y,
                      uint32_t n, uint32_t s0, uint32_t s1, uint32_t thresh,
                      float inv) {
  const uint32_t n4 = n >> 2;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 v = x4[i];
    const uint32_t e = i << 2;
    v.x = drop(v.x, e, s0, s1, thresh, inv);
    v.y = drop(v.y, e + 1u, s0, s1, thresh, inv);
    v.z = drop(v.z, e + 2u, s0, s1, thresh, inv);
    v.w = drop(v.w, e + 3u, s0, s1, thresh, inv);
    y4[i] = v;
  }
  const uint32_t e = (n4 << 2) + threadIdx.x;
  if (blockIdx.x == 0 && e < n) y[e] = drop(x[e], e, s0, s1, thresh, inv);
}

// One bf16 element (as its bits): kept, x * inv in f32 rounded to the
// nearest bf16; dropped, +0.
__device__ __forceinline__ uint16_t drop_bf16(uint16_t v, uint32_t idx,
                                              uint32_t s0, uint32_t s1,
                                              uint32_t thresh, float inv) {
  if ((mix32(idx, s0, s1) >> 8) >= thresh) return 0;
  const float f = __uint_as_float(static_cast<uint32_t>(v) << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(f, inv)));
}

// Two bf16 of one 32-bit word, the lower element id in the low half.
__device__ __forceinline__ uint32_t drop_pair(uint32_t w, uint32_t idx,
                                              uint32_t s0, uint32_t s1,
                                              uint32_t thresh, float inv) {
  const uint32_t lo = drop_bf16(static_cast<uint16_t>(w & 0xFFFFu), idx, s0,
                                s1, thresh, inv);
  const uint32_t hi = drop_bf16(static_cast<uint16_t>(w >> 16), idx + 1u, s0,
                                s1, thresh, inv);
  return lo | (hi << 16);
}

__global__ void __launch_bounds__(kThreads)
threshold_dropout_bf16(const uint16_t* __restrict__ x,
                       uint16_t* __restrict__ y, uint32_t n, uint32_t s0,
                       uint32_t s1, uint32_t thresh, float inv) {
  const uint32_t n8 = n >> 3;
  const uint4* __restrict__ x8 = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ y8 = reinterpret_cast<uint4*>(y);
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    uint4 v = x8[i];
    const uint32_t e = i << 3;
    v.x = drop_pair(v.x, e, s0, s1, thresh, inv);
    v.y = drop_pair(v.y, e + 2u, s0, s1, thresh, inv);
    v.z = drop_pair(v.z, e + 4u, s0, s1, thresh, inv);
    v.w = drop_pair(v.w, e + 6u, s0, s1, thresh, inv);
    y8[i] = v;
  }
  const uint32_t e = (n8 << 3) + threadIdx.x;
  if (blockIdx.x == 0 && e < n) y[e] = drop_bf16(x[e], e, s0, s1, thresh, inv);
}

}  // namespace

extern "C" {

// y[i] = keep(i) ? x[i] * inv : 0 for the n contiguous f32 elements of x
// (16-byte aligned, as is y).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int dl4j_threshold_dropout_f32(const float* x, float* y, unsigned int n,
                               unsigned int s0, unsigned int s1,
                               unsigned int thresh, float inv, void* stream) {
  if (n == 0) return 0;
  const unsigned int n4 = n >> 2;
  unsigned int blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threshold_dropout_f32<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, n, s0, s1, thresh, inv);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: y[i] = keep(i) ? bf16(f32(x[i]) * inv) : 0 for the n
// contiguous bf16 elements of x (their bits; 16-byte aligned, as is y), with
// the f32 form's keep(i).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int dl4j_threshold_dropout_bf16(const uint16_t* x, uint16_t* y,
                                unsigned int n, unsigned int s0,
                                unsigned int s1, unsigned int thresh,
                                float inv, void* stream) {
  if (n == 0) return 0;
  const unsigned int n8 = n >> 3;
  unsigned int blocks = (n8 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threshold_dropout_bf16<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, y, n, s0, s1, thresh, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
