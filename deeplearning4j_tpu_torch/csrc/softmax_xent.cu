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
// too.  The [N, V] probabilities never reach device memory.
//
// What bounds it on this card.  Per element it reads 8 bytes (x, y), writes
// 4 (grad) and does one exp and a few FLOPs, so the bound is HBM bandwidth
// (3.35 TB/s).  At the training path's [128, 1000] that bound is 0.46 us,
// well under the time of any launch, so what the kernel can win there is
// latency: one trip to device memory, no barrier it can do without.
//
// What the design does about it.
// * Each row is read from device memory once and kept in registers until
//   its gradient is written: x and y are loaded together, exp(x - m_lane) is
//   computed once per element and overwrites x.
// * One combined reduction.  Each thread reduces its own elements to
//   (m, z, sum y, sum y (x - m)) about its own max m; partials merge by
//   rescaling (z_a e^(m_a - m) + z_b e^(m_b - m), and sum y (x - m) shifted by
//   sum y (m_a - m)), so max, the sum of exps and both label sums travel in
//   one shuffle tree.  The gradient is then e * (e^(m_lane - m) / z * sum y)
//   - y from registers.
// * Rows up to 2,048 wide: one warp per row and per block (32 threads; up to
//   64 floats of x and of y per lane), no shared memory and no barrier; float4
//   loads and stores where V % 4 == 0 and the rows are 16-byte aligned.  Rows
//   read by single floats stop at 1,024 (32 a lane): at 64, ptxas spilled.
//   At [128, 1000] that is 128 blocks on 128 SMs, each a single round trip to
//   device memory.
// * Longer rows: a thread block cluster of up to 8 blocks of 512 threads
//   owns a row, each thread holding up to 32 floats of x and of y.  Warps
//   reduce by shuffles; their partials go to shared memory, one cluster
//   barrier makes them visible, every warp merges all of the cluster's
//   partials in the same order through distributed shared memory (so every
//   block scales with bit-identical sums), and a second barrier keeps each
//   block's shared memory alive until the others have read it.  The cluster
//   is as wide as the row needs and, for few rows, as wide as fills the SMs:
//   [64, 50257] runs 64 clusters of 4, 256 blocks, so every SM pulls from
//   device memory rather than 64.  Staging the row in shared memory instead
//   would cap a block at ~28k floats of x and y and leave the registers idle.
// * Rows wider than a full cluster holds (131,072): each thread keeps its
//   first 32 floats in registers as above and streams the rest of its
//   chunks into its partial, one exp per element (the partial rescaled when
//   its max grows); after the reduction it reads those chunks a second time
//   to write their gradient, recomputing the exp.  Only these rows are read
//   twice, and only beyond their first 131,072 elements; any V below 2^31
//   is taken.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRowMaxV = 2048;     // widest row one warp holds (float4)
constexpr int kWarpRowMaxV1 = 1024;    // the same by single floats
constexpr int kBlockThreads = 512;     // threads of a block on longer rows
constexpr int kBlockPer = 32;          // floats of x (and of y) per thread there
constexpr int kMaxCluster = 8;         // portable thread block cluster size

// Partial sums of a row's elements about their own max m: z = sum e^(x - m),
// sy = sum y, syd = sum y (x - m).  An empty partial has m = -FLT_MAX and
// zero sums (-FLT_MAX, not -inf, so that 0 * (m_a - m) stays 0).
struct Part {
  float m, z, sy, syd;
};

__device__ __forceinline__ Part merge(const Part& a, const Part& b) {
  const float m = fmaxf(a.m, b.m);
  const float da = a.m - m, db = b.m - m;
  return {m, a.z * expf(da) + b.z * expf(db), a.sy + b.sy,
          (a.syd + a.sy * da) + (b.syd + b.sy * db)};
}

// The warp's merged partial, the same in every lane (lane 0's).
__device__ __forceinline__ Part warp_merge(Part p) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const Part q = {__shfl_xor_sync(kFull, p.m, o),
                    __shfl_xor_sync(kFull, p.z, o),
                    __shfl_xor_sync(kFull, p.sy, o),
                    __shfl_xor_sync(kFull, p.syd, o)};
    p = merge(p, q);
  }
  return {__shfl_sync(kFull, p.m, 0), __shfl_sync(kFull, p.z, 0),
          __shfl_sync(kFull, p.sy, 0), __shfl_sync(kFull, p.syd, 0)};
}

// One row per cluster of `cs` blocks (cs = 1: one row per block) of
// kThreads threads; each thread holds kPer floats of x and of y, in chunks
// of kVec neighbouring floats.  Chunk c of thread t in block `rank` starts
// at ((c * cs + rank) * kThreads + t) * kVec: neighbouring threads read
// neighbouring addresses.  The blocks of kBlockThreads stream chunks past
// the kPer / kVec they hold (rows wider than the cluster's registers).
template <int kVec, int kPer, int kThreads>
__global__ void __launch_bounds__(kThreads)
softmax_xent_f32(const float* __restrict__ logits,
                 const float* __restrict__ labels, float* __restrict__ loss,
                 float* __restrict__ grad, int V, int cs) {
  constexpr int kWarps = kThreads / kWarp;
  constexpr int kChunks = kPer / kVec;
  static_assert(kPer % kVec == 0, "a thread holds whole chunks");
  __shared__ float4 parts[kWarps];

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int row = static_cast<int>(blockIdx.x) / cs;
  const int rank = static_cast<int>(blockIdx.x) % cs;
  const size_t off = static_cast<size_t>(row) * V;
  const float* __restrict__ x = logits + off;
  const float* __restrict__ y = labels + off;
  float* __restrict__ g = grad + off;

  float xv[kPer], yv[kPer];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = ((c * cs + rank) * kThreads + tid) * kVec;
    if (j < V) {
      if constexpr (kVec == 4) {
        const float4 a = *reinterpret_cast<const float4*>(x + j);
        const float4 b = *reinterpret_cast<const float4*>(y + j);
        xv[4 * c] = a.x; xv[4 * c + 1] = a.y;
        xv[4 * c + 2] = a.z; xv[4 * c + 3] = a.w;
        yv[4 * c] = b.x; yv[4 * c + 1] = b.y;
        yv[4 * c + 2] = b.z; yv[4 * c + 3] = b.w;
      } else {
        xv[c] = x[j];
        yv[c] = y[j];
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) xv[kVec * c + v] = yv[kVec * c + v] = 0.f;
    }
  }

  // this thread's partial; e = exp(x - m_lane) replaces x
  float m_lane = -FLT_MAX;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (((c * cs + rank) * kThreads + tid) * kVec < V) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) m_lane = fmaxf(m_lane, xv[kVec * c + v]);
    }
  }
  Part p = {m_lane, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (((c * cs + rank) * kThreads + tid) * kVec < V) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int i = kVec * c + v;
        const float d = xv[i] - m_lane;
        const float e = expf(d);
        p.z += e;
        p.sy += yv[i];
        p.syd += yv[i] * d;
        xv[i] = e;
      }
    }
  }

  // chunks past the registers (rows wider than a full cluster holds):
  // streamed into the partial, whose max may then exceed m_lane (the held
  // e's are scaled from m_lane below)
  const long long stride = static_cast<long long>(cs) * kThreads * kVec;
  const long long tail =
      (static_cast<long long>(kChunks * cs + rank) * kThreads + tid) * kVec;
  if constexpr (kThreads == kBlockThreads) {
    for (long long j = tail; j < V; j += stride) {
      float xc[kVec], yc[kVec];
      if constexpr (kVec == 4) {
        const float4 a = *reinterpret_cast<const float4*>(x + j);
        const float4 b = *reinterpret_cast<const float4*>(y + j);
        xc[0] = a.x; xc[1] = a.y; xc[2] = a.z; xc[3] = a.w;
        yc[0] = b.x; yc[1] = b.y; yc[2] = b.z; yc[3] = b.w;
      } else {
        xc[0] = x[j];
        yc[0] = y[j];
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float xs = xc[v], ys = yc[v];
        if (xs > p.m) {
          const float d = p.m - xs;
          p.z = p.z * expf(d) + 1.f;
          p.syd += p.sy * d;
          p.m = xs;
        } else {
          const float d = xs - p.m;
          p.z += expf(d);
          p.syd += ys * d;
        }
        p.sy += ys;
      }
    }
  }

  p = warp_merge(p);
  if (kWarps > 1 || cs > 1) {
    // every warp merges all partials of the row, in one order
    if (lane == 0) parts[warp] = make_float4(p.m, p.z, p.sy, p.syd);
    if (cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    Part q = {-FLT_MAX, 0.f, 0.f, 0.f};
    for (int k = lane; k < cs * kWarps; k += kWarp) {
      const float4* src =
          cs > 1 ? cg::this_cluster().map_shared_rank(parts, k / kWarps)
                 : parts;
      const float4 f = src[k % kWarps];
      q = merge(q, Part{f.x, f.y, f.z, f.w});
    }
    p = warp_merge(q);
    // no block leaves (and frees its shared memory) while another reads it
    if (cs > 1) cg::this_cluster().sync();
  }

  if (rank == 0 && tid == 0) loss[row] = -(p.syd - p.sy * logf(p.z));
  const float scale = expf(m_lane - p.m) / p.z * p.sy;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = ((c * cs + rank) * kThreads + tid) * kVec;
    if (j < V) {
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(g + j) = make_float4(
            xv[4 * c] * scale - yv[4 * c],
            xv[4 * c + 1] * scale - yv[4 * c + 1],
            xv[4 * c + 2] * scale - yv[4 * c + 2],
            xv[4 * c + 3] * scale - yv[4 * c + 3]);
      } else {
        g[j] = xv[c] * scale - yv[c];
      }
    }
  }
  if constexpr (kThreads == kBlockThreads) {
    const float sz = p.sy / p.z;
    for (long long j = tail; j < V; j += stride) {
      if constexpr (kVec == 4) {
        const float4 a = *reinterpret_cast<const float4*>(x + j);
        const float4 b = *reinterpret_cast<const float4*>(y + j);
        *reinterpret_cast<float4*>(g + j) = make_float4(
            expf(a.x - p.m) * sz - b.x, expf(a.y - p.m) * sz - b.y,
            expf(a.z - p.m) * sz - b.z, expf(a.w - p.m) * sz - b.w);
      } else {
        g[j] = expf(x[j] - p.m) * sz - y[j];
      }
    }
  }
}

__global__ void launch_floor_kernel() {}

struct Plan {
  int vec;      // floats per load: 4 (float4) or 1
  int per;      // floats of x (and of y) per thread
  int threads;  // threads per block
  int cs;       // blocks per row (a cluster when above 1)
};

int device_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

cudaError_t make_plan(int n_rows, int V, bool aligned, int sms, Plan* p) {
  if (n_rows < 1 || V < 1) return cudaErrorInvalidValue;
  p->vec = aligned && V % 4 == 0 ? 4 : 1;
  if (V <= (p->vec == 4 ? kWarpRowMaxV : kWarpRowMaxV1)) {
    p->threads = kWarp;
    p->cs = 1;
    p->per = 4;
    while (p->per * kWarp < V) p->per *= 2;
  } else {
    p->threads = kBlockThreads;
    p->per = kBlockPer;
    // a power of two of blocks per row: as many as the row needs, more
    // while the rows alone leave SMs idle
    const int fill = (sms + n_rows - 1) / n_rows;
    p->cs = 1;
    while (p->cs < kMaxCluster &&
           (p->cs * kBlockThreads * kBlockPer < V || p->cs < fill))
      p->cs *= 2;
  }
  if (static_cast<long long>(n_rows) * p->cs > INT_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int kVec, int kPer, int kThreads>
cudaError_t launch(const float* x, const float* y, float* loss, float* grad,
                   int n_rows, int V, int cs, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_rows * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, softmax_xent_f32<kVec, kPer, kThreads>, x,
                            y, loss, grad, V, cs);
}

template <int kVec>
cudaError_t dispatch(const Plan& p, const float* x, const float* y,
                     float* loss, float* grad, int n_rows, int V,
                     cudaStream_t s) {
  if (p.threads == kBlockThreads)
    return launch<kVec, kBlockPer, kBlockThreads>(x, y, loss, grad, n_rows,
                                                  V, p.cs, s);
  switch (p.per) {
    case 4: return launch<kVec, 4, kWarp>(x, y, loss, grad, n_rows, V, 1, s);
    case 8: return launch<kVec, 8, kWarp>(x, y, loss, grad, n_rows, V, 1, s);
    case 16: return launch<kVec, 16, kWarp>(x, y, loss, grad, n_rows, V, 1, s);
    case 32: return launch<kVec, 32, kWarp>(x, y, loss, grad, n_rows, V, 1, s);
    default:
      if constexpr (kVec == 4)
        if (p.per == 64)
          return launch<4, 64, kWarp>(x, y, loss, grad, n_rows, V, 1, s);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The plan for [n_rows, V] rows (`aligned`: all three row bases 16-byte
// aligned) on this device, as 4 ints: floats per load, floats per thread,
// threads per block, blocks per row.  Returns 0, or cudaErrorInvalidValue
// where the kernel does not apply.
int dl4j_softmax_xent_plan(int n_rows, int V, int aligned, int* out) {
  Plan p;
  const cudaError_t err = make_plan(n_rows, V, aligned != 0, device_sms(), &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.vec;
  out[1] = p.per;
  out[2] = p.threads;
  out[3] = p.cs;
  return 0;
}

// loss[N] and grad[N, V] from logits[N, V] and labels[N, V], all contiguous
// f32 on the device.  Launches on `stream` and returns the launch's error
// (0 on success).
int dl4j_softmax_xent_f32(const float* logits, const float* labels,
                          float* loss, float* grad, int n_rows, int V,
                          void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(logits) |
                         reinterpret_cast<uintptr_t>(labels) |
                         reinterpret_cast<uintptr_t>(grad)) % 16) == 0;
  Plan p;
  cudaError_t err = make_plan(n_rows, V, aligned, device_sms(), &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.vec == 4
            ? dispatch<4>(p, logits, labels, loss, grad, n_rows, V, s)
            : dispatch<1>(p, logits, labels, loss, grad, n_rows, V, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` x `threads`: the least time any launch of
// that grid takes, the floor the small kernels' times are read against.
int dl4j_launch_floor(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
