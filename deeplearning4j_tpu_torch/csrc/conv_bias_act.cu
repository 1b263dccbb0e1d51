// Fused stride-1 conv2d + bias + activation, f32-accurate, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv_bias_act_kernel`
// (deeplearning4j_tpu/ops/pallas_kernels.py:577, launched by `_conv_forward`
// :605): y = act(conv_stride1(pad(x), w) + b), f32 accumulation, the
// activation applied to the accumulator before the one write of y.
//
// What bounds it on this card: operations.  A 3x3 conv at the served shapes
// does 2*9*Cin multiply-adds per output for 4 bytes written.  f32-accurate
// products on the tensor cores take three TF32 products each (3xTF32, below),
// so the least time is 3 * FLOPs over the 494.7 TFLOP/s TF32 peak: 2.5x the
// 67 TFLOP/s of f32 FMAs on the CUDA cores.
//
// The design: an implicit GEMM on the tensor cores with `wgmma`.
//   M = output pixels (n, oh, ow), N = Cout, K = Cin*KH*KW (OIHW order).
// A block of two warpgroups owns a tile of 128 output pixels -- NI images x
// TH rows x TW cols, chosen by plan() from the output's shape -- by BN (32
// or 64) output channels, and walks K in slices of 64.
//  * B, the weights, are split once per call by a small pass into tf32
//    halves, w_hi = rna(w) and w_lo = rna(w - w_hi), written as two
//    [Cout padded to 64][K padded to 64] matrices (zero in the padding).
//    They are K-major, as wgmma wants tf32 operands, and each slice's
//    [BN][64] tile of both is two 128-byte rows per channel, stored as two
//    [BN][32] atoms: the copies write them in the 128-byte swizzle that the
//    wgmma descriptor names.
//  * A, the im2col tile, is never written anywhere.  Each slice stages the
//    input halo of the channels its 64 K indices touch,
//    [channels][NI][TH+KH-1][TW+KW-1], zero where it falls in the padding
//    (the copies' zero-fill: no padded copy of x exists), plus a table of
//    the 64 K indices' offsets into that halo.  Each thread then gathers its
//    wgmma A fragments straight from the halo into registers (a row's base
//    offset plus the K index's offset) and splits them there: a_hi =
//    rna(a), a_lo = rna(a - a_hi).
//  * Per 8-deep K step a warpgroup issues three wgmma.m64nBNk8 products,
//    a_hi.w_hi + a_hi.w_lo + a_lo.w_hi: the error of 3xTF32 is that of the
//    dropped a_lo.w_lo term, ~2^-22 relative per product, near f32's own
//    rounding.  The tensor cores round each accumulation toward zero, which
//    over a K of thousands drifts by ~1e-4 relative, so each slice's 24
//    products go into a fresh accumulator that the CUDA cores then add, with
//    rounding to nearest, to the f32 sum in registers.
//  * The copies are cp.async, into a ring of two stages: the copies of slice
//    k+1 are in flight while the warpgroups multiply slice k.  A slice's
//    products go out in four wgmma groups of six, and each quarter's A
//    fragments are gathered while the groups before it run.  The halo's
//    copies read each element's source offset from a per-block table, so a
//    copy costs one shared load and no division.  A thread waits for its
//    own copies, fences them to the async proxy that wgmma reads through,
//    and a block barrier publishes them.
//  * Small maps with many channels (VGG16's 2x2 and 4x4 maps at serving
//    batches) give too few tiles to fill 132 SMs.  There the host splits the
//    K slices over a thread block cluster of up to 8 blocks: each block
//    parks its partial accumulators in its shared memory, and after a
//    cluster barrier each block sums a share of the tile's outputs across
//    the cluster through distributed shared memory.
//  * Epilogue: bias + activation on the f32 accumulator in registers, and
//    one store of each output, in NCHW.
//
// The full-width route.  A filter that spans the input's whole padded width
// (KW == W + pl + pr, so OW == 1: the convs of a text CNN over word
// vectors, h x D) has no halo to stage: its taps run past kMaxK, and a
// tile's halo of (128 + KH - 1) rows of W floats would not fit a stage.  It
// is a plain GEMM instead: M = N * OH output rows, N = Cout, K = Cin*KH*KW.
// Output row (n, oh) reads x[n, :, oh - pt : oh - pt + KH, :], so A's row
// (n, oh) starts at n*Cin*H*W + (oh - pt)*W and K index (c, kh, kw) sits
// c*H*W + kh*W + kw - pl from it: KH*W contiguous floats per channel when
// there is no width padding.  Each slice stages its A tile, 128 rows by 64
// K in a row pitch of 68 floats (conflict-free fragment reads), straight
// from x with cp.async: 16-byte copies where W, pl and KW are multiples of
// 4 and x is 16-byte aligned, else 4-byte copies; zeros where a row or
// column falls in the padding, past K or past M.  The weights, the wgmma
// mainloop, the cluster split and the epilogue are the halo route's.
// Shapes the halo route takes stay on it.
//
// The bf16 form (dl4j_conv2d_bias_act_bf16) computes what the TPU kernel
// computes for bf16 x, w and b: products accumulated in f32, bias and
// activation on the f32 accumulator, one round-to-nearest-even store of y in
// bf16.  A bf16 product is exact in f32, so one wgmma.m64nBNk16.f32.bf16.bf16
// per 16-deep K step replaces the three tf32 products, and what it bounds is
// the operations at the 989 TFLOP/s bf16 peak.  It keeps the f32 form's plan,
// tables, ring, cluster split and stage layout (a 64-deep bf16 slice is one
// 128-byte swizzled row a channel, the byte depth of a tf32 atom): the
// weights are reordered once per call into K-major bf16 rows, with no split;
// the halo is staged in bf16 by ordinary loads, eight in flight a thread (a
// 2-byte element has no cp.async), and the full-width route's A tile by
// 8-byte cp.async copies of four bf16 where the f32 form takes 16 bytes.  A
// thread gathers its A fragments, two bf16 a register, straight from the
// halo, and a slice's four products go into a fresh accumulator that the
// CUDA cores add to the f32 sum, as in the f32 form.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "hopper_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // two warpgroups of 64 pixel rows
constexpr int kBM = 128;               // output pixels per block
constexpr int kBK = 64;                // K per slice: two 128-byte rows
constexpr int kStages = 2;             // cp.async ring depth
constexpr int kMaxK = 7;               // largest KH / KW of the halo route
constexpr int kMaxTW = 32;             // widest tile, in output columns
constexpr int kHaloMaxFloats = 6144;   // staged halo per stage, 24 KB
constexpr int kAPitch = kBK + 4;       // full-width route: A tile row pitch
constexpr int kMaxCluster = 8;         // portable thread block cluster size
constexpr int kWRowPad = 64;           // split weights' rows: Cout up to this
constexpr int kSmemMax = 231424;       // dynamic shared memory: 227 KB less 1 KB
                                       // for the static tap table

// Activation ids; the Python wrapper maps names to these (ops/cuda_kernels.py).
enum Act {
  kIdentity = 0, kRelu, kRelu6, kTanh, kSigmoid, kLeakyRelu, kElu, kGelu,
  kSoftplus, kSoftsign, kSwish, kSelu, kHardSigmoid, kHardTanh
};

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kRelu6: return fminf(fmaxf(v, 0.0f), 6.0f);
    case kTanh: return tanhf(v);
    case kSigmoid: return sigmoidf(v);
    case kLeakyRelu: return v >= 0.0f ? v : 0.01f * v;
    case kElu: return v > 0.0f ? v : expm1f(v);
    case kGelu: {
      const float k = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    case kSoftplus: return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
    case kSoftsign: return v / (1.0f + fabsf(v));
    case kSwish: return v * sigmoidf(v);
    case kSelu:
      return 1.0507009873554805f *
             (v > 0.0f ? v : 1.6732632423543772f * expm1f(v));
    case kHardSigmoid: return fminf(fmaxf(0.2f * v + 0.5f, 0.0f), 1.0f);
    case kHardTanh: return fminf(fmaxf(v, -1.0f), 1.0f);
    default: return v;
  }
}

// ---------------------------------------------------------------------------
// The plan
// ---------------------------------------------------------------------------

struct Plan {
  int fw;                 // 1: the full-width route (OW == 1), 0: the halo
  int bn;                 // output channels per block: 32 or 64
  int ni, th, tw;         // images, rows and columns of a tile of pixels
                          // (full width: 1, kBM rows of M = N*OH, 1)
  int hr, hp;             // staged halo rows and row pitch (full width: the
                          // A tile's kBM rows and kAPitch)
  int nch;                // input channels staged per slice (full width: 0)
  int halo_floats;        // staged halo (A tile) per stage (multiple of 32)
  int tiles_n, tiles_h, tiles_w, tiles_c;   // image groups, row and column
                                            // tiles, Cout tiles
  int slices;             // K slices of kBK: Kpad / kBK
  int cs;                 // blocks per cluster splitting the slices
  int per_rank;           // slices each block of a cluster multiplies
  int stage_bytes;        // one ring stage: w_hi, w_lo, halo, offsets
  int table_off;          // byte offset of the halo's source offsets
  int smem;               // dynamic shared memory bytes
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The smallest tile that covers `size` in as few tiles as `d` does.
int balance(int size, int d) { return cdiv(size, cdiv(size, d)); }

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Tile of kBM output pixels: try widths of 32, 16, 8 and 4 columns (the
// output's width if narrower), the rows that fill 128 pixels, and several
// whole images when an image is smaller than a tile; keep the candidate with
// the fewest tiles, then the smallest halo.
void choose_tile(int N, int OH, int OW, int KH, int KW, Plan* p) {
  const int widths[4] = {kMaxTW, 16, 8, 4};
  long long best_tiles = -1;
  int best_halo = 0;
  for (int c = 0; c < 4; ++c) {
    int tw = balance(OW, imin(OW, widths[c]));
    int th = balance(OH, imin(OH, kBM / tw));
    int ni = (th == OH && tw == OW) ? balance(N, imin(N, kBM / (th * tw)))
                                    : 1;
    while (p->nch * ni * (th + KH - 1) * (tw + KW - 1) > kHaloMaxFloats) {
      if (ni > 1) ni = balance(N, (ni + 1) / 2);
      else if (th > 1) th = balance(OH, (th + 1) / 2);
      else tw = balance(OW, (tw + 1) / 2);
    }
    const long long tiles =
        static_cast<long long>(cdiv(N, ni)) * cdiv(OH, th) * cdiv(OW, tw);
    const int halo = p->nch * ni * (th + KH - 1) * (tw + KW - 1);
    if (best_tiles < 0 || tiles < best_tiles ||
        (tiles == best_tiles && halo < best_halo)) {
      best_tiles = tiles;
      best_halo = halo;
      p->ni = ni;
      p->th = th;
      p->tw = tw;
    }
  }
}

// Where the halo route applies, in closed form: KH, KW <= kMaxK; K <=
// 2^30; a halo element's offset in x from its tile's first image is an int
// (a tile holds several images only when one image fits in kBM pixels, and
// H <= OH + KH - 1, W <= OW + KW - 1 for a stride-1 conv); and the grid
// fits CUDA's 2^31 - 1 blocks (every tile has an output pixel, and a
// cluster split only multiplies grids below two blocks per SM).
bool halo_supported(int N, int Cin, int KH, int KW, int Cout, int OH,
                    int OW) {
  if (N < 1 || Cin < 1 || Cout < 1 || OH < 1 || OW < 1 || KH < 1 ||
      KW < 1 || KH > kMaxK || KW > kMaxK)
    return false;
  if (static_cast<long long>(Cin) * KH * KW > (1LL << 30)) return false;
  const long long pix = static_cast<long long>(OH) * OW;
  const long long ni = pix <= kBM ? imin(N, kBM / static_cast<int>(pix)) : 1;
  if (ni * Cin * (OH + KH - 1) * (OW + KW - 1) > 0x7FFFFFFFLL) return false;
  return static_cast<long long>(N) * pix * cdiv(Cout, Cout <= 32 ? 32 : 64) <=
         0x7FFFFFFFLL;
}

// Where the full-width route applies: OW == 1 (a stride-1 filter as wide as
// the padded input), KH and KW of any size with K <= 2^30; an element's
// offset in x from its image is an int (Cin*H*W <= Cin*(OH+KH-1)*KW); M =
// N*OH is an int; and the grid of M tiles by Cout tiles fits.
bool full_width_supported(int N, int Cin, int KH, int KW, int Cout, int OH,
                          int OW) {
  if (N < 1 || Cin < 1 || Cout < 1 || OH < 1 || OW != 1 || KH < 1 || KW < 1)
    return false;
  if (static_cast<long long>(Cin) * KH * KW > (1LL << 30)) return false;
  if (static_cast<long long>(Cin) * (OH + KH - 1) * KW > 0x7FFFFFFFLL)
    return false;
  const long long m = static_cast<long long>(N) * OH;
  return m <= 0x7FFFFFFFLL &&
         (m + kBM - 1) / kBM * cdiv(Cout, Cout <= 32 ? 32 : 64) <=
             0x7FFFFFFFLL;
}

// Where the kernel applies (ops/cuda_kernels.py's conv_fused_supported is
// the same test): either route; a shape both take goes the halo route.
bool supported(int N, int Cin, int KH, int KW, int Cout, int OH, int OW) {
  return halo_supported(N, Cin, KH, KW, Cout, OH, OW) ||
         full_width_supported(N, Cin, KH, KW, Cout, OH, OW);
}

// The most shared memory a plan asks for: the ring, whose halo is at most
// kHaloMaxFloats floats a stage, then the halo plane's source offsets (no
// more than the halo's floats) and alignment slack.  The parked
// accumulators of a cluster split reuse the ring's bytes.
constexpr int kRingMax =
    kStages * ((2 * 64 * kBK * 4 + kHaloMaxFloats * 4 + kBK * 4 + 1023) /
               1024 * 1024);
static_assert(64 / 2 * kThreads * 4 <= kRingMax, "parked sums exceed ring");
static_assert(kRingMax + kHaloMaxFloats * 4 + 1024 <= kSmemMax,
              "a plan could ask for more shared memory than a block has");
// the full-width route's ring (A tile instead of the halo) and row tables
constexpr int kRingFw =
    kStages * ((2 * 64 * kBK * 4 + kBM * kAPitch * 4 + kBK * 4 + 1023) /
               1024 * 1024);
static_assert(kRingFw + kBM * 12 + 1024 <= kSmemMax,
              "the full-width plan asks for more shared memory than a block "
              "has");

// The whole launch plan, for a shape supported() accepts.
void plan(int N, int Cin, int KH, int KW, int Cout, int OH, int OW, int sms,
          Plan* p) {
  const int taps = KH * KW;
  const int kpad = cdiv(Cin * taps, kBK) * kBK;
  p->fw = halo_supported(N, Cin, KH, KW, Cout, OH, OW) ? 0 : 1;
  p->bn = Cout <= 32 ? 32 : 64;
  if (p->fw) {
    // one tile: kBM rows of M = N*OH, staged as [kBM][kAPitch]
    p->nch = 0;
    p->ni = 1;
    p->th = kBM;
    p->tw = 1;
    p->hr = kBM;
    p->hp = kAPitch;
    p->halo_floats = kBM * kAPitch;
    p->tiles_n = 1;
    p->tiles_h = static_cast<int>(
        (static_cast<long long>(N) * OH + kBM - 1) / kBM);
    p->tiles_w = 1;
  } else {
    // channels that kBK consecutive K indices can touch, and no more than
    // the padded K holds
    p->nch = imin((kBK + taps - 2) / taps + 1, (kpad - 1) / taps + 1);
    choose_tile(N, OH, OW, KH, KW, p);
    p->hr = p->th + KH - 1;
    p->hp = p->tw + KW - 1;
    p->halo_floats = cdiv(p->nch * p->ni * p->hr * p->hp, 32) * 32;
    p->tiles_n = cdiv(N, p->ni);
    p->tiles_h = cdiv(OH, p->th);
    p->tiles_w = cdiv(OW, p->tw);
  }
  p->tiles_c = cdiv(Cout, p->bn);
  p->slices = kpad / kBK;
  const long long blocks = static_cast<long long>(p->tiles_n) * p->tiles_h *
                           p->tiles_w * p->tiles_c;
  // split K over a cluster while the grid has fewer than two blocks per SM
  p->cs = 1;
  while (p->cs < kMaxCluster && p->slices >= 2 * p->cs &&
         blocks * p->cs < 2LL * sms)
    p->cs *= 2;
  p->per_rank = cdiv(p->slices, p->cs);
  p->stage_bytes =
      cdiv(2 * p->bn * kBK * 4 + p->halo_floats * 4 + kBK * 4, 1024) * 1024;
  const int ring = kStages * p->stage_bytes;
  const int part = p->bn / 2 * kThreads * 4;      // parked accumulators
  p->table_off = ring > part ? ring : part;
  // + the halo plane's source offsets (4 bytes each), or the full-width
  // tile's row offsets (8 bytes) and first input rows (4), + alignment slack
  p->smem = p->table_off +
            (p->fw ? kBM * 12 : p->ni * p->hr * p->hp * 4) + 1024;
}

struct Shape {
  int N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW, act;
  int kpad;               // row length of the split weights
  long long lo_off;       // floats from w_hi to w_lo
  int vec;                // full width: A's copies are 16 bytes, else 4
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// w [rows_w][K] -> w_hi, w_lo [rows][kpad], zero beyond rows_w and K.
__global__ void split_tf32_kernel(const float* __restrict__ w,
                                  float* __restrict__ ws, int rows_w, int K,
                                  int kpad, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i / kpad);
  const int k = static_cast<int>(i % kpad);
  const float v = (n < rows_w && k < K)
                      ? w[static_cast<long long>(n) * K + k] : 0.0f;
  const uint32_t hi = tf32_rna(v);
  const float lo = v - __uint_as_float(hi);
  ws[i] = __uint_as_float(hi);
  ws[total + i] = __uint_as_float(tf32_rna(lo));
}

template <int BN, bool FW>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                  const float* __restrict__ b, float* __restrict__ y,
                  Shape s, Plan p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tap_off[kMaxK * kMaxK];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // the swizzle needs 1 KB
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  int rank = 0;
  if (p.cs > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  int t = blockIdx.x / p.cs;
  const int ct = t % p.tiles_c;
  t /= p.tiles_c;
  const int ow0 = (t % p.tiles_w) * p.tw;
  t /= p.tiles_w;
  const int oh0 = (t % p.tiles_h) * p.th;   // full width: the tile's first
  const int n0 = (t / p.tiles_h) * p.ni;    // row of M, and n0 = 0
  const int co0 = ct * BN;

  const int taps = s.KH * s.KW;
  const int plane = p.ni * p.hr * p.hp;
  const long long chw = static_cast<long long>(s.H) * s.W;
  const float* xn = x + static_cast<long long>(n0) * s.Cin * chw;
  // Halo route: the halo plane [NI][TH+KH-1][TW+KW-1], each element's
  // offset in x from image n0's channel 0, -1 where it is padding, and the
  // taps' offsets in it.  Full width: each tile row's offset in x of its
  // first input row, oh - pt, and that row's index (dead rows: far out).
  int* src_off = reinterpret_cast<int*>(smem + p.table_off);
  long long* row_off = reinterpret_cast<long long*>(smem + p.table_off);
  int* row_ih = reinterpret_cast<int*>(smem + p.table_off + kBM * 8);
  const int M = s.N * s.OH;
  if constexpr (FW) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int m = oh0 + r;
      const int n = m / s.OH, oh = m % s.OH;
      row_off[r] = m < M ? static_cast<long long>(n) * s.Cin * chw +
                               static_cast<long long>(oh - s.pt) * s.W
                         : 0;
      row_ih[r] = m < M ? oh - s.pt : -(1 << 30);
    }
  } else {
    for (int e = tid; e < plane; e += kThreads) {
      const int li = e / (p.hr * p.hp), rem = e % (p.hr * p.hp);
      const int ih = oh0 - s.pt + rem / p.hp, iw = ow0 - s.pl + rem % p.hp;
      src_off[e] = (n0 + li < s.N && ih >= 0 && ih < s.H && iw >= 0 &&
                    iw < s.W)
                       ? static_cast<int>(li * s.Cin * chw + ih * s.W + iw)
                       : -1;
    }
    for (int i = tid; i < taps; i += kThreads)
      tap_off[i] = (i / s.KW) * p.hp + i % s.KW;
  }

  // this thread's two pixel rows of the tile (accumulator rows g and g+8)
  const int pix = p.th * p.tw;
  const int live_rows = FW ? imin(kBM, M - oh0) : p.ni * pix;
  int rbase[2];
  long long yoff[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    if constexpr (FW) {
      const int m = oh0 + r;
      live[h] = r < live_rows;
      rbase[h] = r * kAPitch;
      yoff[h] = live[h] ? static_cast<long long>(m / s.OH) * s.Cout * s.OH +
                              m % s.OH
                        : 0;
    } else {
      const int rn = r / pix, rem = r % pix;
      const int rh = rem / p.tw, rw = rem % p.tw;
      live[h] = r < live_rows && n0 + rn < s.N && oh0 + rh < s.OH &&
                ow0 + rw < s.OW;
      rbase[h] = live[h] ? (rn * p.hr + rh) * p.hp + rw : 0;
      yoff[h] = live[h] ? (static_cast<long long>(n0 + rn) * s.Cout * s.OH +
                           oh0 + rh) * s.OW + ow0 + rw
                        : 0;
    }
  }
  const bool wg_live = wg * 64 < live_rows;     // warpgroup-uniform

  const int s_begin = rank * p.per_rank;
  const int s_end = imin(p.slices, s_begin + p.per_rank);
  const int ns = s_end > s_begin ? s_end - s_begin : 0;
  const int halo_bytes = p.halo_floats * 4;
  // this thread's halo elements f = tid + 256 j of [channel][plane]:
  // channel f / plane, element f % plane, walked without a division
  const int c_first = tid / plane, e_first = tid % plane;
  const int c_step = kThreads / plane, e_step = kThreads % plane;
  // the K bookkeeping of the next slice to load, without divisions: its
  // first channel c_lo (k0 = c_lo * taps + t_lo), and the channel and tap
  // (kc, kt) of K index k0 + kidx, whose halo offset thread kidx writes
  const int k_first = s_begin * kBK;
  int c_lo = k_first / taps, t_lo = k_first % taps;
  const int kidx = tid % kBK;
  int kc = (k_first + kidx) / taps, kt = (k_first + kidx) % taps;
  auto advance = [&](int& c, int& t) {
    c += kBK / taps;
    t += kBK % taps;
    if (t >= taps) {
      t -= taps;
      ++c;
    }
  };
  // Full width: this thread's column of the A tile (four columns with
  // 16-byte copies) and its first row; it copies every rstep-th row.
  const int fw_col = s.vec ? 4 * (tid & 15) : tid & (kBK - 1);
  const int fw_row = s.vec ? tid >> 4 : tid / kBK;
  const int fw_rstep = s.vec ? kThreads / 16 : kThreads / kBK;
  const int K = s.Cin * taps;

  // issue the copies of slice `sl` into ring stage `st` (slices in order)
  auto load = [&](int sl, int st) {
    const uint32_t sa = base + st * p.stage_bytes;
    const int k0 = sl * kBK;
    // w_hi and w_lo tiles, [atom][BN][32 f32] each: row n's 16-byte chunk
    // c of an atom goes to chunk c ^ (n % 8)
#pragma unroll
    for (int j = 0; j < 2 * BN * kBK / 4 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int half = e / (BN * kBK / 4);
      const int n = (e / (kBK / 4)) % BN;
      const int c = e % (kBK / 4);
      cp_async16(sa + half * (BN * kBK * 4) + (c >> 3) * (BN * 128) +
                     n * 128 + (((c & 7) ^ (n & 7)) << 4),
                 ws + half * s.lo_off +
                     static_cast<long long>(co0 + n) * s.kpad + k0 + 4 * c);
    }
    const uint32_t halo = sa + 2 * BN * kBK * 4;
    if constexpr (FW) {
      // the A tile [kBM][kAPitch]: K index k (and, with 16-byte copies,
      // the next three, in the same input row) of every rstep-th row; zero
      // where the row or column is padding, past K, or a dead row
      const int k = k0 + fw_col;
      const int c = k / taps, rt = k % taps;
      const int kh = rt / s.KW, iw = rt % s.KW - s.pl;
      const bool k_ok = k < K && iw >= 0 && iw < s.W;
      const long long koff = c * chw + static_cast<long long>(kh) * s.W + iw;
      for (int r = fw_row; r < kBM; r += fw_rstep) {
        const bool ok = k_ok && static_cast<unsigned>(row_ih[r] + kh) <
                                    static_cast<unsigned>(s.H);
        const float* src = ok ? x + row_off[r] + koff : x;
        const uint32_t dst = halo + (r * kAPitch + fw_col) * 4;
        if (s.vec)
          cp_async16_zfill(dst, src, ok ? 16 : 0);
        else
          cp_async4(dst, src, ok ? 4 : 0);
      }
    } else {
      // the halo of the channels this slice touches, zero outside the image
      int c = c_first, e = e_first;
      for (int f = tid; f < p.nch * plane; f += kThreads) {
        const int g = src_off[e];
        const bool ok = g >= 0 && c_lo + c < s.Cin;
        cp_async4(halo + f * 4, ok ? xn + (c_lo + c) * chw + g : x,
                  ok ? 4 : 0);
        c += c_step;
        e += e_step;
        if (e >= plane) {
          e -= plane;
          ++c;
        }
      }
      // each K index's offset into the halo
      if (tid < kBK) {
        int* koff = reinterpret_cast<int*>(smem + st * p.stage_bytes +
                                           2 * BN * kBK * 4 + halo_bytes);
        koff[tid] = (kc - c_lo) * plane + tap_off[kt];
      }
      advance(c_lo, t_lo);
      advance(kc, kt);
    }
  };

  // Two-level sum: each slice's 24 products go into a fresh wgmma
  // accumulator (`part`), which is then added to `acc` by the CUDA cores.
  // The tensor cores round each accumulation toward zero; summed into one
  // accumulator over a whole K of 4,608 that loses ~1e-4 relative, while a
  // slice's partial is small, and the slices' sum rounds to nearest.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

  __syncthreads();                      // src_off, tap_off or the row tables
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) load(s_begin + i, i);
    cp_async_commit();
  }
  // Per slice of 8 K steps, in quarters of two: gather a quarter's A
  // fragments and issue its six products as one wgmma group; before the
  // third and fourth quarters reuse the first and second quarters'
  // registers, wait until only one group is in flight.  The copies of
  // slice i+1 are issued while the last groups run.
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();       // this thread's copies of slice i
    fence_proxy_async();
    __syncthreads();                    // everyone's; stage i-1 is free
    if (wg_live) {
      const int st = i % kStages;
      const uint8_t* stage = smem + st * p.stage_bytes;
      const float* halo =
          reinterpret_cast<const float*>(stage + 2 * BN * kBK * 4);
      const int* koff = reinterpret_cast<const int*>(
          stage + 2 * BN * kBK * 4 + halo_bytes);
      const uint32_t sa = base + st * p.stage_bytes;
      uint32_t a_hi[2][2][4], a_lo[2][2][4];
#pragma unroll
      for (int qt = 0; qt < kBK / 16; ++qt) {
        if (qt >= 2) wgmma_wait<1>();   // quarter qt-2's registers are free
        uint32_t (&ah)[2][4] = a_hi[qt & 1];
        uint32_t (&al)[2][4] = a_lo[qt & 1];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kk = 2 * qt + u;
          // full width: the A tile's columns are the slice's K indices
          const int k_a = FW ? 8 * kk + (lane & 3)
                             : koff[8 * kk + (lane & 3)];
          const int k_b = FW ? 8 * kk + (lane & 3) + 4
                             : koff[8 * kk + (lane & 3) + 4];
          const float v[4] = {halo[rbase[0] + k_a], halo[rbase[1] + k_a],
                              halo[rbase[0] + k_b], halo[rbase[1] + k_b]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ah[u][q] = tf32_rna(v[q]);
            al[u][q] = tf32_rna(v[q] - __uint_as_float(ah[u][q]));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kk = 2 * qt + u;
          // atom kk / 4 of the tile; 8 K are 32 bytes along its rows, >> 4
          const uint32_t at = sa + (kk >> 2) * (BN * 128);
          const uint64_t d_hi = sw128_desc(at) + 2 * (kk & 3);
          const uint64_t d_lo = sw128_desc(at + BN * kBK * 4) + 2 * (kk & 3);
          Wgmma<BN>::mma(part, ah[u], d_hi, kk > 0);
          Wgmma<BN>::mma(part, ah[u], d_lo, 1);
          Wgmma<BN>::mma(part, al[u], d_hi, 1);
        }
        wgmma_commit();
      }
    }
    const int nx = i + kStages - 1;
    if (nx < ns) load(s_begin + nx, nx % kStages);
    cp_async_commit();
    if (wg_live) {
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        fence_operand(part[j]);
        acc[j] += part[j];
      }
    }
  }
  cp_async_wait<0>();

  // accumulator element i: column pair j = i / 4, row g + 8 * ((i / 2) % 2),
  // column 8 j + 2 (lane % 4) + i % 2
  const long long plane_out = static_cast<long long>(s.OH) * s.OW;
  if (p.cs == 1) {
    if (!wg_live) return;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int co = co0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int h = (i >> 1) & 1;
      if (live[h] && co < s.Cout)
        y[yoff[h] + co * plane_out] = activate(acc[i] + b[co], s.act);
    }
    return;
  }

  // cluster split: park the partial sums, reduce a share across the cluster
  cg::cluster_group cluster = cg::this_cluster();
  float* parked = reinterpret_cast<float*>(smem);   // [BN / 2][kThreads]
  __syncthreads();                                  // the ring is drained
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) parked[i * kThreads + tid] = acc[i];
  cluster.sync();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if (i % p.cs != rank) continue;
    float sum = 0.0f;
    for (int q = 0; q < p.cs; ++q)
      sum += cluster.map_shared_rank(parked, q)[i * kThreads + tid];
    const int co = co0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    const int h = (i >> 1) & 1;
    if (live[h] && co < s.Cout)
      y[yoff[h] + co * plane_out] = activate(sum + b[co], s.act);
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <int BN, bool FW>
cudaError_t launch(const float* x, const float* ws, const float* b, float* y,
                   const Shape& s, const Plan& p, cudaStream_t stream) {
  static bool attr_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_kernel<BN, FW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const long long blocks = static_cast<long long>(p.tiles_n) * p.tiles_h *
                           p.tiles_w * p.tiles_c * p.cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_wgmma_kernel<BN, FW>, x,
                                       ws, b, y, s, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 form
// ---------------------------------------------------------------------------

// w [rows_w][K] -> ws [rows][kpad] (bf16 bits), zero beyond rows_w and K.
__global__ void reorder_bf16_kernel(const uint16_t* __restrict__ w,
                                    uint16_t* __restrict__ ws, int rows_w,
                                    int K, int kpad, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i / kpad);
  const int k = static_cast<int>(i % kpad);
  ws[i] = (n < rows_w && k < K) ? w[static_cast<long long>(n) * K + k]
                                : static_cast<uint16_t>(0);
}

__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The bf16 form of conv_wgmma_kernel: the same plan, tables, ring, cluster
// split and epilogue; bf16 x, w, b and y (as their bits); one bf16 product a
// 16-deep K step.  A stage holds the weights' [BN][64] bf16 tile at its
// start (one 128-byte swizzled row a channel), and the halo (the A tile) and
// the K offsets at the f32 form's offsets, so the f32 plan's stage size and
// shared memory serve it.
template <int BN, bool FW>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgmma_bf16_kernel(const uint16_t* __restrict__ x,
                       const uint16_t* __restrict__ ws,
                       const uint16_t* __restrict__ b,
                       uint16_t* __restrict__ y, Shape s, Plan p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tap_off[kMaxK * kMaxK];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // the swizzle needs 1 KB
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  int rank = 0;
  if (p.cs > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  int t = blockIdx.x / p.cs;
  const int ct = t % p.tiles_c;
  t /= p.tiles_c;
  const int ow0 = (t % p.tiles_w) * p.tw;
  t /= p.tiles_w;
  const int oh0 = (t % p.tiles_h) * p.th;
  const int n0 = (t / p.tiles_h) * p.ni;
  const int co0 = ct * BN;

  const int taps = s.KH * s.KW;
  const int plane = p.ni * p.hr * p.hp;
  const long long chw = static_cast<long long>(s.H) * s.W;
  const uint16_t* xn = x + static_cast<long long>(n0) * s.Cin * chw;
  int* src_off = reinterpret_cast<int*>(smem + p.table_off);
  long long* row_off = reinterpret_cast<long long*>(smem + p.table_off);
  int* row_ih = reinterpret_cast<int*>(smem + p.table_off + kBM * 8);
  const int M = s.N * s.OH;
  if constexpr (FW) {
    for (int r = tid; r < kBM; r += kThreads) {
      const int m = oh0 + r;
      const int n = m / s.OH, oh = m % s.OH;
      row_off[r] = m < M ? static_cast<long long>(n) * s.Cin * chw +
                               static_cast<long long>(oh - s.pt) * s.W
                         : 0;
      row_ih[r] = m < M ? oh - s.pt : -(1 << 30);
    }
  } else {
    for (int e = tid; e < plane; e += kThreads) {
      const int li = e / (p.hr * p.hp), rem = e % (p.hr * p.hp);
      const int ih = oh0 - s.pt + rem / p.hp, iw = ow0 - s.pl + rem % p.hp;
      src_off[e] = (n0 + li < s.N && ih >= 0 && ih < s.H && iw >= 0 &&
                    iw < s.W)
                       ? static_cast<int>(li * s.Cin * chw + ih * s.W + iw)
                       : -1;
    }
    for (int i = tid; i < taps; i += kThreads)
      tap_off[i] = (i / s.KW) * p.hp + i % s.KW;
  }

  const int pix = p.th * p.tw;
  const int live_rows = FW ? imin(kBM, M - oh0) : p.ni * pix;
  int rbase[2];
  long long yoff[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    if constexpr (FW) {
      const int m = oh0 + r;
      live[h] = r < live_rows;
      rbase[h] = r * kAPitch;
      yoff[h] = live[h] ? static_cast<long long>(m / s.OH) * s.Cout * s.OH +
                              m % s.OH
                        : 0;
    } else {
      const int rn = r / pix, rem = r % pix;
      const int rh = rem / p.tw, rw = rem % p.tw;
      live[h] = r < live_rows && n0 + rn < s.N && oh0 + rh < s.OH &&
                ow0 + rw < s.OW;
      rbase[h] = live[h] ? (rn * p.hr + rh) * p.hp + rw : 0;
      yoff[h] = live[h] ? (static_cast<long long>(n0 + rn) * s.Cout * s.OH +
                           oh0 + rh) * s.OW + ow0 + rw
                        : 0;
    }
  }
  const bool wg_live = wg * 64 < live_rows;     // warpgroup-uniform

  const int s_begin = rank * p.per_rank;
  const int s_end = imin(p.slices, s_begin + p.per_rank);
  const int ns = s_end > s_begin ? s_end - s_begin : 0;
  const int w_bytes = 2 * BN * kBK * 4;         // the f32 form's weights
  const int halo_bytes = p.halo_floats * 4;     // and halo, in bytes
  const int c_first = tid / plane, e_first = tid % plane;
  const int c_step = kThreads / plane, e_step = kThreads % plane;
  const int k_first = s_begin * kBK;
  int c_lo = k_first / taps, t_lo = k_first % taps;
  const int kidx = tid % kBK;
  int kc = (k_first + kidx) / taps, kt = (k_first + kidx) % taps;
  auto advance = [&](int& c, int& t) {
    c += kBK / taps;
    t += kBK % taps;
    if (t >= taps) {
      t -= taps;
      ++c;
    }
  };
  // Full width: this thread's column of the A tile (four columns with
  // 8-byte copies) and its first row; it copies every rstep-th row.
  const int fw_col = s.vec ? 4 * (tid & 15) : tid & (kBK - 1);
  const int fw_row = s.vec ? tid >> 4 : tid / kBK;
  const int fw_rstep = s.vec ? kThreads / 16 : kThreads / kBK;
  const int K = s.Cin * taps;

  // the copies and loads of slice `sl` into ring stage `st` (slices in
  // order); a stage's ordinary stores are published by the block barrier
  // that also publishes its copies
  auto load = [&](int sl, int st) {
    const uint32_t sa = base + st * p.stage_bytes;
    uint8_t* stage = smem + st * p.stage_bytes;
    const int k0 = sl * kBK;
    // the weights' [BN][64] tile: row n's 16-byte chunk c goes to chunk
    // c ^ (n % 8)
#pragma unroll
    for (int j = 0; j < BN * (kBK / 8) / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int n = e / (kBK / 8), c = e % (kBK / 8);
      cp_async16(sa + n * 128 + ((c ^ (n & 7)) << 4),
                 ws + static_cast<long long>(co0 + n) * s.kpad + k0 + 8 * c);
    }
    uint16_t* halo = reinterpret_cast<uint16_t*>(stage + w_bytes);
    if constexpr (FW) {
      const int k = k0 + fw_col;
      const int c = k / taps, rt = k % taps;
      const int kh = rt / s.KW, iw = rt % s.KW - s.pl;
      const bool k_ok = k < K && iw >= 0 && iw < s.W;
      const long long koff = c * chw + static_cast<long long>(kh) * s.W + iw;
      if (s.vec) {
        for (int r = fw_row; r < kBM; r += fw_rstep) {
          const bool ok = k_ok && static_cast<unsigned>(row_ih[r] + kh) <
                                      static_cast<unsigned>(s.H);
          cp_async8_zfill(sa + w_bytes + (r * kAPitch + fw_col) * 2,
                          ok ? x + row_off[r] + koff : x, ok ? 8 : 0);
        }
      } else {
        for (int r0 = fw_row; r0 < kBM; r0 += 8 * fw_rstep) {
          uint16_t v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = r0 + j * fw_rstep;
            const bool ok = r < kBM && k_ok &&
                            static_cast<unsigned>(row_ih[r] + kh) <
                                static_cast<unsigned>(s.H);
            v[j] = ok ? __ldg(x + row_off[r] + koff)
                      : static_cast<uint16_t>(0);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = r0 + j * fw_rstep;
            if (r < kBM) halo[r * kAPitch + fw_col] = v[j];
          }
        }
      }
    } else {
      // the halo of the channels this slice touches, zero outside the
      // image: eight loads in flight, then their stores
      const int total = p.nch * plane;
      int c = c_first, e = e_first;
      for (int f0 = tid; f0 < total; f0 += 8 * kThreads) {
        uint16_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int g = src_off[e];
          const bool ok = f0 + j * kThreads < total && g >= 0 &&
                          c_lo + c < s.Cin;
          v[j] = ok ? __ldg(xn + (c_lo + c) * chw + g)
                    : static_cast<uint16_t>(0);
          c += c_step;
          e += e_step;
          if (e >= plane) {
            e -= plane;
            ++c;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (f0 + j * kThreads < total) halo[f0 + j * kThreads] = v[j];
      }
      if (tid < kBK) {
        int* koff = reinterpret_cast<int*>(stage + w_bytes + halo_bytes);
        koff[tid] = (kc - c_lo) * plane + tap_off[kt];
      }
      advance(c_lo, t_lo);
      advance(kc, kt);
    }
  };

  // each slice's four products into a fresh accumulator, added to `acc` by
  // the CUDA cores (the f32 form's two-level sum)
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

  __syncthreads();                      // src_off, tap_off or the row tables
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) load(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();       // this thread's copies of slice i
    fence_proxy_async();
    __syncthreads();                    // everyone's; stage i-1 is free
    if (wg_live) {
      const int st = i % kStages;
      const uint8_t* stage = smem + st * p.stage_bytes;
      const uint16_t* halo = reinterpret_cast<const uint16_t*>(stage + w_bytes);
      const int* koff =
          reinterpret_cast<const int*>(stage + w_bytes + halo_bytes);
      const uint32_t sa = base + st * p.stage_bytes;
      // A fragments of the slice's four K steps: K 2t, 2t+1 (q = 0) and
      // 2t+8, 2t+9 (q = 1) of rows g (register 2q) and g+8 (2q+1)
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = 16 * kk + 8 * q + 2 * (lane & 3);
          const int o0 = FW ? k : koff[k];
          const int o1 = FW ? k + 1 : koff[k + 1];
          a[kk][2 * q] = pack_bf16(halo[rbase[0] + o0], halo[rbase[0] + o1]);
          a[kk][2 * q + 1] =
              pack_bf16(halo[rbase[1] + o0], halo[rbase[1] + o1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)    // 16 K are 32 bytes, >> 4
        WgmmaBf16<BN>::mma(part, a[kk], sw128_desc(sa) + 2 * kk, kk > 0);
      wgmma_commit();
    }
    const int nx = i + kStages - 1;
    if (nx < ns) load(s_begin + nx, nx % kStages);
    cp_async_commit();
    if (wg_live) {
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        fence_operand(part[j]);
        acc[j] += part[j];
      }
    }
  }
  cp_async_wait<0>();

  const long long plane_out = static_cast<long long>(s.OH) * s.OW;
  if (p.cs == 1) {
    if (!wg_live) return;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int co = co0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int h = (i >> 1) & 1;
      if (live[h] && co < s.Cout)
        y[yoff[h] + co * plane_out] = float_to_bf16_bits(
            activate(acc[i] + bf16_bits_to_float(b[co]), s.act));
    }
    return;
  }

  cg::cluster_group cluster = cg::this_cluster();
  float* parked = reinterpret_cast<float*>(smem);   // [BN / 2][kThreads]
  __syncthreads();                                  // the ring is drained
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) parked[i * kThreads + tid] = acc[i];
  cluster.sync();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if (i % p.cs != rank) continue;
    float sum = 0.0f;
    for (int q = 0; q < p.cs; ++q)
      sum += cluster.map_shared_rank(parked, q)[i * kThreads + tid];
    const int co = co0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    const int h = (i >> 1) & 1;
    if (live[h] && co < s.Cout)
      y[yoff[h] + co * plane_out] = float_to_bf16_bits(
          activate(sum + bf16_bits_to_float(b[co]), s.act));
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <int BN, bool FW>
cudaError_t launch_bf16(const uint16_t* x, const uint16_t* ws,
                        const uint16_t* b, uint16_t* y, const Shape& s,
                        const Plan& p, cudaStream_t stream) {
  static bool attr_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_bf16_kernel<BN, FW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const long long blocks = static_cast<long long>(p.tiles_n) * p.tiles_h *
                           p.tiles_w * p.tiles_c * p.cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_wgmma_bf16_kernel<BN, FW>,
                                       x, ws, b, y, s, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int device_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" {

// The plan for a conv on a card with `sms` SMs, as 19 ints: bn, ni, th, tw,
// hr, hp, nch, halo_floats, tiles_n, tiles_h, tiles_w, tiles_c, slices, cs,
// per_rank, stage_bytes, smem, fw, blocks (grid size).  Returns 0, or
// cudaErrorInvalidValue where the kernel does not apply.
int dl4j_conv2d_plan(int N, int Cin, int KH, int KW, int Cout, int OH, int OW,
                     int sms, int* out) {
  if (!supported(N, Cin, KH, KW, Cout, OH, OW))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  plan(N, Cin, KH, KW, Cout, OH, OW, sms, &p);
  const int v[19] = {p.bn, p.ni, p.th, p.tw, p.hr, p.hp, p.nch,
                     p.halo_floats, p.tiles_n, p.tiles_h, p.tiles_w,
                     p.tiles_c, p.slices, p.cs, p.per_rank, p.stage_bytes,
                     p.smem, p.fw,
                     p.tiles_n * p.tiles_h * p.tiles_w * p.tiles_c * p.cs};
  for (int i = 0; i < 19; ++i) out[i] = v[i];
  return 0;
}

// y[N, Cout, OH, OW] = act(conv(x[N, Cin, H, W] padded by (pt top, pl left,
// and whatever OH/OW imply at the bottom/right), w[Cout, Cin, KH, KW]) + b).
// `ws` is scratch for the split weights: 2 * roundup(Cout, 64) *
// roundup(Cin * KH * KW, 64) floats, 16-byte aligned.  All tensors contiguous
// f32 on the device.  Launches the split pass and the conv (the halo route,
// or the full-width route where OW == 1 and the halo route does not apply)
// on `stream` and returns cudaGetLastError() (0 on success).
int dl4j_conv2d_bias_act_f32(const float* x, const float* w, const float* b,
                             float* y, float* ws, int N, int Cin, int H, int W,
                             int Cout, int KH, int KW, int pt, int pl, int OH,
                             int OW, int act, void* stream) {
  if (!supported(N, Cin, KH, KW, Cout, OH, OW))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  plan(N, Cin, KH, KW, Cout, OH, OW, device_sms(), &p);
  if (reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = Cin * KH * KW;
  const int rows = cdiv(Cout, kWRowPad) * kWRowPad;
  // full width: 16-byte copies of A where every run of four K indices is
  // four floats of one input row, 16-byte aligned
  const int vec = W % 4 == 0 && pl % 4 == 0 && KW % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  Shape s = {N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW, act,
             p.slices * kBK, static_cast<long long>(rows) * p.slices * kBK,
             vec};
  const long long total = s.lo_off;
  split_tf32_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      st>>>(w, ws, Cout, K, s.kpad, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.fw)
    err = p.bn == 32 ? launch<32, true>(x, ws, b, y, s, p, st)
                     : launch<64, true>(x, ws, b, y, s, p, st);
  else
    err = p.bn == 32 ? launch<32, false>(x, ws, b, y, s, p, st)
                     : launch<64, false>(x, ws, b, y, s, p, st);
  return static_cast<int>(err);
}

// The bf16 form: x, w, b and y bf16 (as their bits), the same shapes and
// padding as dl4j_conv2d_bias_act_f32, f32 accumulation, y rounded once to
// the nearest bf16.  `ws` is scratch for the reordered weights:
// roundup(Cout, 64) * roundup(Cin * KH * KW, 64) bf16, 16-byte aligned.
// Launches the reorder pass and the conv on `stream` and returns
// cudaGetLastError() (0 on success).
int dl4j_conv2d_bias_act_bf16(const uint16_t* x, const uint16_t* w,
                              const uint16_t* b, uint16_t* y, uint16_t* ws,
                              int N, int Cin, int H, int W, int Cout, int KH,
                              int KW, int pt, int pl, int OH, int OW, int act,
                              void* stream) {
  if (!supported(N, Cin, KH, KW, Cout, OH, OW))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  plan(N, Cin, KH, KW, Cout, OH, OW, device_sms(), &p);
  if (reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = Cin * KH * KW;
  const int rows = cdiv(Cout, kWRowPad) * kWRowPad;
  // full width: 8-byte copies of A where every run of four K indices is
  // four bf16 of one input row, 8-byte aligned
  const int vec = W % 4 == 0 && pl % 4 == 0 && KW % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 8 == 0;
  Shape s = {N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW, act,
             p.slices * kBK, static_cast<long long>(rows) * p.slices * kBK,
             vec};
  const long long total = s.lo_off;     // the reordered weights' elements
  reorder_bf16_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        st>>>(w, ws, Cout, K, s.kpad, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.fw)
    err = p.bn == 32 ? launch_bf16<32, true>(x, ws, b, y, s, p, st)
                     : launch_bf16<64, true>(x, ws, b, y, s, p, st);
  else
    err = p.bn == 32 ? launch_bf16<32, false>(x, ws, b, y, s, p, st)
                     : launch_bf16<64, false>(x, ws, b, y, s, p, st);
  return static_cast<int>(err);
}

}  // extern "C"
