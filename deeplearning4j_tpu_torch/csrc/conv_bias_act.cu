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
// bf16.  A bf16 product is exact in f32, so one wgmma...f32.bf16.bf16 a
// 16-deep K step replaces the three tf32 products; what bounds it is the
// operations at the 989 TFLOP/s bf16 peak, or, for most 1x1 convs, the bytes
// at 3.35 TB/s.  Its sum is the f32 form's on every route: K in slices of
// 64 whole input channels (a 3x3 slice is 7 channels' 63 taps and a zero),
// each slice's products into a fresh accumulator that the CUDA cores add to
// the f32 sum in slice order.  That order is kept because it is the one the
// bf16 rules were set from (tools/bf16_rule_probe.py emulates it, and
// chip_smoke.reordered_conv): a tap-major order read 4.0e-3 against a rule
// of 3.5e-3 at the calibrated ResNet-50's third step on the CPU.  Three
// routes, chosen by shape:
//  * The GEMM route (conv_gemm_bf16_kernel), a 1x1 conv with no padding:
//    image by image a plain GEMM, M = Cout, N = pixels, K = Cin, with no
//    halo and no tables.  A is the reordered weights (K-major, 128-byte
//    swizzle); B is x's [64 channels][pixels] tile as it lies in NCHW,
//    MN-major, which wgmma takes for 16-bit types through the transpose bit
//    (WgmmaBf16SSTransB).  Both come by cp.async into a ring of four stages,
//    B in 16-byte copies where a channel row is a multiple of 8 pixels
//    (56 x 56, 28 x 28), 8-byte where of 4 (14 x 14), and from a pre-pass
//    image [Cin][N*H*W rounded up to 8] otherwise (7 x 7).  A block is 128
//    Cout x 64 pixels (64 x 128 where Cout <= 64), each warpgroup an m64n64
//    product, two blocks an SM; tiles run across images.  The slices go in
//    pairs, one partial accumulator each, so a slice's products run while
//    the slice before is added.  What bounds it: the bytes of x and y for
//    Cin or Cout of 64-256, the products beyond.
//  * The halo route (conv_wgmma_bf16_kernel<BN, false>), every other shape
//    the halo route takes: the f32 form's tiling (128 pixels by BN = 32 or
//    64 Cout, the cluster split), with bf16 stages in a ring of three
//    (plan_bf16).  Where a plane's rows are whole runs of 8, 4 or 2
//    elements (224, 112, 56, 28 and 14 wide) each halo row is staged by
//    16-, 8- or 4-byte cp.async copies from the aligned run at or before
//    its first column, through a per-tile table of the copies' offsets;
//    elsewhere (7 x 7) by 2-byte loads, eight in flight a thread.  The
//    next slice's loads issue before the products.  A thread gathers its A
//    fragments, two bf16 a register, from the halo through the K
//    offsets.  What bounds it on an H100 is the slice's chain, not
//    the products: the staging issue, the gather and the products take
//    turns (tools/conv_probe.py --stamps).
//  * The full-width route (FW = true): the f32 form's, its A tile by 8-byte
//    cp.async copies of four bf16 where the f32 form takes 16 bytes.
// On every route the products, waits and accumulator reads are
// unconditional (a warpgroup with no live row multiplies what its stage
// holds, and its stores are masked): a wgmma wait in a branch made ptxas
// serialise every wgmma (C7518).  The epilogues stage the sums, plus bias,
// through shared memory and apply the activation in a loop over stores
// along pixels; inlined for each of a thread's sums in registers, the
// activation's switch made an epilogue outlast the slice loop.

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

// Phase stamps, for measurement only: a build with DL4J_CONV_STAMPS defined
// (tools/conv_probe.py --stamps writes such a copy of this file) has thread 0
// of each of the first kStampBlocks blocks record clock64() at named points
// of its first kStampSlices slices (slot = slice, phase 0-7), and at the
// tile's entry, loop start, loop end and exit (slot kStampSlices, phases 0-3;
// %globaltimer at entry and exit in phases 4 and 5, so that cycles convert
// to time); dl4j_conv_stamps copies them out.  Without it, CONV_STAMP is
// nothing.
#ifdef DL4J_CONV_STAMPS
constexpr int kStampBlocks = 8, kStampSlices = 32, kStampPhases = 8;
__device__ long long g_conv_stamps[kStampBlocks][kStampSlices + 1]
                                  [kStampPhases];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CONV_STAMP(slot, phase)                                             \
  do {                                                                      \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks &&                    \
        (slot) < kStampSlices)                                              \
      g_conv_stamps[blockIdx.x][slot][phase] = clock64();                   \
  } while (0)
#define CONV_STAMP_TILE(phase)                                              \
  do {                                                                      \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks)                      \
      g_conv_stamps[blockIdx.x][kStampSlices][phase] =                      \
          (phase) >= 4 ? global_ns() : clock64();                           \
  } while (0)
#else
#define CONV_STAMP(slot, phase) do {} while (0)
#define CONV_STAMP_TILE(phase) do {} while (0)
#endif

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
  // the bf16 halo route's own staging (plan_bf16; the f32 form and the
  // full-width route leave it at hpa = hp, al = 0)
  int hpa;                // the staged halo's row pitch
  int al;                 // elements a copy of a halo row: 8, 4 or 2 (16-,
                          // 8- or 4-byte cp.async), 0: 2-byte loads
  int halo_b;             // bytes of a stage's bf16 halo
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
// the bf16 halo route's largest plan: its ring at the largest halo, then
// the 2-byte loads' table
static_assert(3 * ((64 * 64 * 2 + 2 * 6144 * 2 + 64 * 4 + 1023) / 1024 *
                   1024) + 6144 * 4 + 1024 <= kSmemMax,
              "the bf16 halo plan asks for more shared memory than a block "
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
  p->hpa = p->hp;
  p->al = 0;
  p->halo_b = p->halo_floats * 4;
}

constexpr int kBf16Stages = 3;   // the bf16 halo route's ring

// The bf16 halo route's staging, on the f32 plan's tiling (tiles, halo, K
// slices, cluster split): a stage of bf16 sizes (the weights' [BN][64]
// tile, the halo, the 64 K offsets) in a ring of kBf16Stages.  Where a
// plane's rows are whole runs of `al` = 8, 4 or 2 elements (W a multiple
// of al, x aligned to 2 al bytes: the 224, 112, 56, 28 and 14 planes) and
// a tile holds one image, each halo row is staged by 16-, 8- or 4-byte
// cp.async copies from the al-element boundary at or before its first
// column: a row pitch of hpa = roundup(hp + al - 1, 8), the tile's first
// column `(ow0 - pl) mod al` elements in, zeros by the copies' zero-fill
// where a run lies outside the image.  Elsewhere (an odd W, as 7 x 7;
// several images a tile) 2-byte loads, eight in flight a thread.
void plan_bf16(Plan* p, int W, uintptr_t x) {
  int al = W % 8 == 0 && x % 16 == 0 ? 8
           : W % 4 == 0 && x % 8 == 0 ? 4
           : W % 2 == 0 && x % 4 == 0 ? 2 : 0;
  const int hpa = cdiv(p->hp + al - 1, 8) * 8;
  if (p->ni != 1 || p->nch * p->hr * hpa > 2 * kHaloMaxFloats) al = 0;
  p->al = al;
  p->hpa = al ? hpa : p->hp;
  p->halo_b = cdiv(p->nch * p->ni * p->hr * p->hpa * 2, 16) * 16;
  p->stage_bytes = cdiv(p->bn * kBK * 2 + p->halo_b + kBK * 4, 1024) * 1024;
  // the ring, and after it (or over it, once it is drained) the parked
  // sums of a cluster split or the epilogue's f32 tile, then the table of
  // the loads' or copies' source offsets
  const int ring = kBf16Stages * p->stage_bytes;
  const int part = p->bn / 2 * kThreads * 4;
  const int tile = p->bn * (kBM + 4) * 4;
  p->table_off = ring > part ? ring : part;
  if (tile > p->table_off) p->table_off = tile;
  p->smem = p->table_off +
            (p->al ? p->hr * (p->hpa / p->al) : p->ni * p->hr * p->hp) * 4 +
            1024;
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

// The bf16 halo route's epilogue for one tile (cluster size 1): the sums
// plus bias through shared memory (`tile`, [BN][kBM + 4] f32, in bytes the
// block's ring no longer needs), then the activation, one rounding and out
// with each warp on 32 consecutive pixels (or pixel pairs, 4-byte stores)
// of one channel, which NCHW keeps contiguous along a tile's rows.  The activation runs in that loop, not
// in the unrolled stores of the accumulators: inlined for each of a
// thread's BN / 2 sums, its switch made an epilogue take 7-13 us a tile
// on an H100 (tools/conv_probe.py --stamps).
template <int BN>
__device__ __forceinline__ void halo_epilogue_bf16(
    const float (&acc)[BN / 2], float* tile, const uint16_t* __restrict__ b,
    uint16_t* __restrict__ y, const Shape& s, const Plan& p, int co0, int n0,
    int oh0, int ow0) {
  constexpr int kPitch = kBM + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  __syncthreads();                      // every warpgroup's products are done
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int c = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    tile[c * kPitch + r0 + 8 * ((i >> 1) & 1)] =
        acc[i] + bf16_bits_to_float(b[imin(co0 + c, s.Cout - 1)]);
  }
  __syncthreads();
  // this thread's pixel of the tile, or pixel pair (r, r + 1) where the
  // tile's rows and the output's are even (the pair then lies in one row
  // and on a 4-byte boundary): the same for all its channels
  const int pix = p.th * p.tw;
  const bool pairs = p.tw % 2 == 0 && s.OW % 2 == 0;
  const int r = pairs ? 2 * (tid % (kBM / 2)) : tid % kBM;
  const int rn = r / pix, rem = r % pix;
  const int rh = rem / p.tw, rw = rem % p.tw;
  if (r < p.ni * pix && n0 + rn < s.N && oh0 + rh < s.OH &&
      ow0 + rw < s.OW) {
    const long long plane_out = static_cast<long long>(s.OH) * s.OW;
    uint16_t* to = y + (static_cast<long long>(n0 + rn) * s.Cout * s.OH +
                        oh0 + rh) * s.OW + ow0 + rw;
    if (pairs) {
#pragma unroll 4
      for (int c = tid / (kBM / 2); c < BN && co0 + c < s.Cout;
           c += kThreads / (kBM / 2)) {
        const float2 v =
            *reinterpret_cast<const float2*>(tile + c * kPitch + r);
        *reinterpret_cast<uint32_t*>(to + (co0 + c) * plane_out) =
            static_cast<uint32_t>(float_to_bf16_bits(activate(v.x, s.act))) |
            (static_cast<uint32_t>(float_to_bf16_bits(activate(v.y, s.act)))
             << 16);
      }
    } else {
#pragma unroll 4
      for (int c = tid / kBM; c < BN && co0 + c < s.Cout;
           c += kThreads / kBM)
        to[(co0 + c) * plane_out] =
            float_to_bf16_bits(activate(tile[c * kPitch + r], s.act));
    }
  }
}

// The bf16 form of conv_wgmma_kernel, the halo and full-width routes: the
// f32 form's plan, tables, cluster split and K order; bf16 x, w, b and y (as
// their bits); one bf16 product a 16-deep K step.  A stage holds the
// weights' [BN][64] bf16 tile at its start (one 128-byte swizzled row a
// channel), then the halo (the A tile) and the K offsets: at the f32 form's
// offsets and ring of two on the full-width route, at bf16 sizes and a ring
// of three on the halo route (plan_bf16).
template <int BN, bool FW>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgmma_bf16_kernel(const uint16_t* __restrict__ x,
                       const uint16_t* __restrict__ ws,
                       const uint16_t* __restrict__ b,
                       uint16_t* __restrict__ y, Shape s, Plan p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tap_off[kMaxK * kMaxK];
  CONV_STAMP_TILE(0);
  CONV_STAMP_TILE(4);
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

  constexpr int ST = FW ? kStages : kBf16Stages;   // ring stages
  const int taps = s.KH * s.KW;
  const int plane = p.ni * p.hr * p.hpa;
  // aligned staging: the al-element boundary at or before the tile's first
  // input column, and how far that column lies past it
  const int a0 = (ow0 - s.pl) & ~(p.al - 1);
  const int sh = p.al ? ow0 - s.pl - a0 : 0;
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
  } else if (p.al) {
    // each copy of a channel's halo rows (row e / cpr, run e % cpr): its
    // offset in x from the channel's start, -1 outside the image
    const int cpr = p.hpa / p.al;
    for (int e = tid; e < p.hr * cpr; e += kThreads) {
      const int ih = oh0 - s.pt + e / cpr, col = a0 + p.al * (e % cpr);
      src_off[e] = ih >= 0 && ih < s.H && col >= 0 && col < s.W
                       ? ih * s.W + col : -1;
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
  }
  if constexpr (!FW) {
    for (int i = tid; i < taps; i += kThreads)
      tap_off[i] = (i / s.KW) * p.hpa + i % s.KW;
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
      rbase[h] = live[h] ? (rn * p.hr + rh) * p.hpa + rw + sh : 0;
      yoff[h] = live[h] ? (static_cast<long long>(n0 + rn) * s.Cout * s.OH +
                           oh0 + rh) * s.OW + ow0 + rw
                        : 0;
    }
  }
  const bool wg_live = wg * 64 < live_rows;     // warpgroup-uniform

  const int s_begin = rank * p.per_rank;
  const int s_end = imin(p.slices, s_begin + p.per_rank);
  const int ns = s_end > s_begin ? s_end - s_begin : 0;
  // the weights' tile and the halo (A tile), in bytes: the f32 form's
  // sizes on the full-width route, bf16 sizes on the halo route
  const int w_bytes = FW ? 2 * BN * kBK * 4 : BN * kBK * 2;
  const int halo_bytes = p.halo_b;
  // this thread's staging units f = tid + kThreads j of [channel][unit]
  // (unit: a halo element, or a copy of al elements on the aligned path):
  // the first one's channel and unit, walked without a division
  const int unit = p.al ? p.hr * (p.hpa / p.al) : plane;
  const int c_first = tid / unit, e_first = tid % unit;
  const int c_step = kThreads / unit, e_step = kThreads % unit;
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
    } else if (p.al) {
      // the halo of the channels this slice touches by copies of al
      // elements, [channel][row][hpa]: runs from a0, zero outside the image
      int c = c_first, e = e_first;
      for (int f = tid; f < p.nch * unit; f += kThreads) {
        const int g = src_off[e];
        const bool ok = g >= 0 && c_lo + c < s.Cin;
        const uint16_t* src = ok ? xn + (c_lo + c) * chw + g : x;
        const uint32_t dst = sa + w_bytes + f * p.al * 2;
        if (p.al == 8)
          cp_async16_zfill(dst, src, ok ? 16 : 0);
        else if (p.al == 4)
          cp_async8_zfill(dst, src, ok ? 8 : 0);
        else
          cp_async4(dst, src, ok ? 4 : 0);
        c += c_step;
        e += e_step;
        if (e >= unit) {
          e -= unit;
          ++c;
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
          if (e >= unit) {
            e -= unit;
            ++c;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (f0 + j * kThreads < total) halo[f0 + j * kThreads] = v[j];
      }
    }
    if constexpr (!FW) {
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
  for (int i = 0; i < ST - 1; ++i) {
    if (i < ns) load(s_begin + i, i);
    cp_async_commit();
  }
  CONV_STAMP_TILE(1);
  for (int i = 0; i < ns; ++i) {
    CONV_STAMP(i, 0);
    cp_async_wait<ST - 2>();            // this thread's copies of slice i
    fence_proxy_async();
    __syncthreads();                    // everyone's; stage i-1 is free
    CONV_STAMP(i, 1);
    // the copies and loads of slice i + ST - 1 first, into the stage of
    // slice i - 1, which every warpgroup finished before the barrier (issued
    // after the products, they made ptxas spill, and the slice took 10-13 %
    // longer on an H100)
    {
      const int nx = i + ST - 1;
      if (nx < ns) load(s_begin + nx, nx % ST);
      cp_async_commit();
    }
    CONV_STAMP(i, 2);
    {
      const int st = i % ST;
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
      CONV_STAMP(i, 3);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)    // 16 K are 32 bytes, >> 4
        WgmmaBf16<BN>::mma(part, a[kk], sw128_desc(sa) + 2 * kk, kk > 0);
      wgmma_commit();
      CONV_STAMP(i, 4);
    }
    {
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        fence_operand(part[j]);
        acc[j] += part[j];
      }
    }
    CONV_STAMP(i, 5);
  }
  cp_async_wait<0>();
  CONV_STAMP_TILE(2);

  const long long plane_out = static_cast<long long>(s.OH) * s.OW;
  if constexpr (!FW) {
    if (p.cs == 1) {
      halo_epilogue_bf16<BN>(acc, reinterpret_cast<float*>(smem), b, y, s,
                             p, co0, n0, oh0, ow0);
      CONV_STAMP_TILE(3);
      CONV_STAMP_TILE(5);
      return;
    }
  }
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
    CONV_STAMP_TILE(3);
    CONV_STAMP_TILE(5);
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

// ---------------------------------------------------------------------------
// The bf16 form's GEMM route: 1x1 convs with no padding
// ---------------------------------------------------------------------------

constexpr int kGemmStages = 4;          // the GEMM route's ring of copies
constexpr int kGemmPix = 64;            // pixels of a warpgroup's product:
                                        // 64 lets two blocks share an SM (on
                                        // an H100, ResNet-50's 30 1x1 convs
                                        // took 13 % less than at 128, one
                                        // block an SM)
constexpr int kGemmAtom = 8 * 1024;     // B: 64 channel rows of 64 pixels

// Where the GEMM route applies: a 1x1 conv with no padding (OH = H, OW =
// W), among the shapes the halo route takes.  Every other shape keeps its
// route.
bool gemm_route(int N, int Cin, int H, int W, int Cout, int KH, int KW,
                int pt, int pl, int OH, int OW) {
  return KH == 1 && KW == 1 && pt == 0 && pl == 0 && OH == H && OW == W &&
         halo_supported(N, Cin, KH, KW, Cout, OH, OW);
}

struct Gemm {
  int wide;               // 1: Cout <= 64, a block is 64 Cout x 2 kGemmPix
                          // pixels (the warpgroups split the pixels); 0:
                          // 128 Cout x kGemmPix pixels (they split Cout)
  int vec;                // pixels of one copy of B: 8 (16 bytes) or 4
  int image;              // 1: B is read from the pre-pass image
  int hw;                 // pixels of an image of y
  int src_hw;             // pixels of a channel row of B's source: H*W, or
                          // the image's row, N*H*W rounded up to 8
  long long src_img;      // elements between images in the source (0 for
                          // the pre-pass image, which is one image)
  int P;                  // pixels N*H*W
  int Cin, Cout, act, kpad;
  int tiles_p, tiles_c;   // pixel and Cout tiles
  int slices, cs, per_rank;
  int stage_bytes, smem;
};

// The GEMM route's plan.  B's copies are 16 bytes where a channel row of x
// is a multiple of 8 pixels and x is 16-byte aligned (56 x 56, 28 x 28), 8
// bytes where it is a multiple of 4 and 8-byte aligned (14 x 14); any other
// plane (7 x 7) is first copied by a pre-pass into an image [Cin][N*H*W
// rounded up to 8], one row per channel across all images, and B is read
// from that in 16-byte copies.
void gemm_plan(int N, int Cin, int H, int W, int Cout, int act,
               uintptr_t x, int sms, Gemm* g) {
  const int hw = H * W;
  g->wide = Cout <= 64;
  g->vec = (hw % 8 == 0 && x % 16 == 0) ? 8
           : (hw % 4 == 0 && x % 8 == 0) ? 4 : 0;
  g->image = g->vec == 0;
  g->hw = hw;
  g->P = N * hw;
  if (g->image) {
    g->vec = 8;
    g->src_hw = (g->P + 7) / 8 * 8;
    g->src_img = 0;
  } else {
    g->src_hw = hw;
    g->src_img = static_cast<long long>(Cin) * hw;
  }
  g->Cin = Cin;
  g->Cout = Cout;
  g->act = act;
  g->slices = cdiv(Cin, kBK);
  g->kpad = g->slices * kBK;
  const int bp = g->wide ? 2 * kGemmPix : kGemmPix;     // block's pixels
  const int bc = g->wide ? 64 : 128;
  g->tiles_p = cdiv(g->P, bp);
  g->tiles_c = cdiv(Cout, bc);
  const long long blocks = static_cast<long long>(g->tiles_p) * g->tiles_c;
  g->cs = 1;
  while (g->cs < kMaxCluster && g->slices >= 2 * g->cs &&
         blocks * g->cs < 2LL * sms)
    g->cs *= 2;
  g->per_rank = cdiv(g->slices, g->cs);
  g->stage_bytes = bc * kBK * 2 + kBK * bp * 2;       // A, then B
  g->smem = kGemmStages * g->stage_bytes + 1024;
}

// The ring's stages, the parked sums of a cluster split and the 1 KB
// alignment fit a block, in both tilings.
static_assert(kGemmStages * (128 * kBK * 2 + kBK * kGemmPix * 2) + 1024 <=
                  kSmemMax, "the GEMM route's ring exceeds shared memory");
static_assert(kGemmStages * (64 * kBK * 2 + kBK * 2 * kGemmPix * 2) + 1024 <=
                  kSmemMax, "the GEMM route's wide ring exceeds shared memory");
static_assert(2 * (kGemmStages * (128 * kBK * 2 + kBK * kGemmPix * 2) +
                   1024) <= 228 * 1024,
              "two blocks of the GEMM route do not fit an SM");
static_assert(kGemmPix / 2 * kThreads * 4 <=
                  kGemmStages * (128 * kBK * 2 + kBK * kGemmPix * 2),
              "the parked sums exceed the GEMM route's ring");
static_assert(128 * (kGemmPix + 8) * 4 <=
                      kGemmStages * (128 * kBK * 2 + kBK * kGemmPix * 2) &&
                  64 * (2 * kGemmPix + 8) * 4 <=
                      kGemmStages * (64 * kBK * 2 + kBK * 2 * kGemmPix * 2),
              "the output tile exceeds the GEMM route's ring");

// img [Cin][src_hw] <- x [N][Cin][hw], zero past the last pixel.
__global__ void image_bf16_kernel(const uint16_t* __restrict__ x,
                                  uint16_t* __restrict__ img, int hw,
                                  int Cin, int P, int src_hw,
                                  long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i / src_hw);
  const int p = static_cast<int>(i % src_hw);
  img[i] = p < P ? x[(static_cast<long long>(p / hw) * Cin + c) * hw +
                     p % hw]
                 : static_cast<uint16_t>(0);
}

// y[n, co, p] = act(sum_c ws[co, c] x[n, c, p] + b[co]) for a 1x1 conv:
// M = Cout, N = pixels across images, K = Cin in the halo route's 64-deep
// slices, each into a fresh accumulator that the CUDA cores add to the sum
// in slice order.  A block of two warpgroups, each an m64nWN product a k16
// step (WIDE: both on the block's 64 Cout, each its own WN pixels; else
// each its own 64 Cout on the block's WN pixels).  A stage holds A,
// the weights' [Cout][64] tile (K-major, 128-byte swizzle), then B, the
// source's [64 channels][pixels] tile as it lies in x (MN-major: 1 KB atoms
// of 8 channels by 64 pixels, 128-byte swizzle; the pixel atoms kGemmAtom
// apart).  Both come by cp.async, kGemmStages deep: the copies of the next
// two slices are issued as each pair of slices begins.  The slice loop
// runs in pairs, one partial accumulator each, so that the second slice's
// products run while the first's partial is added (wgmma_wait<1>); every
// product, wait and accumulator access is unconditional (a warpgroup past
// the last Cout or pixel multiplies zeros, and its stores are masked), so
// ptxas does not serialise the wgmmas.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_bf16_kernel(const uint16_t* __restrict__ src,
                      const uint16_t* __restrict__ ws,
                      const uint16_t* __restrict__ b,
                      uint16_t* __restrict__ y, Gemm g) {
  constexpr int WN = kGemmPix;                     // a warpgroup's pixels
  constexpr int kBC = WIDE ? 64 : 128;             // Cout of a block
  constexpr int kBP = WIDE ? 2 * WN : WN;         // its pixels
  constexpr int kABytes = kBC * kBK * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;    // the swizzle needs 1 KB
  uint8_t* smem = smem_raw + (base - raw);
  CONV_STAMP_TILE(0);
  CONV_STAMP_TILE(4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;

  int rank = 0;
  if (g.cs > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int t = blockIdx.x / g.cs;
  const int co0 = (t % g.tiles_c) * kBC;
  const int p0 = (t / g.tiles_c) * kBP;

  const int s_begin = rank * g.per_rank;
  const int s_end = imin(g.slices, s_begin + g.per_rank);
  const int ns = s_end > s_begin ? s_end - s_begin : 0;

  // B's copies: this thread's chunk of `vec` pixels (the same in every
  // slice) and every cstep-th channel from c0
  const int chunks = kBP / g.vec;                  // 8, 16 or 32
  const int j = tid % chunks;
  const int c0 = tid / chunks, cstep = kThreads / chunks;
  const int q = j * g.vec;                         // pixel in the tile
  const int pix = p0 + q;
  const bool pix_ok = pix < g.P;
  const long long poff =
      pix_ok ? static_cast<long long>(pix / g.src_hw) * g.src_img +
                   pix % g.src_hw
             : 0;
  const uint32_t b_dst = (q >> 6) * kGemmAtom + (((q & 63) >> 3) << 4) +
                         (q & 7) * 2;

  // the copies of slice `sl` (of this rank; zeros past its last) into
  // ring stage `st`
  auto load = [&](int sl, int st) {
    const uint32_t sa = base + st * g.stage_bytes;
    const bool live = sl < ns;
    const int k0 = (s_begin + sl) * kBK;
#pragma unroll
    for (int m = 0; m < kBC * (kBK / 8) / kThreads; ++m) {
      const int e = tid + m * kThreads;
      const int r = e >> 3, c = e & 7;
      const bool ok = live && co0 + r < g.Cout;
      cp_async16_zfill(sa + r * 128 + ((c ^ (r & 7)) << 4),
                       ok ? ws + static_cast<long long>(co0 + r) * g.kpad +
                                k0 + 8 * c
                          : ws,
                       ok ? 16 : 0);
    }
    const uint32_t bs = sa + kABytes + b_dst;
    for (int c = c0; c < kBK; c += cstep) {
      const bool ok = live && pix_ok && k0 + c < g.Cin;
      // channel row c: its 8-row group's atom row c % 8, chunk ^ (c % 8)
      const uint32_t dst = bs + (c >> 3) * 1024 + (c & 7) * 128;
      const uint32_t swz = dst ^ ((c & 7) << 4);
      const uint16_t* from =
          ok ? src + poff + static_cast<long long>(k0 + c) * g.src_hw : src;
      if (g.vec == 8)
        cp_async16_zfill(swz, from, ok ? 16 : 0);
      else
        cp_async8_zfill(swz, from, ok ? 8 : 0);
    }
  };

  float acc[WN / 2], part0[WN / 2], part1[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = part0[i] = part1[i] = 0.0f;

  // this warpgroup's A rows and B pixels in a stage
  const uint32_t a_off = WIDE ? 0 : wg * 64 * 128;
  const uint32_t b_off = kABytes + (WIDE ? wg * (WN / 64) * kGemmAtom : 0);

#pragma unroll
  for (int i = 0; i < kGemmStages - 2; ++i) {
    load(i, i);
    cp_async_commit();
  }
  CONV_STAMP_TILE(1);
  for (int i = 0; i < ns; i += 2) {
    // slice i: the pair before ended in wgmma_wait<0>, so after this
    // barrier the stages of slices i - 2 and i - 1 are free
    CONV_STAMP(i, 0);
    cp_async_wait<kGemmStages - 3>();
    fence_proxy_async();
    __syncthreads();
    CONV_STAMP(i, 1);
    load(i + kGemmStages - 2, (i + kGemmStages - 2) % kGemmStages);
    cp_async_commit();
    load(i + kGemmStages - 1, (i + kGemmStages - 1) % kGemmStages);
    cp_async_commit();
    CONV_STAMP(i, 2);
    {
      const uint32_t sa = base + (i % kGemmStages) * g.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaBf16SSTransB<WN>::mma(
            part0, sw128_desc(sa + a_off) + 2 * kk,
            sw128_mn_desc(sa + b_off + kk * 2048, kGemmAtom), kk > 0);
      wgmma_commit();
    }
    CONV_STAMP(i, 3);
    // slice i + 1 (zeros when i + 1 == ns)
    cp_async_wait<2>();
    fence_proxy_async();
    __syncthreads();
    CONV_STAMP(i, 4);
    {
      const uint32_t sa = base + ((i + 1) % kGemmStages) * g.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaBf16SSTransB<WN>::mma(
            part1, sw128_desc(sa + a_off) + 2 * kk,
            sw128_mn_desc(sa + b_off + kk * 2048, kGemmAtom), kk > 0);
      wgmma_commit();
    }
    wgmma_wait<1>();
#pragma unroll
    for (int r = 0; r < WN / 2; ++r) {
      fence_operand(part0[r]);
      acc[r] += part0[r];
    }
    CONV_STAMP(i, 5);
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < WN / 2; ++r) {
      fence_operand(part1[r]);
      acc[r] += part1[r];
    }
    CONV_STAMP(i, 6);
  }
  cp_async_wait<0>();
  CONV_STAMP_TILE(2);

  // accumulator element i: Cout row g + 8 ((i / 2) % 2), pixel column
  // 8 (i / 4) + 2 (lane % 4) + i % 2 of this warpgroup's 64 x WN
  const int row0 = co0 + (WIDE ? 0 : wg * 64) + (warp & 3) * 16 + (lane >> 2);
  const int col0 = p0 + (WIDE ? wg * WN : 0) + 2 * (lane & 3);
  const long long plane_out = g.hw;
  auto store = [&](int i, float v) {
    const int co = row0 + 8 * ((i >> 1) & 1);
    const int px = col0 + 8 * (i >> 2) + (i & 1);
    if (co < g.Cout && px < g.P)
      y[(static_cast<long long>(px / g.hw) * g.Cout + co) * plane_out +
        px % g.hw] = float_to_bf16_bits(
          activate(v + bf16_bits_to_float(b[co]), g.act));
  };
  if (g.cs == 1) {
    // the sums plus bias through shared memory ([kBC][kBP + 8] f32:
    // conflict-free pair stores), then the activation, one rounding and
    // out along pixels, which NCHW keeps contiguous within an image: a
    // thread keeps one pixel pair (one pixel where H*W is odd) and walks
    // the channels, so a warp stores 128 (64) contiguous bytes.  The
    // activation runs there and not in the unrolled accumulator stores:
    // inlined for each of a thread's 64 sums, its switch made the
    // epilogue outlast the slice loop.
    constexpr int kPitch = kBP + 8;
    float* tile = reinterpret_cast<float*>(smem);
    __syncthreads();                    // every warpgroup's products are done
    const int trow = (WIDE ? 0 : wg * 64) + (warp & 3) * 16 + (lane >> 2);
    const int tcol = (WIDE ? wg * WN : 0) + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float bias =
          bf16_bits_to_float(b[imin(co0 + trow + 8 * h, g.Cout - 1)]);
#pragma unroll
      for (int i = 2 * h; i < WN / 2; i += 4)
        *reinterpret_cast<float2*>(tile + (trow + 8 * h) * kPitch + tcol +
                                   8 * (i >> 2)) =
            make_float2(acc[i] + bias, acc[i + 1] + bias);
    }
    __syncthreads();
    if (g.hw % 2 == 0) {
      constexpr int kPairs = kBP / 2;             // a row's pixel pairs
      const int q = 2 * (tid % kPairs), px = p0 + q;
      if (px < g.P) {
        uint16_t* to = y + static_cast<long long>(px / g.hw) * g.Cout *
                               plane_out + px % g.hw;
#pragma unroll 4
        for (int r = tid / kPairs; r < kBC; r += kThreads / kPairs) {
          if (co0 + r >= g.Cout) break;
          const float2 v =
              *reinterpret_cast<const float2*>(tile + r * kPitch + q);
          *reinterpret_cast<uint32_t*>(to + (co0 + r) * plane_out) =
              static_cast<uint32_t>(float_to_bf16_bits(activate(v.x, g.act))) |
              (static_cast<uint32_t>(float_to_bf16_bits(activate(v.y, g.act)))
               << 16);
        }
      }
    } else {
      const int q = tid % kBP, px = p0 + q;
      if (px < g.P) {
        uint16_t* to = y + static_cast<long long>(px / g.hw) * g.Cout *
                               plane_out + px % g.hw;
#pragma unroll 4
        for (int r = tid / kBP; r < kBC; r += kThreads / kBP) {
          if (co0 + r >= g.Cout) break;
          to[(co0 + r) * plane_out] =
              float_to_bf16_bits(activate(tile[r * kPitch + q], g.act));
        }
      }
    }
    CONV_STAMP_TILE(3);
    CONV_STAMP_TILE(5);
    return;
  }

  // cluster split: park the partial sums, reduce a share across the cluster
  cg::cluster_group cluster = cg::this_cluster();
  float* parked = reinterpret_cast<float*>(smem);   // [WN / 2][kThreads]
  __syncthreads();                                  // the ring is drained
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) parked[i * kThreads + tid] = acc[i];
  cluster.sync();
#pragma unroll 1
  for (int i = rank; i < WN / 2; i += g.cs) {
    float sum = 0.0f;
    for (int r = 0; r < g.cs; ++r)
      sum += cluster.map_shared_rank(parked, r)[i * kThreads + tid];
    store(i, sum);
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <bool WIDE>
cudaError_t launch_gemm_bf16(const uint16_t* src, const uint16_t* ws,
                             const uint16_t* b, uint16_t* y, const Gemm& g,
                             cudaStream_t stream) {
  static bool attr_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_gemm_bf16_kernel<WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      static_cast<long long>(g.tiles_p) * g.tiles_c * g.cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.cs > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_gemm_bf16_kernel<WIDE>,
                                       src, ws, b, y, g);
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

// The bf16 form's route for a shape (0 the halo route, 1 the full-width
// route, 2 the GEMM route, 3 the GEMM route from a pre-pass image; -1
// where the kernel does not apply), and in *scratch the bf16 elements of
// the scratch dl4j_conv2d_bias_act_bf16 needs for it when x lies at `x`:
// the reordered weights, then the image.
int dl4j_conv2d_bf16_route(int N, int Cin, int H, int W, int Cout, int KH,
                           int KW, int pt, int pl, int OH, int OW,
                           const void* x, long long* scratch) {
  if (!supported(N, Cin, KH, KW, Cout, OH, OW)) return -1;
  const long long weights =
      static_cast<long long>(cdiv(Cout, kWRowPad)) * kWRowPad *
      (cdiv(Cin * KH * KW, kBK) * kBK);
  *scratch = weights;
  if (!gemm_route(N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW))
    return halo_supported(N, Cin, KH, KW, Cout, OH, OW) ? 0 : 1;
  Gemm g;
  gemm_plan(N, Cin, H, W, Cout, 0, reinterpret_cast<uintptr_t>(x), 132, &g);
  if (!g.image) return 2;
  *scratch += static_cast<long long>(Cin) * g.src_hw;
  return 3;
}

// The bf16 form: x, w, b and y bf16 (as their bits), the same shapes and
// padding as dl4j_conv2d_bias_act_f32, f32 accumulation, y rounded once to
// the nearest bf16.  `ws` is scratch of the elements that
// dl4j_conv2d_bf16_route names, 16-byte aligned: the reordered weights,
// roundup(Cout, 64) * roundup(Cin * KH * KW, 64) bf16, then, on the GEMM
// route for a plane that 8- and 16-byte copies cannot read, the image.
// Launches the reorder pass (and the image pre-pass) and the conv on
// `stream` and returns cudaGetLastError() (0 on success).
int dl4j_conv2d_bias_act_bf16(const uint16_t* x, const uint16_t* w,
                              const uint16_t* b, uint16_t* y, uint16_t* ws,
                              int N, int Cin, int H, int W, int Cout, int KH,
                              int KW, int pt, int pl, int OH, int OW, int act,
                              void* stream) {
  if (!supported(N, Cin, KH, KW, Cout, OH, OW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = Cin * KH * KW;
  const int rows = cdiv(Cout, kWRowPad) * kWRowPad;
  if (gemm_route(N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW)) {
    Gemm g;
    gemm_plan(N, Cin, H, W, Cout, act, reinterpret_cast<uintptr_t>(x),
              device_sms(), &g);
    const long long total = static_cast<long long>(rows) * g.kpad;
    reorder_bf16_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          st>>>(w, ws, Cout, K, g.kpad, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint16_t* src = x;
    if (g.image) {
      uint16_t* img = ws + total;
      const long long n = static_cast<long long>(Cin) * g.src_hw;
      image_bf16_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          st>>>(x, img, g.hw, Cin, g.P, g.src_hw, n);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      src = img;
    }
    err = g.wide ? launch_gemm_bf16<true>(src, ws, b, y, g, st)
                 : launch_gemm_bf16<false>(src, ws, b, y, g, st);
    return static_cast<int>(err);
  }
  Plan p;
  plan(N, Cin, KH, KW, Cout, OH, OW, device_sms(), &p);
  if (!p.fw) plan_bf16(&p, W, reinterpret_cast<uintptr_t>(x));
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

#ifdef DL4J_CONV_STAMPS
// Copies the phase stamps (long long [kStampBlocks][kStampSlices + 1]
// [kStampPhases]) to host memory `out`, then zeroes them; returns the CUDA
// error (0 on success).
int dl4j_conv_stamps(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_conv_stamps,
                                         sizeof(g_conv_stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  static long long zeros[kStampBlocks][kStampSlices + 1][kStampPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_conv_stamps, zeros, sizeof(g_conv_stamps)));
}
#endif

}  // extern "C"
