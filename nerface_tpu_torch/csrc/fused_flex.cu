// The Flexible model family's fused MLP on Hopper (sm_90a): K4f, the
// forward, and K4b, its backward.
//
// Replaces K4 of the JAX package, the Pallas TPU kernels behind
// nerface_tpu/ops/pallas/fused_flex.py::fused_flex_mlp: `_fwd_kernel`
// (fused_flex.py:131, pallas_call at :247) and `_bwd_kernel` (:143,
// pallas_call at :287). Python side: nerface_tpu_torch/ops/kernels/
// fused_flex.py (wrappers, the weights' chunk images in one cached gather,
// the autograd.Function and the plain PyTorch versions).
//
// The function, per sample row: points ro + rd·z, [xyz; sin(x·f + φ); 0]
// (kx bf16 columns: 64 up to 10 bands, 128 for 11..20, `xin_extent`), a_0
// = that @ W1 + v0 with NO activation (`layer1`, a
// reference quirk; v0 is its bias with the per-frame conditioning folded
// in), a_{i+1} = relu(a_i @ WH_i + bh_i) for the n hidden layers (any n ≥
// 0, a runtime argument), then σ = a_n · wa + ba off the trunk
// (not off feat, unlike the paper model), feat = relu(a_n @ WF + bf), x0 =
// relu(feat @ WD0 + bd0 + the ray's direction contribution), rgb = x0 @
// wrgb + brgb. Out: raw (R, S, 4) [rgb, σ]; the compositing stays with the
// caller, as in the JAX package. The hidden width h is a multiple of 256
// up to MAX_WIDTH = 1024 (layers_dir.0 h / 2), a runtime argument: h = 256
// runs the kernels described next, h = 512 its own pair
// (`wide_chain_kernel`, `wide_dx_kernel`, below: the two consumer
// warpgroups share each unit, each computing half of every layer's
// columns), h = 768 and 1024 a third (`sliced_chain_kernel`,
// `sliced_dx_kernel`: the same sharing, each layer in slices of 256
// columns).
//
// K4f, `flex_chain_kernel<SF, false>`, is K2's chain without the cluster
// (wgmma_chain.cuh): one persistent 384-thread CTA an SM. The producer
// warpgroup's first thread streams each unit's xc + 4n + 4 + 4 weight chunk
// images through a ring of RING 32 KB stages with bulk copies, its three
// encoder warps fill each unit's swizzled [xyz; PE; 0] tile; the two
// consumer warpgroups run free of each other over whole rays as 64-row
// units. S is any of 1..MAX_SAMPLES (wgmma_chain.cuh, the paper kernels'
// limit too): an item is the paper kernels' `UnitLayout`, whole rays in
// 1..4 units, its rows past the last ray's sample padding the last unit (8
// rays in 3 units at S = 24, one ray in 3 at 192), and past ITEM_ROWS one
// ray in ⌈S / 64⌉ units (a long item: 5 at S = 257 or 320, 16 at 1024).
// Every row is computed and stored on its own, the ray's direction row
// read per row, so a long item is only more units of the same walk: the
// producer's xc + 4n + 4 + 4 chunks a unit, the encoders' 2·64·xc tasks a
// unit, and d_dir carried across the units by `dir_pieces` (dX, below).
// SF, the layout class, is 64 or 128 for the
// passes of the bundled configs (S folded in as a constant) and 0, S read
// at run time, for every other S and for every pass past 10 bands
// (`dispatch_pass`, mma_tile.cuh: two builds of the library, `build.py`'s
// `sample_class_defines`). Past 10 bands the encoded tile is two 64-column
// blocks (UnitLayout's xc = 2): a consumer warpgroup's two xin buffers are
// one buffer of both (`xin_buf` / `xin_phase`), which the encoders fill
// for the next unit once layer1 has read this one, and W1 is two chunks.
// The fixed classes keep one block, so a 10-band pass runs the code, the
// offsets and the classes it ran before. A padding
// row encodes to 0, is never stored and takes a zero cotangent. Each
// layer is one chain of wgmma m64n256k16 (m64n128k16 for
// layers_dir.0's feat columns) with A in registers: layer1 reads xin from
// shared memory (K = 3 + 6·bands packed to 64, or to 128), every epilogue
// rounds its accumulator pairs to bf16 exactly where the plain version does and they
// are the next product's A fragment. The σ head is an m64n8 wgmma off
// a_n's A registers before fc_feat overwrites them, the rgb head one off
// x0's; the raw rows go out as float4s. The bias rows before the hidden
// layers' (and the bands) sit in shared memory; each hidden layer's row is
// read from F by its epilogue, so the depth sizes no buffer.
//
// K4b is four kinds of launch on the caller's stream, no float atomics,
// every partition fixed by the shape, so two calls on the same inputs give
// bit-identical gradients:
//   1. the recompute, `flex_chain_kernel<SF, true>`: K4f's kernel with the
//      save flag (the serving instantiation has no save code), storing xin,
//      a_0..a_n, feat and x0 to the workspace as wgmma operand images (per
//      64-row unit, 64-column blocks in the 128-byte swizzle,
//      paper_train.cuh's `image_offset`, 16-byte stores after
//      `quad_transpose`) and the relu masks of a_1..a_n and feat as bits
//      in the accumulator fragment's order (`store_mask`), no heads;
//   2. `flex_dx_kernel<SF>`, persistent, two consumer warpgroups, the
//      transposed weights' chunk images through a ring: gx0 =
//      bf16(g_rgb)·Wrgbᵀ ⊙ [x0 > 0] per thread; g_feat = bf16(gx0)·WD0ᵀ ⊙
//      [feat > 0]; (bf16(g_feat)·WFᵀ + bf16(g_σ) ⊗ wa) ⊙ [a_n > 0]; WH_iᵀ
//      down to ga_0, unmasked (layer1 has no relu). Each product reads its
//      A, the bf16 cotangent the epilogue before wrote, from the
//      warpgroup's A tile in shared memory (wgmma_ss, 128 accumulators and
//      nothing else in registers); the tile goes out to the workspace as
//      the cotangent's operand image by one bulk store; each mask is one
//      16-byte load a thread, issued before the product. The f32 column
//      sums (bh_i, bf, bd0, d_v0) and the heads' sums (x0ᵀ·bf16(g_rgb),
//      a_nᵀ·bf16(g_σ), brgb, ba) go to each warp's running partial row
//      (K1's reduce-scatter, paper_train.cuh), folded per CTA in order;
//      d_dir = Σ gx0 over a ray's rows: each warp's piece of each ray
//      (paper_train.cuh's `DirPieces` where a warp's 16 rows reach two
//      rays), the pieces summed in row order across the ray's units
//      (`dir_pieces`), so S = 32 / 64 / 128 keep their sums' order;
//   3. `dw_wgmma_kernel` (wgmma_dw.cuh): dW = Xᵀ·bf16(gY) for W1 (K = kx),
//      WF, WD0 and every WH_i from the images (`dw_products`: gY by column
//      blocks of at most 256), in row segments that fill one wave and
//      hold at most DW_SEG_UNITS = 2048 units each (the count fixed by the
//      products and the pass's units, `dw_segments_of`: 12 at h = 256 and
//      3 at h = 512, n = 3, up to 24576 / 6144 units; at 2048 rays × S =
//      1024, 32768 units, 16 of 2048 at either width), at
//      most DWG_MATS_MAX products a launch (a deep pass launches it more
//      than once into the same segments);
//   4. two `reduce_rows`: dW's segments, and the CTAs' partial rows.
// Rounding as in the TPU kernel: every left matmul operand (the raw points
// included), the saved activations and their masks, both dW operands, the
// dX cotangent are bf16; bias sums, d_v0 and d_dir take the f32
// cotangents.
//
// Bounds on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s). At
// n = 3 the forward is 0.6234 MFLOP a sample at the function's widths
// (layer1's K = 63): a 65536-ray serving tile at S = 64 / 128 is 2.61 /
// 5.23 TFLOP, 2.64 / 5.29 ms at the peak, against a few MB of ray data.
// Past 10 bands layer1 reads 3 + 6·bands ≤ 123 columns (K = 128, of which
// the zero pad is not counted): at 16 bands 2·36·256 FLOP a sample more
// than at 10, +3 % of the forward at n = 3.
// K4b is 1.838 MFLOP a sample (recompute 0.623, dX 0.591, dW 0.623), 0.731
// ms for a train step's pair (2048 rays at S = 64 + 128). Its workspace,
// which the TPU kernel never moves, holds ≈ 5.9 KB a row at n = 3 (11.7 KB
// at h = 512: 11.5 / 22.8 GiB for 2048 rays at S = 1024, every offset in it
// a 64-bit product: `carve`, `unit_image`, `unit_mask`, `wide_mask`,
// `Workspace::act`, dW's `bulk_load`s), written
// once and read by dX and dW: for the pair's fine pass a byte floor of
// 0.24 / 0.29 / 0.43 ms (recompute / dX / dW) above the operations bound
// of 0.165 / 0.157 / 0.165. chip_smoke.py's `[flex_kernel]` prints each
// launch's device time beside both, apart.
//
// At h = 512 (`wide_chain_kernel` / `wide_dx_kernel`, below) every
// product reads its A from shared memory: 4.06 × the operations at n = 3.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the tiles 6.0 / 11.7
// ms as bare launches, 44 % of their operations bound (K2 reaches 60 %;
// the run-time layer loop is not the gap: a build with n fixed at compile
// time read about the same); K4b's pair 2.9-3.0 ms, dX at 18 % of its
// bound and the slowest launch, 0.5-0.65 KB of spills a thread in dX,
// none in K4f. Two designs that hold A in registers through dX (one pass
// of 256 columns, or two of 128 reading the same A registers) made ptxas
// serialise every wgmma of the kernel (C7511 / C7512).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "grad_tile.cuh"
#include "paper_train.cuh"
#include "wgmma_chain.cuh"
#include "wgmma_dw.cuh"

using namespace nerface;
using namespace nerface::sm90;

namespace {

constexpr int WIDE = 512;  // the second hidden width the kernels take
// K4's xyz encoding bands: 1..20, [xyz; PE; 0] in at most two 64-column
// blocks (K_XIN_WIDE); the paper kernels' MAX_FREQS reaches a third
constexpr int FLEX_MAX_FREQS = (K_XIN_WIDE - 3) / 6;

// Packed operand offsets at hidden width H, in elements. They must equal
// w_offsets / f_offsets / wt_offsets in ops/kernels/fused_flex.py (a CPU
// test checks it). bf16 weights, (in, out): W1 = [w1a; w1b; 0], WF, WD0,
// WH_i at FW_OFF_WH + i·H², each as its chunk images, then WA and WRGB
// row-major; the FW_OFF_* are those of W1 at K_XIN rows (up to 10 bands),
// `flex_w_off` moves them to K_XIN_WIDE. f32 rows: V0, BF, BD0, BA, BRGB,
// FREQS (FLEX_MAX_FREQS slots), then BH_i at FF_OFF_BH + i·H, at every band
// count. Transposed weights, (out, in), each as its chunk images (K = out,
// N = in): WD0T, WFT, WHT_i at FT_OFF_WHT + i·H².
template <int H>
struct Offsets;
template <>
struct Offsets<256> {
  static constexpr int FW_OFF_W1 = 0;
  static constexpr int FW_OFF_WF = 16384;
  static constexpr int FW_OFF_WD0 = 81920;
  static constexpr int FW_OFF_WH = 114688;
  static constexpr int FF_OFF_V0 = 0;
  static constexpr int FF_OFF_BF = 256;
  static constexpr int FF_OFF_BD0 = 512;
  static constexpr int FF_OFF_BA = 640;
  static constexpr int FF_OFF_BRGB = 641;
  static constexpr int FF_OFF_FREQS = 644;
  static constexpr int FF_OFF_BH = 664;
  static constexpr int FT_OFF_WD0T = 0;
  static constexpr int FT_OFF_WFT = 32768;
  static constexpr int FT_OFF_WHT = 98304;
};
template <>
struct Offsets<512> {
  static constexpr int FW_OFF_W1 = 0;
  static constexpr int FW_OFF_WF = 32768;
  static constexpr int FW_OFF_WD0 = 294912;
  static constexpr int FW_OFF_WH = 425984;
  static constexpr int FF_OFF_V0 = 0;
  static constexpr int FF_OFF_BF = 512;
  static constexpr int FF_OFF_BD0 = 1024;
  static constexpr int FF_OFF_BA = 1280;
  static constexpr int FF_OFF_BRGB = 1281;
  static constexpr int FF_OFF_FREQS = 1284;
  static constexpr int FF_OFF_BH = 1304;
  static constexpr int FT_OFF_WD0T = 0;
  static constexpr int FT_OFF_WFT = 131072;
  static constexpr int FT_OFF_WHT = 393216;
};
template <>
struct Offsets<768> {
  static constexpr int FW_OFF_W1 = 0;
  static constexpr int FW_OFF_WF = 49152;
  static constexpr int FW_OFF_WD0 = 638976;
  static constexpr int FW_OFF_WH = 933888;
  static constexpr int FF_OFF_V0 = 0;
  static constexpr int FF_OFF_BF = 768;
  static constexpr int FF_OFF_BD0 = 1536;
  static constexpr int FF_OFF_BA = 1920;
  static constexpr int FF_OFF_BRGB = 1921;
  static constexpr int FF_OFF_FREQS = 1924;
  static constexpr int FF_OFF_BH = 1944;
  static constexpr int FT_OFF_WD0T = 0;
  static constexpr int FT_OFF_WFT = 294912;
  static constexpr int FT_OFF_WHT = 884736;
};
template <>
struct Offsets<1024> {
  static constexpr int FW_OFF_W1 = 0;
  static constexpr int FW_OFF_WF = 65536;
  static constexpr int FW_OFF_WD0 = 1114112;
  static constexpr int FW_OFF_WH = 1638400;
  static constexpr int FF_OFF_V0 = 0;
  static constexpr int FF_OFF_BF = 1024;
  static constexpr int FF_OFF_BD0 = 2048;
  static constexpr int FF_OFF_BA = 2560;
  static constexpr int FF_OFF_BRGB = 2561;
  static constexpr int FF_OFF_FREQS = 2564;
  static constexpr int FF_OFF_BH = 2584;
  static constexpr int FT_OFF_WD0T = 0;
  static constexpr int FT_OFF_WFT = 524288;
  static constexpr int FT_OFF_WHT = 1572864;
};

template <int H>
constexpr bool offsets_ok() {
  using O = Offsets<H>;
  return O::FW_OFF_WF - O::FW_OFF_W1 == K_XIN * H && O::FW_OFF_WD0 - O::FW_OFF_WF == H * H &&
         O::FW_OFF_WH - O::FW_OFF_WD0 == H * (H / 2) && O::FF_OFF_BF == H && O::FF_OFF_BD0 - O::FF_OFF_BF == H &&
         O::FF_OFF_BA - O::FF_OFF_BD0 == H / 2 && O::FF_OFF_BRGB == O::FF_OFF_BA + 1 &&
         O::FF_OFF_FREQS - O::FF_OFF_BRGB == 3 && O::FF_OFF_BH - O::FF_OFF_FREQS == FLEX_MAX_FREQS &&
         O::FT_OFF_WFT - O::FT_OFF_WD0T == (H / 2) * H && O::FT_OFF_WHT - O::FT_OFF_WFT == H * H;
}
static_assert(offsets_ok<256>() && offsets_ok<512>() && offsets_ok<768>() && offsets_ok<1024>(), "operand layout");

// The offset FW_OFF_* `off` of Offsets<H> in the forward weights of
// encoding extent kx (`xin_extent`): W1 holds kx rows, kx − K_XIN more
// than at K_XIN, which move every later offset (mma_tile.cuh's `w_off`
// for the paper model's layout).
template <int H>
__host__ __device__ constexpr int flex_w_off(int off, int kx) {
  return off + (off > Offsets<H>::FW_OFF_W1 ? (kx - K_XIN) * H : 0);
}
static_assert(flex_w_off<HIDDEN>(Offsets<HIDDEN>::FW_OFF_WF, K_XIN_WIDE) == K_XIN_WIDE * HIDDEN &&
                  flex_w_off<512>(Offsets<512>::FW_OFF_WH, K_XIN) == Offsets<512>::FW_OFF_WH,
              "the wide weight layout");

using O = Offsets<HIDDEN>;  // the h = 256 kernels'

constexpr int HH = HIDDEN * HIDDEN;
constexpr int RING = 5;                          // weight stages
constexpr int CONSUMERS = CHAIN_CONSUMERS;       // warpgroups computing units
constexpr int ENCODERS = CHAIN_ENCODERS;         // warps of the producer warpgroup that encode
constexpr int FLEX_THREADS = 128 * (CONSUMERS + 1);
constexpr int WARPS_A_CTA = 4 * CONSUMERS;
constexpr int BAR_WG = 1;                        // + warpgroup: that warpgroup's named barrier
constexpr int BAR_CONSUMERS = 3;                 // both consumer warpgroups

// The offsets and sizes that depend on the width h, the number of hidden
// layers n (any n ≥ 0: nothing is sized by it at compile time) and the
// encoding's extent kx (K_XIN, or K_XIN_WIDE past 10 bands).
struct Layout {
  int h, dh, n;        // dh = h / 2, layers_dir.0's width
  int kx;              // W1's rows and the xin image's width
  int wf, wd0, wh;     // WF, WD0, WH_0
  int wa, wrgb;        // WA, WRGB after the WH_i
  int f_total;
  int part_cols;       // a partial row: the f32 rows, then WA and WRGB
  int mask_bytes;      // a unit's relu mask of an h-wide activation, as bits
};

template <int H>
__host__ __device__ inline Layout flex_layout(int n, int kx) {
  using OH = Offsets<H>;
  Layout L;
  L.h = H;
  L.dh = H / 2;
  L.n = n;
  L.kx = kx;
  L.wf = flex_w_off<H>(OH::FW_OFF_WF, kx);
  L.wd0 = flex_w_off<H>(OH::FW_OFF_WD0, kx);
  L.wh = flex_w_off<H>(OH::FW_OFF_WH, kx);
  L.wa = L.wh + n * H * H;
  L.wrgb = L.wa + H;
  L.f_total = OH::FF_OFF_BH + n * H;
  L.part_cols = L.f_total + H + (H / 2) * 3;
  L.mask_bytes = 128 * H / 64 * 4;
  return L;
}

// The backward's workspace. Each bf16 buffer holds one matrix of the pass
// as wgmma operand images: per 64-row unit, its 64-column blocks of 64
// rows in the 128-byte swizzle (k1::image_offset), `width` · 128 bytes a
// unit. A run of buffers of one kind (a_0..a_n, the WH_i outputs'
// cotangents, a_1..a_n's masks) lies back to back, `hbytes` / `mask_words`
// apart, so the depth sizes nothing. The order is the carve's, mirrored
// by `workspace_buffers` and `mask_buffers` in ops/kernels/fused_flex.py.
struct Workspace {
  unsigned char* xin;    // kx
  unsigned char* act0;   // a_0..a_n
  unsigned char* feat;
  unsigned char* x0;     // h / 2
  unsigned char* gx0;    // h / 2
  unsigned char* gfeat;
  unsigned char* gpre0;  // the cotangents of WH_i's outputs before the relu
  unsigned char* ga0;    // the cotangent of a_0
  // the relu masks dX applies, as bits in the fragment's order
  // (Layout::mask_bytes a unit): feat's, and a_1..a_n's at amask(i - 1)
  uint32_t* fmask;
  uint32_t* amask0;
  float* warp_part;      // (ctas · WARPS_A_CTA, part_cols): each warp's running sums
  float* tile_part;      // (ctas, part_cols): a CTA's sums
  float* dw_part;        // (dw segments, wa)
  size_t hbytes;         // an h-wide buffer: units · h · 128
  size_t mask_words;     // a mask buffer: units · mask_bytes / 4
  __host__ __device__ unsigned char* act(int i) const { return act0 + i * hbytes; }
  __host__ __device__ unsigned char* gpre(int i) const { return gpre0 + i * hbytes; }
  __host__ __device__ uint32_t* amask(int i) const { return amask0 + i * mask_words; }
};

__host__ __device__ __forceinline__ unsigned char* unit_image(unsigned char* buf, int width, int unit) {
  return buf + (size_t)unit * width * ROW_BYTES;
}

// A 256-wide activation's relu mask of one unit, as bits: the warpgroup's
// thread t holds the 128 elements of its accumulator fragment (pairs p,
// k1::frag_row / fold_col) and keeps them in words [4t, 4t + 4): bit
// 2·(p % 16) + e of word p / 16 is element e of pair p > 0. The recompute
// and dX hold the same elements in the same threads. At h = 512 each
// consumer warpgroup holds 256 of the columns (`wide_mask`).
constexpr int MASK_BYTES = 128 * HIDDEN / 64 * 4;  // 2 KB
constexpr int WIDE_MASK_BYTES = 128 * WIDE / 64 * 4;  // 4 KB

__device__ __forceinline__ uint32_t* unit_mask(uint32_t* buf, int unit) {
  return buf + (size_t)unit * (MASK_BYTES / 4) + 4 * (threadIdx.x & 127);
}

// h = 512: warpgroup wg's threads keep its columns' words after warpgroup
// 0's.
__device__ __forceinline__ uint32_t* wide_mask(uint32_t* buf, int unit, int wg) {
  return buf + (size_t)unit * (WIDE_MASK_BYTES / 4) + 4 * (wg * 128 + (threadIdx.x & 127));
}

// The bits of the bf16 pairs a[0, 64) (a relu'd activation: > 0 is a
// positive non-zero pattern, below 0x8000) into the thread's mask words.
__device__ __forceinline__ void store_mask(uint32_t* dst, const uint32_t* a) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int p = 0; p < HIDDEN / 4; ++p) {
    const uint32_t lo = a[p] & 0xffffu, hi = a[p] >> 16;
    const uint32_t b = (lo - 1u < 0x7fffu ? 1u : 0u) | (hi - 1u < 0x7fffu ? 2u : 0u);
    w[p / 16] |= b << (2 * (p % 16));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// dW's products of a pass, dW = Xᵀ·bf16(gY) from the workspace images: W1
// (its xin rows, K = kx), WF, WD0 and every WH_i, each by column blocks of
// at most 256 of its gY (two at h = 512, four at 1024; WD0's 384 at h =
// 768 as 256 + 128), in that order; fn(DwgMat).
template <class Fn>
void dw_products(const Workspace& ws, const Layout& L, Fn&& fn) {
  auto blocks = [&](const unsigned char* X, const unsigned char* G, int kdim, int ndim, int out_off) {
    const int nb = ndim > 256 ? 256 : ndim;
    for (int c = 0; c < ndim; c += nb)
      fn(DwgMat{X, G ? G + (size_t)c * ROW_BYTES : nullptr, kdim, ndim - c < nb ? ndim - c : nb, out_off + c, ndim,
                ndim});
  };
  blocks(ws.xin, ws.ga0, L.kx, L.h, 0);
  blocks(ws.act0 ? ws.act(L.n) : nullptr, ws.gfeat, L.h, L.h, L.wf);
  blocks(ws.feat, ws.gx0, L.h, L.dh, L.wd0);
  for (int i = 0; i < L.n; ++i)
    blocks(ws.act0 ? ws.act(i) : nullptr, ws.gpre0 ? ws.gpre(i) : nullptr, L.h, L.h, L.wh + i * L.h * L.h);
}

// dW's row segments of a pass of `units` units: one wave over its
// products' CTAs (`dw_tasks` a product), at least 1, and at least enough
// that no segment sums more than DW_SEG_UNITS units. A segment's f32
// accumulators drift from the exact sum about linearly in its rows (at h =
// 512, 3 segments of 10923 units at 2048 rays × S = 1024 read 1.4e-3 of a
// product's max off the f64 Xᵀ·gY on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md §6); the count is a
// function of the shape, so dW stays bit-identical over launches.
constexpr int DW_SEG_UNITS = 2048;
int dw_segments_of(const Layout& L, int units) {
  int tasks = 0;
  dw_products(Workspace{}, L, [&](const DwgMat& m) { tasks += dw_tasks(m.kdim); });
  const int wave = tasks >= DWG_WAVE ? 1 : DWG_WAVE / tasks;
  const int rows = (units + DW_SEG_UNITS - 1) / DW_SEG_UNITS;
  return wave > rows ? wave : rows;
}

// Lays the workspace out from `base` (or only measures it when base is
// null); returns its size in bytes.
size_t carve(unsigned char* base, int units, int ctas, const Layout& L, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  // `count` buffers of `bytes` each, back to back (each a multiple of 256)
  auto run = [&](size_t bytes, int count) -> void* {
    void* p = base ? base + off : nullptr;
    for (int i = 0; i < count; ++i) take(bytes);
    return p;
  };
  auto img = [&](int width) { return static_cast<unsigned char*>(take((size_t)units * width * ROW_BYTES)); };
  auto imgs = [&](int width, int count) {
    return static_cast<unsigned char*>(run((size_t)units * width * ROW_BYTES, count));
  };
  auto bits = [&](int count) { return static_cast<uint32_t*>(run((size_t)units * L.mask_bytes, count)); };
  Workspace w = {};
  w.hbytes = (size_t)units * L.h * ROW_BYTES;
  w.mask_words = (size_t)units * L.mask_bytes / 4;
  w.xin = img(L.kx);
  w.act0 = imgs(L.h, L.n + 1);
  w.feat = img(L.h);
  w.x0 = img(L.dh);
  w.gx0 = img(L.dh);
  w.gfeat = img(L.h);
  w.gpre0 = imgs(L.h, L.n);
  w.ga0 = img(L.h);
  w.fmask = bits(1);
  w.amask0 = bits(L.n);
  w.warp_part = static_cast<float*>(take((size_t)ctas * WARPS_A_CTA * L.part_cols * sizeof(float)));
  w.tile_part = static_cast<float*>(take((size_t)ctas * L.part_cols * sizeof(float)));
  w.dw_part = static_cast<float*>(take((size_t)dw_segments_of(L, units) * L.wa * sizeof(float)));
  if (ws) *ws = w;
  return off;
}

// -- K4f and the recompute ------------------------------------------------------

struct FwdArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // the forward weights' chunk images (Offsets<h>::FW_OFF_*)
  const float* F;      // bias rows + frequency bands (Offsets<h>::FF_OFF_*)
  float* out;          // (R, S, 4), or null in the recompute
  Workspace ws;        // the recompute's images, or all null
  int n_rays;
  UnitLayout l;  // the pass's S, and its items' rays and units (host-computed)
  int n_freqs, n_hidden;
};

struct alignas(ATOM_BYTES) FwdSmem {
  unsigned char ring[RING][CHAIN_STAGE];  // weight chunk images
  // a consumer warpgroup's encoded tiles: two of one block, or one of both
  // blocks past 10 bands (`xin_buf`)
  unsigned char xin[CONSUMERS][2][XIN_BYTES];
  unsigned char wa8[HIDDEN / KCH][8 * ROW_BYTES];  // the heads' weights padded to 8 columns
  unsigned char wrgb8[DIR_HIDDEN / KCH][8 * ROW_BYTES];
  float f[O::FF_OFF_BH];  // the rows before the hidden layers' (read from F, any depth)
  uint64_t full[RING];
  uint64_t empty[RING];
  uint64_t xin_full[CONSUMERS][2];
  uint64_t xin_empty[CONSUMERS][2];
};
constexpr size_t FWD_SMEM_BYTES = sizeof(FwdSmem) + ATOM_BYTES;  // + the alignment pad
static_assert(FWD_SMEM_BYTES <= 232448, "shared memory");

// One layer of a consumer warpgroup (`chain_layer` on this CTA's ring,
// layer1 reading xin's xc blocks): with FRESH (the recompute, whose
// epilogues also store) the accumulators' old values are dead and only the
// A registers the layer reads are fenced; K4f keeps K2's form (a FRESH
// build of it reads the same on the card).
template <int N, int NCH, int X_CHUNKS, bool FRESH, class Smem, class Release>
__device__ __forceinline__ void layer(float* acc, uint32_t* a, uint32_t xin, Smem& sm, Ring& ring,
                                      const Release& release, int xc = 1) {
  chain_layer<N, NCH, X_CHUNKS, RING, FRESH, FRESH ? (KCH / 4) * (NCH - X_CHUNKS) : 64>(acc, a, xin, sm.ring, sm.full,
                                                                                       ring, release, xc);
}

// A dead unit's share of the ring: `count` stages waited for and released
// untouched, so both consumers walk the same stage sequence while only the
// live one computes (no branch inside a product's wgmma chain). Only the
// warpgroup's thread 0 waits and releases; the others only advance their
// ring. Nothing ties a dead warpgroup's warps together (a live one's are
// tied by its wgmmas), so a warp that waited on `full[s]` itself could
// still be waiting for lap L when thread 0 has released it and the
// producer has completed lap L + 1: it would then wait on lap L + 2, of
// the same parity, and trail the ring by two laps until the producer
// stops and the watchdog traps. The other threads read nothing of a
// stage, and a warpgroup's items only grow, so once its item is past the
// last ray every later one is too and they never wait on the ring again.
template <int STAGES, class Smem, class Release>
__device__ __forceinline__ void skip_stages(Smem& sm, Ring& ring, int count, const Release& release) {
  const bool leader = (threadIdx.x & 127) == 0;
  for (int i = 0; i < count; ++i) {
    if (leader) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      release(ring.stage);
    }
    ring.advance<STAGES>();
  }
  __syncwarp();  // thread 0's warp whole again before an aligned barrier (the dX kernel's last)
}

// The producer: each unit's chunks, W1 (L.kx rows), WH_0..WH_{n-1}, WF,
// WD0.
template <int SF>
__device__ __forceinline__ void fwd_produce(FwdSmem& sm, const FwdArgs& a, const Layout& L, int n_rounds) {
  const UnitSchedule<SF, 1> g{a.l};
  Ring ring;
  auto load = [&](int off, int k, int n) {
    load_layer<RING, 1>(sm.ring, sm.full, sm.empty, ring, a.W + off, k, n, 0);
  };
  for (int round = blockIdx.x; round < n_rounds; round += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load(O::FW_OFF_W1, L.kx, HIDDEN);
      for (int i = 0; i < a.n_hidden; ++i) load(L.wh + i * HH, HIDDEN, HIDDEN);
      load(L.wf, HIDDEN, HIDDEN);
      load(L.wd0, HIDDEN, DIR_HIDDEN);
    }
  }
}

// A consumer warpgroup over its units: the chain, then (K4f) the heads and
// the raw rows out, or (SAVE, the recompute) each activation to its
// workspace image. A warpgroup whose rays are past the last walks the same
// chunks: K4f computes them and stores nothing, the recompute waits for
// and releases them untouched. The item's row i < rows() is row ray0·S + i
// of the pass (sample i % S of ray ray0 + i / S); a padding row after it,
// or a row of a ray past the last, is computed and not stored.
template <int SF, bool SAVE>
__device__ __forceinline__ void fwd_consume(FwdSmem& sm, const FwdArgs& a, int wg, int n_rounds) {
  const UnitSchedule<SF, 1> g{a.l};
  constexpr bool FRESH = SAVE;
  const int lane = threadIdx.x & 31;
  const int r0 = k1::frag_row();  // the thread's accumulator rows: r0 and r0 + 8 of a unit
  const int n = a.n_hidden;
  const int xc = g.xc();  // xin's blocks, W1's chunks
  const Workspace& ws = a.ws;
  auto release = [&](int stage) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
  };
  int units = 0;  // units taken, for the xin buffer and its phase
  Ring ring;
  float acc[128];
  uint32_t act[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) act[i] = 0u;

  for (int round = blockIdx.x; round < n_rounds; round += gridDim.x) {
    const int item = g.item(round, 0, wg);
    const int ray0 = item * g.wg_rays();
    const bool live = ray0 < a.n_rays;
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u) {
      const int unit = item * g.units() + u;
      const int b = xin_buf(units, xc), ph = xin_phase(units, xc);
      if (SAVE && !live) {  // the recompute stores nothing of a dead unit: skip its chunks
        // thread 0 alone takes the xin buffer, as skip_stages the ring
        if ((threadIdx.x & 127) == 0) {
          mbar_wait(&sm.xin_full[wg][b], ph);
          mbar_arrive(&sm.xin_empty[wg][b]);
        }
        ++units;
        skip_stages<RING>(sm, ring, xc + 4 * n + 4 + 4, release);
        continue;
      }
      mbar_wait(&sm.xin_full[wg][b], ph);
      const uint32_t xin = smem_u32(sm.xin[wg][b]);
      layer<HIDDEN, 1, 1, FRESH>(acc, act, xin, sm, ring, release, xc);
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.xin_empty[wg][b]);  // layer1 is its only reader
      ++units;
      acc_to_a<HIDDEN, false>(acc, act, ChainBias{sm.f + O::FF_OFF_V0});  // layer1: NO relu
      if (SAVE) k1::store_frag<HIDDEN>(unit_image(ws.act(0), HIDDEN, unit), act);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        layer<HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
        acc_to_a<HIDDEN, true>(acc, act, ChainBias{a.F + O::FF_OFF_BH + i * HIDDEN});
        if (SAVE) {
          k1::store_frag<HIDDEN>(unit_image(ws.act(i + 1), HIDDEN, unit), act);
          store_mask(unit_mask(ws.amask(i), unit), act);
        }
      }
      // σ off the trunk: a_n's A registers against wa padded to 8 columns
      float hs[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!SAVE) chain_head<HIDDEN>(hs, act, smem_u32(sm.wa8));
      layer<HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + O::FF_OFF_BF});  // feat
      if (SAVE) {
        k1::store_frag<HIDDEN>(unit_image(ws.feat, HIDDEN, unit), act);
        store_mask(unit_mask(ws.fmask, unit), act);
      }
      layer<DIR_HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
      // the rays of the thread's rows, worked out here and not held through
      // the trunk; a padding row's is n_rays
      const int i0 = u * 64 + r0, rows = g.rows();
      const int ray_h[2] = {i0 < rows ? ray0 + g.ray_of(i0) : a.n_rays,
                            i0 + 8 < rows ? ray0 + g.ray_of(i0 + 8) : a.n_rays};
      auto dir_row = [&](int ray) { return ray < a.n_rays ? a.dir_c + (size_t)ray * DIR_HIDDEN : nullptr; };
      if constexpr (SF != 0) {  // one ray over whole units: both rows in it
        acc_to_a<DIR_HIDDEN, true>(acc, act, ChainDir{sm.f + O::FF_OFF_BD0, dir_row(ray_h[0])});  // x0
      } else {
        acc_to_a<DIR_HIDDEN, true>(acc, act, ChainDirRows{sm.f + O::FF_OFF_BD0, {dir_row(ray_h[0]), dir_row(ray_h[1])}});
      }
      if constexpr (SAVE) {
        k1::store_frag<DIR_HIDDEN>(unit_image(ws.x0, DIR_HIDDEN, unit), act);
      } else {
        float hc[4] = {0.f, 0.f, 0.f, 0.f};
        chain_head<DIR_HIDDEN>(hc, act, smem_u32(sm.wrgb8));
        // hs / hc[2h + j]: row r0 + 8h, column 2·(lane % 4) + j; lane q = 1
        // holds rgb's third column, handed to lane q = 0, which stores the row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float b2 = __shfl_down_sync(0xffffffffu, hc[2 * h], 1);
          const size_t row = (size_t)ray0 * g.samples() + i0 + 8 * h;  // the pass's row
          if ((lane & 3) == 0 && ray_h[h] < a.n_rays)
            *reinterpret_cast<float4*>(a.out + row * 4) =
                make_float4(hc[2 * h] + sm.f[O::FF_OFF_BRGB], hc[2 * h + 1] + sm.f[O::FF_OFF_BRGB + 1],
                            b2 + sm.f[O::FF_OFF_BRGB + 2], hs[2 * h] + sm.f[O::FF_OFF_BA]);
        }
      }
    }
  }
}

template <int SF, bool SAVE>
__global__ void __launch_bounds__(FLEX_THREADS, 1) flex_chain_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw + pad);
  const UnitSchedule<SF, 1> g{a.l};
  const int t = threadIdx.x;
  const Layout L = flex_layout<HIDDEN>(a.n_hidden, K_XIN * g.xc());
  for (int i = t; i < O::FF_OFF_BH; i += FLEX_THREADS) sm.f[i] = a.F[i];
  if constexpr (!SAVE) {
    head_image<HIDDEN>(sm.wa8, a.W + L.wa, 1, t, FLEX_THREADS);
    head_image<DIR_HIDDEN>(sm.wrgb8, a.W + L.wrgb, 3, t, FLEX_THREADS);
    fence_proxy_async();  // the images are read by wgmma
  }
  if (t == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    for (int w = 0; w < CONSUMERS; ++w) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&sm.xin_full[w][b], ENCODERS * 32);
        mbar_init(&sm.xin_empty[w][b], 1);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_rounds = g.rounds(a.n_rays);
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      fwd_produce<SF>(sm, a, L, n_rounds);
    } else if (w >= 1 && w <= ENCODERS) {
      const int e = t - CONSUMERS * 128 - 32;
      auto xin = [&](int wg, int b) { return sm.xin[wg][b]; };
      if constexpr (SAVE) {
        // the recompute also stores each live unit's xin image (L.kx wide)
        encode_units(g, xin, sm.xin_full, sm.xin_empty, a, sm.f + O::FF_OFF_FREQS, 0, blockIdx.x, gridDim.x,
                     n_rounds, e, [&](int item, int u) -> unsigned char* {
                       return item * g.wg_rays() < a.n_rays ? unit_image(a.ws.xin, L.kx, item * g.units() + u)
                                                            : nullptr;
                     });
      } else {
        encode_units(g, xin, sm.xin_full, sm.xin_empty, a, sm.f + O::FF_OFF_FREQS, 0, blockIdx.x, gridDim.x,
                     n_rounds, e, [](int, int) -> unsigned char* { return nullptr; });
      }
    }
  } else {
    reg_alloc<232>();
    fwd_consume<SF, SAVE>(sm, a, wg, n_rounds);
  }
}

// CTAs of a pass: one a round of two warpgroups' items, at most one an SM
// (the persistent grid; k1::pass_ctas, which K1 shares).
int flex_ctas(int n_rays, int n_samples) { return k1::pass_ctas(n_rays, n_samples); }

template <int SF, bool SAVE>
int launch_chain(const FwdArgs& a, cudaStream_t st) {
  auto kernel = flex_chain_kernel<SF, SAVE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<flex_ctas(a.n_rays, a.l.S), FLEX_THREADS, FWD_SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

// -- K4b's dX chain ---------------------------------------------------------------

struct DxArgs {
  const float* g;   // (R, S, 4): the cotangent of [rgb, σ]
  const bf16* W;    // the forward weights (WA and WRGB, row-major)
  const bf16* WT;   // the transposed weights' chunk images (Offsets<h>::FT_OFF_*)
  float* d_dir;     // (R, 128)
  Workspace ws;
  int n_rays;
  UnitLayout l;  // the pass's S, and its items' rays and units (host-computed)
  int n_hidden;
};

// Each dX product reads its A, the bf16 cotangent the product before wrote,
// from shared memory: a warpgroup's A tile, a 64-row unit's K-major image
// (k1::image_offset, the workspace's layout), written by the epilogue and
// copied out to the workspace by one bulk store. So a product is one
// wgmma_ss chain of m64n256k16 with nothing but its 128 accumulators in
// registers (A in registers, read again by a second pass of 128 columns,
// made ptxas serialise every wgmma of the kernel, C7512).
constexpr int DX_RING = 4;
constexpr int ATILE_BYTES = HIDDEN * ROW_BYTES;  // 64 rows × 256 columns, 32 KB

struct alignas(ATOM_BYTES) DxSmem {
  unsigned char ring[DX_RING][CHAIN_STAGE];  // transposed weights' chunk images
  unsigned char atile[CONSUMERS][ATILE_BYTES];
  float wa[HIDDEN];                          // the heads' bf16 weights as f32
  float wrgb[DIR_HIDDEN * 3];
  float g[CONSUMERS][2][64 * 4];             // a unit's cotangent rows [rgb, σ], by unit parity
  // a unit's d_dir pieces, by unit parity: per warp, its first ray's (slot
  // 0) and, where its rows reach another ray, its last ray's (slot 1)
  float dsum[CONSUMERS][2][4][2][DIR_HIDDEN];
  float dacc[CONSUMERS][DIR_HIDDEN];         // d_dir of a ray's rows in earlier units
  uint64_t full[DX_RING];
  uint64_t empty[DX_RING];
};
constexpr size_t DX_SMEM_BYTES = sizeof(DxSmem) + ATOM_BYTES;
static_assert(DX_SMEM_BYTES <= 232448, "shared memory");

// Bulk copies from shared memory to device memory (the A tiles out to the
// workspace): a copy, its group committed, and the wait until the
// thread's groups have read their source.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// The producer: each unit's dX chunks, WD0ᵀ, WFᵀ, WH_{n-1}ᵀ..WH_0ᵀ.
template <int SF>
__device__ __forceinline__ void dx_produce(DxSmem& sm, const DxArgs& a, int n_pairs) {
  const UnitSchedule<SF, 1> g{a.l};
  Ring ring;
  auto load = [&](int off, int k) {
    load_layer<DX_RING, 1>(sm.ring, sm.full, sm.empty, ring, a.WT + off, k, HIDDEN, 0);
  };
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load(O::FT_OFF_WD0T, DIR_HIDDEN);
      load(O::FT_OFF_WFT, HIDDEN);
      for (int i = a.n_hidden - 1; i >= 0; --i) load(O::FT_OFF_WHT + i * HH, HIDDEN);
    }
  }
}

// The heads' parts of a unit's dX, before its first product (K1's
// `dx_heads` with a_n for feat and x0 for x2), over the warpgroup's 256
// columns of a_n and 128 of x0 (`wrgb` their rows of the f32 (h / 2, 3)
// weight): the WA sums a_nᵀ·bf16(g_σ) and WRGB sums x0ᵀ·bf16(g_rgb) into
// the warp's partial row, with `biases` the σ / rgb biases' sums (at
// `bias_part`: ba, then brgb), and gx0 = bf16(g_rgb)·Wrgbᵀ ⊙ [x0 > 0] into
// acc[0, 64).
__device__ __forceinline__ void dx_heads(const float* wrgb, const unsigned char* an, const unsigned char* x0img,
                                         const float* gs, float* acc, float* part, int wa_col, int wrgb_col,
                                         float* bias_part, bool biases) {
  const int r0 = k1::frag_row(), lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  // WA: the 2-row fold of a_n · bf16(g_σ), 64 column partials in acc
  {
    uint32_t an_frag[HIDDEN / 4];
#pragma unroll
    for (int i = 0; i < HIDDEN / 4; ++i) acc[i] = 0.f;
    const float g0 = round_bf16(gs[r0 * 4 + 3]), g1 = round_bf16(gs[(r0 + 8) * 4 + 3]);
    k1::load_frag<HIDDEN>(an_frag, an);
#pragma unroll
    for (int p = 0; p < HIDDEN / 4; ++p) {
      const float2 f = unpack_bf16(an_frag[p]);
      const float g = (p & 1) ? g1 : g0;
      acc[p & ~1] += f.x * g;  // column pair group p >> 1: acc[2j], acc[2j + 1]
      acc[(p & ~1) + 1] += f.y * g;
    }
  }
  k1::scatter_sum<HIDDEN / 4>(acc);
#pragma unroll
  for (int k = 0; k < HIDDEN / 32; k += 2) {
    float2* p = reinterpret_cast<float2*>(part + wa_col + k1::fold_col(g8 * (HIDDEN / 32) + k));
    float2 o = *p;
    o.x += acc[k];
    o.y += acc[k + 1];
    *p = o;
  }
  // x0: the mask of gx0 and the left operand of WRGB; gx0 into acc
  uint32_t x0[DIR_HIDDEN / 4];
  k1::load_frag<DIR_HIDDEN>(x0, x0img);
  float gr[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gr[h][ch] = round_bf16(gs[(r0 + 8 * h) * 4 + ch]);
#pragma unroll
  for (int p = 0; p < DIR_HIDDEN / 4; ++p) {
    const int h = p & 1, col = k1::fold_col(2 * (p >> 1));
    const float2 m = unpack_bf16(x0[p]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* w = wrgb + (col + e) * 3;
      const float gx = gr[h][0] * w[0] + gr[h][1] * w[1] + gr[h][2] * w[2];
      acc[2 * p + e] = (e == 0 ? m.x : m.y) > 0.f ? gx : 0.f;
    }
  }
  // WRGB, a channel at a time
  float v[DIR_HIDDEN / 4];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int j = 0; j < DIR_HIDDEN / 8; ++j) {
      const float2 m0 = unpack_bf16(x0[2 * j]), m1 = unpack_bf16(x0[2 * j + 1]);
      v[2 * j] = m0.x * gr[0][ch] + m1.x * gr[1][ch];
      v[2 * j + 1] = m0.y * gr[0][ch] + m1.y * gr[1][ch];
    }
    k1::scatter_sum<DIR_HIDDEN / 4>(v);
#pragma unroll
    for (int k = 0; k < DIR_HIDDEN / 32; ++k) part[wrgb_col + k1::fold_col(g8 * (DIR_HIDDEN / 32) + k) * 3 + ch] += v[k];
  }
  // the σ and rgb biases: one lane a column, the unit's rows in order
  const int lw = (threadIdx.x >> 5) & 3;
  if (biases && lw == 0 && lane < 4) {
    float s = 0.f;
    for (int r = 0; r < 64; ++r) s += gs[r * 4 + (lane < 3 ? lane : 3)];
    bias_part[lane < 3 ? 1 + lane : 0] += s;  // ba, then brgb after it
  }
}

// The σ head's cotangent joins fc_feat's: bf16(g_σ) ⊗ wa + acc.
__device__ __forceinline__ void add_sigma(float* acc, const float* gs, const float* wa) {
  const int r0 = k1::frag_row();
  const float g0 = round_bf16(gs[r0 * 4 + 3]), g1 = round_bf16(gs[(r0 + 8) * 4 + 3]);
#pragma unroll
  for (int p = 0; p < HIDDEN / 4; ++p) {
    const float g = (p & 1) ? g1 : g0;
    const int col = k1::fold_col(2 * (p >> 1));
    acc[2 * p] = g * wa[col] + acc[2 * p];
    acc[2 * p + 1] = g * wa[col + 1] + acc[2 * p + 1];
  }
}

// Ask for an image in the L2 cache ahead of its loads: one bulk prefetch by
// the warpgroup's first thread, no register held.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// acc ⊙ [the activation > 0], from the thread's mask words (`store_mask`).
__device__ __forceinline__ void apply_mask(float* acc, const uint4& m) {
  const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int p = 0; p < HIDDEN / 4; ++p) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!((w[p / 16] >> (2 * (p % 16) + e)) & 1u)) acc[2 * p + e] = 0.f;
  }
}

// A cotangent's epilogue: acc (64 × N, f32, masked) rounded to bf16 into the
// warpgroup's A tile (the next product's A), its f32 column sums into the
// warp's partial row at `part` (consuming acc: afterwards acc[0, N/32)
// holds the lane's sums, k1::colsum), and the tile copied out to the
// cotangent's image `gout` with one bulk store by the warpgroup's first
// thread, once the tile's previous copy has read it. With PAIR (h = 512)
// the tile is the warpgroup's columns of an A image both warpgroups read:
// the barriers are both warpgroups' (each one's copies out and product
// done before either writes; the image whole before either reads).
template <int N, bool PAIR = false>
__device__ __forceinline__ void dx_store(float* acc, unsigned char* tile, unsigned char* gout, float* part, int wg) {
  const int t = threadIdx.x & 127, r0 = k1::frag_row(), c2 = 2 * (threadIdx.x & 3);
  if (t == 0) bulk_wait_read();
  if constexpr (PAIR) {
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
  } else {
    named_bar_sync(BAR_WG + wg, 128);
  }
#pragma unroll
  for (int p = 0; p < N / 4; ++p)
    *reinterpret_cast<uint32_t*>(tile + k1::image_offset(r0 + 8 * (p & 1), 8 * (p >> 1) + c2)) =
        pack_bf16(acc[2 * p], acc[2 * p + 1]);
  fence_proxy_async();  // the tile is read by wgmma and the bulk store
  k1::colsum<N>(acc, part, true);
  if constexpr (PAIR) {
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
  } else {
    named_bar_sync(BAR_WG + wg, 128);
  }
  if (t == 0) bulk_store(gout, tile, N * ROW_BYTES);
}

// One dX product of a warpgroup's 64 rows: acc = A·Wᵀ, A (K = NCH·64) the
// A tile, Wᵀ a transposed weight's chunk images (K, 256) from the ring;
// then (+ the σ head's cotangent when SIGMA, for fc_feat's input) ⊙ the
// saved activation's relu mask when MASKED (the thread's words at `mask`,
// loaded before the product), and dx_store.
template <int NCH, bool MASKED, bool SIGMA, class Release>
__device__ __forceinline__ void dx_product(float* acc, DxSmem& sm, int wg, Ring& ring, const Release& release,
                                           const uint32_t* mask, unsigned char* gout, float* part, const float* gs) {
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (MASKED) m = *reinterpret_cast<const uint4*>(mask);  // lands under the product
  uint32_t* no_a = nullptr;  // every chunk's A comes from the tile
  chain_layer<HIDDEN, NCH, NCH, DX_RING, true, 0>(acc, no_a, smem_u32(sm.atile[wg]), sm.ring, sm.full, ring, release);
  if constexpr (SIGMA) add_sigma(acc, gs, sm.wa);
  if constexpr (MASKED) apply_mask(acc, m);
  dx_store<HIDDEN>(acc, sm.atile[wg], gout, part, wg);
}

// The dX chain of one live unit (unit u of the item whose first ray is
// ray0, the pass's unit `unit`): its cotangent rows staged in shared memory
// (zero on padding rows and past the last ray), the heads, gx0 and d_dir
// of the unit's rays, then each product.
template <int SF, class Release>
__device__ __forceinline__ void dx_unit(DxSmem& sm, const DxArgs& a, const Layout& L, Ring& ring, float* acc, int wg,
                                        int u, int unit, int ray0, float* part, int& dx_units, const Release& release) {
  const UnitSchedule<SF, 1> g{a.l};
  const Workspace& ws = a.ws;
  const int n = a.n_hidden;
  const int t = threadIdx.x & 127;
  float* gs = sm.g[wg][dx_units & 1];
  auto img = [&](unsigned char* buf) { return unit_image(buf, HIDDEN, unit); };
  if (t < 64) {
    const int i = u * 64 + t;  // the item's row
    const bool valid = i < g.rows() && ray0 + g.ray_of(i) < a.n_rays;
    const size_t row = (size_t)ray0 * g.samples() + i;
    reinterpret_cast<float4*>(gs)[t] =
        valid ? *reinterpret_cast<const float4*>(a.g + row * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  named_bar_sync(BAR_WG + wg, 128);
  dx_heads(sm.wrgb, img(ws.act(n)), unit_image(ws.x0, DIR_HIDDEN, unit), gs, acc, part, L.f_total, L.f_total + HIDDEN,
           part + O::FF_OFF_BA, true);
  if constexpr (SF == 0) {
    // a warp whose 16 rows reach two rays: its pieces from the masked f32
    // gx0 in acc before the epilogue consumes it
    if (g.samples() % 16 != 0)
      k1::DirPieces<UnitSchedule<SF, 1>>{sm.dsum[wg][dx_units & 1][(threadIdx.x >> 5) & 3],
                                         a.d_dir + (size_t)ray0 * DIR_HIDDEN, g, u, ray0, a.n_rays, true}(acc);
  }
  dx_store<DIR_HIDDEN>(acc, sm.atile[wg], unit_image(ws.gx0, DIR_HIDDEN, unit), part + O::FF_OFF_BD0, wg);
  // d_dir: a warp of one ray's piece is its column sums of gx0 (acc[0, 4)
  // of each lane); the pieces summed over each ray's warps and units in
  // order (at S = 32 / 64 / 128 the sums of the fixed-S kernels)
  {
    const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
    float(*ds)[2][DIR_HIDDEN] = sm.dsum[wg][dx_units & 1];
    const k1::WarpRays wr(u, lw, g);
    if (wr.fa >= 0 && wr.fa == wr.fb) {
      const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll
      for (int k = 0; k < DIR_HIDDEN / 32; ++k) ds[lw][0][k1::fold_col(base + k)] = acc[k];
    }
    named_bar_sync(BAR_WG + wg, 128);
    k1::dir_pieces(ds, sm.dacc[wg], a.d_dir + (size_t)ray0 * DIR_HIDDEN, g, u, ray0, a.n_rays, true, t);
    ++dx_units;
  }
  // g_feat = bf16(gx0)·WD0ᵀ ⊙ [feat > 0]
  dx_product<DIR_HIDDEN / KCH, true, false>(acc, sm, wg, ring, release, unit_mask(ws.fmask, unit), img(ws.gfeat),
                                            part + O::FF_OFF_BF, gs);
  // a_n's cotangent, bf16(g_feat)·WFᵀ + bf16(g_σ) ⊗ wa: masked by a_n, or
  // unmasked when a_n is layer1's output (n = 0); then down the hidden
  // layers, g_{i-1} = bf16(g_i)·WH_iᵀ ⊙ [a_i > 0], and at i = 0 the
  // cotangent of layer1's output a_0, unmasked
  if (n > 0) {
    dx_product<HIDDEN / KCH, true, true>(acc, sm, wg, ring, release, unit_mask(ws.amask(n - 1), unit),
                                         img(ws.gpre(n - 1)), part + O::FF_OFF_BH + (n - 1) * HIDDEN, gs);
#pragma unroll 1
    for (int i = n - 1; i >= 1; --i)
      dx_product<HIDDEN / KCH, true, false>(acc, sm, wg, ring, release, unit_mask(ws.amask(i - 1), unit),
                                            img(ws.gpre(i - 1)), part + O::FF_OFF_BH + (i - 1) * HIDDEN, gs);
    dx_product<HIDDEN / KCH, false, false>(acc, sm, wg, ring, release, nullptr, img(ws.ga0), part + O::FF_OFF_V0, gs);
  } else {
    dx_product<HIDDEN / KCH, false, true>(acc, sm, wg, ring, release, nullptr, img(ws.ga0), part + O::FF_OFF_V0, gs);
  }
}

template <int SF>
__device__ __forceinline__ void dx_consume(DxSmem& sm, const DxArgs& a, const Layout& L, int wg, int n_pairs,
                                           float* part) {
  const UnitSchedule<SF, 1> g{a.l};
  auto release = [&](int stage) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
  };
  int dx_units = 0;
  Ring ring;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int units = g.units();
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int item = g.item(pair, 0, wg);
#pragma unroll 1
    for (int u = 0; u < units; ++u) {
      if (item < n_items) {
        // the heads' images of this warpgroup's next unit into L2, a unit ahead
        const int next_item = u + 1 < units ? item : g.item(pair + gridDim.x, 0, wg);
        if (next_item < n_items) {
          const int next = next_item * units + (u + 1 < units ? u + 1 : 0);
          prefetch_l2(unit_image(a.ws.act(a.n_hidden), HIDDEN, next), ATILE_BYTES);
          prefetch_l2(unit_image(a.ws.x0, DIR_HIDDEN, next), ATILE_BYTES / 2);
        }
        dx_unit<SF>(sm, a, L, ring, acc, wg, u, item * units + u, item * g.wg_rays(), part, dx_units, release);
      } else {  // past the last ray: the unit's chunks, untouched
        skip_stages<DX_RING>(sm, ring, DIR_HIDDEN / KCH + HIDDEN / KCH * (1 + a.n_hidden), release);
      }
    }
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();  // the last tile's copy is out before the CTA's memory goes
}

template <int SF>
__global__ void __launch_bounds__(FLEX_THREADS, 1) flex_dx_kernel(const DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  DxSmem& sm = *reinterpret_cast<DxSmem*>(smem_raw + pad);
  const int t = threadIdx.x;
  const Layout L = flex_layout<HIDDEN>(a.n_hidden, K_XIN * UnitSchedule<SF, 1>{a.l}.xc());
  for (int i = t; i < HIDDEN; i += FLEX_THREADS) sm.wa[i] = __bfloat162float(a.W[L.wa + i]);
  for (int i = t; i < DIR_HIDDEN * 3; i += FLEX_THREADS) sm.wrgb[i] = __bfloat162float(a.W[L.wrgb + i]);
  if (t == 0) {
    for (int s = 0; s < DX_RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  // each consumer warp's running partial row starts at zero
  float* part = nullptr;
  if (t < CONSUMERS * 128) {
    part = a.ws.warp_part + ((size_t)blockIdx.x * WARPS_A_CTA + (t >> 5)) * L.part_cols;
    for (int c = t & 31; c < L.part_cols; c += 32) part[c] = 0.f;
    __syncwarp();
  }
  __syncthreads();

  const int n_pairs = UnitSchedule<SF, 1>{a.l}.rounds(a.n_rays);
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    if (t == CONSUMERS * 128) dx_produce<SF>(sm, a, n_pairs);
  } else {
    reg_alloc<232>();
    dx_consume<SF>(sm, a, L, wg, n_pairs, part);
    // the CTA's partial row: its warps' rows added in order
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
    const float* rows = a.ws.warp_part + (size_t)blockIdx.x * WARPS_A_CTA * L.part_cols;
    for (int c = t; c < L.part_cols; c += CONSUMERS * 128) {
      float s = 0.f;
      for (int w = 0; w < WARPS_A_CTA; ++w) s += rows[(size_t)w * L.part_cols + c];
      a.ws.tile_part[(size_t)blockIdx.x * L.part_cols + c] = s;
    }
  }
}

// The recompute and the dX chain of a pass.
template <int SF>
int launch_backward(const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
  int err = launch_chain<SF, true>(fa, st);
  if (err != 0) return err;
  auto kernel = flex_dx_kernel<SF>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DX_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<flex_ctas(da.n_rays, da.l.S), FLEX_THREADS, DX_SMEM_BYTES, st>>>(da);
  return (int)cudaGetLastError();
}

// -- h = 512: the two consumer warpgroups share a unit ------------------------------
//
// At h = 512 a layer's output for a 64-row unit is 64 × 512 f32: 256
// accumulator registers a thread of one warpgroup, more than it holds. So
// both consumer warpgroups of a CTA take the same unit, warpgroup wg the
// output columns [256·wg, +256) of every trunk layer ([128·wg, +128) of
// layers_dir.0's 256), one m64n256k16 (m64n128k16) chain each. A product
// reads all of its A from shared memory: layer1 the unit's xin tile, every
// other layer the exchange image, where each warpgroup's epilogue leaves
// its columns of the activation (the unit's image, k1::image_offset, so K
// chunk c of the next product is 8 KB · c into it). A ring stage holds one
// whole 64 × 512 chunk image; a warpgroup reads its columns' rows of it
// and both release it. A named barrier of both warpgroups before each
// write of the image (the partner's product that read it is done) and
// after it (the image is whole). The σ and rgb heads are each warpgroup's
// m64n8 product over its own columns, off the A registers of its epilogue;
// the two partial rows meet in shared memory and warpgroup 0 stores the
// raw rows. K4b's dX splits the same way: the cotangent's image is both
// warpgroups' A, each computes its columns of the next one. A CTA takes
// one item a round (the h = 256 kernels' items: whole rays in 1..4
// units), so no warpgroup walks a dead item.

constexpr int WIDE_DH = WIDE / 2;
constexpr int WHALF = WIDE / CONSUMERS;      // a warpgroup's columns of a trunk layer
constexpr int WDHALF = WIDE_DH / CONSUMERS;  // ... of layers_dir.0
constexpr int WSTAGE = KCH * WIDE * 2;       // a ring stage: one 64 × 512 chunk image, 64 KB
constexpr int WRING = 2;
constexpr int WIMG_BYTES = WIDE * ROW_BYTES;  // a unit's 512-wide activation or cotangent as its image
using OW = Offsets<WIDE>;

// CTAs of a pass at h = 512: one a round of one item, at most one an SM.
int wide_ctas(int n_rays, int n_samples) {
  const int items = k1::Geometry(n_samples).items(n_rays);
  return items < k1::K1_CTAS ? items : k1::K1_CTAS;
}

// One product of a unit the warpgroups share: acc = A·W[:, the warpgroup's
// N columns], A (K = NCH·xc·64) the image at shared address `a_img` (xc >
// 1 only for layer1 on a two-block xin image, NCH 1), W's chunk images
// through the ring (the warpgroup's columns N·wg rows into a stage). acc
// needs no clearing: the first wgmma overwrites it.
template <int N, int NCH, class Smem, class Release>
__device__ __forceinline__ void wide_layer(float* acc, uint32_t a_img, Smem& sm, Ring& ring, int wg,
                                           const Release& release, int xc = 1) {
  uint32_t* no_a = nullptr;  // every chunk's A comes from the image
  auto stages = reinterpret_cast<unsigned char(*)[WSTAGE]>(sm.ring[0] + wg * N * ROW_BYTES);
  chain_layer<N, NCH, NCH, WRING, true, 0, WSTAGE>(acc, no_a, a_img, stages, sm.full, ring, release, xc);
}

struct alignas(ATOM_BYTES) WideFwdSmem {
  unsigned char ring[WRING][WSTAGE];  // weight chunk images
  unsigned char xch[WIMG_BYTES];      // the layer's output, both warpgroups' columns: the next product's A
  // a unit's [xyz; PE; 0], both warpgroups' A of layer1: two buffers of one
  // block, or one of both past 10 bands (`xin_buf`; no room for two of two)
  unsigned char xin[2][XIN_BYTES];
  unsigned char wa8[WIDE / KCH][8 * ROW_BYTES];  // the heads' weights padded to 8 columns
  unsigned char wrgb8[WIDE_DH / KCH][8 * ROW_BYTES];
  float heads[CONSUMERS][64][4];      // each warpgroup's partial [rgb, σ] of the unit's rows
  uint64_t full[WRING];
  uint64_t empty[WRING];
  uint64_t xin_full[2];
  uint64_t xin_empty[2];
};
constexpr size_t WIDE_FWD_SMEM_BYTES = sizeof(WideFwdSmem) + ATOM_BYTES;
static_assert(WIDE_FWD_SMEM_BYTES <= 232448, "shared memory");

// The warpgroup's N columns of a layer's output (its A registers) into the
// exchange image, once both warpgroups' products that read it are done;
// afterwards the image is whole.
template <int N>
__device__ __forceinline__ void wide_exchange(unsigned char* img, const uint32_t* act, int wg) {
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
  k1::store_frag<N>(img + wg * N * ROW_BYTES, act);
  fence_proxy_async();  // the image is read by wgmma
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
}

// The producer: each unit's chunks, W1 (L.kx rows), WH_0..WH_{n-1}, WF,
// WD0.
template <int SF>
__device__ __forceinline__ void wide_fwd_produce(WideFwdSmem& sm, const FwdArgs& a, const Layout& L, int n_items) {
  const UnitSchedule<SF, 1> g{a.l};
  Ring ring;
  auto load = [&](int off, int k, int n) {
    load_layer<WRING, 1, WSTAGE>(sm.ring, sm.full, sm.empty, ring, a.W + off, k, n, 0);
  };
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load(OW::FW_OFF_W1, L.kx, WIDE);
      for (int i = 0; i < a.n_hidden; ++i) load(L.wh + i * WIDE * WIDE, WIDE, WIDE);
      load(L.wf, WIDE, WIDE);
      load(L.wd0, WIDE, WIDE_DH);
    }
  }
}

// The encoder warps (index e): each unit of the CTA's items, in order, into
// the next xin buffer (`xin_buf`: of the two, or the one of two blocks past
// 10 bands, 2·64·xc tasks) once both warpgroups have released it; with
// `xg` (the recompute) also into the unit's workspace image. H is the
// width, whose bias rows hold the bands (the h = 768 / 1024 kernels, below,
// share it).
template <int H, class G, class Smem>
__device__ __forceinline__ void wide_encode(const G& g, Smem& sm, const FwdArgs& a, int n_items, int e,
                                            unsigned char* xg) {
  const int xc = g.xc(), tasks = 128 * xc;
  int done = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      const int b = xin_buf(done, xc);
      mbar_wait(&sm.xin_empty[b], xin_phase(done, xc) ^ 1);
      unsigned char* gi = xg ? unit_image(xg, K_XIN * xc, item * g.units() + u) : nullptr;
      for (int task = e; task < tasks; task += ENCODERS * 32)
        encode_task(sm.xin[b], gi, task, a, a.F + Offsets<H>::FF_OFF_FREQS, item * g.wg_rays(), u * 64, g);
      fence_proxy_async();
      mbar_arrive(&sm.xin_full[b]);
      ++done;
    }
  }
}

// A consumer warpgroup's share of each unit: its columns of every layer,
// then (K4f) its partial heads, warpgroup 0 storing the raw rows, or
// (SAVE, the recompute) its columns of each activation and mask to the
// workspace. Row i < rows() of an item is row ray0·S + i of the pass; a
// padding row, or a row of a ray past the last, is computed and not
// stored.
template <int SF, bool SAVE>
__device__ __forceinline__ void wide_fwd_consume(WideFwdSmem& sm, const FwdArgs& a, int wg, int n_items) {
  const UnitSchedule<SF, 1> g{a.l};
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int r0 = k1::frag_row();
  const int n = a.n_hidden;
  const int c0 = wg * WHALF, d0 = wg * WDHALF;  // the warpgroup's first column of a trunk layer / of x0
  const int xc = g.xc();  // xin's blocks, W1's chunks
  const Workspace& ws = a.ws;
  auto release = [&](int stage) {
    if (t == 0) mbar_arrive(&sm.empty[stage]);
  };
  const uint32_t xch = smem_u32(sm.xch);
  int units = 0;  // units taken, for the xin buffer and its phase
  Ring ring;
  float acc[128];
  uint32_t act[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) act[i] = 0u;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int ray0 = item * g.wg_rays();
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u) {
      const int unit = item * g.units() + u;
      const int b = xin_buf(units, xc);
      mbar_wait(&sm.xin_full[b], xin_phase(units, xc));
      wide_layer<WHALF, 1>(acc, smem_u32(sm.xin[b]), sm, ring, wg, release, xc);
      if (t == 0) mbar_arrive(&sm.xin_empty[b]);  // layer1 is its only reader
      ++units;
      acc_to_a<WHALF, false>(acc, act, ChainBias{a.F + OW::FF_OFF_V0 + c0});  // layer1: NO relu
      if (SAVE) k1::store_frag<WHALF>(unit_image(ws.act(0), WIDE, unit) + c0 * ROW_BYTES, act);
      wide_exchange<WHALF>(sm.xch, act, wg);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        wide_layer<WHALF, WIDE / KCH>(acc, xch, sm, ring, wg, release);
        acc_to_a<WHALF, true>(acc, act, ChainBias{a.F + OW::FF_OFF_BH + i * WIDE + c0});
        if (SAVE) {
          k1::store_frag<WHALF>(unit_image(ws.act(i + 1), WIDE, unit) + c0 * ROW_BYTES, act);
          store_mask(wide_mask(ws.amask(i), unit, wg), act);
        }
        wide_exchange<WHALF>(sm.xch, act, wg);
      }
      // σ off the trunk: the warpgroup's columns of a_n against its rows of wa
      float hs[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!SAVE) chain_head<WHALF>(hs, act, smem_u32(sm.wa8[c0 / KCH]));
      wide_layer<WHALF, WIDE / KCH>(acc, xch, sm, ring, wg, release);
      acc_to_a<WHALF, true>(acc, act, ChainBias{a.F + OW::FF_OFF_BF + c0});  // feat
      if (SAVE) {
        k1::store_frag<WHALF>(unit_image(ws.feat, WIDE, unit) + c0 * ROW_BYTES, act);
        store_mask(wide_mask(ws.fmask, unit, wg), act);
      }
      wide_exchange<WHALF>(sm.xch, act, wg);
      wide_layer<WDHALF, WIDE / KCH>(acc, xch, sm, ring, wg, release);
      const int i0 = u * 64 + r0, rows = g.rows();
      const int ray_h[2] = {i0 < rows ? ray0 + g.ray_of(i0) : a.n_rays,
                            i0 + 8 < rows ? ray0 + g.ray_of(i0 + 8) : a.n_rays};
      auto dir_row = [&](int ray) { return ray < a.n_rays ? a.dir_c + (size_t)ray * WIDE_DH + d0 : nullptr; };
      if constexpr (SF != 0) {  // one ray over whole units: both rows in it
        acc_to_a<WDHALF, true>(acc, act, ChainDir{a.F + OW::FF_OFF_BD0 + d0, dir_row(ray_h[0])});  // x0
      } else {
        acc_to_a<WDHALF, true>(acc, act,
                               ChainDirRows{a.F + OW::FF_OFF_BD0 + d0, {dir_row(ray_h[0]), dir_row(ray_h[1])}});
      }
      if constexpr (SAVE) {
        k1::store_frag<WDHALF>(unit_image(ws.x0, WIDE_DH, unit) + d0 * ROW_BYTES, act);
      } else {
        float hc[4] = {0.f, 0.f, 0.f, 0.f};
        chain_head<WDHALF>(hc, act, smem_u32(sm.wrgb8[d0 / KCH]));
        // hs / hc[2h + j]: row r0 + 8h, column 2·(lane % 4) + j: lane q = 0
        // holds rgb's first two columns and σ's, lane q = 1 rgb's third
        float(*hp)[4] = sm.heads[wg];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((lane & 3) == 0) {
            hp[r0 + 8 * h][0] = hc[2 * h];
            hp[r0 + 8 * h][1] = hc[2 * h + 1];
            hp[r0 + 8 * h][3] = hs[2 * h];
          } else if ((lane & 3) == 1) {
            hp[r0 + 8 * h][2] = hc[2 * h];
          }
        }
        named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
        if (wg == 0 && t < 64) {
          const int i = u * 64 + t;  // the item's row
          if (i < rows && ray0 + g.ray_of(i) < a.n_rays) {
            const float* p0 = sm.heads[0][t];
            const float* p1 = sm.heads[1][t];
            const float* f = a.F;
            *reinterpret_cast<float4*>(a.out + ((size_t)ray0 * g.samples() + i) * 4) =
                make_float4(p0[0] + p1[0] + f[OW::FF_OFF_BRGB], p0[1] + p1[1] + f[OW::FF_OFF_BRGB + 1],
                            p0[2] + p1[2] + f[OW::FF_OFF_BRGB + 2], p0[3] + p1[3] + f[OW::FF_OFF_BA]);
          }
        }
      }
    }
  }
}

template <int SF, bool SAVE>
__global__ void __launch_bounds__(FLEX_THREADS, 1) wide_chain_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  WideFwdSmem& sm = *reinterpret_cast<WideFwdSmem*>(smem_raw + pad);
  const UnitSchedule<SF, 1> g{a.l};
  const int t = threadIdx.x;
  const Layout L = flex_layout<WIDE>(a.n_hidden, K_XIN * g.xc());
  if constexpr (!SAVE) {
    head_image<WIDE>(sm.wa8, a.W + L.wa, 1, t, FLEX_THREADS);
    head_image<WIDE_DH>(sm.wrgb8, a.W + L.wrgb, 3, t, FLEX_THREADS);
    fence_proxy_async();  // the images are read by wgmma
  }
  if (t == 0) {
    for (int s = 0; s < WRING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.xin_full[b], ENCODERS * 32);
      mbar_init(&sm.xin_empty[b], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      wide_fwd_produce<SF>(sm, a, L, n_items);
    } else if (w >= 1 && w <= ENCODERS) {
      wide_encode<WIDE>(g, sm, a, n_items, t - CONSUMERS * 128 - 32, SAVE ? a.ws.xin : nullptr);
    }
  } else {
    reg_alloc<232>();
    wide_fwd_consume<SF, SAVE>(sm, a, wg, n_items);
  }
}

template <int SF, bool SAVE>
int launch_wide_chain(const FwdArgs& a, cudaStream_t st) {
  auto kernel = wide_chain_kernel<SF, SAVE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WIDE_FWD_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<wide_ctas(a.n_rays, a.l.S), FLEX_THREADS, WIDE_FWD_SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

struct alignas(ATOM_BYTES) WideDxSmem {
  unsigned char ring[WRING][WSTAGE];  // transposed weights' chunk images
  unsigned char atile[WIMG_BYTES];    // the unit's cotangent, both warpgroups' columns: the next product's A
  float wa[WIDE];                     // the heads' bf16 weights as f32
  float wrgb[WIDE_DH * 3];
  float g[2][64 * 4];                 // a unit's cotangent rows [rgb, σ], by unit parity
  // a warpgroup's d_dir pieces of its 128 columns (as DxSmem's)
  float dsum[CONSUMERS][2][4][2][DIR_HIDDEN];
  float dacc[CONSUMERS][DIR_HIDDEN];
  uint64_t full[WRING];
  uint64_t empty[WRING];
};
constexpr size_t WIDE_DX_SMEM_BYTES = sizeof(WideDxSmem) + ATOM_BYTES;
static_assert(WIDE_DX_SMEM_BYTES <= 232448, "shared memory");

// The producer: each unit's dX chunks, WD0ᵀ, WFᵀ, WH_{n-1}ᵀ..WH_0ᵀ.
template <int SF>
__device__ __forceinline__ void wide_dx_produce(WideDxSmem& sm, const DxArgs& a, int n_items) {
  const UnitSchedule<SF, 1> g{a.l};
  Ring ring;
  auto load = [&](int off, int k) {
    load_layer<WRING, 1, WSTAGE>(sm.ring, sm.full, sm.empty, ring, a.WT + off, k, WIDE, 0);
  };
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load(OW::FT_OFF_WD0T, WIDE_DH);
      load(OW::FT_OFF_WFT, WIDE);
      for (int i = a.n_hidden - 1; i >= 0; --i) load(OW::FT_OFF_WHT + i * WIDE * WIDE, WIDE);
    }
  }
}

// One dX product of a unit (`dx_product` at h = 512): the warpgroup's 256
// columns of A·Wᵀ, A (K = NCH·64) the cotangent image both warpgroups
// wrote, then the σ head's cotangent, the mask and `dx_store` into its
// columns of the image and of `gout`.
template <int NCH, bool MASKED, bool SIGMA, class Release>
__device__ __forceinline__ void wide_dx_product(float* acc, WideDxSmem& sm, int wg, Ring& ring,
                                                const Release& release, const uint32_t* mask, unsigned char* gout,
                                                float* part, const float* gs) {
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (MASKED) m = *reinterpret_cast<const uint4*>(mask);  // lands under the product
  wide_layer<WHALF, NCH>(acc, smem_u32(sm.atile), sm, ring, wg, release);
  if constexpr (SIGMA) add_sigma(acc, gs, sm.wa + wg * WHALF);
  if constexpr (MASKED) apply_mask(acc, m);
  dx_store<WHALF, true>(acc, sm.atile + wg * WHALF * ROW_BYTES, gout + wg * WHALF * ROW_BYTES, part, wg);
}

// The dX chain of a unit at h = 512 (`dx_unit`): the unit's cotangent
// rows staged once for both warpgroups, each warpgroup's columns of the
// heads, gx0, d_dir and every product.
template <int SF, class Release>
__device__ __forceinline__ void wide_dx_unit(WideDxSmem& sm, const DxArgs& a, const Layout& L, Ring& ring,
                                             float* acc, int wg, int u, int unit, int ray0, float* part,
                                             int& dx_units, const Release& release) {
  const UnitSchedule<SF, 1> g{a.l};
  const Workspace& ws = a.ws;
  const int n = a.n_hidden;
  const int t = threadIdx.x & 127;
  const int c0 = wg * WHALF, d0 = wg * WDHALF;
  float* gs = sm.g[dx_units & 1];
  auto img = [&](unsigned char* buf) { return unit_image(buf, WIDE, unit); };
  if (wg == 0 && t < 64) {
    const int i = u * 64 + t;  // the item's row
    const bool valid = i < g.rows() && ray0 + g.ray_of(i) < a.n_rays;
    const size_t row = (size_t)ray0 * g.samples() + i;
    reinterpret_cast<float4*>(gs)[t] =
        valid ? *reinterpret_cast<const float4*>(a.g + row * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
  dx_heads(sm.wrgb + d0 * 3, img(ws.act(n)) + c0 * ROW_BYTES,
           unit_image(ws.x0, WIDE_DH, unit) + d0 * ROW_BYTES, gs, acc, part, L.f_total + c0,
           L.f_total + WIDE + d0 * 3, part + OW::FF_OFF_BA, wg == 0);
  float* d_dir = a.d_dir + (size_t)ray0 * WIDE_DH + d0;  // the item's first ray's row, the warpgroup's columns
  if constexpr (SF == 0) {
    if (g.samples() % 16 != 0)
      k1::DirPieces<UnitSchedule<SF, 1>, WIDE_DH>{sm.dsum[wg][dx_units & 1][(threadIdx.x >> 5) & 3], d_dir, g, u,
                                                   ray0, a.n_rays, true}(acc);
  }
  dx_store<WDHALF, true>(acc, sm.atile + d0 * ROW_BYTES, unit_image(ws.gx0, WIDE_DH, unit) + d0 * ROW_BYTES,
                         part + OW::FF_OFF_BD0 + d0, wg);
  {
    const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
    float(*ds)[2][DIR_HIDDEN] = sm.dsum[wg][dx_units & 1];
    const k1::WarpRays wr(u, lw, g);
    if (wr.fa >= 0 && wr.fa == wr.fb) {
      const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll
      for (int k = 0; k < DIR_HIDDEN / 32; ++k) ds[lw][0][k1::fold_col(base + k)] = acc[k];
    }
    named_bar_sync(BAR_WG + wg, 128);
    k1::dir_pieces<WIDE_DH>(ds, sm.dacc[wg], d_dir, g, u, ray0, a.n_rays, true, t);
    ++dx_units;
  }
  // g_feat = bf16(gx0)·WD0ᵀ ⊙ [feat > 0]; then as `dx_unit`
  wide_dx_product<WIDE_DH / KCH, true, false>(acc, sm, wg, ring, release, wide_mask(ws.fmask, unit, wg),
                                              img(ws.gfeat), part + OW::FF_OFF_BF + c0, gs);
  if (n > 0) {
    wide_dx_product<WIDE / KCH, true, true>(acc, sm, wg, ring, release, wide_mask(ws.amask(n - 1), unit, wg),
                                            img(ws.gpre(n - 1)), part + OW::FF_OFF_BH + (n - 1) * WIDE + c0, gs);
#pragma unroll 1
    for (int i = n - 1; i >= 1; --i)
      wide_dx_product<WIDE / KCH, true, false>(acc, sm, wg, ring, release, wide_mask(ws.amask(i - 1), unit, wg),
                                               img(ws.gpre(i - 1)), part + OW::FF_OFF_BH + (i - 1) * WIDE + c0,
                                               gs);
    wide_dx_product<WIDE / KCH, false, false>(acc, sm, wg, ring, release, nullptr, img(ws.ga0),
                                              part + OW::FF_OFF_V0 + c0, gs);
  } else {
    wide_dx_product<WIDE / KCH, false, true>(acc, sm, wg, ring, release, nullptr, img(ws.ga0),
                                             part + OW::FF_OFF_V0 + c0, gs);
  }
}

template <int SF>
__global__ void __launch_bounds__(FLEX_THREADS, 1) wide_dx_kernel(const DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  WideDxSmem& sm = *reinterpret_cast<WideDxSmem*>(smem_raw + pad);
  const UnitSchedule<SF, 1> g{a.l};
  const int t = threadIdx.x;
  const Layout L = flex_layout<WIDE>(a.n_hidden, K_XIN * g.xc());
  for (int i = t; i < WIDE; i += FLEX_THREADS) sm.wa[i] = __bfloat162float(a.W[L.wa + i]);
  for (int i = t; i < WIDE_DH * 3; i += FLEX_THREADS) sm.wrgb[i] = __bfloat162float(a.W[L.wrgb + i]);
  if (t == 0) {
    for (int s = 0; s < WRING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  // each consumer warp's running partial row starts at zero
  float* part = nullptr;
  if (t < CONSUMERS * 128) {
    part = a.ws.warp_part + ((size_t)blockIdx.x * WARPS_A_CTA + (t >> 5)) * L.part_cols;
    for (int c = t & 31; c < L.part_cols; c += 32) part[c] = 0.f;
    __syncwarp();
  }
  __syncthreads();

  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    if (t == CONSUMERS * 128) wide_dx_produce<SF>(sm, a, n_items);
  } else {
    reg_alloc<232>();
    auto release = [&](int stage) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
    };
    int dx_units = 0;
    Ring ring;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
#pragma unroll 1
      for (int u = 0; u < g.units(); ++u)
        wide_dx_unit<SF>(sm, a, L, ring, acc, wg, u, item * g.units() + u, item * g.wg_rays(), part, dx_units,
                         release);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();  // the last tile's copy is out before the CTA's memory goes
    // the CTA's partial row: its warps' rows added in order
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
    const float* rows = a.ws.warp_part + (size_t)blockIdx.x * WARPS_A_CTA * L.part_cols;
    for (int c = t; c < L.part_cols; c += CONSUMERS * 128) {
      float s = 0.f;
      for (int w = 0; w < WARPS_A_CTA; ++w) s += rows[(size_t)w * L.part_cols + c];
      a.ws.tile_part[(size_t)blockIdx.x * L.part_cols + c] = s;
    }
  }
}

template <int SF>
int launch_wide_backward(const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
  int err = launch_wide_chain<SF, true>(fa, st);
  if (err != 0) return err;
  auto kernel = wide_dx_kernel<SF>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WIDE_DX_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<wide_ctas(da.n_rays, da.l.S), FLEX_THREADS, WIDE_DX_SMEM_BYTES, st>>>(da);
  return (int)cudaGetLastError();
}

// -- h = 768 and 1024: each layer's columns in slices --------------------------------
//
// Past h = 512 the h = 512 structure does not fit: the exchange image of a
// unit's h-wide activation is 96 / 128 KB, a ring stage of whole chunk
// images as much again, and a warpgroup's half of a layer's columns 192 /
// 256 f32 accumulators a thread. So both consumer warpgroups still share
// each unit, but compute each layer in slices of SLICE = 256 columns,
// warpgroup wg the 128 columns [256·s + 128·wg, +128) of slice s (one
// m64n128k16 chain, 64 accumulators). A ring stage holds one slice's
// columns of one 64-row chunk (the chunk image's rows of those columns:
// one bulk copy, 32 KB). Every slice reads the layer's whole input, the
// exchange image (layer1 the xin tile), so a slice's output cannot go into
// the image until every slice of both warpgroups is done: each warpgroup
// parks its slices' bf16 outputs in registers (32 a slice, 96 live at most
// beside the 64 accumulators at h = 1024) and writes them into the image
// between two barriers of both warpgroups. layers_dir.0 (h / 2 wide) is
// slices of the same kind; at h = 768 its second slice is 128 columns,
// warpgroup 0's, and warpgroup 1 waits for and releases its stages
// untouched. The heads are sums on the CUDA cores over the parked a_n and
// x0 (their products are exact in f32; the f32 sums are in a fixed order:
// the thread's columns, its quad, then warpgroup 0's partial before
// warpgroup 1's), which frees the 24 KB of head images the m64n8 heads
// would take. K4b's dX is the same: the cotangent's image is every
// product's A, each product's slices parked and written into it after the
// last, and stored to the workspace from the registers; gx0 is the h = 512
// kernels' `dx_heads` over 128-column blocks of x0 (warpgroup wg the
// blocks wg, wg + 2). The recompute stores each slice's activation and
// its relu mask (2 words a thread of a 128-column block, `slice_mask`) to
// the workspace. Only the runtime layout class (S, its items' rays and
// units read at run time) is built: the h = 768 / 1024 passes of S = 64 /
// 128 run it too, each width in a build of its own (`sliced_forward`).
//
// Bound: the tensor cores, as at h = 512, with every product's B streamed
// from L2 once per 64-row unit (2 MB a hidden layer at h = 1024, 64 FLOP a
// byte of L2 traffic).

constexpr int MAX_WIDTH = 1024;           // the widest h: the kernels take every multiple of HIDDEN up to it

// The h > 512 width whose kernels a build holds, 0 for none (a -D switch:
// `build.py` builds each width as a library of its own, with no layout
// class of the narrower widths, NERFACE_SAMPLE_CLASSES=0).
#ifndef NERFACE_SLICED_WIDTH
#define NERFACE_SLICED_WIDTH 0
#endif
static_assert(NERFACE_SLICED_WIDTH == 0 || NERFACE_SLICED_WIDTH == 768 || NERFACE_SLICED_WIDTH == MAX_WIDTH,
              "a sliced width");
constexpr int SLICE = 256;                // a slice of a layer's columns, both warpgroups'
constexpr int SLICE_WG = SLICE / CONSUMERS;  // a warpgroup's columns of a slice
constexpr int SSTAGE = KCH * SLICE * 2;   // a ring stage: a slice's columns of one 64-row chunk, 32 KB

template <int H>
struct Sliced {
  static constexpr int DH = H / 2;                     // layers_dir.0
  static constexpr int NS = H / SLICE;                 // slices of an h-wide layer or dX product
  static constexpr int DS = (DH + SLICE - 1) / SLICE;  // slices of layers_dir.0
  static constexpr int RING = H <= 768 ? 3 : 2;        // the stages the shared memory holds beside the image
};

// The first column of warpgroup wg's share of slice s.
__device__ __forceinline__ int slice_col(int s, int wg) { return s * SLICE + wg * SLICE_WG; }

// A unit's relu mask of an h-wide activation (h > 512): per 128-column
// block b (slice b / 2, warpgroup b % 2), 2 words a thread of the
// warpgroup (`store_mask_cols`); Layout::mask_bytes a unit, as at h ≤ 512.
template <int H>
__device__ __forceinline__ uint32_t* slice_mask(uint32_t* buf, int unit, int block) {
  return buf + (size_t)unit * (2 * H) + ((size_t)block * 128 + (threadIdx.x & 127)) * 2;
}

// `store_mask` / `apply_mask` for an N-wide accumulator fragment (N / 64
// words a thread).
template <int N>
__device__ __forceinline__ void store_mask_cols(uint32_t* dst, const uint32_t* a) {
  static_assert(N == 128, "2 words");
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
    const uint32_t lo = a[p] & 0xffffu, hi = a[p] >> 16;
    const uint32_t b = (lo - 1u < 0x7fffu ? 1u : 0u) | (hi - 1u < 0x7fffu ? 2u : 0u);
    w[p / 16] |= b << (2 * (p % 16));
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}
template <int N>
__device__ __forceinline__ void apply_mask_cols(float* acc, const uint2& m) {
  static_assert(N == 128, "2 words");
  const uint32_t w[2] = {m.x, m.y};
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!((w[p / 16] >> (2 * (p % 16) + e)) & 1u)) acc[2 * p + e] = 0.f;
  }
}

// `add_sigma` over N columns: bf16(g_σ) ⊗ wa + acc.
template <int N>
__device__ __forceinline__ void add_sigma_cols(float* acc, const float* gs, const float* wa) {
  const int r0 = k1::frag_row();
  const float g0 = round_bf16(gs[r0 * 4 + 3]), g1 = round_bf16(gs[(r0 + 8) * 4 + 3]);
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
    const float g = (p & 1) ? g1 : g0;
    const int col = k1::fold_col(2 * (p >> 1));
    acc[2 * p] = g * wa[col] + acc[2 * p];
    acc[2 * p + 1] = g * wa[col + 1] + acc[2 * p + 1];
  }
}

// The producer's loads of one layer whose chunk images (k rows, n columns)
// are at `src`: slice by slice, each of its k / 64 chunks into the next
// stage (the slice's columns of the chunk: its image's rows 256·s .. +256,
// fewer in a last slice past n).
template <int RING, class Smem>
__device__ __forceinline__ void load_slices(Smem& sm, Ring& ring, const bf16* src, int k, int n) {
  for (int s = 0; s * SLICE < n; ++s) {
    const uint32_t bytes = (n - s * SLICE < SLICE ? n - s * SLICE : SLICE) * ROW_BYTES;
    for (int c = 0; c < k / KCH; ++c) {
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], bytes);
      bulk_load(sm.ring[ring.stage], src + ((size_t)c * KCH * n + (size_t)s * SLICE * KCH), bytes,
                &sm.full[ring.stage]);
      ring.advance<RING>();
    }
  }
}

// Warpgroup wg's 128 columns of one slice of a product: acc = A·W[:, those
// columns], A (K = NCH·xc·64) the image at shared address `a_img`, W's
// slice through the ring (the warpgroup's columns 128·wg rows into a
// stage). The first wgmma overwrites acc.
template <int NCH, int RING, class Smem, class Release>
__device__ __forceinline__ void slice_product(float* acc, uint32_t a_img, Smem& sm, Ring& ring, int wg,
                                              const Release& release, int xc = 1) {
  uint32_t* no_a = nullptr;  // every chunk's A comes from the image
  auto stages = reinterpret_cast<unsigned char(*)[SSTAGE]>(sm.ring[0] + wg * SLICE_WG * ROW_BYTES);
  chain_layer<SLICE_WG, NCH, NCH, RING, true, 0, SSTAGE>(acc, no_a, a_img, stages, sm.full, ring, release, xc);
}

// The parked slices (`cols` columns of the layer) into the image at `img`,
// once both warpgroups' products that read it are done; afterwards the
// image is whole.
template <int NS>
__device__ __forceinline__ void slice_exchange(unsigned char* img, uint32_t (*park)[SLICE_WG / 4], int wg, int cols) {
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (slice_col(s, wg) < cols) k1::store_frag<SLICE_WG>(img + slice_col(s, wg) * ROW_BYTES, park[s]);
  fence_proxy_async();  // the image is read by wgmma
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
}

// A head's f32 sums over the thread's parked columns of `slices` slices
// (`cols` columns), w the f32 weight rows (CH columns a row): d[2·h + ch]
// for row half h, summed over the thread's quad.
template <int NS, int CH>
__device__ __forceinline__ void head_sums(float* d, const uint32_t (*park)[SLICE_WG / 4], const float* w, int wg,
                                          int cols) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 2 * CH; ++i) d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (slice_col(s, wg) >= cols) continue;
#pragma unroll
    for (int p = 0; p < SLICE_WG / 4; ++p) {
      const float2 v = unpack_bf16(park[s][p]);
      const float* wr = w + (slice_col(s, wg) + 8 * (p >> 1) + c2) * CH;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) d[(p & 1) * CH + ch] += v.x * wr[ch] + v.y * wr[CH + ch];
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * CH; ++i) {
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 1);
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 2);
  }
}

template <int H>
struct alignas(ATOM_BYTES) SlicedFwdSmem {
  unsigned char ring[Sliced<H>::RING][SSTAGE];  // weight slices
  unsigned char xch[H * ROW_BYTES];             // the layer's output, both warpgroups' columns: the next product's A
  // a unit's [xyz; PE; 0], both warpgroups' A of layer1: two buffers of one
  // block, or one of both past 10 bands (`xin_buf`)
  unsigned char xin[2][XIN_BYTES];
  float wa[H];                                  // the heads' bf16 weights as f32
  float wrgb[H / 2 * 3];
  float heads[CONSUMERS][64][4];                // each warpgroup's partial [rgb, σ] of the unit's rows
  uint64_t full[Sliced<H>::RING];
  uint64_t empty[Sliced<H>::RING];
  uint64_t xin_full[2];
  uint64_t xin_empty[2];
};
static_assert(sizeof(SlicedFwdSmem<768>) + ATOM_BYTES <= 232448 && sizeof(SlicedFwdSmem<1024>) + ATOM_BYTES <= 232448,
              "shared memory");

// The producer: each unit's slices, W1 (L.kx rows), WH_0..WH_{n-1}, WF,
// WD0.
template <int H>
__device__ __forceinline__ void sliced_fwd_produce(SlicedFwdSmem<H>& sm, const FwdArgs& a, const Layout& L,
                                                   int n_items) {
  const UnitSchedule<0, 1> g{a.l};
  Ring ring;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load_slices<Sliced<H>::RING>(sm, ring, a.W + Offsets<H>::FW_OFF_W1, L.kx, H);
      for (int i = 0; i < a.n_hidden; ++i) load_slices<Sliced<H>::RING>(sm, ring, a.W + L.wh + (size_t)i * H * H, H, H);
      load_slices<Sliced<H>::RING>(sm, ring, a.W + L.wf, H, H);
      load_slices<Sliced<H>::RING>(sm, ring, a.W + L.wd0, H, H / 2);
    }
  }
}

// A consumer warpgroup's share of each unit (`wide_fwd_consume` in
// slices): its columns of every slice of every layer, parked and
// exchanged, then (K4f) its partial heads, warpgroup 0 storing the raw
// rows, or (SAVE, the recompute) its columns of each activation and mask to
// the workspace. Row i < rows() of an item is row ray0·S + i of the pass; a
// padding row, or a row of a ray past the last, is computed and not stored.
template <int H, bool SAVE>
__device__ __forceinline__ void sliced_fwd_consume(SlicedFwdSmem<H>& sm, const FwdArgs& a, int wg, int n_items) {
  using Z = Sliced<H>;
  using OZ = Offsets<H>;
  constexpr int NS = Z::NS, DS = Z::DS, DH = Z::DH, RING = Z::RING;
  const UnitSchedule<0, 1> g{a.l};
  const int t = threadIdx.x & 127;
  const int r0 = k1::frag_row();
  const int n = a.n_hidden;
  const int xc = g.xc();  // xin's blocks, W1's chunks
  const Workspace& ws = a.ws;
  auto release = [&](int stage) {
    if (t == 0) mbar_arrive(&sm.empty[stage]);
  };
  const uint32_t xch = smem_u32(sm.xch);
  int units = 0;  // units taken, for the xin buffer and its phase
  Ring ring;
  float acc[SLICE_WG / 2];
  uint32_t park[NS][SLICE_WG / 4];  // the warpgroup's bf16 columns of each slice of the layer
#pragma unroll
  for (int i = 0; i < SLICE_WG / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < SLICE_WG / 4; ++i) park[s][i] = 0u;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int ray0 = item * g.wg_rays();
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u) {
      const int unit = item * g.units() + u;
      const int b = xin_buf(units, xc);
      mbar_wait(&sm.xin_full[b], xin_phase(units, xc));
#pragma unroll
      for (int s = 0; s < NS; ++s) {  // layer1: NO relu
        const int c0 = slice_col(s, wg);
        slice_product<1, RING>(acc, smem_u32(sm.xin[b]), sm, ring, wg, release, xc);
        acc_to_a<SLICE_WG, false>(acc, park[s], ChainBias{a.F + OZ::FF_OFF_V0 + c0});
        if (SAVE) k1::store_frag<SLICE_WG>(unit_image(ws.act(0), H, unit) + c0 * ROW_BYTES, park[s]);
      }
      if (t == 0) mbar_arrive(&sm.xin_empty[b]);  // layer1 is its only reader
      ++units;
      slice_exchange<NS>(sm.xch, park, wg, H);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int c0 = slice_col(s, wg);
          slice_product<H / KCH, RING>(acc, xch, sm, ring, wg, release);
          acc_to_a<SLICE_WG, true>(acc, park[s], ChainBias{a.F + OZ::FF_OFF_BH + i * H + c0});
          if (SAVE) {
            k1::store_frag<SLICE_WG>(unit_image(ws.act(i + 1), H, unit) + c0 * ROW_BYTES, park[s]);
            store_mask_cols<SLICE_WG>(slice_mask<H>(ws.amask(i), unit, 2 * s + wg), park[s]);
          }
        }
        slice_exchange<NS>(sm.xch, park, wg, H);
      }
      // σ off the trunk: the warpgroup's parked columns of a_n against wa
      float hs[2];
      if constexpr (!SAVE) head_sums<NS, 1>(hs, park, sm.wa, wg, H);
#pragma unroll
      for (int s = 0; s < NS; ++s) {  // feat
        const int c0 = slice_col(s, wg);
        slice_product<H / KCH, RING>(acc, xch, sm, ring, wg, release);
        acc_to_a<SLICE_WG, true>(acc, park[s], ChainBias{a.F + OZ::FF_OFF_BF + c0});
        if (SAVE) {
          k1::store_frag<SLICE_WG>(unit_image(ws.feat, H, unit) + c0 * ROW_BYTES, park[s]);
          store_mask_cols<SLICE_WG>(slice_mask<H>(ws.fmask, unit, 2 * s + wg), park[s]);
        }
      }
      slice_exchange<NS>(sm.xch, park, wg, H);
      // x0 = relu(feat·WD0 + bd0 + the ray's direction contribution), the
      // rays of the thread's rows worked out here; a padding row's is n_rays
      const int i0 = u * 64 + r0, rows = g.rows();
      const int ray_h[2] = {i0 < rows ? ray0 + g.ray_of(i0) : a.n_rays,
                            i0 + 8 < rows ? ray0 + g.ray_of(i0 + 8) : a.n_rays};
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const int c0 = slice_col(s, wg);
        if (c0 < DH) {
          auto dir_row = [&](int ray) { return ray < a.n_rays ? a.dir_c + (size_t)ray * DH + c0 : nullptr; };
          slice_product<H / KCH, RING>(acc, xch, sm, ring, wg, release);
          acc_to_a<SLICE_WG, true>(acc, park[s],
                                   ChainDirRows{a.F + OZ::FF_OFF_BD0 + c0, {dir_row(ray_h[0]), dir_row(ray_h[1])}});
          if (SAVE) k1::store_frag<SLICE_WG>(unit_image(ws.x0, DH, unit) + c0 * ROW_BYTES, park[s]);
        } else {  // h = 768: the last slice is warpgroup 0's alone
          skip_stages<RING>(sm, ring, H / KCH, release);
        }
      }
      if constexpr (!SAVE) {
        float hc[6];
        head_sums<DS, 3>(hc, park, sm.wrgb, wg, DH);
        // the quad's lane 0 holds its rows' sums
        if ((threadIdx.x & 3) == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* hp = sm.heads[wg][r0 + 8 * h];
            hp[0] = hc[3 * h];
            hp[1] = hc[3 * h + 1];
            hp[2] = hc[3 * h + 2];
            hp[3] = hs[h];
          }
        }
        named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
        if (wg == 0 && t < 64) {
          const int i = u * 64 + t;  // the item's row
          if (i < rows && ray0 + g.ray_of(i) < a.n_rays) {
            const float* p0 = sm.heads[0][t];
            const float* p1 = sm.heads[1][t];
            const float* f = a.F;
            *reinterpret_cast<float4*>(a.out + ((size_t)ray0 * g.samples() + i) * 4) =
                make_float4(p0[0] + p1[0] + f[OZ::FF_OFF_BRGB], p0[1] + p1[1] + f[OZ::FF_OFF_BRGB + 1],
                            p0[2] + p1[2] + f[OZ::FF_OFF_BRGB + 2], p0[3] + p1[3] + f[OZ::FF_OFF_BA]);
          }
        }
      }
    }
  }
}

template <int H, bool SAVE>
__global__ void __launch_bounds__(FLEX_THREADS, 1) sliced_chain_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  SlicedFwdSmem<H>& sm = *reinterpret_cast<SlicedFwdSmem<H>*>(smem_raw + pad);
  const UnitSchedule<0, 1> g{a.l};
  const int t = threadIdx.x;
  const Layout L = flex_layout<H>(a.n_hidden, K_XIN * g.xc());
  if constexpr (!SAVE) {
    for (int i = t; i < H; i += FLEX_THREADS) sm.wa[i] = __bfloat162float(a.W[L.wa + i]);
    for (int i = t; i < H / 2 * 3; i += FLEX_THREADS) sm.wrgb[i] = __bfloat162float(a.W[L.wrgb + i]);
  }
  if (t == 0) {
    for (int s = 0; s < Sliced<H>::RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.xin_full[b], ENCODERS * 32);
      mbar_init(&sm.xin_empty[b], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      sliced_fwd_produce<H>(sm, a, L, n_items);
    } else if (w >= 1 && w <= ENCODERS) {
      wide_encode<H>(g, sm, a, n_items, t - CONSUMERS * 128 - 32, SAVE ? a.ws.xin : nullptr);
    }
  } else {
    reg_alloc<232>();
    sliced_fwd_consume<H, SAVE>(sm, a, wg, n_items);
  }
}

template <int H, bool SAVE>
int launch_sliced_chain(const FwdArgs& a, cudaStream_t st) {
  auto kernel = sliced_chain_kernel<H, SAVE>;
  constexpr size_t bytes = sizeof(SlicedFwdSmem<H>) + ATOM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<wide_ctas(a.n_rays, a.l.S), FLEX_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int H>
struct alignas(ATOM_BYTES) SlicedDxSmem {
  unsigned char ring[Sliced<H>::RING][SSTAGE];  // transposed weights' slices
  unsigned char atile[H * ROW_BYTES];           // the unit's cotangent, both warpgroups' columns: the next product's A
  float wa[H];                                  // the heads' bf16 weights as f32
  float wrgb[H / 2 * 3];
  float g[2][64 * 4];                           // a unit's cotangent rows [rgb, σ], by unit parity
  // a warpgroup's d_dir pieces of a 128-column block of x0, by the parity
  // of the blocks it has taken (as DxSmem's)
  float dsum[CONSUMERS][2][4][2][DIR_HIDDEN];
  float dacc[CONSUMERS][2][DIR_HIDDEN];         // d_dir of a ray's rows in earlier units, the warpgroup's blocks
  uint64_t full[Sliced<H>::RING];
  uint64_t empty[Sliced<H>::RING];
};
static_assert(sizeof(SlicedDxSmem<768>) + ATOM_BYTES <= 232448 && sizeof(SlicedDxSmem<1024>) + ATOM_BYTES <= 232448,
              "shared memory");

// The producer: each unit's dX slices, WD0ᵀ, WFᵀ, WH_{n-1}ᵀ..WH_0ᵀ.
template <int H>
__device__ __forceinline__ void sliced_dx_produce(SlicedDxSmem<H>& sm, const DxArgs& a, int n_items) {
  using OZ = Offsets<H>;
  const UnitSchedule<0, 1> g{a.l};
  Ring ring;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int u = 0; u < g.units(); ++u) {
      load_slices<Sliced<H>::RING>(sm, ring, a.WT + OZ::FT_OFF_WD0T, H / 2, H);
      load_slices<Sliced<H>::RING>(sm, ring, a.WT + OZ::FT_OFF_WFT, H, H);
      for (int i = a.n_hidden - 1; i >= 0; --i)
        load_slices<Sliced<H>::RING>(sm, ring, a.WT + OZ::FT_OFF_WHT + (size_t)i * H * H, H, H);
    }
  }
}

// One dX product of a unit (`wide_dx_product` in slices): each slice's
// warpgroup columns of A·Wᵀ, A (K = NCH·64) the cotangent image, then the σ
// head's cotangent (SIGMA), the mask (MASKED: the 128-column block's words
// at `mask`, loaded before the product), the bf16 cotangent parked and
// stored to `gout`, its f32 column sums into the warp's partial row at
// `part`; then, unless it is the unit's LAST product, the parked slices
// into the image for the next.
template <int H, int NCH, bool MASKED, bool SIGMA, bool LAST, class Release>
__device__ __forceinline__ void sliced_dx_product(float* acc, uint32_t (*park)[SLICE_WG / 4], SlicedDxSmem<H>& sm,
                                                  int wg, Ring& ring, const Release& release, uint32_t* mask, int unit,
                                                  unsigned char* gout, float* part, const float* gs) {
  constexpr int NS = Sliced<H>::NS;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c0 = slice_col(s, wg);
    uint2 m = make_uint2(0u, 0u);
    if constexpr (MASKED) m = *reinterpret_cast<const uint2*>(slice_mask<H>(mask, unit, 2 * s + wg));
    slice_product<NCH, Sliced<H>::RING>(acc, smem_u32(sm.atile), sm, ring, wg, release);
    if constexpr (SIGMA) add_sigma_cols<SLICE_WG>(acc, gs, sm.wa + c0);
    if constexpr (MASKED) apply_mask_cols<SLICE_WG>(acc, m);
#pragma unroll
    for (int p = 0; p < SLICE_WG / 4; ++p) park[s][p] = pack_bf16(acc[2 * p], acc[2 * p + 1]);
    k1::store_frag<SLICE_WG>(gout + c0 * ROW_BYTES, park[s]);
    k1::colsum<SLICE_WG>(acc, part + c0, true);
  }
  if constexpr (!LAST) slice_exchange<NS>(sm.atile, park, wg, H);
}

// The dX chain of a unit at h = 768 / 1024 (`wide_dx_unit`): the unit's
// cotangent rows staged once for both warpgroups; the heads, gx0 and d_dir
// over each of the warpgroup's blocks (`dx_heads` on a_n's 256 columns
// [256·i, +256) and x0's 128 [128·i, +128), i = wg, wg + 2 below h / 256),
// gx0 into the image and the workspace; then every product.
template <int H, class Release>
__device__ __forceinline__ void sliced_dx_unit(SlicedDxSmem<H>& sm, const DxArgs& a, const Layout& L, Ring& ring,
                                               float* acc, uint32_t (*park)[SLICE_WG / 4], int wg, int u, int unit,
                                               int ray0, float* part, int& dx_units, int& dx_blocks,
                                               const Release& release) {
  using OZ = Offsets<H>;
  constexpr int DH = H / 2, NB = H / SLICE;
  const UnitSchedule<0, 1> g{a.l};
  const Workspace& ws = a.ws;
  const int n = a.n_hidden;
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
  float* gs = sm.g[dx_units & 1];
  ++dx_units;
  auto img = [&](unsigned char* buf) { return unit_image(buf, H, unit); };
  if (wg == 0 && t < 64) {
    const int i = u * 64 + t;  // the item's row
    const bool valid = i < g.rows() && ray0 + g.ray_of(i) < a.n_rays;
    const size_t row = (size_t)ray0 * g.samples() + i;
    reinterpret_cast<float4*>(gs)[t] =
        valid ? *reinterpret_cast<const float4*>(a.g + row * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the rows whole; both warpgroups are past the previous unit's last
  // product, so the image is free
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = wg + 2 * j;
    if (i >= NB) continue;
    dx_heads(sm.wrgb + DIR_HIDDEN * i * 3, img(ws.act(n)) + HIDDEN * i * ROW_BYTES,
             unit_image(ws.x0, DH, unit) + DIR_HIDDEN * i * ROW_BYTES, gs, acc, part, L.f_total + HIDDEN * i,
             L.f_total + H + DIR_HIDDEN * i * 3, part + OZ::FF_OFF_BA, i == 0);
    float(*ds)[2][DIR_HIDDEN] = sm.dsum[wg][dx_blocks & 1];
    float* d_dir = a.d_dir + (size_t)ray0 * DH + DIR_HIDDEN * i;  // the item's first ray's row, the block's columns
    if (g.samples() % 16 != 0)
      k1::DirPieces<UnitSchedule<0, 1>, DH>{ds[lw], d_dir, g, u, ray0, a.n_rays, true}(acc);
    uint32_t gx[DIR_HIDDEN / 4];
#pragma unroll
    for (int p = 0; p < DIR_HIDDEN / 4; ++p) gx[p] = pack_bf16(acc[2 * p], acc[2 * p + 1]);
    k1::store_frag<DIR_HIDDEN>(sm.atile + DIR_HIDDEN * i * ROW_BYTES, gx);
    k1::store_frag<DIR_HIDDEN>(unit_image(ws.gx0, DH, unit) + DIR_HIDDEN * i * ROW_BYTES, gx);
    k1::colsum<DIR_HIDDEN>(acc, part + OZ::FF_OFF_BD0 + DIR_HIDDEN * i, true);
    // d_dir: a warp of one ray's piece is its column sums (acc[0, 4) of
    // each lane); the pieces summed over each ray's warps and units in order
    const k1::WarpRays wr(u, lw, g);
    if (wr.fa >= 0 && wr.fa == wr.fb) {
      const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll
      for (int k = 0; k < DIR_HIDDEN / 32; ++k) ds[lw][0][k1::fold_col(base + k)] = acc[k];
    }
    named_bar_sync(BAR_WG + wg, 128);
    k1::dir_pieces<DH>(ds, sm.dacc[wg][j], d_dir, g, u, ray0, a.n_rays, true, t);
    ++dx_blocks;
  }
  fence_proxy_async();  // gx0's image is read by wgmma
  named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
  // g_feat = bf16(gx0)·WD0ᵀ ⊙ [feat > 0]; then as `dx_unit`
  sliced_dx_product<H, DH / KCH, true, false, false>(acc, park, sm, wg, ring, release, ws.fmask, unit, img(ws.gfeat),
                                                     part + OZ::FF_OFF_BF, gs);
  if (n > 0) {
    sliced_dx_product<H, H / KCH, true, true, false>(acc, park, sm, wg, ring, release, ws.amask(n - 1), unit,
                                                     img(ws.gpre(n - 1)), part + OZ::FF_OFF_BH + (n - 1) * H, gs);
#pragma unroll 1
    for (int i = n - 1; i >= 1; --i)
      sliced_dx_product<H, H / KCH, true, false, false>(acc, park, sm, wg, ring, release, ws.amask(i - 1), unit,
                                                        img(ws.gpre(i - 1)), part + OZ::FF_OFF_BH + (i - 1) * H, gs);
    sliced_dx_product<H, H / KCH, false, false, true>(acc, park, sm, wg, ring, release, nullptr, unit, img(ws.ga0),
                                                      part + OZ::FF_OFF_V0, gs);
  } else {
    sliced_dx_product<H, H / KCH, false, true, true>(acc, park, sm, wg, ring, release, nullptr, unit, img(ws.ga0),
                                                     part + OZ::FF_OFF_V0, gs);
  }
}

template <int H>
__global__ void __launch_bounds__(FLEX_THREADS, 1) sliced_dx_kernel(const DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  SlicedDxSmem<H>& sm = *reinterpret_cast<SlicedDxSmem<H>*>(smem_raw + pad);
  const UnitSchedule<0, 1> g{a.l};
  const int t = threadIdx.x;
  const Layout L = flex_layout<H>(a.n_hidden, K_XIN * g.xc());
  for (int i = t; i < H; i += FLEX_THREADS) sm.wa[i] = __bfloat162float(a.W[L.wa + i]);
  for (int i = t; i < H / 2 * 3; i += FLEX_THREADS) sm.wrgb[i] = __bfloat162float(a.W[L.wrgb + i]);
  if (t == 0) {
    for (int s = 0; s < Sliced<H>::RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  // each consumer warp's running partial row starts at zero
  float* part = nullptr;
  if (t < CONSUMERS * 128) {
    part = a.ws.warp_part + ((size_t)blockIdx.x * WARPS_A_CTA + (t >> 5)) * L.part_cols;
    for (int c = t & 31; c < L.part_cols; c += 32) part[c] = 0.f;
    __syncwarp();
  }
  __syncthreads();

  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    if (t == CONSUMERS * 128) sliced_dx_produce<H>(sm, a, n_items);
  } else {
    reg_alloc<232>();
    auto release = [&](int stage) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
    };
    int dx_units = 0, dx_blocks = 0;
    Ring ring;
    // 64 accumulators a slice; `dx_heads` and DirPieces use up to 96
    float acc[SLICE_WG / 2 + 32];
    uint32_t park[Sliced<H>::NS][SLICE_WG / 4];
#pragma unroll
    for (int i = 0; i < SLICE_WG / 2 + 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int s = 0; s < Sliced<H>::NS; ++s)
#pragma unroll
      for (int i = 0; i < SLICE_WG / 4; ++i) park[s][i] = 0u;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
#pragma unroll 1
      for (int u = 0; u < g.units(); ++u)
        sliced_dx_unit<H>(sm, a, L, ring, acc, park, wg, u, item * g.units() + u, item * g.wg_rays(), part, dx_units,
                          dx_blocks, release);
    }
    // the CTA's partial row: its warps' rows added in order
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
    const float* rows = a.ws.warp_part + (size_t)blockIdx.x * WARPS_A_CTA * L.part_cols;
    for (int c = t; c < L.part_cols; c += CONSUMERS * 128) {
      float s = 0.f;
      for (int w = 0; w < WARPS_A_CTA; ++w) s += rows[(size_t)w * L.part_cols + c];
      a.ws.tile_part[(size_t)blockIdx.x * L.part_cols + c] = s;
    }
  }
}

template <int H>
int launch_sliced_backward(const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
  int err = launch_sliced_chain<H, true>(fa, st);
  if (err != 0) return err;
  auto kernel = sliced_dx_kernel<H>;
  constexpr size_t bytes = sizeof(SlicedDxSmem<H>) + ATOM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<wide_ctas(da.n_rays, da.l.S), FLEX_THREADS, bytes, st>>>(da);
  return (int)cudaGetLastError();
}

// K4f / K4b at h = 768 and 1024: the runtime layout class at any S, each
// width in a build of its own (NERFACE_SLICED_WIDTH: `build.py`
// compiles them beside the layout-class builds, in parallel); every other
// build refuses them.
int sliced_forward(int hidden, const FwdArgs& a, cudaStream_t st) {
#if NERFACE_SLICED_WIDTH
  if (hidden == NERFACE_SLICED_WIDTH) return launch_sliced_chain<NERFACE_SLICED_WIDTH, false>(a, st);
#endif
  return (int)cudaErrorInvalidValue;
}
int sliced_backward(int hidden, const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
#if NERFACE_SLICED_WIDTH
  if (hidden == NERFACE_SLICED_WIDTH) return launch_sliced_backward<NERFACE_SLICED_WIDTH>(fa, da, st);
#endif
  return (int)cudaErrorInvalidValue;
}

// -- the entry points ---------------------------------------------------------------

// `dispatch_pass`'s functions (mma_tile.cuh: the pass's layout class SF,
// in the build that holds it); its model flag here is the width: false h
// = 256, true h = 512. Every build holds both widths.
template <int SF, bool WIDE_H>
struct Forward {
  static int run(const FwdArgs& a, cudaStream_t st) {
    if constexpr (WIDE_H) {
      return launch_wide_chain<SF, false>(a, st);
    } else {
      return launch_chain<SF, false>(a, st);
    }
  }
};
template <int SF, bool WIDE_H>
struct Backward {
  static int run(const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
    if constexpr (WIDE_H) {
      return launch_wide_backward<SF>(fa, da, st);
    } else {
      return launch_backward<SF>(fa, da, st);
    }
  }
};

// What the kernels take: S in 1..MAX_SAMPLES, 1..FLEX_MAX_FREQS bands (up
// to K_XIN_WIDE columns, `xin_extent`), hidden width a multiple of HIDDEN up
// to MAX_WIDTH (256 and 512 each with its own kernels, 768 and 1024 the
// sliced ones; no width falls back on another's), any number n ≥ 0 of
// hidden layers whose offsets fit an int.
bool valid(int n_rays, int n_samples, int n_freqs, int n_hidden, int hidden) {
  return n_rays >= 0 && n_samples >= 1 && n_samples <= MAX_SAMPLES && n_freqs >= 1 &&
         3 + 6 * n_freqs <= K_XIN_WIDE && hidden >= HIDDEN && hidden <= MAX_WIDTH && hidden % HIDDEN == 0 &&
         n_hidden >= 0 && (long long)(n_hidden + 4) * hidden * hidden * 2 < (1ll << 31);
}

// the layout of a width `valid` admits
Layout layout_of(int hidden, int n_hidden, int kx) {
  if (hidden == MAX_WIDTH) return flex_layout<MAX_WIDTH>(n_hidden, kx);
  if (hidden == 768) return flex_layout<768>(n_hidden, kx);
  return hidden == WIDE ? flex_layout<WIDE>(n_hidden, kx) : flex_layout<HIDDEN>(n_hidden, kx);
}

// h = 256: two items a round; every wider h: both warpgroups on each unit
int ctas_of(int hidden, int n_rays, int n_samples) {
  return hidden > HIDDEN ? wide_ctas(n_rays, n_samples) : flex_ctas(n_rays, n_samples);
}

}  // namespace

// Shared memory a CTA of each kernel takes (dynamic, with the 1 KB
// alignment pad): out[0] flex_chain_kernel, out[1] flex_dx_kernel, out[2]
// dw_wgmma_kernel, out[3] wide_chain_kernel, out[4] wide_dx_kernel (h =
// 512), out[5] / out[6] sliced_chain_kernel / sliced_dx_kernel at h = 768,
// out[7] / out[8] at 1024.
extern "C" void nerface_fused_flex_shared_bytes(long long* out) {
  out[0] = (long long)FWD_SMEM_BYTES;
  out[1] = (long long)DX_SMEM_BYTES;
  out[2] = (long long)DWG_SMEM_BYTES;
  out[3] = (long long)WIDE_FWD_SMEM_BYTES;
  out[4] = (long long)WIDE_DX_SMEM_BYTES;
  out[5] = (long long)(sizeof(SlicedFwdSmem<768>) + ATOM_BYTES);
  out[6] = (long long)(sizeof(SlicedDxSmem<768>) + ATOM_BYTES);
  out[7] = (long long)(sizeof(SlicedFwdSmem<MAX_WIDTH>) + ATOM_BYTES);
  out[8] = (long long)(sizeof(SlicedDxSmem<MAX_WIDTH>) + ATOM_BYTES);
}

// K4f. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for what
// `valid` refuses, or for a width or an S whose layout class this build
// does not hold). Launches on `stream`, does not synchronise and allocates
// nothing. W is the forward weights' chunk images (Offsets<hidden>::FW_OFF_*
// offsets at the bands' extent, `flex_w_off`), F the bias rows and bands
// (FF_OFF_*).
extern "C" int nerface_fused_flex_fwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const float* F, float* out,
                                      int n_rays, int n_samples, int n_freqs, int n_hidden, int hidden,
                                      void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden, hidden)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int xc = xin_extent(n_freqs) / K_XIN;
  FwdArgs fa{ro,    rd,     z,     dir_c, static_cast<const bf16*>(W), F, out, Workspace{}, n_rays,
             UnitLayout::of(n_samples, xc), n_freqs, n_hidden};
  if (hidden > WIDE) return sliced_forward(hidden, fa, static_cast<cudaStream_t>(stream));
  return dispatch_pass<Forward>(n_samples, hidden == WIDE, xc, fa, static_cast<cudaStream_t>(stream));
}

// Bytes of device workspace one K4b call needs (-1 for what `valid`
// refuses): its xin image and W1's dW product are the bands' extent wide.
extern "C" long long nerface_fused_flex_workspace_bytes(int n_rays, int n_samples, int n_freqs, int n_hidden,
                                                        int hidden) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden, hidden)) return -1;
  return (long long)carve(nullptr, k1::pass_units(n_rays, n_samples), ctas_of(hidden, n_rays, n_samples),
                          layout_of(hidden, n_hidden, xin_extent(n_freqs)), nullptr);
}

// K4b: the gradients of Σ g·out. Returns a cudaError_t (0 on success; as
// K4f's for what it does not take).
// Launches on `stream`, does not synchronise and allocates nothing:
// `workspace` holds nerface_fused_flex_workspace_bytes(...) bytes. W and
// WT are the forward and the transposed weights' chunk images; dW is the
// f32 gradient in the packed weight layout (w_offsets at the bands'
// extent), dF in the
// bias-row layout (its V0 row holds d_v0; FREQS is 0), d_dir (R, h / 2).
extern "C" int nerface_fused_flex_bwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const void* WT,
                                      const float* F, const float* g, float* dW, float* dF,
                                      float* d_dir, void* workspace, int n_rays, int n_samples,
                                      int n_freqs, int n_hidden, int hidden, void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden, hidden)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int units = k1::pass_units(n_rays, n_samples), ctas = ctas_of(hidden, n_rays, n_samples);
  const int kx = xin_extent(n_freqs), xc = kx / K_XIN;
  const Layout L = layout_of(hidden, n_hidden, kx);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), units, ctas, L, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const UnitLayout l = UnitLayout::of(n_samples, xc);
  FwdArgs fa{ro, rd, z, dir_c, Wb, F, nullptr, ws, n_rays, l, n_freqs, n_hidden};
  DxArgs da{g, Wb, static_cast<const bf16*>(WT), d_dir, ws, n_rays, l, n_hidden};
  int err = hidden > WIDE ? sliced_backward(hidden, fa, da, st)
                          : dispatch_pass<Backward>(n_samples, hidden == WIDE, xc, fa, da, st);
  if (err != 0) return err;
  // dW from the images (`dw_products`), DWG_MATS_MAX products a launch
  const int segs = dw_segments_of(L, units);
  DwgMat mats[DWG_MATS_MAX];
  int n_mats = 0;
  auto flush = [&]() {
    if (err == 0 && n_mats > 0) err = launch_dw_wgmma(mats, n_mats, ws.dw_part, L.wa, units, segs, st);
    n_mats = 0;
  };
  dw_products(ws, L, [&](const DwgMat& m) {
    if (n_mats == DWG_MATS_MAX) flush();
    mats[n_mats++] = m;
  });
  flush();
  if (err != 0) return err;
  reduce_rows<<<(L.wa + 255) / 256, 256, 0, st>>>(ws.dw_part, segs, L.wa, L.wa, dW, nullptr);
  reduce_rows<<<(L.part_cols + 255) / 256, 256, 0, st>>>(ws.tile_part, ctas, L.part_cols, L.f_total, dF,
                                                        dW + L.wa);
  return (int)cudaGetLastError();
}
