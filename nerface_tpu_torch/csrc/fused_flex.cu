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
// (64 bf16 columns), a_0 = that @ W1 + v0 with NO activation (`layer1`, a
// reference quirk; v0 is its bias with the per-frame conditioning folded
// in), a_{i+1} = relu(a_i @ WH_i + bh_i) for the n hidden layers (0 ≤ n ≤
// MAX_HIDDEN, a runtime argument), then σ = a_n · wa + ba off the trunk
// (not off feat, unlike the paper model), feat = relu(a_n @ WF + bf), x0 =
// relu(feat @ WD0 + bd0 + the ray's direction contribution), rgb = x0 @
// wrgb + brgb. Out: raw (R, S, 4) [rgb, σ]; the compositing stays with the
// caller, as in the JAX package.
//
// K4f, `flex_chain_kernel<S, false>`, is K2's chain without the cluster
// (wgmma_chain.cuh): one persistent 384-thread CTA an SM. The producer
// warpgroup's first thread streams each unit's 1 + 4n + 4 + 4 weight chunk
// images through a ring of RING 32 KB stages with bulk copies, its three
// encoder warps fill each unit's swizzled [xyz; PE; 0] tile; the two
// consumer warpgroups run free of each other over whole rays as 64-row
// units, each layer one chain of wgmma m64n256k16 (m64n128k16 for
// layers_dir.0's feat columns) with A in registers: layer1 reads xin from
// shared memory (K = 63 packed to 64), every epilogue rounds its
// accumulator pairs to bf16 exactly where the plain version does and they
// are the next product's A fragment. The σ head is an m64n8 wgmma off
// a_n's A registers before fc_feat overwrites them, the rgb head one off
// x0's; the raw rows go out as float4s.
//
// K4b is four kinds of launch on the caller's stream, no float atomics,
// every partition fixed by the shape, so two calls on the same inputs give
// bit-identical gradients:
//   1. the recompute, `flex_chain_kernel<S, true>`: K4f's kernel with the
//      save flag (the serving instantiation has no save code), storing xin,
//      a_0..a_n, feat and x0 to the workspace as wgmma operand images (per
//      64-row unit, 64-column blocks in the 128-byte swizzle,
//      paper_train.cuh's `image_offset`, 16-byte stores after
//      `quad_transpose`) and the relu masks of a_1..a_n and feat as bits
//      in the accumulator fragment's order (`store_mask`), no heads;
//   2. `flex_dx_kernel<S>`, persistent, two consumer warpgroups, the
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
//      d_dir = Σ gx0 over a ray's rows;
//   3. `dw_wgmma_kernel` (wgmma_dw.cuh): dW = Xᵀ·bf16(gY) for W1 (K = 64),
//      WF, WD0 and every WH_i from the images, in row segments that fill
//      one wave;
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
// K4b is 1.838 MFLOP a sample (recompute 0.623, dX 0.591, dW 0.623), 0.731
// ms for a train step's pair (2048 rays at S = 64 + 128). Its workspace,
// which the TPU kernel never moves, holds ≈ 5.9 KB a row at n = 3, written
// once and read by dX and dW: for the pair's fine pass a byte floor of
// 0.24 / 0.29 / 0.43 ms (recompute / dX / dW) above the operations bound
// of 0.165 / 0.157 / 0.165. chip_smoke.py's `[flex_kernel]` prints each
// launch's device time beside both, apart.
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

constexpr int MAX_HIDDEN = 8;

// Packed operand offsets, in elements. They must equal w_offsets /
// f_offsets / wt_offsets in ops/kernels/fused_flex.py (a CPU test checks
// it). bf16 weights, (in, out): W1 = [w1a; w1b; 0], WF, WD0, WH_i at
// FW_OFF_WH + i·HIDDEN², each as its chunk images, then WA and WRGB
// row-major.
constexpr int FW_OFF_W1 = 0;
constexpr int FW_OFF_WF = 16384;
constexpr int FW_OFF_WD0 = 81920;
constexpr int FW_OFF_WH = 114688;
// f32 rows: V0, BF, BD0, BA, BRGB, FREQS, then BH_i at FF_OFF_BH + i·HIDDEN.
constexpr int FF_OFF_V0 = 0;
constexpr int FF_OFF_BF = 256;
constexpr int FF_OFF_BD0 = 512;
constexpr int FF_OFF_BA = 640;
constexpr int FF_OFF_BRGB = 641;
constexpr int FF_OFF_FREQS = 644;
constexpr int FF_OFF_BH = 660;
// transposed weights, (out, in), each as its chunk images (K = out, N =
// in): WD0T, WFT, WHT_i at FT_OFF_WHT + i·HIDDEN².
constexpr int FT_OFF_WD0T = 0;
constexpr int FT_OFF_WFT = 32768;
constexpr int FT_OFF_WHT = 98304;
static_assert(FW_OFF_WF - FW_OFF_W1 == K_XIN * HIDDEN && FW_OFF_WD0 - FW_OFF_WF == HIDDEN * HIDDEN &&
                  FW_OFF_WH - FW_OFF_WD0 == HIDDEN * DIR_HIDDEN,
              "weight layout");
static_assert(FF_OFF_BD0 - FF_OFF_BF == HIDDEN && FF_OFF_BA - FF_OFF_BD0 == DIR_HIDDEN &&
                  FF_OFF_FREQS - FF_OFF_BRGB == 3 && FF_OFF_BH - FF_OFF_FREQS == 16,
              "bias row layout");
static_assert(FT_OFF_WFT - FT_OFF_WD0T == DIR_HIDDEN * HIDDEN && FT_OFF_WHT - FT_OFF_WFT == HIDDEN * HIDDEN,
              "transposed layout");

constexpr int HH = HIDDEN * HIDDEN;
constexpr int FF_MAX = FF_OFF_BH + MAX_HIDDEN * HIDDEN;
constexpr int RING = 5;                          // weight stages
constexpr int CONSUMERS = CHAIN_CONSUMERS;       // warpgroups computing units
constexpr int ENCODERS = CHAIN_ENCODERS;         // warps of the producer warpgroup that encode
constexpr int FLEX_THREADS = 128 * (CONSUMERS + 1);
constexpr int WARPS_A_CTA = 4 * CONSUMERS;
constexpr int BAR_WG = 1;                        // + warpgroup: that warpgroup's named barrier
constexpr int BAR_CONSUMERS = 3;                 // both consumer warpgroups

// The offsets that depend on the number of hidden layers n.
struct Layout {
  int n;
  int wa, wrgb;  // WA, WRGB after the WH_i
  int f_total;
  int part_cols;  // a partial row: the f32 rows, then WA and WRGB
};

__host__ __device__ inline Layout flex_layout(int n) {
  Layout L;
  L.n = n;
  L.wa = FW_OFF_WH + n * HH;
  L.wrgb = L.wa + HIDDEN;
  L.f_total = FF_OFF_BH + n * HIDDEN;
  L.part_cols = L.f_total + HIDDEN + DIR_HIDDEN * 3;
  return L;
}

// dW's products' X widths (W1, WF, WD0, WH_i), and the row segments that
// fill one wave with them.
int dw_segments_of(int n) {
  int kdims[3 + MAX_HIDDEN] = {K_XIN, HIDDEN, HIDDEN};
  for (int i = 0; i < n; ++i) kdims[3 + i] = HIDDEN;
  return dw_segments(kdims, 3 + n);
}

// The backward's workspace. Each bf16 buffer holds one matrix of the pass
// as wgmma operand images: per 64-row unit, its 64-column blocks of 64
// rows in the 128-byte swizzle (k1::image_offset), `width` · 128 bytes a
// unit. The order is the carve's, mirrored by `workspace_buffers` and
// `mask_buffers` in ops/kernels/fused_flex.py.
struct Workspace {
  unsigned char* xin;                    // K_XIN
  unsigned char* act[MAX_HIDDEN + 1];    // a_0..a_n
  unsigned char* feat;
  unsigned char* x0;                     // DIR_HIDDEN
  unsigned char* gx0;                    // DIR_HIDDEN
  unsigned char* gfeat;
  unsigned char* gpre[MAX_HIDDEN];       // the cotangents of WH_i's outputs before the relu
  unsigned char* ga0;                    // the cotangent of a_0
  // the relu masks dX applies, as bits in the fragment's order (MASK_BYTES
  // a unit): feat's, and a_1..a_n's at amask[i - 1]
  uint32_t* fmask;
  uint32_t* amask[MAX_HIDDEN];
  float* warp_part;                      // (ctas · WARPS_A_CTA, part_cols): each warp's running sums
  float* tile_part;                      // (ctas, part_cols): a CTA's sums
  float* dw_part;                        // (dw segments, wa)
};

__host__ __device__ __forceinline__ unsigned char* unit_image(unsigned char* buf, int width, int unit) {
  return buf + (size_t)unit * width * ROW_BYTES;
}

// A 256-wide activation's relu mask of one unit, as bits: the warpgroup's
// thread t holds the 128 elements of its accumulator fragment (pairs p,
// k1::frag_row / fold_col) and keeps them in words [4t, 4t + 4): bit
// 2·(p % 16) + e of word p / 16 is element e of pair p > 0. The recompute
// and dX hold the same elements in the same threads.
constexpr int MASK_BYTES = 128 * HIDDEN / 64 * 4;  // 2 KB

__device__ __forceinline__ uint32_t* unit_mask(uint32_t* buf, int unit) {
  return buf + (size_t)unit * (MASK_BYTES / 4) + 4 * (threadIdx.x & 127);
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

// Lays the workspace out from `base` (or only measures it when base is
// null); returns its size in bytes.
size_t carve(unsigned char* base, int units, int ctas, const Layout& L, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  auto img = [&](int width) { return static_cast<unsigned char*>(take((size_t)units * width * ROW_BYTES)); };
  Workspace w = {};
  w.xin = img(K_XIN);
  for (int i = 0; i <= L.n; ++i) w.act[i] = img(HIDDEN);
  w.feat = img(HIDDEN);
  w.x0 = img(DIR_HIDDEN);
  w.gx0 = img(DIR_HIDDEN);
  w.gfeat = img(HIDDEN);
  for (int i = 0; i < L.n; ++i) w.gpre[i] = img(HIDDEN);
  w.ga0 = img(HIDDEN);
  auto bits = [&]() { return static_cast<uint32_t*>(take((size_t)units * MASK_BYTES)); };
  w.fmask = bits();
  for (int i = 0; i < L.n; ++i) w.amask[i] = bits();
  w.warp_part = static_cast<float*>(take((size_t)ctas * WARPS_A_CTA * L.part_cols * sizeof(float)));
  w.tile_part = static_cast<float*>(take((size_t)ctas * L.part_cols * sizeof(float)));
  w.dw_part = static_cast<float*>(take((size_t)dw_segments_of(L.n) * L.wa * sizeof(float)));
  if (ws) *ws = w;
  return off;
}

// -- K4f and the recompute ------------------------------------------------------

struct FwdArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // the forward weights' chunk images (FW_OFF_*)
  const float* F;      // bias rows + frequency bands (FF_OFF_*)
  float* out;          // (R, S, 4), or null in the recompute
  Workspace ws;        // the recompute's images, or all null
  int n_rays, n_freqs, n_hidden;
};

struct alignas(ATOM_BYTES) FwdSmem {
  unsigned char ring[RING][CHAIN_STAGE];  // weight chunk images
  unsigned char xin[CONSUMERS][2][XIN_BYTES];
  unsigned char wa8[HIDDEN / KCH][8 * ROW_BYTES];  // the heads' weights padded to 8 columns
  unsigned char wrgb8[DIR_HIDDEN / KCH][8 * ROW_BYTES];
  float f[FF_MAX];
  uint64_t full[RING];
  uint64_t empty[RING];
  uint64_t xin_full[CONSUMERS][2];
  uint64_t xin_empty[CONSUMERS][2];
};
constexpr size_t FWD_SMEM_BYTES = sizeof(FwdSmem) + ATOM_BYTES;  // + the alignment pad
static_assert(FWD_SMEM_BYTES <= 232448, "shared memory");

// One layer of a consumer warpgroup (`chain_layer` on this CTA's ring):
// with FRESH (the recompute, whose epilogues also store) the
// accumulators' old values are dead and only the A registers the layer
// reads are fenced; K4f keeps K2's form (a FRESH build of it reads the
// same on the card).
template <int N, int NCH, int X_CHUNKS, bool FRESH, class Smem, class Release>
__device__ __forceinline__ void layer(float* acc, uint32_t* a, uint32_t xin, Smem& sm, Ring& ring,
                                      const Release& release) {
  chain_layer<N, NCH, X_CHUNKS, RING, FRESH, FRESH ? (KCH / 4) * (NCH - X_CHUNKS) : 64>(acc, a, xin, sm.ring, sm.full,
                                                                                       ring, release);
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

// The producer: each unit's chunks, W1, WH_0..WH_{n-1}, WF, WD0.
template <int S>
__device__ __forceinline__ void fwd_produce(FwdSmem& sm, const FwdArgs& a, int n_rounds) {
  Ring ring;
  auto load = [&](int off, int k, int n) {
    load_layer<RING, 1>(sm.ring, sm.full, sm.empty, ring, a.W + off, k, n, 0);
  };
  for (int round = blockIdx.x; round < n_rounds; round += gridDim.x) {
    for (int u = 0; u < Schedule<S, 1>::UNITS; ++u) {
      load(FW_OFF_W1, K_XIN, HIDDEN);
      for (int i = 0; i < a.n_hidden; ++i) load(FW_OFF_WH + i * HH, HIDDEN, HIDDEN);
      load(FW_OFF_WF, HIDDEN, HIDDEN);
      load(FW_OFF_WD0, HIDDEN, DIR_HIDDEN);
    }
  }
}

// A consumer warpgroup over its units: the chain, then (K4f) the heads and
// the raw rows out, or (SAVE, the recompute) each activation to its
// workspace image. A warpgroup whose rays are past the last walks the same
// chunks: K4f computes them and stores nothing, the recompute waits for
// and releases them untouched.
template <int S, bool SAVE>
__device__ __forceinline__ void fwd_consume(FwdSmem& sm, const FwdArgs& a, int wg, int n_rounds) {
  using G = Schedule<S, 1>;
  constexpr bool FRESH = SAVE;
  const int lane = threadIdx.x & 31;
  const int r0 = k1::frag_row();  // the thread's accumulator rows: r0 and r0 + 8 of a unit, in one ray
  const int n = a.n_hidden;
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
    const int item = G::item(round, 0, wg);
    const int ray0 = item * G::WG_RAYS;
    const bool live = ray0 < a.n_rays;
#pragma unroll 1
    for (int u = 0; u < G::UNITS; ++u) {
      const int unit = item * G::UNITS + u;
      const int ray = ray0 + (u * 64 + r0) / S;
      const int b = units & 1;
      if (SAVE && !live) {  // the recompute stores nothing of a dead unit: skip its chunks
        // thread 0 alone takes the xin buffer, as skip_stages the ring
        if ((threadIdx.x & 127) == 0) {
          mbar_wait(&sm.xin_full[wg][b], (units >> 1) & 1);
          mbar_arrive(&sm.xin_empty[wg][b]);
        }
        ++units;
        skip_stages<RING>(sm, ring, 1 + 4 * n + 4 + 4, release);
        continue;
      }
      mbar_wait(&sm.xin_full[wg][b], (units >> 1) & 1);
      const uint32_t xin = smem_u32(sm.xin[wg][b]);
      layer<HIDDEN, 1, 1, FRESH>(acc, act, xin, sm, ring, release);
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.xin_empty[wg][b]);  // layer1 is its only reader
      ++units;
      acc_to_a<HIDDEN, false>(acc, act, ChainBias{sm.f + FF_OFF_V0});  // layer1: NO relu
      if (SAVE) k1::store_frag<HIDDEN>(unit_image(ws.act[0], HIDDEN, unit), act);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        layer<HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
        acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + FF_OFF_BH + i * HIDDEN});
        if (SAVE) {
          k1::store_frag<HIDDEN>(unit_image(ws.act[i + 1], HIDDEN, unit), act);
          store_mask(unit_mask(ws.amask[i], unit), act);
        }
      }
      // σ off the trunk: a_n's A registers against wa padded to 8 columns
      float hs[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!SAVE) chain_head<HIDDEN>(hs, act, smem_u32(sm.wa8));
      layer<HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + FF_OFF_BF});  // feat
      if (SAVE) {
        k1::store_frag<HIDDEN>(unit_image(ws.feat, HIDDEN, unit), act);
        store_mask(unit_mask(ws.fmask, unit), act);
      }
      const float* dir_c = ray < a.n_rays ? a.dir_c + (size_t)ray * DIR_HIDDEN : nullptr;
      layer<DIR_HIDDEN, 4, 0, FRESH>(acc, act, xin, sm, ring, release);
      acc_to_a<DIR_HIDDEN, true>(acc, act, ChainDir{sm.f + FF_OFF_BD0, dir_c});  // x0
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
          const int row = u * 64 + r0 + 8 * h;
          if ((lane & 3) == 0 && ray < a.n_rays)
            *reinterpret_cast<float4*>(a.out + ((size_t)ray0 * S + row) * 4) =
                make_float4(hc[2 * h] + sm.f[FF_OFF_BRGB], hc[2 * h + 1] + sm.f[FF_OFF_BRGB + 1],
                            b2 + sm.f[FF_OFF_BRGB + 2], hs[2 * h] + sm.f[FF_OFF_BA]);
        }
      }
    }
  }
}

template <int S, bool SAVE>
__global__ void __launch_bounds__(FLEX_THREADS, 1) flex_chain_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw + pad);
  using G = Schedule<S, 1>;
  const int t = threadIdx.x;
  const Layout L = flex_layout(a.n_hidden);
  for (int i = t; i < L.f_total; i += FLEX_THREADS) sm.f[i] = a.F[i];
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

  const int n_rounds = G::rounds(a.n_rays);
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      fwd_produce<S>(sm, a, n_rounds);
    } else if (w >= 1 && w <= ENCODERS) {
      const int e = t - CONSUMERS * 128 - 32;
      if constexpr (SAVE) {
        // the recompute also stores each live unit's xin image
        encode_units<S, 1>(sm.xin, sm.xin_full, sm.xin_empty, a, sm.f + FF_OFF_FREQS, 0, blockIdx.x, gridDim.x,
                           n_rounds, e, [&](int item, int u) -> unsigned char* {
                             return item * G::WG_RAYS < a.n_rays ? unit_image(a.ws.xin, K_XIN, item * G::UNITS + u)
                                                                 : nullptr;
                           });
      } else {
        encode_units<S, 1>(sm.xin, sm.xin_full, sm.xin_empty, a, sm.f + FF_OFF_FREQS, 0, blockIdx.x, gridDim.x,
                           n_rounds, e, [](int, int) -> unsigned char* { return nullptr; });
      }
    }
  } else {
    reg_alloc<232>();
    fwd_consume<S, SAVE>(sm, a, wg, n_rounds);
  }
}

// CTAs of a pass: one a round of two warpgroups' items, at most one an SM
// (the persistent grid; k1::pass_ctas, which K1 shares).
int flex_ctas(int n_rays, int n_samples) { return k1::pass_ctas(n_rays, n_samples); }

template <int S, bool SAVE>
int launch_chain(const FwdArgs& a, cudaStream_t st) {
  auto kernel = flex_chain_kernel<S, SAVE>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<flex_ctas(a.n_rays, S), FLEX_THREADS, FWD_SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

// -- K4b's dX chain ---------------------------------------------------------------

struct DxArgs {
  const float* g;   // (R, S, 4): the cotangent of [rgb, σ]
  const bf16* W;    // the forward weights (WA and WRGB, row-major)
  const bf16* WT;   // the transposed weights' chunk images (FT_OFF_*)
  float* d_dir;     // (R, 128)
  Workspace ws;
  int n_rays, n_hidden;
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
  float dsum[CONSUMERS][2][4][DIR_HIDDEN];   // a unit's per-warp d_dir sums, by unit parity
  float dacc[CONSUMERS][DIR_HIDDEN];         // d_dir of a ray's first unit (S = 128)
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
template <int S>
__device__ __forceinline__ void dx_produce(DxSmem& sm, const DxArgs& a, int n_pairs) {
  Ring ring;
  auto load = [&](int off, int k) {
    load_layer<DX_RING, 1>(sm.ring, sm.full, sm.empty, ring, a.WT + off, k, HIDDEN, 0);
  };
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    for (int u = 0; u < Schedule<S, 1>::UNITS; ++u) {
      load(FT_OFF_WD0T, DIR_HIDDEN);
      load(FT_OFF_WFT, HIDDEN);
      for (int i = a.n_hidden - 1; i >= 0; --i) load(FT_OFF_WHT + i * HH, HIDDEN);
    }
  }
}

// The heads' parts of a unit's dX, before its first product (K1's
// `dx_heads` with a_n for feat and x0 for x2): the WA sums a_nᵀ·bf16(g_σ)
// and WRGB sums x0ᵀ·bf16(g_rgb) into the warp's partial row, the σ / rgb
// biases' sums, and gx0 = bf16(g_rgb)·Wrgbᵀ ⊙ [x0 > 0] into acc[0, 64).
__device__ __forceinline__ void dx_heads(const DxSmem& sm, const unsigned char* an, const unsigned char* x0img,
                                         const float* gs, float* acc, float* part, int wa_col, int wrgb_col) {
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
      const float* w = sm.wrgb + (col + e) * 3;
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
  if (lw == 0 && lane < 4) {
    float s = 0.f;
    for (int r = 0; r < 64; ++r) s += gs[r * 4 + (lane < 3 ? lane : 3)];
    part[lane < 3 ? FF_OFF_BRGB + lane : FF_OFF_BA] += s;
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
// thread, once the tile's previous copy has read it.
template <int N>
__device__ __forceinline__ void dx_store(float* acc, unsigned char* tile, unsigned char* gout, float* part, int wg) {
  const int t = threadIdx.x & 127, r0 = k1::frag_row(), c2 = 2 * (threadIdx.x & 3);
  if (t == 0) bulk_wait_read();
  named_bar_sync(BAR_WG + wg, 128);
#pragma unroll
  for (int p = 0; p < N / 4; ++p)
    *reinterpret_cast<uint32_t*>(tile + k1::image_offset(r0 + 8 * (p & 1), 8 * (p >> 1) + c2)) =
        pack_bf16(acc[2 * p], acc[2 * p + 1]);
  fence_proxy_async();  // the tile is read by wgmma and the bulk store
  k1::colsum<N>(acc, part, true);
  named_bar_sync(BAR_WG + wg, 128);
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

// The dX chain of one live unit (rows [64·unit, +64) of the pass, of the
// item whose first ray is ray0): its cotangent rows staged in shared
// memory, the heads, gx0 and d_dir of the unit's rays, then each product.
template <int S, class Release>
__device__ __forceinline__ void dx_unit(DxSmem& sm, const DxArgs& a, const Layout& L, Ring& ring, float* acc, int wg,
                                        int u, int unit, int ray0, float* part, int& dx_units, const Release& release) {
  const Workspace& ws = a.ws;
  const int n = a.n_hidden;
  const int t = threadIdx.x & 127;
  float* gs = sm.g[wg][dx_units & 1];
  auto img = [&](unsigned char* buf) { return unit_image(buf, HIDDEN, unit); };
  if (t < 64) {
    const bool valid = ray0 + (u * 64 + t) / S < a.n_rays;
    const size_t row = (size_t)ray0 * S + u * 64 + t;
    reinterpret_cast<float4*>(gs)[t] =
        valid ? *reinterpret_cast<const float4*>(a.g + row * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  named_bar_sync(BAR_WG + wg, 128);
  dx_heads(sm, img(ws.act[n]), unit_image(ws.x0, DIR_HIDDEN, unit), gs, acc, part, L.f_total, L.f_total + HIDDEN);
  dx_store<DIR_HIDDEN>(acc, sm.atile[wg], unit_image(ws.gx0, DIR_HIDDEN, unit), part + FF_OFF_BD0, wg);
  // d_dir: the warps' column sums of gx0 (acc[0, 4) of each lane) summed
  // over the ray's warps in order
  {
    const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
    float* ds = sm.dsum[wg][dx_units & 1][lw];
    const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll
    for (int k = 0; k < DIR_HIDDEN / 32; ++k) ds[k1::fold_col(base + k)] = acc[k];
    named_bar_sync(BAR_WG + wg, 128);
    const float(*d)[DIR_HIDDEN] = sm.dsum[wg][dx_units & 1];
    if constexpr (S == 32) {
      // two rays a unit: warps 0-1 and 2-3
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ray = ray0 + r;
        if (ray < a.n_rays) a.d_dir[(size_t)ray * DIR_HIDDEN + t] = d[2 * r][t] + d[2 * r + 1][t];
      }
    } else {
      const float s = ((d[0][t] + d[1][t]) + d[2][t]) + d[3][t];
      if (S == 64 || u == 1) {
        a.d_dir[(size_t)ray0 * DIR_HIDDEN + t] = S == 64 ? s : sm.dacc[wg][t] + s;
      } else {
        sm.dacc[wg][t] = s;
      }
    }
    ++dx_units;
  }
  // g_feat = bf16(gx0)·WD0ᵀ ⊙ [feat > 0]
  dx_product<DIR_HIDDEN / KCH, true, false>(acc, sm, wg, ring, release, unit_mask(ws.fmask, unit), img(ws.gfeat),
                                            part + FF_OFF_BF, gs);
  // a_n's cotangent, bf16(g_feat)·WFᵀ + bf16(g_σ) ⊗ wa: masked by a_n, or
  // unmasked when a_n is layer1's output (n = 0); then down the hidden
  // layers, g_{i-1} = bf16(g_i)·WH_iᵀ ⊙ [a_i > 0], and at i = 0 the
  // cotangent of layer1's output a_0, unmasked
  if (n > 0) {
    dx_product<HIDDEN / KCH, true, true>(acc, sm, wg, ring, release, unit_mask(ws.amask[n - 1], unit),
                                         img(ws.gpre[n - 1]), part + FF_OFF_BH + (n - 1) * HIDDEN, gs);
#pragma unroll 1
    for (int i = n - 1; i >= 1; --i)
      dx_product<HIDDEN / KCH, true, false>(acc, sm, wg, ring, release, unit_mask(ws.amask[i - 1], unit),
                                            img(ws.gpre[i - 1]), part + FF_OFF_BH + (i - 1) * HIDDEN, gs);
    dx_product<HIDDEN / KCH, false, false>(acc, sm, wg, ring, release, nullptr, img(ws.ga0), part + FF_OFF_V0, gs);
  } else {
    dx_product<HIDDEN / KCH, false, true>(acc, sm, wg, ring, release, nullptr, img(ws.ga0), part + FF_OFF_V0, gs);
  }
}

template <int S>
__device__ __forceinline__ void dx_consume(DxSmem& sm, const DxArgs& a, const Layout& L, int wg, int n_pairs,
                                           float* part) {
  using G = Schedule<S, 1>;
  auto release = [&](int stage) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
  };
  int dx_units = 0;
  Ring ring;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const int n_items = (a.n_rays + G::WG_RAYS - 1) / G::WG_RAYS;
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int item = G::item(pair, 0, wg);
#pragma unroll 1
    for (int u = 0; u < G::UNITS; ++u) {
      if (item < n_items) {
        // the heads' images of this warpgroup's next unit into L2, a unit ahead
        const int next_item = u + 1 < G::UNITS ? item : G::item(pair + gridDim.x, 0, wg);
        if (next_item < n_items) {
          const int next = next_item * G::UNITS + (u + 1 < G::UNITS ? u + 1 : 0);
          prefetch_l2(unit_image(a.ws.act[a.n_hidden], HIDDEN, next), ATILE_BYTES);
          prefetch_l2(unit_image(a.ws.x0, DIR_HIDDEN, next), ATILE_BYTES / 2);
        }
        dx_unit<S>(sm, a, L, ring, acc, wg, u, item * G::UNITS + u, item * G::WG_RAYS, part, dx_units, release);
      } else {  // past the last ray: the unit's chunks, untouched
        skip_stages<DX_RING>(sm, ring, DIR_HIDDEN / KCH + HIDDEN / KCH * (1 + a.n_hidden), release);
      }
    }
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();  // the last tile's copy is out before the CTA's memory goes
}

template <int S>
__global__ void __launch_bounds__(FLEX_THREADS, 1) flex_dx_kernel(const DxArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  DxSmem& sm = *reinterpret_cast<DxSmem*>(smem_raw + pad);
  const int t = threadIdx.x;
  const Layout L = flex_layout(a.n_hidden);
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

  const int n_pairs = Schedule<S, 1>::rounds(a.n_rays);
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    if (t == CONSUMERS * 128) dx_produce<S>(sm, a, n_pairs);
  } else {
    reg_alloc<232>();
    dx_consume<S>(sm, a, L, wg, n_pairs, part);
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
template <int S>
int launch_backward(const FwdArgs& fa, const DxArgs& da, cudaStream_t st) {
  int err = launch_chain<S, true>(fa, st);
  if (err != 0) return err;
  auto kernel = flex_dx_kernel<S>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DX_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<flex_ctas(da.n_rays, S), FLEX_THREADS, DX_SMEM_BYTES, st>>>(da);
  return (int)cudaGetLastError();
}

bool valid(int n_rays, int n_samples, int n_freqs, int n_hidden) {
  return n_rays >= 0 && n_freqs >= 1 && 3 + 6 * n_freqs <= K_XIN && n_hidden >= 0 &&
         n_hidden <= MAX_HIDDEN && (n_samples == 32 || n_samples == 64 || n_samples == 128);
}

}  // namespace

// Shared memory a CTA of each kernel takes (dynamic, with the 1 KB
// alignment pad): out[0] flex_chain_kernel, out[1] flex_dx_kernel, out[2]
// dw_wgmma_kernel.
extern "C" void nerface_fused_flex_shared_bytes(long long* out) {
  out[0] = (long long)FWD_SMEM_BYTES;
  out[1] = (long long)DX_SMEM_BYTES;
  out[2] = (long long)DWG_SMEM_BYTES;
}

// K4f. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. W is the forward weights' chunk images
// (FW_OFF_* offsets), F the bias rows and bands (FF_OFF_*).
extern "C" int nerface_fused_flex_fwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const float* F, float* out,
                                      int n_rays, int n_samples, int n_freqs, int n_hidden,
                                      void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  FwdArgs fa{ro, rd, z, dir_c, static_cast<const bf16*>(W), F, out, Workspace{}, n_rays, n_freqs, n_hidden};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_samples) {
    case 32:
      return launch_chain<32, false>(fa, st);
    case 64:
      return launch_chain<64, false>(fa, st);
    default:
      return launch_chain<128, false>(fa, st);
  }
}

// Bytes of device workspace one K4b call needs.
extern "C" long long nerface_fused_flex_workspace_bytes(int n_rays, int n_samples, int n_hidden) {
  if (!valid(n_rays, n_samples, 1, n_hidden)) return -1;
  return (long long)carve(nullptr, k1::pass_units(n_rays, n_samples), flex_ctas(n_rays, n_samples),
                          flex_layout(n_hidden), nullptr);
}

// K4b: the gradients of Σ g·out. Returns a cudaError_t (0 on success).
// Launches on `stream`, does not synchronise and allocates nothing:
// `workspace` holds nerface_fused_flex_workspace_bytes(...) bytes. W and
// WT are the forward and the transposed weights' chunk images; dW is the
// f32 gradient in the packed weight layout (w_offsets), dF in the
// bias-row layout (its V0 row holds d_v0; FREQS is 0), d_dir (R, 128).
extern "C" int nerface_fused_flex_bwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const void* WT,
                                      const float* F, const float* g, float* dW, float* dF,
                                      float* d_dir, void* workspace, int n_rays, int n_samples,
                                      int n_freqs, int n_hidden, void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int units = k1::pass_units(n_rays, n_samples), ctas = flex_ctas(n_rays, n_samples);
  const Layout L = flex_layout(n_hidden);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), units, ctas, L, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs fa{ro, rd, z, dir_c, Wb, F, nullptr, ws, n_rays, n_freqs, n_hidden};
  DxArgs da{g, Wb, static_cast<const bf16*>(WT), d_dir, ws, n_rays, n_hidden};
  int err;
  switch (n_samples) {
    case 32:
      err = launch_backward<32>(fa, da, st);
      break;
    case 64:
      err = launch_backward<64>(fa, da, st);
      break;
    default:
      err = launch_backward<128>(fa, da, st);
  }
  if (err != 0) return err;
  // dW = Xᵀ·bf16(gY) from the images: W1 (its xin rows, K = 64), WF, WD0, WH_i
  DwgMat mats[DWG_MATS_MAX];
  int n_mats = 0;
  mats[n_mats++] = {ws.xin, ws.ga0, K_XIN, HIDDEN, FW_OFF_W1};
  mats[n_mats++] = {ws.act[n_hidden], ws.gfeat, HIDDEN, HIDDEN, FW_OFF_WF};
  mats[n_mats++] = {ws.feat, ws.gx0, HIDDEN, DIR_HIDDEN, FW_OFF_WD0};
  for (int i = 0; i < n_hidden; ++i) mats[n_mats++] = {ws.act[i], ws.gpre[i], HIDDEN, HIDDEN, FW_OFF_WH + i * HH};
  const int segs = dw_segments_of(n_hidden);
  err = launch_dw_wgmma(mats, n_mats, ws.dw_part, L.wa, units, segs, st);
  if (err != 0) return err;
  reduce_rows<<<(L.wa + 255) / 256, 256, 0, st>>>(ws.dw_part, segs, L.wa, L.wa, dW, nullptr);
  reduce_rows<<<(L.part_cols + 255) / 256, 256, 0, st>>>(ws.tile_part, ctas, L.part_cols, L.f_total, dF,
                                                        dW + L.wa);
  return (int)cudaGetLastError();
}
