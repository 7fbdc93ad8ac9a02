// The paper model's training pass on Hopper (sm_90a), shared by K1
// (fused_train_pass.cu: MLP, compositing, the loss cotangent and the
// whole backward) and K3b (fused_paper_mlp.cu: the MLP's backward from
// autograd's cotangent g).
//
// A pass is four launches on the caller's stream:
//
//   1. train_pass_kernel<SF, SMALL, Policy>: one persistent CTA an SM
//      (K1_CTAS at most), 384 threads. The sample count S is 1..MAX_SAMPLES,
//      a constant of the layout class SF = 64 or 128, else (SF = 0) read at
//      run time. Per item of a consumer warpgroup (whole rays in 64-row
//      units, `UnitLayout` of wgmma_chain.cuh, padding rows after the last
//      ray's when S neither divides nor is a multiple of 64) it runs
//        - the forward chain of K2 (fused_paper_render.cu): wgmma m64n256k16
//          / m64n128k16 with A from registers, each epilogue's bf16 pairs
//          the next layer's A fragment, the weights' chunk images
//          (`pack_sm90_chunks`) streamed through a ring of RING 32 KB
//          stages by a producer thread with 1-D bulk copies, the encoder
//          warps filling xin; every bf16 activation is also stored to the
//          workspace;
//        - the middle, a policy: K1's compositing, loss cotangent and
//          compositing backward (fused_train_pass.cu), or K3b's read of
//          autograd's cotangent g (fused_paper_mlp.cu), giving each row's
//          f32 cotangents of raw σ and rgb, zero on a padding row (so it
//          adds nothing to dW, the bias sums or d_dir);
//        - the dX chain, on wgmma too: gy as bf16 A fragments in
//          registers, B the layer's Wᵀ as its own chunk images (the
//          transposed trunk through `pack_sm90_chunks`), streamed through
//          the same ring; the relu masks from the activations this
//          warpgroup stored a moment before (an L2 hit); each bf16
//          cotangent to the workspace;
//        - the bias and conditioning sums (f32 cotangents) and the σ / rgb
//          heads' weight sums, per warp (`colsum`); d_dir, each ray's sum
//          of its rows' f32 cotangents of the direction branch's input,
//          from per-warp pieces summed in row order (`dir_pieces`).
//   2. dw_wgmma_kernel (wgmma_dw.cuh): dW = Xᵀ·bf16(gY) for the 11
//      products (10 in the smaller model; W3 in two: its xin rows and its
//      h2 rows), read from the workspace's operand images.
//   3./4. reduce_rows (grad_tile.cuh): dW's row segments, and the CTAs'
//      partial rows (biases, cond0 / cond3, the heads' weights), each
//      added in a fixed order.
// No float atomics and every partition fixed by the shape: two calls on
// the same inputs give bit-identical gradients.
//
// A long item (S > ITEM_ROWS: one ray in up to 16 units) keeps its rows'
// raw σ / rgb and their f32 cotangents, 32 bytes a row, in the workspace
// (`Workspace::rows`, one slab a consumer warpgroup of each CTA: 8.7 MB
// at S = 1024, L2-resident) instead of shared memory, whose item rows
// hold ITEM_ROWS; K1's middle composites such a ray forward and back in
// segments of ITEM_ROWS samples (fused_train_pass.cu).
//
// The workspace belongs to the kernels. Each buffer (`WS_BUFFERS`, the
// order of WS_BUFFER_NAMES in ops/kernels/fused_train.py) holds one bf16
// matrix of the pass as wgmma operand images: per 64-row unit, its
// 64-column blocks of 64 rows in the 128-byte swizzle, 8 KB a block
// (`image_offset`). The forward and dX store whole 16-byte groups (a
// quad's four lanes trade their words with shuffles, `quad_transpose`),
// and dW loads a unit of a buffer with one bulk copy.
//
// Bounds on this card. The pass's operations are 2.885 MFLOP a sample
// (0.98 forward, 0.92 dX, 0.98 dW): 1.147 ms of the H100's bf16 dense
// peak for a train step's pair (2048 rays at S = 64 and 128). The
// workspace, which the TPU kernel never moves, adds ≈ 8.6 KB a row written
// and ≈ 8.3 KB read by dW: ≈ 6.6 GB for the pair, a floor of ≈ 2 ms at
// 3.35 TB/s. The design keeps the rest out of HBM: the activations' second
// read (the dX masks) comes from L2 (a persistent grid's working set, 132
// CTAs × 2 items × ≈ 4.3 KB × 64–128 rows, is a few MB of the 50 MB), the
// f32 head cotangents never leave shared memory, and the bias sums never
// leave the CTA until its last item.
//
// What bounds it now is neither: registers. A consumer thread holds 128
// f32 accumulators and 64 bf16 A registers, and ptxas spills 6.8–8.3 KB
// a thread in every instantiation of train_pass_kernel (the A registers,
// stored after their convert and reloaded around every ring wait), so the
// kernel runs at ≈ 100 TFLOP/s and the pair takes 8.8 ms as a bare launch
// on an H100 80GB HBM3 at 700 W (PERF.md §6), not the ≈ 2 ms floor.
// dw_wgmma_kernel spills nothing; at ≈ 30 % of its operations bound it is
// the smaller part. `chip_smoke.py`'s `[build]` prints the spills and any
// wgmma ptxas serialises (its C75xx notes) for every instantiation. A
// later version that keeps dW's operands out of HBM (dW per tile, with
// the accumulators spread over the CTAs) would move about half the bytes,
// once the registers no longer bound it.
//
// The bias sums stay sums of the f32 cotangents, as in the TPU kernel.
// Form: after a layer's epilogue each thread folds its two rows, the
// warp reduce-scatters the column sums over its eight row lanes (N/8 +
// N/16 + N/32 shuffles instead of an all-reduce's 3·N/4), and each lane
// adds its N/32 columns into the warp's running partial row in global
// memory (an L2 hit, only that lane ever touches them); at the end a CTA
// folds its 8 warps' rows into one, in order. Cost: ≈ 60 shuffles, 64
// adds and 4 float2 read-modify-writes a thread for a 256-wide layer,
// ≈ 2 % of the warpgroup's instruction slots, off the tensor cores and
// overlapped by the other warpgroup's products.
//
// SMALL is the smaller paper model (no layers_xyz.5): its forward skips
// W5, fc_feat's cotangent is masked by h4 directly, and W5 drops out of
// the dW list; its W5/B5 gradient slots are zero.

#pragma once

#include "grad_tile.cuh"
#include "wgmma_chain.cuh"
#include "wgmma_dw.cuh"
#include "wgmma_tile.cuh"

namespace nerface {

// Transposed trunk weights, (out, in), for the dX products, each as its
// chunk images (K = out, N = in). They must equal WT_OFFSETS in
// ops/kernels/fused_mlp.py.
constexpr int WT_OFF_WD2T = 0;
constexpr int WT_OFF_WD1T = 16384;
constexpr int WT_OFF_WD0T = 32768;
constexpr int WT_OFF_WFT = 65536;
constexpr int WT_OFF_W5T = 131072;
constexpr int WT_OFF_W4T = 196608;
constexpr int WT_OFF_W3HT = 262144;
constexpr int WT_OFF_W2T = 327680;
constexpr int WT_OFF_W1T = 393216;
constexpr int WT_OFF_TOTAL = 458752;

// A partial row: the F_LAYOUT columns (bias and conditioning sums), then
// WA (256) and WRGB (128·3).
constexpr int PART_WA = F_OFF_TOTAL;
constexpr int PART_WRGB = PART_WA + HIDDEN;
constexpr int PART_COLS = PART_WRGB + DIR_HIDDEN * 3;

namespace k1 {

using namespace sm90;

constexpr int K1_CTAS = 132;       // the persistent grid, at most: one CTA an H100 SM
constexpr int CONSUMERS = 2;       // warpgroups computing items
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int RING = 4;            // weight stages
constexpr int STAGE_BYTES = KCH * HIDDEN * 2;
constexpr int ENCODERS = 3;        // warps of the producer warpgroup that encode
constexpr int BAR_WG = 1;          // + warpgroup: that warpgroup's named barrier
constexpr int BAR_CONSUMERS = 3;   // both consumer warpgroups
constexpr int WARPS_A_CTA = 4 * CONSUMERS;
constexpr int BLOCK_BYTES = 64 * ROW_BYTES;  // a 64 × 64 image block

// The workspace's bf16 buffers and their widths; xin's is the pass's
// encoding extent kx (K_XIN, K_XIN_WIDE or K_XIN_XL).
enum WsBuffer {
  WS_XIN, WS_H0, WS_H1, WS_H2, WS_H3, WS_H4, WS_H5, WS_FEAT, WS_X0, WS_X1, WS_X2,
  WS_GX2, WS_GX1, WS_GX0, WS_GFEAT, WS_GH0, WS_GH1, WS_GH2, WS_GH3, WS_GH4, WS_GH5, WS_BUFFERS
};
__host__ __device__ constexpr int ws_width(int b, int kx) {
  return b == WS_XIN ? kx
                     : (b == WS_X0 || b == WS_X1 || b == WS_X2 || b == WS_GX2 || b == WS_GX1 || b == WS_GX0)
                           ? DIR_HIDDEN
                           : HIDDEN;
}

// Byte offset of element (row, col) of a unit's image (64 rows, width
// columns): its column block, then the swizzled row.
__host__ __device__ __forceinline__ int image_offset(int row, int col) {
  return (col >> 6) * BLOCK_BYTES + sw128(row, col & 63);
}

// The items of a pass at S samples a ray: `UnitLayout` (wgmma_chain.cuh),
// l.rays rays in l.units 64-row units an item (two rays a unit at S = 32,
// one at S = 64, one ray in two units at S = 128, 8 rays in 3 units at S =
// 24); consumer wg of CTA c takes item 2·pair + wg of its pairs c, c +
// gridDim.x, ... (`UnitSchedule<SF, 1>::item`, SF the layout class).
struct Geometry {
  UnitLayout l;
  __host__ __device__ explicit Geometry(int s) : l(UnitLayout::of(s)) {}
  __host__ __device__ int items(int n_rays) const { return (n_rays + l.rays - 1) / l.rays; }
  __host__ __device__ int pairs(int n_rays) const { return (items(n_rays) + CONSUMERS - 1) / CONSUMERS; }
};

inline int pass_units(int n_rays, int n_samples) {
  const Geometry g(n_samples);
  return g.items(n_rays) * g.l.units;
}
inline int pass_ctas(int n_rays, int n_samples) {
  const int pairs = Geometry(n_samples).pairs(n_rays);
  return pairs < K1_CTAS ? pairs : K1_CTAS;
}

struct Workspace {
  unsigned char* buf[WS_BUFFERS];  // unit images, units × width × 128 bytes each
  float* warp_part;                // (ctas · WARPS_A_CTA, PART_COLS): each warp's running sums
  float* tile_part;                // (ctas, PART_COLS): a CTA's sums
  float* dw_part;                  // (DWG_SEGS, w_off(W_OFF_WA, kx))
  float* rows;                     // a long item's rows: (ctas · CONSUMERS, 8 · 64 · units), else none
  int kx;                          // the encoding extent: xin's width
  __device__ __forceinline__ unsigned char* unit(int b, int u) const {
    return buf[b] + (size_t)u * ws_width(b, kx) * ROW_BYTES;
  }
};

// The f32 values of a long item's rows slab (`Workspace::rows`) at `units`
// units an item: σ, rgb, g_σ, g_rgb, 64·units rows each; 0 for an item of
// at most ITEM_ROWS rows, whose rows stay in shared memory.
__host__ __device__ inline int item_row_floats(int units) { return units * 64 > ITEM_ROWS ? 8 * 64 * units : 0; }

// Lays the workspace of a pass at encoding extent kx out from `base` (or
// only measures it when base is null); returns its size in bytes. An item
// is `item_units` units.
inline size_t carve(unsigned char* base, int units, int ctas, int kx, int item_units, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  Workspace w;
  for (int b = 0; b < WS_BUFFERS; ++b)
    w.buf[b] = static_cast<unsigned char*>(take((size_t)units * ws_width(b, kx) * ROW_BYTES));
  w.warp_part = static_cast<float*>(take((size_t)ctas * WARPS_A_CTA * PART_COLS * sizeof(float)));
  w.tile_part = static_cast<float*>(take((size_t)ctas * PART_COLS * sizeof(float)));
  w.dw_part = static_cast<float*>(take((size_t)DWG_SEGS * w_off(W_OFF_WA, kx) * sizeof(float)));
  w.rows = static_cast<float*>(take((size_t)ctas * CONSUMERS * item_row_floats(item_units) * sizeof(float)));
  w.kx = kx;
  if (ws) *ws = w;
  return off;
}

inline long long workspace_bytes(int n_rays, int n_samples, int kx) {
  return (long long)carve(nullptr, pass_units(n_rays, n_samples), pass_ctas(n_rays, n_samples), kx,
                          Geometry(n_samples).l.units, nullptr);
}

struct PassArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // the weights' chunk images (W_OFF_* offsets)
  const bf16* WT;      // the transposed trunk's chunk images (WT_OFF_*)
  const float* F;      // bias rows + frequency bands
  float* d_dir;        // (R, 128)
  Workspace ws;
  int n_rays;
  UnitLayout l;  // the pass's S, and its items' rays and units (host-computed; read from the
                 // argument space, they hold no register through the chains)
  int n_freqs;
};

// At xc = 3 (21..31 bands) the ring runs RING − 1 stages and the two
// three-block xin buffers take its last and run on into `xin` (`xin_at`,
// `ring_stages`): a fourth stage and three blocks a warpgroup together
// would overrun the 227 KB by the alignment pad.
struct alignas(ATOM_BYTES) Smem {
  unsigned char ring[RING][STAGE_BYTES];  // weight chunk images
  // two buffers, one of two blocks (`xin_buf`), or at xc = 3 one of three
  // from the ring's last stage on (`xin_at`)
  unsigned char xin[CONSUMERS][2][64 * ROW_BYTES];
  unsigned char wa8[HIDDEN / KCH][8 * ROW_BYTES];  // the heads' weights padded to 8 columns
  unsigned char wrgb8[DIR_HIDDEN / KCH][8 * ROW_BYTES];
  float f[F_OFF_TOTAL];
  float wa[HIDDEN];              // the heads' bf16 weights as f32, for dX
  float wrgb[DIR_HIDDEN * 3];
  // an item's raw σ / rgb and their f32 cotangents, per consumer warpgroup
  // (a long item's in the workspace: `item_rows`)
  float sigma[CONSUMERS][ITEM_ROWS];
  float rgb[CONSUMERS][ITEM_ROWS * 3];
  float gsig[CONSUMERS][ITEM_ROWS];
  float grgb[CONSUMERS][ITEM_ROWS * 3];
  // a unit's d_dir pieces, by unit parity: per warp, its first ray's
  // (slot 0) and, where its rows reach another ray, its last ray's (slot 1)
  float dsum[CONSUMERS][2][4][2][DIR_HIDDEN];
  float dacc[CONSUMERS][DIR_HIDDEN];  // d_dir of a ray's rows in earlier units
  uint64_t full[RING];
  uint64_t empty[RING];
  uint64_t xin_full[CONSUMERS][2];
  uint64_t xin_empty[CONSUMERS][2];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + ATOM_BYTES;  // + the alignment pad
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(STAGE_BYTES == CHAIN_STAGE && offsetof(Smem, xin) == offsetof(Smem, ring) + sizeof(Smem::ring),
              "xin follows the ring (`xin_at`)");

// Where consumer warpgroup wg keeps its item's rows' raw σ, rgb and their
// cotangents: shared memory, or a long item's slab of the workspace.
struct ItemRows {
  float *sigma, *rgb, *gsig, *grgb;
};
template <int SF>
__device__ __forceinline__ ItemRows item_rows(Smem& sm, const PassArgs& a, int wg) {
  const UnitSchedule<SF, 1> g{a.l};
  if (g.long_item()) {
    const int n = 64 * g.units();
    float* b = a.ws.rows + ((size_t)blockIdx.x * CONSUMERS + wg) * item_row_floats(g.units());
    return {b, b + n, b + 4 * n, b + 5 * n};
  }
  return {sm.sigma[wg], sm.rgb[wg], sm.gsig[wg], sm.grgb[wg]};
}

// -- the chunk sequence ---------------------------------------------------------

// Every chunk, in the consumers' order, of a round of `units` units: each
// unit's forward layers (W packed at encoding extent kx), then each unit's
// dX layers (WT: no encoding rows, the same at every extent). `fn(src, k,
// n)` takes one layer.
template <bool SMALL, class Fn>
__device__ __forceinline__ void round_layers(const bf16* W, const bf16* WT, int units, int kx, Fn&& fn) {
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    fn(W + W_OFF_W0, kx, HIDDEN);
    fn(W + w_off(W_OFF_W1, kx), HIDDEN, HIDDEN);
    fn(W + w_off(W_OFF_W2, kx), HIDDEN, HIDDEN);
    fn(W + w_off(W_OFF_W3, kx), kx + HIDDEN, HIDDEN);
    fn(W + w_off(W_OFF_W4, kx), HIDDEN, HIDDEN);
    if (!SMALL) fn(W + w_off(W_OFF_W5, kx), HIDDEN, HIDDEN);
    fn(W + w_off(W_OFF_WF, kx), HIDDEN, HIDDEN);
    fn(W + w_off(W_OFF_WD0, kx), HIDDEN, DIR_HIDDEN);
    fn(W + w_off(W_OFF_WD1, kx), DIR_HIDDEN, DIR_HIDDEN);
    fn(W + w_off(W_OFF_WD2, kx), DIR_HIDDEN, DIR_HIDDEN);
  }
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    fn(WT + WT_OFF_WD2T, DIR_HIDDEN, DIR_HIDDEN);
    fn(WT + WT_OFF_WD1T, DIR_HIDDEN, DIR_HIDDEN);
    fn(WT + WT_OFF_WD0T, DIR_HIDDEN, HIDDEN);
    fn(WT + WT_OFF_WFT, HIDDEN, HIDDEN);
    if (!SMALL) fn(WT + WT_OFF_W5T, HIDDEN, HIDDEN);
    fn(WT + WT_OFF_W4T, HIDDEN, HIDDEN);
    fn(WT + WT_OFF_W3HT, HIDDEN, HIDDEN);
    fn(WT + WT_OFF_W2T, HIDDEN, HIDDEN);
    fn(WT + WT_OFF_W1T, HIDDEN, HIDDEN);
  }
}

// The producer: every chunk of every round of this CTA, through the
// ring's stages at encoding extent kx (`ring_stages`).
template <bool SMALL>
__device__ __forceinline__ void produce(Smem& sm, const PassArgs& a, int n_pairs, int units, int kx) {
  Ring ring;
  const int stages = ring_stages<RING>(kx / K_XIN);
  auto load = [&](const bf16* src, int k, int n) {
    const uint32_t bytes = KCH * n * 2;
    for (int c = 0; c < k / KCH; ++c) {
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], bytes);
      bulk_load(sm.ring[ring.stage], src + c * KCH * n, bytes, &sm.full[ring.stage]);
      ring.advance(stages);
    }
  };
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) round_layers<SMALL>(a.W, a.WT, units, kx, load);
}

// One layer of a warpgroup's 64 rows: acc = A·B, `chain_layer` on this
// CTA's ring of `stages` (A: xin in shared memory for the first
// X_CHUNKS·xc chunks, then the registers a[] for NCH − X_CHUNKS); one
// chunk's group stays in flight while the previous stage is released. The
// accumulators' old values are dead: made constants (FRESH), they hold no
// register through the epilogue before. Only the A registers this layer
// read are fenced.
template <int N, int NCH, int X_CHUNKS>
__device__ __forceinline__ void layer(float* acc, uint32_t* a, uint32_t xin, Smem& sm, Ring& ring, int stages,
                                      int xc = 1) {
  chain_layer<N, NCH, X_CHUNKS, RING, true, (KCH / 4) * (NCH - X_CHUNKS), STAGE_BYTES>(
      acc, a, xin, sm.ring, sm.full, ring,
      [&](int stage) {
        if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[stage]);
      },
      xc, stages);
}

// A head: the m64n8 product of the K bf16 columns in a[] with a (K, 8)
// weight image at shared address `w`, into d.
template <int K>
__device__ __forceinline__ void head(float* d, uint32_t* a, uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s)
    wgmma_rs_n8(d, a + 4 * s, desc_k(w + (s >> 2) * 8 * ROW_BYTES + 32 * (s & 3)), s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<4>(d);
  fence_regs<K / 4>(a);
}

// -- fragments and images ---------------------------------------------------------

// The thread's first row of a warpgroup's 64-row unit (the second is + 8).
__device__ __forceinline__ int frag_row() { return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2); }

// A 4 × 4 transpose of 32-bit words across a quad: lane q's w[t] becomes
// lane t's w[q]. Two exchange stages of two shuffles.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    const bool hi = (q & b) != 0;
#pragma unroll
    for (int t0 = 0; t0 < 4; ++t0) {
      if (t0 & b) continue;
      const int t1 = t0 | b;
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, hi ? w[t0] : w[t1], b);
      if (hi) {
        w[t0] = recv;
      } else {
        w[t1] = recv;
      }
    }
  }
}

// A-fragment pairs a[p] (row frag_row() + 8·(p & 1), columns 8·(p >> 1) +
// 2·(lane % 4) + {0, 1}) of an N-wide unit into its image: a quad's lanes
// trade words so that each stores one whole 16-byte group.
template <int N>
__device__ __forceinline__ void store_frag(unsigned char* img, const uint32_t* a) {
  const int r0 = frag_row(), q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int bb = 0; bb < N / 32; ++bb) {
      uint32_t w[4] = {a[8 * bb + h], a[8 * bb + 2 + h], a[8 * bb + 4 + h], a[8 * bb + 6 + h]};
      quad_transpose(w);
      const int j = 4 * bb + q;  // the group this lane stores
      *reinterpret_cast<uint4*>(img + image_offset(r0 + 8 * h, 8 * j)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The inverse: the thread's pairs of an N-wide unit's image into a[], one
// 16-byte group a lane loaded and traded back.
template <int N>
__device__ __forceinline__ void load_frag(uint32_t* a, const unsigned char* img) {
  const int r0 = frag_row(), q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int bb = 0; bb < N / 32; ++bb) {
      const uint4 v = *reinterpret_cast<const uint4*>(img + image_offset(r0 + 8 * h, 8 * (4 * bb + q)));
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
      quad_transpose(w);
#pragma unroll
      for (int t = 0; t < 4; ++t) a[8 * bb + 2 * t + h] = w[t];
    }
  }
}

// -- column sums ---------------------------------------------------------------

// One stage of a reduce-scatter over lanes lane ^ L: each keeps half of
// v[0, NV) (the upper half where its bit L is set) plus the partner's.
template <int NV, int L>
__device__ __forceinline__ void scatter_stage(float* v) {
  const bool upper = (threadIdx.x & L) != 0;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float send = upper ? v[i] : v[i + NV / 2];
    const float keep = upper ? v[i + NV / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, L);
  }
}

// v[0, NV) summed over the eight lanes that share lane % 4 (a warp's 16
// rows); afterwards lane g·4 + q holds the sums of indices [g·NV/8,
// (g+1)·NV/8) in v[0, NV/8).
template <int NV>
__device__ __forceinline__ void scatter_sum(float* v) {
  scatter_stage<NV, 16>(v);
  scatter_stage<NV / 2, 8>(v);
  scatter_stage<NV / 4, 4>(v);
}

// The column of index i of a thread's folded accumulator (i = 2j + e:
// column pair group j, element e).
__device__ __forceinline__ int fold_col(int i) { return 8 * (i >> 1) + 2 * (threadIdx.x & 3) + (i & 1); }

// The f32 values in acc (64 × N, accumulator layout) summed over the
// warp's 16 rows and added into the warp's partial row `part` (+ the
// row's column offset): each thread folds its two rows in place (acc[2j +
// e], column fold_col(2j + e)), the warp reduce-scatters them
// (`scatter_sum`). acc is consumed: afterwards acc[0, N/32) holds this
// lane's column sums (columns fold_col(g·N/32 + k)).
template <int N>
__device__ __forceinline__ void colsum(float* acc, float* part, bool live) {
  constexpr int NV = N / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) acc[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
  }
  scatter_sum<NV>(acc);
  if (!live) return;
  const int base = ((threadIdx.x & 31) >> 2) * (NV / 8);
#pragma unroll
  for (int k = 0; k < NV / 8; k += 2) {
    float2* p = reinterpret_cast<float2*>(part + fold_col(base + k));
    float2 o = *p;
    o.x += acc[k];
    o.y += acc[k + 1];
    *p = o;
  }
}

// -- the forward ----------------------------------------------------------------

struct EpiBias {
  const float* bias;
  __device__ __forceinline__ float2 operator()(int, int col, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    return make_float2(v0 + b.x, v1 + b.y);
  }
};

// The direction branch's first epilogue: + bias and each row's ray's
// dir_c row (ChainDirRows: the thread's rows r0 and r0 + 8 may lie in two
// rays; null for a padding row or past the last ray).
using EpiDir = ChainDirRows;

// The encoder warps (ENCODERS · 32 threads, index e): every unit of both
// consumer warpgroups, in their order (`encode_units` of wgmma_chain.cuh
// on the pass's UnitSchedule<SF, 1>, whose item(pair, 0, wg) is 2·pair +
// wg), each into the next of the warpgroup's two xin buffers once its skip
// layer has released it, and into the workspace's xin image of a live item.
template <int SF>
__device__ __forceinline__ void encode(Smem& sm, const PassArgs& a, int n_pairs, int e) {
  const UnitSchedule<SF, 1> g{a.l};
  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  const int units = g.units();
  encode_units(g, [&](int wg, int b) { return xin_at(sm.xin, wg, b, g.xc()); }, sm.xin_full, sm.xin_empty, a,
               sm.f + F_OFF_FREQS, 0, blockIdx.x, gridDim.x, n_pairs, e,
               [&](int item, int u) -> unsigned char* {
                 return item < n_items ? a.ws.unit(WS_XIN, item * units + u) : nullptr;
               });
}

// The forward of one unit: K2's chain, each activation also stored to
// the workspace (when `live`), the raw σ and rgb of its rows into
// sigma / rgb (rows u·64 ..). The item's first ray is ray0; the rays of
// the thread's rows r0 and r0 + 8 are worked out at the direction branch.
template <int SF, bool SMALL>
__device__ __forceinline__ void forward_unit(Smem& sm, const PassArgs& a, Ring& ring, float* acc, uint32_t* act,
                                             int wg, int u, int unit, int ray0, bool live, int& units) {
  const UnitSchedule<SF, 1> g{a.l};
  const int b = xin_buf(units, g.xc());
  mbar_wait(&sm.xin_full[wg][b], xin_phase(units, g.xc()));
  const uint32_t xin = smem_u32(xin_at(sm.xin, wg, b, g.xc()));
  const Workspace& ws = a.ws;
  const int stages = ring_stages<RING>(g.xc());
  layer<HIDDEN, 1, 1>(acc, act, xin, sm, ring, stages, g.xc());
  acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_COND0});
  if (live) store_frag<HIDDEN>(ws.unit(WS_H0, unit), act);
  layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
  acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_B1});
  if (live) store_frag<HIDDEN>(ws.unit(WS_H1, unit), act);
  layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
  acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_B2});
  if (live) store_frag<HIDDEN>(ws.unit(WS_H2, unit), act);
  layer<HIDDEN, 5, 1>(acc, act, xin, sm, ring, stages, g.xc());  // the skip: [xin; h2]
  if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.xin_empty[wg][b]);
  ++units;
  acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_COND3});
  if (live) store_frag<HIDDEN>(ws.unit(WS_H3, unit), act);
  layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
  acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_B4});
  if (live) store_frag<HIDDEN>(ws.unit(WS_H4, unit), act);
  if constexpr (!SMALL) {
    layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
    acc_to_a<HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_B5});
    if (live) store_frag<HIDDEN>(ws.unit(WS_H5, unit), act);
  }
  layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
  // feat: no relu
  acc_to_a<HIDDEN, false>(acc, act, EpiBias{sm.f + F_OFF_BF});
  if (live) store_frag<HIDDEN>(ws.unit(WS_FEAT, unit), act);
  float hs[4] = {0.f, 0.f, 0.f, 0.f};
  head<HIDDEN>(hs, act, smem_u32(sm.wa8));
  layer<DIR_HIDDEN, 4, 0>(acc, act, xin, sm, ring, stages);
  // x0 = relu(hd_pre): its mask is hd_pre's, and it is WD1's dW operand;
  // a padding row's ray is n_rays, with no dir_c row
  const int row = u * 64 + frag_row(), rows = g.rows();
  const int ray_a = row < rows ? ray0 + g.ray_of(row) : a.n_rays;
  const int ray_b = row + 8 < rows ? ray0 + g.ray_of(row + 8) : a.n_rays;
  const float* dir_a = ray_a < a.n_rays ? a.dir_c + (size_t)ray_a * DIR_HIDDEN : nullptr;
  const float* dir_b = ray_b < a.n_rays ? a.dir_c + (size_t)ray_b * DIR_HIDDEN : nullptr;
  acc_to_a<DIR_HIDDEN, true>(acc, act, EpiDir{sm.f + F_OFF_BD0, {dir_a, dir_b}});
  if (live) store_frag<DIR_HIDDEN>(ws.unit(WS_X0, unit), act);
  layer<DIR_HIDDEN, 2, 0>(acc, act, xin, sm, ring, stages);
  acc_to_a<DIR_HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_BD1});
  if (live) store_frag<DIR_HIDDEN>(ws.unit(WS_X1, unit), act);
  layer<DIR_HIDDEN, 2, 0>(acc, act, xin, sm, ring, stages);
  acc_to_a<DIR_HIDDEN, true>(acc, act, EpiBias{sm.f + F_OFF_BD2});
  if (live) store_frag<DIR_HIDDEN>(ws.unit(WS_X2, unit), act);
  float hc[4] = {0.f, 0.f, 0.f, 0.f};
  head<DIR_HIDDEN>(hc, act, smem_u32(sm.wrgb8));
  const ItemRows ir = item_rows<SF>(sm, a, wg);
  float* sigma = ir.sigma;
  float* rgb = ir.rgb;
  const int lane = threadIdx.x & 31, r0 = frag_row();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = u * 64 + r0 + 8 * h;
    if ((lane & 3) == 0) {
      sigma[row] = hs[2 * h] + sm.f[F_OFF_BA];
      rgb[row * 3] = hc[2 * h] + sm.f[F_OFF_BRGB];
      rgb[row * 3 + 1] = hc[2 * h + 1] + sm.f[F_OFF_BRGB + 1];
    } else if ((lane & 3) == 1) {
      rgb[row * 3 + 2] = hc[2 * h] + sm.f[F_OFF_BRGB + 2];
    }
  }
}

// -- dX -------------------------------------------------------------------------

struct NoPieces {
  __device__ __forceinline__ void operator()(float*) const {}
};

// acc ⊙ [the activation image > 0] (no mask when img is null), then
// `pieces(acc)` on the masked f32 values, bf16 into act (the next
// product's A) and, when live, into the cotangent's image `gout`; then the
// f32 column sums into the warp's partial row. The mask's words are loaded
// into act, whose old values (the layer's A) are dead here.
template <int N, class Pieces = NoPieces>
__device__ __forceinline__ void dx_epilogue(float* acc, uint32_t* act, const unsigned char* img, unsigned char* gout,
                                            float* part, bool live, const Pieces& pieces = Pieces{}) {
  if (img != nullptr) {
    load_frag<N>(act, img);
#pragma unroll
    for (int p = 0; p < N / 4; ++p) {
      const float2 m = unpack_bf16(act[p]);
      acc[2 * p] = m.x > 0.f ? acc[2 * p] : 0.f;
      acc[2 * p + 1] = m.y > 0.f ? acc[2 * p + 1] : 0.f;
    }
  }
  pieces(acc);
#pragma unroll
  for (int p = 0; p < N / 4; ++p) act[p] = pack_bf16(acc[2 * p], acc[2 * p + 1]);
  if (live) store_frag<N>(gout, act);
  colsum<N>(acc, part, live);
}

// The heads' parts of a unit's dX, before its first product: the tile's
// WA sums featᵀ·bf16(g_σ) and WRGB sums x2ᵀ·bf16(g_rgb), the σ / rgb
// biases' sums, and gx2 = bf16(g_rgb)·Wrgbᵀ ⊙ [x2 > 0] into acc[0, 64).
// The 128-wide dX layers that follow use only acc[0, 64) and act[0, 32),
// so the upper halves hold the temporaries: no register beyond the
// chain's 128 + 64 is live here.
template <int SF>
__device__ __forceinline__ void dx_heads(Smem& sm, const PassArgs& a, float* acc, uint32_t* act, int wg, int u,
                                         int unit, float* part, bool live) {
  const ItemRows ir = item_rows<SF>(sm, a, wg);
  const float* gsig = ir.gsig + u * 64;
  const float* grgb = ir.grgb + u * 64 * 3;
  const int r0 = frag_row(), lane = threadIdx.x & 31;
  const int g8 = lane >> 2;
  float* v = acc + 64;      // 64 column partials
  uint32_t* x2 = act + 32;  // the unit's x2 fragment (32 pairs)
  // WA: the 2-row fold of feat · bf16(g_σ), 64 columns a thread
#pragma unroll
  for (int i = 0; i < HIDDEN / 4; ++i) v[i] = 0.f;
  const float g0 = round_bf16(gsig[r0]), g1 = round_bf16(gsig[r0 + 8]);
  load_frag<HIDDEN>(act, a.ws.unit(WS_FEAT, unit));  // act is dead here
#pragma unroll
  for (int p = 0; p < HIDDEN / 4; ++p) {
    const float2 f = unpack_bf16(act[p]);
    const float g = (p & 1) ? g1 : g0;
    v[p & ~1] += f.x * g;  // column pair group p >> 1: v[2j], v[2j + 1]
    v[(p & ~1) + 1] += f.y * g;
  }
  scatter_sum<HIDDEN / 4>(v);
  if (live) {
#pragma unroll
    for (int k = 0; k < HIDDEN / 32; k += 2) {
      float2* p = reinterpret_cast<float2*>(part + PART_WA + fold_col(g8 * (HIDDEN / 32) + k));
      float2 o = *p;
      o.x += v[k];
      o.y += v[k + 1];
      *p = o;
    }
  }
  // x2: the mask of gx2 and the left operand of WRGB; gx2 into acc
  load_frag<DIR_HIDDEN>(x2, a.ws.unit(WS_X2, unit));
  float gr[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) gr[h][ch] = round_bf16(grgb[(r0 + 8 * h) * 3 + ch]);
#pragma unroll
  for (int p = 0; p < DIR_HIDDEN / 4; ++p) {
    const int h = p & 1, col = fold_col(2 * (p >> 1));
    const float2 m = unpack_bf16(x2[p]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* w = sm.wrgb + (col + e) * 3;
      const float gx = gr[h][0] * w[0] + gr[h][1] * w[1] + gr[h][2] * w[2];
      acc[2 * p + e] = (e == 0 ? m.x : m.y) > 0.f ? gx : 0.f;
    }
  }
  // WRGB, a channel at a time
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int j = 0; j < DIR_HIDDEN / 8; ++j) {
      const float2 m0 = unpack_bf16(x2[2 * j]), m1 = unpack_bf16(x2[2 * j + 1]);
      v[2 * j] = m0.x * gr[0][ch] + m1.x * gr[1][ch];
      v[2 * j + 1] = m0.y * gr[0][ch] + m1.y * gr[1][ch];
    }
    scatter_sum<DIR_HIDDEN / 4>(v);
    if (live) {
#pragma unroll
      for (int k = 0; k < DIR_HIDDEN / 32; ++k) part[PART_WRGB + fold_col(g8 * (DIR_HIDDEN / 32) + k) * 3 + ch] += v[k];
    }
  }
  // the σ and rgb biases: one lane a column, the unit's rows in order
  const int lw = (threadIdx.x >> 5) & 3;
  if (live && lw == 0 && lane < 4) {
    float s = 0.f;
    for (int r = 0; r < 64; ++r) s += lane < 3 ? grgb[r * 3 + lane] : gsig[r];
    part[lane < 3 ? F_OFF_BRGB + lane : F_OFF_BA] += s;
  }
}

// The σ head's cotangent joins fc_feat's: gfeat = bf16(g_σ) ⊗ wa + acc.
__device__ __forceinline__ void add_sigma(float* acc, const float* gsig, const float* wa) {
  const int r0 = frag_row();
  const float g0 = round_bf16(gsig[r0]), g1 = round_bf16(gsig[r0 + 8]);
#pragma unroll
  for (int p = 0; p < HIDDEN / 4; ++p) {
    const float g = (p & 1) ? g1 : g0;
    const int col = fold_col(2 * (p >> 1));
    acc[2 * p] = g * wa[col] + acc[2 * p];
    acc[2 * p + 1] = g * wa[col + 1] + acc[2 * p + 1];
  }
}

// Where the rows of warp w of unit u lie: item rows [w0, w0 + 16), real
// below rows = l.rays·l.S; its first ray fa and its last fb
// (item-relative), both -1 when the warp holds padding rows only.
struct WarpRays {
  int fa, fb;
  template <class G>
  __device__ __forceinline__ WarpRays(int u, int w, const G& l) {
    const int w0 = u * 64 + 16 * w, rows = l.rows();
    fa = w0 < rows ? l.ray_of(w0) : -1;
    fb = w0 < rows ? l.ray_of(min(w0 + 15, rows - 1)) : -1;
  }
};

// d_dir's pieces of a warp whose 16 rows reach more than one ray, from the
// masked f32 gx0 in acc[0, 64) (rows r0 / r0 + 8, `fold_col` columns):
// for each ray j of the warp, its rows' sums over the warp (acc[64, 96)
// as the fold, `scatter_sum`), into slot 0 (j = fa) or slot 1 (j = fb) of
// the warp's pieces, or, for a ray whose rows all lie inside the warp
// between those two, straight into d_dir (rows LD floats apart: K4b at h =
// 512 sums each half of its 256-wide rows). A warp of one ray takes its
// piece from `colsum` after the epilogue instead (the same sums).
template <class G, int LD = DIR_HIDDEN>
struct DirPieces {
  float (*slots)[DIR_HIDDEN];  // the warp's two slots
  float* d_dir;                // the item's first ray's row of d_dir
  const G& l;
  int u, ray0, n_rays;
  bool live;
  __device__ __forceinline__ void operator()(float* acc) const {
    const int lw = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const WarpRays wr(u, lw, l);
    if (!live || wr.fa == wr.fb) return;
    const int rows = l.rows(), ia = u * 64 + frag_row(), ib = ia + 8;
    const int ra = ia < rows ? l.ray_of(ia) : -1, rb = ib < rows ? l.ray_of(ib) : -1;
    float* v = acc + 64;
    const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll 1
    for (int j = wr.fa; j <= wr.fb; ++j) {
      const bool in_a = ra == j, in_b = rb == j;
#pragma unroll
      for (int c = 0; c < DIR_HIDDEN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * c + e] = (in_a ? acc[4 * c + e] : 0.f) + (in_b ? acc[4 * c + 2 + e] : 0.f);
      }
      scatter_sum<DIR_HIDDEN / 4>(v);
      if (j == wr.fa || j == wr.fb) {
        float* slot = slots[j == wr.fa ? 0 : 1];
#pragma unroll
        for (int k = 0; k < DIR_HIDDEN / 32; ++k) slot[fold_col(base + k)] = v[k];
      } else if (ray0 + j < n_rays) {
#pragma unroll
        for (int k = 0; k < DIR_HIDDEN / 32; ++k) d_dir[(size_t)j * LD + fold_col(base + k)] = v[k];
      }
    }
  }
};

// d_dir of the rays of unit u, by thread t of the warpgroup (column t):
// the warps' pieces in row order, a ray's pieces added in that order; a
// ray that began in an earlier unit adds its sum so far (dacc) to this
// unit's, and a ray that goes on past the unit keeps its sum there. d_dir's
// rows are LD floats apart.
template <int LD = DIR_HIDDEN, class G>
__device__ __forceinline__ void dir_pieces(const float (*d)[2][DIR_HIDDEN], float* dacc, float* d_dir, const G& l,
                                           int u, int ray0, int n_rays, bool live, int t) {
  const int S = l.samples();
  // the common layouts first, with the same sums in the same order: one
  // ray over whole units (S = 64, 128, ...) and two rays a unit (S = 32)
  if (S % 64 == 0) {
    const float s = ((d[0][0][t] + d[1][0][t]) + d[2][0][t]) + d[3][0][t];
    const float total = u > 0 ? dacc[t] + s : s;
    if (u + 1 < l.units()) {
      dacc[t] = total;
    } else if (live && ray0 < n_rays) {
      d_dir[t] = total;
    }
    return;
  }
  if (S == 32) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (live && ray0 + r < n_rays) d_dir[(size_t)r * LD + t] = d[2 * r][0][t] + d[2 * r + 1][0][t];
    return;
  }
  int cur = -1;
  float sum = 0.f;
  auto finish = [&]() {
    const float total = cur * S < u * 64 ? dacc[t] + sum : sum;
    if ((cur + 1) * S > u * 64 + 64) {
      dacc[t] = total;
    } else if (live && ray0 + cur < n_rays) {
      d_dir[(size_t)cur * LD + t] = total;
    }
  };
#pragma unroll 1
  for (int w = 0; w < 4; ++w) {
    const WarpRays wr(u, w, l);
    if (wr.fa < 0) break;
#pragma unroll 1
    for (int slot = 0; slot < (wr.fb > wr.fa ? 2 : 1); ++slot) {
      const int j = slot ? wr.fb : wr.fa;
      const float v = d[w][slot][t];
      if (j == cur) {
        sum += v;
      } else {
        if (cur >= 0) finish();
        cur = j;
        sum = v;
      }
    }
  }
  if (cur >= 0) finish();
}

// The dX chain of one unit, from the item's f32 head cotangents in
// gsig / grgb: each cotangent masked, stored and summed (dx_epilogue),
// d_dir of the unit's rays.
template <int SF, bool SMALL>
__device__ __forceinline__ void dx_unit(Smem& sm, const PassArgs& a, Ring& ring, float* acc, uint32_t* act, int wg,
                                        int u, int unit, int ray0, float* part, bool live, int& dx_units) {
  const UnitSchedule<SF, 1> g{a.l};
  const Workspace& ws = a.ws;
  const uint32_t none = 0;
  const int stages = ring_stages<RING>(g.xc());
  dx_heads<SF>(sm, a, acc, act, wg, u, unit, part, live);  // gx2, masked, in acc
  dx_epilogue<DIR_HIDDEN>(acc, act, nullptr, ws.unit(WS_GX2, unit), part + F_OFF_BD2, live);
  layer<DIR_HIDDEN, 2, 0>(acc, act, none, sm, ring, stages);  // gx1 = gx2·WD2ᵀ ⊙ [x1 > 0]
  dx_epilogue<DIR_HIDDEN>(acc, act, ws.unit(WS_X1, unit), ws.unit(WS_GX1, unit), part + F_OFF_BD1, live);
  layer<DIR_HIDDEN, 2, 0>(acc, act, none, sm, ring, stages);  // gx0 = gx1·WD1ᵀ ⊙ [x0 > 0]
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3, t = threadIdx.x & 127;
  float(*ds)[2][DIR_HIDDEN] = sm.dsum[wg][dx_units & 1];
  float* d_dir = a.d_dir + (size_t)ray0 * DIR_HIDDEN;
  if (g.samples() % 16 == 0) {  // each warp's real rows lie in one ray: its column sums are its piece
    dx_epilogue<DIR_HIDDEN>(acc, act, ws.unit(WS_X0, unit), ws.unit(WS_GX0, unit), part + F_OFF_BD0, live);
  } else {
    dx_epilogue<DIR_HIDDEN>(acc, act, ws.unit(WS_X0, unit), ws.unit(WS_GX0, unit), part + F_OFF_BD0, live,
                            DirPieces<UnitSchedule<SF, 1>>{ds[lw], d_dir, g, u, ray0, a.n_rays, live});
  }
  // d_dir: a warp of one ray's piece is its column sums of gx0 (acc[0, 4)
  // of each lane); the pieces summed over each ray's warps and units in order
  {
    const WarpRays wr(u, lw, g);
    if (wr.fa >= 0 && wr.fa == wr.fb) {
      const int base = (lane >> 2) * (DIR_HIDDEN / 32);
#pragma unroll
      for (int k = 0; k < DIR_HIDDEN / 32; ++k) ds[lw][0][fold_col(base + k)] = acc[k];
    }
    named_bar_sync(BAR_WG + wg, 128);
    dir_pieces(ds, sm.dacc[wg], d_dir, g, u, ray0, a.n_rays, live, t);
    ++dx_units;
  }
  layer<HIDDEN, 2, 0>(acc, act, none, sm, ring, stages);  // gfeat = gx0·WD0ᵀ + bf16(g_σ) ⊗ wa
  add_sigma(acc, item_rows<SF>(sm, a, wg).gsig + u * 64, sm.wa);
  dx_epilogue<HIDDEN>(acc, act, nullptr, ws.unit(WS_GFEAT, unit), part + F_OFF_BF, live);
  // fc_feat's input: h5, or h4 in the smaller model
  constexpr int LAST = SMALL ? WS_H4 : WS_H5;
  layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // WFᵀ
  dx_epilogue<HIDDEN>(acc, act, ws.unit(LAST, unit), ws.unit(SMALL ? WS_GH4 : WS_GH5, unit),
                      part + (SMALL ? F_OFF_B4 : F_OFF_B5), live);
  if constexpr (!SMALL) {
    layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // W5ᵀ
    dx_epilogue<HIDDEN>(acc, act, ws.unit(WS_H4, unit), ws.unit(WS_GH4, unit), part + F_OFF_B4, live);
  }
  layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // W4ᵀ
  dx_epilogue<HIDDEN>(acc, act, ws.unit(WS_H3, unit), ws.unit(WS_GH3, unit), part + F_OFF_COND3, live);
  layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // W3hᵀ
  dx_epilogue<HIDDEN>(acc, act, ws.unit(WS_H2, unit), ws.unit(WS_GH2, unit), part + F_OFF_B2, live);
  layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // W2ᵀ
  dx_epilogue<HIDDEN>(acc, act, ws.unit(WS_H1, unit), ws.unit(WS_GH1, unit), part + F_OFF_B1, live);
  layer<HIDDEN, 4, 0>(acc, act, none, sm, ring, stages);  // W1ᵀ
  dx_epilogue<HIDDEN>(acc, act, ws.unit(WS_H0, unit), ws.unit(WS_GH0, unit), part + F_OFF_COND0, live);
}

// A consumer warpgroup over its items: each unit's forward, the middle
// (`policy`: the rows' f32 cotangents of raw σ and rgb into gsig / grgb,
// zero on padding rows and past the last ray), each unit's dX. A
// warpgroup whose item is past the last ray walks the same chunks and
// stores nothing.
template <int SF, bool SMALL, class Policy>
__device__ __forceinline__ void consume(Smem& sm, const PassArgs& a, const Policy& policy, int wg, int n_pairs,
                                        float* part) {
  const UnitSchedule<SF, 1> g{a.l};
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
  int units = 0, dx_units = 0;
  Ring ring;
  float acc[128];
  uint32_t act[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) act[i] = 0u;
  const int n_items = (a.n_rays + g.wg_rays() - 1) / g.wg_rays();
  for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
    const int item = g.item(pair, 0, wg);
    const bool live = item < n_items;
    const int ray0 = item * g.wg_rays();
    // a warpgroup past the last ray computes on the first unit's images,
    // whose results it drops: it reads nothing past the workspace
    const int unit0 = live ? item * g.units() : 0;
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u)
      forward_unit<SF, SMALL>(sm, a, ring, acc, act, wg, u, unit0 + u, ray0, live, units);
    // the chain's registers hold nothing the middle needs: constants, so
    // the compiler can hand their registers to the compositing
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) act[i] = 0u;
    named_bar_sync(BAR_WG + wg, 128);
    const ItemRows ir = item_rows<SF>(sm, a, wg);
    policy.middle(ir.sigma, ir.rgb, ir.gsig, ir.grgb, ray0, g, lw, lane);
    named_bar_sync(BAR_WG + wg, 128);
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u)
      dx_unit<SF, SMALL>(sm, a, ring, acc, act, wg, u, unit0 + u, ray0, part, live, dx_units);
  }
}

template <int SF, bool SMALL, class Policy>
__global__ void __launch_bounds__(THREADS, 1) train_pass_kernel(const PassArgs a, const Policy policy) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int t = threadIdx.x;
  const UnitSchedule<SF, 1> g{a.l};
  const int kx = K_XIN * g.xc();
  const bf16* wa = a.W + w_off(W_OFF_WA, kx);
  const bf16* wrgb = a.W + w_off(W_OFF_WRGB, kx);
  for (int i = t; i < F_OFF_TOTAL; i += THREADS) sm.f[i] = a.F[i];
  for (int i = t; i < HIDDEN; i += THREADS) sm.wa[i] = __bfloat162float(wa[i]);
  for (int i = t; i < DIR_HIDDEN * 3; i += THREADS) sm.wrgb[i] = __bfloat162float(wrgb[i]);
  // element (k, n) of a head's (K, 8) weight: chunk k / 64, byte sw128(n, k % 64)
  for (int i = t; i < HIDDEN * 8; i += THREADS) {
    const int k = i >> 3, n = i & 7;
    *reinterpret_cast<bf16*>(sm.wa8[k / KCH] + sw128(n, k % KCH)) = n == 0 ? wa[k] : __float2bfloat16_rn(0.f);
  }
  for (int i = t; i < DIR_HIDDEN * 8; i += THREADS) {
    const int k = i >> 3, n = i & 7;
    *reinterpret_cast<bf16*>(sm.wrgb8[k / KCH] + sw128(n, k % KCH)) =
        n < 3 ? wrgb[k * 3 + n] : __float2bfloat16_rn(0.f);
  }
  fence_proxy_async();  // the images are read by wgmma
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
  // each consumer warp's running partial row starts at zero
  float* part = nullptr;
  if (t < CONSUMERS * 128) {
    part = a.ws.warp_part + ((size_t)blockIdx.x * WARPS_A_CTA + (t >> 5)) * PART_COLS;
    for (int c = t & 31; c < PART_COLS; c += 32) part[c] = 0.f;
    __syncwarp();
  }
  __syncthreads();

  const int n_pairs = ((a.n_rays + g.wg_rays() - 1) / g.wg_rays() + CONSUMERS - 1) / CONSUMERS;
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      produce<SMALL>(sm, a, n_pairs, g.units(), kx);
    } else if (w >= 1 && w <= ENCODERS) {
      encode<SF>(sm, a, n_pairs, t - CONSUMERS * 128 - 32);
    }
  } else {
    reg_alloc<232>();
    consume<SF, SMALL, Policy>(sm, a, policy, wg, n_pairs, part);
    // the CTA's partial row: its warps' rows added in order
    named_bar_sync(BAR_CONSUMERS, CONSUMERS * 128);
    const float* rows = a.ws.warp_part + (size_t)blockIdx.x * WARPS_A_CTA * PART_COLS;
    for (int c = t; c < PART_COLS; c += CONSUMERS * 128) {
      float s = 0.f;
      for (int w = 0; w < WARPS_A_CTA; ++w) s += rows[(size_t)w * PART_COLS + c];
      a.ws.tile_part[(size_t)blockIdx.x * PART_COLS + c] = s;
    }
  }
}

// The pass: train_pass_kernel, then dW = Xᵀ·bf16(gY) on wgmma (W3 in two:
// its kx xin rows and its h2 rows), and the partials summed in order: dW in
// the packed weight layout at the pass's encoding extent kx (w_off(
// W_OFF_TOTAL, kx)), dF in the bias-row layout (F_OFF_TOTAL: COND0/COND3
// hold d_cond0/d_cond3; FREQS is 0). Returns a cudaError_t.
template <int SF, bool SMALL, class Policy>
int launch_pass(const PassArgs& a, const Policy& policy, float* dW, float* dF, cudaStream_t st) {
  const int ctas = pass_ctas(a.n_rays, a.l.S);
  auto kernel = train_pass_kernel<SF, SMALL, Policy>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, THREADS, SMEM_BYTES, st>>>(a, policy);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Workspace& ws = a.ws;
  const int kx = ws.kx;
  auto B = [&](int b) { return ws.buf[b]; };
  auto O = [&](int off) { return w_off(off, kx); };
  const DwgMat mats[] = {
      {B(WS_XIN), B(WS_GH0), kx, HIDDEN, O(W_OFF_W0)},
      {B(WS_H0), B(WS_GH1), HIDDEN, HIDDEN, O(W_OFF_W1)},
      {B(WS_H1), B(WS_GH2), HIDDEN, HIDDEN, O(W_OFF_W2)},
      {B(WS_XIN), B(WS_GH3), kx, HIDDEN, O(W_OFF_W3)},
      {B(WS_H2), B(WS_GH3), HIDDEN, HIDDEN, O(W_OFF_W3) + kx * HIDDEN},
      {B(WS_H3), B(WS_GH4), HIDDEN, HIDDEN, O(W_OFF_W4)},
      {B(SMALL ? WS_H4 : WS_H5), B(WS_GFEAT), HIDDEN, HIDDEN, O(W_OFF_WF)},
      {B(WS_FEAT), B(WS_GX0), HIDDEN, DIR_HIDDEN, O(W_OFF_WD0)},
      {B(WS_X0), B(WS_GX1), DIR_HIDDEN, DIR_HIDDEN, O(W_OFF_WD1)},
      {B(WS_X1), B(WS_GX2), DIR_HIDDEN, DIR_HIDDEN, O(W_OFF_WD2)},
      {B(WS_H4), B(WS_GH5), HIDDEN, HIDDEN, O(W_OFF_W5)},
  };
  // the smaller model has no W5: the last entry drops out, and its slot,
  // which no dW block covers, is zeroed after the reduction
  const int n_mats = (int)(sizeof(mats) / sizeof(mats[0])) - (SMALL ? 1 : 0);
  const int wa = O(W_OFF_WA);  // dW's columns below the heads
  int err = launch_dw_wgmma(mats, n_mats, ws.dw_part, wa, pass_units(a.n_rays, a.l.S), DWG_SEGS, st);
  if (err != 0) return err;
  reduce_rows<<<(wa + 255) / 256, 256, 0, st>>>(ws.dw_part, DWG_SEGS, wa, wa, dW, nullptr);
  if (SMALL) {
    e = cudaMemsetAsync(dW + O(W_OFF_W5), 0, (size_t)HIDDEN * HIDDEN * sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_rows<<<(PART_COLS + 255) / 256, 256, 0, st>>>(ws.tile_part, ctas, PART_COLS, F_OFF_TOTAL, dF, dW + wa);
  return (int)cudaGetLastError();
}

}  // namespace k1
}  // namespace nerface
