// Fused render of the NeRFace paper model on Hopper (sm_90a): the radiance
// MLP and the volume compositing in one kernel.
//
// Replaces K2 of the JAX package, the Pallas TPU kernel `_render_kernel`
// behind nerface_tpu/ops/pallas/fused_mlp.py::fused_paper_render
// (pallas_call at fused_mlp.py:811). Python side:
// nerface_tpu_torch/ops/kernels/fused_mlp.py (wrapper, the weights' chunk
// images `pack_sm90_chunks`, and the plain PyTorch version
// `fused_paper_render_reference`). `small` selects the smaller paper model,
// whose trunk has no layers_xyz.5 (256→256 ×1 after the skip).
//
// Bound: tensor-core throughput. The MLP is ≈ 0.983 MFLOP a sample at the
// function's widths with 10 bands (2·(63·256 + 5·256² + 319·256 + 256 +
// 256·128 + 2·128² + 128·3); the zero pad of layer 0 and the skip layer to
// K = 64 / 320 is not counted; each band more adds 2·2·6·256): 4.17 ms for
// a 65536-ray tile at S = 64 and 8.34 ms at S = 128 at the H100's 989
// TFLOP/s bf16 dense peak, against ~1.9 MB of ray data in and out per
// 65536 rays. From 11 to 20 bands the encoding is 69..123 columns, padded
// to K = 128 (two 64-column blocks, `xin_extent`): layer 0 and the skip
// layer read one chunk more, 6.7 % more products than at K = 64; from 21
// to 31 bands 129..189 columns in K = 192, two chunks more (13.3 %).
//
// Design (one persistent 2-CTA cluster per SM pair, 384 threads a CTA; the
// chain's pieces are wgmma_chain.cuh's, which K4f shares, and the paper
// model's layer sequence, producer and set-up are paper_chain.cuh's, which
// K3f runs without the cluster):
//   - The weights are packed once per model into chunk images
//     (`wbuf_sm90`): each layer's 64-row K chunks as the byte image of
//     wgmma's 128-byte-swizzled K-major B operand (wgmma_tile.cuh), 32 KB
//     for a 256-wide layer, 16 KB for the 128-wide direction branch; the
//     skip layer (K = 320) is five chunks, the first reading [xyz; PE; 0]
//     (six, the first two reading it, at K = 128 past 10 bands; seven, the
//     first three, at K = 192 past 20).
//   - Warpgroup 2 feeds the others. One thread (the producer) streams the
//     chunk sequence through a RING-deep ring of 32 KB stages, each chunk
//     one `cp.async.bulk` completing on the stage's `full` mbarrier; in the
//     cluster each CTA copies half of a chunk and multicasts it to both, so
//     a chunk leaves L2 once for 256 rows. A stage is refilled when all
//     four consumer warpgroups of the cluster have arrived on its `empty`
//     barrier (the peer's by a remote arrive). Its other three warps (the
//     encoders) write each unit's [xyz; PE; 0] tile into one of its
//     warpgroup's two swizzled xin buffers, handed over on mbarriers
//     (`xin_full` / `xin_empty`), so the encode's sinf never holds a
//     consumer. Past 10 bands a tile is 16 KB, two blocks: the same 16 KB
//     a warpgroup hold one such buffer (K2's shared memory is ≈ 215 KB of
//     227), and the encoders write the next unit once the skip layer has
//     read this one, under its last eight layers. Past 20 a tile is three
//     blocks, 24 KB a warpgroup, which no free bytes hold: that layout runs
//     a 4-stage ring, and the two buffers take the fifth stage's 32 KB and
//     16 KB of the xin array (`xin_at`, `ring_stages`; a runtime value of
//     the runtime class, so no pass of up to 20 bands runs other code).
//     `setmaxnreg` gives the warpgroup's registers to the consumers (40 /
//     232).
//   - Warpgroups 0 and 1 (the consumers) each take whole rays as 64-row
//     units, S in 1..1024 (`UnitLayout`, wgmma_chain.cuh): an item of
//     64 / S rays in one unit where S divides 64, one ray in S / 64 units
//     at a multiple of 64, and otherwise the few rays whose units waste
//     the fewest rows (8 rays in 3 units at S = 24; padding rows compute
//     zeros and are never composited). S = 64 and 128 have instantiations
//     of their own (the layout class SF), any other S reads it at run
//     time, as does a pass past 10 bands at any S (the xin image's two or
//     three blocks, `xc`: the fixed classes keep one, so the 10-band 64 +
//     64 path runs the code it ran before). Each layer is `wgmma.mma_async` m64n256k16
//     (m64n128k16 for the direction branch) into 128 f32 accumulator
//     registers a thread. Layer 0 and the skip layer's first chunk (two
//     at K = 128, three at 192) read xin from shared memory with K packed to 64 (probe P1: four k16 steps
//     a product against five for the split x3 | enc, 14.73 against 18.03 µs
//     a repetition). Every other A comes from registers: the epilogue
//     (bias, the cond0/cond3 folds, the ray's dir_c row) rounds each
//     accumulator pair to bf16 with the relu fused into the convert,
//     exactly where the plain version rounds, and that pair is wgmma's
//     A-fragment register for the next layer (`acc_to_a`); activations
//     never touch shared memory (probe P2: chains whose operands go through
//     shared memory, fourchain, run 13 % below those that stay in
//     registers). 128 accumulator + 64 A-fragment registers a thread fit
//     the 232. One chunk's wgmma group stays in flight while the previous
//     stage is released.
//   - The two consumers run free of each other: no ping-pong ordering
//     (probe P2: two free-running warpgroups 661 TFLOP/s, the same two
//     with named-barrier ping-pong 593, one warpgroup 577; PERF.md §6).
//     Only the weight ring ties them.
//   - The σ head (256→1) and the rgb head (128→3) are m64n8k16 wgmmas
//     against the head weights zero-padded to 8 columns in shared memory;
//     the raw σ and rgb of an item's rows (up to 256) go to shared memory
//     for the compositing once its last unit is done, so a ray spanning
//     several units composites in one piece: one warp per ray (warp w
//     takes rays w, w + 4, ...), lane l its samples [l·spl, (l + 1)·spl)
//     with spl = ⌈S / 32⌉, an f32 scan of log transmittance with
//     separately rounded __fadd_rn / __fmul_rn, the background on the
//     last sample, relu σ + 1e-6 there, the 1e-10 / 1e-38 guards. Below
//     S = 32 lanes idle (S = 16: half a warp): the compositing is well
//     under 1 % of a unit's time next to its 64 rows of the MLP. A ray
//     longer than ITEM_ROWS (S > 256, one ray an item) composites in
//     segments of ITEM_ROWS rows as each fills (`composite_segment`): its
//     log transmittance and its rgb / depth / acc sums carry from one
//     segment to the next in shared memory (`carry`), so the raw rows of
//     one segment, not the ray's, sit in shared memory. Such a pass runs
//     instantiations of its own (`LONG`), so the code of every other pass
//     is as it was without them.
//   - The grid is persistent: cluster c takes rounds c, c + clusters, ...
//     of 2 CTAs × 2 warpgroups' rays; the producer and the encoders run
//     ahead into the next round. A warpgroup whose rays are past the last
//     ray computes zeros and stores nothing, so every consumer of a cluster
//     walks the same chunk sequence.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true: the disparity guard max(acc, 1e-38) needs
// denormals, and the encoding needs the accurate sinf.

#include "mma_tile.cuh"
#include "paper_chain.cuh"

using namespace nerface;
using namespace nerface::sm90;

namespace {

// CTAs sharing each chunk: 2 (the peer is rank ^ 1), or 1 in a build with
// NERFACE_K2_CLUSTER=1 (tools/perf/k2_cluster_ablation.py's comparison)
#ifndef NERFACE_K2_CLUSTER
#define NERFACE_K2_CLUSTER 2
#endif
constexpr int CLUSTER = NERFACE_K2_CLUSTER;
static_assert(CLUSTER == 1 || CLUSTER == 2, "K2 runs in 1- or 2-CTA clusters");
constexpr int CONSUMERS = CHAIN_CONSUMERS;  // warpgroups computing the tile
constexpr int K2_THREADS = PAPER_THREADS;
constexpr int BAR_WG = 1;                   // + warpgroup: that warpgroup's named barrier

// A consumer warpgroup takes whole rays, wg_rays() at a time, as units()
// 64-row units; a cluster takes CLUSTER · CONSUMERS items a round of its
// loop, and streams every chunk units() times a round. SF: the layout
// class (wgmma_chain.cuh).
template <int SF>
using Geometry = UnitSchedule<SF, CLUSTER>;
constexpr int MAX_SPL = ITEM_ROWS / 32;  // samples a lane composites, at most

struct Args {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const float* bg;     // (R, 3) or null
  const bf16* W;       // the weights' chunk images (W_OFF_* offsets)
  const float* F;      // packed bias rows + frequency bands
  float* rgb;          // (R, 3)
  float* disp;         // (R,)
  float* acc;          // (R,)
  float* depth;        // (R,)
  float* bgw;          // (R,)
  float* weights;      // (R, S) or null
  int n_rays;
  UnitLayout l;  // the pass's S, and its items' rays and units (host-computed)
  int n_freqs;
  int white_bg;
};

// The chain's shared memory (paper_chain.cuh), then a warpgroup's item's
// (or a long ray's segment's) raw σ and rgb for the compositing, and a
// long ray's state between its segments: log transmittance, the r / g / b,
// depth and acc sums.
struct K2Smem : PaperChainSmem {
  float sigma[CONSUMERS][ITEM_ROWS];
  float rgb[CONSUMERS][ITEM_ROWS * 3];
  float carry[CONSUMERS][6];
};

// Compositing of ray `ray` (rows row0 .. row0 + S - 1 of its warpgroup's
// raw σ and rgb) by one warp: lane l owns samples [l·spl, (l+1)·spl) below
// S, spl = ⌈S / 32⌉ (at S = 32 / 64 / 128 every lane S / 32 of them), in
// registers of SPL ≥ spl slots (`composite_ray` picks SPL: a warp that
// composites holds up its warpgroup's next wgmma, so S = 64 runs a loop of
// 2 samples, and in its own instantiation with S folded in, not the
// largest one).
template <int SPL>
__device__ __forceinline__ void composite(const float* sigma, const float* rgb, const Args& a, int row0,
                                          int lane, int ray, int S) {
  const int spl = (S + 31) >> 5;
  const float* zr = a.z + (size_t)ray * S;
  const float rx = a.rd[ray * 3], ry = a.rd[ray * 3 + 1], rz = a.rd[ray * 3 + 2];
  const float rnorm =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
  const bool has_bg = a.bg != nullptr;

  float alpha[SPL], prefix[SPL];
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane * spl + q;
    alpha[q] = 0.f;
    prefix[q] = run;
    if (q >= spl || s >= S) continue;
    const int row = row0 + s;
    const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
    const float d = __fmul_rn(dz, rnorm);
    float sa = fmaxf(sigma[row], 0.f);
    if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
    // one_minus_alpha as exp(-σd) directly: 1 - alpha + 1e-10 would round
    // to exactly 0 for alpha == 1 and log would give -inf
    const float oma = expf(__fmul_rn(-sa, d));
    alpha[q] = __fsub_rn(1.f, oma);
    run = __fadd_rn(run, logf(__fadd_rn(oma, 1e-10f)));
  }
  // exclusive scan of the lanes' log-transmittance totals
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;

  float r_sum = 0.f, g_sum = 0.f, b_sum = 0.f, depth = 0.f, acc = 0.f;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane * spl + q;
    if (q >= spl || s >= S) continue;
    const int row = row0 + s;
    const float w = alpha[q] * expf(excl + prefix[q]);
    float c[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float raw = rgb[row * 3 + ch];
      // the last sample's rgb is the raw background pixel, no sigmoid
      c[ch] = (has_bg && s == S - 1) ? a.bg[ray * 3 + ch] : 1.f / (1.f + expf(-raw));
    }
    r_sum += w * c[0];
    g_sum += w * c[1];
    b_sum += w * c[2];
    depth += w * zr[s];
    acc += w;
    if (s == S - 1) a.bgw[ray] = w;
    if (a.weights != nullptr) a.weights[(size_t)ray * S + s] = w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r_sum += __shfl_xor_sync(0xffffffffu, r_sum, o);
    g_sum += __shfl_xor_sync(0xffffffffu, g_sum, o);
    b_sum += __shfl_xor_sync(0xffffffffu, b_sum, o);
    depth += __shfl_xor_sync(0xffffffffu, depth, o);
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (lane == 0) {
    const float white = a.white_bg ? 1.f - acc : 0.f;
    a.rgb[ray * 3] = r_sum + white;
    a.rgb[ray * 3 + 1] = g_sum + white;
    a.rgb[ray * 3 + 2] = b_sum + white;
    a.depth[ray] = depth;
    a.acc[ray] = acc;
    a.disp[ray] = 1.f / fmaxf(1e-10f, depth / fmaxf(acc, 1e-38f));
  }
}

__device__ __forceinline__ void composite_ray(const float* sigma, const float* rgb, const Args& a, int row0,
                                              int lane, int ray, int S) {
  const int spl = (S + 31) >> 5;
  if (spl == 1) {
    composite<1>(sigma, rgb, a, row0, lane, ray, S);
  } else if (spl == 2) {
    composite<2>(sigma, rgb, a, row0, lane, ray, S);
  } else if (spl <= 4) {
    composite<4>(sigma, rgb, a, row0, lane, ray, S);
  } else {
    composite<MAX_SPL>(sigma, rgb, a, row0, lane, ray, S);
  }
}

// One segment of a long ray (S > ITEM_ROWS) by one warp: samples s0 ..
// s0 + n − 1 (n ≤ ITEM_ROWS) in rows 0 .. n − 1 of the warpgroup's raw σ
// and rgb, lane l its samples [l·spl, (l+1)·spl) of the segment, spl =
// ⌈n / 32⌉: `composite`'s scan and sums, each sample's transmittance offset
// by the log transmittance of the ray's earlier segments, carry[0]; its
// sums added to theirs, carry[1..5] (none at s0 = 0). After the ray's last
// segment lane 0 writes the outputs, after any other the new state.
__device__ __forceinline__ void composite_segment(const float* sigma, const float* rgb, float* carry, const Args& a,
                                                  int lane, int ray, int S, int s0, int n) {
  const int spl = (n + 31) >> 5;
  const float* zr = a.z + (size_t)ray * S;
  const float rx = a.rd[ray * 3], ry = a.rd[ray * 3 + 1], rz = a.rd[ray * 3 + 2];
  const float rnorm =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
  const bool has_bg = a.bg != nullptr;
  const bool first = s0 == 0, last = s0 + n == S;
  const float log_t0 = first ? 0.f : carry[0];

  float alpha[MAX_SPL], prefix[MAX_SPL];
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_SPL; ++q) {
    const int i = lane * spl + q, s = s0 + i;  // the segment's row, the ray's sample
    alpha[q] = 0.f;
    prefix[q] = run;
    if (q >= spl || i >= n) continue;
    const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
    const float d = __fmul_rn(dz, rnorm);
    float sa = fmaxf(sigma[i], 0.f);
    if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
    const float oma = expf(__fmul_rn(-sa, d));
    alpha[q] = __fsub_rn(1.f, oma);
    run = __fadd_rn(run, logf(__fadd_rn(oma, 1e-10f)));
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float seg_log_t = __shfl_sync(0xffffffffu, incl, 31);  // the segment's total

  float sum[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // r, g, b, depth, acc
#pragma unroll
  for (int q = 0; q < MAX_SPL; ++q) {
    const int i = lane * spl + q, s = s0 + i;
    if (q >= spl || i >= n) continue;
    const float w = alpha[q] * expf(log_t0 + (excl + prefix[q]));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float c = (has_bg && s == S - 1) ? a.bg[ray * 3 + ch] : 1.f / (1.f + expf(-rgb[i * 3 + ch]));
      sum[ch] += w * c;
    }
    sum[3] += w * zr[s];
    sum[4] += w;
    if (s == S - 1) a.bgw[ray] = w;
    if (a.weights != nullptr) a.weights[(size_t)ray * S + s] = w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 5; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
  }
  if (!first) {
#pragma unroll
    for (int k = 0; k < 5; ++k) sum[k] = carry[1 + k] + sum[k];
  }
  __syncwarp();  // every lane has read carry
  if (lane != 0) return;
  if (!last) {
    carry[0] = log_t0 + seg_log_t;
#pragma unroll
    for (int k = 0; k < 5; ++k) carry[1 + k] = sum[k];
    return;
  }
  const float white = a.white_bg ? 1.f - sum[4] : 0.f;
  a.rgb[ray * 3] = sum[0] + white;
  a.rgb[ray * 3 + 1] = sum[1] + white;
  a.rgb[ray * 3 + 2] = sum[2] + white;
  a.depth[ray] = sum[3];
  a.acc[ray] = sum[4];
  a.disp[ray] = 1.f / fmaxf(1e-10f, sum[3] / fmaxf(sum[4], 1e-38f));
}

// A consumer warpgroup (wg 0 or 1) over its rays: for each unit, encode,
// the layers and the heads; after an item's last unit, its warps composite
// its rays. Nothing but the weight ring ties the two warpgroups together,
// so one's encode, epilogues, heads and compositing run under the other's
// matrix products. LONG (the runtime class's instantiations for S >
// ITEM_ROWS, one ray an item): its warp 0 composites each segment of four
// units as it fills (`composite_segment`), the last after the item; the
// other instantiations hold none of that code.
template <int SF, bool SMALL, bool LONG>
__device__ __forceinline__ void consume(K2Smem& sm, const Args& a, uint32_t rank, int wg, int n_pairs) {
  const Geometry<SF> g{a.l};
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;  // lw: the warp in the warpgroup
  // the thread's accumulator rows: r0 and r0 + 8 of a unit
  const int r0 = lw * 16 + (lane >> 2);
  int units = 0;  // units taken, for the xin buffer and its phase
  float* sigma = sm.sigma[wg];
  float* rgb = sm.rgb[wg];
  Ring ring;
  float acc[128];
  uint32_t act[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) act[i] = 0u;

  for (int pair = cluster_id(); pair < n_pairs; pair += cluster_count()) {
    const int ray0 = g.item(pair, (int)rank, wg) * g.wg_rays();
#pragma unroll 1
    for (int u = 0; u < g.units(); ++u) {
      const int b = xin_buf(units, g.xc());
      mbar_wait(&sm.xin_full[wg][b], xin_phase(units, g.xc()));
      float hs[4], hc[4];
      paper_unit<SMALL, CLUSTER>(acc, act, smem_u32(xin_at(sm.xin, wg, b, g.xc())), sm, ring, rank,
                                 &sm.xin_empty[wg][b], a.dir_c, g, ray0, u, a.n_rays, hs, hc);
      ++units;

      // the unit's place in its item, or in its long ray's segment of ITEM_ROWS rows
      const int su = LONG ? u & (ITEM_ROWS / 64 - 1) : u;
      if (su == 0) named_bar_sync(BAR_WG + wg, 128);  // the last item's (segment's) compositing has read sigma / rgb
      // hs / hc[2h + j]: row r0 + 8h, column 2·(lane % 4) + j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = su * 64 + r0 + 8 * h;
        if ((lane & 3) == 0) {
          sigma[row] = hs[2 * h] + sm.f[F_OFF_BA];
          rgb[row * 3] = hc[2 * h] + sm.f[F_OFF_BRGB];
          rgb[row * 3 + 1] = hc[2 * h + 1] + sm.f[F_OFF_BRGB + 1];
        } else if ((lane & 3) == 1) {
          rgb[row * 3 + 2] = hc[2 * h] + sm.f[F_OFF_BRGB + 2];
        }
      }
      if constexpr (LONG) {
        if (su == ITEM_ROWS / 64 - 1 && u + 1 < g.units()) {  // a full segment, more to come
          named_bar_sync(BAR_WG + wg, 128);
          if (lw == 0 && ray0 < a.n_rays)
            composite_segment(sigma, rgb, sm.carry[wg], a, lane, ray0, g.samples(), (u >> 2) * ITEM_ROWS, ITEM_ROWS);
        }
      }
    }
    named_bar_sync(BAR_WG + wg, 128);
    if constexpr (LONG) {
      const int s0 = ((g.units() - 1) >> 2) * ITEM_ROWS;
      if (lw == 0 && ray0 < a.n_rays) composite_segment(sigma, rgb, sm.carry[wg], a, lane, ray0, g.samples(), s0,
                                                        g.samples() - s0);
      continue;
    }
    for (int r = lw; r < g.wg_rays() && ray0 + r < a.n_rays; r += 4)
      composite_ray(sigma, rgb, a, r * g.samples(), lane, ray0 + r, g.samples());
  }
}

template <int SF, bool SMALL, bool LONG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(K2_THREADS, 1) render_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  K2Smem& sm = *reinterpret_cast<K2Smem*>(smem_raw + pad);
  const Geometry<SF> g{a.l};
  paper_setup<CLUSTER>(sm, a.W, a.F, K_XIN * g.xc());
  cluster_sync();  // the peer's barriers exist before any copy or arrive reaches them

  const uint32_t rank = cluster_rank();
  const int n_pairs = g.rounds(a.n_rays);
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    paper_feed<SMALL, CLUSTER>(sm, a, g, rank, cluster_id(), cluster_count(), n_pairs);
  } else {
    reg_alloc<232>();
    consume<SF, SMALL, LONG>(sm, a, rank, wg, n_pairs);
  }
}

constexpr size_t SMEM_BYTES = sizeof(K2Smem) + ATOM_BYTES;  // + the alignment pad

template <int SF, bool SMALL, bool LONG>
struct RenderLaunch {
  static int run(const Args& args, cudaStream_t stream) {
    auto kernel = render_kernel<SF, SMALL, LONG>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    static int max_clusters = 0;  // co-resident clusters on this card
    if (max_clusters == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(CLUSTER, 1, 1);
      cfg.blockDim = dim3(K2_THREADS, 1, 1);
      cfg.dynamicSmemBytes = SMEM_BYTES;
      e = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
    }
    const int pairs = Geometry<SF>{args.l}.rounds(args.n_rays);
    const int clusters = pairs < max_clusters ? pairs : max_clusters;
    kernel<<<clusters * CLUSTER, K2_THREADS, SMEM_BYTES, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

// A pass's instantiation: past ITEM_ROWS rows an item (the runtime class)
// runs LONG's, every other pass the instantiation of its layout class.
template <int SF, bool SMALL>
struct Render {
  static int run(const Args& args, cudaStream_t stream) {
    if constexpr (SF == 0) {
      if (args.l.units * 64 > ITEM_ROWS) return RenderLaunch<SF, SMALL, true>::run(args, stream);
    }
    return RenderLaunch<SF, SMALL, false>::run(args, stream);
  }
};

}  // namespace

// Shared memory a CTA of render_kernel takes (dynamic, with its 1 KB
// alignment pad): the same at every encoding extent.
extern "C" void nerface_fused_paper_render_shared_bytes(long long* out) { out[0] = (long long)SMEM_BYTES; }

// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for n_samples
// outside 1..MAX_SAMPLES or n_freqs outside 1..MAX_FREQS). Launches on
// `stream`, does not synchronise and allocates nothing. W is
// `pack_sm90_chunks`' image of the weights packed at the bands' encoding
// extent (`xin_extent`: K = 64 up to 10 bands, 128 from 11, 192 from 21).
extern "C" int nerface_fused_paper_render(const float* ro, const float* rd, const float* z,
                                          const float* dir_c, const float* bg, const void* W,
                                          const float* F, float* rgb, float* disp, float* acc,
                                          float* depth, float* bgw, float* weights,
                                          int n_rays, int n_samples, int n_freqs, int white_bg,
                                          int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || n_freqs > MAX_FREQS) return (int)cudaErrorInvalidValue;
  if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  const int xc = xin_extent(n_freqs) / K_XIN;
  Args args{ro,  rd,    z,   dir_c,   bg,     static_cast<const bf16*>(W),   F,       rgb,     disp,
            acc, depth, bgw, weights, n_rays, UnitLayout::of(n_samples, xc), n_freqs, white_bg};
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_pass<Render>(n_samples, small, xc, args, s);
}
