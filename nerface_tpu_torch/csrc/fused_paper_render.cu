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
// function's widths (2·(63·256 + 5·256² + 319·256 + 256 + 256·128 + 2·128²
// + 128·3); the zero pad of layer 0 and the skip layer to K = 64 / 320 is
// not counted): 4.17 ms for a 65536-ray tile at S = 64 and 8.34 ms at
// S = 128 at the H100's 989 TFLOP/s bf16 dense peak, against ~1.9 MB of
// ray data in and out per 65536 rays.
//
// Design (one persistent 2-CTA cluster per SM pair, 384 threads a CTA; the
// chain's pieces are wgmma_chain.cuh's, which K4f shares):
//   - The weights are packed once per model into chunk images
//     (`wbuf_sm90`): each layer's 64-row K chunks as the byte image of
//     wgmma's 128-byte-swizzled K-major B operand (wgmma_tile.cuh), 32 KB
//     for a 256-wide layer, 16 KB for the 128-wide direction branch; the
//     skip layer (K = 320) is five chunks, the first reading [xyz; PE; 0].
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
//     consumer. `setmaxnreg` gives the warpgroup's registers to the
//     consumers (40 / 232).
//   - Warpgroups 0 and 1 (the consumers) each take whole rays as 64-row
//     units: two rays a unit at S = 32, one at S = 64, one ray in two
//     units at S = 128. Each layer is `wgmma.mma_async` m64n256k16
//     (m64n128k16 for the direction branch) into 128 f32 accumulator
//     registers a thread. Layer 0 and the skip layer's first chunk read
//     xin from shared memory with K packed to 64 (probe P1: four k16 steps
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
//     the raw σ and rgb go to shared memory for the compositing: one warp
//     per ray, an f32 scan of log transmittance with separately rounded
//     __fadd_rn / __fmul_rn, the background on the last sample, relu σ +
//     1e-6 there, the 1e-10 / 1e-38 guards.
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
#include "wgmma_chain.cuh"

using namespace nerface;
using namespace nerface::sm90;

namespace {

constexpr int RING = 5;                     // weight stages
// CTAs sharing each chunk: 2 (the peer is rank ^ 1), or 1 in a build with
// NERFACE_K2_CLUSTER=1 (tools/perf/k2_cluster_ablation.py's comparison)
#ifndef NERFACE_K2_CLUSTER
#define NERFACE_K2_CLUSTER 2
#endif
constexpr int CLUSTER = NERFACE_K2_CLUSTER;
static_assert(CLUSTER == 1 || CLUSTER == 2, "K2 runs in 1- or 2-CTA clusters");
constexpr int CONSUMERS = CHAIN_CONSUMERS;  // warpgroups computing the tile
constexpr int K2_THREADS = 128 * (CONSUMERS + 1);
constexpr int ENCODERS = CHAIN_ENCODERS;    // warps of the producer warpgroup that encode
constexpr int BAR_WG = 1;                   // + warpgroup: that warpgroup's named barrier

// A consumer warpgroup takes whole rays, WG_RAYS at a time, as UNITS
// 64-row units (two at S = 128: one ray); a cluster takes RAYS_PER_ROUND
// rays a round of its loop, and streams every chunk UNITS times a round.
template <int S>
using Geometry = Schedule<S, CLUSTER>;

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
  int n_freqs;
  int white_bg;
};

struct alignas(ATOM_BYTES) K2Smem {
  unsigned char ring[RING][CHAIN_STAGE];   // weight chunk images
  // [xyz; PE; 0] of a consumer warpgroup's unit, K-major swizzled: two
  // buffers a warpgroup, filled by the encoder warps
  unsigned char xin[CONSUMERS][2][XIN_BYTES];
  // the heads' weights zero-padded to 8 columns, as chunk images: wa
  // (256 → 1) and wrgb (128 → 3)
  unsigned char wa8[HIDDEN / KCH][8 * ROW_BYTES];
  unsigned char wrgb8[DIR_HIDDEN / KCH][8 * ROW_BYTES];
  float f[F_OFF_TOTAL];                      // bias rows, frequency bands
  float sigma[CONSUMERS][128];              // a warpgroup's rays' raw σ and rgb
  float rgb[CONSUMERS][128 * 3];
  uint64_t full[RING];
  uint64_t empty[RING];
  uint64_t xin_full[CONSUMERS][2];
  uint64_t xin_empty[CONSUMERS][2];
};

// The producer: every chunk of every layer of every unit of every round of
// this cluster, in the consumers' order; then wait until each stage has
// been released once more, so no arrive or copy of the peer CTA is left in
// flight when this CTA exits.
template <int S, bool SMALL>
__device__ __forceinline__ void produce(K2Smem& sm, const bf16* __restrict__ W, uint32_t rank, int n_pairs) {
  Ring ring;
  auto load_layer = [&](int off, int k, int n) {
    sm90::load_layer<RING, CLUSTER>(sm.ring, sm.full, sm.empty, ring, W + off, k, n, rank);
  };
  for (int pair = cluster_id(); pair < n_pairs; pair += cluster_count()) {
    for (int u = 0; u < Geometry<S>::UNITS; ++u) {
      load_layer(W_OFF_W0, K_XIN, HIDDEN);
      load_layer(W_OFF_W1, HIDDEN, HIDDEN);
      load_layer(W_OFF_W2, HIDDEN, HIDDEN);
      load_layer(W_OFF_W3, K_XIN + HIDDEN, HIDDEN);
      load_layer(W_OFF_W4, HIDDEN, HIDDEN);
      if (!SMALL) load_layer(W_OFF_W5, HIDDEN, HIDDEN);
      load_layer(W_OFF_WF, HIDDEN, HIDDEN);
      load_layer(W_OFF_WD0, HIDDEN, DIR_HIDDEN);
      load_layer(W_OFF_WD1, DIR_HIDDEN, DIR_HIDDEN);
      load_layer(W_OFF_WD2, DIR_HIDDEN, DIR_HIDDEN);
    }
  }
  for (int s = 0; s < RING; ++s) {
    mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
    ring.advance<RING>();
  }
}

// Release a stage: one arrive from this warpgroup on the stage's `empty`
// barrier in each CTA of the cluster.
__device__ __forceinline__ void release(K2Smem& sm, int stage, uint32_t rank) {
  const int t = threadIdx.x & 127;
  if (t == 0) mbar_arrive(&sm.empty[stage]);
  if (CLUSTER > 1 && t == 32) mbar_arrive_cluster(&sm.empty[stage], rank ^ 1);
}

// One layer of a warpgroup's 64 rows (`chain_layer`), each stage released
// in both CTAs of the cluster.
template <int N, int NCH, int X_CHUNKS>
__device__ __forceinline__ void layer(float* acc, uint32_t* a, uint32_t xin, K2Smem& sm, Ring& ring,
                                      uint32_t rank) {
  chain_layer<N, NCH, X_CHUNKS, RING>(acc, a, xin, sm.ring, sm.full, ring,
                                      [&](int stage) { release(sm, stage, rank); });
}

// The encoder warps (ENCODERS · 32 threads, index e): every unit of both
// consumer warpgroups, in the order they take them (`encode_units`).
template <int S>
__device__ __forceinline__ void encode(K2Smem& sm, const Args& a, uint32_t rank, int n_pairs, int e) {
  encode_units<S, CLUSTER>(sm.xin, sm.xin_full, sm.xin_empty, a, sm.f + F_OFF_FREQS, rank, cluster_id(),
                           cluster_count(), n_pairs, e, [](int, int) -> unsigned char* { return nullptr; });
}

// Compositing of ray `ray` (rows warp·S .. warp·S + S - 1 of its
// warpgroup's raw σ and rgb) by one warp: lane l owns samples
// [l·SPL, (l+1)·SPL).
template <int S>
__device__ __forceinline__ void composite(const float* sigma, const float* rgb, const Args& a, int warp,
                                          int lane, int ray) {
  constexpr int SPL = S / 32;
  const float* zr = a.z + (size_t)ray * S;
  const float rx = a.rd[ray * 3], ry = a.rd[ray * 3 + 1], rz = a.rd[ray * 3 + 2];
  const float rnorm =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
  const bool has_bg = a.bg != nullptr;

  float alpha[SPL], prefix[SPL];
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane * SPL + q;
    const int row = warp * S + s;
    const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
    const float d = __fmul_rn(dz, rnorm);
    float sa = fmaxf(sigma[row], 0.f);
    if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
    // one_minus_alpha as exp(-σd) directly: 1 - alpha + 1e-10 would round
    // to exactly 0 for alpha == 1 and log would give -inf
    const float oma = expf(__fmul_rn(-sa, d));
    alpha[q] = __fsub_rn(1.f, oma);
    prefix[q] = run;
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

  float r_sum = 0.f, g_sum = 0.f, b_sum = 0.f, depth = 0.f, acc = 0.f, w_last = 0.f;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int s = lane * SPL + q;
    const int row = warp * S + s;
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
    if (s == S - 1) w_last = w;
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
  if (lane == 31) a.bgw[ray] = w_last;
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

// A consumer warpgroup (wg 0 or 1) over its rays: for each unit, encode,
// the layers and the heads; after an item's last unit, its warps composite
// its rays. Nothing but the weight ring ties the two warpgroups together,
// so one's encode, epilogues, heads and compositing run under the other's
// matrix products.
template <int S, bool SMALL>
__device__ __forceinline__ void consume(K2Smem& sm, const Args& a, uint32_t rank, int wg, int n_pairs) {
  using G = Geometry<S>;
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;  // lw: the warp in the warpgroup
  // the thread's accumulator rows: r0 and r0 + 8 of a unit, in one ray
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
    const int ray0 = G::item(pair, (int)rank, wg) * G::WG_RAYS;
#pragma unroll 1
    for (int u = 0; u < G::UNITS; ++u) {
      const int ray = ray0 + (u * 64 + r0) / S;
      const int b = units & 1;
      mbar_wait(&sm.xin_full[wg][b], (units >> 1) & 1);
      const uint32_t xin = smem_u32(sm.xin[wg][b]);

      layer<HIDDEN, 1, 1>(acc, act, xin, sm, ring, rank);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_COND0});
      layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B1});
      layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B2});
      layer<HIDDEN, 5, 1>(acc, act, xin, sm, ring, rank);  // the skip: [xin; h2]
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.xin_empty[wg][b]);  // its last reader is done
      ++units;
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_COND3});
      layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B4});
      if constexpr (!SMALL) {
        layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
        acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B5});
      }
      layer<HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<HIDDEN, false>(acc, act, ChainBias{sm.f + F_OFF_BF});  // feat

      // the σ head: feat (bf16, in act) against wa padded to 8 columns
      float hs[4] = {0.f, 0.f, 0.f, 0.f};
      chain_head<HIDDEN>(hs, act, smem_u32(sm.wa8));

      const float* dir_c = ray < a.n_rays ? a.dir_c + (size_t)ray * DIR_HIDDEN : nullptr;
      layer<DIR_HIDDEN, 4, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<DIR_HIDDEN, true>(acc, act, ChainDir{sm.f + F_OFF_BD0, dir_c});
      layer<DIR_HIDDEN, 2, 0>(acc, act, xin, sm, ring, rank);
      acc_to_a<DIR_HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_BD1});
      layer<DIR_HIDDEN, 2, 0>(acc, act, xin, sm, ring, rank);

      // the rgb head: x2 = bf16(relu(acc + bd2)) against wrgb padded to 8
      // columns
      acc_to_a<DIR_HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_BD2});
      float hc[4] = {0.f, 0.f, 0.f, 0.f};
      chain_head<DIR_HIDDEN>(hc, act, smem_u32(sm.wrgb8));

      if (u == 0) named_bar_sync(BAR_WG + wg, 128);  // the last item's compositing has read sigma / rgb
      // hs / hc[2h + j]: row r0 + 8h, column 2·(lane % 4) + j
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
    named_bar_sync(BAR_WG + wg, 128);
    if (lw < G::WG_RAYS && ray0 + lw < a.n_rays) composite<S>(sigma, rgb, a, lw, lane, ray0 + lw);
  }
}

template <int S, bool SMALL>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(K2_THREADS, 1) render_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  K2Smem& sm = *reinterpret_cast<K2Smem*>(smem_raw + pad);
  const int t = threadIdx.x;
  for (int i = t; i < F_OFF_TOTAL; i += K2_THREADS) sm.f[i] = a.F[i];
  head_image<HIDDEN>(sm.wa8, a.W + W_OFF_WA, 1, t, K2_THREADS);
  head_image<DIR_HIDDEN>(sm.wrgb8, a.W + W_OFF_WRGB, 3, t, K2_THREADS);
  fence_proxy_async();  // the images are read by wgmma
  if (t == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS * CLUSTER);
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
  cluster_sync();  // the peer's barriers exist before any copy or arrive reaches them

  const uint32_t rank = cluster_rank();
  const int n_pairs = Geometry<S>::rounds(a.n_rays);
  const int wg = t / 128;
  if (wg == CONSUMERS) {
    reg_dealloc<40>();
    const int w = (t >> 5) - 4 * CONSUMERS;  // the warp in the producer warpgroup
    if (t == CONSUMERS * 128) {
      produce<S, SMALL>(sm, a.W, rank, n_pairs);
    } else if (w >= 1 && w <= ENCODERS) {
      encode<S>(sm, a, rank, n_pairs, t - CONSUMERS * 128 - 32);
    }
  } else {
    reg_alloc<232>();
    consume<S, SMALL>(sm, a, rank, wg, n_pairs);
  }
}

constexpr size_t SMEM_BYTES = sizeof(K2Smem) + ATOM_BYTES;  // + the alignment pad

template <int S, bool SMALL>
struct Render {
  static int run(const Args& args, cudaStream_t stream) {
    auto kernel = render_kernel<S, SMALL>;
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
    const int pairs = Geometry<S>::rounds(args.n_rays);
    const int clusters = pairs < max_clusters ? pairs : max_clusters;
    kernel<<<clusters * CLUSTER, K2_THREADS, SMEM_BYTES, stream>>>(args);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. W is `pack_sm90_chunks`' image of the
// packed weights.
extern "C" int nerface_fused_paper_render(const float* ro, const float* rd, const float* z,
                                          const float* dir_c, const float* bg, const void* W,
                                          const float* F, float* rgb, float* disp, float* acc,
                                          float* depth, float* bgw, float* weights,
                                          int n_rays, int n_samples, int n_freqs, int white_bg,
                                          int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  Args args{ro,  rd,  z,     dir_c, bg,  static_cast<const bf16*>(W), F,      rgb,     disp,
            acc, depth, bgw, weights, n_rays, n_freqs, white_bg};
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_pass<Render>(n_samples, small, args, s);
}
