// The paper model's forward chain on wgmma_chain.cuh, shared by K2
// (fused_paper_render.cu: the chain, then each ray's compositing) and K3f
// (fused_paper_mlp.cu: the chain, then each row's raw [rgb, σ] out).
//
// A CTA of PAPER_THREADS: warpgroups 0 and 1 consume, warpgroup 2 feeds
// them (`paper_feed`: its first thread streams the chunk sequence of every
// unit through the PAPER_RING-stage weight ring, its warps 1..3 encode each
// unit's [xyz; PE; 0] tile). A consumer warpgroup runs one 64-row unit at
// a time through `paper_unit`: the trunk kx→256, 256→256 ×2, the skip
// layer [xin; h2] (K = kx + 256)→256 (kx = 64, 128 past 10 bands or 192
// past 20: UnitLayout's xc blocks, the runtime layout class only; at xc =
// 3 the ring runs PAPER_RING − 1 stages, `ring_stages`, and the xin
// buffers take the last, `xin_at`), 256→256 ×2 (×1 for the smaller model,
// SMALL: no layers_xyz.5), fc_feat, the σ head, the direction branch
// 256→128 (+ the ray's dir_c row) and 128→128 ×2, the rgb head; it hands
// back the heads' raw sums and the caller adds the head biases. In a
// cluster of CTAS (K2's default 2) each chunk is copied once for the
// cluster and a stage is released in every CTA of it; K3f runs with CTAS
// = 1. Each kernel's shared memory starts with `PaperChainSmem`.

#pragma once

#include "mma_tile.cuh"
#include "wgmma_chain.cuh"

namespace nerface {
namespace sm90 {

constexpr int PAPER_RING = 5;  // weight stages
constexpr int PAPER_THREADS = 128 * (CHAIN_CONSUMERS + 1);

struct alignas(ATOM_BYTES) PaperChainSmem {
  unsigned char ring[PAPER_RING][CHAIN_STAGE];  // weight chunk images
  // [xyz; PE; 0] of a consumer warpgroup's unit, K-major swizzled, filled
  // by the encoder warps: two buffers of one 64-column block a warpgroup,
  // one of both blocks at xc = 2 (`xin_buf`), or at xc = 3 one of three
  // from the ring's last stage on (`xin_at`)
  unsigned char xin[CHAIN_CONSUMERS][2][XIN_BYTES];
  // the heads' weights zero-padded to 8 columns, as chunk images: wa
  // (256 → 1) and wrgb (128 → 3)
  unsigned char wa8[HIDDEN / KCH][8 * ROW_BYTES];
  unsigned char wrgb8[DIR_HIDDEN / KCH][8 * ROW_BYTES];
  float f[F_OFF_TOTAL];  // bias rows, frequency bands
  uint64_t full[PAPER_RING];
  uint64_t empty[PAPER_RING];
  uint64_t xin_full[CHAIN_CONSUMERS][2];
  uint64_t xin_empty[CHAIN_CONSUMERS][2];
};
static_assert(offsetof(PaperChainSmem, xin) == offsetof(PaperChainSmem, ring) + sizeof(PaperChainSmem::ring),
              "xin follows the ring (`xin_at`)");

// The CTA's set-up: the bias rows, the heads' images (W packed at
// encoding extent kx) and the barriers (a stage's `empty` counts every
// consumer warpgroup of the cluster); ends with __syncthreads.
template <int CTAS>
__device__ __forceinline__ void paper_setup(PaperChainSmem& sm, const bf16* W, const float* F, int kx) {
  const int t = threadIdx.x;
  for (int i = t; i < F_OFF_TOTAL; i += PAPER_THREADS) sm.f[i] = F[i];
  head_image<HIDDEN>(sm.wa8, W + w_off(W_OFF_WA, kx), 1, t, PAPER_THREADS);
  head_image<DIR_HIDDEN>(sm.wrgb8, W + w_off(W_OFF_WRGB, kx), 3, t, PAPER_THREADS);
  fence_proxy_async();  // the images are read by wgmma
  if (t == 0) {
    for (int s = 0; s < PAPER_RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CHAIN_CONSUMERS * CTAS);
    }
    for (int w = 0; w < CHAIN_CONSUMERS; ++w) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&sm.xin_full[w][b], CHAIN_ENCODERS * 32);
        mbar_init(&sm.xin_empty[w][b], 1);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer: every chunk of every layer of every unit (`units` a round)
// of rounds round0, round0 + step, ... below n_rounds, in the consumers'
// order, W packed at encoding extent kx, through the ring's stages at kx
// (`ring_stages`); then wait until each stage has been released once
// more, so no arrive or copy of a peer CTA is left in flight when this CTA
// exits.
template <bool SMALL, int CTAS>
__device__ __forceinline__ void paper_produce(PaperChainSmem& sm, const bf16* __restrict__ W, uint32_t rank,
                                              int round0, int step, int n_rounds, int units, int kx) {
  Ring ring;
  const int stages = ring_stages<PAPER_RING>(kx / K_XIN);
  auto load = [&](int off, int k, int n) {
    load_layer<PAPER_RING, CTAS>(sm.ring, sm.full, sm.empty, ring, W + w_off(off, kx), k, n, rank, stages);
  };
  for (int round = round0; round < n_rounds; round += step) {
    for (int u = 0; u < units; ++u) {
      load(W_OFF_W0, kx, HIDDEN);
      load(W_OFF_W1, HIDDEN, HIDDEN);
      load(W_OFF_W2, HIDDEN, HIDDEN);
      load(W_OFF_W3, kx + HIDDEN, HIDDEN);
      load(W_OFF_W4, HIDDEN, HIDDEN);
      if (!SMALL) load(W_OFF_W5, HIDDEN, HIDDEN);
      load(W_OFF_WF, HIDDEN, HIDDEN);
      load(W_OFF_WD0, HIDDEN, DIR_HIDDEN);
      load(W_OFF_WD1, DIR_HIDDEN, DIR_HIDDEN);
      load(W_OFF_WD2, DIR_HIDDEN, DIR_HIDDEN);
    }
  }
  for (int s = 0; s < stages; ++s) {
    mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
    ring.advance(stages);
  }
}

// Warpgroup CHAIN_CONSUMERS after it gave its registers away: the producer
// thread and the encoder warps over the same rounds of schedule g as the
// consumers. `a` has W, the rays (ro, rd, z), n_rays and n_freqs.
template <bool SMALL, int CTAS, class A, class G>
__device__ __forceinline__ void paper_feed(PaperChainSmem& sm, const A& a, const G& g, uint32_t rank, int round0,
                                           int step, int n_rounds) {
  const int t = threadIdx.x - CHAIN_CONSUMERS * 128;  // the thread in the warpgroup
  const int w = t >> 5;
  if (t == 0) {
    paper_produce<SMALL, CTAS>(sm, a.W, rank, round0, step, n_rounds, g.units(), K_XIN * g.xc());
  } else if (w >= 1 && w <= CHAIN_ENCODERS) {
    encode_units(g, [&](int wg, int b) { return xin_at(sm.xin, wg, b, g.xc()); }, sm.xin_full, sm.xin_empty, a,
                 sm.f + F_OFF_FREQS, rank, round0, step, n_rounds, t - 32,
                 [](int, int) -> unsigned char* { return nullptr; });
  }
}

// Release a stage: one arrive from this warpgroup on the stage's `empty`
// barrier in each CTA of the cluster (the peer is rank ^ 1).
template <int CTAS>
__device__ __forceinline__ void paper_release(PaperChainSmem& sm, int stage, uint32_t rank) {
  const int t = threadIdx.x & 127;
  if (t == 0) mbar_arrive(&sm.empty[stage]);
  if (CTAS > 1 && t == 32) mbar_arrive_cluster(&sm.empty[stage], rank ^ 1);
}

// One layer of a warpgroup's 64 rows (`chain_layer` on the ring's `stages`
// of PAPER_RING, xin's xc blocks), each stage released in every CTA of the
// cluster.
template <int N, int NCH, int X_CHUNKS, int CTAS>
__device__ __forceinline__ void paper_layer(float* acc, uint32_t* a, uint32_t xin, PaperChainSmem& sm, Ring& ring,
                                            uint32_t rank, int stages, int xc = 1) {
  chain_layer<N, NCH, X_CHUNKS, PAPER_RING>(acc, a, xin, sm.ring, sm.full, ring,
                                            [&](int stage) { paper_release<CTAS>(sm, stage, rank); }, xc, stages);
}

// A consumer warpgroup's unit: its encoded tile at shared address xin
// (released on *xin_empty after the skip layer, its last reader), the
// layers and the heads. hs / hc[2h + j] come back as the σ / rgb heads'
// sums without their biases, for row r0 + 8h and column 2·(lane % 4) + j
// (r0 = 16·warp + lane / 4). The unit is unit u of an item of schedule g
// whose first ray is ray0: rows r0 and r0 + 8 read their rays' dir_c rows
// from dir_c_base (R, 128), a padding row or a ray past n_rays none. The
// rays and the addresses are worked out where the direction branch needs
// them, not held through the trunk (such a register kept K3f's S = 128
// chain from a clean wgmma pipeline, C7511).
template <bool SMALL, int CTAS, class G>
__device__ __forceinline__ void paper_unit(float* acc, uint32_t* act, uint32_t xin, PaperChainSmem& sm, Ring& ring,
                                           uint32_t rank, uint64_t* xin_empty, const float* dir_c_base, const G& g,
                                           int ray0, int u, int n_rays, float* hs, float* hc) {
  const int stages = ring_stages<PAPER_RING>(g.xc());
  paper_layer<HIDDEN, 1, 1, CTAS>(acc, act, xin, sm, ring, rank, stages, g.xc());
  acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_COND0});
  paper_layer<HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B1});
  paper_layer<HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B2});
  paper_layer<HIDDEN, 5, 1, CTAS>(acc, act, xin, sm, ring, rank, stages, g.xc());  // the skip: [xin; h2]
  if ((threadIdx.x & 127) == 0) mbar_arrive(xin_empty);            // its last reader is done
  acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_COND3});
  paper_layer<HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B4});
  if constexpr (!SMALL) {
    paper_layer<HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
    acc_to_a<HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_B5});
  }
  paper_layer<HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  acc_to_a<HIDDEN, false>(acc, act, ChainBias{sm.f + F_OFF_BF});  // feat

  // the σ head: feat (bf16, in act) against wa padded to 8 columns
#pragma unroll
  for (int i = 0; i < 4; ++i) hs[i] = 0.f;
  chain_head<HIDDEN>(hs, act, smem_u32(sm.wa8));

  paper_layer<DIR_HIDDEN, 4, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  const int row = u * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);  // the item's row of r0
  const int rows = g.rows();
  const int ray_a = row < rows ? ray0 + g.ray_of(row) : n_rays;
  const int ray_b = row + 8 < rows ? ray0 + g.ray_of(row + 8) : n_rays;
  const float* dir_c0 = ray_a < n_rays ? dir_c_base + (size_t)ray_a * DIR_HIDDEN : nullptr;
  const float* dir_c1 = ray_b < n_rays ? dir_c_base + (size_t)ray_b * DIR_HIDDEN : nullptr;
  acc_to_a<DIR_HIDDEN, true>(acc, act, ChainDirRows{sm.f + F_OFF_BD0, {dir_c0, dir_c1}});
  paper_layer<DIR_HIDDEN, 2, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);
  acc_to_a<DIR_HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_BD1});
  paper_layer<DIR_HIDDEN, 2, 0, CTAS>(acc, act, xin, sm, ring, rank, stages);

  // the rgb head: x2 = bf16(relu(acc + bd2)) against wrgb padded to 8
  // columns
  acc_to_a<DIR_HIDDEN, true>(acc, act, ChainBias{sm.f + F_OFF_BD2});
#pragma unroll
  for (int i = 0; i < 4; ++i) hc[i] = 0.f;
  chain_head<DIR_HIDDEN>(hc, act, smem_u32(sm.wrgb8));
}

}  // namespace sm90
}  // namespace nerface
