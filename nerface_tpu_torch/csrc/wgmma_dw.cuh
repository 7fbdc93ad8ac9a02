// The weight gradients of the port's training passes on Hopper (sm_90a):
// dW = Xᵀ·bf16(gY) for the products of a pass, from its workspace: the
// paper model's (K1, fused_train_pass.cu; K3b, fused_paper_mlp.cu; both
// through paper_train.cuh) and the Flexible family's (K4b, fused_flex.cu).
//
// The workspace holds every bf16 activation X and cotangent gY of the pass
// as wgmma operand images: per 64-row unit, the buffer's 64-column blocks
// of 64 rows in the 128-byte swizzle (`sw128`, wgmma_tile.cuh), 8 KB a
// block, a unit's blocks one after the other (paper_train.cuh,
// `image_offset`). So one 1-D bulk copy brings a unit of X or gY into
// shared memory as it is, and the product reads both MN-major: A = Xᵀ (M
// = the columns of X, K = the unit's rows) and B = gY (K = the rows, N =
// its columns), the transposed-A product of probe P2's `bwd_mix`
// (probes.cu), checked against its plain version on the card.
//
// A CTA owns one product, two 64-column blocks of its X (one a consumer
// warpgroup: the 64 × N f32 block of dW, 64 or 128 accumulator registers
// a thread) and one of the caller's row segments, a count fixed by the
// pass's shape: DWG_SEGS for the paper model (its 18 column-block pairs ×
// 7 = 126 CTAs, one wave on 132 SMs), or one the pass picks for its
// product list (K4b's `dw_segments_of`, fused_flex.cu).
// Its producer thread keeps a ring of DWG_RING stages in flight, each a
// unit of gY and of the CTA's two X blocks (one bulk copy each); the
// consumers run four m64nNk16 wgmmas a unit and keep one unit's group in
// flight while releasing the stage before. The accumulators stay in
// registers over the whole segment; each segment's f32 block goes to a
// partial buffer, and `reduce_rows` (grad_tile.cuh) adds the segments in
// order. No atomics: two calls on the same inputs give bit-identical dW.
//
// Bound: tensor-core throughput against the workspace reads. A unit of a
// 256 × 256 product is 8.4 MFLOP for 48 KB of X and gY brought in twice
// (the two CTAs of the product's column blocks read the same gY, the
// second from L2): ≈ 175 FLOP a byte of HBM against the H100's ≈ 295 at
// peak, so the reads bound it unless gY's second read hits L2 (segments
// of one product run at the same time, which keeps it there).

#pragma once

#include "wgmma_tile.cuh"

namespace nerface {

constexpr int DWG_SEGS = 7;       // the paper model's row segments: 18 × 7 = 126 CTAs, one wave on 132 SMs
constexpr int DWG_WAVE = 132;     // CTAs of one wave on an H100 (one an SM)
constexpr int DWG_RING = 4;
constexpr int DWG_MATS_MAX = 12;
constexpr int DWG_BLOCK = 64 * sm90::ROW_BYTES;  // a 64 × 64 bf16 image block, 8 KB
constexpr int DWG_G_BYTES = 4 * DWG_BLOCK;       // gY of a unit, up to 256 columns
constexpr int DWG_STAGE = DWG_G_BYTES + 2 * DWG_BLOCK;
constexpr int DWG_THREADS = 2 * 128 + 32;        // two consumer warpgroups, the producer warp

struct DwgMat {
  const unsigned char* X;  // unit images, kdim columns
  const unsigned char* G;  // ndim columns of unit images g_ld columns wide
  int kdim, ndim, out_off;
  int g_ld, out_ld;        // G's unit width and dW's row length, in columns (0: ndim)
};

struct DwgArgs {
  DwgMat m[DWG_MATS_MAX];
  int task_start[DWG_MATS_MAX + 1];  // CTAs (column-block pairs) of the products before each
  float* part;                       // (segments, part_ld)
  int part_ld;
  int units;
  int units_per_seg;
};

struct alignas(sm90::ATOM_BYTES) DwgSmem {
  unsigned char ring[DWG_RING][DWG_STAGE];
  uint64_t full[DWG_RING];
  uint64_t empty[DWG_RING];
};

template <int N>
__device__ __forceinline__ void dwg_consume(DwgSmem& sm, int wg, int mb, int u0, int u1, float* out, int ld) {
  using namespace sm90;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  Ring ring;
  int prev = -1;
  for (int u = u0; u < u1; ++u) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    const uint32_t g = smem_u32(sm.ring[ring.stage]);
    const uint32_t x = g + DWG_G_BYTES + wg * DWG_BLOCK;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<N, 1, 1>(acc, desc_mn(x + ks * 2 * ATOM_BYTES, DWG_BLOCK, ATOM_BYTES),
                        desc_mn(g + ks * 2 * ATOM_BYTES, DWG_BLOCK, ATOM_BYTES), 1);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if ((threadIdx.x & 127) == 0) mbar_arrive(&sm.empty[prev]);
    }
    prev = ring.stage;
    ring.advance<DWG_RING>();
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  // element i: row 16·warp + lane/4 + 8·((i >> 1) & 1), column 8·(i >> 2) + 2·(lane % 4) + (i & 1)
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r0 = mb * 64 + 16 * w + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int p = 0; p < N / 4; ++p) {
    const int row = r0 + 8 * (p & 1), col = 8 * (p >> 1) + c2;
    *reinterpret_cast<float2*>(out + (size_t)row * ld + col) = make_float2(acc[2 * p], acc[2 * p + 1]);
  }
}

__global__ void __launch_bounds__(DWG_THREADS, 1) dw_wgmma_kernel(const DwgArgs a) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  DwgSmem& sm = *reinterpret_cast<DwgSmem*>(smem_raw + pad);
  int mi = 0;
  while (blockIdx.x >= (unsigned)a.task_start[mi + 1]) ++mi;
  const DwgMat& M = a.m[mi];
  const int mb0 = 2 * (blockIdx.x - a.task_start[mi]);       // the CTA's first X column block
  const int blocks = M.kdim / 64 - mb0 >= 2 ? 2 : 1;          // consumer warpgroups with work
  const int u0 = blockIdx.y * a.units_per_seg;
  const int u1 = min(a.units, u0 + a.units_per_seg);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < DWG_RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], blocks);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = t / 128;
  if (wg == 2) {
    if (t != 256) return;
    // the producer: a unit of gY and of the CTA's X blocks a stage
    const uint32_t g_bytes = M.ndim * ROW_BYTES, x_bytes = blocks * DWG_BLOCK;
    Ring ring;
    for (int u = u0; u < u1; ++u) {
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], g_bytes + x_bytes);
      bulk_load(sm.ring[ring.stage], M.G + (size_t)u * M.g_ld * ROW_BYTES, g_bytes, &sm.full[ring.stage]);
      bulk_load(sm.ring[ring.stage] + DWG_G_BYTES, M.X + (size_t)u * M.kdim * ROW_BYTES + mb0 * DWG_BLOCK,
                x_bytes, &sm.full[ring.stage]);
      ring.advance<DWG_RING>();
    }
    return;
  }
  if (wg >= blocks) return;
  float* out = a.part + (size_t)blockIdx.y * a.part_ld + M.out_off;
  if (M.ndim == 256) {
    dwg_consume<256>(sm, wg, mb0 + wg, u0, u1, out, M.out_ld);
  } else {
    dwg_consume<128>(sm, wg, mb0 + wg, u0, u1, out, M.out_ld);
  }
}

constexpr size_t DWG_SMEM_BYTES = sizeof(DwgSmem) + sm90::ATOM_BYTES;  // + the alignment pad

// A product's CTAs: one a pair of X's 64-column blocks.
__host__ __device__ inline int dw_tasks(int kdim) { return (kdim / 64 + 1) / 2; }

// dW of `n_mats` products over `units` workspace units into `part`
// (segs × part_ld floats; the products cover every column below part_ld),
// the units cut into `segs` row segments; returns a cudaError_t. The
// caller adds the segments (reduce_rows). A product of more than 256
// columns is launched as products of column blocks (a G pointer and an
// out_off into the block, g_ld / out_ld the whole widths); a pass of more
// than DWG_MATS_MAX products launches several times into the same `part`.
inline int launch_dw_wgmma(const DwgMat* mats, int n_mats, float* part, int part_ld, int units, int segs,
                           cudaStream_t st) {
  if (n_mats > DWG_MATS_MAX || segs < 1) return (int)cudaErrorInvalidValue;
  DwgArgs da;
  da.task_start[0] = 0;
  for (int i = 0; i < n_mats; ++i) {
    if (mats[i].kdim % 64 != 0 || (mats[i].ndim != 128 && mats[i].ndim != 256))
      return (int)cudaErrorInvalidValue;
    da.m[i] = mats[i];
    if (da.m[i].g_ld == 0) da.m[i].g_ld = mats[i].ndim;
    if (da.m[i].out_ld == 0) da.m[i].out_ld = mats[i].ndim;
    da.task_start[i + 1] = da.task_start[i] + dw_tasks(mats[i].kdim);
  }
  da.part = part;
  da.part_ld = part_ld;
  da.units = units;
  da.units_per_seg = (units + segs - 1) / segs;
  cudaError_t e = cudaFuncSetAttribute(dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DWG_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dw_wgmma_kernel<<<dim3(da.task_start[n_mats], segs), DWG_THREADS, DWG_SMEM_BYTES, st>>>(da);
  return (int)cudaGetLastError();
}

}  // namespace nerface
