// K4b's backward pieces (fused_flex.cu): the dX epilogues, a tile's column
// sums, and the deterministic weight gradient dW = Xᵀ·gY over every row of
// a pass; `reduce_rows` also adds K1's and K3b's partials (paper_train.cuh).
//
// dW: a CTA of `dw_kernel` owns one 64×64 block of one matrix and one of up
// to DW_SPLIT_MAX row segments, reads the bf16 activations X and cotangents
// gY from the pass's device workspace (cp.async, double-buffered), runs
// bf16 `mma.sync` with f32 accumulation and writes its f32 block to a
// partial buffer; `reduce_rows` adds the partials in a fixed order. No
// atomics: two calls on the same inputs give bit-identical gradients.

#pragma once

#include "mma_tile.cuh"

namespace nerface {

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// gy = acc ⊙ [act > 0], the mask from the bf16 activation in the
// workspace; no mask when act is null (a layer without activation).
struct EpiMask {
  const bf16* act;  // the tile's (128, ld) activation
  int ld;
  __device__ __forceinline__ float2 operator()(int row, int col, float v0, float v1) const {
    if (act == nullptr) return make_float2(v0, v1);
    const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(act + (size_t)row * ld + col);
    return make_float2(__low2float(m) > 0.f ? v0 : 0.f, __high2float(m) > 0.f ? v1 : 0.f);
  }
};

// The σ head's cotangent joins that of the activation it reads:
// gx = bf16(g_sigma) ⊗ wa + acc, then ⊙ [act > 0] when act is given (K1:
// feat, which has no relu; K4b: the trunk's last activation).
struct EpiAddSigma {
  const float* gsig;  // shared memory, per row
  const bf16* wa;     // (256,)
  const bf16* act;    // the tile's (128, ld) activation, or null
  int ld;
  __device__ __forceinline__ float2 operator()(int row, int col, float v0, float v1) const {
    const float g = round_bf16(gsig[row]);
    v0 = g * __bfloat162float(wa[col]) + v0;
    v1 = g * __bfloat162float(wa[col + 1]) + v1;
    return EpiMask{act, ld}(row, col, v0, v1);
  }
};

// the tile's column sums (four 32-row blocks, added in order) into its
// partial row
template <int N>
__device__ __forceinline__ void tile_colsum(float* dst, const float* colsum) {
  for (int c = threadIdx.x; c < N; c += THREADS)
    dst[c] = ((colsum[c] + colsum[N + c]) + colsum[2 * N + c]) + colsum[3 * N + c];
}

// dW: 64×64 output blocks, 64-row chunks, 4 warps, up to DW_SPLIT_MAX row
// segments, up to DW_MATS_MAX matrices a call.
constexpr int DW_BM = 64;
constexpr int DW_BN = 64;
constexpr int DW_ROWS = 64;
constexpr int DW_THREADS = 128;
constexpr int DW_LD = 64 + 8;
constexpr int DW_SPLIT_MAX = 16;
constexpr int DW_MATS_MAX = 12;
constexpr int DW_SMEM_BYTES = 2 * 2 * DW_ROWS * DW_LD * (int)sizeof(bf16);

struct DwMat {
  const bf16* X;  // (rows, ldx) activations; columns [0, kdim)
  const bf16* G;  // (rows, ndim) cotangents
  int ldx, kdim, ndim, out_off, relu_x;
};

struct DwArgs {
  DwMat m[DW_MATS_MAX];
  int block_start[DW_MATS_MAX + 1];
  float* part;  // (split, part_ld)
  int part_ld;
  int rows_per_split;
  int rows;
};

__global__ void __launch_bounds__(DW_THREADS) dw_kernel(const DwArgs a) {
  __shared__ __align__(128) bf16 xs[2][DW_ROWS * DW_LD];
  __shared__ __align__(128) bf16 gs[2][DW_ROWS * DW_LD];
  int mi = 0;
  while (blockIdx.x >= (unsigned)a.block_start[mi + 1]) ++mi;
  const DwMat& M = a.m[mi];
  const int blk = blockIdx.x - a.block_start[mi];
  const int nb = M.ndim / DW_BN;
  const int k0 = (blk / nb) * DW_BM, n0 = (blk % nb) * DW_BN;
  const int r_begin = blockIdx.y * a.rows_per_split;
  const int r_end = min(a.rows, r_begin + a.rows_per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mw = (warp >> 1) * 32, nw = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto stage = [&](int buf, int r0) {
    // 64 rows × 8 segments of 16 bytes, for X and for G
    for (int i = threadIdx.x; i < DW_ROWS * 8; i += DW_THREADS) {
      const int r = i >> 3, c = (i & 7) * 8;
      cp_async16(&xs[buf][r * DW_LD + c], M.X + (size_t)(r0 + r) * M.ldx + k0 + c);
      cp_async16(&gs[buf][r * DW_LD + c], M.G + (size_t)(r0 + r) * M.ndim + n0 + c);
    }
    cp_async_commit();
  };

  const int nch = (r_end - r_begin) / DW_ROWS;
  if (nch > 0) stage(0, r_begin);
  // A (m = k of W, k = row) comes from xs stored [row][m]: ldmatrix.trans,
  // lanes 8j..8j+7 give rows kk + (lane&7) + 8·(j/2) at m + 8·(j%2).
  // B (row × n) from gs stored [row][n]: as mma_layer's B.
  const int j8 = lane >> 3;
  const int a_row = (lane & 7) + ((j8 >> 1) << 3), a_col = (j8 & 1) << 3;
  const int b_row = lane & 15, b_col = (lane >> 4) << 3;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage((ch + 1) & 1, r_begin + (ch + 1) * DW_ROWS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* X = xs[ch & 1];
    const bf16* G = gs[ch & 1];
#pragma unroll
    for (int kk = 0; kk < DW_ROWS; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4<true>(af[i], X + (kk + a_row) * DW_LD + mw + 16 * i + a_col);
        if (M.relu_x) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&af[i][e]);
            t = __hmax2(t, __float2bfloat162_rn(0.f));
            af[i][e] = *reinterpret_cast<unsigned*>(&t);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned bfr[4];
        ldsm_x4<true>(bfr, G + (kk + b_row) * DW_LD + nw + 16 * jj + b_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = a.part + (size_t)blockIdx.y * a.part_ld + M.out_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = k0 + mw + 16 * i + (lane >> 2) + 8 * h;
        const int n = n0 + nw + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + (size_t)m * M.ndim + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// out[c] = Σ_{p in order} part[p][c] for c < C; columns below C1 go to
// out1[c], the others to out2[c − C1].
__global__ void reduce_rows(const float* __restrict__ part, int P, int C, int C1, float* out1,
                            float* out2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f;
  for (int p = 0; p < P; ++p) sum += part[(size_t)p * C + c];
  if (c < C1)
    out1[c] = sum;
  else
    out2[c - C1] = sum;
}

// dW of `n_mats` matrices over `rows` sample rows (whole 64-row chunks) into
// dW[0, part_ld): dw_kernel over DW_SPLIT_MAX row segments into `part`
// (DW_SPLIT_MAX × part_ld floats; the matrices' blocks cover every column
// below part_ld), then their sum in segment order. Returns a cudaError_t.
inline int launch_dw(const DwMat* mats, int n_mats, float* part, int part_ld, int rows, float* dW,
                     cudaStream_t st) {
  if (n_mats > DW_MATS_MAX) return (int)cudaErrorInvalidValue;
  const int chunks = rows / DW_ROWS;
  const int split = chunks < DW_SPLIT_MAX ? chunks : DW_SPLIT_MAX;
  const int per = (chunks + split - 1) / split;
  DwArgs da;
  da.block_start[0] = 0;
  for (int i = 0; i < n_mats; ++i) {
    da.m[i] = mats[i];
    da.block_start[i + 1] = da.block_start[i] + (mats[i].kdim / DW_BM) * (mats[i].ndim / DW_BN);
  }
  da.part = part;
  da.part_ld = part_ld;
  da.rows_per_split = per * DW_ROWS;
  da.rows = rows;
  dw_kernel<<<dim3(da.block_start[n_mats], split), DW_THREADS, 0, st>>>(da);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // segments past the last row (split·per > chunks) computed zero blocks
  reduce_rows<<<(part_ld + 255) / 256, 256, 0, st>>>(part, split, part_ld, part_ld, dW, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace nerface
