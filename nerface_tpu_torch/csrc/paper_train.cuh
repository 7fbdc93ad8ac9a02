// The paper model's training kernels' shared pieces (fused_train_pass.cu,
// K1; fused_paper_mlp.cu, K3b): the device-memory workspace of a pass, the
// forward over a tile that writes every activation to it, the heads'
// cotangents and partial sums, the trunk backward (dX) kernel, and the
// weight gradients (dW) with the final reductions.
//
// A pass is a chain of launches on the caller's stream, the activations
// and cotangents in the workspace (≈ 8.8 KB a row): a forward kernel (K1's
// with compositing and the loss cotangent, K3b's recompute reading the
// cotangent g) that ends in `head_partials`; then `train_bwd_kernel` and
// `launch_paper_backward`'s dw_kernel and reductions (grad_tile.cuh). No
// atomics: two calls on the same inputs give bit-identical gradients.
//
// SMALL is the smaller paper model (no layers_xyz.5): its forward skips
// W5, fc_feat's cotangent is masked by h4 directly, and W5 drops out of
// the dW list; its W5/B5 gradient slots are zero.

#pragma once

#include "grad_tile.cuh"

namespace nerface {

// Transposed trunk weights, (out, in) row-major, for the dX products. They
// must equal WT_OFFSETS in ops/kernels/fused_mlp.py.
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

// A tile's partial row: the F_LAYOUT columns (bias and conditioning sums),
// then WA (256) and WRGB (128·3).
constexpr int PART_WA = F_OFF_TOTAL;
constexpr int PART_WRGB = PART_WA + HIDDEN;
constexpr int PART_COLS = PART_WRGB + DIR_HIDDEN * 3;

// The workspace: per buffer a (rows, width) row-major matrix, rows being
// the pass's sample rows rounded up to whole tiles.
struct Workspace {
  bf16* xin;
  bf16* h[6];
  bf16* feat;
  bf16* hd;
  bf16* x1;
  bf16* x2;
  bf16* gx2;
  bf16* gx1;
  bf16* gx0;
  bf16* gfeat;
  bf16* gh[6];  // gh[i]: cotangent of h_i
  float* g_rgb;    // (rows, 3)
  float* g_sigma;  // (rows,)
  float* tile_part;  // (tiles, PART_COLS)
  float* dw_part;    // (DW_SPLIT, W_OFF_WA)
};

// Lays the workspace out from `base` (or only measures it when base is
// null); returns its size in bytes.
inline size_t carve(unsigned char* base, long long rows, long long tiles, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  auto mat = [&](int width) { return static_cast<bf16*>(take((size_t)rows * width * sizeof(bf16))); };
  Workspace w;
  w.xin = mat(K_XIN);
  for (int i = 0; i < 6; ++i) w.h[i] = mat(HIDDEN);
  w.feat = mat(HIDDEN);
  w.hd = mat(DIR_HIDDEN);
  w.x1 = mat(DIR_HIDDEN);
  w.x2 = mat(DIR_HIDDEN);
  w.gx2 = mat(DIR_HIDDEN);
  w.gx1 = mat(DIR_HIDDEN);
  w.gx0 = mat(DIR_HIDDEN);
  w.gfeat = mat(HIDDEN);
  for (int i = 0; i < 6; ++i) w.gh[i] = mat(HIDDEN);
  w.g_rgb = static_cast<float*>(take((size_t)rows * 3 * sizeof(float)));
  w.g_sigma = static_cast<float*>(take((size_t)rows * sizeof(float)));
  w.tile_part = static_cast<float*>(take((size_t)tiles * PART_COLS * sizeof(float)));
  w.dw_part = static_cast<float*>(take((size_t)DW_SPLIT_MAX * W_OFF_WA * sizeof(float)));
  if (ws) *ws = w;
  return off;
}

// The tiles of a pass of n_rays × n_samples rows, and its workspace bytes.
inline long long pass_tiles(int n_rays, int n_samples) {
  return ((long long)n_rays * n_samples + TILE_ROWS - 1) / TILE_ROWS;
}

inline long long workspace_bytes(int n_rays, int n_samples) {
  const long long tiles = pass_tiles(n_rays, n_samples);
  return (long long)carve(nullptr, tiles * TILE_ROWS, tiles, nullptr);
}

// Shared memory of a forward CTA of the training kernels.
struct FwdSmem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  bf16 xin[TILE_ROWS * LD_XIN];
  float sigma[TILE_ROWS];
  float rgb[TILE_ROWS * 3];
  float gsig[TILE_ROWS];
  float grgb[TILE_ROWS * 3];
};

// layers_dir.0 in training: hd_pre = acc + bias + the ray's dir
// contribution, kept before the relu (its mask is the backward's).
template <int S>
struct EpiDirPre {
  const float* bias;
  const float* dir_c;
  int ray0, n_rays;
  __device__ __forceinline__ float2 operator()(int row, int col, float v0, float v1) const {
    v0 += bias[col];
    v1 += bias[col + 1];
    const int ray = ray0 + row / S;
    if (ray < n_rays) {
      v0 += dir_c[(size_t)ray * DIR_HIDDEN + col];
      v1 += dir_c[(size_t)ray * DIR_HIDDEN + col + 1];
    }
    return make_float2(v0, v1);
  }
};

// The forward over `tile` that keeps what the backward reads: K2's layer
// chain (bf16 mma.sync, f32 accumulation), each activation also written to
// the workspace (xin, h0..h4 [h5], feat, hd_pre, x1, x2), the raw σ and rgb
// heads into sm.sigma / sm.rgb. Returns the shared-memory buffer that holds
// x2 (read by `head_partials`); ends with a barrier.
template <int S, bool SMALL>
__device__ __forceinline__ const bf16* train_tile(FwdSmem& sm, const float* __restrict__ ro,
                                                  const float* __restrict__ rd, const float* __restrict__ z,
                                                  const float* __restrict__ dir_c, const bf16* __restrict__ W,
                                                  const float* __restrict__ F, const Workspace& ws, int tile,
                                                  int n_rays, int n_freqs) {
  using Relu = EpiBias<true>;
  using Linear = EpiBias<false>;
  constexpr int RAYS = TILE_ROWS / S;
  const int ray0 = tile * RAYS;
  const size_t row0 = (size_t)tile * TILE_ROWS;
  const size_t oH = row0 * HIDDEN, oD = row0 * DIR_HIDDEN;
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];
  bf16* A = sm.act[0];
  bf16* B = sm.act[1];
  encode_tile<S>(sm.xin, ws.xin + row0 * K_XIN, ro, rd, z, F + F_OFF_FREQS, ray0, n_rays, n_freqs);
  mma_layer<HIDDEN, K_XIN, 0, false>(s0, s1, sm.xin, LD_XIN, nullptr, W + W_OFF_W0, A, ws.h[0] + oH,
                                     nullptr, Relu{F + F_OFF_COND0});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, A, LD_ACT, nullptr, W + W_OFF_W1, B, ws.h[1] + oH,
                                      nullptr, Relu{F + F_OFF_B1});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_W2, A, ws.h[2] + oH,
                                      nullptr, Relu{F + F_OFF_B2});
  mma_layer<HIDDEN, K_XIN, HIDDEN, false>(s0, s1, sm.xin, LD_XIN, A, W + W_OFF_W3, B, ws.h[3] + oH,
                                          nullptr, Relu{F + F_OFF_COND3});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_W4, A, ws.h[4] + oH,
                                      nullptr, Relu{F + F_OFF_B4});
  bf16* h = A;  // the trunk's last activation
  bf16* o = B;
  if constexpr (!SMALL) {
    mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, h, LD_ACT, nullptr, W + W_OFF_W5, o, ws.h[5] + oH,
                                        nullptr, Relu{F + F_OFF_B5});
    h = B;
    o = A;
  }
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, h, LD_ACT, nullptr, W + W_OFF_WF, o, ws.feat + oH,
                                      nullptr, Linear{F + F_OFF_BF});
  bf16* feat = o;
  bf16* x = h;
  sigma_head(sm.sigma, feat, W + W_OFF_WA, F[F_OFF_BA]);
  mma_layer<DIR_HIDDEN, HIDDEN, 0, false>(s0, s1, feat, LD_ACT, nullptr, W + W_OFF_WD0, x, ws.hd + oD,
                                          nullptr, EpiDirPre<S>{F + F_OFF_BD0, dir_c, ray0, n_rays});
  // x0 = relu(hd_pre) in place (relu commutes with the bf16 rounding)
  for (int e = threadIdx.x; e < TILE_ROWS * DIR_HIDDEN; e += THREADS) {
    bf16* p = x + (e / DIR_HIDDEN) * LD_ACT + e % DIR_HIDDEN;
    if (__bfloat162float(*p) < 0.f) *p = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, x, LD_ACT, nullptr, W + W_OFF_WD1, feat,
                                              ws.x1 + oD, nullptr, Relu{F + F_OFF_BD1});
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, feat, LD_ACT, nullptr, W + W_OFF_WD2, x,
                                              ws.x2 + oD, nullptr, Relu{F + F_OFF_BD2});
  rgb_head(sm.rgb, x, W + W_OFF_WRGB, F + F_OFF_BRGB);
  return x;
}

// The row cotangents of the heads (sm.gsig, sm.grgb: raw σ and rgb) to the
// workspace, and the tile's partial sums of the heads' biases and weights
// (a 256→1 and a 128→3 product: no tensor-core shape); x2 is the tile's
// bf16 x2 in shared memory. Call after a barrier.
__device__ __forceinline__ void head_partials(FwdSmem& sm, const Workspace& ws, int tile, const bf16* x2) {
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)tile * TILE_ROWS;
  for (int i = tid; i < TILE_ROWS; i += THREADS) ws.g_sigma[row0 + i] = sm.gsig[i];
  for (int i = tid; i < TILE_ROWS * 3; i += THREADS) ws.g_rgb[row0 * 3 + i] = sm.grgb[i];
  float* part = ws.tile_part + (size_t)tile * PART_COLS;
  if (tid < 3) {
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r) sum += sm.grgb[r * 3 + tid];
    part[F_OFF_BRGB + tid] = sum;
  } else if (tid == 3) {
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r) sum += sm.gsig[r];
    part[F_OFF_BA] = sum;
  } else if (tid >= 32 && tid < 32 + (F_OFF_TOTAL - F_OFF_FREQS)) {
    part[F_OFF_FREQS + tid - 32] = 0.f;
  }
  // WRGB: x2ᵀ · bf16(g_rgb)
  for (int idx = tid; idx < DIR_HIDDEN * 3; idx += THREADS) {
    const int k = idx / 3, ch = idx % 3;
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r)
      sum += __bfloat162float(x2[r * LD_ACT + k]) * round_bf16(sm.grgb[r * 3 + ch]);
    part[PART_WRGB + idx] = sum;
  }
  // WA: featᵀ · bf16(g_sigma); feat from the workspace (this CTA's writes)
  for (int k = tid; k < HIDDEN; k += THREADS) {
    float sum = 0.f;
    const bf16* f = ws.feat + row0 * HIDDEN + k;
    for (int r = 0; r < TILE_ROWS; ++r) sum += __bfloat162float(f[(size_t)r * HIDDEN]) * round_bf16(sm.gsig[r]);
    part[PART_WA + k] = sum;
  }
}

// ---------------------------------------------------------------------------
// Trunk backward (dX)

struct BwdArgs {
  const bf16* W;   // packed forward weights (for Wrgb, Wa)
  const bf16* WT;  // packed transposed weights
  float* d_dir;    // (R, 128)
  Workspace ws;
  int n_rays;
};

struct BwdSmem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  float colsum[4 * HIDDEN];
  float gsig[TILE_ROWS];
  float grgb[TILE_ROWS * 3];
};

// Per tile: gx2 = bf16(g_rgb) Wrgbᵀ ⊙ [x2 > 0], then gy ← (bf16(gy) Wᵀ) ⊙
// [act > 0] layer by layer down to gh0 as mma.sync GEMMs over transposed
// weights, each bf16 cotangent written to the workspace; the f32 column
// sums of each (bias and conditioning gradients) to the tile's partial
// row, and the per-ray d_dir (the sum of gx0 over the ray's rows) straight
// out.
template <int S, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) train_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ray0 = tile * RAYS;
  const size_t row0 = (size_t)tile * TILE_ROWS;
  const Workspace& ws = a.ws;
  const size_t oH = row0 * HIDDEN, oD = row0 * DIR_HIDDEN;
  float* part = ws.tile_part + (size_t)tile * PART_COLS;
  bf16* A = sm.act[0];
  bf16* B = sm.act[1];
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];

  for (int i = tid; i < TILE_ROWS; i += THREADS) sm.gsig[i] = ws.g_sigma[row0 + i];
  for (int i = tid; i < TILE_ROWS * 3; i += THREADS) sm.grgb[i] = ws.g_rgb[row0 * 3 + i];
  __syncthreads();

  // gx2 = bf16(g_rgb) Wrgbᵀ ⊙ [x2 > 0]: thread (k, rows of block tid/128)
  {
    const int k = tid & (DIR_HIDDEN - 1), blk = tid / DIR_HIDDEN;
    const bf16* wr = a.W + W_OFF_WRGB + k * 3;
    const float w0 = __bfloat162float(wr[0]), w1 = __bfloat162float(wr[1]), w2 = __bfloat162float(wr[2]);
    float sum = 0.f;
    for (int r = blk * 32; r < blk * 32 + 32; ++r) {
      float v = round_bf16(sm.grgb[r * 3]) * w0 + round_bf16(sm.grgb[r * 3 + 1]) * w1 +
                round_bf16(sm.grgb[r * 3 + 2]) * w2;
      if (!(__bfloat162float(ws.x2[oD + (size_t)r * DIR_HIDDEN + k]) > 0.f)) v = 0.f;
      const bf16 b = __float2bfloat16_rn(v);
      A[r * LD_ACT + k] = b;
      ws.gx2[oD + (size_t)r * DIR_HIDDEN + k] = b;
      sum += v;
    }
    sm.colsum[blk * DIR_HIDDEN + k] = sum;
  }
  __syncthreads();
  tile_colsum<DIR_HIDDEN>(part + F_OFF_BD2, sm.colsum);

  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, true>(s0, s1, A, LD_ACT, nullptr, a.WT + WT_OFF_WD2T, B,
                                             ws.gx1 + oD, sm.colsum, EpiMask{ws.x1 + oD, DIR_HIDDEN});
  tile_colsum<DIR_HIDDEN>(part + F_OFF_BD1, sm.colsum);
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, true>(s0, s1, B, LD_ACT, nullptr, a.WT + WT_OFF_WD1T, A,
                                             ws.gx0 + oD, sm.colsum, EpiMask{ws.hd + oD, DIR_HIDDEN});
  tile_colsum<DIR_HIDDEN>(part + F_OFF_BD0, sm.colsum);
  // d_dir: the sum of gx0 over the ray's rows (S/32 blocks of 32)
  for (int e = tid; e < RAYS * DIR_HIDDEN; e += THREADS) {
    const int j = e / DIR_HIDDEN, c = e % DIR_HIDDEN;
    if (ray0 + j >= a.n_rays) continue;
    float sum = 0.f;
    for (int b = j * (S / 32); b < (j + 1) * (S / 32); ++b) sum += sm.colsum[b * DIR_HIDDEN + c];
    a.d_dir[(size_t)(ray0 + j) * DIR_HIDDEN + c] = sum;
  }
  mma_layer<HIDDEN, DIR_HIDDEN, 0, true>(s0, s1, A, LD_ACT, nullptr, a.WT + WT_OFF_WD0T, B,
                                         ws.gfeat + oH, sm.colsum,
                                         EpiAddSigma{sm.gsig, a.W + W_OFF_WA});
  tile_colsum<HIDDEN>(part + F_OFF_BF, sm.colsum);
  // g: the cotangent just computed; o: the other buffer
  bf16* g = B;
  bf16* o = A;
  auto flip = [&]() {
    bf16* t = g;
    g = o;
    o = t;
  };
  // fc_feat's input: h5, or h4 in the smaller model
  constexpr int LAST = SMALL ? 4 : 5;
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_WFT, o,
                                     ws.gh[LAST] + oH, sm.colsum, EpiMask{ws.h[LAST] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + (SMALL ? F_OFF_B4 : F_OFF_B5), sm.colsum);
  flip();
  if constexpr (SMALL) {
    for (int c = tid; c < HIDDEN; c += THREADS) part[F_OFF_B5 + c] = 0.f;
  } else {
    mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_W5T, o,
                                       ws.gh[4] + oH, sm.colsum, EpiMask{ws.h[4] + oH, HIDDEN});
    tile_colsum<HIDDEN>(part + F_OFF_B4, sm.colsum);
    flip();
  }
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_W4T, o,
                                     ws.gh[3] + oH, sm.colsum, EpiMask{ws.h[3] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_COND3, sm.colsum);
  flip();
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_W3HT, o,
                                     ws.gh[2] + oH, sm.colsum, EpiMask{ws.h[2] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B2, sm.colsum);
  flip();
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_W2T, o,
                                     ws.gh[1] + oH, sm.colsum, EpiMask{ws.h[1] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B1, sm.colsum);
  flip();
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, g, LD_ACT, nullptr, a.WT + WT_OFF_W1T, o,
                                     ws.gh[0] + oH, sm.colsum, EpiMask{ws.h[0] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_COND0, sm.colsum);
}

// The rest of a pass after its forward kernel: train_bwd_kernel, then dW =
// Xᵀ·bf16(gY) for the tensor-core products (W3 in two: its xin rows and
// its h2 rows) over whole 64-row chunks, and the partials summed over tiles
// (biases, cond0/cond3, the heads' weights). dW is the f32 gradient in the
// packed weight layout (W_OFF_TOTAL), dF in the bias-row layout
// (F_OFF_TOTAL: COND0/COND3 hold d_cond0/d_cond3; FREQS is 0). Returns a
// cudaError_t.
template <int S, bool SMALL>
int launch_paper_backward(const BwdArgs& ba, long long tiles, float* dW, float* dF, cudaStream_t st) {
  int err = launch_tiles(train_bwd_kernel<S, SMALL>, sizeof(BwdSmem), (int)tiles, st, ba);
  if (err != 0) return err;
  const Workspace& ws = ba.ws;
  const int rows = (int)(tiles * TILE_ROWS);
  const DwMat mats[] = {
      {ws.xin, ws.gh[0], K_XIN, K_XIN, HIDDEN, W_OFF_W0, 0},
      {ws.h[0], ws.gh[1], HIDDEN, HIDDEN, HIDDEN, W_OFF_W1, 0},
      {ws.h[1], ws.gh[2], HIDDEN, HIDDEN, HIDDEN, W_OFF_W2, 0},
      {ws.xin, ws.gh[3], K_XIN, K_XIN, HIDDEN, W_OFF_W3, 0},
      {ws.h[2], ws.gh[3], HIDDEN, HIDDEN, HIDDEN, W_OFF_W3 + K_XIN * HIDDEN, 0},
      {ws.h[3], ws.gh[4], HIDDEN, HIDDEN, HIDDEN, W_OFF_W4, 0},
      {ws.h[SMALL ? 4 : 5], ws.gfeat, HIDDEN, HIDDEN, HIDDEN, W_OFF_WF, 0},
      {ws.feat, ws.gx0, HIDDEN, HIDDEN, DIR_HIDDEN, W_OFF_WD0, 0},
      {ws.hd, ws.gx1, DIR_HIDDEN, DIR_HIDDEN, DIR_HIDDEN, W_OFF_WD1, 1},
      {ws.x1, ws.gx2, DIR_HIDDEN, DIR_HIDDEN, DIR_HIDDEN, W_OFF_WD2, 0},
      {ws.h[4], ws.gh[5], HIDDEN, HIDDEN, HIDDEN, W_OFF_W5, 0},
  };
  // the smaller model has no W5: the last entry drops out, and its slot,
  // which no dw block covers, is zeroed after the reduction
  const int n_mats = (int)(sizeof(mats) / sizeof(mats[0])) - (SMALL ? 1 : 0);
  err = launch_dw(mats, n_mats, ws.dw_part, W_OFF_WA, rows, dW, st);
  if (err != 0) return err;
  if (SMALL) {
    cudaError_t e = cudaMemsetAsync(dW + W_OFF_W5, 0, (size_t)HIDDEN * HIDDEN * sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_rows<<<(PART_COLS + 255) / 256, 256, 0, st>>>(ws.tile_part, (int)tiles, PART_COLS, F_OFF_TOTAL, dF,
                                                       dW + W_OFF_WA);
  return (int)cudaGetLastError();
}

}  // namespace nerface
