// One training pass of the NeRFace paper model on Hopper (sm_90a): radiance
// MLP forward, volume compositing, the MSE-loss cotangent, the compositing
// backward, the trunk backward and the weight gradients.
//
// Replaces K1 of the JAX package, the Pallas TPU kernel `_train_kernel`
// behind nerface_tpu/ops/pallas/fused_train.py::fused_train_pass
// (pallas_call at fused_train.py:398). Python side:
// nerface_tpu_torch/ops/kernels/fused_train.py (wrapper, operand packing,
// the autograd.Function and the plain PyTorch version
// `fused_train_pass_reference`). The encode, dense-layer and head code is
// shared with K2 (fused_paper_render.cu) in mma_tile.cuh, the dX epilogues
// and dW with K4b (fused_flex.cu) in grad_tile.cuh.
//
// The TPU kernel keeps a tile's 10 bf16 activations in VMEM and adds its
// weight gradients into one output block over the sequential grid. Neither
// carries over: the activations of a 128-row tile (2176 bf16 a row, 557 KB)
// do not fit in shared memory, and CUDA blocks run at the same time in no
// order. So one call is five launches on the caller's stream, with the
// activations and cotangents in a device-memory workspace (≈ 8.8 KB a row):
//
//   1. train_fwd_kernel, one 512-thread CTA per 128-row tile (2 rays at
//      S = 64, 1 at S = 128): encode, the trunk and heads as in K2 (bf16
//      mma.sync, f32 accumulation), writing xin, h0..h5, feat, hd_pre, x1,
//      x2 (bf16) to the workspace; then per ray one warp: compositing with
//      an f32 scan of log transmittance, rgb and weights out, the loss
//      cotangent (rgb − t)·loss_scale (+ the white-background and
//      supervised-background terms), and the compositing backward with a
//      reverse (suffix) warp scan, giving the per-row f32 cotangents of raw
//      rgb and σ. The tile's sums for the σ/rgb heads' weights and biases
//      (a 256→1 and a 128→3 product: no tensor-core shape) go to a per-tile
//      partial row.
//   2. train_bwd_kernel, per tile: gx2 = bf16(g_rgb) Wrgbᵀ ⊙ [x2 > 0], then
//      gy ← (bf16(gy) Wᵀ) ⊙ [act > 0] layer by layer down to gh0 as mma.sync
//      GEMMs over transposed weights, each bf16 cotangent written to the
//      workspace; the f32 column sums of each (bias and conditioning
//      gradients) to the tile's partial row, and the per-ray d_dir (the sum
//      of gx0 over the ray's rows) straight out.
//   3. dw_kernel: dW = Xᵀ·bf16(gY) for the 13 tensor-core products (W3 in
//      two: its xin rows and its h2 rows), bf16 operands and f32
//      accumulation. A CTA owns one 64×64 block of one matrix and one of
//      DW_SPLIT row segments, and writes its f32 block to a partial buffer.
//   4./5. reduce_rows: the partials summed over segments (dW) and over
//      tiles (biases, cond0/cond3, the heads' weights), each in a fixed
//      order.
// No atomics anywhere: two calls on the same inputs give bit-identical
// results.
//
// Where the TPU kernel rounds to bf16, this one does too: every left matmul
// operand (the raw points included), both operands of dW, the cotangent of
// dX; relu masks are taken on the bf16 activations; bias sums take the f32
// cotangents; the compositing and its backward stay f32.
//
// Bound: tensor-core throughput. Forward ≈ 0.98 MFLOP a sample, dX ≈ 0.92
// (no dX into the encoding), dW ≈ 0.98: 2.885 MFLOP a sample at the
// function's widths (layer 0's K = 63 and the skip layer's 319, not the
// zero-padded 64 and 320 the MMAs run), 0.76 TFLOP
// for the slice's fine pass (2048 rays × 128 samples). The workspace moves
// ≈ 2.3 GB at that pass (written once, read by dX and dW), ~0.7 ms at the
// card's 3.35 TB/s against ~0.75 ms of bf16 dense peak: the design is near
// balance, and a later version that keeps dX in shared memory across
// layers would move less.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "grad_tile.cuh"

using namespace nerface;

namespace {

// Transposed trunk weights, (out, in) row-major, for the dX products. They
// must equal WT_OFFSETS in ops/kernels/fused_train.py.
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
size_t carve(unsigned char* base, long long rows, long long tiles, Workspace* ws) {
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

struct FwdArgs {
  const float* ro;      // (R, 3)
  const float* rd;      // (R, 3)
  const float* z;       // (R, S)
  const float* target;  // (R, 3)
  const float* dir_c;   // (R, 128)
  const float* bg;      // (R, 3) or null
  const float* noise;   // (R, S) or null
  const bf16* W;        // packed weights (fused_mlp.py W_LAYOUT)
  const float* F;       // packed bias rows + frequency bands (F_LAYOUT)
  float* rgb;           // (R, 3)
  float* weights;       // (R, S)
  float* d_bg;          // (R, 3) or null
  Workspace ws;
  int n_rays, n_freqs, white_bg;
  float noise_std, loss_scale, sup_bg_scale;
};

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

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

template <int S>
__global__ void __launch_bounds__(THREADS, 1) train_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ray0 = tile * RAYS;
  const size_t row0 = (size_t)tile * TILE_ROWS;
  const bf16* W = a.W;
  const float* F = a.F;
  const Workspace& ws = a.ws;
  using Relu = EpiBias<true>;
  using Linear = EpiBias<false>;

  for (int i = tid; i < TILE_ROWS; i += THREADS) sm.gsig[i] = 0.f;
  for (int i = tid; i < TILE_ROWS * 3; i += THREADS) sm.grgb[i] = 0.f;

  // ---- forward: K2's layer chain, each activation also to the workspace
  encode_tile<S>(sm.xin, ws.xin + row0 * K_XIN, a.ro, a.rd, a.z, F + F_OFF_FREQS, ray0, a.n_rays,
                 a.n_freqs);
  bf16* A = sm.act[0];
  bf16* B = sm.act[1];
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];
  const size_t oH = row0 * HIDDEN, oD = row0 * DIR_HIDDEN;
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
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, A, LD_ACT, nullptr, W + W_OFF_W5, B, ws.h[5] + oH,
                                      nullptr, Relu{F + F_OFF_B5});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_WF, A, ws.feat + oH,
                                      nullptr, Linear{F + F_OFF_BF});  // A = feat
  sigma_head(sm.sigma, A, W + W_OFF_WA, F[F_OFF_BA]);
  mma_layer<DIR_HIDDEN, HIDDEN, 0, false>(s0, s1, A, LD_ACT, nullptr, W + W_OFF_WD0, B, ws.hd + oD,
                                          nullptr,
                                          EpiDirPre<S>{F + F_OFF_BD0, a.dir_c, ray0, a.n_rays});
  // x0 = relu(hd_pre) in place (relu commutes with the bf16 rounding)
  for (int e = tid; e < TILE_ROWS * DIR_HIDDEN; e += THREADS) {
    bf16* p = B + (e / DIR_HIDDEN) * LD_ACT + e % DIR_HIDDEN;
    if (__bfloat162float(*p) < 0.f) *p = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_WD1, A,
                                              ws.x1 + oD, nullptr, Relu{F + F_OFF_BD1});
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, A, LD_ACT, nullptr, W + W_OFF_WD2, B,
                                              ws.x2 + oD, nullptr, Relu{F + F_OFF_BD2});
  rgb_head(sm.rgb, B, W + W_OFF_WRGB, F + F_OFF_BRGB);  // B = x2, kept below

  // ---- compositing, loss cotangent, compositing backward: warp w owns
  // ray ray0 + w; lane l owns samples [l·SPL, (l+1)·SPL)
  constexpr int SPL = S / 32;
  const int ray = ray0 + warp;
  if (warp < RAYS && ray < a.n_rays) {
    const float* zr = a.z + (size_t)ray * S;
    const float rx = a.rd[ray * 3], ry = a.rd[ray * 3 + 1], rz = a.rd[ray * 3 + 2];
    const float rnorm =
        sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
    const bool has_bg = a.bg != nullptr;
    float d[SPL], oma[SPL], alpha[SPL], prefix[SPL], trans[SPL], w[SPL];
    bool mask[SPL];
    float run = 0.f;
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int s = lane * SPL + q;
      const int row = warp * S + s;
      const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
      d[q] = __fmul_rn(dz, rnorm);
      float sn = sm.sigma[row];
      if (a.noise != nullptr) sn = __fadd_rn(sn, __fmul_rn(a.noise[(size_t)ray * S + s], a.noise_std));
      mask[q] = sn > 0.f;
      float sa = mask[q] ? sn : 0.f;
      if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
      oma[q] = expf(__fmul_rn(-sa, d[q]));
      alpha[q] = __fsub_rn(1.f, oma[q]);
      prefix[q] = run;
      run = __fadd_rn(run, logf(__fadd_rn(oma[q], 1e-10f)));
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;

    float c_sum[3] = {0.f, 0.f, 0.f}, acc = 0.f;
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int s = lane * SPL + q;
      const int row = warp * S + s;
      trans[q] = expf(excl + prefix[q]);
      w[q] = alpha[q] * trans[q];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c = (has_bg && s == S - 1) ? a.bg[ray * 3 + ch] : sigmoidf(sm.rgb[row * 3 + ch]);
        c_sum[ch] += w[q] * c;
      }
      acc += w[q];
      a.weights[(size_t)ray * S + s] = w[q];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c_sum[ch] += __shfl_xor_sync(0xffffffffu, c_sum[ch], o);
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    const float white = a.white_bg ? 1.f - acc : 0.f;
    float grm[3], tgt[3], bgv[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float rgb_map = c_sum[ch] + white;
      if (lane == 0) a.rgb[ray * 3 + ch] = rgb_map;
      tgt[ch] = a.target[ray * 3 + ch];
      grm[ch] = (rgb_map - tgt[ch]) * a.loss_scale;
      if (has_bg) bgv[ch] = a.bg[ray * 3 + ch];
    }
    const float g_acc = a.white_bg ? -(grm[0] + grm[1] + grm[2]) : 0.f;
    float sup_ray = 0.f;
    if (a.sup_bg_scale > 0.f) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sup_ray += (bgv[ch] - tgt[ch]) * (bgv[ch] - tgt[ch]);
    }
    // g_w, then the suffix sums Σ_{i>j} g_trans_i·trans_i
    float g_alpha_c[SPL], v[SPL];
    float vt = 0.f;
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int s = lane * SPL + q;
      const int row = warp * S + s;
      float g_w = g_acc;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c = (has_bg && s == S - 1) ? bgv[ch] : sigmoidf(sm.rgb[row * 3 + ch]);
        g_w += c * grm[ch];
      }
      if (s == S - 1) g_w += sup_ray * a.sup_bg_scale;
      g_alpha_c[q] = g_w * trans[q];
      v[q] = (g_w * alpha[q]) * trans[q];
      vt += v[q];
    }
    float sfx = vt;  // inclusive suffix over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, sfx, o);
      if (lane + o < 32) sfx += t;
    }
    float after = __shfl_down_sync(0xffffffffu, sfx, 1);  // lanes > this one
    if (lane == 31) after = 0.f;
#pragma unroll
    for (int q = SPL - 1; q >= 0; --q) {
      const int s = lane * SPL + q;
      const int row = warp * S + s;
      const float g_log_t = after;
      after += v[q];
      const float g_omae = g_log_t / (oma[q] + 1e-10f) - g_alpha_c[q];
      // omae first: it is exactly 0 on the 1e10 last distance
      const float g_sa = -(oma[q] * g_omae) * d[q];
      sm.gsig[row] = mask[q] ? g_sa : 0.f;
      const bool bg_sample = has_bg && s == S - 1;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float g_act = w[q] * grm[ch];
        if (bg_sample) {
          sm.grgb[row * 3 + ch] = 0.f;
          if (a.d_bg != nullptr) {
            float g = g_act;
            if (a.sup_bg_scale > 0.f) g += 2.f * (bgv[ch] - tgt[ch]) * w[q] * a.sup_bg_scale;
            a.d_bg[ray * 3 + ch] = g;
          }
        } else {
          const float sg = sigmoidf(sm.rgb[row * 3 + ch]);
          sm.grgb[row * 3 + ch] = g_act * sg * (1.f - sg);
        }
      }
    }
  }
  __syncthreads();

  // ---- the head cotangents out, and the tile's partial sums
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
  // WRGB: x2ᵀ · bf16(g_rgb); x2 is B in shared memory
  for (int idx = tid; idx < DIR_HIDDEN * 3; idx += THREADS) {
    const int k = idx / 3, ch = idx % 3;
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r)
      sum += __bfloat162float(B[r * LD_ACT + k]) * round_bf16(sm.grgb[r * 3 + ch]);
    part[PART_WRGB + idx] = sum;
  }
  // WA: featᵀ · bf16(g_sigma); feat from the workspace (this CTA's writes)
  for (int k = tid; k < HIDDEN; k += THREADS) {
    float sum = 0.f;
    const bf16* f = ws.feat + oH + k;
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

template <int S>
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
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, B, LD_ACT, nullptr, a.WT + WT_OFF_WFT, A,
                                     ws.gh[5] + oH, sm.colsum, EpiMask{ws.h[5] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B5, sm.colsum);
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, A, LD_ACT, nullptr, a.WT + WT_OFF_W5T, B,
                                     ws.gh[4] + oH, sm.colsum, EpiMask{ws.h[4] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B4, sm.colsum);
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, B, LD_ACT, nullptr, a.WT + WT_OFF_W4T, A,
                                     ws.gh[3] + oH, sm.colsum, EpiMask{ws.h[3] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_COND3, sm.colsum);
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, A, LD_ACT, nullptr, a.WT + WT_OFF_W3HT, B,
                                     ws.gh[2] + oH, sm.colsum, EpiMask{ws.h[2] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B2, sm.colsum);
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, B, LD_ACT, nullptr, a.WT + WT_OFF_W2T, A,
                                     ws.gh[1] + oH, sm.colsum, EpiMask{ws.h[1] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_B1, sm.colsum);
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, A, LD_ACT, nullptr, a.WT + WT_OFF_W1T, B,
                                     ws.gh[0] + oH, sm.colsum, EpiMask{ws.h[0] + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + F_OFF_COND0, sm.colsum);
}

template <int S>
int launch_tiles(const FwdArgs& fa, const BwdArgs& ba, int tiles, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(train_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(FwdSmem));
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(train_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(BwdSmem));
  if (e != cudaSuccess) return (int)e;
  train_fwd_kernel<S><<<tiles, THREADS, sizeof(FwdSmem), stream>>>(fa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  train_bwd_kernel<S><<<tiles, THREADS, sizeof(BwdSmem), stream>>>(ba);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a CTA of each kernel takes: out[0] train_fwd_kernel and
// out[1] train_bwd_kernel (dynamic), out[2] dw_kernel (static).
extern "C" void nerface_fused_train_shared_bytes(long long* out) {
  out[0] = (long long)sizeof(FwdSmem);
  out[1] = (long long)sizeof(BwdSmem);
  out[2] = (long long)DW_SMEM_BYTES;
}

// Bytes of device workspace one call needs.
extern "C" long long nerface_fused_train_workspace_bytes(int n_rays, int n_samples) {
  const long long rows = (long long)n_rays * n_samples;
  const long long tiles = (rows + TILE_ROWS - 1) / TILE_ROWS;
  return (long long)carve(nullptr, tiles * TILE_ROWS, tiles, nullptr);
}

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing: `workspace` holds
// nerface_fused_train_workspace_bytes(n_rays, n_samples) bytes. dW is the
// f32 gradient in the packed weight layout (W_OFF_TOTAL), dF in the bias-row
// layout (F_OFF_TOTAL: COND0/COND3 rows hold d_cond0/d_cond3; FREQS is 0).
extern "C" int nerface_fused_train_pass(
    const float* ro, const float* rd, const float* z, const float* target, const float* dir_c,
    const float* bg, const float* noise, const void* W, const void* WT, const float* F, float* rgb,
    float* weights, float* dW, float* dF, float* d_dir, float* d_bg, void* workspace, int n_rays,
    int n_samples, int n_freqs, int white_bg, float noise_std, float loss_scale, float sup_bg_scale,
    void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  if (n_samples != 32 && n_samples != 64 && n_samples != 128) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const long long rows_ll = (long long)n_rays * n_samples;
  const long long tiles = (rows_ll + TILE_ROWS - 1) / TILE_ROWS;
  const int rows = (int)(tiles * TILE_ROWS);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), rows, tiles, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  const bf16* WTb = static_cast<const bf16*>(WT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  FwdArgs fa{ro, rd, z, target, dir_c, bg, noise, Wb, F, rgb, weights, d_bg, ws,
             n_rays, n_freqs, white_bg, noise_std, loss_scale, sup_bg_scale};
  if (noise_std <= 0.f) fa.noise = nullptr;
  BwdArgs ba{Wb, WTb, d_dir, ws, n_rays};
  int err;
  switch (n_samples) {
    case 32:
      err = launch_tiles<32>(fa, ba, (int)tiles, st);
      break;
    case 64:
      err = launch_tiles<64>(fa, ba, (int)tiles, st);
      break;
    default:
      err = launch_tiles<128>(fa, ba, (int)tiles, st);
      break;
  }
  if (err != 0) return err;

  // dW over row segments of whole 64-row chunks
  const DwMat mats[] = {
      {ws.xin, ws.gh[0], K_XIN, K_XIN, HIDDEN, W_OFF_W0, 0},
      {ws.h[0], ws.gh[1], HIDDEN, HIDDEN, HIDDEN, W_OFF_W1, 0},
      {ws.h[1], ws.gh[2], HIDDEN, HIDDEN, HIDDEN, W_OFF_W2, 0},
      {ws.xin, ws.gh[3], K_XIN, K_XIN, HIDDEN, W_OFF_W3, 0},
      {ws.h[2], ws.gh[3], HIDDEN, HIDDEN, HIDDEN, W_OFF_W3 + K_XIN * HIDDEN, 0},
      {ws.h[3], ws.gh[4], HIDDEN, HIDDEN, HIDDEN, W_OFF_W4, 0},
      {ws.h[4], ws.gh[5], HIDDEN, HIDDEN, HIDDEN, W_OFF_W5, 0},
      {ws.h[5], ws.gfeat, HIDDEN, HIDDEN, HIDDEN, W_OFF_WF, 0},
      {ws.feat, ws.gx0, HIDDEN, HIDDEN, DIR_HIDDEN, W_OFF_WD0, 0},
      {ws.hd, ws.gx1, DIR_HIDDEN, DIR_HIDDEN, DIR_HIDDEN, W_OFF_WD1, 1},
      {ws.x1, ws.gx2, DIR_HIDDEN, DIR_HIDDEN, DIR_HIDDEN, W_OFF_WD2, 0},
  };
  err = launch_dw(mats, (int)(sizeof(mats) / sizeof(mats[0])), ws.dw_part, W_OFF_WA, rows, dW, st);
  if (err != 0) return err;
  reduce_rows<<<(PART_COLS + 255) / 256, 256, 0, st>>>(ws.tile_part, (int)tiles, PART_COLS,
                                                       F_OFF_TOTAL, dF, dW + W_OFF_WA);
  return (int)cudaGetLastError();
}
