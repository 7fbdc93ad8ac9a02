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
// and dW with K4b (fused_flex.cu) in grad_tile.cuh, the forward with its
// workspace writes, the dX kernel and the dW list with K3b
// (fused_paper_mlp.cu) in paper_train.cuh. `small` selects the smaller
// paper model (no layers_xyz.5; paper_train.cuh).
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

#include "paper_train.cuh"

using namespace nerface;

namespace {

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

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

template <int S, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) train_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ray0 = tile * RAYS;

  for (int i = tid; i < TILE_ROWS; i += THREADS) sm.gsig[i] = 0.f;
  for (int i = tid; i < TILE_ROWS * 3; i += THREADS) sm.grgb[i] = 0.f;

  // ---- forward: K2's layer chain, each activation also to the workspace
  const bf16* x2 = train_tile<S, SMALL>(sm, a.ro, a.rd, a.z, a.dir_c, a.W, a.F, a.ws, tile, a.n_rays,
                                        a.n_freqs);

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
  head_partials(sm, a.ws, tile, x2);
}

template <int S, bool SMALL>
struct Pass {
  static int run(const FwdArgs& fa, const BwdArgs& ba, long long tiles, float* dW, float* dF,
                 cudaStream_t st) {
    int err = launch_tiles(train_fwd_kernel<S, SMALL>, sizeof(FwdSmem), (int)tiles, st, fa);
    if (err != 0) return err;
    return launch_paper_backward<S, SMALL>(ba, tiles, dW, dF, st);
  }
};

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
  return workspace_bytes(n_rays, n_samples);
}

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing: `workspace` holds
// nerface_fused_train_workspace_bytes(n_rays, n_samples) bytes. dW is the
// f32 gradient in the packed weight layout (W_OFF_TOTAL), dF in the bias-row
// layout (F_OFF_TOTAL: COND0/COND3 rows hold d_cond0/d_cond3; FREQS is 0).
// `small`: the smaller paper model (its W5/B5 slots come back zero).
extern "C" int nerface_fused_train_pass(
    const float* ro, const float* rd, const float* z, const float* target, const float* dir_c,
    const float* bg, const float* noise, const void* W, const void* WT, const float* F, float* rgb,
    float* weights, float* dW, float* dF, float* d_dir, float* d_bg, void* workspace, int n_rays,
    int n_samples, int n_freqs, int white_bg, int small, float noise_std, float loss_scale,
    float sup_bg_scale, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  if (n_samples != 32 && n_samples != 64 && n_samples != 128) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const long long tiles = pass_tiles(n_rays, n_samples);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), tiles * TILE_ROWS, tiles, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  FwdArgs fa{ro, rd, z, target, dir_c, bg, noise, Wb, F, rgb, weights, d_bg, ws,
             n_rays, n_freqs, white_bg, noise_std, loss_scale, sup_bg_scale};
  if (noise_std <= 0.f) fa.noise = nullptr;
  BwdArgs ba{Wb, static_cast<const bf16*>(WT), d_dir, ws, n_rays};
  return dispatch_pass<Pass>(n_samples, small, fa, ba, tiles, dW, dF, static_cast<cudaStream_t>(stream));
}
