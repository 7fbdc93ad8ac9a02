// One training pass of the NeRFace paper model on Hopper (sm_90a): radiance
// MLP forward, volume compositing, the MSE-loss cotangent, the compositing
// backward, the trunk backward and the weight gradients.
//
// Replaces K1 of the JAX package, the Pallas TPU kernel `_train_kernel`
// behind nerface_tpu/ops/pallas/fused_train.py::fused_train_pass
// (pallas_call at fused_train.py:398). Python side:
// nerface_tpu_torch/ops/kernels/fused_train.py (wrapper, operand packing,
// the autograd.Function and the plain PyTorch version
// `fused_train_pass_reference`). `small` selects the smaller paper model
// (no layers_xyz.5).
//
// The TPU kernel keeps the whole pass of a tile in one body, because the
// loss cotangent is ray-local: forward, compositing, backward. So does
// this one: `train_pass_kernel` (paper_train.cuh) is one persistent CTA an
// SM whose two consumer warpgroups each take whole rays through the
// forward chain on wgmma, K1's middle below (compositing, the loss
// cotangent and its backward, in f32), and the dX chain on wgmma, without
// leaving the CTA. The weight gradients are a second kernel over the
// activations and cotangents the first stored as wgmma operand images
// (`dw_wgmma_kernel`, wgmma_dw.cuh), and two `reduce_rows` add the
// partials in a fixed order: four launches a call, no float atomics,
// bit-identical gradients over calls. K3b (fused_paper_mlp.cu) runs the
// same launches with its own middle.
//
// Where the TPU kernel rounds to bf16, this one does too: every left
// matmul operand (the raw points included), both operands of dW, the
// cotangent of dX; relu masks are taken on the bf16 activations; bias sums
// take the f32 cotangents; the compositing and its backward stay f32.
//
// Bound on this card (paper_train.cuh): 2.885 MFLOP a sample, 1.147 ms
// of the bf16 dense peak for a train step's pair (2048 rays at S = 64 and
// 128), with a floor of ≈ 2 ms for the ≈ 6.6 GB of workspace written and
// read again by dW. What holds the kernel back today is registers: ptxas
// spills 6.8–8.3 KB a thread in every train_pass_kernel instantiation,
// and the pair takes 8.8 ms as a bare launch (H100 80GB HBM3, 700 W;
// PERF.md §6). The earlier design (one 512-thread CTA a 128-row
// tile, mma.sync, every activation read back from device memory by two
// more launches) took 11.8 ms on the same card.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "paper_train.cuh"

using namespace nerface;
using namespace nerface::k1;

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

constexpr int MAX_SPL = ITEM_ROWS / 32;  // samples a lane takes, at most

// K1's middle: per ray one warp (warp lw of the warpgroup takes rays lw,
// lw + 4, ... of the item; lane l its samples [l·spl, (l+1)·spl) below S,
// spl = ⌈S / 32⌉): compositing with an f32 scan of log transmittance, rgb
// and weights out, the loss cotangent (rgb − t)·loss_scale (+ the
// white-background and supervised-background terms), and the compositing
// backward with a reverse (suffix) warp scan, giving each row's f32
// cotangents of raw σ and rgb. A ray past the last one and the item's
// padding rows get zero cotangents. The background and its weight are the
// ray's sample S − 1, wherever the item's rows end. A long item's ray (S >
// ITEM_ROWS, its rows in the workspace) goes through `composite_long`.
struct K1Policy {
  const float* rd;      // (R, 3)
  const float* z;       // (R, S)
  const float* target;  // (R, 3)
  const float* bg;      // (R, 3) or null
  const float* noise;   // (R, S) or null
  float* rgb;           // (R, 3)
  float* weights;       // (R, S)
  float* d_bg;          // (R, 3) or null
  int n_rays, white_bg;
  float noise_std, loss_scale, sup_bg_scale;

  template <class G>
  __device__ __forceinline__ void middle(const float* sigma, const float* rgb_raw, float* gsig, float* grgb,
                                         int ray0, const G& l, int lw, int lane) const {
    const int S = l.samples();
    for (int r = l.rows() + (threadIdx.x & 127); r < l.units() * 64; r += 128) {
      gsig[r] = 0.f;
      grgb[r * 3] = grgb[r * 3 + 1] = grgb[r * 3 + 2] = 0.f;
    }
    if (l.long_item()) {
      if (lw == 0 && ray0 < n_rays) composite_long(sigma, rgb_raw, gsig, grgb, ray0, lane, S);
      if (lw == 0 && ray0 >= n_rays) {
        for (int s = lane; s < S; s += 32) {
          gsig[s] = 0.f;
          grgb[s * 3] = grgb[s * 3 + 1] = grgb[s * 3 + 2] = 0.f;
        }
      }
      return;
    }
    for (int r = lw; r < l.wg_rays(); r += 4) {
      const int ray = ray0 + r;
      if (ray >= n_rays) {
        for (int s = lane; s < S; s += 32) {
          const int row = r * S + s;
          gsig[row] = 0.f;
          grgb[row * 3] = grgb[row * 3 + 1] = grgb[row * 3 + 2] = 0.f;
        }
      } else {
        // SPL ≥ ⌈S / 32⌉ register slots a lane: a warp that composites holds
        // up its warpgroup's next wgmma, so S = 64 runs a loop of 2 samples
        // (and in its own instantiation, S folded in), not the largest one
        const int spl = (S + 31) >> 5;
        if (spl == 1) {
          composite<1>(sigma, rgb_raw, gsig, grgb, ray, r * S, lane, S);
        } else if (spl == 2) {
          composite<2>(sigma, rgb_raw, gsig, grgb, ray, r * S, lane, S);
        } else if (spl <= 4) {
          composite<4>(sigma, rgb_raw, gsig, grgb, ray, r * S, lane, S);
        } else {
          composite<MAX_SPL>(sigma, rgb_raw, gsig, grgb, ray, r * S, lane, S);
        }
      }
    }
  }

  // A long ray (S > ITEM_ROWS, rows 0 .. S − 1 of the item) by one warp,
  // `composite`'s arithmetic in segments of ITEM_ROWS samples (lane l its
  // samples [l·spl, (l+1)·spl) of a segment of n, spl = ⌈n / 32⌉): forward
  // from the first segment, each sample's transmittance offset by the log
  // transmittance of the segments before it, the weights out and each
  // transmittance kept in its g_σ slot; then the loss cotangent; then the
  // backward from the last segment, the suffix sums Σ_{i>j} of the later
  // segments carried, the kept transmittance read back before its slot
  // takes g_σ.
  __device__ __forceinline__ void composite_long(const float* sigma, const float* rgb, float* gsig, float* grgb,
                                                 int ray, int lane, int S) const {
    const K1Policy& a = *this;
    constexpr int SPL = MAX_SPL;
    const int n_seg = (S + ITEM_ROWS - 1) / ITEM_ROWS;
    const float* zr = a.z + (size_t)ray * S;
    const float rx = a.rd[ray * 3], ry = a.rd[ray * 3 + 1], rz = a.rd[ray * 3 + 2];
    const float rnorm =
        sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
    const bool has_bg = a.bg != nullptr;
    // a sample's d, 1 − α, relu mask: the same operations in both directions
    auto sample = [&](int s, float& d, float& oma, bool& mask) {
      const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
      d = __fmul_rn(dz, rnorm);
      float sn = sigma[s];
      if (a.noise != nullptr) sn = __fadd_rn(sn, __fmul_rn(a.noise[(size_t)ray * S + s], a.noise_std));
      mask = sn > 0.f;
      float sa = mask ? sn : 0.f;
      if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
      oma = expf(__fmul_rn(-sa, d));
    };
    float c_sum[3] = {0.f, 0.f, 0.f}, acc = 0.f, log_t0 = 0.f;
#pragma unroll 1
    for (int seg = 0; seg < n_seg; ++seg) {
      const int s0 = seg * ITEM_ROWS, n = min(ITEM_ROWS, S - s0), spl = (n + 31) >> 5;
      float alpha[SPL], prefix[SPL];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < SPL; ++q) {
        const int i = lane * spl + q;
        alpha[q] = 0.f;
        prefix[q] = run;
        if (q >= spl || i >= n) continue;
        float d, oma;
        bool mask;
        sample(s0 + i, d, oma, mask);
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
#pragma unroll
      for (int q = 0; q < SPL; ++q) {
        const int i = lane * spl + q, s = s0 + i;
        if (q >= spl || i >= n) continue;
        const float trans = expf(log_t0 + (excl + prefix[q]));
        const float w = alpha[q] * trans;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float c = (has_bg && s == S - 1) ? a.bg[ray * 3 + ch] : sigmoidf(rgb[s * 3 + ch]);
          c_sum[ch] += w * c;
        }
        acc += w;
        a.weights[(size_t)ray * S + s] = w;
        gsig[s] = trans;  // read back by the backward below, this lane's own
      }
      log_t0 = log_t0 + __shfl_sync(0xffffffffu, incl, 31);
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
    float later = 0.f;  // Σ g_trans_i·trans_i over the later segments
#pragma unroll 1
    for (int seg = n_seg - 1; seg >= 0; --seg) {
      const int s0 = seg * ITEM_ROWS, n = min(ITEM_ROWS, S - s0), spl = (n + 31) >> 5;
      float d[SPL], oma[SPL], trans[SPL], w[SPL], g_alpha_c[SPL], v[SPL];
      bool mask[SPL];
      float vt = 0.f;
#pragma unroll
      for (int q = 0; q < SPL; ++q) {
        const int i = lane * spl + q, s = s0 + i;
        d[q] = oma[q] = trans[q] = w[q] = g_alpha_c[q] = v[q] = 0.f;
        mask[q] = false;
        if (q >= spl || i >= n) continue;
        sample(s, d[q], oma[q], mask[q]);
        const float alpha = __fsub_rn(1.f, oma[q]);
        trans[q] = gsig[s];
        w[q] = alpha * trans[q];
        float g_w = g_acc;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float c = (has_bg && s == S - 1) ? bgv[ch] : sigmoidf(rgb[s * 3 + ch]);
          g_w += c * grm[ch];
        }
        if (s == S - 1) g_w += sup_ray * a.sup_bg_scale;
        g_alpha_c[q] = g_w * trans[q];
        v[q] = (g_w * alpha) * trans[q];
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
      after = later + after;
#pragma unroll
      for (int q = SPL - 1; q >= 0; --q) {
        const int i = lane * spl + q, s = s0 + i;
        if (q >= spl || i >= n) continue;
        const float g_log_t = after;
        after += v[q];
        const float g_omae = g_log_t / (oma[q] + 1e-10f) - g_alpha_c[q];
        const float g_sa = -(oma[q] * g_omae) * d[q];
        gsig[s] = mask[q] ? g_sa : 0.f;
        const bool bg_sample = has_bg && s == S - 1;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float g_act = w[q] * grm[ch];
          if (bg_sample) {
            grgb[s * 3 + ch] = 0.f;
            if (a.d_bg != nullptr) {
              float g = g_act;
              if (a.sup_bg_scale > 0.f) g += 2.f * (bgv[ch] - tgt[ch]) * w[q] * a.sup_bg_scale;
              a.d_bg[ray * 3 + ch] = g;
            }
          } else {
            const float sg = sigmoidf(rgb[s * 3 + ch]);
            grgb[s * 3 + ch] = g_act * sg * (1.f - sg);
          }
        }
      }
      later = later + __shfl_sync(0xffffffffu, sfx, 0);
    }
  }

  // kept operation for operation from the earlier one-CTA-a-tile kernel;
  // the ray's rows are row0 .. row0 + S - 1 of the item's, SPL register
  // slots a lane
  template <int SPL>
  __device__ __forceinline__ void composite(const float* sigma, const float* rgb, float* gsig, float* grgb,
                                            int ray, int row0, int lane, int S) const {
    const K1Policy& a = *this;
    const int spl = (S + 31) >> 5;
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
      const int s = lane * spl + q;
      d[q] = oma[q] = alpha[q] = 0.f;
      mask[q] = false;
      prefix[q] = run;
      if (q >= spl || s >= S) continue;
      const int row = row0 + s;
      const float dz = s < S - 1 ? __fsub_rn(zr[s + 1], zr[s]) : 1e10f;
      d[q] = __fmul_rn(dz, rnorm);
      float sn = sigma[row];
      if (a.noise != nullptr) sn = __fadd_rn(sn, __fmul_rn(a.noise[(size_t)ray * S + s], a.noise_std));
      mask[q] = sn > 0.f;
      float sa = mask[q] ? sn : 0.f;
      if (s == S - 1) sa = __fadd_rn(sa, 1e-6f);
      oma[q] = expf(__fmul_rn(-sa, d[q]));
      alpha[q] = __fsub_rn(1.f, oma[q]);
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
      const int s = lane * spl + q;
      trans[q] = w[q] = 0.f;
      if (q >= spl || s >= S) continue;
      const int row = row0 + s;
      trans[q] = expf(excl + prefix[q]);
      w[q] = alpha[q] * trans[q];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c = (has_bg && s == S - 1) ? a.bg[ray * 3 + ch] : sigmoidf(rgb[row * 3 + ch]);
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
      const int s = lane * spl + q;
      g_alpha_c[q] = v[q] = 0.f;
      if (q >= spl || s >= S) continue;
      const int row = row0 + s;
      float g_w = g_acc;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c = (has_bg && s == S - 1) ? bgv[ch] : sigmoidf(rgb[row * 3 + ch]);
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
      const int s = lane * spl + q;
      if (q >= spl || s >= S) continue;
      const int row = row0 + s;
      const float g_log_t = after;
      after += v[q];
      const float g_omae = g_log_t / (oma[q] + 1e-10f) - g_alpha_c[q];
      // omae first: it is exactly 0 on the 1e10 last distance
      const float g_sa = -(oma[q] * g_omae) * d[q];
      gsig[row] = mask[q] ? g_sa : 0.f;
      const bool bg_sample = has_bg && s == S - 1;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float g_act = w[q] * grm[ch];
        if (bg_sample) {
          grgb[row * 3 + ch] = 0.f;
          if (a.d_bg != nullptr) {
            float g = g_act;
            if (a.sup_bg_scale > 0.f) g += 2.f * (bgv[ch] - tgt[ch]) * w[q] * a.sup_bg_scale;
            a.d_bg[ray * 3 + ch] = g;
          }
        } else {
          const float sg = sigmoidf(rgb[row * 3 + ch]);
          grgb[row * 3 + ch] = g_act * sg * (1.f - sg);
        }
      }
    }
  }
};

template <int SF, bool SMALL>
struct Pass {
  static int run(const PassArgs& pa, const K1Policy& policy, float* dW, float* dF, cudaStream_t st) {
    return launch_pass<SF, SMALL>(pa, policy, dW, dF, st);
  }
};

}  // namespace

// Shared memory a CTA of each kernel takes: out[0] train_pass_kernel,
// out[1] dw_wgmma_kernel (both dynamic, with their 1 KB alignment pad).
extern "C" void nerface_fused_train_shared_bytes(long long* out) {
  out[0] = (long long)SMEM_BYTES;
  out[1] = (long long)DWG_SMEM_BYTES;
}

// Bytes of device workspace one call needs (-1 for n_freqs outside
// 1..MAX_FREQS).
extern "C" long long nerface_fused_train_workspace_bytes(int n_rays, int n_samples, int n_freqs) {
  if (n_freqs < 1 || n_freqs > MAX_FREQS) return -1;
  return k1::workspace_bytes(n_rays, n_samples, xin_extent(n_freqs));
}

// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for n_samples
// outside 1..MAX_SAMPLES or n_freqs outside 1..MAX_FREQS). Launches on
// `stream`, does not synchronise and allocates nothing: `workspace` holds
// nerface_fused_train_workspace_bytes(n_rays, n_samples, n_freqs) bytes. W
// and WT are the chunk images of the packed weights (at the bands'
// encoding extent kx = `xin_extent(n_freqs)`) and of the transposed trunk
// (`pack_sm90_chunks`, ops/kernels/fused_mlp.py). dW is the f32 gradient
// in the packed weight layout at kx (w_off(W_OFF_TOTAL, kx)), dF in the
// bias-row layout (F_OFF_TOTAL: COND0/COND3 rows hold d_cond0/d_cond3;
// FREQS is 0). `small`: the smaller paper model (its W5/B5 slots come back
// zero).
extern "C" int nerface_fused_train_pass(
    const float* ro, const float* rd, const float* z, const float* target, const float* dir_c,
    const float* bg, const float* noise, const void* W, const void* WT, const float* F, float* rgb,
    float* weights, float* dW, float* dF, float* d_dir, float* d_bg, void* workspace, int n_rays,
    int n_samples, int n_freqs, int white_bg, int small, float noise_std, float loss_scale,
    float sup_bg_scale, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || n_freqs > MAX_FREQS) return (int)cudaErrorInvalidValue;
  if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int kx = xin_extent(n_freqs);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), pass_units(n_rays, n_samples), pass_ctas(n_rays, n_samples), kx,
        UnitLayout::of(n_samples).units, &ws);
  PassArgs pa{ro, rd, z, dir_c, static_cast<const bf16*>(W), static_cast<const bf16*>(WT), F, d_dir, ws,
              n_rays, UnitLayout::of(n_samples, kx / K_XIN), n_freqs};
  K1Policy policy{rd, z, target, bg, noise_std > 0.f ? noise : nullptr, rgb, weights, d_bg, n_rays, white_bg,
                  noise_std, loss_scale, sup_bg_scale};
  return dispatch_pass<Pass>(n_samples, small, kx / K_XIN, pa, policy, dW, dF, static_cast<cudaStream_t>(stream));
}
