// Fused render of the NeRFace paper model on Hopper (sm_90a): the radiance
// MLP and the volume compositing in one kernel.
//
// Replaces K2 of the JAX package, the Pallas TPU kernel `_render_kernel`
// behind nerface_tpu/ops/pallas/fused_mlp.py::fused_paper_render
// (pallas_call at fused_mlp.py:811). Python side:
// nerface_tpu_torch/ops/kernels/fused_mlp.py (wrapper, operand packing, and
// the plain PyTorch version `fused_paper_render_reference`).
// Steps 1-3 below are `render_tile` in mma_tile.cuh, shared with K3f
// (fused_paper_mlp.cu); the encode, dense-layer and head code with K1
// (fused_train_pass.cu) too. `small` selects the smaller paper model, whose
// trunk has no layers_xyz.5 (256→256 ×1 after the skip).
//
// What one CTA does, for a tile of 128 sample rows (2 rays at S = 64, 1 ray
// at S = 128):
//   1. points ro + rd·z and their positional encoding sin(x·f + φ) in f32
//      (`sinf`, full range reduction: arguments reach hundreds of radians),
//      packed with xyz into 64 bf16 columns [xyz(3); PE(60); 0] in shared
//      memory;
//   2. the trunk 64→256, 256→256 ×2, the concat-skip layer [xin; h2] (K=320)
//      →256, 256→256 ×2, fc_feat, then the direction branch 256→128 (+ the
//      per-ray dir contribution) and 128→128 ×2. Each layer is bf16
//      `mma.sync.m16n8k16` with f32 accumulation, operands loaded with
//      `ldmatrix` (B transposed on the fly); activations ping-pong between
//      two 128×256 bf16 buffers in shared memory; the weights (~0.98 MB bf16,
//      resident in L2) stream through shared memory in 64-row K-chunks,
//      double-buffered with cp.async, so the CTA's 16 warps share one copy of
//      each chunk and the next chunk's load overlaps this chunk's MMAs. Bias,
//      relu, the cond0/cond3 conditioning folds and the dir contribution are
//      applied to the accumulator registers, which are stored as bf16 pairs;
//   3. the σ head (256→1) and the rgb head (128→3) as per-thread dot
//      products;
//   4. compositing: one warp per ray, an f32 scan of log transmittance
//      (the TPU kernel's triangular matmul was a Mosaic workaround), the
//      background on the last sample, relu σ + 1e-6 there.
//
// Bound: tensor-core throughput. The MLP is about 1 MFLOP per sample
// (2·(63·256 + 5·256² + 319·256 + 256 + 256·128 + 2·128² + 128·3) ≈ 0.983
// MFLOP at the function's widths; the zero pad of layer 0 and the skip
// layer to K = 64 / 320 is not counted), ≈ 49.5
// TFLOP for one 512² frame at 64 + 128 samples per ray, against
// ~1.9 MB of ray data in and out per 65536 rays. On an H100 80GB HBM3 at
// 700 W, chip_smoke.py times it at 212-219 TFLOP/s on 65536-ray tiles,
// ≈ 22 % of the bf16 dense peak.
//
// What this simple design leaves on the table: wgmma (mma.sync reaches only
// part of Hopper's tensor-core rate); TMA multicast of the weight chunks
// across a cluster; one CTA per SM (218 KB of shared memory), so an SM idles
// through each CTA's encode, epilogues, heads, scan and the barrier at every
// chunk; and a persistent grid that would overlap one tile's epilogue with
// the next tile's loads.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true: the disparity guard max(acc, 1e-38) needs
// denormals, and the encoding needs the accurate sinf.

#include "mma_tile.cuh"

using namespace nerface;

namespace {

struct Args {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const float* bg;     // (R, 3) or null
  const bf16* W;       // packed weights
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

template <int S, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) render_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RenderSmem& sm = *reinterpret_cast<RenderSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray0 = blockIdx.x * RAYS;

  // 1.-3. encode, the MLP, the σ and rgb heads (mma_tile.cuh)
  render_tile<S, SMALL>(sm, a.ro, a.rd, a.z, a.dir_c, a.W, a.F, ray0, a.n_rays, a.n_freqs);

  // 4. compositing: warp w owns ray ray0 + w; lane l owns samples
  // [l·SPL, (l+1)·SPL).
  constexpr int SPL = S / 32;
  const int ray = ray0 + warp;
  if (warp >= RAYS || ray >= a.n_rays) return;
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
    float sa = fmaxf(sm.sigma[row], 0.f);
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
      const float raw = sm.rgb[row * 3 + ch];
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

template <int S, bool SMALL>
struct Render {
  static int run(const Args& args, int grid, cudaStream_t s) {
    return launch_tiles(render_kernel<S, SMALL>, sizeof(RenderSmem), grid, s, args);
  }
};

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_paper_render(const float* ro, const float* rd, const float* z,
                                          const float* dir_c, const float* bg, const void* W,
                                          const float* F, float* rgb, float* disp, float* acc,
                                          float* depth, float* bgw, float* weights,
                                          int n_rays, int n_samples, int n_freqs, int white_bg,
                                          int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  Args args{ro,  rd,  z,     dir_c, bg,  static_cast<const bf16*>(W), F,      rgb,     disp,
            acc, depth, bgw, weights, n_rays, n_freqs, white_bg};
  const long long rows = (long long)n_rays * n_samples;
  const int grid = (int)((rows + TILE_ROWS - 1) / TILE_ROWS);
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_pass<Render>(n_samples, small, args, grid, s);
}
