// The NeRFace paper model's MLP on Hopper (sm_90a), without compositing:
// its forward (K3f) and its backward (K3b).
//
// Replaces K3 of the JAX package, the Pallas TPU kernels behind
// nerface_tpu/ops/pallas/fused_mlp.py::fused_paper_mlp: `_fwd_kernel`
// (pallas_call at fused_mlp.py:473) and `_bwd_kernel` (pallas_call at
// fused_mlp.py:523), the custom VJP whose backward recomputes the forward.
// Python side: nerface_tpu_torch/ops/kernels/fused_mlp.py (the wrappers
// `fused_paper_mlp_forward` / `fused_paper_mlp_backward`, the
// autograd.Function and the plain PyTorch versions). The paper model's
// training passes that K1 does not take (a coarse-only run) and the render
// passes that K2 does not take (σ-noise > 0) run their MLP here; `small`
// selects the smaller paper model (no layers_xyz.5).
//
// K3f: one 512-thread CTA per 128-row tile runs K2's MLP (`render_tile`,
// mma_tile.cuh: encode, the trunk, the heads; bf16 mma.sync with f32
// accumulation, the weights streamed from L2 through shared memory) and
// writes each row's raw [rgb, σ] to the (R, S, 4) f32 output. It saves
// nothing: the backward recomputes, as the TPU kernel's VJP does.
//
// K3b: K1's launches (fused_train_pass.cu) with the first one replaced:
//   1. recompute_kernel: `train_tile` (paper_train.cuh), the forward that
//      writes xin, h0..h5, feat, hd_pre, x1, x2 to the workspace; then the
//      row cotangents of raw rgb and σ loaded from g into the workspace,
//      and the σ/rgb heads' partial sums (`head_partials`);
//   2.-5. train_bwd_kernel (dX), dw_kernel (dW) and the two reduce_rows,
//      K1's own (`launch_paper_backward`).
// No atomics: the gradients are bit-identical over launches. Matrix
// gradients come out in f32; the wrapper's autograd.Function rounds them
// to bf16 as the JAX package's VJP does.
//
// Bound: tensor-core throughput. K3f does K2's MLP work, ≈ 0.98 MFLOP a
// sample at the function's widths (0.85 for the smaller model); K3b K1's
// forward + dX + dW, ≈ 2.885 MFLOP a sample (2.49 small). Its workspace
// traffic is K1's (≈ 8.8 KB a row written once, read by dX and dW), near
// the balance point of an H100's 3.35 TB/s and bf16 dense peak. wgmma, TMA
// and a persistent grid are later work (see fused_paper_render.cu).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "paper_train.cuh"

using namespace nerface;

namespace {

struct FwdArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // packed weights (fused_mlp.py W_LAYOUT)
  const float* F;      // packed bias rows + frequency bands (F_LAYOUT)
  float* out;          // (R, S, 4): raw rgb, σ
  int n_rays, n_freqs;
};

template <int S, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) mlp_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RenderSmem& sm = *reinterpret_cast<RenderSmem*>(smem_raw);
  const int ray0 = blockIdx.x * (TILE_ROWS / S);
  render_tile<S, SMALL>(sm, a.ro, a.rd, a.z, a.dir_c, a.W, a.F, ray0, a.n_rays, a.n_freqs);
  // the tile's rows [rgb, σ], 4 floats each, neighbouring threads on
  // neighbouring addresses; rows past the last ray are not written
  const size_t row0 = (size_t)blockIdx.x * TILE_ROWS;
  const size_t rows = (size_t)a.n_rays * S;
  for (int e = threadIdx.x; e < TILE_ROWS * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    if (row0 + r < rows) a.out[(row0 + r) * 4 + c] = c < 3 ? sm.rgb[r * 3 + c] : sm.sigma[r];
  }
}

struct RecomputeArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const float* g;      // (R, S, 4): the cotangent of [rgb, σ]
  const bf16* W;
  const float* F;
  Workspace ws;
  int n_rays, n_freqs;
};

template <int S, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1) recompute_kernel(const RecomputeArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tile = blockIdx.x;
  const bf16* x2 = train_tile<S, SMALL>(sm, a.ro, a.rd, a.z, a.dir_c, a.W, a.F, a.ws, tile, a.n_rays,
                                        a.n_freqs);
  // the rows' head cotangents; zero past the last ray
  const size_t row0 = (size_t)tile * TILE_ROWS;
  const size_t rows = (size_t)a.n_rays * S;
  for (int e = threadIdx.x; e < TILE_ROWS * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    const float v = row0 + r < rows ? a.g[(row0 + r) * 4 + c] : 0.f;
    if (c < 3)
      sm.grgb[r * 3 + c] = v;
    else
      sm.gsig[r] = v;
  }
  __syncthreads();
  head_partials(sm, a.ws, tile, x2);
}

template <int S, bool SMALL>
struct Forward {
  static int run(const FwdArgs& a, int grid, cudaStream_t st) {
    return launch_tiles(mlp_fwd_kernel<S, SMALL>, sizeof(RenderSmem), grid, st, a);
  }
};

template <int S, bool SMALL>
struct Backward {
  static int run(const RecomputeArgs& ra, const BwdArgs& ba, long long tiles, float* dW, float* dF,
                 cudaStream_t st) {
    int err = launch_tiles(recompute_kernel<S, SMALL>, sizeof(FwdSmem), (int)tiles, st, ra);
    if (err != 0) return err;
    return launch_paper_backward<S, SMALL>(ba, tiles, dW, dF, st);
  }
};

}  // namespace

// Shared memory a CTA of each kernel takes: out[0] mlp_fwd_kernel, out[1]
// recompute_kernel, out[2] train_bwd_kernel (dynamic), out[3] dw_kernel
// (static).
extern "C" void nerface_fused_paper_mlp_shared_bytes(long long* out) {
  out[0] = (long long)sizeof(RenderSmem);
  out[1] = (long long)sizeof(FwdSmem);
  out[2] = (long long)sizeof(BwdSmem);
  out[3] = (long long)DW_SMEM_BYTES;
}

// Bytes of device workspace one backward call needs.
extern "C" long long nerface_fused_paper_mlp_workspace_bytes(int n_rays, int n_samples) {
  return workspace_bytes(n_rays, n_samples);
}

// K3f. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_paper_mlp_fwd(const float* ro, const float* rd, const float* z,
                                           const float* dir_c, const void* W, const float* F, float* out,
                                           int n_rays, int n_samples, int n_freqs, int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  const long long tiles = pass_tiles(n_rays, n_samples);
  if (tiles == 0) return 0;
  FwdArgs a{ro, rd, z, dir_c, static_cast<const bf16*>(W), F, out, n_rays, n_freqs};
  return dispatch_pass<Forward>(n_samples, small, a, (int)tiles, static_cast<cudaStream_t>(stream));
}

// K3b. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing: `workspace` holds
// nerface_fused_paper_mlp_workspace_bytes(n_rays, n_samples) bytes. dW is
// the f32 gradient in the packed weight layout (W_OFF_TOTAL), dF in the
// bias-row layout (F_OFF_TOTAL: COND0/COND3 hold d_cond0/d_cond3; FREQS and
// the smaller model's W5/B5 slots are 0), d_dir (R, 128).
extern "C" int nerface_fused_paper_mlp_bwd(const float* ro, const float* rd, const float* z,
                                           const float* dir_c, const float* g, const void* W,
                                           const void* WT, const float* F, float* dW, float* dF,
                                           float* d_dir, void* workspace, int n_rays, int n_samples,
                                           int n_freqs, int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  if (n_samples != 32 && n_samples != 64 && n_samples != 128) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const long long tiles = pass_tiles(n_rays, n_samples);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), tiles * TILE_ROWS, tiles, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  RecomputeArgs ra{ro, rd, z, dir_c, g, Wb, F, ws, n_rays, n_freqs};
  BwdArgs ba{Wb, static_cast<const bf16*>(WT), d_dir, ws, n_rays};
  return dispatch_pass<Backward>(n_samples, small, ra, ba, tiles, dW, dF,
                                 static_cast<cudaStream_t>(stream));
}
