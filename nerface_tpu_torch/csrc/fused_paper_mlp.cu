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
// K3b: K1's launches (fused_train_pass.cu, paper_train.cuh) with K3b's
// middle: `train_pass_kernel` recomputes the forward on wgmma (storing
// every activation to the workspace as operand images), reads each row's
// cotangent of raw [rgb, σ] from g (zero past the last ray), and runs the
// dX chain; then `dw_wgmma_kernel` (wgmma_dw.cuh) and the two
// `reduce_rows`. No atomics: the gradients are bit-identical over
// launches. Matrix gradients come out in f32; the wrapper's
// autograd.Function rounds them to bf16 as the JAX package's VJP does.
//
// Bound: K3f is tensor-core bound: K2's MLP work, ≈ 0.98 MFLOP a sample at
// the function's widths (0.85 for the smaller model); it stays on the
// mma.sync tile of mma_tile.cuh (a later PR's). K3b does K1's forward + dX
// + dW, ≈ 2.885 MFLOP a sample (2.49 small), and is bound, as K1 is, by
// the workspace's bytes (paper_train.cuh).
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

// K3b's middle: each row's cotangent of raw [rgb, σ] from g (R, S, 4),
// zero past the last ray.
struct K3bPolicy {
  const float* g;
  int n_rays;

  template <int S>
  __device__ __forceinline__ void middle(const float*, const float*, float* gsig, float* grgb, int ray0, int,
                                         int) const {
    constexpr int ROWS = 64 * k1::Geometry<S>::UNITS;
    const size_t row0 = (size_t)ray0 * S, rows = (size_t)n_rays * S;
    for (int e = threadIdx.x & 127; e < ROWS * 4; e += 128) {
      const int r = e >> 2, c = e & 3;
      const float v = row0 + r < rows ? g[(row0 + r) * 4 + c] : 0.f;
      if (c < 3) {
        grgb[r * 3 + c] = v;
      } else {
        gsig[r] = v;
      }
    }
  }
};

template <int S, bool SMALL>
struct Forward {
  static int run(const FwdArgs& a, int grid, cudaStream_t st) {
    return launch_tiles(mlp_fwd_kernel<S, SMALL>, sizeof(RenderSmem), grid, st, a);
  }
};

template <int S, bool SMALL>
struct Backward {
  static int run(const k1::PassArgs& pa, const K3bPolicy& policy, float* dW, float* dF, cudaStream_t st) {
    return k1::launch_pass<S, SMALL>(pa, policy, dW, dF, st);
  }
};

}  // namespace

// Shared memory a CTA of each kernel takes (dynamic): out[0]
// mlp_fwd_kernel, out[1] train_pass_kernel, out[2] dw_wgmma_kernel (both
// with their 1 KB alignment pad).
extern "C" void nerface_fused_paper_mlp_shared_bytes(long long* out) {
  out[0] = (long long)sizeof(RenderSmem);
  out[1] = (long long)k1::SMEM_BYTES;
  out[2] = (long long)DWG_SMEM_BYTES;
}

// Bytes of device workspace one backward call needs.
extern "C" long long nerface_fused_paper_mlp_workspace_bytes(int n_rays, int n_samples) {
  return k1::workspace_bytes(n_rays, n_samples);
}

// K3f. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_paper_mlp_fwd(const float* ro, const float* rd, const float* z,
                                           const float* dir_c, const void* W, const float* F, float* out,
                                           int n_rays, int n_samples, int n_freqs, int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)n_rays * n_samples + TILE_ROWS - 1) / TILE_ROWS;
  if (tiles == 0) return 0;
  FwdArgs a{ro, rd, z, dir_c, static_cast<const bf16*>(W), F, out, n_rays, n_freqs};
  return dispatch_pass<Forward>(n_samples, small, a, (int)tiles, static_cast<cudaStream_t>(stream));
}

// K3b. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing: `workspace` holds
// nerface_fused_paper_mlp_workspace_bytes(n_rays, n_samples) bytes. W and
// WT are the chunk images of the packed weights and of the transposed
// trunk (`pack_sm90_chunks`, as K1 takes them; K3f takes W plain). dW is
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
  k1::Workspace ws;
  k1::carve(static_cast<unsigned char*>(workspace), k1::pass_units(n_rays, n_samples),
            k1::pass_ctas(n_rays, n_samples), &ws);
  k1::PassArgs pa{ro, rd, z, dir_c, static_cast<const bf16*>(W), static_cast<const bf16*>(WT), F, d_dir, ws,
                  n_rays, n_freqs};
  return dispatch_pass<Backward>(n_samples, small, pa, K3bPolicy{g, n_rays}, dW, dF,
                                 static_cast<cudaStream_t>(stream));
}
