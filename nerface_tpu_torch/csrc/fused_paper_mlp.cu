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
// K3f: K2's forward chain (paper_chain.cuh, on wgmma_chain.cuh) without
// the cluster, as K4f runs it: one persistent 384-thread CTA an SM
// (k1::pass_ctas), warpgroup 2 streaming the weights' chunk images through
// a 5-stage bulk-copy ring and encoding each 64-row unit's [xyz; PE; 0],
// warpgroups 0 and 1 running free of each other over whole rays
// (wgmma m64n256k16 / m64n128k16 with A in registers, the heads on m64n8).
// After the heads each row's raw [rgb, σ] (σ = head + ba, rgb = head +
// brgb: what K2 composites) goes out as one float4, the eight rows of a
// warp's store one 128-byte line; rows past the last ray are not written.
// It saves nothing: the backward recomputes, as the TPU kernel's VJP does.
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
// the function's widths (0.85 for the smaller model): 4.17 / 8.34 ms for a
// 65536-ray tile at S = 64 / 128 at the H100's 989 TFLOP/s bf16 dense
// peak, against 52 / 69 MB of rays in and 67 / 134 MB of rows out (36 /
// 61 µs at 3.35 TB/s). K3b does K1's forward + dX + dW, ≈ 2.885 MFLOP a
// sample (2.49 small), and is bound, as K1 is, by the workspace's bytes
// (paper_train.cuh).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "paper_chain.cuh"
#include "paper_train.cuh"

using namespace nerface;
using namespace nerface::sm90;

namespace {

struct FwdArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // the weights' chunk images (W_OFF_* offsets, as K2 takes them)
  const float* F;      // packed bias rows + frequency bands (F_LAYOUT)
  float* out;          // (R, S, 4): raw rgb, σ
  int n_rays;
  UnitLayout l;  // the pass's S, and its items' rays and units (host-computed)
  int n_freqs;
};

constexpr size_t FWD_SMEM_BYTES = sizeof(PaperChainSmem) + ATOM_BYTES;  // + the alignment pad

// A consumer warpgroup over its units: the chain, then the rows out. Its
// k-th unit is unit k % units() of the item of round blockIdx.x + (k /
// units())·gridDim.x; the item's row i < rows() is row ray0·S + i of the
// pass (sample i % S of ray ray0 + i / S), a padding row after. A
// warpgroup whose rays are past the last computes zeros and stores nothing,
// so both consumers walk the same chunk sequence.
template <int SF, bool SMALL>
__device__ __forceinline__ void fwd_consume(PaperChainSmem& sm, const FwdArgs& a, int wg, int n_rounds) {
  const UnitSchedule<SF, 1> g{a.l};
  const int lane = threadIdx.x & 31;
  const int r0 = k1::frag_row();  // the thread's accumulator rows: r0 and r0 + 8 of a unit
  Ring ring;
  float acc[128];
  uint32_t act[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) act[i] = 0u;

  for (int k = 0;; ++k) {
    const int units = g.units();
    const int round = blockIdx.x + (k / units) * gridDim.x;
    if (round >= n_rounds) break;
    const int item = g.item(round, 0, wg);
    const int b = xin_buf(k, g.xc());
    mbar_wait(&sm.xin_full[wg][b], xin_phase(k, g.xc()));
    float hs[4], hc[4];
    paper_unit<SMALL, 1>(acc, act, smem_u32(xin_at(sm.xin, wg, b, g.xc())), sm, ring, 0, &sm.xin_empty[wg][b],
                         a.dir_c, g, item * g.wg_rays(), k % units, a.n_rays, hs, hc);
    const int rows = g.rows();
    const int i0 = (k % units) * 64 + r0;  // the item's row of the thread's first row
    // a padding row's ray is n_rays: it is not stored
    const int ray_h[2] = {i0 < rows ? item * g.wg_rays() + g.ray_of(i0) : a.n_rays,
                          i0 + 8 < rows ? item * g.wg_rays() + g.ray_of(i0 + 8) : a.n_rays};
    // hs / hc[2h + j]: row r0 + 8h, column 2·(lane % 4) + j; lane q = 1
    // holds rgb's third column, handed to lane q = 0, which stores the row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float b2 = __shfl_down_sync(0xffffffffu, hc[2 * h], 1);
      const size_t row = (size_t)item * rows + i0 + 8 * h;  // the pass's row
      if ((lane & 3) == 0 && ray_h[h] < a.n_rays)
        *reinterpret_cast<float4*>(a.out + row * 4) =
            make_float4(hc[2 * h] + sm.f[F_OFF_BRGB], hc[2 * h + 1] + sm.f[F_OFF_BRGB + 1],
                        b2 + sm.f[F_OFF_BRGB + 2], hs[2 * h] + sm.f[F_OFF_BA]);
    }
  }
}

template <int SF, bool SMALL>
__global__ void __launch_bounds__(PAPER_THREADS, 1) mlp_fwd_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  PaperChainSmem& sm = *reinterpret_cast<PaperChainSmem*>(smem_raw + pad);
  const UnitSchedule<SF, 1> g{a.l};
  paper_setup<1>(sm, a.W, a.F, K_XIN * g.xc());
  const int n_rounds = g.rounds(a.n_rays);
  const int wg = threadIdx.x / 128;
  if (wg == CHAIN_CONSUMERS) {
    reg_dealloc<40>();
    paper_feed<SMALL, 1>(sm, a, g, 0, blockIdx.x, gridDim.x, n_rounds);
  } else {
    reg_alloc<232>();
    fwd_consume<SF, SMALL>(sm, a, wg, n_rounds);
  }
}

// K3b's middle: each row's cotangent of raw [rgb, σ] from g (R, S, 4),
// zero on the item's padding rows and past the last ray.
struct K3bPolicy {
  const float* g;
  int n_rays;

  template <class G>
  __device__ __forceinline__ void middle(const float*, const float*, float* gsig, float* grgb, int ray0,
                                         const G& l, int, int) const {
    const int real = l.rows();  // the item's real rows; the rest pad its last unit
    const size_t row0 = (size_t)ray0 * l.samples(), rows = (size_t)n_rays * l.samples();
    for (int e = threadIdx.x & 127; e < l.units() * 64 * 4; e += 128) {
      const int r = e >> 2, c = e & 3;
      const float v = r < real && row0 + r < rows ? g[(row0 + r) * 4 + c] : 0.f;
      if (c < 3) {
        grgb[r * 3 + c] = v;
      } else {
        gsig[r] = v;
      }
    }
  }
};

template <int SF, bool SMALL>
struct Forward {
  static int run(const FwdArgs& a, cudaStream_t st) {
    auto kernel = mlp_fwd_kernel<SF, SMALL>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    kernel<<<k1::pass_ctas(a.n_rays, a.l.S), PAPER_THREADS, FWD_SMEM_BYTES, st>>>(a);
    return (int)cudaGetLastError();
  }
};

template <int SF, bool SMALL>
struct Backward {
  static int run(const k1::PassArgs& pa, const K3bPolicy& policy, float* dW, float* dF, cudaStream_t st) {
    return k1::launch_pass<SF, SMALL>(pa, policy, dW, dF, st);
  }
};

}  // namespace

// Shared memory a CTA of each kernel takes (dynamic, each with its 1 KB
// alignment pad): out[0] mlp_fwd_kernel, out[1] train_pass_kernel, out[2]
// dw_wgmma_kernel.
extern "C" void nerface_fused_paper_mlp_shared_bytes(long long* out) {
  out[0] = (long long)FWD_SMEM_BYTES;
  out[1] = (long long)k1::SMEM_BYTES;
  out[2] = (long long)DWG_SMEM_BYTES;
}

// Bytes of device workspace one backward call needs (-1 for n_freqs
// outside 1..MAX_FREQS).
extern "C" long long nerface_fused_paper_mlp_workspace_bytes(int n_rays, int n_samples, int n_freqs) {
  if (n_freqs < 1 || n_freqs > MAX_FREQS) return -1;
  return k1::workspace_bytes(n_rays, n_samples, xin_extent(n_freqs));
}

// K3f. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for
// n_samples outside 1..MAX_SAMPLES or n_freqs outside 1..MAX_FREQS).
// Launches on `stream`, does not synchronise and allocates nothing. W is
// packed at the bands' encoding extent (`xin_extent`).
extern "C" int nerface_fused_paper_mlp_fwd(const float* ro, const float* rd, const float* z,
                                           const float* dir_c, const void* W, const float* F, float* out,
                                           int n_rays, int n_samples, int n_freqs, int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || n_freqs > MAX_FREQS) return (int)cudaErrorInvalidValue;
  if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int xc = xin_extent(n_freqs) / K_XIN;
  FwdArgs a{ro,     rd,     z, dir_c, static_cast<const bf16*>(W), F, out, n_rays, UnitLayout::of(n_samples, xc),
            n_freqs};
  return dispatch_pass<Forward>(n_samples, small, xc, a, static_cast<cudaStream_t>(stream));
}

// K3b. Returns a cudaError_t (0 on success; cudaErrorInvalidValue as K3f).
// Launches on `stream`, does not synchronise and allocates nothing:
// `workspace` holds nerface_fused_paper_mlp_workspace_bytes(n_rays,
// n_samples, n_freqs) bytes. W and WT are the chunk images of the packed
// weights and of the transposed trunk (`pack_sm90_chunks`, as K1 takes
// them; K3f takes the same W). dW is the f32 gradient in the packed weight
// layout at the bands' encoding extent kx (w_off(W_OFF_TOTAL, kx)), dF in
// the bias-row layout (F_OFF_TOTAL: COND0/COND3 hold d_cond0/d_cond3;
// FREQS and the smaller model's W5/B5 slots are 0), d_dir (R, 128).
extern "C" int nerface_fused_paper_mlp_bwd(const float* ro, const float* rd, const float* z,
                                           const float* dir_c, const float* g, const void* W,
                                           const void* WT, const float* F, float* dW, float* dF,
                                           float* d_dir, void* workspace, int n_rays, int n_samples,
                                           int n_freqs, int small, void* stream) {
  if (n_rays < 0 || n_freqs < 1 || n_freqs > MAX_FREQS) return (int)cudaErrorInvalidValue;
  if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int kx = xin_extent(n_freqs);
  k1::Workspace ws;
  k1::carve(static_cast<unsigned char*>(workspace), k1::pass_units(n_rays, n_samples),
            k1::pass_ctas(n_rays, n_samples), kx, UnitLayout::of(n_samples).units, &ws);
  k1::PassArgs pa{ro, rd, z, dir_c, static_cast<const bf16*>(W), static_cast<const bf16*>(WT), F, d_dir, ws,
                  n_rays, UnitLayout::of(n_samples, kx / K_XIN), n_freqs};
  return dispatch_pass<Backward>(n_samples, small, kx / K_XIN, pa, K3bPolicy{g, n_rays}, dW, dF,
                                 static_cast<cudaStream_t>(stream));
}
