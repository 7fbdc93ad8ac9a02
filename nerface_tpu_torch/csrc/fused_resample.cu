// Fused hierarchical resample on Hopper (sm_90a): the inverse-CDF draw of
// the fine samples from the coarse weights and the sorted union with the
// coarse depths, in one kernel.
//
// Replaces K5 of the JAX package, the Pallas TPU kernel `_resample_kernel`
// (nerface_tpu/ops/pallas/fused_mlp.py:837) behind `fused_resample`
// (pallas_call at fused_mlp.py:973). Python side:
// nerface_tpu_torch/ops/kernels/fused_resample.py (wrapper and the plain
// PyTorch version `fused_resample_reference`, which is the pipeline's
// `sample_pdf` + `merge_sorted_zvals`).
//
// Per ray, with z and w the ray's Sc coarse depths and weights and u its Sf
// draws (or one (Sf,) row shared by every ray):
//   pdf  = (w[1:Sc-1] + 1e-5) / Σ (w[1:Sc-1] + 1e-5)           (Sc-2 values)
//   cdf  = [0, cumsum(pdf)],  bins = (z[1:] + z[:-1]) / 2         (Sc-1 values)
//   k    = #{cdf ≤ u}  (searchsorted, right),  below = max(k-1, 0),
//          above = min(k, Sc-2);  denom = cdf[above] - cdf[below], 1 if < 1e-5
//   s    = bins[below] + (u - cdf[below]) / denom · (bins[above] - bins[below])
//   out  = the sorted union of z and the Sf samples              (Sc+Sf values)
//
// Design: one warp per ray, RAYS_PER_CTA rays per CTA, nothing but the
// output written to device memory.
//   1. the warp loads z and w coalesced (each lane Sc/32 of each) into
//      registers and its slice of shared memory; the pdf's normaliser is a
//      warp reduction, the cdf a warp inclusive scan in f32, chunk by chunk
//      of 32 with a carry; cdf and bins stay in shared memory;
//   2. each lane draws its samples q = lane, lane + 32, ...: a binary search
//      over the cdf finds k, and the interpolation runs with the reference's
//      denom < 1e-5 → 1 rule in separately rounded operations (no FMA
//      contraction: __fadd_rn / __fmul_rn / __fdiv_rn), as PyTorch's
//      elementwise kernels compute it;
//   3. in the general regime the samples are bitonic-sorted in shared
//      memory (padded with +inf to a power of two); with `sorted_u` (u
//      non-decreasing, e.g. the deterministic linspace draws) the draw is
//      monotone in u and the sort is skipped;
//   4. merge by ranks: z_i goes to i + #{s < z_i} and s_q to q + #{z ≤ s_q},
//      each count a binary search in the other sorted list (ties put z
//      first, as both JAX regimes do; equal values are equal, so the output
//      is the same for any tie order), scattered into shared memory and
//      stored coalesced.
// The shared (Sf,) u row is read once per CTA.
//
// Bound: bytes. No tensor-core work; at 65536 rays × (64 + 64) samples it
// reads z and w (2 × 16.8 MB, and u, 16.8 MB, in the general regime) and
// writes 33.5 MB: ≈ 84 MB, ≈ 25 µs at 3.35 TB/s. The design reads each
// input once and writes each output once; everything in between lives in
// registers and shared memory.
//
// Shapes: Sc ∈ {32, 64, 128} (a template argument), 1 ≤ Sf ≤ 128,
// Sc + Sf ≤ 256, z sorted per ray, any R (the last CTA's spare warps exit).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int RAYS_PER_CTA = 8;  // one warp per ray
constexpr int MAX_FINE = 128;
constexpr int MAX_OUT = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int SC>
struct WarpSmem {
  float z[SC];
  float cdf[SC];   // Sc - 1 used
  float bins[SC];  // Sc - 1 used
  float s[MAX_FINE];
  float out[MAX_OUT];
};

// first index in a[0, n) whose value is > x (a non-decreasing)
__device__ __forceinline__ int upper_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in a[0, n) whose value is >= x (a non-decreasing)
__device__ __forceinline__ int lower_bound(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int SC, bool SORTED>
__global__ void __launch_bounds__(RAYS_PER_CTA * 32)
resample_kernel(const float* __restrict__ z, const float* __restrict__ w,
                const float* __restrict__ u, int u_shared, float* __restrict__ out, int n_rays,
                int n_fine) {
  __shared__ float u_row[MAX_FINE];
  __shared__ WarpSmem<SC> smem[RAYS_PER_CTA];
  constexpr int B = SC - 1;     // cdf and bins
  constexpr int PER = SC / 32;  // z and w values a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (u_shared) {
    for (int q = threadIdx.x; q < n_fine; q += blockDim.x) u_row[q] = u[q];
  }
  __syncthreads();
  const int ray = blockIdx.x * RAYS_PER_CTA + warp;
  if (ray >= n_rays) return;
  WarpSmem<SC>& m = smem[warp];
  const float* zr = z + (size_t)ray * SC;
  const float* wr = w + (size_t)ray * SC;

  // 1. z, the shifted weights and their sum
  float wv[PER];
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = k * 32 + lane;
    m.z[i] = zr[i];
    wv[k] = (i >= 1 && i <= SC - 2) ? __fadd_rn(wr[i], 1e-5f) : 0.f;
    part = __fadd_rn(part, wv[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(FULL, part, o));
  const float total = part;
  __syncwarp();
  for (int i = lane; i < B; i += 32) m.bins[i] = __fmul_rn(0.5f, __fadd_rn(m.z[i + 1], m.z[i]));
  // cdf[i] = Σ pdf over weight indices 1..i, chunk by chunk with a carry
  float carry = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = k * 32 + lane;
    float v = (i >= 1 && i <= SC - 2) ? __fdiv_rn(wv[k], total) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = __fadd_rn(v, t);
    }
    v = __fadd_rn(carry, v);
    if (i >= 1 && i <= SC - 2) m.cdf[i] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  if (lane == 0) m.cdf[0] = 0.f;
  __syncwarp();

  // 2. the inverse-CDF draw
  const float* ur = u_shared ? u_row : u + (size_t)ray * n_fine;
  for (int q = lane; q < n_fine; q += 32) {
    const float uq = ur[q];
    const int k = upper_bound(m.cdf, B, uq);
    const int below = k > 0 ? k - 1 : 0;
    const int above = k < B - 1 ? k : B - 1;
    const float cb = m.cdf[below], bb = m.bins[below];
    float denom = __fsub_rn(m.cdf[above], cb);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(uq, cb), denom);
    m.s[q] = __fadd_rn(bb, __fmul_rn(t, __fsub_rn(m.bins[above], bb)));
  }
  __syncwarp();

  // 3. sort the draws (general regime): bitonic over a power of two
  if (!SORTED) {
    int p = 1;
    while (p < n_fine) p <<= 1;
    for (int q = n_fine + lane; q < p; q += 32) m.s[q] = __int_as_float(0x7f800000);  // +inf
    __syncwarp();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = lane; i < p; i += 32) {
          const int ij = i ^ j;
          if (ij > i) {
            const float a = m.s[i], b = m.s[ij];
            const bool up = (i & k) == 0;
            if (up ? a > b : a < b) {
              m.s[i] = b;
              m.s[ij] = a;
            }
          }
        }
        __syncwarp();
      }
    }
  }

  // 4. merge by ranks, then one coalesced store of the row
  for (int i = lane; i < SC; i += 32) {
    const float zi = m.z[i];
    m.out[i + lower_bound(m.s, n_fine, zi)] = zi;
  }
  for (int q = lane; q < n_fine; q += 32) {
    const float sq = m.s[q];
    m.out[q + upper_bound(m.z, SC, sq)] = sq;
  }
  __syncwarp();
  const int n_out = SC + n_fine;
  float* orow = out + (size_t)ray * n_out;
  for (int i = lane; i < n_out; i += 32) orow[i] = m.out[i];
}

template <int SC>
int launch(const float* z, const float* w, const float* u, int u_shared, float* out, int n_rays,
           int n_fine, int sorted_u, cudaStream_t stream) {
  const int grid = (n_rays + RAYS_PER_CTA - 1) / RAYS_PER_CTA;
  if (sorted_u)
    resample_kernel<SC, true><<<grid, RAYS_PER_CTA * 32, 0, stream>>>(z, w, u, u_shared, out,
                                                                     n_rays, n_fine);
  else
    resample_kernel<SC, false><<<grid, RAYS_PER_CTA * 32, 0, stream>>>(z, w, u, u_shared, out,
                                                                      n_rays, n_fine);
  return (int)cudaGetLastError();
}

}  // namespace

// z, w (n_rays, n_coarse), u (n_rays, n_fine) or (n_fine,) with u_shared,
// out (n_rays, n_coarse + n_fine), all f32 and contiguous. Returns a
// cudaError_t (0 on success). Launches on `stream`, does not synchronise and
// allocates nothing.
extern "C" int nerface_fused_resample(const float* z, const float* w, const float* u, int u_shared,
                                      float* out, int n_rays, int n_coarse, int n_fine,
                                      int sorted_u, void* stream) {
  if (n_rays < 0 || n_fine < 1 || n_fine > MAX_FINE || n_coarse + n_fine > MAX_OUT)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_coarse) {
    case 32: return launch<32>(z, w, u, u_shared, out, n_rays, n_fine, sorted_u, s);
    case 64: return launch<64>(z, w, u, u_shared, out, n_rays, n_fine, sorted_u, s);
    case 128: return launch<128>(z, w, u, u_shared, out, n_rays, n_fine, sorted_u, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
