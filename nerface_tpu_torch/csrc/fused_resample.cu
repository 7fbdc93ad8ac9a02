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
// Bound: bytes. No tensor-core work; at 65536 rays × (64 + 64) samples it
// reads z and w (2 × 16.8 MB, and u, 16.8 MB, in the general regime) and
// writes 33.5 MB: ≈ 84 MB, ≈ 25 µs at 3.35 TB/s (67 MB, 20 µs, with one
// shared u row); at 64 + 256 (the long regime below) ≈ 185 MB, ≈ 55 µs
// (118 MB, 35 µs). Everything between the loads and the store lives in
// registers, apart from a warp's cdf, bins and z rows in shared memory.
//
// Design: a persistent grid (as many CTAs as fit on the card, WARPS warps
// each) whose warps walk the rays, one ray a warp at a time, the next
// ray's z / w (and u) rows loaded into registers while this one is worked
// on. Sc is padded to its class SC (32, 64, 128 or 256: the least power of
// two ≥ Sc, from 32): the padded z are +inf, so they sort last and are
// never written out; the padded w weigh nothing; the padded cdf entries
// are +inf, so no draw's search counts them. Per ray:
//   1. the scan, in registers: lane l holds z and w at [PER·l, PER·l + PER)
//      (one 4-, 8- or 16-byte load each where Sc = SC, else one load an
//      element); the normaliser is a butterfly
//      sum, the cdf the lane's running sum plus an exclusive warp scan of
//      the lanes' totals; cdf, bins and z go to the warp's rows in shared
//      memory (vector stores);
//   2. the draws: lane l draws q = FP·l .. FP·l + FP - 1 (+inf past Sf): a
//      branch-free search of log2(SC) steps over the cdf finds k, and the
//      interpolation runs with the reference's denom < 1e-5 → 1 rule in
//      separately rounded operations (no FMA contraction: __fadd_rn /
//      __fmul_rn / __fdiv_rn), as PyTorch's elementwise kernels compute it;
//   3. in the general regime the draws are bitonic-sorted across the warp in
//      registers (shuffles, FP a lane); with `sorted_u` (u non-decreasing,
//      e.g. the deterministic linspace draws) the draw is monotone in u and
//      they come out sorted;
//   4. the union: a warp's N = 32·E registers (N the power of two ≥ SC +
//      32·FP, at most 512) hold z ascending (lanes below SC / E, read back
//      from shared memory) and then the draws descending (moved into place
//      by one shuffle a register), a bitonic sequence that log2(N) merge
//      stages sort; equal values are equal, so the output is what any tie
//      order (the reference puts z first) gives. Its first Sc + Sf values
//      are the row: lane l stores those of [E·l, E·l + E), with 16-byte
//      stores where the row's length is a multiple of 4.
// The shared (Sf,) u row is read once per CTA. The work is a pure function
// of the ray's inputs: launches are bit-identical.
//
// Shapes of that design: Sc + Sf ≤ SHORT_OUT = 256; SC and FP (1, 2, 4 or
// 8 draws a lane, 32·FP ≥ Sf) are the template arguments, 15 pairs × 2
// regimes.
//
// The long regime, Sc + Sf in SHORT_OUT + 1 .. MAX_OUT (`resample_long_kernel`): a
// ray no longer fits a warp's registers (its union alone is up to 1024
// values, and the network above holds at most 512), so a warp keeps the
// ray's rows in shared memory, `LongRows`: z, the weights and then the
// cdf, the bins and the draws, MAX_OUT floats each, one padding word after
// every 32 (`at`) so that a lane's run of consecutive entries and a
// lane-strided sweep both hit 32 banks. Per ray:
//   1. z and w into the rows (coalesced, lane-strided; z +inf and w 0 past
//      Sc); the cdf in the short kernel's order of sums, lane l owning the
//      run [PER·l, PER·l + PER), PER = SC / 32 with SC Sc's class (32 ..
//      1024): the lane's run summed in order, the butterfly sum of the 32
//      lanes' runs (xor 16, 8, 4, 2, 1), each run's running sum of w / total
//      plus the exclusive Hillis-Steele scan of the runs' totals (shifts 1,
//      2, 4, 8, 16), every operation separately rounded; at Sc ≤ 256 this
//      is the short kernel's cdf bit for bit;
//   2. the draws q = lane, lane + 32, ...: the short kernel's branch-free
//      search over the SC-entry cdf and its interpolation, __fadd_rn /
//      __fmul_rn / __fdiv_rn; +inf past Sf;
//   3. in the general regime a bitonic sort of the draws in shared memory
//      (the pairs of a stage lane-strided, a __syncwarp between stages);
//      with `sorted_u` none;
//   4. the union as a merge by rank, no network: z[i] goes to i + #(draws
//      < z[i]) and draw j to j + #(z ≤ draw j), each count a binary search
//      of the other sorted list (padded with +inf to one less than a power
//      of two past its length); two sorted lists merge exactly, ties in the
//      reference's z-first order. The row is staged in the cdf's place and
//      stored coalesced.
// `LONG_WARPS` warps a CTA, a persistent grid as the short kernel's.
//
// Shapes: 3 ≤ Sc, 1 ≤ Sf, Sc + Sf ≤ MAX_OUT, the port's one sample limit
// (`MAX_SAMPLES`, wgmma_chain.cuh: 1024); z sorted per ray, any R. The
// wrapper refuses anything else, and so does the entry point
// (cudaErrorInvalidValue).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast math).

#include <cuda_runtime.h>

#include "wgmma_chain.cuh"  // MAX_SAMPLES

namespace {

constexpr int WARPS = 8;  // warps a CTA, one ray each at a time
constexpr int MIN_COARSE = 3;
constexpr int SHORT_OUT = 256;  // Sc + Sf that a warp's registers hold
constexpr int MAX_OUT = nerface::sm90::MAX_SAMPLES;
static_assert(MAX_OUT == 1024, "the port's sample limit");
constexpr int MAX_FINE = SHORT_OUT - MIN_COARSE;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// V consecutive floats at `p` (4·V-byte aligned) into v
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* p) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + c);
      v[c] = a.x, v[c + 1] = a.y, v[c + 2] = a.z, v[c + 3] = a.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < V; c += 4) *reinterpret_cast<float4*>(p + c) = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  }
}

// One stage of a bitonic network over a warp's 32·E values, E a lane in
// blocked order (lane l holds positions E·l .. E·l + E - 1): each pair
// (i, i ^ j) is put in order, ascending where i & size is 0, else
// descending.
template <int E>
__device__ __forceinline__ void bitonic_stage(float (&v)[E], int size, int j, int lane) {
  if (j >= E) {  // the partner is slot e of lane ^ (j / E); both bits lie above the slot
    const int i0 = lane * E;
    const bool up = (i0 & size) == 0, lower = (i0 & j) == 0;
    const bool keep_max = lower != up;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float b = __shfl_xor_sync(FULL, v[e], j / E);
      v[e] = keep_max ? fmaxf(v[e], b) : fminf(v[e], b);
    }
  } else {  // the partner is slot e ^ j of this lane
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & j) continue;
      const bool up = ((lane * E + e) & size) == 0;
      const float lo = fminf(v[e], v[e ^ j]), hi = fmaxf(v[e], v[e ^ j]);
      v[e] = up ? lo : hi;
      v[e ^ j] = up ? hi : lo;
    }
  }
}

// Sort a warp's 32·E values ascending.
template <int E>
__device__ __forceinline__ void bitonic_sort(float (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) bitonic_stage<E>(v, size, j, lane);
  }
}

// A warp's rows in shared memory: the ray's cdf, bins and z, padded to SC.
template <int SC>
struct __align__(16) WarpRows {
  float cdf[SC];   // Sc - 1 real, +inf after
  float bins[SC];  // Sc - 1 used
  float z[SC];     // Sc real, +inf after
};

// A ray's inputs in registers: z and w at [PER·lane, +PER) (past Sc, z
// +inf and w 0), u at [FP·lane, +FP) (0 past n_fine, or unread with a
// shared row).
template <int SC, int FP>
struct RayRows {
  static constexpr int PER = SC / 32;
  float z[PER], w[PER], u[FP];
  __device__ __forceinline__ void load(const float* __restrict__ zg, const float* __restrict__ wg,
                                       const float* __restrict__ ug, bool u_shared, int n_coarse, int n_fine,
                                       int ray, int lane) {
    if (n_coarse == SC) {  // whole rows of the class: vector loads
      load_vec<PER>(z, zg + (size_t)ray * SC + PER * lane);
      load_vec<PER>(w, wg + (size_t)ray * SC + PER * lane);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = PER * lane + k;
        z[k] = i < n_coarse ? zg[(size_t)ray * n_coarse + i] : pos_inf();
        w[k] = i < n_coarse ? wg[(size_t)ray * n_coarse + i] : 0.f;
      }
    }
    if (!u_shared) {
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        const int q = FP * lane + k;
        u[k] = q < n_fine ? ug[(size_t)ray * n_fine + q] : 0.f;
      }
    }
  }
};

// SC: Sc's class (the padded coarse count, 32..256), FP: draws a lane.
template <int SC, int FP, bool SORTED>
__global__ void __launch_bounds__(WARPS * 32)
resample_kernel(const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ u,
                int u_shared, float* __restrict__ out, int n_rays, int n_coarse, int n_fine) {
  constexpr int PER = SC / 32;                       // z and w a lane in the scan
  constexpr int N = pow2_at_least(SC + 32 * FP);     // the union's network
  constexpr int E = N / 32;                          // union positions a lane
  constexpr int ZL = SC / E;                         // lanes holding z in the union
  static_assert(E % FP == 0 && SC % E == 0 && N <= 2 * SHORT_OUT, "shapes");
  __shared__ float u_row[MAX_FINE];
  __shared__ WarpRows<SC> rows[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (u_shared) {
    for (int q = threadIdx.x; q < n_fine; q += blockDim.x) u_row[q] = u[q];
  }
  __syncthreads();
  WarpRows<SC>& m = rows[warp];
  const int B = n_coarse - 1;  // the real cdf entries and bins
  const int n_out = n_coarse + n_fine;
  const int stride = gridDim.x * WARPS;

  RayRows<SC, FP> next;
  int ray = blockIdx.x * WARPS + warp;
  if (ray < n_rays) next.load(z, w, u, u_shared, n_coarse, n_fine, ray, lane);
  for (; ray < n_rays; ray += stride) {
    const RayRows<SC, FP> cur = next;
    if (ray + stride < n_rays) next.load(z, w, u, u_shared, n_coarse, n_fine, ray + stride, lane);

    // 1. the shifted weights, their sum, the cdf and the bins
    float wk[PER], part = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = PER * lane + k;
      wk[k] = (i >= 1 && i <= n_coarse - 2) ? __fadd_rn(cur.w[k], 1e-5f) : 0.f;
      part = __fadd_rn(part, wk[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(FULL, part, o));
    const float total = part;
    float c[PER], run = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = PER * lane + k;
      if (i >= 1 && i <= n_coarse - 2) run = __fadd_rn(run, __fdiv_rn(wk[k], total));
      c[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    const float z_next = __shfl_down_sync(FULL, cur.z[0], 1);  // z[PER·(l+1)]; lane 31's bin is unused
    float bins[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      // a padded entry is +inf: no draw counts it
      c[k] = PER * lane + k < B ? __fadd_rn(excl, c[k]) : pos_inf();
      bins[k] = __fmul_rn(0.5f, __fadd_rn(k + 1 < PER ? cur.z[k + 1] : z_next, cur.z[k]));
    }
    __syncwarp();  // the last ray's reads of the rows are done
    store_vec<PER>(m.cdf + PER * lane, c);
    store_vec<PER>(m.bins + PER * lane, bins);
    store_vec<PER>(m.z + PER * lane, cur.z);
    __syncwarp();

    // 2. the inverse-CDF draws q = FP·lane + k
    float s[FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) {
      const int q = FP * lane + k;
      s[k] = pos_inf();
      if (q < n_fine) {
        const float uq = u_shared ? u_row[q] : cur.u[k];
        int pos = 0;  // #{cdf ≤ uq} over the real entries: the steps add up to SC - 1 ≥ B
#pragma unroll
        for (int step = SC / 2; step > 0; step >>= 1) pos += m.cdf[pos + step - 1] <= uq ? step : 0;
        const int below = pos > 0 ? pos - 1 : 0;
        const int above = pos < B - 1 ? pos : B - 1;
        const float cb = m.cdf[below], bb = m.bins[below];
        float denom = __fsub_rn(m.cdf[above], cb);
        if (denom < 1e-5f) denom = 1.f;
        const float t = __fdiv_rn(__fsub_rn(uq, cb), denom);
        s[k] = __fadd_rn(bb, __fmul_rn(t, __fsub_rn(m.bins[above], bb)));
      }
    }

    // 3. the draws in order (the general regime)
    if constexpr (!SORTED) bitonic_sort<FP>(s, lane);

    // 4. the union: z ascending, then the draws descending (draw N - 1 - p
    // at position p), merged
    float v[E];
    if (lane < ZL) {
      load_vec<E>(v, m.z + E * lane);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int q = N - 1 - (E * lane + e);
      const float t = __shfl_sync(FULL, s[FP - 1 - e % FP], (q / FP) & 31);
      if (lane >= ZL) v[e] = q < n_fine ? t : pos_inf();
    }
#pragma unroll
    for (int j = N / 2; j > 0; j >>= 1) bitonic_stage<E>(v, N, j, lane);

    float* orow = out + (size_t)ray * n_out;
    if (E >= 4 && (n_out & 3) == 0) {
#pragma unroll
      for (int c4 = 0; c4 < E; c4 += 4) {
        const int p = E * lane + c4;
        if (p < n_out) *reinterpret_cast<float4*>(orow + p) = make_float4(v[c4], v[c4 + 1], v[c4 + 2], v[c4 + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (E * lane + e < n_out) orow[E * lane + e] = v[e];
      }
    }
  }
}

// The CTAs of `kernel` (`threads` a CTA) resident on the card at once, the
// persistent grid, into *ctas (computed on the first call); a cudaError_t.
template <class Kernel>
int resident_ctas(Kernel kernel, int threads, int* ctas) {
  if (*ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *ctas = sms * per_sm;
  }
  return 0;
}

template <int SC, int FP, bool SORTED>
int launch_one(const float* z, const float* w, const float* u, int u_shared, float* out, int n_rays, int n_coarse,
               int n_fine, cudaStream_t stream) {
  auto kernel = resample_kernel<SC, FP, SORTED>;
  static int ctas = 0;
  if (int e = resident_ctas(kernel, WARPS * 32, &ctas)) return e;
  const int need = (n_rays + WARPS - 1) / WARPS;
  kernel<<<need < ctas ? need : ctas, WARPS * 32, 0, stream>>>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine);
  return (int)cudaGetLastError();
}

// Sc's class SC: FP draws a lane (32·FP ≥ Sf) and the regime.
template <int SC>
int launch(const float* z, const float* w, const float* u, int u_shared, float* out, int n_rays, int n_coarse,
           int n_fine, int sorted_u, cudaStream_t stream) {
  const int fp = n_fine <= 32 ? 1 : (n_fine <= 64 ? 2 : (n_fine <= 128 ? 4 : 8));
#define NERFACE_K5_LAUNCH(FP, SORTED) \
  return launch_one<SC, FP, SORTED>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, stream)
  switch (fp * 2 + (sorted_u ? 1 : 0)) {
    case 2: NERFACE_K5_LAUNCH(1, false);
    case 3: NERFACE_K5_LAUNCH(1, true);
    case 4: NERFACE_K5_LAUNCH(2, false);
    case 5: NERFACE_K5_LAUNCH(2, true);
    case 8: NERFACE_K5_LAUNCH(4, false);
    case 9: NERFACE_K5_LAUNCH(4, true);
  }
  if constexpr (SC + 32 * 8 <= 2 * SHORT_OUT && SC < 256) {  // Sc ≤ 128 leaves room for Sf > 128
    if (sorted_u) NERFACE_K5_LAUNCH(8, true);
    NERFACE_K5_LAUNCH(8, false);
  }
#undef NERFACE_K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// -- the long regime: SHORT_OUT < Sc + Sf ≤ MAX_OUT ------------------------------

constexpr int LONG_WARPS = 2;                     // warps a CTA, one ray each at a time
constexpr int LONG_ROW = MAX_OUT + MAX_OUT / 32;  // a row with its padding words

// Entry i of a padded row: one word after every 32.
__device__ __forceinline__ int at(int i) { return i + (i >> 5); }

// A warp's rows of its ray in shared memory.
struct LongRows {
  float z[LONG_ROW];    // Sc real, +inf after
  float cdf[LONG_ROW];  // the weights, then the cdf (Sc - 1 real, +inf after), then the union's row
  float bins[LONG_ROW];
  float s[LONG_ROW];    // the draws, +inf after Sf
};

// #{i < 2^k − 1 : row[i] < v} (LESS) or ≤ v, over a sorted row padded with
// +inf: `steps` = 2^(k−1), the steps adding up to 2^k − 1.
template <bool LESS>
__device__ __forceinline__ int rank_in(const float* row, float v, int steps) {
  int pos = 0;
  for (int step = steps; step > 0; step >>= 1) {
    const float r = row[at(pos + step - 1)];
    pos += (LESS ? r < v : r <= v) ? step : 0;
  }
  return pos;
}

// sc: Sc's class (32 .. 1024, as the short kernel's SC); nz / ns: the least
// powers of two past Sc and Sf (the merge's searches); nf: the least power
// of two ≥ Sf (the sort's).
template <bool SORTED>
__global__ void __launch_bounds__(LONG_WARPS * 32)
resample_long_kernel(const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ u, int u_shared,
            float* __restrict__ out, int n_rays, int n_coarse, int n_fine, int sc, int nz, int ns, int nf) {
  __shared__ LongRows rows[LONG_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  LongRows& m = rows[warp];
  const int per = sc / 32;     // the cdf entries of a lane's run
  const int B = n_coarse - 1;  // the real cdf entries and bins
  const int n_out = n_coarse + n_fine;
  const int z_fill = nz > sc ? nz : sc;
  for (int ray = blockIdx.x * LONG_WARPS + warp; ray < n_rays; ray += gridDim.x * LONG_WARPS) {
    const float* zr = z + (size_t)ray * n_coarse;
    const float* wr = w + (size_t)ray * n_coarse;
    __syncwarp();  // the last ray's reads of the rows are done

    // 1. the rows, then the cdf and the bins in the short kernel's order of sums
    for (int i = lane; i < z_fill; i += 32) {
      m.z[at(i)] = i < n_coarse ? zr[i] : pos_inf();
      if (i < sc) m.cdf[at(i)] = i < n_coarse ? wr[i] : 0.f;
    }
    __syncwarp();
    float part = 0.f;
    for (int k = 0; k < per; ++k) {
      const int i = per * lane + k;
      part = __fadd_rn(part, (i >= 1 && i <= n_coarse - 2) ? __fadd_rn(m.cdf[at(i)], 1e-5f) : 0.f);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(FULL, part, o));
    const float total = part;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {  // the run's running sums, in place of its weights
      const int i = per * lane + k;
      if (i >= 1 && i <= n_coarse - 2) run = __fadd_rn(run, __fdiv_rn(__fadd_rn(m.cdf[at(i)], 1e-5f), total));
      m.cdf[at(i)] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int k = 0; k < per; ++k) {
      const int i = per * lane + k;
      m.cdf[at(i)] = i < B ? __fadd_rn(excl, m.cdf[at(i)]) : pos_inf();
      m.bins[at(i)] = i < B ? __fmul_rn(0.5f, __fadd_rn(m.z[at(i + 1)], m.z[at(i)])) : 0.f;
    }
    __syncwarp();

    // 2. the inverse-CDF draws
    for (int q = lane; q < ns; q += 32) {
      float sq = pos_inf();
      if (q < n_fine) {
        const float uq = u_shared ? u[q] : u[(size_t)ray * n_fine + q];
        const int pos = rank_in<false>(m.cdf, uq, sc / 2);  // #{cdf ≤ uq}: the steps add up to SC - 1 ≥ B
        const int below = pos > 0 ? pos - 1 : 0;
        const int above = pos < B - 1 ? pos : B - 1;
        const float cb = m.cdf[at(below)], bb = m.bins[at(below)];
        float denom = __fsub_rn(m.cdf[at(above)], cb);
        if (denom < 1e-5f) denom = 1.f;
        const float t = __fdiv_rn(__fsub_rn(uq, cb), denom);
        sq = __fadd_rn(bb, __fmul_rn(t, __fsub_rn(m.bins[at(above)], bb)));
      }
      m.s[at(q)] = sq;
    }
    __syncwarp();

    // 3. the draws in order (the general regime): a bitonic sort of nf
    if constexpr (!SORTED) {
      for (int size = 2; size <= nf; size <<= 1) {
        for (int j = size >> 1; j > 0; j >>= 1) {
          for (int p = lane; p < nf / 2; p += 32) {
            const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // the pair's lower entry: bit j clear
            const float a = m.s[at(i)], b = m.s[at(i | j)];
            const bool up = (i & size) == 0;
            m.s[at(i)] = up ? fminf(a, b) : fmaxf(a, b);
            m.s[at(i | j)] = up ? fmaxf(a, b) : fminf(a, b);
          }
          __syncwarp();
        }
      }
    }

    // 4. the union by rank, staged in the cdf's place, then stored
    for (int i = lane; i < n_coarse; i += 32) {
      const float v = m.z[at(i)];
      m.cdf[at(i + rank_in<true>(m.s, v, ns / 2))] = v;
    }
    for (int j = lane; j < n_fine; j += 32) {
      const float v = m.s[at(j)];
      m.cdf[at(j + rank_in<false>(m.z, v, nz / 2))] = v;
    }
    __syncwarp();
    float* orow = out + (size_t)ray * n_out;
    for (int p = lane; p < n_out; p += 32) orow[p] = m.cdf[at(p)];
  }
}

template <bool SORTED>
int launch_long(const float* z, const float* w, const float* u, int u_shared, float* out, int n_rays, int n_coarse,
                int n_fine, cudaStream_t stream) {
  auto kernel = resample_long_kernel<SORTED>;
  static int ctas = 0;
  if (int e = resident_ctas(kernel, LONG_WARPS * 32, &ctas)) return e;
  const int sc = pow2_at_least(n_coarse < 32 ? 32 : n_coarse);
  const int nz = pow2_at_least(n_coarse + 1), ns = pow2_at_least(n_fine + 1), nf = pow2_at_least(n_fine);
  const int need = (n_rays + LONG_WARPS - 1) / LONG_WARPS;
  kernel<<<need < ctas ? need : ctas, LONG_WARPS * 32, 0, stream>>>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine,
                                                                   sc, nz, ns, nf);
  return (int)cudaGetLastError();
}

}  // namespace

// z, w (n_rays, n_coarse), u (n_rays, n_fine) or (n_fine,) with u_shared,
// out (n_rays, n_coarse + n_fine), all f32 and contiguous. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue outside 3 ≤ n_coarse,
// 1 ≤ n_fine, n_coarse + n_fine ≤ MAX_OUT). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_resample(const float* z, const float* w, const float* u, int u_shared,
                                      float* out, int n_rays, int n_coarse, int n_fine,
                                      int sorted_u, void* stream) {
  if (n_rays < 0 || n_coarse < MIN_COARSE || n_fine < 1 || n_coarse + n_fine > MAX_OUT)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_coarse + n_fine > SHORT_OUT) {
    if (sorted_u) return launch_long<true>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, s);
    return launch_long<false>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, s);
  }
  if (n_coarse <= 32) return launch<32>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, sorted_u, s);
  if (n_coarse <= 64) return launch<64>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, sorted_u, s);
  if (n_coarse <= 128) return launch<128>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, sorted_u, s);
  return launch<256>(z, w, u, u_shared, out, n_rays, n_coarse, n_fine, sorted_u, s);
}
