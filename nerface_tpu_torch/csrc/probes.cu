// Design probes of K2's Hopper layer chain (fused_paper_render.cu), built
// on the same primitive (wgmma_tile.cuh). They replace the JAX package's
// two TPU probes and ask their questions of this card:
//
// P2 (tools/perf/chain_overlap_probe.py, pallas_call at :119): does a
// 256-wide bf16 matmul → relu chain overlap one chain's epilogue with
// another chain's matmul? Every variant runs DEPTH layers a = relu(a·W)
// of 64-row sub-tiles with the 256×256 weight resident in shared memory
// (128 KB, the K-major swizzled chunk image) and f32 accumulators in
// registers, the next layer's A in registers (`acc_to_a`):
//   single          one consumer warpgroup a CTA, one chain at a time;
//   twochain_1wg    one warpgroup, two chains in turn (the second's A in
//                   shared memory). Two m64n256 f32 accumulators are 256
//                   registers a thread, above the 255 limit, so one
//                   warpgroup cannot hold chain b's accumulator while it
//                   runs chain a's epilogue: on Hopper the TPU probe's
//                   "interleave in one core" is this sequential form;
//   twochain        two warpgroups, one chain each, free-running;
//   twochain_pingpong  the same, with named barriers that alternate the
//                   warpgroups' matmul issue (one's epilogue under the
//                   other's matmul);
//   fourchain       two warpgroups with two chains each (chain b's A from
//                   shared memory: the cost of an operand that round-trips
//                   through shared memory);
//   bwd_mix         one warpgroup: gy = (a·W) ⊙ (a > 0), then aᵀ·gy, the
//                   dW product with a transposed A (MN-major operands from
//                   shared memory), DEPTH/2 times; its sums are written
//                   nowhere, as the TPU probe's `acc[:1] * 0`, except when
//                   `dw` is given: then the last 64-row block's first aᵀ·gy
//                   (256 × 256 f32) goes there, for a check of the product;
//   bias_sums       two warpgroups, the chain plus per-layer column sums of
//                   a (the bias-gradient reduction: quad-row shuffles and
//                   shared-memory atomics).
// P1 (tools/perf/encoder_concat_probe.py, pallas_calls at :77 / :82): is
// the first layer faster as a split K (x3·wa + enc·wb, K padded to 16 +
// 64: five k16 steps) or packed (concat·w, K = 64: four steps)? REPS
// products accumulated into one f32 tile a row block.
//
// Bound: tensor-core throughput for P2 at its sizes (12 · 2 · 256² FLOP a
// row against 2 KB of f32 in and out); P1 is bound by its f32 output
// (1 KB a row against 8 · 2 · 63 · 256 FLOP), so its main() also times
// many more repetitions and reports the matmul's cost a repetition.

#include "wgmma_tile.cuh"

using namespace nerface;
using namespace nerface::sm90;

namespace {

constexpr int W = 256;                  // the chain's width
constexpr int WCHUNK = KCH * W * 2;     // one 64-row chunk image, bytes
constexpr int TILE64 = 64 * W * 2;      // a 64 × 256 bf16 tile, bytes
constexpr int BAR_PP = 1;               // + warpgroup: ping-pong turns
constexpr int BAR_WG = 3;               // + warpgroup: its own threads

enum Variant { SINGLE, TWOCHAIN_1WG, TWOCHAIN, TWOCHAIN_PINGPONG, FOURCHAIN, BWD_MIX, BIAS_SUMS, N_VARIANTS };

template <int V>
struct Cfg {
  static constexpr int WGS = (V == SINGLE || V == TWOCHAIN_1WG || V == BWD_MIX) ? 1 : 2;
  static constexpr int CHAINS = (V == TWOCHAIN_1WG || V == FOURCHAIN) ? 2 : 1;
  static constexpr int ROWS = 64 * WGS * CHAINS;  // rows a CTA takes at a time
};

struct alignas(ATOM_BYTES) ProbeSmem {
  unsigned char w[4][WCHUNK];       // the weight's chunk images
  unsigned char park[2][TILE64];    // operands that go through shared memory
  float colsum[2][W];
  uint64_t bar;
};

__device__ __forceinline__ ProbeSmem& probe_smem(unsigned char* raw) {
  const uint32_t pad = (ATOM_BYTES - (smem_u32(raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1);
  return *reinterpret_cast<ProbeSmem*>(raw + pad);
}

// Thread 0 bulk-copies `chunks` chunk images of `bytes` each into sm.w;
// every thread waits for them.
__device__ __forceinline__ void load_weights(ProbeSmem& sm, const bf16* w, int chunks, int bytes) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar, 1);
    mbar_init_fence();
    mbar_expect_tx(&sm.bar, chunks * bytes);
    for (int c = 0; c < chunks; ++c)
      bulk_load(sm.w[c], reinterpret_cast<const unsigned char*>(w) + (size_t)c * bytes, bytes, &sm.bar);
  }
  __syncthreads();
  mbar_wait(&sm.bar, 0);
}

// The thread's rows of a warpgroup's 64-row tile: r0 and r0 + 8.
__device__ __forceinline__ int frag_row() { return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2); }

// Rows [row_base, row_base + 64) of x (f32, 256 wide) as the bf16 A
// fragment: a[p] holds row r0 + 8(p & 1), columns 8(p >> 1) + 2(lane % 4) + {0, 1}.
__device__ __forceinline__ void load_a(uint32_t* a, const float* __restrict__ x, int row_base) {
  const int r0 = row_base + frag_row(), c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < 64; ++p) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(x + (size_t)(r0 + 8 * (p & 1)) * W + 8 * (p >> 1) + c2));
    a[p] = pack_bf16(v.x, v.y);
  }
}

// The f32 accumulator through `f` into rows [row_base, +64) of out.
template <class F>
__device__ __forceinline__ void store_acc(const float* acc, float* __restrict__ out, int row_base, const F& f) {
  const int r0 = row_base + frag_row(), c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < 64; ++p) {
    const int col = 8 * (p >> 1) + c2;
    *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * (p & 1)) * W + col) =
        make_float2(f(col, acc[2 * p]), f(col + 1, acc[2 * p + 1]));
  }
}

// Element (row, col) of a 64 × 256 bf16 tile in shared memory: K-major
// (four 64-column blocks of 64 swizzled rows) or MN-major (the same bytes
// read with the roles of rows and columns swapped by the descriptor).
__device__ __forceinline__ int tile_offset(int row, int col) { return (col >> 6) * (64 * ROW_BYTES) + sw128(row, col & 63); }

// x rows [row_base, +64) → bf16 tile, by the warpgroup's 128 threads.
__device__ __forceinline__ void x_to_tile(unsigned char* t, const float* __restrict__ x, int row_base) {
  const int i = threadIdx.x & 127;
  for (int e = i; e < 64 * W / 2; e += 128) {
    const int r = e / (W / 2), col = 2 * (e % (W / 2));
    const float2 v = __ldg(reinterpret_cast<const float2*>(x + (size_t)(row_base + r) * W + col));
    *reinterpret_cast<uint32_t*>(t + tile_offset(r, col)) = pack_bf16(v.x, v.y);
  }
}

// A-fragment registers (pairs) → the tile, each thread its own elements.
__device__ __forceinline__ void regs_to_tile(unsigned char* t, const uint32_t* a) {
  const int r0 = frag_row(), c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int p = 0; p < 64; ++p)
    *reinterpret_cast<uint32_t*>(t + tile_offset(r0 + 8 * (p & 1), 8 * (p >> 1) + c2)) = a[p];
}

// acc = A·W over K = 256: A from registers or from a K-major tile.
__device__ __forceinline__ void chain_rs(float* acc, const uint32_t* a, const ProbeSmem& sm) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < W / 16; ++s)
    wgmma_rs<W>(acc, a + 4 * s, desc_k(smem_u32(sm.w[s >> 2]) + 32 * (s & 3)), s > 0);
  wgmma_commit();
}
__device__ __forceinline__ void chain_ss(float* acc, const unsigned char* t, const ProbeSmem& sm) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < W / 16; ++s)
    wgmma_ss<W>(acc, desc_k(smem_u32(t) + (s >> 2) * (64 * ROW_BYTES) + 32 * (s & 3)),
                desc_k(smem_u32(sm.w[s >> 2]) + 32 * (s & 3)), s > 0);
  wgmma_commit();
}
__device__ __forceinline__ void wait_all(float* acc, uint32_t* a) {
  wgmma_wait<0>();
  fence_regs<128>(acc);
  fence_regs<64>(a);
}

struct Linear {
  __device__ __forceinline__ float2 operator()(int, int, float v0, float v1) const { return make_float2(v0, v1); }
};
struct ReluF {
  __device__ __forceinline__ float operator()(int, float v) const { return fmaxf(v, 0.f); }
};

struct ChainArgs {
  const float* x;
  const bf16* w;  // 4 chunk images
  float* out;
  float* dw;      // bwd_mix: the last block's first aᵀ·gy, or null
  int n_rows;
  int depth;
};

template <int V>
__global__ void __launch_bounds__(128 * Cfg<V>::WGS, 1) chain_kernel(const ChainArgs p) {
  extern __shared__ unsigned char smem_raw[];
  ProbeSmem& sm = probe_smem(smem_raw);
  using C = Cfg<V>;
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) sm.colsum[i / W][i % W] = 0.f;
  load_weights(sm, p.w, 4, WCHUNK);
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int c2 = 2 * (lane & 3);
  float acc[128];
  uint32_t a[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (V == TWOCHAIN_PINGPONG && wg == 1) named_bar_arrive(BAR_PP, 256);
  const int iters = p.n_rows / C::ROWS;
  for (int it = blockIdx.x; it < iters; it += gridDim.x) {
    const int base = it * C::ROWS + wg * 64 * C::CHAINS;  // this warpgroup's first row
    if constexpr (V == BWD_MIX) {
      load_a(a, p.x, base);
      for (int d = 0; d < p.depth / 2; ++d) {
        chain_rs(acc, a, sm);
        wait_all(acc, a);
        // gy = (a·W) ⊙ (a > 0); the old a and bf16(gy) go to shared
        // memory for aᵀ·gy, and gy becomes the next a
        named_bar_sync(BAR_WG + wg, 128);
        regs_to_tile(sm.park[0], a);
#pragma unroll
        for (int q = 0; q < 64; ++q) {
          const float2 old = unpack_bf16(a[q]);
          acc[2 * q] = old.x > 0.f ? acc[2 * q] : 0.f;
          acc[2 * q + 1] = old.y > 0.f ? acc[2 * q + 1] : 0.f;
          a[q] = pack_bf16(acc[2 * q], acc[2 * q + 1]);
        }
        if (d == p.depth / 2 - 1) store_acc(acc, p.out, base, [](int, float v) { return v; });
        regs_to_tile(sm.park[1], a);
        fence_proxy_async();
        named_bar_sync(BAR_WG + wg, 128);
        float sink = 0.f;
#pragma unroll 1
        for (int mt = 0; mt < W / 64; ++mt) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t at = smem_u32(sm.park[0]) + mt * (64 * ROW_BYTES) + ks * 2 * ATOM_BYTES;
            const uint32_t gt = smem_u32(sm.park[1]) + ks * 2 * ATOM_BYTES;
            wgmma_ss<W, 1, 1>(acc, desc_mn(at, 64 * ROW_BYTES, ATOM_BYTES), desc_mn(gt, 64 * ROW_BYTES, ATOM_BYTES),
                              ks > 0);
          }
          wgmma_commit();
          wait_all(acc, a);
          sink += acc[0];
          if (p.dw != nullptr && d == 0 && it == iters - 1)
            store_acc(acc, p.dw, mt * 64, [](int, float v) { return v; });
        }
        if (sink != sink) p.out[0] = sink;  // keeps the dW sums live; never true for finite inputs
      }
    } else if constexpr (C::CHAINS == 2) {
      unsigned char* tb = sm.park[wg];
      load_a(a, p.x, base);
      x_to_tile(tb, p.x, base + 64);
      fence_proxy_async();
      named_bar_sync(BAR_WG + wg, 128);
      for (int d = 0; d < p.depth; ++d) {
        const bool last = d == p.depth - 1;
        chain_rs(acc, a, sm);  // chain a, A in registers
        wait_all(acc, a);
        if (last) {
          store_acc(acc, p.out, base, ReluF{});
        } else {
          acc_to_a<W, true>(acc, a, Linear{});
        }
        chain_ss(acc, tb, sm);  // chain b, A from shared memory
        wait_all(acc, a);
        if (last) {
          store_acc(acc, p.out, base + 64, ReluF{});
        } else {
          named_bar_sync(BAR_WG + wg, 128);  // every warp's product has read tb
          const int r0 = frag_row();
#pragma unroll
          for (int q = 0; q < 64; ++q)
            *reinterpret_cast<uint32_t*>(tb + tile_offset(r0 + 8 * (q & 1), 8 * (q >> 1) + c2)) =
                pack_bf16(fmaxf(acc[2 * q], 0.f), fmaxf(acc[2 * q + 1], 0.f));
          fence_proxy_async();
          named_bar_sync(BAR_WG + wg, 128);
        }
      }
    } else {
      load_a(a, p.x, base);
      for (int d = 0; d < p.depth; ++d) {
        if (V == TWOCHAIN_PINGPONG) named_bar_sync(BAR_PP + wg, 256);  // this warpgroup's turn
        chain_rs(acc, a, sm);
        if (V == TWOCHAIN_PINGPONG) named_bar_arrive(BAR_PP + (wg ^ 1), 256);  // the other's turn
        wait_all(acc, a);
        if (V == BIAS_SUMS) {
          // s += Σ_rows relu(acc): the thread's two rows, then the 8 row
          // lanes of the quad column, then the warps by shared atomics
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            float s0 = fmaxf(acc[4 * q], 0.f) + fmaxf(acc[4 * q + 2], 0.f);
            float s1 = fmaxf(acc[4 * q + 1], 0.f) + fmaxf(acc[4 * q + 3], 0.f);
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, o);
              s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            if (lane < 4) {
              atomicAdd(&sm.colsum[wg][8 * q + c2], s0);
              atomicAdd(&sm.colsum[wg][8 * q + c2 + 1], s1);
            }
          }
        }
        if (d < p.depth - 1) acc_to_a<W, true>(acc, a, Linear{});
      }
      if (V == BIAS_SUMS) {
        named_bar_sync(BAR_WG + wg, 128);
        const float* s = sm.colsum[wg];
        store_acc(acc, p.out, base, [s](int col, float v) { return fmaxf(v, 0.f) + s[col] * 0.f; });
      } else {
        store_acc(acc, p.out, base, ReluF{});
      }
    }
  }
  if (V == TWOCHAIN_PINGPONG && wg == 0) named_bar_sync(BAR_PP, 256);  // the last turn handed over
}

// P1: acc += A·W, REPS times, over a 64-row block: packed ([x3; enc; 0],
// K = 64, one chunk image) or split (x3 padded to K = 16 against wa's
// chunk, then enc padded to 64 against wb's).
struct EncoderArgs {
  const float* x3;   // (n, 3)
  const float* enc;  // (n, 60)
  const bf16* w;     // packed: 1 chunk image; split: wa's, then wb's
  float* out;        // (n, 256)
  int n_rows;
  int reps;
};

template <bool SPLIT>
__global__ void __launch_bounds__(256, 1) encoder_kernel(const EncoderArgs p) {
  extern __shared__ unsigned char smem_raw[];
  ProbeSmem& sm = probe_smem(smem_raw);
  load_weights(sm, p.w, SPLIT ? 2 : 1, WCHUNK);
  const int wg = threadIdx.x / 128, i = threadIdx.x & 127;
  // this warpgroup's operand rows: packed in park[wg]'s first block; split
  // x3 there and enc in its second block
  unsigned char* xa = sm.park[wg];
  unsigned char* xb = sm.park[wg] + 64 * ROW_BYTES;
  float acc[128];
  uint32_t none[64];
#pragma unroll
  for (int q = 0; q < 128; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 64; ++q) none[q] = 0u;
  const int iters = p.n_rows / 128;
  for (int it = blockIdx.x; it < iters; it += gridDim.x) {
    const int base = it * 128 + wg * 64;
    named_bar_sync(BAR_WG + wg, 128);  // the previous block's products are done with xa / xb
    for (int e = i; e < 64 * 64; e += 128) {
      const int r = e / 64, c = e % 64;
      const size_t row = (size_t)(base + r);
      float va, vb = 0.f;
      if (SPLIT) {
        va = c < 3 ? p.x3[row * 3 + c] : 0.f;
        vb = c < 60 ? p.enc[row * 60 + c] : 0.f;
        *reinterpret_cast<bf16*>(xb + sw128(r, c)) = __float2bfloat16_rn(vb);
      } else {
        va = c < 3 ? p.x3[row * 3 + c] : (c < 63 ? p.enc[row * 60 + c - 3] : 0.f);
      }
      *reinterpret_cast<bf16*>(xa + sw128(r, c)) = __float2bfloat16_rn(va);
    }
    fence_proxy_async();
    named_bar_sync(BAR_WG + wg, 128);
    for (int rep = 0; rep < p.reps; ++rep) {
      wgmma_fence();
      if (SPLIT) {
        wgmma_ss<W>(acc, desc_k(smem_u32(xa)), desc_k(smem_u32(sm.w[0])), rep > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<W>(acc, desc_k(smem_u32(xb) + 32 * kk), desc_k(smem_u32(sm.w[1]) + 32 * kk), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<W>(acc, desc_k(smem_u32(xa) + 32 * kk), desc_k(smem_u32(sm.w[0]) + 32 * kk),
                      rep > 0 || kk > 0);
      }
      wgmma_commit();
    }
    wait_all(acc, none);
    store_acc(acc, p.out, base, [](int, float v) { return v; });
  }
}

constexpr size_t SMEM_BYTES = sizeof(ProbeSmem) + ATOM_BYTES;

template <class Kernel, class Args>
int launch_persistent(Kernel kernel, int threads, int units, cudaStream_t stream, const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, SMEM_BYTES)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = units < sms * per_sm ? units : sms * per_sm;
  if (grid > 0) kernel<<<grid, threads, SMEM_BYTES, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int V>
int run_chain(const ChainArgs& args, cudaStream_t s) {
  return launch_persistent(chain_kernel<V>, 128 * Cfg<V>::WGS, args.n_rows / Cfg<V>::ROWS, s, args);
}

}  // namespace

// P2: out = the DEPTH-layer chain of x (n_rows × 256 f32, n_rows a multiple
// of 256) through w (the 256×256 weight's 4 chunk images), by `variant`
// (0 single, 1 twochain_1wg, 2 twochain, 3 twochain_pingpong, 4 fourchain,
// 5 bwd_mix, 6 bias_sums); `dw` (256 × 256 f32, bwd_mix only, may be null)
// takes aᵀ·gy of the first step on the last 64 rows. Returns a cudaError_t.
extern "C" int nerface_probe_chain(const float* x, const void* w, float* out, float* dw, int n_rows, int depth,
                                   int variant, void* stream) {
  if (n_rows < 0 || n_rows % 256 != 0 || depth < 2 || depth % 2 != 0) return (int)cudaErrorInvalidValue;
  if (dw != nullptr && variant != BWD_MIX) return (int)cudaErrorInvalidValue;
  const ChainArgs args{x, static_cast<const bf16*>(w), out, dw, n_rows, depth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case SINGLE: return run_chain<SINGLE>(args, s);
    case TWOCHAIN_1WG: return run_chain<TWOCHAIN_1WG>(args, s);
    case TWOCHAIN: return run_chain<TWOCHAIN>(args, s);
    case TWOCHAIN_PINGPONG: return run_chain<TWOCHAIN_PINGPONG>(args, s);
    case FOURCHAIN: return run_chain<FOURCHAIN>(args, s);
    case BWD_MIX: return run_chain<BWD_MIX>(args, s);
    case BIAS_SUMS: return run_chain<BIAS_SUMS>(args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P1: out = Σ_reps A·W over n_rows rows (a multiple of 128), packed (w: one
// chunk image of [wa; wb; 0]) or split (w: the images of [wa; 0] and
// [wb; 0]). Returns a cudaError_t.
extern "C" int nerface_probe_encoder(const float* x3, const float* enc, const void* w, float* out, int n_rows,
                                     int reps, int split, void* stream) {
  if (n_rows < 0 || n_rows % 128 != 0 || reps < 1) return (int)cudaErrorInvalidValue;
  const EncoderArgs args{x3, enc, static_cast<const bf16*>(w), out, n_rows, reps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split ? launch_persistent(encoder_kernel<true>, 256, n_rows / 128, s, args)
               : launch_persistent(encoder_kernel<false>, 256, n_rows / 128, s, args);
}
