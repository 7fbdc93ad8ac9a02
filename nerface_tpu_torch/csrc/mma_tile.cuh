// Device code shared by the paper model's kernels (fused_paper_render.cu,
// fused_train_pass.cu, fused_paper_mlp.cu) and K4 (fused_flex.cu): the packed
// operand layout,
// cp.async / ldmatrix / mma.sync wrappers, the positional encoding of a
// tile's sample points, one dense layer over a 128-row tile with its
// epilogue supplied by the caller, and the forward-only MLP over a tile
// (K2 and K3f).
//
// A dense layer: out = epi([A0 | A1] @ Wt) over a tile of 128 sample rows,
// bf16 `mma.sync.m16n8k16` with f32 accumulation, operands loaded with
// `ldmatrix` (B transposed on the fly). The weights, row-major (K, N) in
// global memory (resident in L2), stream through two 64-row shared-memory
// chunks with cp.async, so the CTA's 16 warps share one copy of each chunk
// and the next chunk's load overlaps this chunk's MMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace nerface {

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 256;
constexpr int DIR_HIDDEN = 128;
constexpr int K_XIN = 64;
constexpr int TILE_ROWS = 128;
constexpr int THREADS = 512;        // 16 warps
constexpr int LD_ACT = HIDDEN + 8;  // row padding: staggers smem banks
constexpr int LD_XIN = K_XIN + 8;
constexpr int KC = 64;              // weight rows per staged chunk
constexpr int LD_W = HIDDEN + 8;

// Packed operand offsets, in elements. They must equal W_OFFSETS /
// F_OFFSETS in ops/kernels/fused_mlp.py (tests/test_torch_fused_render.py
// checks it).
// bf16 weights, each (in, out) row-major:
constexpr int W_OFF_W0 = 0;
constexpr int W_OFF_W1 = 16384;
constexpr int W_OFF_W2 = 81920;
constexpr int W_OFF_W3 = 147456;
constexpr int W_OFF_W4 = 229376;
constexpr int W_OFF_W5 = 294912;
constexpr int W_OFF_WF = 360448;
constexpr int W_OFF_WD0 = 425984;
constexpr int W_OFF_WD1 = 458752;
constexpr int W_OFF_WD2 = 475136;
constexpr int W_OFF_WA = 491520;
constexpr int W_OFF_WRGB = 491776;
constexpr int W_OFF_TOTAL = 492160;
// f32 rows:
constexpr int F_OFF_COND0 = 0;
constexpr int F_OFF_B1 = 256;
constexpr int F_OFF_B2 = 512;
constexpr int F_OFF_COND3 = 768;
constexpr int F_OFF_B4 = 1024;
constexpr int F_OFF_B5 = 1280;
constexpr int F_OFF_BF = 1536;
constexpr int F_OFF_BD0 = 1792;
constexpr int F_OFF_BD1 = 1920;
constexpr int F_OFF_BD2 = 2048;
constexpr int F_OFF_BA = 2176;
constexpr int F_OFF_BRGB = 2177;
constexpr int F_OFF_FREQS = 2180;
constexpr int F_OFF_TOTAL = 2196;
static_assert(W_OFF_W1 - W_OFF_W0 == K_XIN * HIDDEN && W_OFF_W4 - W_OFF_W3 == (K_XIN + HIDDEN) * HIDDEN &&
                  W_OFF_WD1 - W_OFF_WD0 == HIDDEN * DIR_HIDDEN && W_OFF_WRGB - W_OFF_WA == HIDDEN &&
                  W_OFF_TOTAL - W_OFF_WRGB == DIR_HIDDEN * 3,
              "weight layout");
static_assert(F_OFF_BD0 - F_OFF_BF == HIDDEN && F_OFF_BA - F_OFF_BD2 == DIR_HIDDEN &&
                  F_OFF_FREQS - F_OFF_BRGB == 3 && F_OFF_TOTAL - F_OFF_FREQS == 16,
              "bias row layout");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Four 8×8 bf16 matrices from shared memory, one 16-byte row address per
// lane (lanes 8i..8i+7 give matrix i's rows); `trans` transposes each.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// d += a · b for one m16n8k16 tile: a 16×16 bf16 (row), b 16×8 bf16 (col),
// d 16×8 f32. Lane t holds d rows t/4 and t/4 + 8, columns 2(t%4), +1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Start copying weight rows [k0, k0 + KC) of Wt (K, N), row-major in global
// memory, into dst (KC rows, leading dim LD_W): 16 bytes per cp.async,
// neighbouring threads on neighbouring addresses.
template <int N>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* __restrict__ Wt, int k0) {
  constexpr int SEGS = N / 8;
  for (int i = threadIdx.x; i < KC * SEGS; i += THREADS) {
    const int r = i / SEGS, c = i % SEGS;
    cp_async16(dst + r * LD_W + c * 8, Wt + (size_t)(k0 + r) * N + c * 8);
  }
  cp_async_commit();
}

// The layer-0 / skip-layer input of a tile: [xyz; sin(x·f + φ); 0] per
// sample row, rounded to bf16 as the TPU kernel's `_dot` rounds its
// operands, into xin (leading dim LD_XIN) and, when xg is given, into xg
// (K_XIN per row). __fmul_rn/__fadd_rn keep nvcc from contracting into an
// FMA: the products and sums round as in the JAX package and the plain
// version; `sinf` has full range reduction (arguments reach hundreds of
// radians). Rows past the last ray are zero.
template <int S>
__device__ __forceinline__ void encode_tile(bf16* xin, bf16* __restrict__ xg, const float* __restrict__ ro,
                                            const float* __restrict__ rd, const float* __restrict__ z,
                                            const float* __restrict__ freqs, int ray0, int n_rays,
                                            int n_freqs) {
  for (int e = threadIdx.x; e < TILE_ROWS * K_XIN; e += THREADS) {
    const int r = e / K_XIN, c = e % K_XIN;
    const int ray = ray0 + r / S, s = r % S;
    float v = 0.f;
    if (ray < n_rays && c < 3 + 6 * n_freqs) {
      const int d = c < 3 ? c : (c - 3) % 3;
      const float x = __fadd_rn(ro[ray * 3 + d], __fmul_rn(rd[ray * 3 + d], z[(size_t)ray * S + s]));
      if (c < 3) {
        v = x;
      } else {
        const int p = c - 3;
        const float phase = (p % 6) >= 3 ? 1.57079632679489661923f : 0.f;
        v = sinf(__fadd_rn(__fmul_rn(x, freqs[p / 6]), phase));
      }
    }
    const bf16 b = __float2bfloat16_rn(v);
    xin[r * LD_XIN + c] = b;
    if (xg != nullptr) xg[(size_t)r * K_XIN + c] = b;
  }
  __syncthreads();
}

// One dense layer over the tile: for every output element, epi(row, col,
// v0, v1) turns the f32 sums of columns col, col + 1 into the layer's f32
// outputs, which are stored as bf16 pairs into `out` (shared memory,
// leading dim LD_ACT) and, when `gout` is given, into gout (global, N per
// row). Wt is the layer's (K0 + K1, N) weights, row-major and contiguous in
// global memory; the A operand is A0 (leading dim lda0) for the first K0
// columns and A1 (leading dim LD_ACT) for the next K1; K1 = 0 means a
// single input segment. With COLSUM, each warp also writes the sums of its
// 32 rows' outputs per column into colsum[(warp / 4) · N + col], summed in
// a fixed order. Warp w computes rows [32·(w/4), +32) × columns
// [(w%4)·N/4, +N/4): 2 × N/32 m16n8 tiles.
template <int N, int K0, int K1, bool COLSUM, class Epi>
__device__ __forceinline__ void mma_layer(bf16* wstage0, bf16* wstage1, const bf16* A0, int lda0,
                                          const bf16* A1, const bf16* __restrict__ Wt, bf16* out,
                                          bf16* __restrict__ gout, float* colsum, const Epi& epi) {
  constexpr int NT = N / 32;
  constexpr int NCH = (K0 + K1) / KC;
  static_assert(K0 % KC == 0 && K1 % KC == 0, "K segments must be whole chunks");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 32;
  const int c0 = (warp & 3) * (N / 4);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses: A rows r0 + 16i + lane%16 at k + 8·(lane/16);
  // B (k-major) rows k + lane%16 at column c0 + 16jj + 8·(lane/16)
  const int lrow = lane & 15, lcol = (lane >> 4) << 3;
  stage_chunk<N>(wstage0, Wt, 0);
#pragma unroll 1
  for (int ch = 0; ch < NCH; ++ch) {
    // chunk ch + 1 goes into the buffer read in iteration ch - 1, which
    // that iteration's closing barrier released
    if (ch + 1 < NCH) {
      stage_chunk<N>((ch + 1) & 1 ? wstage1 : wstage0, Wt, (ch + 1) * KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Bs = ch & 1 ? wstage1 : wstage0;
    const int kg = ch * KC;
    const bool second = K1 > 0 && kg >= K0;
    const bf16* A = second ? A1 : A0;
    const int lda = second ? LD_ACT : lda0;
    const int ka = second ? kg - K0 : kg;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4<false>(af[i], A + (r0 + 16 * i + lrow) * lda + ka + kk + lcol);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        unsigned bfr[4];
        ldsm_x4<true>(bfr, Bs + (kk + lrow) * LD_W + c0 + 16 * jj + lcol);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + (lane >> 2) + 8 * h;
        const float2 v = epi(row, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
        *reinterpret_cast<__nv_bfloat162*>(out + row * LD_ACT + col) = p;
        if (gout != nullptr) *reinterpret_cast<__nv_bfloat162*>(gout + (size_t)row * N + col) = p;
        if (COLSUM) {
          s0 += v.x;
          s1 += v.y;
        }
      }
    }
    if (COLSUM) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        colsum[(warp >> 2) * N + col] = s0;
        colsum[(warp >> 2) * N + col + 1] = s1;
      }
    }
  }
  __syncthreads();
}

// Epilogues of the forward layers: + bias, then relu (RELU) or not.
template <bool RELU>
struct EpiBias {
  const float* bias;
  __device__ __forceinline__ float2 operator()(int, int col, float v0, float v1) const {
    v0 += bias[col];
    v1 += bias[col + 1];
    if (RELU) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
    }
    return make_float2(v0, v1);
  }
};

// layers_dir.0: relu(acc + bias + the ray's direction contribution).
template <int S>
struct EpiDirRelu {
  const float* bias;
  const float* dir_c;  // (R, DIR_HIDDEN)
  int ray0, n_rays;
  __device__ __forceinline__ float2 operator()(int row, int col, float v0, float v1) const {
    v0 += bias[col];
    v1 += bias[col + 1];
    const int ray = ray0 + row / S;
    if (ray < n_rays) {
      v0 += dir_c[(size_t)ray * DIR_HIDDEN + col];
      v1 += dir_c[(size_t)ray * DIR_HIDDEN + col + 1];
    }
    return make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  }
};

// The σ head (256→1): four threads per row, a quarter of K each; sigma[row]
// for the tile's 128 rows from feat (shared memory, leading dim LD_ACT).
__device__ __forceinline__ void sigma_head(float* sigma, const bf16* feat, const bf16* __restrict__ wa,
                                           float ba) {
  constexpr int PART = HIDDEN / 4;
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const bf16* f = feat + row * LD_ACT + part * PART;
  const bf16* w = wa + part * PART;
  float sum = 0.f;
#pragma unroll 8
  for (int k = 0; k < PART; ++k) sum += __bfloat162float(f[k]) * __bfloat162float(w[k]);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0) sigma[row] = sum + ba;
}

// The rgb head (128→3): one (row, channel) dot product per thread-iteration,
// rgb[row·3 + ch] from x (shared memory, leading dim LD_ACT); ends with a
// barrier.
__device__ __forceinline__ void rgb_head(float* rgb, const bf16* x, const bf16* __restrict__ wrgb,
                                         const float* brgb) {
  for (int idx = threadIdx.x; idx < TILE_ROWS * 3; idx += THREADS) {
    const int row = idx / 3, ch = idx % 3;
    const bf16* xr = x + row * LD_ACT;
    const bf16* w = wrgb + ch;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < DIR_HIDDEN; ++k) sum += __bfloat162float(xr[k]) * __bfloat162float(w[3 * k]);
    rgb[idx] = sum + brgb[ch];
  }
  __syncthreads();
}

// Shared memory of a forward-only CTA (K2, K3f).
struct RenderSmem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  bf16 xin[TILE_ROWS * LD_XIN];
  float sigma[TILE_ROWS];
  float rgb[TILE_ROWS * 3];
};

// The paper model's MLP over one tile of 128 sample rows, forward only (K2,
// K3f): [xyz; sin(x·f + φ); 0] per row, the trunk 64→256, 256→256 ×2, the
// concat-skip layer [xin; h2] (K = 320)→256, 256→256 ×2 (×1 when SMALL: the
// smaller model has no layers_xyz.5), fc_feat, the direction branch 256→128
// (+ the ray's dir contribution) and 128→128 ×2; the raw σ and rgb heads
// into sm.sigma / sm.rgb, ending with a barrier. Activations ping-pong
// between the two act buffers; cond0 / cond3 carry the folded per-frame
// conditioning.
template <int S, bool SMALL>
__device__ __forceinline__ void render_tile(RenderSmem& sm, const float* __restrict__ ro,
                                            const float* __restrict__ rd, const float* __restrict__ z,
                                            const float* __restrict__ dir_c, const bf16* __restrict__ W,
                                            const float* __restrict__ F, int ray0, int n_rays, int n_freqs) {
  using Relu = EpiBias<true>;
  using Linear = EpiBias<false>;
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];
  bf16* A = sm.act[0];
  bf16* B = sm.act[1];
  encode_tile<S>(sm.xin, nullptr, ro, rd, z, F + F_OFF_FREQS, ray0, n_rays, n_freqs);
  mma_layer<HIDDEN, K_XIN, 0, false>(s0, s1, sm.xin, LD_XIN, nullptr, W + W_OFF_W0, A, nullptr, nullptr,
                                     Relu{F + F_OFF_COND0});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, A, LD_ACT, nullptr, W + W_OFF_W1, B, nullptr, nullptr,
                                      Relu{F + F_OFF_B1});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_W2, A, nullptr, nullptr,
                                      Relu{F + F_OFF_B2});
  mma_layer<HIDDEN, K_XIN, HIDDEN, false>(s0, s1, sm.xin, LD_XIN, A, W + W_OFF_W3, B, nullptr, nullptr,
                                          Relu{F + F_OFF_COND3});
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, B, LD_ACT, nullptr, W + W_OFF_W4, A, nullptr, nullptr,
                                      Relu{F + F_OFF_B4});
  bf16* h = A;  // the trunk's last activation
  bf16* o = B;
  if constexpr (!SMALL) {
    mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, h, LD_ACT, nullptr, W + W_OFF_W5, o, nullptr, nullptr,
                                        Relu{F + F_OFF_B5});
    h = B;
    o = A;
  }
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, h, LD_ACT, nullptr, W + W_OFF_WF, o, nullptr, nullptr,
                                      Linear{F + F_OFF_BF});
  bf16* feat = o;
  bf16* x = h;
  sigma_head(sm.sigma, feat, W + W_OFF_WA, F[F_OFF_BA]);
  mma_layer<DIR_HIDDEN, HIDDEN, 0, false>(s0, s1, feat, LD_ACT, nullptr, W + W_OFF_WD0, x, nullptr, nullptr,
                                          EpiDirRelu<S>{F + F_OFF_BD0, dir_c, ray0, n_rays});
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, x, LD_ACT, nullptr, W + W_OFF_WD1, feat, nullptr,
                                              nullptr, Relu{F + F_OFF_BD1});
  mma_layer<DIR_HIDDEN, DIR_HIDDEN, 0, false>(s0, s1, feat, LD_ACT, nullptr, W + W_OFF_WD2, x, nullptr,
                                              nullptr, Relu{F + F_OFF_BD2});
  rgb_head(sm.rgb, x, W + W_OFF_WRGB, F + F_OFF_BRGB);
}

// Launch `kernel` (a 512-thread CTA a tile, `smem` bytes of dynamic shared
// memory) on `grid` tiles; returns a cudaError_t.
template <class Kernel, class Args>
inline int launch_tiles(Kernel kernel, size_t smem, int grid, cudaStream_t stream, const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// Runs FN<S, SMALL>::run(args...) for a pass's sample count and model
// (SMALL: the smaller paper model); returns its cudaError_t
// (cudaErrorInvalidValue for a sample count the kernels are not built for).
template <template <int, bool> class FN, class... Args>
int dispatch_pass(int n_samples, int small, Args&&... args) {
  switch (n_samples * 2 + (small ? 1 : 0)) {
    case 64:
      return FN<32, false>::run(args...);
    case 65:
      return FN<32, true>::run(args...);
    case 128:
      return FN<64, false>::run(args...);
    case 129:
      return FN<64, true>::run(args...);
    case 256:
      return FN<128, false>::run(args...);
    case 257:
      return FN<128, true>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace nerface
