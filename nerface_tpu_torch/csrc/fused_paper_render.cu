// Fused render of the NeRFace paper model on Hopper (sm_90a): the radiance
// MLP and the volume compositing in one kernel.
//
// Replaces K2 of the JAX package, the Pallas TPU kernel `_render_kernel`
// behind nerface_tpu/ops/pallas/fused_mlp.py::fused_paper_render
// (pallas_call at fused_mlp.py:811). Python side:
// nerface_tpu_torch/ops/kernels/fused_mlp.py (wrapper, operand packing, and
// the plain PyTorch version `fused_paper_render_reference`).
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
// (2·(64·256 + 4·256² + 320·256 + 256·128 + 2·128²) ≈ 0.98 MFLOP), ≈ 49.5
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HIDDEN = 256;
constexpr int DIR_HIDDEN = 128;
constexpr int K_XIN = 64;
constexpr int TILE_ROWS = 128;
constexpr int THREADS = 512;  // 16 warps
constexpr int LD_ACT = HIDDEN + 8;  // row padding: staggers smem banks
constexpr int LD_XIN = K_XIN + 8;
constexpr int KC = 64;               // weight rows per staged chunk
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

struct Smem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  bf16 xin[TILE_ROWS * LD_XIN];
  float sigma[TILE_ROWS];
  float rgb[TILE_ROWS * 3];
};

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

enum { EPI_RELU = 0, EPI_LINEAR = 1, EPI_DIR_RELU = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

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

// One dense layer over the tile: out = epi([A0 | A1] @ Wt + bias) as bf16,
// Wt the layer's (K0 + K1, N) weights, row-major and contiguous in global
// memory; epi is relu, identity, or relu after adding the per-ray dir
// contribution. K1 = 0 means a single input segment. Warp w computes rows
// [32·(w/4), +32) × columns [(w%4)·N/4, +N/4): 2 × N/32 m16n8 tiles.
template <int N, int K0, int K1, int EPI, int S>
__device__ __forceinline__ void layer(Smem& sm, const bf16* A0, int lda0, const bf16* A1,
                                      const bf16* Wt, bf16* out, const float* bias,
                                      const Args& a, int ray0) {
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
  stage_chunk<N>(sm.wstage[0], Wt, 0);
#pragma unroll 1
  for (int ch = 0; ch < NCH; ++ch) {
    // chunk ch + 1 goes into the buffer read in iteration ch - 1, which
    // that iteration's closing barrier released
    if (ch + 1 < NCH) {
      stage_chunk<N>(sm.wstage[(ch + 1) & 1], Wt, (ch + 1) * KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Bs = sm.wstage[ch & 1];
    const int kg = ch * KC;
    const bool second = K1 > 0 && kg >= K0;
    const bf16* A = second ? A1 : A0;
    const int lda = second ? LD_ACT : lda0;
    const int ka = second ? kg - K0 : kg;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4<false>(af[i], A + (r0 + 16 * i + lrow) * lda + ka + kk + lcol);
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
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + (lane >> 2) + 8 * h;
        float v0 = acc[i][j][2 * h] + b0;
        float v1 = acc[i][j][2 * h + 1] + b1;
        if (EPI == EPI_DIR_RELU) {
          const int ray = ray0 + row / S;
          if (ray < a.n_rays) {
            v0 += a.dir_c[(size_t)ray * DIR_HIDDEN + col];
            v1 += a.dir_c[(size_t)ray * DIR_HIDDEN + col + 1];
          }
        }
        if (EPI != EPI_LINEAR) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * LD_ACT + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) render_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * RAYS;
  const bf16* W = a.W;
  const float* F = a.F;

  // 1. [xyz; sin(x·f + φ); 0] per sample row, rounded to bf16 as the TPU
  // kernel's `_dot` rounds its operands. __fmul_rn/__fadd_rn keep nvcc
  // from contracting into an FMA: the products and sums round as in the
  // JAX package and the plain version.
  for (int e = tid; e < TILE_ROWS * K_XIN; e += THREADS) {
    const int r = e / K_XIN, c = e % K_XIN;
    const int ray = ray0 + r / S, s = r % S;
    float v = 0.f;
    if (ray < a.n_rays && c < 3 + 6 * a.n_freqs) {
      const int d = c < 3 ? c : (c - 3) % 3;
      const float x = __fadd_rn(a.ro[ray * 3 + d],
                                __fmul_rn(a.rd[ray * 3 + d], a.z[(size_t)ray * S + s]));
      if (c < 3) {
        v = x;
      } else {
        const int p = c - 3;
        const float phase = (p % 6) >= 3 ? 1.57079632679489661923f : 0.f;
        v = sinf(__fadd_rn(__fmul_rn(x, F[F_OFF_FREQS + p / 6]), phase));
      }
    }
    sm.xin[r * LD_XIN + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  bf16* A = sm.act[0];
  bf16* B = sm.act[1];
  // 2. trunk (cond0 / cond3 carry the folded per-frame conditioning)
  layer<HIDDEN, K_XIN, 0, EPI_RELU, S>(sm, sm.xin, LD_XIN, nullptr, W + W_OFF_W0, A,
                                       F + F_OFF_COND0, a, ray0);
  layer<HIDDEN, HIDDEN, 0, EPI_RELU, S>(sm, A, LD_ACT, nullptr, W + W_OFF_W1, B,
                                        F + F_OFF_B1, a, ray0);
  layer<HIDDEN, HIDDEN, 0, EPI_RELU, S>(sm, B, LD_ACT, nullptr, W + W_OFF_W2, A,
                                        F + F_OFF_B2, a, ray0);
  layer<HIDDEN, K_XIN, HIDDEN, EPI_RELU, S>(sm, sm.xin, LD_XIN, A, W + W_OFF_W3, B,
                                            F + F_OFF_COND3, a, ray0);
  layer<HIDDEN, HIDDEN, 0, EPI_RELU, S>(sm, B, LD_ACT, nullptr, W + W_OFF_W4, A,
                                        F + F_OFF_B4, a, ray0);
  layer<HIDDEN, HIDDEN, 0, EPI_RELU, S>(sm, A, LD_ACT, nullptr, W + W_OFF_W5, B,
                                        F + F_OFF_B5, a, ray0);
  layer<HIDDEN, HIDDEN, 0, EPI_LINEAR, S>(sm, B, LD_ACT, nullptr, W + W_OFF_WF, A,
                                          F + F_OFF_BF, a, ray0);  // A = feat

  // 3a. σ head: four threads per row, a quarter of K each.
  {
    constexpr int PART = HIDDEN / 4;
    const int row = tid >> 2, part = tid & 3;
    const bf16* f = A + row * LD_ACT + part * PART;
    const bf16* w = W + W_OFF_WA + part * PART;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < PART; ++k) sum += __bfloat162float(f[k]) * __bfloat162float(w[k]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) sm.sigma[row] = sum + F[F_OFF_BA];
  }

  // 2b. direction branch
  layer<DIR_HIDDEN, HIDDEN, 0, EPI_DIR_RELU, S>(sm, A, LD_ACT, nullptr, W + W_OFF_WD0, B,
                                                F + F_OFF_BD0, a, ray0);
  layer<DIR_HIDDEN, DIR_HIDDEN, 0, EPI_RELU, S>(sm, B, LD_ACT, nullptr, W + W_OFF_WD1, A,
                                                F + F_OFF_BD1, a, ray0);
  layer<DIR_HIDDEN, DIR_HIDDEN, 0, EPI_RELU, S>(sm, A, LD_ACT, nullptr, W + W_OFF_WD2, B,
                                                F + F_OFF_BD2, a, ray0);

  // 3b. rgb head: one (row, channel) dot product per thread-iteration.
  for (int idx = tid; idx < TILE_ROWS * 3; idx += THREADS) {
    const int row = idx / 3, ch = idx % 3;
    const bf16* x = B + row * LD_ACT;
    const bf16* w = W + W_OFF_WRGB + ch;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < DIR_HIDDEN; ++k) sum += __bfloat162float(x[k]) * __bfloat162float(w[3 * k]);
    sm.rgb[idx] = sum + F[F_OFF_BRGB + ch];
  }
  __syncthreads();

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

template <int S>
int launch(const Args& args, int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(render_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  render_kernel<S><<<grid, THREADS, sizeof(Smem), stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_paper_render(const float* ro, const float* rd, const float* z,
                                          const float* dir_c, const float* bg, const void* W,
                                          const float* F, float* rgb, float* disp, float* acc,
                                          float* depth, float* bgw, float* weights,
                                          int n_rays, int n_samples, int n_freqs, int white_bg,
                                          void* stream) {
  if (n_rays < 0 || n_freqs < 1 || 3 + 6 * n_freqs > K_XIN) return (int)cudaErrorInvalidValue;
  Args args{ro,  rd,  z,     dir_c, bg,  static_cast<const bf16*>(W), F,      rgb,     disp,
            acc, depth, bgw, weights, n_rays, n_freqs, white_bg};
  const long long rows = (long long)n_rays * n_samples;
  const int grid = (int)((rows + TILE_ROWS - 1) / TILE_ROWS);
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_samples) {
    case 32:
      return launch<32>(args, grid, s);
    case 64:
      return launch<64>(args, grid, s);
    case 128:
      return launch<128>(args, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
