// The Flexible model family's fused MLP on Hopper (sm_90a): K4f, the
// forward, and K4b, its backward.
//
// Replaces K4 of the JAX package, the Pallas TPU kernels behind
// nerface_tpu/ops/pallas/fused_flex.py::fused_flex_mlp: `_fwd_kernel`
// (fused_flex.py:131, pallas_call at :247) and `_bwd_kernel` (:143,
// pallas_call at :287). Python side: nerface_tpu_torch/ops/kernels/
// fused_flex.py (wrappers, operand packing, the autograd.Function and the
// plain PyTorch versions). The encode, dense-layer and head code is K2's
// (mma_tile.cuh), the dX epilogues and dW are K1's (grad_tile.cuh).
//
// The function, per sample row: points ro + rd·z, [xyz; sin(x·f + φ); 0]
// (64 bf16 columns), a_0 = that @ W1 + v0 with NO activation (`layer1`, a
// reference quirk; v0 is its bias with the per-frame conditioning folded
// in), a_{i+1} = relu(a_i @ WH_i + bh_i) for the n hidden layers, then
// σ = a_n · wa + ba off the trunk (not off feat, unlike the paper model),
// feat = relu(a_n @ WF + bf), x0 = relu(feat @ WD0 + bd0 + the ray's
// direction contribution), rgb = x0 @ wrgb + brgb. Out: raw [rgb, σ].
//
// K4f (`flex_fwd_kernel`, one 512-thread CTA per tile of 128 sample rows,
// 2 rays at S = 64, 1 at S = 128): the layer chain as bf16 `mma.sync`
// GEMMs with f32 accumulation, activations ping-ponging in shared memory,
// weights staged from L2 in 64-row chunks (mma_layer), the σ and rgb heads
// as per-thread dot products; (R, S, 4) f32 out.
//
// K4b: the TPU kernel recomputes the forward per tile and adds its weight
// gradients into one block over the sequential grid. Neither carries over
// as it is: a tile's activations (≈ 1.5 k bf16 a row at n = 3) do not fit
// in shared memory, and CUDA blocks run at once in no order. So one call
// is five launches on the caller's stream, with a device workspace:
//   1. flex_fwd_kernel again, writing xin, a_0..a_n, feat and x0 (bf16);
//   2. flex_bwd_kernel, per tile: the heads' weight and bias sums into the
//      tile's partial row; gx0 = bf16(g_rgb) Wrgbᵀ ⊙ [x0 > 0]; then
//      g_feat = (bf16(gx0) WD0ᵀ) ⊙ [feat > 0], the trunk's cotangent
//      (bf16(g_feat) WFᵀ + bf16(g_σ) ⊗ wa) ⊙ [a_n > 0], and down the hidden
//      layers to ga_0 = bf16(g_0) WH_0ᵀ, unmasked (layer1 has no relu): each
//      an mma_layer over the transposed weights, each bf16 cotangent to the
//      workspace, its f32 column sums (bh_i, bf, bd0, d_v0) to the tile's
//      partial row, and per ray d_dir = Σ over its rows of gx0;
//   3. dw_kernel: dW = bf16(X)ᵀ·bf16(gY) for W1, WF, WD0 and every WH_i;
//   4./5. reduce_rows: dW's row segments and the tiles' partial rows, each
//      summed in a fixed order. No atomics: bit-identical over launches.
// Rounding as in the TPU kernel: every left matmul operand (the raw points
// included), the saved activations and their masks, both dW operands, the
// dX cotangent are bf16; bias sums, d_v0 and d_dir take the f32 cotangents.
//
// Bound: tensor-core throughput. At n = 3 the forward is 0.623 MFLOP a
// sample at the function's widths (layer1's K = 63), the backward 1.838
// (recompute 0.623, dX 0.591, dW 0.623): a train step's 2048 rays × (64 +
// 128) samples are 245 + 723 GFLOP, 0.25 + 0.73 ms at the bf16 dense peak,
// against a few MB of ray data; a 65536-ray serving tile at S = 128 is 5.2
// TFLOP. The workspace of a fine training pass (≈ 1.5 GB, written once and
// read by dX and dW) costs about as much HBM time as the MMAs.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3, with neither
// --use_fast_math nor -ftz=true (see fused_paper_render.cu).

#include "grad_tile.cuh"

using namespace nerface;

namespace {

constexpr int MAX_HIDDEN = 8;

// Packed operand offsets, in elements. They must equal w_offsets /
// f_offsets / wt_offsets in ops/kernels/fused_flex.py (a CPU test checks
// it). bf16 weights, (in, out) row-major: W1 = [w1a; w1b; 0], WF, WD0,
// WH_i at FW_OFF_WH + i·HIDDEN², then WA and WRGB.
constexpr int FW_OFF_W1 = 0;
constexpr int FW_OFF_WF = 16384;
constexpr int FW_OFF_WD0 = 81920;
constexpr int FW_OFF_WH = 114688;
// f32 rows: V0, BF, BD0, BA, BRGB, FREQS, then BH_i at FF_OFF_BH + i·HIDDEN.
constexpr int FF_OFF_V0 = 0;
constexpr int FF_OFF_BF = 256;
constexpr int FF_OFF_BD0 = 512;
constexpr int FF_OFF_BA = 640;
constexpr int FF_OFF_BRGB = 641;
constexpr int FF_OFF_FREQS = 644;
constexpr int FF_OFF_BH = 660;
// transposed weights, (out, in) row-major: WD0T, WFT, WHT_i at
// FT_OFF_WHT + i·HIDDEN².
constexpr int FT_OFF_WD0T = 0;
constexpr int FT_OFF_WFT = 32768;
constexpr int FT_OFF_WHT = 98304;
static_assert(FW_OFF_WF - FW_OFF_W1 == K_XIN * HIDDEN && FW_OFF_WD0 - FW_OFF_WF == HIDDEN * HIDDEN &&
                  FW_OFF_WH - FW_OFF_WD0 == HIDDEN * DIR_HIDDEN,
              "weight layout");
static_assert(FF_OFF_BD0 - FF_OFF_BF == HIDDEN && FF_OFF_BA - FF_OFF_BD0 == DIR_HIDDEN &&
                  FF_OFF_FREQS - FF_OFF_BRGB == 3 && FF_OFF_BH - FF_OFF_FREQS == 16,
              "bias row layout");
static_assert(FT_OFF_WFT - FT_OFF_WD0T == DIR_HIDDEN * HIDDEN && FT_OFF_WHT - FT_OFF_WFT == HIDDEN * HIDDEN,
              "transposed layout");

constexpr size_t HH = (size_t)HIDDEN * HIDDEN;

// The offsets that depend on the number of hidden layers n.
struct Layout {
  int n;
  int wa, wrgb, w_total;  // WA, WRGB after the WH_i
  int f_total;
  int part_cols;  // a tile's partial row: the f32 rows, then WA and WRGB
};

Layout flex_layout(int n) {
  Layout L;
  L.n = n;
  L.wa = FW_OFF_WH + n * HIDDEN * HIDDEN;
  L.wrgb = L.wa + HIDDEN;
  L.w_total = L.wrgb + DIR_HIDDEN * 3;
  L.f_total = FF_OFF_BH + n * HIDDEN;
  L.part_cols = L.f_total + HIDDEN + DIR_HIDDEN * 3;
  return L;
}

// The backward's workspace: per buffer a (rows, width) row-major matrix,
// rows being the pass's sample rows rounded up to whole tiles. All null in
// a forward-only call.
struct Workspace {
  size_t rows;
  bf16* xin;
  bf16* acts;   // a_0..a_n, each (rows, HIDDEN)
  bf16* feat;
  bf16* x0;
  bf16* gx0;
  bf16* gfeat;
  bf16* gpre;   // g_0..g_{n-1}: the cotangents of WH_i's outputs before the relu
  bf16* ga0;    // the cotangent of a_0
  float* tile_part;  // (tiles, part_cols)
  float* dw_part;    // (DW_SPLIT_MAX, wa)

  __device__ __forceinline__ bf16* act(int i, size_t row0) const {
    return acts + ((size_t)i * rows + row0) * HIDDEN;
  }
  __device__ __forceinline__ bf16* g(int i, size_t row0) const {
    return gpre + ((size_t)i * rows + row0) * HIDDEN;
  }
};

size_t carve(unsigned char* base, long long rows, long long tiles, const Layout& L, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off = align256(off + bytes);
    return p;
  };
  auto mat = [&](size_t width) { return static_cast<bf16*>(take((size_t)rows * width * sizeof(bf16))); };
  Workspace w;
  w.rows = (size_t)rows;
  w.xin = mat(K_XIN);
  w.acts = mat((size_t)(L.n + 1) * HIDDEN);
  w.feat = mat(HIDDEN);
  w.x0 = mat(DIR_HIDDEN);
  w.gx0 = mat(DIR_HIDDEN);
  w.gfeat = mat(HIDDEN);
  w.gpre = mat((size_t)(L.n > 0 ? L.n : 1) * HIDDEN);
  w.ga0 = mat(HIDDEN);
  w.tile_part = static_cast<float*>(take((size_t)tiles * L.part_cols * sizeof(float)));
  w.dw_part = static_cast<float*>(take((size_t)DW_SPLIT_MAX * L.wa * sizeof(float)));
  if (ws) *ws = w;
  return off;
}

struct FwdArgs {
  const float* ro;     // (R, 3)
  const float* rd;     // (R, 3)
  const float* z;      // (R, S)
  const float* dir_c;  // (R, 128)
  const bf16* W;       // packed weights
  const float* F;      // packed bias rows + frequency bands
  float* out;          // (R, S, 4), or null in the backward's recompute
  Workspace ws;        // activations out (the backward), or all null
  Layout L;
  int n_rays, n_freqs;
};

struct FwdSmem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  bf16 xin[TILE_ROWS * LD_XIN];
  float sigma[TILE_ROWS];
  float rgb[TILE_ROWS * 3];
};

template <int S>
__global__ void __launch_bounds__(THREADS, 1) flex_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int ray0 = blockIdx.x * RAYS;
  const size_t row0 = (size_t)blockIdx.x * TILE_ROWS;
  const bf16* W = a.W;
  const float* F = a.F;
  const Workspace& ws = a.ws;
  const int n = a.L.n;
  const bool save = ws.xin != nullptr;
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];

  encode_tile<S>(sm.xin, save ? ws.xin + row0 * K_XIN : nullptr, a.ro, a.rd, a.z, F + FF_OFF_FREQS,
                 ray0, a.n_rays, a.n_freqs);
  bf16* cur = sm.act[0];
  bf16* nxt = sm.act[1];
  // layer1: NO relu (`fused_flex.py:110`)
  mma_layer<HIDDEN, K_XIN, 0, false>(s0, s1, sm.xin, LD_XIN, nullptr, W + FW_OFF_W1, cur,
                                     save ? ws.act(0, row0) : nullptr, nullptr,
                                     EpiBias<false>{F + FF_OFF_V0});
  for (int i = 0; i < n; ++i) {
    mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, cur, LD_ACT, nullptr, W + FW_OFF_WH + i * HH, nxt,
                                        save ? ws.act(i + 1, row0) : nullptr, nullptr,
                                        EpiBias<true>{F + FF_OFF_BH + i * HIDDEN});
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  // cur = a_n; nxt = feat
  mma_layer<HIDDEN, HIDDEN, 0, false>(s0, s1, cur, LD_ACT, nullptr, W + FW_OFF_WF, nxt,
                                      save ? ws.feat + row0 * HIDDEN : nullptr, nullptr,
                                      EpiBias<true>{F + FF_OFF_BF});
  // σ off the trunk (`fused_flex.py:116`); the next layer overwrites cur
  // only after its first barrier
  if (a.out != nullptr) sigma_head(sm.sigma, cur, W + a.L.wa, F[FF_OFF_BA]);
  mma_layer<DIR_HIDDEN, HIDDEN, 0, false>(s0, s1, nxt, LD_ACT, nullptr, W + FW_OFF_WD0, cur,
                                          save ? ws.x0 + row0 * DIR_HIDDEN : nullptr, nullptr,
                                          EpiDirRelu<S>{F + FF_OFF_BD0, a.dir_c, ray0, a.n_rays});
  if (a.out == nullptr) return;
  rgb_head(sm.rgb, cur, W + a.L.wrgb, F + FF_OFF_BRGB);
  const size_t rows = (size_t)a.n_rays * S;
  for (int e = threadIdx.x; e < TILE_ROWS * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    if (row0 + r < rows) a.out[(row0 + r) * 4 + c] = c < 3 ? sm.rgb[r * 3 + c] : sm.sigma[r];
  }
}

// ---------------------------------------------------------------------------
// The dX chain

struct BwdArgs {
  const float* g;  // (R, S, 4): the cotangent of [rgb, σ]
  const bf16* W;   // packed forward weights (for wrgb, wa)
  const bf16* WT;  // packed transposed weights
  float* d_dir;    // (R, 128)
  Workspace ws;
  Layout L;
  int n_rays;
};

struct BwdSmem {
  bf16 act[2][TILE_ROWS * LD_ACT];
  bf16 wstage[2][KC * LD_W];
  float colsum[4 * HIDDEN];
  float gsig[TILE_ROWS];
  float grgb[TILE_ROWS * 3];
};

template <int S>
__global__ void __launch_bounds__(THREADS, 1) flex_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  constexpr int RAYS = TILE_ROWS / S;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ray0 = tile * RAYS;
  const size_t row0 = (size_t)tile * TILE_ROWS;
  const Workspace& ws = a.ws;
  const Layout& L = a.L;
  const int n = L.n;
  const size_t oD = row0 * DIR_HIDDEN, oH = row0 * HIDDEN;
  float* part = ws.tile_part + (size_t)tile * L.part_cols;
  bf16* s0 = sm.wstage[0];
  bf16* s1 = sm.wstage[1];

  // the cotangent of the tile's rows; rows past the last ray are 0
  const size_t rows = (size_t)a.n_rays * S;
  for (int e = tid; e < TILE_ROWS * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    const float v = row0 + r < rows ? a.g[(row0 + r) * 4 + c] : 0.f;
    if (c < 3)
      sm.grgb[r * 3 + c] = v;
    else
      sm.gsig[r] = v;
  }
  __syncthreads();

  // the σ and rgb heads (256→1, 128→3: no tensor-core shape): their bias
  // sums and weight gradients x0ᵀ·bf16(g_rgb), a_nᵀ·bf16(g_σ) per tile
  if (tid < 3) {
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r) sum += sm.grgb[r * 3 + tid];
    part[FF_OFF_BRGB + tid] = sum;
  } else if (tid == 3) {
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r) sum += sm.gsig[r];
    part[FF_OFF_BA] = sum;
  } else if (tid >= 32 && tid < 32 + (FF_OFF_BH - FF_OFF_FREQS)) {
    part[FF_OFF_FREQS + tid - 32] = 0.f;
  }
  const bf16* x0 = ws.x0 + oD;
  for (int idx = tid; idx < DIR_HIDDEN * 3; idx += THREADS) {
    const int k = idx / 3, ch = idx % 3;
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r)
      sum += __bfloat162float(x0[(size_t)r * DIR_HIDDEN + k]) * round_bf16(sm.grgb[r * 3 + ch]);
    part[L.f_total + HIDDEN + idx] = sum;
  }
  const bf16* an = ws.act(n, row0);
  for (int k = tid; k < HIDDEN; k += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r)
      sum += __bfloat162float(an[(size_t)r * HIDDEN + k]) * round_bf16(sm.gsig[r]);
    part[L.f_total + k] = sum;
  }

  // gx0 = bf16(g_rgb) Wrgbᵀ ⊙ [x0 > 0]: thread (k, rows of block tid/128)
  bf16* cur = sm.act[0];
  bf16* nxt = sm.act[1];
  {
    const int k = tid & (DIR_HIDDEN - 1), blk = tid / DIR_HIDDEN;
    const bf16* wr = a.W + L.wrgb + k * 3;
    const float w0 = __bfloat162float(wr[0]), w1 = __bfloat162float(wr[1]), w2 = __bfloat162float(wr[2]);
    float sum = 0.f;
    for (int r = blk * 32; r < blk * 32 + 32; ++r) {
      float v = round_bf16(sm.grgb[r * 3]) * w0 + round_bf16(sm.grgb[r * 3 + 1]) * w1 +
                round_bf16(sm.grgb[r * 3 + 2]) * w2;
      if (!(__bfloat162float(x0[(size_t)r * DIR_HIDDEN + k]) > 0.f)) v = 0.f;
      const bf16 b = __float2bfloat16_rn(v);
      cur[r * LD_ACT + k] = b;
      ws.gx0[oD + (size_t)r * DIR_HIDDEN + k] = b;
      sum += v;
    }
    sm.colsum[blk * DIR_HIDDEN + k] = sum;
  }
  __syncthreads();
  tile_colsum<DIR_HIDDEN>(part + FF_OFF_BD0, sm.colsum);
  // d_dir: the sum of gx0 over the ray's rows (S/32 blocks of 32)
  for (int e = tid; e < RAYS * DIR_HIDDEN; e += THREADS) {
    const int j = e / DIR_HIDDEN, c = e % DIR_HIDDEN;
    if (ray0 + j >= a.n_rays) continue;
    float sum = 0.f;
    for (int b = j * (S / 32); b < (j + 1) * (S / 32); ++b) sum += sm.colsum[b * DIR_HIDDEN + c];
    a.d_dir[(size_t)(ray0 + j) * DIR_HIDDEN + c] = sum;
  }

  // g_feat = bf16(gx0) WD0ᵀ ⊙ [feat > 0]
  mma_layer<HIDDEN, DIR_HIDDEN, 0, true>(s0, s1, cur, LD_ACT, nullptr, a.WT + FT_OFF_WD0T, nxt,
                                         ws.gfeat + oH, sm.colsum,
                                         EpiMask{ws.feat + oH, HIDDEN});
  tile_colsum<HIDDEN>(part + FF_OFF_BF, sm.colsum);
  // the trunk's last activation a_n feeds fc_feat and the σ head:
  // (bf16(g_feat) WFᵀ + bf16(g_σ) ⊗ wa) ⊙ [a_n > 0], unmasked when a_n is
  // layer1's output (n = 0)
  mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, nxt, LD_ACT, nullptr, a.WT + FT_OFF_WFT, cur,
                                     n > 0 ? ws.g(n - 1, row0) : ws.ga0 + oH, sm.colsum,
                                     EpiAddSigma{sm.gsig, a.W + L.wa, n > 0 ? an : nullptr, HIDDEN});
  tile_colsum<HIDDEN>(part + (n > 0 ? FF_OFF_BH + (n - 1) * HIDDEN : FF_OFF_V0), sm.colsum);
  // down the hidden layers: g_{i-1} = bf16(g_i) WH_iᵀ ⊙ [a_i > 0], and at
  // i = 0 the cotangent of layer1's output a_0, unmasked
  for (int i = n - 1; i >= 0; --i) {
    mma_layer<HIDDEN, HIDDEN, 0, true>(s0, s1, cur, LD_ACT, nullptr, a.WT + FT_OFF_WHT + i * HH, nxt,
                                       i > 0 ? ws.g(i - 1, row0) : ws.ga0 + oH, sm.colsum,
                                       EpiMask{i > 0 ? ws.act(i, row0) : nullptr, HIDDEN});
    tile_colsum<HIDDEN>(part + (i > 0 ? FF_OFF_BH + (i - 1) * HIDDEN : FF_OFF_V0), sm.colsum);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <int S>
int launch_tiles(const FwdArgs& fa, const BwdArgs* ba, int tiles, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flex_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(FwdSmem));
  if (e != cudaSuccess) return (int)e;
  flex_fwd_kernel<S><<<tiles, THREADS, sizeof(FwdSmem), stream>>>(fa);
  e = cudaGetLastError();
  if (e != cudaSuccess || ba == nullptr) return (int)e;
  e = cudaFuncSetAttribute(flex_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(BwdSmem));
  if (e != cudaSuccess) return (int)e;
  flex_bwd_kernel<S><<<tiles, THREADS, sizeof(BwdSmem), stream>>>(*ba);
  return (int)cudaGetLastError();
}

int launch_by_samples(int n_samples, const FwdArgs& fa, const BwdArgs* ba, int tiles, cudaStream_t st) {
  switch (n_samples) {
    case 32:
      return launch_tiles<32>(fa, ba, tiles, st);
    case 64:
      return launch_tiles<64>(fa, ba, tiles, st);
    case 128:
      return launch_tiles<128>(fa, ba, tiles, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool valid(int n_rays, int n_samples, int n_freqs, int n_hidden) {
  return n_rays >= 0 && n_freqs >= 1 && 3 + 6 * n_freqs <= K_XIN && n_hidden >= 0 &&
         n_hidden <= MAX_HIDDEN && (n_samples == 32 || n_samples == 64 || n_samples == 128);
}

}  // namespace

// Shared memory a CTA of each kernel takes: out[0] flex_fwd_kernel and
// out[1] flex_bwd_kernel (dynamic), out[2] dw_kernel (static).
extern "C" void nerface_fused_flex_shared_bytes(long long* out) {
  out[0] = (long long)sizeof(FwdSmem);
  out[1] = (long long)sizeof(BwdSmem);
  out[2] = (long long)DW_SMEM_BYTES;
}

// K4f. Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int nerface_fused_flex_fwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const float* F, float* out,
                                      int n_rays, int n_samples, int n_freqs, int n_hidden,
                                      void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden)) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)n_rays * n_samples + TILE_ROWS - 1) / TILE_ROWS;
  if (tiles == 0) return 0;
  FwdArgs fa{ro, rd, z, dir_c, static_cast<const bf16*>(W), F, out, Workspace{}, flex_layout(n_hidden),
             n_rays, n_freqs};
  return launch_by_samples(n_samples, fa, nullptr, (int)tiles, static_cast<cudaStream_t>(stream));
}

// Bytes of device workspace one K4b call needs.
extern "C" long long nerface_fused_flex_workspace_bytes(int n_rays, int n_samples, int n_hidden) {
  const long long tiles = ((long long)n_rays * n_samples + TILE_ROWS - 1) / TILE_ROWS;
  return (long long)carve(nullptr, tiles * TILE_ROWS, tiles, flex_layout(n_hidden), nullptr);
}

// K4b: the gradients of Σ g·out. Returns a cudaError_t (0 on success).
// Launches on `stream`, does not synchronise and allocates nothing:
// `workspace` holds nerface_fused_flex_workspace_bytes(...) bytes. dW is the
// f32 gradient in the packed weight layout, dF in the bias-row layout (its
// V0 row holds d_v0; FREQS is 0), d_dir (R, 128).
extern "C" int nerface_fused_flex_bwd(const float* ro, const float* rd, const float* z,
                                      const float* dir_c, const void* W, const void* WT,
                                      const float* F, const float* g, float* dW, float* dF,
                                      float* d_dir, void* workspace, int n_rays, int n_samples,
                                      int n_freqs, int n_hidden, void* stream) {
  if (!valid(n_rays, n_samples, n_freqs, n_hidden)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const long long tiles = ((long long)n_rays * n_samples + TILE_ROWS - 1) / TILE_ROWS;
  const int rows = (int)(tiles * TILE_ROWS);
  const Layout L = flex_layout(n_hidden);
  Workspace ws;
  carve(static_cast<unsigned char*>(workspace), rows, tiles, L, &ws);
  const bf16* Wb = static_cast<const bf16*>(W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs fa{ro, rd, z, dir_c, Wb, F, nullptr, ws, L, n_rays, n_freqs};
  BwdArgs ba{g, Wb, static_cast<const bf16*>(WT), d_dir, ws, L, n_rays};
  int err = launch_by_samples(n_samples, fa, &ba, (int)tiles, st);
  if (err != 0) return err;

  // dW over row segments of whole 64-row chunks
  DwMat mats[DW_MATS_MAX];
  int n_mats = 0;
  mats[n_mats++] = {ws.xin, ws.ga0, K_XIN, K_XIN, HIDDEN, FW_OFF_W1, 0};
  mats[n_mats++] = {ws.acts + (size_t)n_hidden * rows * HIDDEN, ws.gfeat, HIDDEN, HIDDEN, HIDDEN,
                    FW_OFF_WF, 0};
  mats[n_mats++] = {ws.feat, ws.gx0, HIDDEN, HIDDEN, DIR_HIDDEN, FW_OFF_WD0, 0};
  for (int i = 0; i < n_hidden; ++i)
    mats[n_mats++] = {ws.acts + (size_t)i * rows * HIDDEN, ws.gpre + (size_t)i * rows * HIDDEN, HIDDEN,
                      HIDDEN, HIDDEN, FW_OFF_WH + i * HIDDEN * HIDDEN, 0};
  err = launch_dw(mats, n_mats, ws.dw_part, L.wa, rows, dW, st);
  if (err != 0) return err;
  reduce_rows<<<(L.part_cols + 255) / 256, 256, 0, st>>>(ws.tile_part, (int)tiles, L.part_cols,
                                                        L.f_total, dF, dW + L.wa);
  return (int)cudaGetLastError();
}
