// The paper model's packed operand layout, shared by its kernels (K2
// fused_paper_render.cu, K1 fused_train_pass.cu, K3 fused_paper_mlp.cu)
// and K4 (fused_flex.cu): the widths, the offsets of the packed weights
// and bias rows, the bf16 rounding helper, and `dispatch_pass`, which runs
// a kernel's instantiation for a pass's layout class and model.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace nerface {

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 256;
constexpr int DIR_HIDDEN = 128;
// Layer 0 and the skip layer read [xyz; PE; 0]: K = K_XIN holds up to 10
// bands (3 + 6·10 = 63 columns), K = K_XIN_WIDE up to 20 (123 columns) as
// two 64-column blocks, K = K_XIN_XL up to MAX_FREQS = 31 (189 columns) as
// three. The paper kernels (K2, K3, K1) take every extent,
// `xin_extent(n_freqs)`; K4 (fused_flex.cu) the first two, up to its own
// FLEX_MAX_FREQS = 20.
constexpr int K_XIN = 64;
constexpr int K_XIN_WIDE = 128;
constexpr int K_XIN_XL = 192;
constexpr int MAX_FREQS = (K_XIN_XL - 3) / 6;
__host__ __device__ constexpr int xin_extent(int n_freqs) {
  return 3 + 6 * n_freqs <= K_XIN ? K_XIN : (3 + 6 * n_freqs <= K_XIN_WIDE ? K_XIN_WIDE : K_XIN_XL);
}

// Packed operand offsets, in elements. They must equal W_OFFSETS /
// F_OFFSETS in ops/kernels/fused_mlp.py (tests/test_torch_fused_render.py
// checks it).
// bf16 weights, each (in, out) row-major, at K = K_XIN (`w_off` moves
// them to K = K_XIN_WIDE or K_XIN_XL):
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
constexpr int F_OFF_TOTAL = 2212;
// FREQS holds MAX_FREQS bands and one spare slot: an even F_OFF_TOTAL keeps
// the float2 columns of K1's partial rows (PART_WA, paper_train.cuh) and
// the rows themselves 8-byte aligned.
constexpr int FREQ_SLOTS = 32;
static_assert(W_OFF_W1 - W_OFF_W0 == K_XIN * HIDDEN && W_OFF_W4 - W_OFF_W3 == (K_XIN + HIDDEN) * HIDDEN &&
                  W_OFF_WD1 - W_OFF_WD0 == HIDDEN * DIR_HIDDEN && W_OFF_WRGB - W_OFF_WA == HIDDEN &&
                  W_OFF_TOTAL - W_OFF_WRGB == DIR_HIDDEN * 3,
              "weight layout");
static_assert(F_OFF_BD0 - F_OFF_BF == HIDDEN && F_OFF_BA - F_OFF_BD2 == DIR_HIDDEN &&
                  F_OFF_FREQS - F_OFF_BRGB == 3 && F_OFF_TOTAL - F_OFF_FREQS == FREQ_SLOTS &&
                  FREQ_SLOTS >= MAX_FREQS && F_OFF_TOTAL % 2 == 0,
              "bias row layout");

// The offset W_OFF_* `off` in the packed weights of encoding extent kx: W0
// (kx × 256) and W3 ([w3xa; w3xb; 0] in kx rows, then w3h) each hold kx − K_XIN
// more rows than at K_XIN, which move every later offset (w_off(W_OFF_W3 +
// K_XIN·HIDDEN, kx), w3h's first row, is W3's at kx plus kx·HIDDEN).
__host__ __device__ constexpr int w_off(int off, int kx) {
  return off + (off > W_OFF_W0 ? (kx - K_XIN) * HIDDEN : 0) + (off > W_OFF_W3 ? (kx - K_XIN) * HIDDEN : 0);
}
static_assert(w_off(W_OFF_TOTAL, K_XIN_WIDE) == W_OFF_TOTAL + 2 * 64 * HIDDEN &&
                  w_off(W_OFF_W3 + K_XIN * HIDDEN, K_XIN_WIDE) == w_off(W_OFF_W3, K_XIN_WIDE) + K_XIN_WIDE * HIDDEN,
              "the wide weight layout");
static_assert(w_off(W_OFF_TOTAL, K_XIN_XL) == W_OFF_TOTAL + 2 * 128 * HIDDEN &&
                  w_off(W_OFF_W1, K_XIN_XL) == K_XIN_XL * HIDDEN &&
                  w_off(W_OFF_W3 + K_XIN * HIDDEN, K_XIN_XL) == w_off(W_OFF_W3, K_XIN_XL) + K_XIN_XL * HIDDEN,
              "the three-block weight layout");

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The layout classes a build of a library holds (a -D switch, so that
// `build.py` compiles them as two libraries side by side, each half the
// nvcc time): 1 the runtime class only, 2 the fixed classes only, 3 both.
#ifndef NERFACE_SAMPLE_CLASSES
#define NERFACE_SAMPLE_CLASSES 3
#endif

// Runs FN<SF, SMALL>::run(args...) for a pass of n_samples samples a ray
// and its model (SMALL: the smaller paper model), and returns its
// cudaError_t. SF is the pass's layout class: 64 or 128 (the paper
// schedule's passes, S folded in as a constant), else 0 (S read at run
// time, any S the kernels take); cudaErrorInvalidValue for a class the
// build does not hold. The fixed classes read a one-block xin image (K =
// K_XIN): a pass of xc = 2 or 3 blocks (K_XIN_WIDE, K_XIN_XL) runs the
// runtime class at any S, which reads xc at run time too.
template <template <int, bool> class FN, class... Args>
int dispatch_pass(int n_samples, int small, int xc, Args&&... args) {
#if NERFACE_SAMPLE_CLASSES & 2
  switch (xc == 1 ? n_samples * 2 + (small ? 1 : 0) : 0) {
    case 128:
      return FN<64, false>::run(args...);
    case 129:
      return FN<64, true>::run(args...);
    case 256:
      return FN<128, false>::run(args...);
    case 257:
      return FN<128, true>::run(args...);
    default:
      break;
  }
#endif
#if NERFACE_SAMPLE_CLASSES & 1
  return small ? FN<0, true>::run(args...) : FN<0, false>::run(args...);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

}  // namespace nerface
