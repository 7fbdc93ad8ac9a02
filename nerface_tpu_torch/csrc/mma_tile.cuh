// The paper model's packed operand layout, shared by its kernels (K2
// fused_paper_render.cu, K1 fused_train_pass.cu, K3 fused_paper_mlp.cu)
// and K4 (fused_flex.cu): the widths, the offsets of the packed weights
// and bias rows, the bf16 rounding helper, and `dispatch_pass`, which runs
// a kernel's instantiation for a pass's sample count and model.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace nerface {

typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 256;
constexpr int DIR_HIDDEN = 128;
constexpr int K_XIN = 64;

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

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

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
