// The layer chain of the port's persistent wgmma MLP kernels, shared by K2
// and K3f (through paper_chain.cuh) and K4f / K4b's recompute
// (fused_flex.cu).
//
// A CTA has two consumer warpgroups and a producer warpgroup. The
// producer's first thread streams each layer's weight chunk images
// (wgmma_tile.cuh) through a ring of CHAIN_STAGE-byte stages
// (`load_layer`), three of its warps encode each unit's [xyz; PE; 0] tile
// into the consumer's two swizzled xin buffers (`encode_units`), handed
// over on mbarriers. A consumer warpgroup takes whole rays as 64-row units
// (`UnitSchedule`, S fixed by a layout class or read at run time) and runs
// each layer as one chain of wgmmas
// with A in registers (`chain_layer`), its epilogue turning the
// accumulators into the next layer's A (`acc_to_a` with `ChainBias`,
// `ChainDir` or `ChainDirRows`); the narrow heads are m64n8 products
// (`chain_head`). Nothing here calls out: ptxas serialises every wgmma of
// a kernel that contains a call.

#pragma once

#include "wgmma_tile.cuh"

namespace nerface {
namespace sm90 {

constexpr int CHAIN_CONSUMERS = 2;                 // warpgroups computing units
constexpr int CHAIN_ENCODERS = 3;                  // warps of the producer warpgroup that encode
constexpr int CHAIN_STAGE = KCH * 256 * 2;         // a ring stage: one 64 × 256 bf16 chunk image
constexpr int XIN_BYTES = 64 * ROW_BYTES;          // a 64-column block of a unit's [xyz; PE; 0]

// The kernels' sample counts: 1..MAX_SAMPLES, one limit for the paper
// kernels (K2, K3f, K1, K3b), K4f / K4b and K5's Sc + Sf
// (fused_resample.cu). An item of at most ITEM_ROWS rows (four units) is
// what K2's and K1's shared memory holds for the compositing; a longer
// ray is an item of its own.
constexpr int MAX_SAMPLES = 1024;
constexpr int ITEM_ROWS = 256;

// The kernels' unit layout at any S in 1..MAX_SAMPLES: an item, what
// a consumer warpgroup takes at once, is `rays` whole rays in `units`
// 64-row units. Its row i < rays·S is sample i % S of its ray i / S; the
// rows from rays·S to 64·units pad the last unit, and the kernels take
// them as rows past the last ray. S dividing 64: 64 / S rays in one unit;
// S a multiple of 64: one ray in S / 64 units; any other S: the ray count up to ITEM_ROWS / S whose units hold the most
// real rows a unit, the fewest rays on a tie (8 rays in 3 units at S = 24,
// 4 in 3 at 48, 2 in 3 at 96, 1 in 3 at 192, 3 in 2 at 40). Past
// ITEM_ROWS an item is one ray in ⌈S / 64⌉ units (a long item: `long_item`),
// up to 16 at MAX_SAMPLES; K2 composites it in segments of ITEM_ROWS
// rows, K1 and K3b keep its rows in the workspace (paper_train.cuh), K4f
// and K4b walk its units as any other item's (fused_flex.cu).
// ops/kernels/fused_mlp.py::unit_layout is the same rule. An item row's
// ray, row / S, is a multiply and a shift (`ray_of`, div = ⌈2^24 / S⌉): it
// is exact while row·e < 2^24, e = S·div − 2^24 < S, so for every row below
// ITEM_ROWS and every row of a long item (below S + 64: 1087·1023 < 2^24 at
// MAX_SAMPLES); the encoder warps, which divide once a task, keep
// pace with the consumers as at a compile-time S.
//
// xc is the pass's xin image in 64-column blocks: 1 (K = 64, up to 10
// bands), 2 (K = 128, 11..20 bands) or 3 (K = 192, 21..31 bands, the
// paper kernels only). A consumer warpgroup's xin buffers are two of one
// block (the encoders one unit ahead) or one of xc blocks (`xin_buf`,
// `xin_at`).
struct UnitLayout {
  int S, rays, units;
  uint32_t div;  // ⌈2^24 / S⌉
  int xc;
  __host__ __device__ static UnitLayout of(int s, int xc = 1) {
    int rays = 1, units = (s + 63) / 64;
    if (64 % s == 0) {
      rays = 64 / s;
    } else if (s % 64 != 0) {
      for (int n = 2; n * s <= ITEM_ROWS; ++n) {
        const int u = (n * s + 63) / 64;
        if (n * units > rays * u) {  // n / u > rays / units
          rays = n;
          units = u;
        }
      }
    }
    return UnitLayout{s, rays, units, ((1u << 24) + (uint32_t)s - 1u) / (uint32_t)s, xc};
  }
  // row / S for 0 ≤ row < max(ITEM_ROWS, 64·units)
  __host__ __device__ int ray_of(int row) const { return (int)(((uint32_t)row * div) >> 24); }
};

// The schedule of a pass's items at its layout, for an instantiation of
// layout class SF: at SF = 0 the UnitLayout `l` (a kernel argument, computed on the
// host: read from the argument space, S, rays and units hold no register
// through the consumers' chains); at SF = 64 or 128, the passes of the
// bundled configs (64 + 64), one ray over SF / 64 units as constants, so
// that code folds as it did when S was a template argument of every
// kernel (at a runtime S, K1's 64 + 64 pair took 2.5–4 % longer and K2's
// tile 2 %); a fixed class reads one xin block (`dispatch_pass` sends a
// pass of two to the runtime class). Round r of a CTA group of CTAS gives item (r·CTAS + rank)·
// CHAIN_CONSUMERS + wg to consumer wg of CTA rank; item k holds rays
// [k·rays, (k + 1)·rays) and the pass's units [k·units, (k + 1)·units).
template <int SF, int CTAS>
struct UnitSchedule {
  static_assert(SF % 64 == 0, "a fixed layout class is one ray over whole units");
  const UnitLayout& l;
  __host__ __device__ int samples() const { return SF ? SF : l.S; }
  __host__ __device__ int wg_rays() const { return SF ? 1 : l.rays; }
  __host__ __device__ int units() const { return SF ? SF / 64 : l.units; }
  __host__ __device__ int rows() const { return SF ? SF : l.rays * l.S; }
  __host__ __device__ int ray_of(int row) const { return SF ? row / SF : l.ray_of(row); }
  __host__ __device__ int xc() const { return SF ? 1 : l.xc; }
  // an item past ITEM_ROWS rows: one ray of more than four units
  __host__ __device__ bool long_item() const { return SF ? false : l.units * 64 > ITEM_ROWS; }
  __host__ __device__ int rounds(int n_rays) const {
    const int per_round = CTAS * CHAIN_CONSUMERS * wg_rays();
    return (n_rays + per_round - 1) / per_round;
  }
  __host__ __device__ static int item(int round, int rank, int wg) {
    return (round * CTAS + rank) * CHAIN_CONSUMERS + wg;
  }
};

// A consumer warpgroup's k-th unit (k = 0, 1, ...) is encoded into its
// xin buffer xin_buf(k, xc) (a buffer of xc blocks: buffer 0 at xc = 2
// spans the two blocks of xin[wg]), whose barriers complete phase
// xin_phase(k, xc) for it.
__host__ __device__ __forceinline__ int xin_buf(int k, int xc) { return xc == 1 ? k & 1 : 0; }
__host__ __device__ __forceinline__ int xin_phase(int k, int xc) { return xc == 1 ? (k >> 1) & 1 : k & 1; }

// The bytes of consumer warpgroup wg's xin buffer b in a paper kernel's
// shared memory, whose `xin` (CHAIN_CONSUMERS × 2 blocks) directly follows
// its weight ring of CHAIN_STAGE-byte stages: xin[wg][b] up to xc = 2; at
// xc = 3 the two warpgroups' three-block buffers (48 KB) start at the
// ring's last stage, which that layout's ring leaves unused
// (`ring_stages`), and run on into xin.
__device__ __forceinline__ unsigned char* xin_at(unsigned char (*xin)[2][XIN_BYTES], int wg, int b, int xc) {
  return xc == 3 ? xin[0][0] - CHAIN_STAGE + wg * 3 * XIN_BYTES : xin[wg][b];
}
static_assert(2 * 3 * XIN_BYTES <= CHAIN_STAGE + CHAIN_CONSUMERS * 2 * XIN_BYTES, "the xc = 3 xin buffers");

// The stages a paper kernel's ring of RING runs at xc blocks: one fewer
// at xc = 3, whose xin buffers take the last (`xin_at`).
template <int RING>
__host__ __device__ __forceinline__ int ring_stages(int xc) {
  return xc == 3 ? RING - 1 : RING;
}

// The producer: one layer's k / 64 chunks of 64 × n bf16 from the chunk
// images at `src`, each into the next stage (STAGE bytes, at least 128·n)
// once every consumer has released it; in a cluster of CTAS each CTA
// copies its part of a chunk and multicasts it to all. The ring runs
// `n_stages` of its RING stages (`ring_stages`).
template <int RING, int CTAS, int STAGE = CHAIN_STAGE>
__device__ __forceinline__ void load_layer(unsigned char (*stages)[STAGE], uint64_t* full, uint64_t* empty,
                                           Ring& ring, const bf16* src, int k, int n, uint32_t rank,
                                           int n_stages = RING) {
  const uint32_t bytes = KCH * n * 2, part = bytes / CTAS;
  for (int c = 0; c < k / KCH; ++c) {
    mbar_wait(&empty[ring.stage], ring.phase ^ 1);
    mbar_expect_tx(&full[ring.stage], bytes);
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src + c * KCH * n);
    if constexpr (CTAS == 1) {
      bulk_load(stages[ring.stage], s, bytes, &full[ring.stage]);
    } else {
      bulk_load_multicast(stages[ring.stage] + rank * part, s + rank * part, part, &full[ring.stage],
                          (1u << CTAS) - 1);
    }
    ring.advance(n_stages);
  }
}

// One layer of a warpgroup's 64 rows: acc = A·W over the layer's chunks
// of N columns. A is a K-major image in shared memory at xin (64 × 64
// blocks, XIN_BYTES apart: the encoded tile, or K4b's A tile) for the
// first X_CHUNKS·xc chunks (xc > 1 only where X_CHUNKS is 1: layer 0 and
// the skip layer of a wide xin image, xc read at run time in a runtime
// layout class), then the registers a[] for NCH − X_CHUNKS chunks (k16
// slice s in a[4s .. 4s + 3], indexed at compile time). One chunk's group
// stays in flight while the previous stage is released
// (`release(stage)`). Afterwards the accumulators and the first A_LIVE A
// registers are fenced (K2 fences all 64). With FRESH the accumulators'
// old values are made constants first: the first product does not read
// them, but its asm operand would keep them live through the epilogue
// before. A stage holds STAGE bytes: a chunk image's N rows of 64 k, or
// (K4b's dX) half of them; the ring runs `n_stages` of its RING.
template <int N, int NCH, int X_CHUNKS, int RING, bool FRESH = false, int A_LIVE = 64, int STAGE = CHAIN_STAGE,
          class Release>
__device__ __forceinline__ void chain_layer(float* acc, uint32_t* a, uint32_t xin, unsigned char (*stages)[STAGE],
                                            uint64_t* full, Ring& ring, const Release& release, int xc = 1,
                                            int n_stages = RING) {
  if constexpr (FRESH) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  const int nx = X_CHUNKS * xc;  // the chunks whose A is in shared memory
  int prev = 0;
#pragma unroll
  for (int c = 0; c < nx; ++c) {
    mbar_wait(&full[ring.stage], ring.phase);
    const uint32_t b = smem_u32(stages[ring.stage]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KCH / 16; ++kk)
      wgmma_ss<N>(acc, desc_k(xin + c * XIN_BYTES + 32 * kk), desc_k(b + 32 * kk), (c > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      release(prev);
    }
    prev = ring.stage;
    ring.advance(n_stages);
  }
#pragma unroll
  for (int c = 0; c < NCH - X_CHUNKS; ++c) {
    mbar_wait(&full[ring.stage], ring.phase);
    const uint32_t b = smem_u32(stages[ring.stage]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KCH / 16; ++kk)
      wgmma_rs<N>(acc, a + 4 * ((KCH / 16) * c + kk), desc_k(b + 32 * kk), (nx > 0 || c > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    if (nx > 0 || c > 0) {
      wgmma_wait<1>();
      release(prev);
    }
    prev = ring.stage;
    ring.advance(n_stages);
  }
  wgmma_wait<0>();
  release(prev);
  fence_regs<N / 2>(acc);
  fence_regs<A_LIVE>(a);
}

// A head: the m64n8 product of the K bf16 columns in a[] with a (K, 8)
// weight image at shared address `w` (K / 64 chunks of 1 KB), into d.
template <int K>
__device__ __forceinline__ void chain_head(float* d, uint32_t* a, uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s) wgmma_rs_n8(d, a + 4 * s, desc_k(w + (s >> 2) * 8 * ROW_BYTES + 32 * (s & 3)), s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<4>(d);
  fence_regs<64>(a);
}

// A head's (K, 8) image in shared memory from the row-major (K, cols)
// bf16 weight at `w`, zero past `cols`: element (k, n) at chunk k / 64,
// byte sw128(n, k % 64). The caller fences for the async proxy.
template <int K>
__device__ __forceinline__ void head_image(unsigned char (*img)[8 * ROW_BYTES], const bf16* w, int cols, int t,
                                           int threads) {
  for (int i = t; i < K * 8; i += threads) {
    const int k = i >> 3, n = i & 7;
    *reinterpret_cast<bf16*>(img[k / KCH] + sw128(n, k % KCH)) = n < cols ? w[k * cols + n] : __float2bfloat16_rn(0.f);
  }
}

// Epilogues on the accumulator (acc_to_a applies the relu): + bias row;
// the direction branch's first layer adds the ray's dir_c row too.
struct ChainBias {
  const float* bias;
  __device__ __forceinline__ float2 operator()(int, int col, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    return make_float2(v0 + b.x, v1 + b.y);
  }
};

struct ChainDir {
  const float* bias;
  const float* dir_c;  // the ray's row, or null past the last ray
  __device__ __forceinline__ float2 operator()(int, int col, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    v0 += b.x;
    v1 += b.y;
    if (dir_c != nullptr) {
      const float2 d = __ldg(reinterpret_cast<const float2*>(dir_c + col));
      v0 += d.x;
      v1 += d.y;
    }
    return make_float2(v0, v1);
  }
};

// The same where the thread's two rows (r0 and r0 + 8) may lie in two
// rays: row half h adds dir_c[h] (null for a padding row or past the last
// ray). The paper kernels, at any S.
struct ChainDirRows {
  const float* bias;
  const float* dir_c[2];
  __device__ __forceinline__ float2 operator()(int h, int col, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    v0 += b.x;
    v1 += b.y;
    const float* d = h ? dir_c[1] : dir_c[0];
    if (d != nullptr) {
      const float2 dv = __ldg(reinterpret_cast<const float2*>(d + col));
      v0 += dv.x;
      v1 += dv.y;
    }
    return make_float2(v0, v1);
  }
};

// One encode task of a unit (rows row_base .. row_base + 63 of an item
// whose first ray is ray0, of schedule g: S = g.samples(), the real rows
// below g.rows()):
// row task % 64, the 32 columns [32·(task / 64), +32) of [xyz; sin(x·f +
// φ); 0], rounded to bf16, into the unit's swizzled xin buffer (column c
// in the 64-column block c / 64, XIN_BYTES apart) and, when xg is not
// null, into the same bytes of a workspace image. A row's point
// is loaded and computed once. The products and sums round separately (no
// FMA contraction) as in the plain version; `sinf` has full range
// reduction. Padding rows and rows past the last ray are 0. `a` has the
// rays (ro, rd, z), n_rays and n_freqs.
template <class G, class A>
__device__ __forceinline__ void encode_task(unsigned char* xin, unsigned char* xg, int task, const A& a,
                                            const float* freqs, int ray0, int row_base, const G& g) {
  const int r = task & 63, c0 = (task >> 6) * 32;
  const int block = (c0 >> 6) * XIN_BYTES;  // the task's 32 columns lie in one block
  const int row = row_base + r;
  const int q = g.ray_of(row);  // the item's ray of the row
  const int ray = ray0 + q;
  const int n_cols = row < g.rows() && ray < a.n_rays ? 3 + 6 * a.n_freqs : 0;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (n_cols > 0) {
    const float zz = a.z[(size_t)ray * g.samples() + (row - q * g.samples())];
    x0 = __fadd_rn(a.ro[ray * 3], __fmul_rn(a.rd[ray * 3], zz));
    x1 = __fadd_rn(a.ro[ray * 3 + 1], __fmul_rn(a.rd[ray * 3 + 1], zz));
    x2 = __fadd_rn(a.ro[ray * 3 + 2], __fmul_rn(a.rd[ray * 3 + 2], zz));
  }
  auto col = [&](int c) {
    if (c >= n_cols) return 0.f;
    if (c < 3) return c == 0 ? x0 : (c == 1 ? x1 : x2);
    const int p = c - 3, d = p % 3;
    const float phase = (p % 6) >= 3 ? 1.57079632679489661923f : 0.f;
    return sinf(__fadd_rn(__fmul_rn(d == 0 ? x0 : (d == 1 ? x1 : x2), freqs[p / 6]), phase));
  };
#pragma unroll 1
  for (int j = 0; j < 32; j += 2) {
    const int c = c0 + j;
    const uint32_t v = pack_bf16(col(c), col(c + 1));
    const int off = block + sw128(r, c & 63);
    *reinterpret_cast<uint32_t*>(xin + off) = v;
    if (xg != nullptr) *reinterpret_cast<uint32_t*>(xg + off) = v;
  }
}

// The encoder warps (CHAIN_ENCODERS · 32 threads, index e): every unit of
// both consumer warpgroups of CTA `rank`, rounds round0, round0 + step, ...
// below n_rounds of schedule g (a `UnitSchedule`), in the
// order the consumers take them, each (g.xc() blocks, 2·64·xc tasks) into
// the warpgroup's next xin buffer (`xin_buf`; xin(wg, b) its bytes) once
// its reader has released it. xg(item, u) is the unit's workspace image, or
// null.
template <class G, class A, class Xin, class Xg>
__device__ __forceinline__ void encode_units(const G& g, const Xin& xin,
                                             uint64_t (*xin_full)[2], uint64_t (*xin_empty)[2], const A& a,
                                             const float* freqs, uint32_t rank, int round0, int step,
                                             int n_rounds, int e, const Xg& xg) {
  int done[CHAIN_CONSUMERS] = {};  // units encoded for each warpgroup
  const int xc = g.xc(), tasks = 128 * xc;
  for (int round = round0; round < n_rounds; round += step) {
    for (int u = 0; u < g.units(); ++u) {
#pragma unroll
      for (int wg = 0; wg < CHAIN_CONSUMERS; ++wg) {
        const int b = xin_buf(done[wg], xc);
        mbar_wait(&xin_empty[wg][b], xin_phase(done[wg], xc) ^ 1);
        const int item = g.item(round, (int)rank, wg);
        unsigned char* gi = xg(item, u);
        for (int task = e; task < tasks; task += CHAIN_ENCODERS * 32)
          encode_task(xin(wg, b), gi, task, a, freqs, item * g.wg_rays(), u * 64, g);
        fence_proxy_async();
        mbar_arrive(&xin_full[wg][b]);
        ++done[wg];
      }
    }
  }
}

}  // namespace sm90
}  // namespace nerface
