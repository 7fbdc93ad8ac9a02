// Host-side ray-batch sampler for the training feed.
//
// Native equivalent of the per-step host work the reference does in
// numpy/torch (`train_transformed_rays.py:289-331`): draw `k` pixels
// without replacement from a per-frame importance distribution over H·W
// pixels, then assemble the ray batch (gather camera-frame directions,
// rotate by the head pose, gather target/background RGB).
//
// Sampling uses the Gumbel top-k construction (identical in distribution
// to successive sampling without replacement proportional to p): one pass
// over the probability map maintaining a k-element min-heap of
// log(p)+Gumbel keys — O(n log k), no temporaries, ~5x faster than the
// numpy log+gumbel+argpartition pipeline at n=262144, k=2048.
//
// Build: g++ -O3 -shared -fPIC -o libnerface_host.so ray_sampler.cpp
// Python binding: ctypes (nerface_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// xoshiro256++ — fast, seedable, reproducible across platforms.
struct Xoshiro256 {
  uint64_t s[4];

  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 expansion of the seed
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }

  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }

  inline uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform in (0, 1) — never exactly 0 (log-safe)
  inline double uniform() {
    return ((next() >> 11) + 1.0) * 0x1.0p-53;
  }
};

struct HeapEntry {
  double key;
  int64_t idx;
};

inline bool heap_less(const HeapEntry& a, const HeapEntry& b) {
  return a.key > b.key;  // min-heap on key
}

}  // namespace

extern "C" {

// Fill `out` (H*W doubles) with the reference's importance map: mass p
// uniform inside [h0,h1)x[w0,w1), (1-p) outside, normalized
// (`train_transformed_rays.py:229-239`).
void nerface_importance_map(int64_t H, int64_t W, int64_t h0, int64_t h1,
                            int64_t w0, int64_t w1, double p, double* out) {
  const double lo = 1.0 - p;
  double total = 0.0;
  for (int64_t y = 0; y < H; y++) {
    const bool in_y = (y >= h0 && y < h1);
    for (int64_t x = 0; x < W; x++) {
      const double v = (in_y && x >= w0 && x < w1) ? p : lo;
      out[y * W + x] = v;
      total += v;
    }
  }
  const double inv = 1.0 / total;
  for (int64_t i = 0; i < H * W; i++) out[i] *= inv;
}

// Draw k indices without replacement ~ probs (length n) via the
// exponential-race form of Gumbel top-k: key_i = p_i / E_i with
// E_i ~ Exp(1) (a monotone transform of log p_i + Gumbel_i, so the top-k
// sets are identical in distribution). Zero-mass pixels are never selected
// (as long as k <= #nonzero).
//
// Fast path: a pixel can enter the heap only if U_i > exp(-p_i/m) where m
// is the current heap minimum. Importance maps hold very few distinct
// probability values (2 for the reference's bbox maps), so those
// thresholds are cached and the common case costs one RNG draw + one
// compare — no transcendentals. The cache is rebuilt only when m changes
// (~k·ln(n/k) times).
void nerface_gumbel_topk(const double* probs, int64_t n, int64_t k,
                         uint64_t seed, int64_t* out_idx) {
  constexpr int kMaxDistinct = 8;
  Xoshiro256 rng(seed);
  HeapEntry* heap = new HeapEntry[k];
  int64_t size = 0;

  double distinct_p[kMaxDistinct];
  double thresh[kMaxDistinct];
  int n_distinct = 0;
  bool cache_ok = true;
  double m = 0.0;  // current heap min key

  auto rebuild = [&]() {
    for (int d = 0; d < n_distinct; d++)
      thresh[d] = std::exp(-distinct_p[d] / m);
  };

  for (int64_t i = 0; i < n; i++) {
    const double pi = probs[i];
    if (pi <= 0.0) continue;
    const double u = rng.uniform();

    if (size == k) {
      // threshold lookup for the common distinct values
      if (cache_ok) {
        int d = 0;
        for (; d < n_distinct; d++)
          if (distinct_p[d] == pi) break;
        if (d < n_distinct) {
          if (u <= thresh[d]) continue;  // cannot beat heap min
        } else if (n_distinct < kMaxDistinct) {
          distinct_p[n_distinct] = pi;
          thresh[n_distinct] = std::exp(-pi / m);
          n_distinct++;
          if (u <= thresh[n_distinct - 1]) continue;
        } else {
          cache_ok = false;  // too many distinct values; general path
        }
      }
      const double key = pi / (-std::log(u));
      if (key <= heap[0].key) continue;
      std::pop_heap(heap, heap + k, heap_less);
      heap[k - 1] = {key, i};
      std::push_heap(heap, heap + k, heap_less);
      m = heap[0].key;
      if (cache_ok) rebuild();
    } else {
      const double key = pi / (-std::log(u));
      heap[size++] = {key, i};
      if (size == k) {
        std::make_heap(heap, heap + k, heap_less);
        m = heap[0].key;
        rebuild();
      }
    }
  }
  std::sort_heap(heap, heap + size, heap_less);
  std::reverse(heap, heap + size);  // descending key
  for (int64_t i = 0; i < size; i++) out_idx[i] = heap[i].idx;
  for (int64_t i = size; i < k; i++) out_idx[i] = heap[size ? size - 1 : 0].idx;
  delete[] heap;
}

// Assemble a ray batch for k selected pixels:
//   rd[i] = R (3x3, row-major) @ dirs_cam[sel[i]]
//   ro[i] = t
//   target[i] = image[sel[i]] (first 3 of `channels`)
//   bg[i] = background[sel[i]] (optional, pass nullptr to skip)
void nerface_assemble_batch(const int64_t* sel, int64_t k,
                            const float* dirs_cam,  // (n, 3)
                            const float* image,     // (n, channels)
                            int64_t channels,
                            const float* background,  // (n, 3) or nullptr
                            const float* pose,        // (3, 4) row-major
                            float* ro, float* rd, float* target, float* bg) {
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], tx = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], ty = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], tz = pose[11];
  for (int64_t i = 0; i < k; i++) {
    const int64_t s = sel[i];
    const float dx = dirs_cam[3 * s], dy = dirs_cam[3 * s + 1],
                dz = dirs_cam[3 * s + 2];
    rd[3 * i] = r00 * dx + r01 * dy + r02 * dz;
    rd[3 * i + 1] = r10 * dx + r11 * dy + r12 * dz;
    rd[3 * i + 2] = r20 * dx + r21 * dy + r22 * dz;
    ro[3 * i] = tx;
    ro[3 * i + 1] = ty;
    ro[3 * i + 2] = tz;
    const float* px = image + channels * s;
    target[3 * i] = px[0];
    target[3 * i + 1] = px[1];
    target[3 * i + 2] = px[2];
    if (background != nullptr && bg != nullptr) {
      bg[3 * i] = background[3 * s];
      bg[3 * i + 1] = background[3 * s + 1];
      bg[3 * i + 2] = background[3 * s + 2];
    }
  }
}

}  // extern "C"
