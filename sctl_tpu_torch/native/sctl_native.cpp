// Native host runtime for sctl_tpu_torch (a copy of the JAX package's
// sctl_tpu/native/sctl_native.cpp).
//
// The reference's shared-memory substrate (include/sctl/ompUtils.hpp,
// omp_par::merge_sort, and the morton.hpp/.txx bit manipulation): tree
// construction is host work on 1e7+ points, where numpy's
// single-threaded argsort leads the setup.  This library provides:
//
//   morton_encode_3d / _2d : OpenMP-parallel Morton key computation
//   sort_keys_u64          : parallel LSD radix sort of uint64 keys
//                            returning the permutation (4 passes of
//                            16 bits, per-thread histograms)
//   sort_small_keys        : radix sort of keys below 2^24 carrying
//                            their indices (the uniform tree's box ids)
//   box_counts             : per-box counts from sorted keys
//
// Exposed through a plain C ABI for ctypes.
//
// Build: sctl_tpu_torch/native/__init__.py, at first use
// (g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

static inline uint64_t spread3(uint64_t x) {
  x &= 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFULL;
  x = (x | (x << 16)) & 0x1F0000FF0000FFULL;
  x = (x | (x << 8))  & 0x100F00F00F00F00FULL;
  x = (x | (x << 4))  & 0x10C30C30C30C30C3ULL;
  x = (x | (x << 2))  & 0x1249249249249249ULL;
  return x;
}

static inline uint64_t spread2(uint64_t x) {
  x &= 0xFFFFFFFF;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8))  & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4))  & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2))  & 0x3333333333333333ULL;
  x = (x | (x << 1))  & 0x5555555555555555ULL;
  return x;
}

// coords: (n,3) in [0,1); depth = bits per dimension (<=20)
void morton_encode_3d(const double* coords, int64_t n, int depth,
                      uint64_t* out) {
  const double scale = (double)(1ULL << depth);
  const int64_t maxq = (1LL << depth) - 1;
  const int shift = 3 * (20 - depth);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    uint64_t q[3];
    for (int d = 0; d < 3; d++) {
      double v = coords[3 * i + d] * scale;
      int64_t iv = (int64_t)v;
      iv = iv < 0 ? 0 : (iv > maxq ? maxq : iv);
      q[d] = (uint64_t)iv;
    }
    out[i] = (spread3(q[0]) | (spread3(q[1]) << 1)
              | (spread3(q[2]) << 2)) << shift;
  }
}

void morton_encode_2d(const double* coords, int64_t n, int depth,
                      uint64_t* out) {
  const double scale = (double)(1ULL << depth);
  const int64_t maxq = (1LL << depth) - 1;
  const int shift = 2 * (31 - depth);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    uint64_t q[2];
    for (int d = 0; d < 2; d++) {
      double v = coords[2 * i + d] * scale;
      int64_t iv = (int64_t)v;
      iv = iv < 0 ? 0 : (iv > maxq ? maxq : iv);
      q[d] = (uint64_t)iv;
    }
    out[i] = (spread2(q[0]) | (spread2(q[1]) << 1)) << shift;
  }
}

// Parallel LSD radix sort; fills perm with the sorting permutation and
// sorts keys in place.  keys_tmp/perm_tmp are n-sized scratch.
void sort_keys_u64(uint64_t* keys, int64_t* perm, int64_t n) {
  const int R = 16;             // bits per pass (4 passes over 64 bits)
  const int BUCKETS = 1 << R;
  int nt = omp_get_max_threads();
  std::vector<uint64_t> keys_tmp(n);
  std::vector<int64_t> perm_tmp(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) perm[i] = i;

  std::vector<int64_t> hist((size_t)nt * BUCKETS);
  uint64_t* src_k = keys;   int64_t* src_p = perm;
  uint64_t* dst_k = keys_tmp.data(); int64_t* dst_p = perm_tmp.data();

  for (int pass = 0; pass < 4; pass++) {
    const int sh = pass * R;
    std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel
    {
      int t = omp_get_thread_num();
      int64_t* h = &hist[(size_t)t * BUCKETS];
#pragma omp for schedule(static)
      for (int64_t i = 0; i < n; i++)
        h[(src_k[i] >> sh) & (BUCKETS - 1)]++;
    }
    // exclusive prefix over (bucket, thread)
    int64_t sum = 0;
    for (int b = 0; b < BUCKETS; b++)
      for (int t = 0; t < nt; t++) {
        int64_t c = hist[(size_t)t * BUCKETS + b];
        hist[(size_t)t * BUCKETS + b] = sum;
        sum += c;
      }
#pragma omp parallel
    {
      int t = omp_get_thread_num();
      int64_t* h = &hist[(size_t)t * BUCKETS];
#pragma omp for schedule(static)
      for (int64_t i = 0; i < n; i++) {
        int b = (src_k[i] >> sh) & (BUCKETS - 1);
        int64_t pos = h[b]++;
        dst_k[pos] = src_k[i];
        dst_p[pos] = src_p[i];
      }
    }
    std::swap(src_k, dst_k);
    std::swap(src_p, dst_p);
  }
  // even pass count -> result already back in keys/perm
  if (src_k != keys) {
    std::memcpy(keys, src_k, sizeof(uint64_t) * n);
    std::memcpy(perm, src_p, sizeof(int64_t) * n);
  }
}

// Sort small keys (< 2^24) carrying their index: packs key<<40|idx
// into one uint64 and radix-sorts the top 3 bytes — one 8-byte stream
// per pass instead of two 8-byte streams, and only ceil(bits/8)
// passes.  This is the tree-construction path (box ids at depth<=8).
void sort_small_keys(const int64_t* keys, int64_t n, int key_bits,
                     int64_t* perm_out, int64_t* sorted_out) {
  const int R = 8, BUCKETS = 1 << R;
  std::vector<uint64_t> a(n), b(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++)
    a[i] = ((uint64_t)keys[i] << 40) | (uint64_t)i;
  int passes = (key_bits + R - 1) / R;
  uint64_t* src = a.data();
  uint64_t* dst = b.data();
  std::vector<int64_t> hist(BUCKETS);
  for (int pass = 0; pass < passes; pass++) {
    const int sh = 40 + pass * R;
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i = 0; i < n; i++) hist[(src[i] >> sh) & (BUCKETS - 1)]++;
    int64_t sum = 0;
    for (int bkt = 0; bkt < BUCKETS; bkt++) {
      int64_t c = hist[bkt]; hist[bkt] = sum; sum += c;
    }
    for (int64_t i = 0; i < n; i++)
      dst[hist[(src[i] >> sh) & (BUCKETS - 1)]++] = src[i];
    std::swap(src, dst);
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    perm_out[i] = (int64_t)(src[i] & 0xFFFFFFFFFFULL);
    sorted_out[i] = (int64_t)(src[i] >> 40);
  }
}

// counts[b] = #sorted_box_ids == b, for b in [0, n_boxes)
void box_counts(const int64_t* sorted_box_ids, int64_t n,
                int64_t n_boxes, int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * n_boxes);
#pragma omp parallel
  {
    std::vector<int64_t> local(n_boxes, 0);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; i++) {
      int64_t b = sorted_box_ids[i];
      if (b >= 0 && b < n_boxes) local[b]++;
    }
#pragma omp critical
    for (int64_t b = 0; b < n_boxes; b++) counts[b] += local[b];
  }
}

}  // extern "C"
