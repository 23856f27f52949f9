// shardops: the shard compiler's host loops in plain C++ with a C interface
// (loaded with ctypes by native/shardops.py; no CPython or numpy headers).
//
//   kgwas_stable_order_{i32,i64}  stable counting-sort order of int keys in
//                                 [0, n_keys): np.argsort(kind="stable")
//   kgwas_csr_offsets_{i32,i64}   CSR offsets [n_rows + 1] of keys in
//                                 [0, n_rows): bincount, then cumsum
//   kgwas_coalesce                the first edge of each distinct
//                                 (src, dst) in ascending src * num_dst + dst
//
// All three are O(E + N): two passes over the keys and one over the key
// range. Each takes its arrays as raw pointers and returns 0, or -1 - i
// where key i lies outside its range (kgwas_coalesce: the kept count).
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

template <typename K>
int64_t stable_order(const K* keys, int64_t n, int64_t n_keys,
                     int64_t* order) {
  std::vector<int64_t> start(static_cast<size_t>(n_keys) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = static_cast<int64_t>(keys[i]);
    if (k < 0 || k >= n_keys) return -1 - i;
    ++start[static_cast<size_t>(k) + 1];
  }
  for (int64_t k = 0; k < n_keys; ++k) start[k + 1] += start[k];
  for (int64_t i = 0; i < n; ++i) order[start[keys[i]]++] = i;
  return 0;
}

template <typename K>
int64_t csr_offsets(const K* keys, int64_t n, int64_t n_rows,
                    int64_t* offsets) {
  std::fill(offsets, offsets + n_rows + 1, int64_t{0});
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = static_cast<int64_t>(keys[i]);
    if (k < 0 || k >= n_rows) return -1 - i;
    ++offsets[k + 1];
  }
  for (int64_t r = 0; r < n_rows; ++r) offsets[r + 1] += offsets[r];
  return 0;
}

}  // namespace

extern "C" {

int64_t kgwas_stable_order_i32(const int32_t* keys, int64_t n,
                               int64_t n_keys, int64_t* order) {
  return stable_order(keys, n, n_keys, order);
}

int64_t kgwas_stable_order_i64(const int64_t* keys, int64_t n,
                               int64_t n_keys, int64_t* order) {
  return stable_order(keys, n, n_keys, order);
}

int64_t kgwas_csr_offsets_i32(const int32_t* keys, int64_t n, int64_t n_rows,
                              int64_t* offsets) {
  return csr_offsets(keys, n, n_rows, offsets);
}

int64_t kgwas_csr_offsets_i64(const int64_t* keys, int64_t n, int64_t n_rows,
                              int64_t* offsets) {
  return csr_offsets(keys, n, n_rows, offsets);
}

// keep [n] receives the kept edges' positions in ascending (src, dst), each
// pair's earliest position, as a stable sort by src * num_dst + dst followed
// by a first-of-run pass gives them: two stable counting sorts (by dst, then
// by src), O(E + num_src + num_dst). Returns the kept count, or -1 - i where
// edge i's src or dst lies outside its range
int64_t kgwas_coalesce(const int64_t* src, const int64_t* dst, int64_t n,
                       int64_t num_src, int64_t num_dst, int64_t* keep) {
  std::vector<int64_t> by_dst(static_cast<size_t>(n));
  const int64_t rc = stable_order(dst, n, num_dst, by_dst.data());
  if (rc < 0) return rc;
  std::vector<int64_t> start(static_cast<size_t>(num_src) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (src[i] < 0 || src[i] >= num_src) return -1 - i;
    ++start[static_cast<size_t>(src[i]) + 1];
  }
  for (int64_t k = 0; k < num_src; ++k) start[k + 1] += start[k];
  std::vector<int64_t> order(static_cast<size_t>(n));
  for (int64_t j = 0; j < n; ++j) {
    const int64_t i = by_dst[j];
    order[start[src[i]]++] = i;
  }
  int64_t kept = 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t i = order[j];
    if (j == 0 || src[i] != src[order[j - 1]] || dst[i] != dst[order[j - 1]])
      keep[kept++] = i;
  }
  return kept;
}

}  // extern "C"
