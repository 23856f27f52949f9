// Backward of segment_softmax_spmm_fwd.cu, edge half, for Hopper (sm_90a),
// plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_bwd_kernel
// (launched by _fused_backward, the VJP of fused_segment_softmax_spmm). With
// g the cotangent of the forward's output and the forward's saved out,
// row_max and row_sum, per edge e of row r:
//
//   p_e       = exp(min(l_e - lse_r, 60)),  lse_r = row_max_r + log(row_sum_r + 1e-16)
//   dot_r     = out_r . g_r                  (from the saved output, as the TPU)
//   d_logit_e = p_e (xs[src_e] . g_r - dot_r)
//
// and writes two scalars per edge, w_e = p_e and d_logit_e. The TPU kernel
// also writes the [E, D] message cotangent d_msgs_e = p_e g_r; this kernel
// does not: csc_segment_sum.cu (without logit term) forms p_e g_r in
// registers while it walks the relation's CSC and sums d_xs per source row.
//
// Design. One warp per row, as in the forward: g_r and out_r are loaded
// once (float4 per lane at D % 128 == 0) and dot_r reduced by butterfly.
// The row's edges load 32 at a time, one per lane (src and logit), with the
// next 32 prefetched; source rows are read U at a time, their U dot products
// with g_r reduce in one interleaved butterfly, and the lane whose index is
// the edge's position in its group of 32 keeps the product; then every lane
// finishes and stores its own edge. Every sum is taken in a fixed order with
// no atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], out and g [n_rows, D], src and logits [E], row_offsets,
// row_max and row_sum [n_rows], w and d_logits [E]), against 2 D flops per
// edge and per row. The gather reads each source row once per edge, mostly
// from L2. A relation's trash row holds all of its pad edges (up to 511):
// one warp walks them, each edge a load, a dot product and a 5-step
// butterfly (shared by U edges).

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kFull;
using kgwas::kMaxCols;

constexpr float kExpClamp = 60.0f;
constexpr float kEps = 1e-16f;
constexpr int kWarps = 8;  // warps per block

struct Args {
  const float* xs;         // [S, D]
  const int* src;          // [E]
  const float* logits;     // [E]
  const int* row_offsets;  // [n_rows + 1]
  const float* row_max;    // [n_rows]
  const float* row_sum;    // [n_rows]
  const float* out;        // [n_rows, D]
  const float* g;          // [n_rows, D]
  float* w;                // [E]
  float* d_logits;         // [E]
  long long n_rows;
  int d;
};

template <bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_spmm_bwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = !VEC || NV > 2 ? 2 : 4;  // source rows in flight
  const int lane = threadIdx.x & 31;
  const long long o =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= a.n_rows) return;  // whole warp exits together

  const int beg = a.row_offsets[o];
  const int end = a.row_offsets[o + 1];
  if (beg >= end) return;  // an empty row has no edge to write
  R gr, ov;
  gr.load(a.g + o * a.d, lane, a.d);
  ov.load(a.out + o * a.d, lane, a.d);
  float dot = 0.0f;
#pragma unroll
  for (int c = 0; c < R::C; ++c) dot = fmaf(ov.v[c], gr.v[c], dot);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
  const float lse = a.row_max[o] + logf(a.row_sum[o] + kEps);

  int next_src = beg + lane < end ? a.src[beg + lane] : 0;
  float next_l = beg + lane < end ? a.logits[beg + lane] : 0.0f;
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_src = next_src;
    const float my_l = next_l;
    const bool more = base + 32 + lane < end;
    next_src = more ? a.src[base + 32 + lane] : 0;
    next_l = more ? a.logits[base + 32 + lane] : 0.0f;
    float my_m = 0.0f;  // xs[src_e] . g_r of this lane's edge
    for (int j = 0; j < cnt; j += U) {
      // a step past the row's end re-reads its last edge's row; no lane
      // keeps its product
      R x[U];
      float pm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = __shfl_sync(kFull, my_src, min(j + u, cnt - 1));
        x[u].load(a.xs + static_cast<size_t>(s) * a.d, lane, a.d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float q = 0.0f;
#pragma unroll
        for (int c = 0; c < R::C; ++c) q = fmaf(x[u].v[c], gr.v[c], q);
        pm[u] = q;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) pm[u] += __shfl_xor_sync(kFull, pm[u], off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lane == j + u) my_m = pm[u];
    }
    if (lane < cnt) {
      const float p = fast_exp(fminf(my_l - lse, kExpClamp));
      a.w[base + lane] = p;
      a.d_logits[base + lane] = p * (my_m - dot);
    }
  }
}

template <bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  segment_softmax_spmm_bwd_kernel<VEC, NV>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; float4 rows need xs, out and g 16-byte aligned when D % 128 ==
// 0 (the wrapper checks).
extern "C" int kgwas_segment_softmax_spmm_bwd(
    const void* xs, const void* src, const void* logits,
    const void* row_offsets, const void* row_max, const void* row_sum,
    const void* out, const void* g, void* w, void* d_logits, long long n_rows,
    int d, void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.src = static_cast<const int*>(src);
  a.logits = static_cast<const float*>(logits);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.row_max = static_cast<const float*>(row_max);
  a.row_sum = static_cast<const float*>(row_sum);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.w = static_cast<float*>(w);
  a.d_logits = static_cast<float*>(d_logits);
  a.n_rows = n_rows;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return launch<true, 1>(a, s);
    case 256: return launch<true, 2>(a, s);
    case 384: return launch<true, 3>(a, s);
    case 512: return launch<true, 4>(a, s);
    default:
      if (d >= 1 && d <= 32 * kMaxCols) return launch<false, 1>(a, s);
      return cudaErrorInvalidValue;
  }
}
