// Per-relation segment softmax of given logits fused with the weighted
// aggregation of gathered source rows, for Hopper (sm_90a), plain C entry
// point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_fwd_kernel
// (launched by _fused_forward, via fused_segment_softmax_spmm): the GAT
// layer of one relation on the per-relation path (kgwas_tpu/models/convs.py
// apply_gat, taken for gnn_aggr max and min), fused with the source-row
// gather that the JAX package runs before it (gather_rows_csc's forward).
// Over one relation's dst-sorted CSR edge stream it computes, per row r:
//
//   m_r   = max over the row's edges of l_e          (NEG_BIG when empty)
//   p_e   = exp(min(l_e - m_r, 60))
//   out_r = sum_e p_e xs[src_e] / (sum_e p_e + 1e-16)
//
// with the logits l_e given (leaky_relu(a_src + a_dst) / T, formed outside,
// as the TPU kernel takes them), and saves row_max = m_r and row_sum =
// sum_e p_e per row ([n_rows], not the TPU's [n_tiles * 8, BN] tiling) for
// segment_softmax_spmm_bwd.cu. Empty rows give 0, NEG_BIG and 0.
//
// Design. One warp per row, as in merged_gat_fwd.cu. The row's edges load
// 32 at a time, one per lane (src and logit), with the next 32 prefetched;
// the warp takes the 32 logits' max by butterfly and rescales its running
// sum and accumulator once per 32 edges (the online softmax of the TPU
// kernel, which rescales once per edge window), then each lane's weight is
// broadcast by shuffle and the source rows are read U at a time (float4 per
// lane at D % 128 == 0) and summed in registers in edge order. The [E, D]
// message stream is never written. No atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], src and logits [E], row_offsets [n_rows + 1], out [n_rows,
// D], row_max and row_sum [n_rows]), against 2 D flops per edge. The
// gather reads each source row once per edge, mostly from L2. Each
// relation's trash row holds all of its pad edges (up to 511) and one warp
// walks them in sequence; with the logits given, the per-edge chain is a
// load and an FMA, with one max and one exp per lane per 32 edges.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kFull;
using kgwas::kMaxCols;

constexpr float kNegBig = -1e9f;
constexpr float kExpClamp = 60.0f;
constexpr float kEps = 1e-16f;
constexpr int kWarps = 8;  // warps per block

struct Args {
  const float* xs;         // [S, D]
  const int* src;          // [E]
  const float* logits;     // [E]
  const int* row_offsets;  // [n_rows + 1]
  float* out;              // [n_rows, D]
  float* row_max;          // [n_rows]
  float* row_sum;          // [n_rows]
  long long n_rows;
  int d;
};

template <bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_spmm_fwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = !VEC || NV > 2 ? 2 : 4;  // source rows in flight
  const int lane = threadIdx.x & 31;
  const long long o =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= a.n_rows) return;  // whole warp exits together

  const int beg = a.row_offsets[o];
  const int end = a.row_offsets[o + 1];
  float m = kNegBig;
  float ssum = 0.0f;
  R acc;
  acc.zero();
  int next_src = beg + lane < end ? a.src[beg + lane] : 0;
  float next_l = beg + lane < end ? a.logits[beg + lane] : kNegBig;
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const bool mine = base + lane < end;
    const int my_src = next_src;
    const float my_l = next_l;
    const bool more = base + 32 + lane < end;
    next_src = more ? a.src[base + 32 + lane] : 0;
    next_l = more ? a.logits[base + 32 + lane] : kNegBig;

    // the 32 logits' max, then one rescale of the running state
    float m_new = my_l;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m_new = fmaxf(m_new, __shfl_xor_sync(kFull, m_new, off));
    m_new = fmaxf(m, m_new);
    const float scale = fast_exp(fminf(m - m_new, 0.0f));
    ssum *= scale;
#pragma unroll
    for (int c = 0; c < R::C; ++c) acc.v[c] *= scale;
    m = m_new;
    const float my_p = mine ? fast_exp(fminf(my_l - m_new, kExpClamp)) : 0.0f;

    for (int j = 0; j < cnt; j += U) {
      // a step past the row's end re-reads its last edge's row, masked below
      R x[U];
      float pu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src_lane = min(j + u, cnt - 1);
        const int s = __shfl_sync(kFull, my_src, src_lane);
        pu[u] = __shfl_sync(kFull, my_p, src_lane);
        x[u].load(a.xs + static_cast<size_t>(s) * a.d, lane, a.d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < cnt) {  // warp-uniform
          ssum += pu[u];
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] = fmaf(pu[u], x[u].v[c], acc.v[c]);
        }
      }
    }
  }
  // division, not a multiply by the reciprocal: the same rounding as the
  // plain version's acc / (sum + eps)
#pragma unroll
  for (int c = 0; c < R::C; ++c) acc.v[c] = acc.v[c] / (ssum + kEps);
  acc.store(a.out + o * a.d, lane, a.d);
  if (lane == 0) {
    a.row_max[o] = m;
    a.row_sum[o] = ssum;
  }
}

template <bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  segment_softmax_spmm_fwd_kernel<VEC, NV>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; float4 rows need xs and out 16-byte aligned when D % 128 == 0
// (the wrapper checks).
extern "C" int kgwas_segment_softmax_spmm_fwd(
    const void* xs, const void* src, const void* logits,
    const void* row_offsets, void* out, void* row_max, void* row_sum,
    long long n_rows, int d, void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.src = static_cast<const int*>(src);
  a.logits = static_cast<const float*>(logits);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.out = static_cast<float*>(out);
  a.row_max = static_cast<float*>(row_max);
  a.row_sum = static_cast<float*>(row_sum);
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
