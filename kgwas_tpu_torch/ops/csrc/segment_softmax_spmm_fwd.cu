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
// An optional per-edge multiplier mult [E] (the dropout of the JAX
// package's apply_gat: keep_e / (1 - p), drawn outside) weights each edge's
// message after the softmax: out_r = sum_e p_e mult_e xs[src_e] /
// (sum_e p_e + 1e-16), with m_r and the row sum unchanged. It is a
// compile-time flag (MULT): a launch without it runs the kernel as it was.
//
// Design. A static schedule (gat_items.cuh, ops/schedule.py; built once per
// relation stream and kept on its DeviceLayout) gives each warp one item:
// up to 32 consecutive rows with at most max_edges edges together, or one
// chunk of a longer row (a relation's trash row with up to 511 pad edges, a
// hub). The warp stages the item's source indices and logits in shared
// memory (their loads issued four 32-edge batches at a time), puts its
// first source rows in flight, takes each row's max over its logits (a
// segmented max across the lanes) and turns every logit into its weight
// p_e once, and then gathers the source rows into registers, two batches
// of 4 at D = 128 in flight, one summed while the other arrives: with the
// weights known the per-edge chain is one FMA per column, and the row sum
// one add. Shared memory is a few KB a warp, so 8-warp blocks keep many
// warps on each SM, and their staging overlaps the others' gathers. A
// chunk writes its partial (m, s, acc) to scratch and a second, small
// launch merges each chunked row's parts in part order by log-sum-exp
// (gat_items.cuh merge_parts) and writes it. A relation's trash row sums
// identical pad terms (all read source row 0, from L1): cut into chunks,
// it rounds otherwise than the plain version's sequential sum, within the
// trash rows' rtol 1e-4 (no fold adds it to another row here). Warps take
// items from the last: the trash row's chunks start first. No atomics: two
// runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], src and logits [E], row_offsets [n_rows + 1], out [n_rows,
// D], row_max and row_sum [n_rows]), against 2 D flops per edge. The
// gather reads each source row once per edge (512 bytes at D = 128), from
// the 50 MB L2 when the table fits, else from device memory: that gather's
// rate, measured alone by gather_probe.cu, is the floor the design aims at.
//
// The bf16 instance (kgwas_segment_softmax_spmm_fwd_bf16: xs bf16, logits
// float32 or bf16, mult float32), compile-time flags BF and LB: the
// float32 instance's arithmetic on bf16 operands, as the TPU kernel keeps
// the softmax state and the output float32 (pallas_segment.py's out_shapes
// and scratch). Each message row is read as bf16 and widened (exact), each
// bf16 logit widened; the row max and sum, p_e, the products, the sums and
// the division are float32, and out, row_max and row_sum are written in
// float32. So the instance on (xs, logits) gives the float32 instance's
// bits on (xs.float(), logits.float()) under the same schedule. Rows are
// read at 8 bytes a lane at D = 128 (4 values), else a value a lane per 32
// columns; the chunk combine is the float32 one. Its bound: xs read at 2
// bytes a value, the gather half the float32 instance's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kEps;
using kgwas::kExpClamp;
using kgwas::kFull;
using kgwas::kBwdMaxEdges;
using kgwas::kItemMaxRows;
using kgwas::kMaxCols;
using kgwas::kNegBig;

constexpr int kWarps = 8;   // warps per block

struct Args {
  const float* xs;          // [S, D]
  const int* src;           // [E]
  const float* logits;      // [E]
  const float* mult;        // [E], or null (MULT = false)
  const int* row_offsets;   // [n_rows + 1]
  float* out;               // [n_rows, D]
  float* row_max;           // [n_rows]
  float* row_sum;           // [n_rows]
  const int4* items;        // [n_items]
  const int* split_units;   // [n_split]
  const int* part_offsets;  // [n_split + 1]
  float* part_m;            // [n_parts]
  float* part_s;            // [n_parts]
  float* part_acc;          // [n_parts, D]
  long long n_items;
  long long n_split;
  long long n_rows;
  int d;
  const __nv_bfloat16* xsb;      // [S, D]: the bf16 instance's table
  const __nv_bfloat16* logitsb;  // [E]: its bf16 logits (LB)
};

// the table of the float32 (BF false) or the bf16 instance
template <bool BF>
__device__ __forceinline__ auto xs_table(const Args& a) {
  if constexpr (BF)
    return a.xsb;
  else
    return a.xs;
}

// logit i, widened from bf16 when LB
template <bool LB>
__device__ __forceinline__ float logit(const Args& a, int i) {
  if constexpr (LB)
    return __bfloat162float(a.logitsb[i]);
  else
    return a.logits[i];
}

template <bool VEC, int NV, bool MULT, bool BF = false, bool LB = false>
__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_spmm_fwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  __shared__ int s_src_w[kWarps][kBwdMaxEdges];
  __shared__ float s_p_w[kWarps][kBwdMaxEdges];  // logits, then weights
  __shared__ unsigned char s_k_w[kWarps][kBwdMaxEdges];
  __shared__ float s_m_w[kWarps][kItemMaxRows];  // each row's max
  __shared__ float s_mult_w[kWarps][MULT ? kBwdMaxEdges : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(w, a.n_items);
  int* s_src = s_src_w[warp];
  float* s_p = s_p_w[warp];
  unsigned char* s_k = s_k_w[warp];
  float* s_m = s_m_w[warp];
  float* s_mult = s_mult_w[warp];
  const int d = a.d;

  const kgwas::ItemRows it =
      kgwas::item_rows(a.items[item], a.row_offsets, a.n_rows, 1, lane);
  // a packed item's rows without edges: the plain version's NEG_BIG and 0
  if (!it.chunk && lane < it.n_rows && it.cnt == 0) {
    a.row_max[it.row] = kNegBig;
    a.row_sum[it.row] = 0.0f;
  }
  if (lane < it.n_rows) s_m[lane] = kNegBig;
  // each virtual edge's row, then its source row and logit (and
  // multiplier; the item's edges follow each other in the stream)
  const int first = kgwas::stage_row_keys(it, s_k, lane);
  for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
    int src[4] = {0, 0, 0, 0};
    float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float mu[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        src[q] = a.src[first + v];
        l[q] = logit<LB>(a, first + v);
        if (MULT) mu[q] = a.mult[first + v];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        s_src[v] = src[q];
        s_p[v] = l[q];
        if (MULT) s_mult[v] = mu[q];
      }
    }
  }
  __syncwarp();
  // the first rows in flight while each row's max, then each edge's weight
  // are formed
  R xa[U], xb[U];
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, xs_table<BF>(a), s_src, 0, it.total,
                                   lane, d);
  for (int base = 0; base < it.total; base += 32) {
    const int v = base + lane;
    const bool ok = v < it.total;
    kgwas::segmented_max(ok ? s_p[v] : kNegBig, ok ? s_k[v] : 255, s_m, lane);
  }
  for (int v = lane; v < it.total; v += 32)
    s_p[v] = fast_exp(fminf(s_p[v] - s_m[s_k[v]], kExpClamp));
  __syncwarp();

  int cur = -1;  // the row being summed
  float s = 0.0f;
  R acc;
  acc.zero();
  auto finish_row = [&](int k) {
    const float m = s_m[k];
    if (it.chunk) {
      if (lane == 0) {
        a.part_m[it.part] = m;
        a.part_s[it.part] = s;
      }
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      return;
    }
    const long long row = it.unit0 + k;
    if (lane == 0) {
      a.row_max[row] = m;
      a.row_sum[row] = s;
    }
    // division, not a multiply by the reciprocal: the same rounding as the
    // plain version's acc / (sum + eps)
#pragma unroll
    for (int c = 0; c < R::C; ++c) acc.v[c] = acc.v[c] / (s + kEps);
    acc.store(a.out + row * d, lane, d);
  };

  // sums batch x of U rows, edges v..v+U-1
  auto take = [&](const R (&x)[U], int v) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vu = v + u;
      if (vu < it.total) {  // warp-uniform
        const int k = s_k[vu];
        if (k != cur) {
          if (cur >= 0) finish_row(cur);
          cur = k;
          s = 0.0f;
          acc.zero();
        }
        const float p = s_p[vu];
        s += p;
        const float pm = MULT ? p * s_mult[vu] : p;
#pragma unroll
        for (int c = 0; c < R::C; ++c)
          acc.v[c] = fmaf(pm, x[u].v[c], acc.v[c]);
      }
    }
  };
  // two batches in flight: one is summed while the other arrives
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, xs_table<BF>(a), s_src, v + U,
                                     it.total, lane, d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, xs_table<BF>(a), s_src, v + 2 * U,
                                     it.total, lane, d);
    if (v + U < it.total) take(xb, v + U);
  }
  if (cur >= 0) finish_row(cur);
  if (!it.chunk) {  // the item's rows without edges: zeros
    unsigned empty = __ballot_sync(kFull, lane < it.n_rows && it.cnt == 0);
    R zero;
    zero.zero();
    for (; empty; empty &= empty - 1)
      zero.store(a.out + (it.unit0 + __ffs(empty) - 1) * d, lane, d);
  }
}

// One warp per row cut into chunks: its parts merged in part order, then
// the division.
template <bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_combine_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= a.n_split) return;
  const long long row = a.split_units[j];
  float mx, sum;
  R acc;
  kgwas::merge_parts<VEC, NV, true>(a.part_m, a.part_s, a.part_acc,
                                    a.part_offsets[j], a.part_offsets[j + 1],
                                    lane, a.d, mx, sum, acc);
#pragma unroll
  for (int c = 0; c < R::C; ++c) acc.v[c] = acc.v[c] / (sum + kEps);
  acc.store(a.out + row * a.d, lane, a.d);
  if (lane == 0) {
    a.row_max[row] = mx;
    a.row_sum[row] = sum;
  }
}

template <bool VEC, int NV, bool MULT, bool BF, bool LB>
cudaError_t launch_items(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    segment_softmax_spmm_fwd_kernel<VEC, NV, MULT, BF, LB>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (cblocks > 0) {
    segment_softmax_combine_kernel<VEC, NV>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <bool VEC, int NV, bool BF = false, bool LB = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.mult != nullptr ? launch_items<VEC, NV, true, BF, LB>(a, stream)
                           : launch_items<VEC, NV, false, BF, LB>(a, stream);
}

// the bf16 instance's widths: 8-byte row loads at D = 128, else generic
template <bool LB>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if (a.d == 128) return launch<true, 1, true, LB>(a, stream);
  if (a.d >= 1 && a.d <= 32 * kMaxCols)
    return launch<false, 1, true, LB>(a, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* xs, const void* src, const void* logits,
               const void* mult, const void* row_offsets, void* out,
               void* row_max, void* row_sum, const void* items,
               long long n_items, const void* split_units,
               const void* part_offsets, long long n_split, void* part_m,
               void* part_s, void* part_acc, long long n_rows, int d) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.src = static_cast<const int*>(src);
  a.logits = static_cast<const float*>(logits);
  a.mult = static_cast<const float*>(mult);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.out = static_cast<float*>(out);
  a.row_max = static_cast<float*>(row_max);
  a.row_sum = static_cast<float*>(row_sum);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_acc = static_cast<float*>(part_acc);
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_rows = n_rows;
  a.d = d;
  a.xsb = nullptr;
  a.logitsb = nullptr;
  return a;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; xs, out, part_acc and items must be 16-byte aligned (the
// wrapper checks); mult may be null (every multiplier 1). The schedule
// (items, split_units, part_offsets) and the scratch part_* come from the
// wrapper; two launches: the items, then the combine of the chunked rows.
extern "C" int kgwas_segment_softmax_spmm_fwd(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, void* out, void* row_max, void* row_sum,
    const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_m, void* part_s,
    void* part_acc, long long n_rows, int d, void* stream) {
  const Args a = make_args(xs, src, logits, mult, row_offsets, out, row_max,
                           row_sum, items, n_items, split_units, part_offsets,
                           n_split, part_m, part_s, part_acc, n_rows, d);
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

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (8-byte
// aligned rows at D = 128; the wrapper checks), logits bf16 when
// logits_bf16 != 0, else float32; every output float32.
extern "C" int kgwas_segment_softmax_spmm_fwd_bf16(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, void* out, void* row_max, void* row_sum,
    const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_m, void* part_s,
    void* part_acc, long long n_rows, int d, int logits_bf16, void* stream) {
  Args a = make_args(nullptr, src, logits_bf16 ? nullptr : logits, mult,
                     row_offsets, out, row_max, row_sum, items, n_items,
                     split_units, part_offsets, n_split, part_m, part_s,
                     part_acc, n_rows, d);
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.logitsb =
      logits_bf16 ? static_cast<const __nv_bfloat16*>(logits) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logits_bf16 ? launch_bf16<true>(a, s) : launch_bf16<false>(a, s);
}
