// Destination-sorted segment sum with the source-row gather fused in, for
// Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_segsum_kernel as
// _pallas_segment_sum_ts launches it for segment_sum_edges: the forward of
// the merged message-passing layer of the SAGE, GCN and SGC backbones
// (kgwas_tpu/models/hetero_gnn.py apply_merged_mp_layer). There the [E, D]
// message stream is gathered (gather_rows_csc), scaled by the per-edge norm
// and written, and the kernel sums it per destination row by one-hot
// products on the matrix unit. Here nothing [E, D] is written: per row r of
// a dst-sorted CSR
//
//   out[r] = sum_{e in [row_offsets[r], row_offsets[r+1])} w_e x[src_e]
//
// with w the GCN/SGC symmetric norm, or no weight (the SAGE sum, which the
// caller scales by 1/deg afterwards).
//
// Design: segment_softmax_spmm_fwd.cu's without the softmax. A static
// schedule of the merged layout's R*N rows (gat_items.cuh, ops/schedule.py
// row_schedule, built once and kept on the layout's DeviceLayout) gives each
// warp one item: up to 32 consecutive rows with at most max_edges edges
// together, or one chunk of a longer row (each relation's trash row with up
// to 511 pad edges, a hub). The warp stages the item's source indices (and
// weights, WEIGHTED a compile-time flag) in shared memory, their loads
// issued four 32-edge batches at a time, then gathers the source rows into
// registers, two batches of 4 at D = 128 in flight, one summed while the
// other arrives: the per-edge chain is one FMA (or add) per column, each
// row's edges in stream order, as the earlier one-warp-per-row kernel took
// them (the same bits on every row that is not cut). Rows without edges are
// written as 0. A chunk writes its partial sum to scratch, and a second,
// small launch adds each chunked row's parts in part order (gat_items.cuh
// merge_parts) and writes it. Warps take items from the last: the trash
// rows' chunks start first. No atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (x [S, D], src and w [E], row_offsets [n_rows + 1], out [n_rows, D]),
// against 2 D flops per edge: far below the card's float32 rate. The gather
// reads each source row once per edge (512 bytes at D = 128), from the 50 MB
// L2 when the table fits (the SNP group's, 21 MB at the 200k-SNP bench
// size), else from device memory (the Gene group's, 234 MB): gather_probe.cu
// measures that gather alone on the same index stream, the floor the design
// aims at.
//
// The bf16 instance (kgwas_csr_segment_sum_bf16: x bf16, out float32), a
// compile-time flag BF: the same sums of bf16 rows read at 8 bytes a lane
// (D = 128), the JAX package's one-hot products on bf16 values summed in
// float32. With round_products (a bf16 w, which the wrapper passes as its
// exact float32 copy) each product w_e x[src_e] is rounded to bf16 before
// it is added, as the JAX package forms msgs * w in bf16 there; else an f32
// w multiplies in float32. Its bound: the f32 one's with 2-byte rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::kBwdMaxEdges;
using kgwas::kFull;
using kgwas::kMaxCols;

constexpr int kWarps = 8;  // warps per block

struct Args {
  const float* x;           // [S, D]
  const int* src;           // [E]
  const int* row_offsets;   // [n_rows + 1]
  const float* w;           // [E] or null
  float* out;               // [n_rows, D]
  const int4* items;        // [n_items]
  const int* split_units;   // [n_split]
  const int* part_offsets;  // [n_split + 1]
  float* part_acc;          // [n_parts, D]
  long long n_items;
  long long n_split;
  long long n_rows;
  int d;
  const __nv_bfloat16* xb;  // [S, D]: the bf16 instance's table
};

template <bool BF>
__device__ __forceinline__ auto x_table(const Args& a) {
  if constexpr (BF)
    return a.xb;
  else
    return a.x;
}

template <bool VEC, int NV, bool WEIGHTED, bool BF = false,
          bool ROUND = false>
__global__ void __launch_bounds__(kWarps * 32)
csr_segment_sum_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  __shared__ int s_src_w[kWarps][kBwdMaxEdges];
  __shared__ float s_w_w[kWarps][WEIGHTED ? kBwdMaxEdges : 1];
  __shared__ unsigned char s_k_w[kWarps][kBwdMaxEdges];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(wi, a.n_items);
  int* s_src = s_src_w[warp];
  float* s_w = s_w_w[warp];
  unsigned char* s_k = s_k_w[warp];
  const int d = a.d;

  const kgwas::ItemRows it =
      kgwas::item_rows(a.items[item], a.row_offsets, a.n_rows, 1, lane);
  // each virtual edge's row, then its source row and weight (the item's
  // edges follow each other in the stream)
  const int first = kgwas::stage_row_keys(it, s_k, lane);
  for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
    int src[4] = {0, 0, 0, 0};
    float wv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        src[q] = a.src[first + v];
        if (WEIGHTED) wv[q] = a.w[first + v];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        s_src[v] = src[q];
        if (WEIGHTED) s_w[v] = wv[q];
      }
    }
  }
  __syncwarp();

  int cur = -1;  // the row being summed
  R acc;
  acc.zero();
  auto finish_row = [&](int k) {
    if (it.chunk)
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
    else
      acc.store(a.out + (it.unit0 + k) * d, lane, d);
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
          acc.zero();
        }
        const float wu = WEIGHTED ? s_w[vu] : 1.0f;
        if (ROUND) {
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] += kgwas::round_bf16(__fmul_rn(wu, x[u].v[c]));
        } else {
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] = WEIGHTED ? fmaf(wu, x[u].v[c], acc.v[c])
                                : acc.v[c] + x[u].v[c];
        }
      }
    }
  };
  // two batches in flight: one is summed while the other arrives
  R xa[U], xb[U];
  const auto x_tab = x_table<BF>(a);
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, x_tab, s_src, 0, it.total, lane, d);
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, x_tab, s_src, v + U, it.total, lane,
                                     d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, x_tab, s_src, v + 2 * U, it.total,
                                     lane, d);
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

// One warp per row cut into chunks: its parts added in part order.
template <bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
csr_combine_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= a.n_split) return;
  float mx, sum;
  R acc;
  kgwas::merge_parts<VEC, NV, false>(nullptr, nullptr, a.part_acc,
                                     a.part_offsets[j], a.part_offsets[j + 1],
                                     lane, a.d, mx, sum, acc);
  acc.store(a.out + static_cast<long long>(a.split_units[j]) * a.d, lane,
            a.d);
}

template <bool VEC, int NV, bool WEIGHTED, bool BF = false,
          bool ROUND = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    csr_segment_sum_kernel<VEC, NV, WEIGHTED, BF, ROUND>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (cblocks > 0) {
    csr_combine_kernel<VEC, NV>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <bool WEIGHTED, bool BF = false, bool ROUND = false>
cudaError_t dispatch_width(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch<true, 1, WEIGHTED, BF, ROUND>(a, stream);
    case 256: return launch<true, 2, WEIGHTED, BF, ROUND>(a, stream);
    case 384: return launch<true, 3, WEIGHTED, BF, ROUND>(a, stream);
    case 512: return launch<true, 4, WEIGHTED, BF, ROUND>(a, stream);
    default:
      if (a.d >= 1 && a.d <= 32 * kMaxCols)
        return launch<false, 1, WEIGHTED, BF, ROUND>(a, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; x, out, part_acc and items must be 16-byte aligned (the wrapper
// checks). w may be null: every weight 1. The schedule (items, split_units,
// part_offsets) and the scratch part_acc come from the wrapper; two
// launches: the items, then the combine of the chunked rows.
extern "C" int kgwas_csr_segment_sum(
    const void* x, const void* src, const void* row_offsets, const void* w,
    void* out, const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_acc,
    long long n_rows, int d, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.xb = nullptr;
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_acc = static_cast<float*>(part_acc);
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_rows = n_rows;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s);
}

// The bf16 instance: the same arguments, x a bf16 [S, D] table (8-byte
// aligned rows at D = 128 * NV; the wrapper checks); round_products != 0
// (with w) rounds each product w_e x[src_e] to bf16.
extern "C" int kgwas_csr_segment_sum_bf16(
    const void* x, const void* src, const void* row_offsets, const void* w,
    void* out, const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_acc,
    long long n_rows, int d, int round_products, void* stream) {
  Args a;
  a.x = nullptr;
  a.xb = static_cast<const __nv_bfloat16*>(x);
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_acc = static_cast<float*>(part_acc);
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_rows = n_rows;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == nullptr) return dispatch_width<false, true, false>(a, s);
  return round_products ? dispatch_width<true, true, true>(a, s)
                        : dispatch_width<true, true, false>(a, s);
}
