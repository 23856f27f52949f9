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
// The bf16 instance (kgwas_csr_segment_sum_bf16: x bf16, out float32): the
// same sums of bf16 rows widened to float32 (exact), the JAX package's
// one-hot products on bf16 values summed in float32. With round_products
// (a bf16 w, which the wrapper passes as its exact float32 copy) each
// product w_e x[src_e] is rounded to bf16 before it is added, as the JAX
// package forms msgs * w in bf16 there; else an f32 w multiplies in
// float32. Its bound: the f32 one's with 2-byte rows.
//
// Its design differs from the float32 one, whose 8 rows in flight a warp
// in registers left the bf16 instance latency-bound on half the bytes.
// One warp still takes one item (blocks of 4 warps), but its bf16 source
// rows come through a cp.async ring of kRingStages stages of kGroup rows
// in shared memory (gat_items.cuh EdgeRing), 16 bytes a lane at
// D = 128 * NV, a lane's copies unrolled, kept packed until a lane widens
// its columns at use. Its arrays live in dynamic shared memory sized by
// the schedule's largest item (item_edges). Each column's chain is the
// float32 kernel's: one add (or FMA, or rounded product) an edge in stream
// order, from 0; rows without edges are written as 0; a chunk's partial
// goes to part_acc and the combine adds the parts in part order. Output
// rows are written once (evict first). At D = 128, 47 registers and
// 4.5 KB of shared memory a warp leave 40 warps on each SM; 3 ring stages
// measured slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::kBwdMaxEdges;
using kgwas::kFull;
using kgwas::kGroup;
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
  int item_edges;  // the bf16 instance: the most edges of an item, a
                   // multiple of 4 (its staging arrays' length)
};

template <bool VEC, int NV, bool WEIGHTED>
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
#pragma unroll
        for (int c = 0; c < R::C; ++c)
          acc.v[c] = WEIGHTED ? fmaf(wu, x[u].v[c], acc.v[c])
                              : acc.v[c] + x[u].v[c];
      }
    }
  };
  // two batches in flight: one is summed while the other arrives
  R xa[U], xb[U];
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, a.x, s_src, 0, it.total, lane, d);
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, a.x, s_src, v + U, it.total, lane,
                                     d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, a.x, s_src, v + 2 * U, it.total,
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

// ---- the bf16 instance: rows through a cp.async ring

constexpr int kBf16Warps = 4;   // warps per block
// ring stages of kGroup rows (3 cost warps an SM and measured slower)
constexpr int kRingStages = 2;

// shared memory of one warp in 32-bit words: the ring (kRingStages stages
// of kGroup rows of rw words), then the item's source rows and weights for
// items of at most e edges, rounded up to 16 bytes (the next warp's ring
// takes 16-byte copies)
__host__ __device__ constexpr int bf16_warp_words(int rw, int e,
                                                  bool weighted) {
  return (kRingStages * kGroup * rw + (weighted ? 2 : 1) * e + 3) / 4 * 4;
}

// One warp per item: its edges' source rows (and weights) staged, the
// ring's first S groups put in flight, then the rows in order, each row's
// edges summed in stream order from the ring as its groups land.
template <bool VEC, int NV, bool WEIGHTED, bool ROUND>
__global__ void __launch_bounds__(kBf16Warps * 32, VEC && NV == 1 ? 8 : 1)
csr_segment_sum_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi =
      static_cast<long long>(blockIdx.x) * kBf16Warps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const int d = a.d;
  const int rw = kgwas::row_words_bf16<VEC, NV>(d);
  unsigned* ring =
      reinterpret_cast<unsigned*>(smem) +
      static_cast<size_t>(warp) * bf16_warp_words(rw, a.item_edges, WEIGHTED);
  int* s_src = reinterpret_cast<int*>(ring + kRingStages * kGroup * rw);
  float* s_w = reinterpret_cast<float*>(s_src + a.item_edges);

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[kgwas::item_of_warp(wi, a.n_items)], a.row_offsets, a.n_rows,
      1, lane);
  // the item's edges follow each other in the stream from lane 0's first
  const int first = __shfl_sync(kFull, it.beg, 0);
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

  kgwas::EdgeRing<VEC, NV, kRingStages> ring_rows(ring, rw, it.total, s_src,
                                                  a.xb, lane, d);
  ring_rows.start();
  for (int k = 0; k < it.n_rows; ++k) {  // warp-uniform
    const int cnt_k = __shfl_sync(kFull, it.cnt, k);
    if (cnt_k == 0) continue;
    R acc;
    acc.zero();
    const int v1 = __shfl_sync(kFull, it.vbeg, k) + cnt_k;
    for (int v = v1 - cnt_k; v < v1;) {
      if (v % kGroup == 0) {  // the group read last is free, v's landed
        ring_rows.release(v);
        ring_rows.ready(v);
      }
      const int run_end = min(v1, (v / kGroup + 1) * kGroup);
      for (; v < run_end; ++v) {  // the edges of one ring group
        R x;
        kgwas::load_ring_bf16<VEC, NV>(x, ring_rows.row(v), lane, d);
        const float wu = WEIGHTED ? s_w[v] : 1.0f;
        if (ROUND) {
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] += kgwas::round_bf16(__fmul_rn(wu, x.v[c]));
        } else {
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] = WEIGHTED ? fmaf(wu, x.v[c], acc.v[c])
                                : acc.v[c] + x.v[c];
        }
      }
    }
    if (it.chunk)
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
    else  // written once: evict first
      acc.store_once(a.out + (it.unit0 + k) * d, lane, d);
  }
  kgwas::cp_async_wait<0>();
  if (!it.chunk) {  // the item's rows without edges: zeros
    unsigned empty = __ballot_sync(kFull, lane < it.n_rows && it.cnt == 0);
    R zero;
    zero.zero();
    for (; empty; empty &= empty - 1)
      zero.store(a.out + (it.unit0 + __ffs(empty) - 1) * d, lane, d);
  }
}

// the chunked rows' parts added in part order
template <bool VEC, int NV>
cudaError_t launch_combine(const Args& a, cudaStream_t stream) {
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (cblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (cblocks == 0) return cudaSuccess;
  csr_combine_kernel<VEC, NV>
      <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC, int NV, bool WEIGHTED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    csr_segment_sum_kernel<VEC, NV, WEIGHTED>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_combine<VEC, NV>(a, stream);
}

template <bool VEC, int NV, bool WEIGHTED, bool ROUND>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kBf16Warps - 1) / kBf16Warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    const int rw = kgwas::row_words_bf16<VEC, NV>(a.d);
    const size_t smem = sizeof(unsigned) * kBf16Warps *
                        bf16_warp_words(rw, a.item_edges, WEIGHTED);
    auto kern = csr_segment_sum_bf16_kernel<VEC, NV, WEIGHTED, ROUND>;
    cudaError_t err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kern<<<static_cast<unsigned>(blocks), kBf16Warps * 32, smem, stream>>>(
        a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return launch_combine<VEC, NV>(a, stream);
}

template <bool WEIGHTED>
cudaError_t dispatch_width(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch<true, 1, WEIGHTED>(a, stream);
    case 256: return launch<true, 2, WEIGHTED>(a, stream);
    case 384: return launch<true, 3, WEIGHTED>(a, stream);
    case 512: return launch<true, 4, WEIGHTED>(a, stream);
    default:
      if (a.d >= 1 && a.d <= 32 * kMaxCols)
        return launch<false, 1, WEIGHTED>(a, stream);
      return cudaErrorInvalidValue;
  }
}

// the bf16 instance's widths: 16-byte ring copies at D = 128 * NV, else
// 4 bytes a lane
template <bool WEIGHTED, bool ROUND>
cudaError_t dispatch_width_bf16(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch_bf16<true, 1, WEIGHTED, ROUND>(a, stream);
    case 256: return launch_bf16<true, 2, WEIGHTED, ROUND>(a, stream);
    case 384: return launch_bf16<true, 3, WEIGHTED, ROUND>(a, stream);
    case 512: return launch_bf16<true, 4, WEIGHTED, ROUND>(a, stream);
    default:
      if (a.d >= 1 && a.d <= 32 * kMaxCols)
        return launch_bf16<false, 1, WEIGHTED, ROUND>(a, stream);
      return cudaErrorInvalidValue;
  }
}

Args make_args(const void* src, const void* row_offsets, const void* w,
               void* out, const void* items, long long n_items,
               const void* split_units, const void* part_offsets,
               long long n_split, void* part_acc, long long n_rows, int d) {
  Args a;
  a.x = nullptr;
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
  a.item_edges = 0;
  return a;
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
  Args a = make_args(src, row_offsets, w, out, items, n_items, split_units,
                     part_offsets, n_split, part_acc, n_rows, d);
  a.x = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s);
}

// The bf16 instance: the same arguments, x a bf16 [S, D] table (16-byte
// aligned rows at D = 128 * NV, else 4-byte; the wrapper checks);
// round_products != 0 (with w) rounds each product w_e x[src_e] to bf16;
// item_edges the most edges of an item of the schedule (1 to
// kBwdMaxEdges), which sizes each warp's arrays in shared memory.
extern "C" int kgwas_csr_segment_sum_bf16(
    const void* x, const void* src, const void* row_offsets, const void* w,
    void* out, const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_acc,
    long long n_rows, int d, int round_products, int item_edges,
    void* stream) {
  if (item_edges < 1 || item_edges > kBwdMaxEdges)
    return cudaErrorInvalidValue;
  Args a = make_args(src, row_offsets, w, out, items, n_items, split_units,
                     part_offsets, n_split, part_acc, n_rows, d);
  a.xb = static_cast<const __nv_bfloat16*>(x);
  a.item_edges = (item_edges + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == nullptr) return dispatch_width_bf16<false, false>(a, s);
  return round_products ? dispatch_width_bf16<true, true>(a, s)
                        : dispatch_width_bf16<true, false>(a, s);
}
