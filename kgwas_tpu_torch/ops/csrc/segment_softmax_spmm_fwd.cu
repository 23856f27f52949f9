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
// float32 or bf16, mult float32), compile-time flag LB: the float32
// instance's arithmetic on bf16 operands, as the TPU kernel keeps the
// softmax state and the output float32 (pallas_segment.py's out_shapes and
// scratch). Each message row is read as bf16 and widened (exact), each
// bf16 logit widened; the row max and sum, p_e, the products, the sums and
// the division are float32, in the float32 kernel's order, and out,
// row_max and row_sum are written in float32. So the instance on (xs,
// logits) gives the float32 instance's bits on (xs.float(),
// logits.float()) under the same schedule. Its bound: xs read at 2 bytes
// a value, the gather half the float32 instance's bytes.
//
// Its design differs from the float32 one, whose one item per warp with
// 8 rows in flight in registers left the instance no faster than the
// float32 one on half the bytes. One warp still takes one item (blocks of
// 4 warps), but it gathers the item's bf16 source rows through a cp.async
// ring of kRingStages stages of kGroup rows in shared memory, 16 bytes a
// lane, kept packed until a lane widens its columns at use: 16 rows in
// flight a warp. Its arrays are sized by the schedule's largest item
// (item_edges), so that at D = 128 ring and arrays leave 28 warps on each
// SM. A persistent walk that staged each warp's next item while it summed
// the current one measured slower on the model's schedules (PERF.md):
// other warps already overlap an item's dependent loads. The chunk
// combine is the float32 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kEps;
using kgwas::kGroup;
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
  int item_edges;  // the bf16 instance: the most edges of an item, a
                   // multiple of 4 (its staging buffers' length)
};

template <bool VEC, int NV, bool MULT>
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
        l[q] = a.logits[first + v];
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
    kgwas::gather_rows<VEC, NV, U>(xa, a.xs, s_src, 0, it.total, lane, d);
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
      kgwas::gather_rows<VEC, NV, U>(xb, a.xs, s_src, v + U, it.total,
                                     lane, d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, a.xs, s_src, v + 2 * U, it.total,
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

// the combine of the chunked rows, after the items
template <bool VEC, int NV>
cudaError_t launch_combine(const Args& a, cudaStream_t stream) {
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (cblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (cblocks > 0) {
    segment_softmax_combine_kernel<VEC, NV>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <bool VEC, int NV, bool MULT>
cudaError_t launch_items(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    segment_softmax_spmm_fwd_kernel<VEC, NV, MULT>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_combine<VEC, NV>(a, stream);
}

template <bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.mult != nullptr ? launch_items<VEC, NV, true>(a, stream)
                           : launch_items<VEC, NV, false>(a, stream);
}

// ---- the bf16 instance: rows through a cp.async ring

constexpr int kBf16Warps = 4;   // warps per block
// ring stages of kGroup rows: 16 rows in flight a warp (2 and 4 stages
// measured no faster: fewer rows, or fewer warps)
constexpr int kRingStages = 3;

// A warp's item in shared memory, E = the most edges of an item in the
// schedule (a multiple of 4).
struct Staged {
  int* src;          // [E] each edge's source row
  float* p;          // [E] its logit, then its weight p_e
  float* mult;       // [E] its multiplier (MULT)
  float* m;          // [kItemMaxRows] each row's max
  unsigned char* k;  // [E] each edge's row in the item
};

// shared memory of one warp in 32-bit words: the ring (kRingStages stages
// of kGroup rows of rw words), then the item's arrays for items of at most
// e edges, rounded up to 16 bytes (the next warp's ring takes 16-byte
// copies)
__host__ __device__ constexpr int bf16_warp_words(int rw, int e, bool mult) {
  return (kRingStages * kGroup * rw + (mult ? 3 : 2) * e + kItemMaxRows +
          e / 4 + 3) / 4 * 4;
}

template <bool MULT>
__device__ __forceinline__ Staged staged_at(unsigned* base, int e) {
  Staged st;
  st.src = reinterpret_cast<int*>(base);
  st.p = reinterpret_cast<float*>(base + e);
  st.mult = reinterpret_cast<float*>(base + 2 * e);
  st.m = reinterpret_cast<float*>(base + (MULT ? 3 : 2) * e);
  st.k = reinterpret_cast<unsigned char*>(st.m + kItemMaxRows);
  return st;
}

// One warp per item: its edges staged (each edge's row, source row and
// logit, widened from bf16 when LB, and multiplier; the loads of four
// 32-edge batches issued before any is stored), the first S - 1 ring
// groups of its source rows put in flight, each row's max and each edge's
// weight taken while they land, then the rows summed in edge order as the
// groups arrive. Each row's arithmetic is the float32 kernel's, in its
// order. At D = 128 shared memory and registers hold 6 blocks of 4 warps
// on each SM.
template <bool VEC, int NV, bool MULT, bool LB>
__global__ void __launch_bounds__(kBf16Warps * 32, VEC && NV == 1 ? 6 : 1)
segment_softmax_spmm_fwd_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int S = kRingStages;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kBf16Warps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const int d = a.d;
  const int rw = kgwas::row_words_bf16<VEC, NV>(d);
  unsigned* ring =
      reinterpret_cast<unsigned*>(smem) +
      static_cast<size_t>(warp) * bf16_warp_words(rw, a.item_edges, MULT);
  const Staged st = staged_at<MULT>(ring + S * kGroup * rw, a.item_edges);

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[kgwas::item_of_warp(w, a.n_items)], a.row_offsets, a.n_rows,
      1, lane);
  // a packed item's rows without edges: the plain version's NEG_BIG and 0
  if (!it.chunk && lane < it.n_rows && it.cnt == 0) {
    a.row_max[it.row] = kNegBig;
    a.row_sum[it.row] = 0.0f;
  }
  if (lane < it.n_rows) st.m[lane] = kNegBig;
  const int first = kgwas::stage_row_keys(it, st.k, lane);
  for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
    int src[4] = {0, 0, 0, 0};
    float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float mu[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        src[q] = a.src[first + v];
        l[q] = LB ? __bfloat162float(a.logitsb[first + v])
                  : a.logits[first + v];
        if (MULT) mu[q] = a.mult[first + v];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        st.src[v] = src[q];
        st.p[v] = l[q];
        if (MULT) st.mult[v] = mu[q];
      }
    }
  }
  __syncwarp();

  const int n_groups = (it.total + kGroup - 1) / kGroup;
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < n_groups)
      kgwas::load_group_bf16<VEC, NV, S>(ring, rw, g, it.total, st.src,
                                         a.xsb, lane, d);
    kgwas::cp_async_commit();
  }
  // each row's max over its logits, then each edge's weight
  for (int base = 0; base < it.total; base += 32) {
    const int v = base + lane;
    const bool ok = v < it.total;
    kgwas::segmented_max(ok ? st.p[v] : kNegBig, ok ? st.k[v] : 255, st.m,
                         lane);
  }
  for (int v = lane; v < it.total; v += 32)
    st.p[v] = fast_exp(fminf(st.p[v] - st.m[st.k[v]], kExpClamp));
  __syncwarp();

  // group g of the ring made readable: the stage read last is free, so
  // group g + S - 1 starts loading into it
  auto next_group = [&](int g) {
    __syncwarp();
    if (g + S - 1 < n_groups)
      kgwas::load_group_bf16<VEC, NV, S>(ring, rw, g + S - 1, it.total,
                                         st.src, a.xsb, lane, d);
    kgwas::cp_async_commit();
    kgwas::cp_async_wait<S - 1>();  // group g has landed
    __syncwarp();
  };

  // the rows in order, each row's edges in order, as the float32 kernel
  // sums them
  for (int k = 0; k < it.n_rows; ++k) {  // warp-uniform
    const int cnt_k = __shfl_sync(kFull, it.cnt, k);
    if (cnt_k == 0) continue;
    float s = 0.0f;
    R acc;
    acc.zero();
    const int v1 = __shfl_sync(kFull, it.vbeg, k) + cnt_k;
    for (int v = v1 - cnt_k; v < v1;) {
      if (v % kGroup == 0) next_group(v / kGroup);
      const unsigned* stage = ring + ((v / kGroup) % S) * kGroup * rw;
      const int run_end = min(v1, (v / kGroup + 1) * kGroup);
      for (; v < run_end; ++v) {
        const float p = st.p[v];
        s += p;
        const float pm = MULT ? p * st.mult[v] : p;
        R x;
        kgwas::load_ring_bf16<VEC, NV>(x, stage + (v % kGroup) * rw, lane,
                                       d);
#pragma unroll
        for (int c = 0; c < R::C; ++c) acc.v[c] = fmaf(pm, x.v[c], acc.v[c]);
      }
    }
    const float m = st.m[k];
    if (it.chunk) {
      if (lane == 0) {
        a.part_m[it.part] = m;
        a.part_s[it.part] = s;
      }
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      continue;
    }
    const long long row = it.unit0 + k;
    if (lane == 0) {
      a.row_max[row] = m;
      a.row_sum[row] = s;
    }
    // division, not a multiply by the reciprocal: the same rounding as
    // the plain version's acc / (sum + eps)
#pragma unroll
    for (int c = 0; c < R::C; ++c) acc.v[c] = acc.v[c] / (s + kEps);
    acc.store(a.out + row * d, lane, d);
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

template <bool VEC, int NV, bool MULT, bool LB>
cudaError_t launch_items_bf16(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kBf16Warps - 1) / kBf16Warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    const int rw = kgwas::row_words_bf16<VEC, NV>(a.d);
    const size_t smem = sizeof(unsigned) * kBf16Warps *
                        bf16_warp_words(rw, a.item_edges, MULT);
    auto kern = segment_softmax_spmm_fwd_bf16_kernel<VEC, NV, MULT, LB>;
    cudaError_t err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kern<<<static_cast<unsigned>(blocks), kBf16Warps * 32, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return launch_combine<VEC, NV>(a, stream);
}

template <bool VEC, int NV, bool LB>
cudaError_t launch_mult_bf16(const Args& a, cudaStream_t stream) {
  return a.mult != nullptr ? launch_items_bf16<VEC, NV, true, LB>(a, stream)
                           : launch_items_bf16<VEC, NV, false, LB>(a, stream);
}

// the bf16 instance's widths: 16-byte ring copies at D = 128 * NV, else
// 4 bytes a lane
template <bool LB>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch_mult_bf16<true, 1, LB>(a, stream);
    case 256: return launch_mult_bf16<true, 2, LB>(a, stream);
    case 384: return launch_mult_bf16<true, 3, LB>(a, stream);
    case 512: return launch_mult_bf16<true, 4, LB>(a, stream);
    default:
      if (a.d >= 1 && a.d <= 32 * kMaxCols)
        return launch_mult_bf16<false, 1, LB>(a, stream);
      return cudaErrorInvalidValue;
  }
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
  a.item_edges = 0;
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

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (16-byte
// aligned rows at D = 128 * NV, else 4-byte; the wrapper checks), logits
// bf16 when logits_bf16 != 0, else float32; every output float32;
// item_edges the most edges of an item of the schedule (1 to
// kBwdMaxEdges), which sizes each warp's arrays in shared memory.
extern "C" int kgwas_segment_softmax_spmm_fwd_bf16(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, void* out, void* row_max, void* row_sum,
    const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_m, void* part_s,
    void* part_acc, long long n_rows, int d, int logits_bf16, int item_edges,
    void* stream) {
  if (item_edges < 1 || item_edges > kBwdMaxEdges)
    return cudaErrorInvalidValue;
  Args a = make_args(nullptr, src, logits_bf16 ? nullptr : logits, mult,
                     row_offsets, out, row_max, row_sum, items, n_items,
                     split_units, part_offsets, n_split, part_m, part_s,
                     part_acc, n_rows, d);
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.logitsb =
      logits_bf16 ? static_cast<const __nv_bfloat16*>(logits) : nullptr;
  a.item_edges = (item_edges + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logits_bf16 ? launch_bf16<true>(a, s) : launch_bf16<false>(a, s);
}
