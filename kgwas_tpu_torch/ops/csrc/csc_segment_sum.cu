// CSC segment sum of a layer's message cotangent, for Hopper (sm_90a),
// plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_segsum_kernel as
// pallas_segment_sum launches it for gather_rows_csc's backward: there the
// [E, D] message cotangent d_msgs (written by the backward layer kernel) is
// permuted to source order and summed per source row. Here d_msgs is never
// written. Walking the layout's CSC (entry i of source row s is edge e =
// csc_perm[i]), each source row s of the concatenated table xs gets
//
//   d_xs[s] = sum_i (w_e g[row_i] + dz_e att[slot(s)])
//           = sum_i w_e g[row_i] + c_s att[slot(s)],     c_s = sum_i dz_e
//
// with w and dz from the layer's edge backward (merged_gat_bwd.cu), g the
// layer output's cotangent and row_i = csc_rows[i] its row for entry i
// (dst[csc_perm[i]], % N with the merged layer's fold, laid out in CSC order
// once per layout). The same pass reduces the attention vector's gradient
// d_att[slot] = sum_{s in slot} c_s xs[s], which the TPU backward layer
// kernel accumulates per tile (its d_att partials are summed outside it,
// _tile_grads_to_rel).
//
// Without logit cotangents (dz == nullptr: the per-relation GAT backward
// after segment_softmax_spmm_bwd.cu, and the message-passing backward of
// csr_segment_sum.cu) the kernel runs with LOGITS = false, a compile-time
// flag: d_xs[s] = sum_i w_e g[row_i], no att, no d_att. With w == nullptr
// every weight is 1 (the SAGE mean's sum) and csc_perm is not read.
//
// The gradient of the weights (d_w != nullptr, a compile-time flag DW, only
// without logit cotangents: the backward of csr_segment_sum.cu when w is a
// function of parameters, the per-relation sigmoid GAT layer): for each
// entry i of source row s, d_w[csc_perm[i]] = g[row_i] . xs[s]. The warp
// that owns row s loads xs[s] once, when the row starts, and dots it with
// each cotangent row it gathers anyway: one more row read per source row
// and one float written per edge. The U dots of a batch reduce across the
// warp in one transposing butterfly (warp_rows.cuh multi_sum). Each edge
// has one CSC entry, so each d_w is written once, also on chunked rows,
// which need no combine for it. A launch without d_w runs the kernel as it
// was.
//
// Design. A static schedule over source rows (gat_items.cuh,
// ops/schedule.py; built once per layout and kept on its DeviceLayout with
// csc_rows) gives each warp one item: up to 32 consecutive source rows of
// one slot with at most max_edges entries together, or one chunk of a
// longer row (a slot's trash source row, which holds the relation's pad
// edges, or a hub). The warp stages the item's entries in shared memory,
// their loads issued four 32-entry batches at a time: first each entry's
// cotangent row and edge (csc_offsets -> csc_rows and csc_perm, two
// dependent loads where reading dst through csc_perm took three); it then
// puts its first cotangent rows in flight and stages w and dz by edge
// meanwhile.
// It gathers the cotangent rows into registers, two batches of 4 at
// D = 128 in flight, one summed while the other arrives, each row's sum in
// CSC order, one FMA per column and entry, as the one-warp-per-row kernel
// before it did; a row's c_s is summed when the row ends, in that kernel's
// order (lane partials of every 32nd entry, then a butterfly), so a row
// that is not chunked gets the same bits. Shared memory is a few KB a
// warp, so 8-warp blocks (at most 64 registers a thread at D = 128: 32
// warps on each SM) keep many warps on each SM, and their staging
// overlaps the others' gathers. Chunks write partial sums (acc, c) to
// scratch, and a second launch adds each chunked row's parts in part
// order. Every item writes its share of d_att (the sum of c xs[s] over its
// rows in order, or its chunk's; the item's xs rows are consecutive and
// are read once its cotangent rows are summed, two batches of U in flight)
// to a partial row; two small launches sum them per slot in item order,
// first in groups of 64 items over many blocks, then the groups. No
// atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (g [N or R*N, D], xs [S, D], w, dz, csc_rows and csc_perm [E],
// csc_offsets [S + 1], d_xs [S, D]), against 2 D flops per entry. The
// gather reads a cotangent row per entry (512 bytes at D = 128): from L2
// when g fits (the Gene group's 10.5 MB), else mostly from device memory
// (the SNP group's 102.5 MB); that gather's rate, measured alone by
// gather_probe.cu, is the floor the design aims at.
//
// The bf16 instance (kgwas_csc_segment_sum_bf16: xs bf16; g, w, dz, att
// and every output float32). With the logit term it rounds where the JAX
// package's backward rounds on bf16 messages: each entry's message
// cotangent row w_e g[row_i] + dz_e att[slot] (products and sum rounded
// separately, as the plain version forms them) is rounded to bf16 before
// it is added, so the att term is not factored out of the row's sum, and
// c_s sums the bf16-rounded dz_e for d_att. Without it, a weighted sum
// rounds each product w_e g[row_i] to bf16 (the JAX package's cotangent of
// bf16 messages times float32 weights comes back through the cast to bf16)
// and an unweighted one is the f32 instance's sum; xs is read as bf16 for
// d_att and d_w. Its bound: xs read at 2 bytes a value.
//
// Its kernel (csc_items_bf16_kernel) is the float32 one's item per warp
// with two changes that keep the bits: the rows' c are summed once w and
// dz are staged, eight rows at a time in one transposing butterfly
// (multi_sum: the same pairs as each row's own butterfly), where the
// float32 kernel sums one row's when the row ends; and pairs of columns
// round to bf16 in one conversion. It runs in blocks of 4 warps with a
// register budget by form (72 with the logit term, 64 without), so that
// neither spills much and 28 or 32 warps fit on each SM. Two designs
// measured slower on the model's layouts (PERF.md): a persistent
// walk that staged each warp's next item between its register batches
// (its registers cost warps, and other warps already overlap an item's
// dependent loads), and the d_att share's xs rows streamed behind the
// cotangent rows through the same batches (its registers cost warps too).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::kBwdMaxEdges;
using kgwas::kFull;
using kgwas::kItemMaxRows;
using kgwas::kMaxCols;
using kgwas::multi_sum;
using kgwas::row_dot;

constexpr int kWarps = 8;          // warps per block
constexpr int kMaxSlots = 32;      // ops/segment.py MAX_SLOTS
constexpr int kMaxD = 32 * kMaxCols;

struct Args {
  const float* g;            // [N or R*N, D]
  const float* w;            // [E], edge order
  const float* dz;           // [E], edge order
  const float* xs;           // [S, D]
  const float* att;          // [R, D]
  const int* csc_rows;       // [E]: entry i's row of g
  const int* csc_perm;       // [E]: entry i's edge
  const int* csc_offsets;    // [S + 1]
  const int4* items;         // [n_items]
  const int* split_units;    // [n_split]
  const int* part_offsets;   // [n_split + 1]
  float* part_acc;           // [n_parts, D]
  float* part_c;             // [n_parts]
  float* d_xs;               // [S, D]
  float* d_att;              // [R, D]
  float* d_w;                // [E], edge order, or null (DW = false)
  float* partial;            // [n_items, D]
  long long src_base[kMaxSlots + 1];
  long long slot_items[kMaxSlots + 1];  // slot r's items
  long long slot_groups[kMaxSlots + 1]; // slot r's groups of kGroupItems
  long long n_items;
  long long n_split;
  long long n_src;           // S
  int n_rel;
  int d;
  const __nv_bfloat16* xsb;  // [S, D]: the bf16 instance's table
};

// the slot whose source rows hold row s
__device__ __forceinline__ int slot_of(const Args& a, long long s) {
  int slot = 0;
  while (slot + 1 < a.n_rel && a.src_base[slot + 1] <= s) ++slot;
  return slot;
}

// at D = 128, at most 64 registers a thread: 4 blocks, 32 warps, on each
// SM (wider rows need more; with DW, 3 blocks)
template <bool VEC, int NV, bool LOGITS, bool DW>
__global__ void __launch_bounds__(kWarps * 32,
                                  VEC && NV == 1 ? (DW ? 3 : 4) : 1)
csc_items_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  const float* xs = a.xs;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  __shared__ int s_row_w[kWarps][kBwdMaxEdges];
  __shared__ float s_w_w[kWarps][kBwdMaxEdges];
  __shared__ float s_dz_w[kWarps][LOGITS ? kBwdMaxEdges : 1];
  __shared__ unsigned char s_k_w[kWarps][kBwdMaxEdges];
  __shared__ int s_edge_w[kWarps][DW ? kBwdMaxEdges : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(wi, a.n_items);
  int* s_row = s_row_w[warp];
  float* s_w = s_w_w[warp];
  float* s_dz = s_dz_w[warp];
  unsigned char* s_k = s_k_w[warp];
  const int d = a.d;
  const bool weighted = a.w != nullptr;

  const kgwas::ItemRows it =
      kgwas::item_rows(a.items[item], a.csc_offsets, a.n_src, 1, lane);
  // each virtual entry's source row, then its cotangent row and its edge
  // (the item's entries follow each other in the CSC), both loads issued
  // together; the edge waits in s_w's place for w and dz (in its own array
  // with DW, which writes d_w by edge at the end)
  const bool by_edge = LOGITS || weighted || DW;
  int* s_e = DW ? s_edge_w[warp] : reinterpret_cast<int*>(s_w);
  const int first = kgwas::stage_row_keys(it, s_k, lane);
  for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
    int row[4] = {0, 0, 0, 0};
    int e[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        row[q] = a.csc_rows[first + v];
        if (by_edge) e[q] = a.csc_perm[first + v];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        s_row[v] = row[q];
        if (by_edge) s_e[v] = e[q];
      }
    }
  }
  __syncwarp();
  // the first cotangent rows in flight while w and dz arrive, by each
  // entry's edge (each lane rewrites its own entries)
  R xa[U], xb[U];
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, a.g, s_row, 0, it.total, lane, d);
  if (LOGITS || weighted) {
    for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
      float wq[4], dzq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + 32 * q + lane;
        if (v < it.total) {
          const int e = s_e[v];
          wq[q] = weighted ? a.w[e] : 1.0f;
          if (LOGITS) dzq[q] = a.dz[e];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + 32 * q + lane;
        if (v < it.total) {
          s_w[v] = wq[q];
          if (LOGITS) s_dz[v] = dzq[q];
        }
      }
    }
    __syncwarp();
  }
  R att;  // the slot's attention row
  if (LOGITS)
    att.load(a.att + static_cast<size_t>(slot_of(a, it.unit0)) * d, lane, d);

  int cur = -1;  // the row being summed
  R acc;
  acc.zero();
  R xr;  // DW: the row's own xs[s]
  float my_c = 0.0f;  // lane k: c of the item's row k
  auto finish_row = [&](int k) {
    const long long s = it.unit0 + (it.chunk ? 0 : k);
    // c of row k in the one-warp-per-row kernel's order: lane partials of
    // every 32nd entry, then a butterfly
    float c = 0.0f;
    if (LOGITS) {
      const int beg = __shfl_sync(kFull, it.vbeg, k);
      const int cnt = __shfl_sync(kFull, it.cnt, k);
      for (int j = lane; j < cnt; j += 32)
        c += s_dz[beg + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(kFull, c, off);
      if (lane == k) my_c = c;
    }
    if (it.chunk) {
      if (LOGITS && lane == 0) a.part_c[it.part] = c;
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      return;
    }
    if (LOGITS) {
#pragma unroll
      for (int q = 0; q < R::C; ++q) acc.v[q] = fmaf(c, att.v[q], acc.v[q]);
    }
    acc.store(a.d_xs + s * d, lane, d);
  };

  // sums batch x of U rows, entries v..v+U-1 (with DW, and each entry's
  // g[row_i] . xs[s] to d_w)
  auto take = [&](const R (&x)[U], int v) {
    float dw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vu = v + u;
      if (DW) dw[u] = 0.0f;
      if (vu < it.total) {  // warp-uniform
        const int k = s_k[vu];
        if (k != cur) {
          if (cur >= 0) finish_row(cur);
          cur = k;
          acc.zero();
          if (DW)
            xr.load(xs + static_cast<size_t>(it.unit0 + (it.chunk ? 0 : k))
                             * d,
                    lane, d);
        }
        const float wv = weighted ? s_w[vu] : 1.0f;
#pragma unroll
        for (int q = 0; q < R::C; ++q)
          acc.v[q] = fmaf(wv, x[u].v[q], acc.v[q]);
        if (DW) dw[u] = row_dot(x[u], xr);
      }
    }
    if (DW) {
      const float t = multi_sum<U>(dw, lane);
      const int j = lane / (32 / U);
      if (lane % (32 / U) == 0 && v + j < it.total) a.d_w[s_e[v + j]] = t;
    }
  };
  // two batches in flight: one is summed while the other arrives
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, a.g, s_row, v + U, it.total, lane,
                                     d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, a.g, s_row, v + 2 * U, it.total,
                                     lane, d);
    if (v + U < it.total) take(xb, v + U);
  }
  if (cur >= 0) finish_row(cur);
  if (!it.chunk) {  // the item's rows without edges: zeros
    unsigned empty = __ballot_sync(kFull, lane < it.n_rows && it.cnt == 0);
    R zero;
    zero.zero();
    for (; empty; empty &= empty - 1)
      zero.store(a.d_xs + (it.unit0 + __ffs(empty) - 1) * d, lane, d);
  }
  if (!LOGITS) return;
  // the item's share of d_att, the sum of c xs[s] over its rows in order
  // (a row with c = 0 adds nothing): the xs rows, consecutive, gathered two
  // batches of U at a time once the item's cotangent rows are summed
  const unsigned nz = __ballot_sync(kFull, lane < it.n_rows && my_c != 0.0f);
  __syncwarp();  // s_row and s_k are free again
  if (nz >> lane & 1) {
    const int j = __popc(nz & ((1u << lane) - 1));
    s_row[j] = static_cast<int>(it.unit0) + lane;
    s_k[j] = static_cast<unsigned char>(lane);
  }
  __syncwarp();
  const int n_nz = __popc(nz);
  R part;
  part.zero();
  auto add = [&](const R (&x)[U], int v) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v + u < n_nz) {  // warp-uniform
        const float c = __shfl_sync(kFull, my_c, s_k[v + u]);
#pragma unroll
        for (int q = 0; q < R::C; ++q)
          part.v[q] = fmaf(c, x[u].v[q], part.v[q]);
      }
    }
  };
  if (n_nz > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, xs, s_row, 0, n_nz, lane, d);
  for (int v = 0; v < n_nz; v += 2 * U) {
    if (v + U < n_nz)
      kgwas::gather_rows<VEC, NV, U>(xb, xs, s_row, v + U, n_nz, lane, d);
    add(xa, v);
    if (v + 2 * U < n_nz)
      kgwas::gather_rows<VEC, NV, U>(xa, xs, s_row, v + 2 * U, n_nz, lane,
                                     d);
    if (v + U < n_nz) add(xb, v + U);
  }
  part.store(a.partial + item * d, lane, d);
}

// ---- the bf16 instance
//
// One warp an item, as the float32 kernel, in blocks of 4 warps: its
// rows' c are summed once w and dz are staged, eight rows at a time in
// one transposing butterfly, and pairs of columns round to bf16 in one
// conversion (see the note at the top).

constexpr int kBf16Warps = 4;  // warps per block

// A warp's item in shared memory.
template <bool LOGITS, bool DW>
struct Staged {
  int row[kBwdMaxEdges];    // each entry's row of g, then the d_att rows
  float w[kBwdMaxEdges];    // its edge's weight (first its edge, without DW)
  float dz[LOGITS ? kBwdMaxEdges : 1];  // its edge's logit cotangent
  int e[DW ? kBwdMaxEdges : 1];         // its edge (DW)
  float c[LOGITS ? kItemMaxRows : 1];   // each row's c
  unsigned char nz[LOGITS ? kItemMaxRows : 1];  // the rows with c != 0
  unsigned char k[kBwdMaxEdges];        // each entry's row in the item
};

// c of each of the item's rows, the bf16-rounded dz summed in the float32
// kernel's order (lane partials of every 32nd entry, then a butterfly):
// eight rows at a time, their butterflies in one transposing multi_sum
// (the same pairs, so the same bits); then the rows with c != 0 in order.
// Returns how many.
template <bool DW>
__device__ __forceinline__ int stage_c(const kgwas::ItemRows& it,
                                       Staged<true, DW>& st, int lane) {
  constexpr int G = 8;
  for (int k0 = 0; k0 < it.n_rows; k0 += G) {  // warp-uniform
    float p[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int k = min(k0 + u, it.n_rows - 1);
      const int beg = __shfl_sync(kFull, it.vbeg, k);
      const int cnt = __shfl_sync(kFull, it.cnt, k);
      p[u] = 0.0f;
      for (int j = lane; j < cnt; j += 32)
        p[u] += kgwas::round_bf16(st.dz[beg + j]);
    }
    const float t = multi_sum<G>(p, lane);
    const int k = k0 + lane / (32 / G);
    if (lane % (32 / G) == 0 && k < it.n_rows) st.c[k] = t;
  }
  __syncwarp();
  const float my_c = lane < it.n_rows ? st.c[lane] : 0.0f;
  const unsigned nz = __ballot_sync(kFull, my_c != 0.0f);
  if (nz >> lane & 1)
    st.nz[__popc(nz & ((1u << lane) - 1))] = static_cast<unsigned char>(lane);
  __syncwarp();
  return __popc(nz);
}

// each of a lane's columns rounded to the nearest bf16, a pair a
// conversion (the same bits as one at a time; C is even)
template <int C>
__device__ __forceinline__ void round_bf16_cols(float (&t)[C]) {
#pragma unroll
  for (int q = 0; q < C; q += 2) {
    const float2 r = __bfloat1622float2(
        __float22bfloat162_rn(make_float2(t[q], t[q + 1])));
    t[q] = r.x;
    t[q + 1] = r.y;
  }
}

// at D = 128, at most 72 registers a thread with the logit term (7 blocks,
// 28 warps, on each SM), else 64 (8 blocks, 32 warps)
template <bool VEC, int NV, bool LOGITS, bool DW>
__global__ void __launch_bounds__(kBf16Warps * 32,
                                  VEC && NV == 1 ? (LOGITS ? 7 : 8) : 1)
csc_items_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  __shared__ Staged<LOGITS, DW> st_w[kBf16Warps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi = static_cast<long long>(blockIdx.x) * kBf16Warps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(wi, a.n_items);
  Staged<LOGITS, DW>& st = st_w[warp];
  const int d = a.d;
  const bool weighted = a.w != nullptr;

  const kgwas::ItemRows it =
      kgwas::item_rows(a.items[item], a.csc_offsets, a.n_src, 1, lane);
  // each entry's cotangent row and edge (the item's entries follow each
  // other in the CSC), loads issued four 32-entry batches at a time; the
  // edge waits in w's place for w and dz (in its own array with DW)
  const bool by_edge = LOGITS || weighted || DW;
  int* s_e = DW ? st.e : reinterpret_cast<int*>(st.w);
  const int first = kgwas::stage_row_keys(it, st.k, lane);
  for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
    int row[4] = {0, 0, 0, 0};
    int e[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        row[q] = a.csc_rows[first + v];
        if (by_edge) e[q] = a.csc_perm[first + v];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = v0 + 32 * q + lane;
      if (v < it.total) {
        st.row[v] = row[q];
        if (by_edge) s_e[v] = e[q];
      }
    }
  }
  __syncwarp();
  // the first cotangent rows in flight while w and dz arrive by each
  // entry's edge (each lane rewrites its own entries)
  R xa[U], xb[U];
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, a.g, st.row, 0, it.total, lane, d);
  if (LOGITS || weighted) {
    for (int v0 = 0; v0 < it.total; v0 += 4 * 32) {
      float wq[4], dzq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + 32 * q + lane;
        if (v < it.total) {
          const int e = s_e[v];
          wq[q] = weighted ? a.w[e] : 1.0f;
          if (LOGITS) dzq[q] = a.dz[e];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + 32 * q + lane;
        if (v < it.total) {
          st.w[v] = wq[q];
          if (LOGITS) st.dz[v] = dzq[q];
        }
      }
    }
    __syncwarp();
  }
  int n_nz = 0;
  if constexpr (LOGITS) n_nz = stage_c(it, st, lane);
  R att;  // the slot's attention row
  if (LOGITS)
    att.load(a.att + static_cast<size_t>(slot_of(a, it.unit0)) * d, lane, d);

  int cur = -1;  // the row being summed
  R acc;
  acc.zero();
  R xr;  // DW: the row's own xs[s]
  auto finish_row = [&](int k) {
    if (it.chunk) {
      if (LOGITS && lane == 0) a.part_c[it.part] = st.c[0];
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
    } else {
      acc.store(a.d_xs + (it.unit0 + k) * d, lane, d);
    }
  };
  // sums batch x of U rows, entries v..v+U-1 (with DW, and each entry's
  // g[row_i] . xs[s] to d_w)
  auto take = [&](const R (&x)[U], int v) {
    float dw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vu = v + u;
      if (DW) dw[u] = 0.0f;
      if (vu < it.total) {  // warp-uniform
        const int k = st.k[vu];
        if (k != cur) {
          if (cur >= 0) finish_row(cur);
          cur = k;
          acc.zero();
          if (DW)
            xr.load(a.xsb + static_cast<size_t>(it.unit0 + k) * d, lane, d);
        }
        const float wv = weighted ? st.w[vu] : 1.0f;
        if (LOGITS) {
          // the formed row w_e g + dz_e att, rounded to bf16
          const float dzv = st.dz[vu];
          float t[R::C];
#pragma unroll
          for (int q = 0; q < R::C; ++q)
            t[q] = __fadd_rn(__fmul_rn(wv, x[u].v[q]),
                             __fmul_rn(dzv, att.v[q]));
          round_bf16_cols(t);
#pragma unroll
          for (int q = 0; q < R::C; ++q) acc.v[q] += t[q];
        } else if (weighted) {
          float t[R::C];
#pragma unroll
          for (int q = 0; q < R::C; ++q) t[q] = __fmul_rn(wv, x[u].v[q]);
          round_bf16_cols(t);
#pragma unroll
          for (int q = 0; q < R::C; ++q) acc.v[q] += t[q];
        } else {
#pragma unroll
          for (int q = 0; q < R::C; ++q)
            acc.v[q] = fmaf(wv, x[u].v[q], acc.v[q]);
        }
        if (DW) dw[u] = kgwas::row_dot(x[u], xr);
      }
    }
    if (DW) {
      const float t = multi_sum<U>(dw, lane);
      const int j = lane / (32 / U);
      if (lane % (32 / U) == 0 && v + j < it.total) a.d_w[st.e[v + j]] = t;
    }
  };
  // two batches in flight: one is summed while the other arrives
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, a.g, st.row, v + U, it.total, lane,
                                     d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, a.g, st.row, v + 2 * U, it.total,
                                     lane, d);
    if (v + U < it.total) take(xb, v + U);
  }
  if (cur >= 0) finish_row(cur);
  if (!it.chunk) {  // the item's rows without edges: zeros
    unsigned empty = __ballot_sync(kFull, lane < it.n_rows && it.cnt == 0);
    R zero;
    zero.zero();
    for (; empty; empty &= empty - 1)
      zero.store(a.d_xs + (it.unit0 + __ffs(empty) - 1) * d, lane, d);
  }
  if (!LOGITS) return;
  // the item's share of d_att, the sum of c xs[s] over its rows with
  // c != 0 in order: their xs rows, consecutive, gathered two batches of U
  // at a time once its cotangent rows are summed
  __syncwarp();  // the entries' rows are read
  if (lane < n_nz) st.row[lane] = static_cast<int>(it.unit0) + st.nz[lane];
  __syncwarp();
  R share;
  share.zero();
  auto add = [&](const R (&x)[U], int v) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v + u < n_nz) {  // warp-uniform
        const float c = st.c[st.nz[v + u]];
#pragma unroll
        for (int q = 0; q < R::C; ++q)
          share.v[q] = fmaf(c, x[u].v[q], share.v[q]);
      }
    }
  };
  if (n_nz > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, a.xsb, st.row, 0, n_nz, lane, d);
  for (int v = 0; v < n_nz; v += 2 * U) {
    if (v + U < n_nz)
      kgwas::gather_rows<VEC, NV, U>(xb, a.xsb, st.row, v + U, n_nz, lane,
                                     d);
    add(xa, v);
    if (v + 2 * U < n_nz)
      kgwas::gather_rows<VEC, NV, U>(xa, a.xsb, st.row, v + 2 * U, n_nz,
                                     lane, d);
    if (v + U < n_nz) add(xb, v + U);
  }
  share.store(a.partial + item * d, lane, d);
}

template <bool VEC, int NV, bool LOGITS, bool DW>
cudaError_t launch_items_bf16(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kBf16Warps - 1) / kBf16Warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  csc_items_bf16_kernel<VEC, NV, LOGITS, DW>
      <<<static_cast<unsigned>(blocks), kBf16Warps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// One warp per source row cut into chunks: its parts added in part order,
// then c_s att[slot] (the bf16 instance's parts hold the att term).
template <bool VEC, int NV, bool LOGITS, bool BF>
__global__ void __launch_bounds__(kWarps * 32)
csc_combine_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= a.n_split) return;
  const int d = a.d;
  const long long s = a.split_units[j];
  R acc;
  acc.zero();
  float c = 0.0f;
  for (int pi = a.part_offsets[j]; pi < a.part_offsets[j + 1]; ++pi) {
    R x;
    x.load(a.part_acc + static_cast<size_t>(pi) * d, lane, d);
#pragma unroll
    for (int q = 0; q < R::C; ++q) acc.v[q] += x.v[q];
    if (LOGITS) c += a.part_c[pi];
  }
  if (LOGITS && !BF) {
    R att;
    att.load(a.att + static_cast<size_t>(slot_of(a, s)) * d, lane, d);
#pragma unroll
    for (int q = 0; q < R::C; ++q) acc.v[q] = fmaf(c, att.v[q], acc.v[q]);
  }
  acc.store(a.d_xs + s * d, lane, d);
}

// d_att[slot] = the sum of the slot's item partials, in two passes so
// that many blocks share the work. Each slot's items form groups of
// kGroupItems consecutive items; group_sum_kernel (grid (groups, D / 32))
// sums a group's partials into its first row, and slot_sum_kernel (grid
// (R, D / 32)) sums each slot's group rows. In both, lane = column, warp k
// sums rows k, k + 8, ... in order, then warp 0 sums the 8 warps' sums in
// order: a fixed order, no atomics.
constexpr int kSumWarps = 8;
constexpr int kGroupItems = 64;

__device__ __forceinline__ void sum_rows(const Args& a, long long b0,
                                         long long b1, long long stride,
                                         float* dst) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;
  float s = 0.0f;
  if (col < a.d)
    for (long long b = b0 + warp * stride; b < b1; b += kSumWarps * stride)
      s += a.partial[b * a.d + col];
  red[warp][lane] = s;
  __syncthreads();  // every read of the rows is done before the write
  if (warp == 0 && col < a.d) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kSumWarps; ++k) t += red[k][lane];
    dst[col] = t;
  }
}

__global__ void __launch_bounds__(kSumWarps * 32)
group_sum_kernel(const Args a) {
  const long long g = blockIdx.x;
  int slot = 0;
  while (slot + 1 < a.n_rel && a.slot_groups[slot + 1] <= g) ++slot;
  const long long b0 =
      a.slot_items[slot] + (g - a.slot_groups[slot]) * kGroupItems;
  const long long b1 = min(b0 + kGroupItems, a.slot_items[slot + 1]);
  sum_rows(a, b0, b1, 1, a.partial + b0 * a.d);
}

__global__ void __launch_bounds__(kSumWarps * 32)
slot_sum_kernel(const Args a) {
  const int slot = blockIdx.x;
  sum_rows(a, a.slot_items[slot], a.slot_items[slot + 1], kGroupItems,
           a.d_att + static_cast<long long>(slot) * a.d);
}

template <bool VEC, int NV, bool LOGITS, bool DW, bool BF>
cudaError_t launch_items(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (BF) {
    const cudaError_t err = launch_items_bf16<VEC, NV, LOGITS, DW>(a, stream);
    if (err != cudaSuccess) return err;
  } else if (blocks > 0) {
    csc_items_kernel<VEC, NV, LOGITS, DW>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (cblocks > 0) {
    csc_combine_kernel<VEC, NV, LOGITS, BF>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!LOGITS) return cudaSuccess;
  const long long groups = a.slot_groups[a.n_rel];
  if (groups > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (groups > 0) {
    group_sum_kernel<<<dim3(static_cast<unsigned>(groups), (a.d + 31) / 32),
                       kSumWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  slot_sum_kernel<<<dim3(a.n_rel, (a.d + 31) / 32), kSumWarps * 32, 0,
                    stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC, int NV, bool BF>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.dz != nullptr)
    return launch_items<VEC, NV, true, false, BF>(a, stream);
  return a.d_w != nullptr ? launch_items<VEC, NV, false, true, BF>(a, stream)
                          : launch_items<VEC, NV, false, false, BF>(a, stream);
}

// Returns the launch's cudaError_t (0 on success). Device pointers except
// src_base and slot_items, host arrays of n_rel + 1 source-row and item
// boundaries of the slots (the wrapper checks them against the schedule,
// and 16-byte alignment of the float4 rows and the items). w may be null
// (weight 1); dz null (no logit term) leaves att, part_c, d_att and
// partial unread and unwritten; d_w null writes no weight gradient, and
// d_w is taken only without dz. csc_perm is read only for w, dz or d_w. Up
// to four launches: the items, the combine of the chunked rows, the group and
// slot sums of d_att.
template <bool BF>
int segment_sum_entry(
    const void* g, const void* w, const void* dz, const void* xs,
    const void* att, const void* csc_rows, const void* csc_perm,
    const void* csc_offsets, const void* items, long long n_items,
    const void* split_units, const void* part_offsets, long long n_split,
    void* part_acc, void* part_c, const long long* src_base,
    const long long* slot_items, void* d_xs, void* d_att, void* d_w,
    void* partial, int n_rel, int d, void* stream) {
  if (n_rel < 1 || n_rel > kMaxSlots || d < 1 || d > kMaxD ||
      (dz != nullptr && d_w != nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.xsb = BF ? static_cast<const __nv_bfloat16*>(xs) : nullptr;
  a.g = static_cast<const float*>(g);
  a.w = static_cast<const float*>(w);
  a.dz = static_cast<const float*>(dz);
  a.xs = BF ? nullptr : static_cast<const float*>(xs);
  a.att = static_cast<const float*>(att);
  a.csc_rows = static_cast<const int*>(csc_rows);
  a.csc_perm = static_cast<const int*>(csc_perm);
  a.csc_offsets = static_cast<const int*>(csc_offsets);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_c = static_cast<float*>(part_c);
  a.d_xs = static_cast<float*>(d_xs);
  a.d_att = static_cast<float*>(d_att);
  a.d_w = static_cast<float*>(d_w);
  a.partial = static_cast<float*>(partial);
  for (int r = 0; r <= n_rel; ++r) {
    a.src_base[r] = src_base[r];
    a.slot_items[r] = slot_items[r];
  }
  a.slot_groups[0] = 0;
  for (int r = 0; r < n_rel; ++r)
    a.slot_groups[r + 1] =
        a.slot_groups[r] +
        (slot_items[r + 1] - slot_items[r] + kGroupItems - 1) / kGroupItems;
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_src = src_base[n_rel];
  a.n_rel = n_rel;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return launch<true, 1, BF>(a, s);
    case 256: return launch<true, 2, BF>(a, s);
    case 384: return launch<true, 3, BF>(a, s);
    case 512: return launch<true, 4, BF>(a, s);
    default: return launch<false, 1, BF>(a, s);
  }
}

}  // namespace

extern "C" int kgwas_csc_segment_sum(
    const void* g, const void* w, const void* dz, const void* xs,
    const void* att, const void* csc_rows, const void* csc_perm,
    const void* csc_offsets, const void* items, long long n_items,
    const void* split_units, const void* part_offsets, long long n_split,
    void* part_acc, void* part_c, const long long* src_base,
    const long long* slot_items, void* d_xs, void* d_att, void* d_w,
    void* partial, int n_rel, int d, void* stream) {
  return segment_sum_entry<false>(
      g, w, dz, xs, att, csc_rows, csc_perm, csc_offsets, items, n_items,
      split_units, part_offsets, n_split, part_acc, part_c, src_base,
      slot_items, d_xs, d_att, d_w, partial, n_rel, d, stream);
}

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (8-byte
// aligned rows at D = 128 * NV; the wrapper checks).
extern "C" int kgwas_csc_segment_sum_bf16(
    const void* g, const void* w, const void* dz, const void* xs,
    const void* att, const void* csc_rows, const void* csc_perm,
    const void* csc_offsets, const void* items, long long n_items,
    const void* split_units, const void* part_offsets, long long n_split,
    void* part_acc, void* part_c, const long long* src_base,
    const long long* slot_items, void* d_xs, void* d_att, void* d_w,
    void* partial, int n_rel, int d, void* stream) {
  return segment_sum_entry<true>(
      g, w, dz, xs, att, csc_rows, csc_perm, csc_offsets, items, n_items,
      split_units, part_offsets, n_split, part_acc, part_c, src_base,
      slot_items, d_xs, d_att, d_w, partial, n_rel, d, stream);
}
