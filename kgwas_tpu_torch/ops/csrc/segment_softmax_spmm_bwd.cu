// Backward of segment_softmax_spmm_fwd.cu, edge half, for Hopper (sm_90a),
// plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_bwd_kernel
// (launched by _fused_backward, the VJP of fused_segment_softmax_spmm). With
// g the cotangent of the forward's output and the forward's saved out,
// row_max and row_sum, per edge e of row r:
//
//   p_e       = exp(min(l_e - lse_r, 60)),  lse_r = row_max_r + log(row_sum_r + 1e-16)
//   m_e       = xs[src_e] . g_r
//   dot_r     = out_r . g_r  (the TPU's formula)  =  sum_e p_e m_e
//   d_logit_e = p_e (m_e - dot_r)
//
// and writes two scalars per edge, w_e = p_e and d_logit_e. With the
// forward's per-edge multiplier mult (a compile-time flag, MULT: a launch
// without it runs the kernel as it was), out_r = sum_e p_e mult_e xs[src_e]
// and
//
//   w_e = p_e mult_e,  dot_r = sum_e p_e mult_e m_e,
//   d_logit_e = p_e (mult_e m_e - dot_r).
// The TPU kernel
// also writes the [E, D] message cotangent d_msgs_e = p_e g_r; this kernel
// does not: csc_segment_sum.cu (without logit term) forms p_e g_r in
// registers while it walks the relation's CSC and sums d_xs per source row.
//
// Design. The forward's static schedule of the relation's rows
// (gat_items.cuh, ops/schedule.py row_schedule, kept on the relation's
// DeviceLayout) gives each warp one item: up to 32 consecutive rows with at
// most max_edges edges together, or one chunk of a longer row (a relation's
// trash row with up to 511 pad edges, a hub). Every output is per edge, so
// a chunk writes its own edges: no partials and no second launch. The warp
// stages the item's source indices and logits in shared memory, forms each
// row's log-sum-exp once (a lane a row) and each edge's p_e once, then
// gathers the source rows into registers in batches of U edges of one row
// (4 at D = 128) together with that row's g_r, two batches in flight, one
// reduced while the other arrives: a row's g_r is read once per batch, not
// once per edge. The U products x_u . g_r of a batch reduce across the warp
// in one transposing butterfly (log2 U halving exchanges, then the rest:
// 6 shuffles for 4 edges where a butterfly each would take 20), and m_e
// goes to shared memory. (Lane groups, 8 lanes x 16 floats an edge and 3
// shuffles, hold 16 floats of g_r per batch instead of 4: 94 registers, 16
// warps per SM, and 4-8% slower per GAT-max step, PERF.md.) Last, each row's dot_r, then w_e and d_logit_e for
// every edge of the item, written by consecutive lanes.
//
// dot_r. Inside a packed item the row is whole, so dot_r = sum_e p_e m_e
// comes from the m_e already in shared memory (a segmented sum in a fixed
// order), and the saved output is not read there: one 512-byte row per row,
// from device memory, beside the row's g_r (the SNP rows hold about 3.5
// edges each, from an L2-held table). A chunk sees part of its row and
// takes the TPU's formula, out_r . g_r. Both are the same value in exact
// arithmetic (out_r = sum_e p_e xs[src_e]); the plain version keeps the
// TPU's formula. Measured at full width (PERF.md), the edge-formed dot_r
// saved 7.7% of the earlier one-warp-per-row kernel's device time per
// GAT-max step (its out read dropped) and 10.9-11.4% of this design's
// (against out_r . g_r on every row).
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], out and g [n_rows, D], src and logits [E], row_offsets,
// row_max and row_sum [n_rows], w and d_logits [E]; of out, only the
// chunked rows), against 2 D flops per edge and per row. The gather reads
// each source row once per edge (512 bytes at D = 128), from the 50 MB L2
// when the table fits, else from device memory: gather_probe.cu's rate for
// that gather is the floor the design aims at. No atomics: two runs give
// the same bits.
//
// The bf16 instance (kgwas_segment_softmax_spmm_bwd_bf16: xs bf16, logits
// float32 or bf16; out, g, mult float32), compile-time flag LB: the
// float32 instance's arithmetic on widened operands (exact), as the TPU
// kernel's body is float32 throughout (its dmsgs and dlogits out_shapes).
// w and d_logits are written in float32. out is
// segment_softmax_spmm_fwd.cu's float32 output and g its float32
// cotangent: a packed row's dot_r is formed from its edges, which equals
// out_r . g_r only for the forward's own out, so a rounded (bf16) out is
// not taken. Its bound: xs read at 2 bytes a value.
//
// Its design differs from the float32 one, whose batches of 4 edges of one
// row, two in flight in registers, left the instance 6% below the float32
// one on half the bytes, and whose short batches (the SNP-side relations
// hold 1-6 edges a row) re-read a row from device memory and re-read g_r
// with every batch. One warp still takes one item (blocks of 4 warps), but
// its bf16 source rows come through a cp.async ring of kRingStages stages
// of kGroup rows in shared memory (gat_items.cuh EdgeRing), 16 bytes a
// lane at D = 128 * NV, a lane's copies unrolled, fed by edge: every slot
// carries a real row. A row's edges are taken in batches from the ring: 8
// while more than 4 are left, else 4, a batch's slots past the row's end
// adding 0, so that a short batch reads nothing more. g_r is read once per
// row (evict first: it is read once), the next row's while this one's
// batches are summed. Each m_e is the same lane dot over the same columns
// as the float32 instance's, summed across the lanes by multi_sum, whose
// total for an edge is the full butterfly over offsets 16, 8, 4, 2, 1 of
// that edge's lane values whatever the batch's width or other edges: the
// instance keeps the float32 instance's bits on the widened operands. The
// item's arrays live in dynamic shared memory sized by the schedule's
// largest item (item_edges), as segment_softmax_spmm_fwd.cu's bf16
// instance sizes them. At D = 128, 56 registers (64 with the multiplier)
// and 6 KB of shared memory a warp leave 36 warps on each SM. The kernel
// is bound by the instructions an edge takes (PERF.md, the full-width
// streams): more stages, or deeper loads of g, cost warps and were slower;
// the unrolled ring fill and the 8-edge batches gained most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kBwdMaxEdges;
using kgwas::kEps;
using kgwas::kExpClamp;
using kgwas::kFull;
using kgwas::kGroup;
using kgwas::kItemMaxRows;
using kgwas::kMaxCols;
using kgwas::multi_sum;
using kgwas::row_dot;

constexpr int kWarps = 8;  // warps per block
// a batch's entry: its first virtual edge, its row (item slot) and edges
constexpr int kRowShift = 9, kCountShift = 14;

struct Args {
  const float* xs;         // [S, D]
  const int* src;          // [E]
  const float* logits;     // [E]
  const float* mult;       // [E], or null (MULT = false)
  const int* row_offsets;  // [n_rows + 1]
  const float* row_max;    // [n_rows]
  const float* row_sum;    // [n_rows]
  const float* out;        // [n_rows, D]
  const float* g;          // [n_rows, D]
  float* w;                // [E]
  float* d_logits;         // [E]
  const int4* items;       // [n_items]
  long long n_items;
  long long n_rows;
  int d;
  const __nv_bfloat16* xsb;      // [S, D]: the bf16 instance's table
  const __nv_bfloat16* logitsb;  // [E]: its bf16 logits (LB)
  int item_edges;  // the bf16 instance: the most edges of an item, a
                   // multiple of 4 (its staging arrays' length)
};

template <bool VEC, int NV, bool MULT>
__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_spmm_bwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  constexpr int kMaxBatches = kBwdMaxEdges / U + kItemMaxRows;
  __shared__ int s_src_w[kWarps][kBwdMaxEdges];
  __shared__ float s_p_w[kWarps][kBwdMaxEdges];  // logits, then p_e
  __shared__ float s_m_w[kWarps][kBwdMaxEdges];  // m_e
  __shared__ unsigned s_b_w[kWarps][kMaxBatches];
  __shared__ unsigned char s_k_w[kWarps][kBwdMaxEdges];
  __shared__ float s_lse_w[kWarps][kItemMaxRows];
  __shared__ float s_dot_w[kWarps][kItemMaxRows];
  __shared__ float s_mult_w[kWarps][MULT ? kBwdMaxEdges : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(w, a.n_items);
  int* s_src = s_src_w[warp];
  float* s_p = s_p_w[warp];
  float* s_m = s_m_w[warp];
  unsigned* s_b = s_b_w[warp];
  unsigned char* s_k = s_k_w[warp];
  float* s_lse = s_lse_w[warp];
  float* s_dot = s_dot_w[warp];
  float* s_mult = s_mult_w[warp];
  const int d = a.d;

  const kgwas::ItemRows it =
      kgwas::item_rows(a.items[item], a.row_offsets, a.n_rows, 1, lane);
  if (it.total == 0) return;  // rows without edges: nothing to write
  if (lane < it.n_rows) {
    s_lse[lane] = a.row_max[it.row] + logf(a.row_sum[it.row] + kEps);
    s_dot[lane] = 0.0f;
  }
  // the batches: lane k's row in ceil(cnt / U) runs of up to U edges
  int n_batches;
  {
    const int nb = (it.cnt + U - 1) / U;
    int x = nb;  // inclusive scan of the batch counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    for (int j = 0; j < nb; ++j) {
      const int v = it.vbeg + j * U;
      s_b[x - nb + j] =
          v | (lane << kRowShift) | (min(U, it.cnt - j * U) << kCountShift);
    }
    n_batches = __shfl_sync(kFull, x, 31);
  }
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

  // batch b: U source rows of row k (a step past the row's end re-reads its
  // last edge, masked below) and g_k
  auto load = [&](R (&x)[U], R& gr, int b) {
    const unsigned e = s_b[b];
    const int v = e & ((1 << kRowShift) - 1);
    const int k = (e >> kRowShift) & 31;
    const int n = (e >> kCountShift) & 63;
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u].load(a.xs + static_cast<size_t>(s_src[v + min(u, n - 1)]) * d,
                lane, d);
    gr.load(a.g + (it.unit0 + k) * d, lane, d);
  };
  auto take = [&](const R (&x)[U], const R& gr, int b) {
    const unsigned e = s_b[b];
    const int v = e & ((1 << kRowShift) - 1);
    const int n = (e >> kCountShift) & 63;
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = row_dot(x[u], gr);
    const float m = multi_sum<U>(p, lane);
    const int j = lane / (32 / U);
    if (lane % (32 / U) == 0 && j < n) s_m[v + j] = m;
  };
  R xa[U], xb[U], ga, gb;
  load(xa, ga, 0);
  if (it.chunk) {  // warp-uniform: a chunk's dot_r = out_r . g_r
    R ov, gr;
    ov.load(a.out + it.row * d, lane, d);
    gr.load(a.g + it.row * d, lane, d);
    float q = row_dot(ov, gr);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(kFull, q, off);
    if (lane == 0) s_dot[0] = q;
  }
  // each edge's weight while the first batch arrives
  for (int v = lane; v < it.total; v += 32)
    s_p[v] = fast_exp(fminf(s_p[v] - s_lse[s_k[v]], kExpClamp));
  // two batches in flight: one is reduced while the other arrives
  for (int b = 0; b < n_batches; b += 2) {
    if (b + 1 < n_batches) load(xb, gb, b + 1);
    take(xa, ga, b);
    if (b + 2 < n_batches) load(xa, ga, b + 2);
    if (b + 1 < n_batches) take(xb, gb, b + 1);
  }
  __syncwarp();
  if (!it.chunk) {  // dot_r = sum_e p_e (mult_e) m_e over each whole row
    for (int base = 0; base < it.total; base += 32) {
      const int v = base + lane;
      const bool ok = v < it.total;
      const float e = !ok    ? 0.0f
                      : MULT ? s_p[v] * s_mult[v] * s_m[v]
                             : s_p[v] * s_m[v];
      kgwas::segmented_add(e, ok ? s_k[v] : 255, s_dot, lane);
    }
  }
  for (int v = lane; v < it.total; v += 32) {
    const float p = s_p[v];
    if (MULT) {
      const float mu = s_mult[v];
      a.w[first + v] = p * mu;
      a.d_logits[first + v] = p * (mu * s_m[v] - s_dot[s_k[v]]);
    } else {
      a.w[first + v] = p;
      a.d_logits[first + v] = p * (s_m[v] - s_dot[s_k[v]]);
    }
  }
}

template <bool VEC, int NV, bool MULT>
cudaError_t launch_items(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  segment_softmax_spmm_bwd_kernel<VEC, NV, MULT>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.mult != nullptr ? launch_items<VEC, NV, true>(a, stream)
                           : launch_items<VEC, NV, false>(a, stream);
}

// ---- the bf16 instance: rows through a cp.async ring

constexpr int kBf16Warps = 4;  // warps per block
// ring stages of kGroup rows (3 and 4 stages cost warps an SM and
// measured slower at full width, PERF.md)
constexpr int kRingStages = 2;
// edges of one row reduced together: kBatch, or 2 kBatch while more than
// kBatch of the row are left
constexpr int kBatch = 4;

// A warp's item in shared memory, E = the most edges of an item in the
// schedule (a multiple of 4).
struct Staged {
  int* src;          // [E] each edge's source row
  float* p;          // [E] its logit, then its weight p_e
  float* m;          // [E] m_e
  float* mult;       // [E] its multiplier (MULT)
  float* lse;        // [kItemMaxRows] each row's log-sum-exp
  float* dot;        // [kItemMaxRows] each row's dot_r
  unsigned char* k;  // [E] each edge's row in the item
};

// shared memory of one warp in 32-bit words: the ring (kRingStages stages
// of kGroup rows of rw words), then the item's arrays for items of at most
// e edges, rounded up to 16 bytes (the next warp's ring takes 16-byte
// copies)
__host__ __device__ constexpr int bf16_warp_words(int rw, int e, bool mult) {
  return (kRingStages * kGroup * rw + (mult ? 4 : 3) * e + 2 * kItemMaxRows +
          e / 4 + 3) / 4 * 4;
}

template <bool MULT>
__device__ __forceinline__ Staged staged_at(unsigned* base, int e) {
  Staged st;
  st.src = reinterpret_cast<int*>(base);
  st.p = reinterpret_cast<float*>(base + e);
  st.m = reinterpret_cast<float*>(base + 2 * e);
  st.mult = reinterpret_cast<float*>(base + 3 * e);
  st.lse = reinterpret_cast<float*>(base + (MULT ? 4 : 3) * e);
  st.dot = st.lse + kItemMaxRows;
  st.k = reinterpret_cast<unsigned char*>(st.dot + kItemMaxRows);
  return st;
}

// One warp per item: its edges staged (each edge's row, source row and
// logit, widened from bf16 when LB, and multiplier), the ring's first S
// groups put in flight, each edge's weight taken while they land, then the
// rows with edges in order: row k's g_k (loaded while row k - 1 was
// summed) against its edges in batches of kBatch from the ring, the next
// row's g loaded meanwhile. Then dot_r, w_e and d_logit_e as the float32
// kernel forms them.
template <bool VEC, int NV, bool MULT, bool LB>
__global__ void __launch_bounds__(kBf16Warps * 32, VEC && NV == 1 ? 6 : 1)
segment_softmax_spmm_bwd_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int S = kRingStages;
  constexpr int U = kBatch;
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
  if (it.total == 0) return;  // rows without edges: nothing to write
  if (lane < it.n_rows) {
    st.lse[lane] = a.row_max[it.row] + logf(a.row_sum[it.row] + kEps);
    st.dot[lane] = 0.0f;
  }
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

  kgwas::EdgeRing<VEC, NV, S> ring_rows(ring, rw, it.total, st.src, a.xsb,
                                        lane, d);
  ring_rows.start();
  // the rows with edges in order (a chunk: its one row)
  unsigned rows = __ballot_sync(kFull, lane < it.n_rows && it.cnt > 0);
  auto next_row = [&]() {  // -1 past the last
    const int k = __ffs(rows) - 1;
    rows &= rows - 1;
    return k;
  };
  auto load_g = [&](R& g, int k) {  // read once: evict first
    if (k >= 0) g.load_once(a.g + (it.unit0 + k) * d, lane, d);
  };
  // m_e of edges v .. v + n - 1 of one row (n <= UB) against its g: one
  // batch of UB slots, the slots past n adding 0
  auto batch = [&](auto width, int v, int n, const R& g) {
    constexpr int UB = decltype(width)::value;
    ring_rows.ready(v + n - 1);
    float p[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      p[u] = 0.0f;
      if (u < n) {
        R x;
        kgwas::load_ring_bf16<VEC, NV>(x, ring_rows.row(v + u), lane, d);
        p[u] = row_dot(x, g);
      }
    }
    const float m = multi_sum<UB>(p, lane);
    const int j = lane / (32 / UB);
    if (lane % (32 / UB) == 0 && j < n) st.m[v + j] = m;
    ring_rows.release(v + n);
  };
  int k = next_row();
  R gr;
  load_g(gr, k);
  if (it.chunk) {  // warp-uniform: a chunk's dot_r = out_r . g_r
    R ov;
    ov.load(a.out + it.row * d, lane, d);
    float q = row_dot(ov, gr);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(kFull, q, off);
    if (lane == 0) st.dot[0] = q;
  }
  // each edge's weight while the first groups arrive
  for (int v = lane; v < it.total; v += 32)
    st.p[v] = fast_exp(fminf(st.p[v] - st.lse[st.k[v]], kExpClamp));
  for (;;) {  // warp-uniform; the next row's g loaded meanwhile
    const int next = next_row();
    R gn;
    load_g(gn, next);
    const int v0 = __shfl_sync(kFull, it.vbeg, k);
    const int v1 = v0 + __shfl_sync(kFull, it.cnt, k);
    for (int v = v0; v < v1;) {
      const int n = v1 - v;
      if (n > U) {
        batch(std::integral_constant<int, 2 * U>(), v, min(n, 2 * U), gr);
        v += 2 * U;
      } else {
        batch(std::integral_constant<int, U>(), v, min(n, U), gr);
        v += U;
      }
    }
    if (next < 0) break;
    k = next;
    gr = gn;
  }
  kgwas::cp_async_wait<0>();
  __syncwarp();
  if (!it.chunk) {  // dot_r = sum_e p_e (mult_e) m_e over each whole row
    for (int base = 0; base < it.total; base += 32) {
      const int v = base + lane;
      const bool ok = v < it.total;
      const float e = !ok    ? 0.0f
                      : MULT ? st.p[v] * st.mult[v] * st.m[v]
                             : st.p[v] * st.m[v];
      kgwas::segmented_add(e, ok ? st.k[v] : 255, st.dot, lane);
    }
  }
  for (int v = lane; v < it.total; v += 32) {
    const float p = st.p[v];
    if (MULT) {
      const float mu = st.mult[v];
      a.w[first + v] = p * mu;
      a.d_logits[first + v] = p * (mu * st.m[v] - st.dot[st.k[v]]);
    } else {
      a.w[first + v] = p;
      a.d_logits[first + v] = p * (st.m[v] - st.dot[st.k[v]]);
    }
  }
}

template <bool VEC, int NV, bool MULT, bool LB>
cudaError_t launch_items_bf16(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kBf16Warps - 1) / kBf16Warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  const int rw = kgwas::row_words_bf16<VEC, NV>(a.d);
  const size_t smem = sizeof(unsigned) * kBf16Warps *
                      bf16_warp_words(rw, a.item_edges, MULT);
  auto kern = segment_softmax_spmm_bwd_bf16_kernel<VEC, NV, MULT, LB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), kBf16Warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC, int NV, bool LB>
cudaError_t launch_mult_bf16(const Args& a, cudaStream_t stream) {
  return a.mult != nullptr ? launch_items_bf16<VEC, NV, true, LB>(a, stream)
                           : launch_items_bf16<VEC, NV, false, LB>(a, stream);
}

// the bf16 instance's widths: 16-byte ring copies at D = 128 * NV (the
// float32 instance's columns a lane), else 4 bytes a lane
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
               const void* mult, const void* row_offsets,
               const void* row_max, const void* row_sum, const void* out,
               const void* g, void* w, void* d_logits, const void* items,
               long long n_items, long long n_rows, int d) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.src = static_cast<const int*>(src);
  a.logits = static_cast<const float*>(logits);
  a.mult = static_cast<const float*>(mult);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.row_max = static_cast<const float*>(row_max);
  a.row_sum = static_cast<const float*>(row_sum);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.w = static_cast<float*>(w);
  a.d_logits = static_cast<float*>(d_logits);
  a.items = static_cast<const int4*>(items);
  a.n_items = n_items;
  a.n_rows = n_rows;
  a.d = d;
  a.xsb = a.logitsb = nullptr;
  a.item_edges = 0;
  return a;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; xs, out, g and items must be 16-byte aligned (the wrapper
// checks); mult may be null (every multiplier 1). items is the relation's
// row schedule (ops/schedule.py row_schedule), at most kBwdMaxEdges edges
// an item.
extern "C" int kgwas_segment_softmax_spmm_bwd(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, const void* row_max, const void* row_sum,
    const void* out, const void* g, void* w, void* d_logits,
    const void* items, long long n_items, long long n_rows, int d,
    void* stream) {
  const Args a = make_args(xs, src, logits, mult, row_offsets, row_max,
                           row_sum, out, g, w, d_logits, items, n_items,
                           n_rows, d);
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
// bf16 when logits_bf16 != 0, else float32; out, g, w and d_logits
// float32; item_edges the most edges of an item of the schedule (1 to
// kBwdMaxEdges), which sizes each warp's arrays in shared memory.
extern "C" int kgwas_segment_softmax_spmm_bwd_bf16(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, const void* row_max, const void* row_sum,
    const void* out, const void* g, void* w, void* d_logits,
    const void* items, long long n_items, long long n_rows, int d,
    int logits_bf16, int item_edges, void* stream) {
  if (item_edges < 1 || item_edges > kBwdMaxEdges)
    return cudaErrorInvalidValue;
  Args a = make_args(nullptr, src, logits_bf16 ? nullptr : logits, mult,
                     row_offsets, row_max, row_sum, out, g, w, d_logits,
                     items, n_items, n_rows, d);
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.logitsb =
      logits_bf16 ? static_cast<const __nv_bfloat16*>(logits) : nullptr;
  a.item_edges = (item_edges + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logits_bf16 ? launch_bf16<true>(a, s) : launch_bf16<false>(a, s);
}
