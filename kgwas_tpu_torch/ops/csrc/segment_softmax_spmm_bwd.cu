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
// float32 or bf16; out, g, mult float32), compile-time flags BF and LB:
// the float32 instance's arithmetic on widened operands (exact), as the
// TPU kernel's body is float32 throughout (its dmsgs and dlogits
// out_shapes). w and d_logits are written in float32. So it gives the
// float32 instance's bits on the operands widened to float32, under the
// same schedule. out is segment_softmax_spmm_fwd.cu's float32 output and g
// its float32 cotangent: a packed row's dot_r is formed from its edges,
// which equals out_r . g_r only for the forward's own out, so a rounded
// (bf16) out is not taken. Rows are read at 8 bytes a lane at D = 128,
// else a value a lane per 32 columns. Its bound: xs read at 2 bytes a
// value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kBwdMaxEdges;
using kgwas::kEps;
using kgwas::kExpClamp;
using kgwas::kFull;
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

  // batch b: U source rows of row k (a step past the row's end re-reads its
  // last edge, masked below) and g_k
  auto load = [&](R (&x)[U], R& gr, int b) {
    const unsigned e = s_b[b];
    const int v = e & ((1 << kRowShift) - 1);
    const int k = (e >> kRowShift) & 31;
    const int n = (e >> kCountShift) & 63;
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u].load(xs_table<BF>(a) +
                    static_cast<size_t>(s_src[v + min(u, n - 1)]) * d,
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

template <bool VEC, int NV, bool MULT, bool BF, bool LB>
cudaError_t launch_items(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  segment_softmax_spmm_bwd_kernel<VEC, NV, MULT, BF, LB>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
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

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (8-byte
// aligned rows at D = 128; the wrapper checks), logits bf16 when
// logits_bf16 != 0, else float32; out, g, w and d_logits float32.
extern "C" int kgwas_segment_softmax_spmm_bwd_bf16(
    const void* xs, const void* src, const void* logits, const void* mult,
    const void* row_offsets, const void* row_max, const void* row_sum,
    const void* out, const void* g, void* w, void* d_logits,
    const void* items, long long n_items, long long n_rows, int d,
    int logits_bf16, void* stream) {
  Args a = make_args(nullptr, src, logits_bf16 ? nullptr : logits, mult,
                     row_offsets, row_max, row_sum, out, g, w, d_logits,
                     items, n_items, n_rows, d);
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.logitsb =
      logits_bf16 ? static_cast<const __nv_bfloat16*>(logits) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logits_bf16 ? launch_bf16<true>(a, s) : launch_bf16<false>(a, s);
}
