// Merged-relation GAT layer forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_gat_layer.py::_make_fwd_kernel
// (launched by _merged_forward), fused with the source-row gather that the
// JAX package runs before it (gather_rows_csc's forward jnp.take,
// kgwas_tpu/ops/pallas_segment.py). Over one destination group's merged,
// dst-sorted CSR edge stream it computes, per row:
//
//   z_e   = att[slot] . xs[src_e] + a_dst[row]        slot = row / N
//   l_e   = leaky_relu(z_e, slope) / temperature
//   softmax: online max/sum from NEG_BIG, weight exp(min(l - m, 60)),
//            out = sum_e w_e xs[src_e] / (sum + 1e-16)
//   sigmoid: out = sum_e sigmoid(l_e) xs[src_e]
//   raw:     out = sum_e (l_e * temperature) xs[src_e]
//
// and saves row_max / row_sum for the backward. With fold = R the output is
// the cross-relation sum over the R slot rows r*N + n of node n.
//
// Design. A static schedule (gat_items.cuh, built once per layout on the
// host) balances the work: one warp per item, where an item packs the
// slot rows of several consecutive units (output rows) up to max_edges
// edges, or is one chunk (a slot row, or at most 512 edges of a longer
// one) of a unit with more edges. A trash node (up to 511 pad edges in
// each slot row) and any hub node are spread over many warps, whose chunks
// start first; a second, small launch merges each long unit's chunk
// partials (m, s, acc[D]) in part order by log-sum-exp and writes its
// output. A whole slot row per chunk keeps a trash row's sum of identical
// pad terms in the plain version's sequential order (shorter chunks round
// it differently, by more than rtol 1e-4 where a fold's slots cancel).
// The item's source indices are staged in shared memory, and its source
// rows reach the arithmetic through a two-stage ring of 8 rows each,
// filled with cp.async while the previous 8 are scored: 16 rows in flight
// per warp. Four lanes score each edge of a group (its dot with att[slot],
// columns in a rotated order free of bank conflicts), then the warp
// aggregates the group column-parallel (a float4 per lane at D = 128), the
// softmax state rescaled per edge. No float atomics: every sum has a fixed
// order and two runs give the same bits.
//
// What bounds it. Bytes at the bound: xs_all [S, D], src [E], row_offsets,
// a_dst, att, out, row_max and row_sum, each once (~0.04-0.08 ms per launch
// at the 200k-SNP synthetic KG, D = 128). The gather reads each edge's
// source row (0.7-0.9 GB per launch) from the 50 MB L2, which holds the
// tables; the ring keeps enough of them in flight, and what is left is the
// per-edge instruction stream of the warps (scoring, exp, D-wide FMAs).
//
// The bf16 instance (kgwas_merged_gat_fwd_bf16: xs bf16, everything else
// as above) computes what the TPU kernel computes on bf16 messages, at
// its rounding points: the score att . xs with att rounded to bf16, and
// each weight rounded to bf16 before it multiplies its message (products
// of two bf16 values are exact in float32; the sums are float32). The
// softmax weight is exp(min(l - row_max, 60)) against the row's max,
// known before the row is aggregated: so the instance makes two passes
// over its items, a first that scores every edge and writes each row's
// max (a chunked row's from its chunks' maxima, by a small launch), and a
// second that scores again and aggregates; the weights' sum is of the
// unrounded weights. exp and the divisions are the accurate ones (expf,
// IEEE division), as the plain version's. A warp gathers its edges' rows
// into registers, two batches of 4 in flight at D = 128 (8 bytes a lane:
// a bf16 row is 256 bytes), and sums each batch's dots in one transposing
// butterfly (warp_rows.cuh multi_sum). Its bound: the same bytes with
// 2-byte rows, twice the gather (the second pass mostly from L2).

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_items.cuh"
#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kFull;
using kgwas::kGroup;
using kgwas::kMaxCols;
using kgwas::kNegBig;
using kgwas::kEps;
using kgwas::kExpClamp;
using kgwas::kSoftmax;
using kgwas::kSigmoid;
using kgwas::kStages;

constexpr int kWarps = 4;  // warps per block

struct Args {
  const float* xs;          // [S, D]
  const int* src;           // [E]
  const int* row_offsets;   // [R*N + 1]
  const float* att;         // [R, D]
  const float* a_dst;       // [R*N]
  float* out;               // [N or R*N, D]
  float* row_max;           // [R*N]
  float* row_sum;           // [R*N]
  const int4* items;        // [n_items]
  const int* split_units;   // [n_split]
  const int* part_offsets;  // [n_split * F + 1]
  float* part_m;            // [n_parts]
  float* part_s;            // [n_parts]
  float* part_acc;          // [n_parts, D]
  long long n_items;
  long long n_split;
  long long n_rows_per_rel; // N
  int fold_slots;           // F: R (fold) or 1
  int d;
  float slope;
  float temperature;
  const __nv_bfloat16* xsb;  // [S, D]: the bf16 instance's table
};

// leaky_relu(a_src + a_dst) / temperature, the division folded into two
// multipliers (inv_t = 1/t, slope_t = slope/t)
__device__ __forceinline__ float edge_logit(float a_src, float a_dst,
                                            float slope_t, float inv_t) {
  const float z = a_src + a_dst;
  return z >= 0.0f ? z * inv_t : z * slope_t;
}

// a lane's columns of a shared-memory row
template <bool VEC, int NV>
__device__ __forceinline__ void load_shared(kgwas::Row<VEC, NV>& x,
                                            const float* row, int lane,
                                            int d) {
  if (VEC) {
    const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float4 q = p[k * 32 + lane];
      x.v[4 * k] = q.x;
      x.v[4 * k + 1] = q.y;
      x.v[4 * k + 2] = q.z;
      x.v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int c = lane + 32 * k;
      x.v[k] = c < d ? row[c] : 0.0f;
    }
  }
}

template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_fwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(w, a.n_items);

  const int d = a.d;
  const int F = a.fold_slots;
  const int rl = kgwas::row_len<VEC, NV>(d);
  float* ring = smem + static_cast<size_t>(warp) *
                           kgwas::warp_smem_floats(rl, 0, kgwas::kFwdMaxEdges, 0);
  int* s_src = reinterpret_cast<int*>(ring + kStages * kGroup * rl);
  int* s_beg = s_src + kgwas::kFwdMaxEdges;
  int* s_vbeg = s_beg + kgwas::kItemMaxRows;
  unsigned char* s_k = reinterpret_cast<unsigned char*>(
      s_vbeg + kgwas::kItemMaxRows);

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[item], a.row_offsets, a.n_rows_per_rel, F, lane);
  // a packed item's rows without edges: the plain version's NEG_BIG and 0
  if (!it.chunk && lane < it.n_rows && it.cnt == 0) {
    a.row_max[it.row] = kNegBig;
    a.row_sum[it.row] = 0.0f;
  }
  kgwas::stage_edges(it, a.src, s_beg, s_vbeg, s_src, s_k, lane);

  const float ad = lane < it.n_rows ? a.a_dst[it.row] : 0.0f;
  const float inv_t = 1.0f / a.temperature;
  const float slope_t = a.slope / a.temperature;
  const int q = lane >> 2, p = lane & 3;  // the edge this lane scores
  const int n_groups = (it.total + kGroup - 1) / kGroup;

  int cur = -1;              // the row being aggregated
  int next_unit = 0;         // units before it are stored
  float m = kNegBig, s = 0.0f;
  R acc, res;
  acc.zero();
  res.zero();

  // the row's state: its stats, and its share of the unit's output
  auto finish_row = [&](int k) {
    const long long row = __shfl_sync(kFull, it.row, k);
    if (it.chunk) {
      if (lane == 0) {
        a.part_m[it.part] = m;
        a.part_s[it.part] = s;
      }
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      return;
    }
    if (lane == 0) {
      a.row_max[row] = MODE == kSoftmax ? m : kNegBig;
      a.row_sum[row] = MODE == kSoftmax ? s : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < R::C; ++c)
      // division, not a multiply by the reciprocal: the same rounding as
      // the plain version's acc / (sum + eps)
      res.v[c] += MODE == kSoftmax ? acc.v[c] / (s + kEps) : acc.v[c];
  };
  // stores units next_unit..i-1 as zeros (no edges) and unit i as res
  auto store_unit = [&](int i) {
    R zero;
    zero.zero();
    for (; next_unit < i; ++next_unit)
      zero.store(a.out + (it.unit0 + next_unit) * d, lane, d);
    res.store(a.out + (it.unit0 + i) * d, lane, d);
    next_unit = i + 1;
    res.zero();
  };

  if (n_groups > 0)
    kgwas::load_group<VEC, NV>(ring, rl, 0, it.total, s_src, a.xs, lane, d);
  kgwas::cp_async_commit();
  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups)
      kgwas::load_group<VEC, NV>(ring, rl, g + 1, it.total, s_src, a.xs,
                                 lane, d);
    kgwas::cp_async_commit();
    kgwas::cp_async_wait<1>();  // group g has landed
    __syncwarp();
    const float* stage = ring + (g % kStages) * kGroup * rl;
    const int cnt = min(kGroup, it.total - g * kGroup);

    // score: lanes 4q..4q+3 take edge q of the group
    const int k = q < cnt ? s_k[g * kGroup + q] : 0;
    const int slot = __shfl_sync(kFull, it.slot, k);
    const float adk = __shfl_sync(kFull, ad, k);
    float dot = 0.0f, unused;
    if (q < cnt)
      kgwas::part_dots<VEC, NV, false>(stage + q * rl,
                                       a.att + static_cast<size_t>(slot) * d,
                                       nullptr, q, p, d, dot, unused);
    dot += __shfl_xor_sync(kFull, dot, 1);
    dot += __shfl_xor_sync(kFull, dot, 2);
    const float l_mine = edge_logit(dot, adk, slope_t, inv_t);

    // aggregate the group in edge order, column-parallel
    for (int e = 0; e < cnt; ++e) {
      const int ke = s_k[g * kGroup + e];  // warp-uniform
      if (ke != cur) {
        if (cur >= 0) {
          finish_row(cur);
          if (!it.chunk && ke / F != cur / F) store_unit(cur / F);
        }
        cur = ke;
        m = kNegBig;
        s = 0.0f;
        acc.zero();
      }
      const float l = __shfl_sync(kFull, l_mine, 4 * e);
      R x;
      load_shared<VEC, NV>(x, stage + e * rl, lane, d);
      if (MODE == kSoftmax) {
        const float m_new = fmaxf(m, l);
        const float scale = fast_exp(m - m_new);
        const float w = fast_exp(fminf(l - m_new, kExpClamp));
        s = fmaf(s, scale, w);
#pragma unroll
        for (int c = 0; c < R::C; ++c)
          acc.v[c] = fmaf(w, x.v[c], acc.v[c] * scale);
        m = m_new;
      } else {
        const float w = MODE == kSigmoid ? 1.0f / (1.0f + fast_exp(-l))
                                         : l * a.temperature;
#pragma unroll
        for (int c = 0; c < R::C; ++c) acc.v[c] = fmaf(w, x.v[c], acc.v[c]);
      }
    }
    __syncwarp();  // the stage is read before it is loaded again
  }
  if (cur >= 0) {
    finish_row(cur);
    if (!it.chunk) store_unit(cur / F);
  }
  if (!it.chunk) {
    R zero;
    zero.zero();
    for (; next_unit < it.n_units; ++next_unit)
      zero.store(a.out + (it.unit0 + next_unit) * d, lane, d);
  }
}

// One warp per unit cut into chunks: per slot row the log-sum-exp merge of
// its parts in part order (or their plain sum), then the row's division and
// the fold's sum over the unit's slot rows.
template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_combine_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= a.n_split) return;
  const int d = a.d;
  const int F = a.fold_slots;
  const long long u = a.split_units[j];
  R res;
  res.zero();
  for (int r = 0; r < F; ++r) {
    const long long row = F > 1 ? r * a.n_rows_per_rel + u : u;
    const int p0 = a.part_offsets[j * F + r];
    const int p1 = a.part_offsets[j * F + r + 1];
    float mx, sum;
    R acc;
    kgwas::merge_parts<VEC, NV, MODE == kSoftmax>(
        a.part_m, a.part_s, a.part_acc, p0, p1, lane, d, mx, sum, acc);
#pragma unroll
    for (int c = 0; c < R::C; ++c)
      res.v[c] += MODE == kSoftmax ? acc.v[c] / (sum + kEps) : acc.v[c];
    if (lane == 0) {
      a.row_max[row] = mx;
      a.row_sum[row] = sum;
    }
  }
  res.store(a.out + u * d, lane, d);
}

template <int MODE, bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int rl = kgwas::row_len<VEC, NV>(a.d);
  const size_t smem =
      sizeof(float) * kWarps * kgwas::warp_smem_floats(rl, 0, kgwas::kFwdMaxEdges, 0);
  if (blocks > 0) {
    auto kern = merged_gat_fwd_kernel<MODE, VEC, NV>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kern<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (cblocks > 0) {
    merged_gat_combine_kernel<MODE, VEC, NV>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <int MODE>
cudaError_t dispatch_width(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch<MODE, true, 1>(a, stream);
    case 256: return launch<MODE, true, 2>(a, stream);
    case 384: return launch<MODE, true, 3>(a, stream);
    case 512: return launch<MODE, true, 4>(a, stream);
    default:
      if (a.d <= 32 * kMaxCols) return launch<MODE, false, 1>(a, stream);
      return cudaErrorInvalidValue;
  }
}

// ---- the bf16 instance

constexpr int kPhaseMax = 0;  // score every edge, write each row's max
constexpr int kPhaseAgg = 1;  // score again and aggregate

// the logit of the bf16 instance: leaky_relu(z) / temperature, as the
// plain version divides
__device__ __forceinline__ float edge_logit_bf16(float z, float slope,
                                                 float t) {
  return (z >= 0.0f ? z : slope * z) / t;
}

template <int MODE, bool VEC, int NV, int PHASE>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_fwd_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  constexpr int E = kgwas::kFwdMaxEdges;
  __shared__ int s_src_w[kWarps][E];
  __shared__ int s_beg_w[kWarps][kgwas::kItemMaxRows];
  __shared__ int s_vbeg_w[kWarps][kgwas::kItemMaxRows];
  __shared__ unsigned char s_k_w[kWarps][E];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(w, a.n_items);
  int* s_src = s_src_w[warp];
  unsigned char* s_k = s_k_w[warp];
  const int d = a.d;
  const int F = a.fold_slots;

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[item], a.row_offsets, a.n_rows_per_rel, F, lane);
  if (PHASE == kPhaseAgg && !it.chunk && lane < it.n_rows && it.cnt == 0) {
    a.row_max[it.row] = kNegBig;
    a.row_sum[it.row] = 0.0f;
  }
  kgwas::stage_edges(it, a.src, s_beg_w[warp], s_vbeg_w[warp], s_src, s_k,
                     lane);
  const float ad = lane < it.n_rows ? a.a_dst[it.row] : 0.0f;

  int att_slot = -1;  // the slot whose rounded att row is in attr
  R attr;
  int cur = -1;       // the row being scored or aggregated
  int next_unit = 0;  // units before it are stored
  float m = kNegBig, s = 0.0f;
  R acc, res;
  acc.zero();
  res.zero();

  auto finish_row = [&](int k) {
    const long long row = __shfl_sync(kFull, it.row, k);
    if (PHASE == kPhaseMax) {
      if (lane == 0) {
        if (it.chunk)
          a.part_m[it.part] = m;
        else
          a.row_max[row] = m;
      }
      return;
    }
    if (it.chunk) {
      if (lane == 0) {
        a.part_m[it.part] = m;
        a.part_s[it.part] = s;
      }
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      return;
    }
    if (lane == 0) {
      a.row_max[row] = MODE == kSoftmax ? m : kNegBig;
      a.row_sum[row] = MODE == kSoftmax ? s : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < R::C; ++c)
      res.v[c] += MODE == kSoftmax ? acc.v[c] / (s + kEps) : acc.v[c];
  };
  auto store_unit = [&](int i) {
    R zero;
    zero.zero();
    for (; next_unit < i; ++next_unit)
      zero.store(a.out + (it.unit0 + next_unit) * d, lane, d);
    res.store(a.out + (it.unit0 + i) * d, lane, d);
    next_unit = i + 1;
    res.zero();
  };
  // a new row k: its softmax max (the first pass's) when aggregating
  auto start_row = [&](int k) {
    cur = k;
    s = 0.0f;
    acc.zero();
    m = kNegBig;
    if (PHASE == kPhaseAgg && MODE == kSoftmax)
      m = a.row_max[__shfl_sync(kFull, it.row, k)];
  };

  // the U edges v..v+U-1 of batch x: their scores, then each edge in turn
  auto take = [&](const R (&x)[U], int v) {
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = s_k[min(v + u, it.total - 1)];  // warp-uniform
      const int slot = __shfl_sync(kFull, it.slot, k);
      if (slot != att_slot) {
        attr.load(a.att + static_cast<size_t>(slot) * d, lane, d);
#pragma unroll
        for (int c = 0; c < R::C; ++c) attr.v[c] = kgwas::round_bf16(attr.v[c]);
        att_slot = slot;
      }
      p[u] = kgwas::row_dot(x[u], attr);
    }
    const float tot = kgwas::multi_sum<U>(p, lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int vu = v + u;
      const float dot = __shfl_sync(kFull, tot, u * (32 / U));
      if (vu >= it.total) continue;  // warp-uniform
      const int k = s_k[vu];
      if (k != cur) {
        if (cur >= 0) {
          finish_row(cur);
          if (PHASE == kPhaseAgg && !it.chunk && k / F != cur / F)
            store_unit(cur / F);
        }
        start_row(k);
      }
      const float l = edge_logit_bf16(dot + __shfl_sync(kFull, ad, k),
                                      a.slope, a.temperature);
      if (PHASE == kPhaseMax) {
        m = fmaxf(m, l);
        continue;
      }
      float wt;
      if (MODE == kSoftmax) {
        wt = expf(fminf(l - m, kExpClamp));
        s += wt;
      } else {
        wt = MODE == kSigmoid ? 1.0f / (1.0f + expf(-l)) : l * a.temperature;
      }
      const float alpha = kgwas::round_bf16(wt);
#pragma unroll
      for (int c = 0; c < R::C; ++c)
        acc.v[c] = fmaf(alpha, x[u].v[c], acc.v[c]);
    }
  };

  // two batches in flight: one is scored while the other arrives
  R xa[U], xb[U];
  if (it.total > 0)
    kgwas::gather_rows<VEC, NV, U>(xa, a.xsb, s_src, 0, it.total, lane, d);
  for (int v = 0; v < it.total; v += 2 * U) {
    if (v + U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xb, a.xsb, s_src, v + U, it.total, lane,
                                     d);
    take(xa, v);
    if (v + 2 * U < it.total)
      kgwas::gather_rows<VEC, NV, U>(xa, a.xsb, s_src, v + 2 * U, it.total,
                                     lane, d);
    if (v + U < it.total) take(xb, v + U);
  }
  if (cur >= 0) {
    finish_row(cur);
    if (PHASE == kPhaseAgg && !it.chunk) store_unit(cur / F);
  }
  if (PHASE == kPhaseAgg && !it.chunk) {
    R zero;
    zero.zero();
    for (; next_unit < it.n_units; ++next_unit)
      zero.store(a.out + (it.unit0 + next_unit) * d, lane, d);
  }
}

// The max of each chunked slot row, from its chunks' maxima: one thread
// per slot row of a unit cut into chunks.
__global__ void __launch_bounds__(128) merged_gat_row_max_kernel(const Args a) {
  const long long jr = static_cast<long long>(blockIdx.x) * 128 + threadIdx.x;
  const int F = a.fold_slots;
  if (jr >= a.n_split * F) return;
  const long long u = a.split_units[jr / F];
  const long long row = F > 1 ? (jr % F) * a.n_rows_per_rel + u : u;
  float m = kNegBig;
  for (int pi = a.part_offsets[jr]; pi < a.part_offsets[jr + 1]; ++pi)
    m = fmaxf(m, a.part_m[pi]);
  a.row_max[row] = m;
}

template <int MODE, bool VEC, int NV>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  const long long mblocks = (a.n_split * a.fold_slots + 127) / 128;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err;
  if (MODE == kSoftmax) {
    merged_gat_fwd_bf16_kernel<MODE, VEC, NV, kPhaseMax>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (mblocks > 0) {
      merged_gat_row_max_kernel<<<static_cast<unsigned>(mblocks), 128, 0,
                                  stream>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  merged_gat_fwd_bf16_kernel<MODE, VEC, NV, kPhaseAgg>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (cblocks > 0) {
    merged_gat_combine_kernel<MODE, VEC, NV>
        <<<static_cast<unsigned>(cblocks), kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <int MODE>
cudaError_t dispatch_width_bf16(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 128: return launch_bf16<MODE, true, 1>(a, stream);
    case 256: return launch_bf16<MODE, true, 2>(a, stream);
    case 384: return launch_bf16<MODE, true, 3>(a, stream);
    case 512: return launch_bf16<MODE, true, 4>(a, stream);
    default:
      if (a.d <= 32 * kMaxCols) return launch_bf16<MODE, false, 1>(a, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; xs, att, out, part_acc and items must be 16-byte aligned (the
// wrapper checks). mode: 0 softmax, 1 sigmoid, 2 raw. The schedule (items,
// split_units, part_offsets) and the scratch part_* come from the wrapper;
// two launches: the items, then the combine of the chunked units.
extern "C" int kgwas_merged_gat_fwd(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, void* out, void* row_max, void* row_sum,
    const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_m, void* part_s,
    void* part_acc, long long n_rows_per_rel, int fold_slots, int d, int mode,
    float slope, float temperature, void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.xsb = nullptr;
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.att = static_cast<const float*>(att);
  a.a_dst = static_cast<const float*>(a_dst);
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
  a.n_rows_per_rel = n_rows_per_rel;
  a.fold_slots = fold_slots;
  a.d = d;
  a.slope = slope;
  a.temperature = temperature;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kgwas::kSoftmax: return dispatch_width<kgwas::kSoftmax>(a, s);
    case kgwas::kSigmoid: return dispatch_width<kgwas::kSigmoid>(a, s);
    case kgwas::kRaw: return dispatch_width<kgwas::kRaw>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (8-byte
// aligned rows at D = 128 * NV; the wrapper checks). Up to four launches:
// with softmax the first pass and the chunked rows' maxima, then the
// second pass and the combine of the chunked units.
extern "C" int kgwas_merged_gat_fwd_bf16(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, void* out, void* row_max, void* row_sum,
    const void* items, long long n_items, const void* split_units,
    const void* part_offsets, long long n_split, void* part_m, void* part_s,
    void* part_acc, long long n_rows_per_rel, int fold_slots, int d, int mode,
    float slope, float temperature, void* stream) {
  Args a;
  a.xs = nullptr;
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.att = static_cast<const float*>(att);
  a.a_dst = static_cast<const float*>(a_dst);
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
  a.n_rows_per_rel = n_rows_per_rel;
  a.fold_slots = fold_slots;
  a.d = d;
  a.slope = slope;
  a.temperature = temperature;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kgwas::kSoftmax: return dispatch_width_bf16<kgwas::kSoftmax>(a, s);
    case kgwas::kSigmoid: return dispatch_width_bf16<kgwas::kSigmoid>(a, s);
    case kgwas::kRaw: return dispatch_width_bf16<kgwas::kRaw>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
