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
// known before the row is aggregated; the weights' sum is of the
// unrounded weights. exp and the divisions are the accurate ones (expf,
// IEEE division), as the plain version's.
//
// The score depends on the source row alone: slot r owns the rows
// src_base[r] .. src_base[r+1] of the table, so a first pass
// (kgwas_merged_gat_a_src_bf16, one launch per layer forward, whose
// result the backward reuses) takes one dot per source row, a_src[s] =
// bf16(att[slot(s)]) . xs[s], with the lanes' columns and the transposing
// butterfly (warp_rows.cuh row_dot, multi_sum) the per-edge dot had: the
// Gene group's 457,728 rows against its 1,781,760 edges. The item kernel
// then reads 4 bytes an edge to form every logit and each packed row's
// max before it gathers any row (a chunked row's max comes from a small
// launch over its edges' a_src), and gathers each edge's 256-byte row
// once, through a cp.async ring of two 8-row stages, weighting it in edge
// order, row by row (runs of edges inside a stage, no shared-memory read
// on the way to the next edge). Chunk partials and their combine are the
// f32 instance's. What bounds it: the same bytes as above with 2-byte
// rows and 4 bytes of a_src a row; then the gather of one 256-byte row an
// edge, from L2 for the SNP group and mostly from device memory for the
// Gene group's 117 MB table; measured (PERF.md), each item's chain of
// dependent steps (its indices, its scores, the ring, one row after
// another), which the SNP group's short rows, 16 to an item, make long.
// The unit of a row comes from a multiply and a shift (gat_items.cuh
// unit_of), not an integer division.

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
  const float* a_src;        // [S]: the bf16 instance's per-row scores
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

constexpr int kMaxSlots = 32;  // slots of a group (ops/gat_layer.py)
constexpr int kSrcBatches = 8;  // register batches of rows a warp scores

// shared memory of one warp in 32-bit words: the ring (S stages of kGroup
// rows of rw words), then s_w, s_src (kFwdMaxEdges each), s_beg, s_vbeg,
// s_mx (kItemMaxRows each) and s_k (kFwdMaxEdges bytes)
__host__ __device__ inline int fwd_bf16_words(int rw, int stages) {
  return stages * kGroup * rw + 2 * kgwas::kFwdMaxEdges +
         3 * kgwas::kItemMaxRows + kgwas::kFwdMaxEdges / 4;
}

struct SrcArgs {
  const __nv_bfloat16* xs;  // [S, D]
  const float* att;         // [R, D]
  float* a_src;             // [S]
  long long src_base[kMaxSlots + 1];
  long long s_begin;        // src_base[0]
  long long s_end;          // src_base[R]
  int n_slots;              // R
  int d;
};

// a_src[s] = round_bf16(att[slot(s)]) . xs[s] for the source rows s of the
// slots, slot r owning rows src_base[r] .. src_base[r+1]: a warp scores
// kSrcBatches batches of U consecutive rows, each batch's dots summed in
// one transposing butterfly. The lanes' columns and the butterfly are the
// ones the edge kernels used per edge, so a_src[src_e] has the bits of
// that per-edge score.
template <bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_a_src_kernel(const SrcArgs a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long first = a.s_begin + w * (kSrcBatches * U);
  if (first >= a.s_end) return;  // whole warp exits together
  const int d = a.d;
  int slot = 0;
  while (slot + 1 < a.n_slots && a.src_base[slot + 1] <= first) ++slot;
  int att_slot = -1;
  R attr;
  for (int b = 0; b < kSrcBatches; ++b) {
    const long long s0 = first + b * U;
    if (s0 >= a.s_end) break;  // warp-uniform
    R x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u].load(a.xs + static_cast<size_t>(min(s0 + u, a.s_end - 1)) * d,
                lane, d);
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long s = min(s0 + u, a.s_end - 1);
      while (slot + 1 < a.n_slots && a.src_base[slot + 1] <= s) ++slot;
      if (slot != att_slot) {
        attr.load(a.att + static_cast<size_t>(slot) * d, lane, d);
#pragma unroll
        for (int c = 0; c < R::C; ++c) attr.v[c] = kgwas::round_bf16(attr.v[c]);
        att_slot = slot;
      }
      p[u] = kgwas::row_dot(x[u], attr);
    }
    const float tot = kgwas::multi_sum<U>(p, lane);
    const int u = lane / (32 / U);
    if (lane % (32 / U) == 0 && s0 + u < a.s_end) a.a_src[s0 + u] = tot;
  }
}

// the logit of the bf16 instance: leaky_relu(z) / temperature, as the
// plain version divides
__device__ __forceinline__ float edge_logit_bf16(float z, float slope,
                                                 float t) {
  return (z >= 0.0f ? z : slope * z) / t;
}

// The max logit of each chunked slot row, from a_src over its edges (4
// bytes an edge): one warp per slot row of a unit cut into chunks.
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_chunk_max_bf16_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long jr =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int F = a.fold_slots;
  if (jr >= a.n_split * F) return;
  const long long u = a.split_units[jr / F];
  const long long row = F > 1 ? (jr % F) * a.n_rows_per_rel + u : u;
  const int beg = a.row_offsets[row], end = a.row_offsets[row + 1];
  const float ad = a.a_dst[row];
  float m = kNegBig;
  for (int e = beg + lane; e < end; e += 32)
    m = fmaxf(m, edge_logit_bf16(a.a_src[a.src[e]] + ad, a.slope,
                                 a.temperature));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) a.row_max[row] = m;
}

// One warp per item, one pass: every edge's logit from a_src[src_e] and
// a_dst (a lane an edge), the packed rows' softmax max (a chunk's from
// merged_gat_chunk_max_bf16_kernel), every edge's weight, then the rows
// aggregated in edge order through the cp.async ring.
template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_fwd_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int S = kgwas::kStagesBf16;
  constexpr int E = kgwas::kFwdMaxEdges;
  constexpr int KR = kgwas::kItemMaxRows;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(w, a.n_items);
  const int d = a.d;
  const int F = a.fold_slots;
  const int rw = kgwas::row_words_bf16<VEC, NV>(d);
  unsigned* ring = reinterpret_cast<unsigned*>(smem) +
                   static_cast<size_t>(warp) * fwd_bf16_words(rw, S);
  float* s_w = reinterpret_cast<float*>(ring + S * kGroup * rw);
  int* s_src = reinterpret_cast<int*>(s_w + E);
  int* s_beg = s_src + E;
  int* s_vbeg = s_beg + KR;
  float* s_mx = reinterpret_cast<float*>(s_vbeg + KR);
  unsigned char* s_k = reinterpret_cast<unsigned char*>(s_mx + KR);

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[item], a.row_offsets, a.n_rows_per_rel, F, lane);
  // a packed item's rows without edges: the plain version's NEG_BIG and 0
  if (!it.chunk && lane < it.n_rows && it.cnt == 0) {
    a.row_max[it.row] = kNegBig;
    a.row_sum[it.row] = 0.0f;
  }
  kgwas::stage_edges(it, a.src, s_beg, s_vbeg, s_src, s_k, lane);

  // the ring's first S - 1 stages are in flight while the weights form,
  // from each edge's score a_src[src_e] (into s_w)
  const int n_groups = (it.total + kGroup - 1) / kGroup;
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < n_groups)
      kgwas::load_group_bf16<VEC, NV>(ring, rw, g, it.total, s_src, a.xsb,
                                      lane, d);
    kgwas::cp_async_commit();
  }
  kgwas::gather_edge_values(a.a_src, s_src, s_w, it.total, lane);

  // every edge's logit (a lane an edge); without a max to wait for (a
  // chunk's is its row's, the other modes take none) its weight at once
  constexpr bool SM = MODE == kSoftmax;
  const float ad = lane < it.n_rows ? a.a_dst[it.row] : 0.0f;
  float mrow = kNegBig;  // lane k: row k's softmax max
  if (SM && it.chunk) mrow = a.row_max[it.row];
  if (SM && !it.chunk && lane < KR) s_mx[lane] = kNegBig;
  __syncwarp();
  const bool direct = !SM || it.chunk;
  const int n_win = (it.total + 31) / 32;
  for (int wn = 0; wn < n_win; ++wn) {
    const int v = wn * 32 + lane;
    const bool ok = v < it.total;
    const int k = ok ? s_k[v] : 0;
    const float adk = __shfl_sync(kFull, ad, k);
    float l = kNegBig;
    if (ok) {
      l = edge_logit_bf16(s_w[v] + adk, a.slope, a.temperature);
      if (!direct)
        s_w[v] = l;
      else if (SM)
        s_w[v] = expf(fminf(l - mrow, kExpClamp));
      else
        s_w[v] = MODE == kSigmoid ? 1.0f / (1.0f + expf(-l))
                                  : l * a.temperature;
    }
    if (!direct) kgwas::segmented_max(l, ok ? k : 255, s_mx, lane);
  }
  if (!direct) {  // the packed rows' softmax weights against their max
    mrow = lane < KR ? s_mx[lane] : kNegBig;
    for (int wn = 0; wn < n_win; ++wn) {
      const int v = wn * 32 + lane;
      const bool ok = v < it.total;
      const float mk = __shfl_sync(kFull, mrow, ok ? s_k[v] : 0);
      if (ok) s_w[v] = expf(fminf(s_w[v] - mk, kExpClamp));
    }
  }
  __syncwarp();

  int cur = -1;       // the row being aggregated
  int next_unit = 0;  // units before it are stored
  float m = kNegBig, s = 0.0f;
  R acc, res;
  acc.zero();
  res.zero();

  // lane k keeps row k's statistics, stored together at the item's end
  float row_m = kNegBig, row_s = 0.0f;
  auto finish_row = [&](int k) {
    if (it.chunk) {
      if (lane == 0) {
        a.part_m[it.part] = m;
        a.part_s[it.part] = s;
      }
      acc.store(a.part_acc + static_cast<size_t>(it.part) * d, lane, d);
      return;
    }
    if (SM && lane == k) {
      row_m = m;
      row_s = s;
    }
#pragma unroll
    for (int c = 0; c < R::C; ++c)
      res.v[c] += SM ? acc.v[c] / (s + kEps) : acc.v[c];
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

  // group g of the ring made readable: the stage read last is free, so
  // group g + S - 1 starts loading into it
  auto next_group = [&](int g) {
    __syncwarp();
    if (g + S - 1 < n_groups)
      kgwas::load_group_bf16<VEC, NV>(ring, rw, g + S - 1, it.total,
                                      s_src, a.xsb, lane, d);
    kgwas::cp_async_commit();
    kgwas::cp_async_wait<S - 1>();  // group g has landed
    __syncwarp();
  };

  // the rows in order, each row's edges in order: runs of edges inside one
  // ring stage, with no shared-memory read on the way to the next edge
  const int fmul = kgwas::unit_multiplier(F);
  for (int k = 0; k < it.n_rows; ++k) {  // warp-uniform
    const int cnt_k = __shfl_sync(kFull, it.cnt, k);
    if (cnt_k == 0) continue;
    if (cur >= 0) {
      finish_row(cur);
      const int i = kgwas::unit_of(cur, fmul);
      if (!it.chunk && kgwas::unit_of(k, fmul) != i) store_unit(i);
    }
    cur = k;
    s = 0.0f;
    acc.zero();
    m = __shfl_sync(kFull, mrow, k);
    const int v1 = __shfl_sync(kFull, it.vbeg, k) + cnt_k;
    for (int v = v1 - cnt_k; v < v1;) {
      if (v % kGroup == 0) next_group(v / kGroup);
      const unsigned* stage = ring + ((v / kGroup) % S) * kGroup * rw;
      const int run_end = min(v1, (v / kGroup + 1) * kGroup);
      for (; v < run_end; ++v) {
        const float wt = s_w[v];
        if (SM) s += wt;
        const float alpha = kgwas::round_bf16(wt);
        R x;
        kgwas::load_ring_bf16<VEC, NV>(x, stage + (v % kGroup) * rw, lane,
                                       d);
#pragma unroll
        for (int c = 0; c < R::C; ++c)
          acc.v[c] = fmaf(alpha, x.v[c], acc.v[c]);
      }
    }
  }
  kgwas::cp_async_wait<0>();
  if (cur >= 0) {
    finish_row(cur);
    if (!it.chunk) store_unit(kgwas::unit_of(cur, fmul));
  }
  if (!it.chunk) {
    R zero;
    zero.zero();
    for (; next_unit < it.n_units; ++next_unit)
      zero.store(a.out + (it.unit0 + next_unit) * d, lane, d);
    if (lane < it.n_rows && it.cnt > 0) {  // rows without edges: above
      a.row_max[it.row] = row_m;
      a.row_sum[it.row] = row_s;
    }
  }
}

template <bool VEC, int NV>
cudaError_t launch_a_src(const SrcArgs& a, cudaStream_t stream) {
  constexpr int U = kgwas::rows_in_flight<VEC, NV>();
  const long long per_block = static_cast<long long>(kWarps) * kSrcBatches * U;
  const long long blocks = (a.s_end - a.s_begin + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks <= 0) return cudaSuccess;
  merged_gat_a_src_kernel<VEC, NV>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, bool VEC, int NV>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int S = kgwas::kStagesBf16;
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks = (a.n_split + kWarps - 1) / kWarps;
  const long long mblocks = (a.n_split * a.fold_slots + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || mblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err;
  if (MODE == kSoftmax && mblocks > 0) {
    merged_gat_chunk_max_bf16_kernel<<<static_cast<unsigned>(mblocks),
                                       kWarps * 32, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int rw = kgwas::row_words_bf16<VEC, NV>(a.d);
  const size_t smem = sizeof(unsigned) * kWarps * fwd_bf16_words(rw, S);
  auto kern = merged_gat_fwd_bf16_kernel<MODE, VEC, NV>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(a);
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
  a.a_src = nullptr;
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

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (16-byte
// aligned at D = 128 * NV, else 4-byte aligned; the wrapper checks), and
// a_src [S] from kgwas_merged_gat_a_src_bf16 on the same table and att.
// Up to three launches: with softmax the chunked rows' maxima, then the
// items and the combine of the chunked units.
extern "C" int kgwas_merged_gat_fwd_bf16(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, const void* a_src, void* out, void* row_max,
    void* row_sum, const void* items, long long n_items,
    const void* split_units, const void* part_offsets, long long n_split,
    void* part_m, void* part_s, void* part_acc, long long n_rows_per_rel,
    int fold_slots, int d, int mode, float slope, float temperature,
    void* stream) {
  Args a;
  a.xs = nullptr;
  a.xsb = static_cast<const __nv_bfloat16*>(xs);
  a.a_src = static_cast<const float*>(a_src);
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

// The bf16 instance's logit pass: a_src[s] = round_bf16(att[r]) . xs[s]
// (float32) for every source row s of slot r, src_base[r] <= s <
// src_base[r+1]; src_base a host array of n_slots + 1 non-decreasing row
// indices (n_slots <= 32), rows outside them untouched. xs a bf16 [S, D]
// table as for kgwas_merged_gat_fwd_bf16, att float32 [n_slots, D]. One
// launch.
extern "C" int kgwas_merged_gat_a_src_bf16(const void* xs, const void* att,
                                           void* a_src,
                                           const long long* src_base,
                                           int n_slots, int d, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return cudaErrorInvalidValue;
  SrcArgs a;
  a.xs = static_cast<const __nv_bfloat16*>(xs);
  a.att = static_cast<const float*>(att);
  a.a_src = static_cast<float*>(a_src);
  for (int r = 0; r <= kMaxSlots; ++r)
    a.src_base[r] = src_base[r < n_slots ? r : n_slots];
  a.s_begin = src_base[0];
  a.s_end = src_base[n_slots];
  a.n_slots = n_slots;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return launch_a_src<true, 1>(a, s);
    case 256: return launch_a_src<true, 2>(a, s);
    case 384: return launch_a_src<true, 3>(a, s);
    case 512: return launch_a_src<true, 4>(a, s);
    default:
      if (d <= 32 * kMaxCols) return launch_a_src<false, 1>(a, s);
      return cudaErrorInvalidValue;
  }
}
