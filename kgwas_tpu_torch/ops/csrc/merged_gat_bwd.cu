// Merged-relation GAT layer backward, edge half, for Hopper (sm_90a), plain
// C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_gat_layer.py::_make_bwd_kernel
// (launched by _merged_backward). Over one destination group's merged,
// dst-sorted CSR edge stream, with g the cotangent of the forward's output
// (g[n] for every slot row r*N + n when folding), it computes per edge
//
//   z_e  = att[slot] . xs[src_e] + a_dst[row]       l_e = leaky(z_e) / T
//   m_e  = g_row . xs[src_e]
//   softmax: w_e = exp(min(l_e - lse_row, 60)), lse = row_max + log(sum + 1e-16)
//            dz_e = w_e (m_e - dot_row) leaky'(z_e) / T,  dot_row = sum w_e m_e
//   sigmoid: w_e = sigmoid(l_e),  dz_e = m_e w_e (1 - w_e) leaky'(z_e) / T
//   raw:     w_e = l_e T,         dz_e = m_e leaky'(z_e)
//
// and writes w [E], dz [E] and d_a_dst[row] = sum over the row of dz_e. The
// TPU kernel writes the [E, D] message cotangent d_msgs = w_e g_row +
// dz_e att[slot] (1.7 GB per layer at the 200k-SNP bench size) and takes
// dot_row from the saved unfolded output; this kernel writes neither:
// csc_segment_sum.cu forms each d_msgs row in registers from w, dz and g,
// and dot_row is summed from the row's own edges, so the forward keeps only
// its folded [N, D] output.
//
// Design. A static schedule (gat_items.cuh) as in the forward, with
// shorter chunks (its sums are trees, not a sequential chain, so a trash
// row may be cut anywhere): one warp per item, packed short rows or one
// chunk of a long row. The item's cotangent rows (one per unit) and,
// through a two-stage ring of 8 rows, its edges' source rows are gathered
// into shared memory with cp.async; four lanes score each edge (its dots
// with att[slot] and with g_row, rotated columns) and keep z_e and m_e in
// shared memory, so no D-wide sum is left. Then each lane takes an edge:
// dot_row and d_a_dst are segmented warp sums over the item's rows in a
// fixed order. A chunk writes z_e and m_e into w and dz and its partial
// dot_row to scratch; a second, small launch, one warp per chunked slot
// row, sums the row's partials in part order and finishes its edges. No
// float atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], g [N or R*N, D], src [E], w and dz [E], row_offsets, a_dst,
// row_max, row_sum and d_a_dst [R*N]), ~0.04-0.08 ms per launch at the
// bench size. The gathered source rows come from L2 (the SNP group) or
// from device memory (the Gene group's 234 MB table), as in the forward.
//
// The bf16 instance (kgwas_merged_gat_bwd_bf16: xs bf16) rounds where the
// TPU kernel rounds on bf16 messages: att to bf16 for the score, g to bf16
// for m_e = g_row . xs[src_e]; dot_row is the forward output row dotted
// with the unrounded g, taken from the row's edges as the sum of the
// forward's rounded weights bf16(exp(min(l_e - row_max, 60))) times
// g_row . xs[src_e], over row_sum + 1e-16. w_e, dz_e and d_a_dst stay
// float32 (the TPU kernel's d_msgs rounding is csc_segment_sum.cu's). exp
// and the divisions are the accurate ones, as the plain version's. The
// score is the forward's per-source-row a_src (merged_gat_fwd.cu), so z_e
// = a_src[src_e] + a_dst[row] costs 4 bytes an edge and no dot. The two
// dots left, bf16(g_row) . x_e and (softmax) g_row . x_e, read the rows
// from a cp.async ring of two 8-row stages (one loads while the other is
// scored), the lanes' columns and the transposing
// butterfly those of the per-edge dots before (one butterfly of 8 sums a
// group a dot); the item's cotangent rows wait in shared memory. The second
// pass, the chunks and their combine are unchanged.

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
using kgwas::kGroup;
using kgwas::kItemMaxRows;
using kgwas::kItemMaxUnits;
using kgwas::kMaxCols;
using kgwas::kSigmoid;
using kgwas::kSoftmax;
using kgwas::kStages;

constexpr int kWarps = 4;  // warps per block
// per-edge z and m, per-row dot_row and d_a_dst
constexpr int kExtra = 2 * kBwdMaxEdges + 2 * kItemMaxRows;

struct Args {
  const float* xs;          // [S, D]
  const int* src;           // [E]
  const int* row_offsets;   // [R*N + 1]
  const float* att;         // [R, D]
  const float* a_dst;       // [R*N]
  const float* row_max;     // [R*N]
  const float* row_sum;     // [R*N]
  const float* g;           // [N or R*N, D]
  float* w;                 // [E]
  float* dz;                // [E]
  float* d_a_dst;           // [R*N]
  const int4* items;        // [n_items]
  const int* split_units;   // [n_split]
  const int* part_offsets;  // [n_split * F + 1]
  float* part_dot;          // [n_parts]
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

// the final w_e and dz_e of an edge from z_e, m_e and its row's lse and
// dot_row
template <int MODE>
__device__ __forceinline__ void edge_grads(float z, float m, float lse,
                                           float dot, float slope, float t,
                                           float& wt, float& dzv) {
  const float inv_t = 1.0f / t;
  const float slope_t = slope / t;
  const float l = z >= 0.0f ? z * inv_t : z * slope_t;
  const float kd = z >= 0.0f ? inv_t : slope_t;  // leaky'(z) / T
  if (MODE == kSoftmax) {
    wt = fast_exp(fminf(l - lse, kExpClamp));
    dzv = wt * (m - dot) * kd;
  } else if (MODE == kSigmoid) {
    wt = 1.0f / (1.0f + fast_exp(-l));
    dzv = m * wt * (1.0f - wt) * kd;
  } else {
    wt = l * t;
    dzv = z >= 0.0f ? m : m * slope;
  }
}

template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(wi, a.n_items);

  const int d = a.d;
  const int F = a.fold_slots;
  const int rl = kgwas::row_len<VEC, NV>(d);
  float* ring = smem + static_cast<size_t>(warp) *
                           kgwas::warp_smem_floats(rl, kItemMaxUnits,
                                                   kBwdMaxEdges, kExtra);
  float* s_g = ring + kStages * kGroup * rl;
  int* s_src = reinterpret_cast<int*>(s_g + kItemMaxUnits * rl);
  int* s_beg = s_src + kBwdMaxEdges;
  int* s_vbeg = s_beg + kItemMaxRows;
  unsigned char* s_k = reinterpret_cast<unsigned char*>(s_vbeg + kItemMaxRows);
  float* s_z = reinterpret_cast<float*>(s_k + kBwdMaxEdges);
  float* s_m = s_z + kBwdMaxEdges;
  float* s_dot = s_m + kBwdMaxEdges;
  float* s_da = s_dot + kItemMaxRows;

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[item], a.row_offsets, a.n_rows_per_rel, F, lane);
  // the item's cotangent rows: g[unit] (the unit is the node with the
  // fold, the slot row without)
  for (int i = 0; i < it.n_units; ++i)
    kgwas::copy_row<VEC, NV>(s_g + i * rl, a.g + (it.unit0 + i) * d, lane, d);
  kgwas::cp_async_commit();
  if (lane < kItemMaxRows) {
    s_dot[lane] = 0.0f;
    s_da[lane] = 0.0f;
  }
  kgwas::stage_edges(it, a.src, s_beg, s_vbeg, s_src, s_k, lane);

  float ad = 0.0f, lse = 0.0f;
  if (lane < it.n_rows) {
    ad = a.a_dst[it.row];
    if (MODE == kSoftmax)
      lse = a.row_max[it.row] + logf(a.row_sum[it.row] + kEps);
  }
  const int q = lane >> 2, p = lane & 3;  // the edge this lane scores
  const int n_groups = (it.total + kGroup - 1) / kGroup;

  // pass 1: z_e and m_e of every edge of the item into shared memory
  if (n_groups > 0)
    kgwas::load_group<VEC, NV>(ring, rl, 0, it.total, s_src, a.xs, lane, d);
  kgwas::cp_async_commit();
  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups)
      kgwas::load_group<VEC, NV>(ring, rl, g + 1, it.total, s_src, a.xs,
                                 lane, d);
    kgwas::cp_async_commit();
    kgwas::cp_async_wait<1>();  // the g rows and group g have landed
    __syncwarp();
    const float* stage = ring + (g % kStages) * kGroup * rl;
    const int cnt = min(kGroup, it.total - g * kGroup);
    const int v = g * kGroup + q;
    const int k = q < cnt ? s_k[v] : 0;
    const int slot = __shfl_sync(kFull, it.slot, k);
    const float adk = __shfl_sync(kFull, ad, k);
    float pa = 0.0f, pm = 0.0f;
    if (q < cnt)
      kgwas::part_dots<VEC, NV, true>(
          stage + q * rl, a.att + static_cast<size_t>(slot) * d,
          s_g + (it.chunk ? 0 : k / F) * rl, q, p, d, pa, pm);
    pa += __shfl_xor_sync(kFull, pa, 1);
    pm += __shfl_xor_sync(kFull, pm, 1);
    pa += __shfl_xor_sync(kFull, pa, 2);
    pm += __shfl_xor_sync(kFull, pm, 2);
    if (q < cnt && p == 0) {
      s_z[v] = pa + adk;
      s_m[v] = pm;
    }
    __syncwarp();  // the stage is read before it is loaded again
  }
  kgwas::cp_async_wait<0>();  // an item without edges loaded its g rows
  const int n_win = (it.total + 31) / 32;

  // dot_row = sum over the row of w_e m_e (softmax)
  if (MODE == kSoftmax) {
    const float inv_t = 1.0f / a.temperature;
    const float slope_t = a.slope / a.temperature;
    for (int wn = 0; wn < n_win; ++wn) {
      const int v = wn * 32 + lane;
      const bool ok = v < it.total;
      const int k = ok ? s_k[v] : 255;
      const float lse_k = __shfl_sync(kFull, lse, ok ? k : 0);
      float val = 0.0f;
      if (ok) {
        const float z = s_z[v];
        const float l = z >= 0.0f ? z * inv_t : z * slope_t;
        val = fast_exp(fminf(l - lse_k, kExpClamp)) * s_m[v];
      }
      kgwas::segmented_add(val, k, s_dot, lane);
    }
  }

  if (it.chunk) {
    // z_e and m_e go to w and dz, the partial dot_row to scratch; the
    // combine finishes the row
    for (int v = lane; v < it.total; v += 32) {
      a.w[s_beg[0] + v] = s_z[v];
      a.dz[s_beg[0] + v] = s_m[v];
    }
    if (lane == 0) a.part_dot[it.part] = s_dot[0];
    return;
  }

  // pass 2: each lane finishes an edge; d_a_dst per row
  for (int wn = 0; wn < n_win; ++wn) {
    const int v = wn * 32 + lane;
    const bool ok = v < it.total;
    const int k = ok ? s_k[v] : 255;
    const float lse_k = __shfl_sync(kFull, lse, ok ? k : 0);
    float dzv = 0.0f;
    if (ok) {
      float wt;
      edge_grads<MODE>(s_z[v], s_m[v], lse_k, s_dot[k], a.slope,
                       a.temperature, wt, dzv);
      const int e = s_beg[k] + v - s_vbeg[k];
      a.w[e] = wt;
      a.dz[e] = dzv;
    }
    kgwas::segmented_add(dzv, k, s_da, lane);
  }
  if (lane < it.n_rows) a.d_a_dst[it.row] = s_da[lane];
}

// One warp per slot row of a unit cut into chunks: dot_row from the row's
// parts in part order, then every edge's w_e and dz_e from the z_e and m_e
// the chunks stored (four edges a lane loaded before any is written), and
// d_a_dst.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_bwd_combine_kernel(const Args a) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const long long jr =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int F = a.fold_slots;
  if (jr >= a.n_split * F) return;
  const long long j = jr / F;
  const int r = static_cast<int>(jr % F);
  const long long u = a.split_units[j];
  const long long row = F > 1 ? r * a.n_rows_per_rel + u : u;
  float dot = 0.0f, lse = 0.0f;
  if (MODE == kSoftmax) {
    for (int pi = a.part_offsets[jr]; pi < a.part_offsets[jr + 1]; ++pi)
      dot += a.part_dot[pi];
    lse = a.row_max[row] + logf(a.row_sum[row] + kEps);
  }
  const int beg = a.row_offsets[row], end = a.row_offsets[row + 1];
  float da = 0.0f;
  for (int e0 = beg + lane; e0 < end; e0 += 32 * kBatch) {
    float z[kBatch], m[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + 32 * b;
      z[b] = e < end ? a.w[e] : 0.0f;
      m[b] = e < end ? a.dz[e] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + 32 * b;
      if (e < end) {
        float wt, dzv;
        edge_grads<MODE>(z[b], m[b], lse, dot, a.slope, a.temperature, wt,
                         dzv);
        a.w[e] = wt;
        a.dz[e] = dzv;
        da += dzv;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(kFull, da, off);
  if (lane == 0) a.d_a_dst[row] = da;
}

template <int MODE, bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  // the combine: one warp per slot row of a chunked unit
  const long long cblocks =
      (a.n_split * a.fold_slots + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int rl = kgwas::row_len<VEC, NV>(a.d);
  const size_t smem = sizeof(float) * kWarps *
                      kgwas::warp_smem_floats(rl, kItemMaxUnits,
                                              kBwdMaxEdges, kExtra);
  if (blocks > 0) {
    auto kern = merged_gat_bwd_kernel<MODE, VEC, NV>;
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
    merged_gat_bwd_combine_kernel<MODE>
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

// the bf16 instance's w_e and dz_e, in the plain version's formulas
template <int MODE>
__device__ __forceinline__ void edge_grads_bf16(float z, float m, float lse,
                                                float dot, float slope,
                                                float t, float& wt,
                                                float& dzv) {
  const float leaky_d = z >= 0.0f ? 1.0f : slope;
  const float l = (z >= 0.0f ? z : slope * z) / t;
  if (MODE == kSoftmax) {
    wt = expf(fminf(l - lse, kExpClamp));
    dzv = wt * (m - dot) * leaky_d / t;
  } else if (MODE == kSigmoid) {
    wt = 1.0f / (1.0f + expf(-l));
    dzv = m * wt * (1.0f - wt) * leaky_d / t;
  } else {
    wt = l * t;
    dzv = m * leaky_d;
  }
}

// a lane's columns of a shared-memory f32 row
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

// shared memory of one warp in 32-bit words: the item's cotangent rows
// (kItemMaxUnits float32 rows of rl), the ring (S stages of kGroup bf16
// rows of rw words), s_src, s_z, s_m, s_m2 (kBwdMaxEdges each), s_beg,
// s_vbeg, s_dot, s_da (kItemMaxRows each) and s_k (kBwdMaxEdges bytes)
__host__ __device__ inline int bwd_bf16_words(int rl, int rw, int stages) {
  return kItemMaxUnits * rl + stages * kGroup * rw + 4 * kBwdMaxEdges +
         4 * kItemMaxRows + kBwdMaxEdges / 4;
}

template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_bwd_bf16_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int S = kgwas::kStagesBf16;
  constexpr int E = kBwdMaxEdges;
  constexpr bool SM = MODE == kSoftmax;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (wi >= a.n_items) return;  // whole warp exits together
  const long long item = kgwas::item_of_warp(wi, a.n_items);
  const int d = a.d;
  const int F = a.fold_slots;
  const int rl = kgwas::row_len<VEC, NV>(d);
  const int rw = kgwas::row_words_bf16<VEC, NV>(d);
  float* s_g = smem + static_cast<size_t>(warp) * bwd_bf16_words(rl, rw, S);
  unsigned* ring = reinterpret_cast<unsigned*>(s_g + kItemMaxUnits * rl);
  int* s_src = reinterpret_cast<int*>(ring + S * kGroup * rw);
  float* s_z = reinterpret_cast<float*>(s_src + E);
  float* s_m = s_z + E;
  float* s_m2 = s_m + E;
  int* s_beg = reinterpret_cast<int*>(s_m2 + E);
  int* s_vbeg = s_beg + kItemMaxRows;
  float* s_dot = reinterpret_cast<float*>(s_vbeg + kItemMaxRows);
  float* s_da = s_dot + kItemMaxRows;
  unsigned char* s_k = reinterpret_cast<unsigned char*>(s_da + kItemMaxRows);

  const kgwas::ItemRows it = kgwas::item_rows(
      a.items[item], a.row_offsets, a.n_rows_per_rel, F, lane);
  for (int i = 0; i < it.n_units; ++i)
    kgwas::copy_row<VEC, NV>(s_g + i * rl, a.g + (it.unit0 + i) * d, lane, d);
  kgwas::cp_async_commit();
  if (lane < kItemMaxRows) {
    s_dot[lane] = 0.0f;
    s_da[lane] = 0.0f;
  }
  kgwas::stage_edges(it, a.src, s_beg, s_vbeg, s_src, s_k, lane);
  const int n_groups = (it.total + kGroup - 1) / kGroup;
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < n_groups)
      kgwas::load_group_bf16<VEC, NV>(ring, rw, g, it.total, s_src, a.xsb,
                                      lane, d);
    kgwas::cp_async_commit();
  }
  kgwas::gather_edge_values(a.a_src, s_src, s_z, it.total, lane);
  float ad = 0.0f, rmax = 0.0f, rsum = 0.0f, lse = 0.0f;
  if (lane < it.n_rows) {
    ad = a.a_dst[it.row];
    if (SM) {
      rmax = a.row_max[it.row];
      rsum = a.row_sum[it.row];
      lse = rmax + logf(rsum + kEps);
    }
  }
  const int n_win = (it.total + 31) / 32;

  // z_e = a_src[src_e] + a_dst[row], a lane an edge
  for (int wn = 0; wn < n_win; ++wn) {
    const int v = wn * 32 + lane;
    const bool ok = v < it.total;
    const float adk = __shfl_sync(kFull, ad, ok ? s_k[v] : 0);
    if (ok) s_z[v] = s_z[v] + adk;
  }

  // m_e = bf16(g_row) . x_e (and with softmax g_row . x_e unrounded) from
  // the rows in the ring: a group's dots summed in one transposing
  // butterfly, each total written by the lane that holds it
  int g_unit = -1;
  const int fmul = kgwas::unit_multiplier(F);
  R gr, grr;
  for (int g = 0; g < n_groups; ++g) {
    if (g + S - 1 < n_groups)
      kgwas::load_group_bf16<VEC, NV>(ring, rw, g + S - 1, it.total,
                                      s_src, a.xsb, lane, d);
    kgwas::cp_async_commit();
    kgwas::cp_async_wait<S - 1>();  // the g rows and group g have landed
    __syncwarp();
    const unsigned* stage = ring + (g % S) * kGroup * rw;
    const int cnt = min(kGroup, it.total - g * kGroup);
    float pm[kGroup], pm2[kGroup];
    // the group's rows k, one read (past the end: the last edge again)
    const uint2 keys = *reinterpret_cast<const uint2*>(s_k + g * kGroup);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int uu = min(u, cnt - 1);
      const int k = ((uu < 4 ? keys.x : keys.y) >> (8 * (uu & 3))) & 0xff;
      const int i = it.chunk ? 0 : kgwas::unit_of(k, fmul);
      if (i != g_unit) {
        load_shared<VEC, NV>(gr, s_g + i * rl, lane, d);
#pragma unroll
        for (int c = 0; c < R::C; ++c) grr.v[c] = kgwas::round_bf16(gr.v[c]);
        g_unit = i;
      }
      R x;
      kgwas::load_ring_bf16<VEC, NV>(x, stage + uu * rw, lane, d);
      pm[u] = kgwas::row_dot(x, grr);
      pm2[u] = SM ? kgwas::row_dot(x, gr) : 0.0f;
    }
    const float tm = kgwas::multi_sum<kGroup>(pm, lane);
    const float tm2 = SM ? kgwas::multi_sum<kGroup>(pm2, lane) : 0.0f;
    constexpr int kLanes = 32 / kGroup;  // lanes holding each total
    const int u = lane / kLanes;
    if (lane % kLanes == 0 && u < cnt) {
      s_m[g * kGroup + u] = tm;
      if (SM) s_m2[g * kGroup + u] = tm2;
    }
    __syncwarp();  // the stage is read before it is loaded again
  }
  kgwas::cp_async_wait<0>();
  __syncwarp();

  // the sum over the row of the forward's rounded weight times m2
  if (SM) {
    for (int wn = 0; wn < n_win; ++wn) {
      const int v = wn * 32 + lane;
      const bool ok = v < it.total;
      const int k = ok ? s_k[v] : 255;
      const float rmax_k = __shfl_sync(kFull, rmax, ok ? k : 0);
      float val = 0.0f;
      if (ok) {
        const float z = s_z[v];
        const float l = (z >= 0.0f ? z : a.slope * z) / a.temperature;
        val = kgwas::round_bf16(expf(fminf(l - rmax_k, kExpClamp))) * s_m2[v];
      }
      kgwas::segmented_add(val, k, s_dot, lane);
    }
  }

  if (it.chunk) {
    for (int v = lane; v < it.total; v += 32) {
      a.w[s_beg[0] + v] = s_z[v];
      a.dz[s_beg[0] + v] = s_m[v];
    }
    if (lane == 0) a.part_dot[it.part] = s_dot[0];
    return;
  }

  // pass 2: each lane finishes an edge; d_a_dst per row
  for (int wn = 0; wn < n_win; ++wn) {
    const int v = wn * 32 + lane;
    const bool ok = v < it.total;
    const int k = ok ? s_k[v] : 255;
    const float lse_k = __shfl_sync(kFull, lse, ok ? k : 0);
    const float rsum_k = __shfl_sync(kFull, rsum, ok ? k : 0);
    float dzv = 0.0f;
    if (ok) {
      float wt;
      const float dot = SM ? s_dot[k] / (rsum_k + kEps) : 0.0f;
      edge_grads_bf16<MODE>(s_z[v], s_m[v], lse_k, dot, a.slope,
                            a.temperature, wt, dzv);
      const int e = s_beg[k] + v - s_vbeg[k];
      a.w[e] = wt;
      a.dz[e] = dzv;
    }
    kgwas::segmented_add(dzv, k, s_da, lane);
  }
  if (lane < it.n_rows) a.d_a_dst[it.row] = s_da[lane];
}

// One warp per slot row of a unit cut into chunks: dot_row from the row's
// parts in part order over row_sum + 1e-16, then every edge's w_e and dz_e
// from the z_e and m_e the chunks stored, and d_a_dst.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_bwd_combine_bf16_kernel(const Args a) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const long long jr =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int F = a.fold_slots;
  if (jr >= a.n_split * F) return;
  const long long j = jr / F;
  const int r = static_cast<int>(jr % F);
  const long long u = a.split_units[j];
  const long long row = F > 1 ? r * a.n_rows_per_rel + u : u;
  float dot = 0.0f, lse = 0.0f;
  if (MODE == kSoftmax) {
    for (int pi = a.part_offsets[jr]; pi < a.part_offsets[jr + 1]; ++pi)
      dot += a.part_dot[pi];
    dot = dot / (a.row_sum[row] + kEps);
    lse = a.row_max[row] + logf(a.row_sum[row] + kEps);
  }
  const int beg = a.row_offsets[row], end = a.row_offsets[row + 1];
  float da = 0.0f;
  for (int e0 = beg + lane; e0 < end; e0 += 32 * kBatch) {
    float z[kBatch], m[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + 32 * b;
      z[b] = e < end ? a.w[e] : 0.0f;
      m[b] = e < end ? a.dz[e] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + 32 * b;
      if (e < end) {
        float wt, dzv;
        edge_grads_bf16<MODE>(z[b], m[b], lse, dot, a.slope, a.temperature,
                              wt, dzv);
        a.w[e] = wt;
        a.dz[e] = dzv;
        da += dzv;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(kFull, da, off);
  if (lane == 0) a.d_a_dst[row] = da;
}

template <int MODE, bool VEC, int NV>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int S = kgwas::kStagesBf16;
  const long long blocks = (a.n_items + kWarps - 1) / kWarps;
  const long long cblocks =
      (a.n_split * a.fold_slots + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || cblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int rl = kgwas::row_len<VEC, NV>(a.d);
  const int rw = kgwas::row_words_bf16<VEC, NV>(a.d);
  const size_t smem = sizeof(float) * kWarps * bwd_bf16_words(rl, rw, S);
  if (blocks > 0) {
    auto kern = merged_gat_bwd_bf16_kernel<MODE, VEC, NV>;
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
    merged_gat_bwd_combine_bf16_kernel<MODE>
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
// pointers; xs, att, g and items must be 16-byte aligned (the wrapper
// checks). mode: 0 softmax, 1 sigmoid, 2 raw. The schedule's items hold
// at most 256 edges (the wrapper checks); part_dot is scratch of one float
// per chunk. Two launches: the
// items, then the combine of the chunked units.
extern "C" int kgwas_merged_gat_bwd(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, const void* row_max, const void* row_sum,
    const void* g, void* w, void* dz, void* d_a_dst, const void* items,
    long long n_items, const void* split_units, const void* part_offsets,
    long long n_split, void* part_dot, long long n_rows_per_rel,
    int fold_slots, int d, int mode, float slope, float temperature,
    void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.xsb = nullptr;
  a.a_src = nullptr;
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.att = static_cast<const float*>(att);
  a.a_dst = static_cast<const float*>(a_dst);
  a.row_max = static_cast<const float*>(row_max);
  a.row_sum = static_cast<const float*>(row_sum);
  a.g = static_cast<const float*>(g);
  a.w = static_cast<float*>(w);
  a.dz = static_cast<float*>(dz);
  a.d_a_dst = static_cast<float*>(d_a_dst);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_dot = static_cast<float*>(part_dot);
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_rows_per_rel = n_rows_per_rel;
  a.fold_slots = fold_slots;
  a.d = d;
  a.slope = slope;
  a.temperature = temperature;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSoftmax: return dispatch_width<kSoftmax>(a, s);
    case kSigmoid: return dispatch_width<kSigmoid>(a, s);
    case kgwas::kRaw: return dispatch_width<kgwas::kRaw>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 instance: the same arguments, xs a bf16 [S, D] table (16-byte
// aligned at D = 128 * NV, else 4-byte aligned; the wrapper checks), and
// a_src [S] from kgwas_merged_gat_a_src_bf16 (merged_gat_fwd.cu) on the
// same table and att.
extern "C" int kgwas_merged_gat_bwd_bf16(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, const void* a_src, const void* row_max,
    const void* row_sum,
    const void* g, void* w, void* dz, void* d_a_dst, const void* items,
    long long n_items, const void* split_units, const void* part_offsets,
    long long n_split, void* part_dot, long long n_rows_per_rel,
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
  a.row_max = static_cast<const float*>(row_max);
  a.row_sum = static_cast<const float*>(row_sum);
  a.g = static_cast<const float*>(g);
  a.w = static_cast<float*>(w);
  a.dz = static_cast<float*>(dz);
  a.d_a_dst = static_cast<float*>(d_a_dst);
  a.items = static_cast<const int4*>(items);
  a.split_units = static_cast<const int*>(split_units);
  a.part_offsets = static_cast<const int*>(part_offsets);
  a.part_dot = static_cast<float*>(part_dot);
  a.n_items = n_items;
  a.n_split = n_split;
  a.n_rows_per_rel = n_rows_per_rel;
  a.fold_slots = fold_slots;
  a.d = d;
  a.slope = slope;
  a.temperature = temperature;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSoftmax: return dispatch_width_bf16<kSoftmax>(a, s);
    case kSigmoid: return dispatch_width_bf16<kSigmoid>(a, s);
    case kgwas::kRaw: return dispatch_width_bf16<kgwas::kRaw>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
