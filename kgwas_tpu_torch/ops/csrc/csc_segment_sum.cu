// CSC segment sum of the merged GAT layer's message cotangent, for Hopper
// (sm_90a), plain C entry point.
//
// Replaces the TPU kernel kgwas_tpu/ops/pallas_segment.py::_segsum_kernel as
// pallas_segment_sum launches it for gather_rows_csc's backward: there the
// [E, D] message cotangent d_msgs (written by the backward layer kernel) is
// permuted to source order and summed per source row. Here d_msgs is never
// written. Walking the layout's CSC (csc_perm, csc_offsets), each source row
// s of the concatenated table xs gets
//
//   d_xs[s] = sum_i (w_e g[row_e] + dz_e att[slot(s)]),   e = csc_perm[i]
//           = sum_i w_e g[row_e] + c_s att[slot(s)],     c_s = sum_i dz_e
//
// with w and dz from merged_gat_bwd.cu and g the layer output's cotangent
// (row row_e % N of it with the fold). The same pass reduces the attention
// vector's gradient d_att[slot] = sum_{s in slot} c_s xs[s], which the TPU
// backward layer kernel accumulates per tile (its d_att partials are summed
// outside it, _tile_grads_to_rel).
//
// Design. One warp per source row, kRowsPerWarp rows per warp in order, 8
// warps per block: a block covers kBlockRows = 64 consecutive source rows.
// The CSC entries of a row load 32 at a time, one per lane (csc_perm, then
// dst, w and dz of that edge), are broadcast by shuffle, and the cotangent
// rows g[row_e] are read U at a time (float4 per lane at D % 128 == 0) and
// summed in registers in CSC order. Every row is written, rows without
// edges and padded rows included. Source rows are padded to multiples of
// 512 per slot, so a block never spans two slots: each block sums its
// rows' c_s xs[s] (its warps in order) into one partial row, and a second
// small kernel sums each slot's partials in a fixed order. No atomics: two
// runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (g [N or R*N, D], xs [S, D], w, dz, dst and csc_perm [E], csc_offsets
// [S + 1], d_xs [S, D]; the partials are S / 64 rows), against 2 D flops per
// edge. As in the layer kernels, each slot's trash source row holds all of
// the relation's pad edges (up to 511) and one warp walks them in sequence.
//
// Without logit cotangents (dz == nullptr: the per-relation GAT backward
// after segment_softmax_spmm_bwd.cu, and the message-passing backward of
// csr_segment_sum.cu) the same kernel runs with LOGITS = false, a
// compile-time flag: d_xs[s] = sum_i w_e g[row_e], no att, no d_att and no
// slot sums. With w == nullptr every weight is 1 (the SAGE mean's sum).

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::kFull;
using kgwas::kMaxCols;

constexpr int kWarps = 8;          // warps per block
constexpr int kRowsPerWarp = 8;    // source rows per warp
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // ops/segment.py BLOCK_ROWS
constexpr int kMaxSlots = 32;      // ops/segment.py MAX_SLOTS
constexpr int kMaxD = 32 * kMaxCols;

struct Args {
  const float* g;            // [N or R*N, D]
  const float* w;            // [E]
  const float* dz;           // [E]
  const float* xs;           // [S, D]
  const float* att;          // [R, D]
  const int* dst;            // [E]
  const int* csc_perm;       // [E]
  const int* csc_offsets;    // [S + 1]
  float* d_xs;               // [S, D]
  float* d_att;              // [R, D]
  float* partial;            // [S / kBlockRows, D]
  long long src_base[kMaxSlots + 1];
  long long n_rows_per_rel;  // N
  int n_rel;
  int fold;
  int d;
};

template <bool VEC, int NV, bool LOGITS>
__global__ void __launch_bounds__(kWarps * 32)
csc_rows_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = !VEC || NV > 2 ? 2 : 4;  // cotangent rows in flight
  __shared__ __align__(16) float red[kWarps][kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long block_row0 = static_cast<long long>(blockIdx.x) * kBlockRows;
  const int n_per_rel = static_cast<int>(a.n_rows_per_rel);

  R att;
  R part;  // this warp's sum of c_s xs[s]
  if (LOGITS) {
    int slot = 0;  // the block's rows all lie in one slot
    while (slot + 1 < a.n_rel && a.src_base[slot + 1] <= block_row0) ++slot;
    att.load(a.att + static_cast<long long>(slot) * a.d, lane, a.d);
    part.zero();
  }

  for (int k = 0; k < kRowsPerWarp; ++k) {
    const long long s = block_row0 + warp * kRowsPerWarp + k;
    const int beg = a.csc_offsets[s];
    const int end = a.csc_offsets[s + 1];
    R acc;
    acc.zero();
    float c = 0.0f;  // lane partial of c_s
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      int my_row = 0;
      float my_w = 0.0f;
      if (base + lane < end) {
        const int e = a.csc_perm[base + lane];
        const int row = a.dst[e];
        my_row = a.fold ? row % n_per_rel : row;
        my_w = a.w != nullptr ? a.w[e] : 1.0f;  // warp-uniform
        if (LOGITS) c += a.dz[e];
      }
      for (int j = 0; j < cnt; j += U) {
        // a step past the end re-reads the last edge's row, masked below
        R gx[U];
        float wu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src_lane = min(j + u, cnt - 1);
          const int r = __shfl_sync(kFull, my_row, src_lane);
          wu[u] = __shfl_sync(kFull, my_w, src_lane);
          gx[u].load(a.g + static_cast<size_t>(r) * a.d, lane, a.d);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < cnt) {  // warp-uniform
#pragma unroll
            for (int q = 0; q < R::C; ++q)
              acc.v[q] = fmaf(wu[u], gx[u].v[q], acc.v[q]);
          }
        }
      }
    }
    if (!LOGITS) {
      acc.store(a.d_xs + s * a.d, lane, a.d);
      continue;
    }
    // xor butterfly: every lane ends with the same c_s
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
#pragma unroll
    for (int q = 0; q < R::C; ++q) acc.v[q] = fmaf(c, att.v[q], acc.v[q]);
    acc.store(a.d_xs + s * a.d, lane, a.d);
    if (c != 0.0f) {  // c * xs[s] adds nothing otherwise
      R x;
      x.load(a.xs + s * a.d, lane, a.d);
#pragma unroll
      for (int q = 0; q < R::C; ++q) part.v[q] = fmaf(c, x.v[q], part.v[q]);
    }
  }

  if (!LOGITS) return;
  // the block's d_att partial: its warps' sums in warp order
  part.store(&red[warp][0], lane, a.d);
  __syncthreads();
  for (int col = threadIdx.x; col < a.d; col += kWarps * 32) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += red[k][col];
    a.partial[static_cast<long long>(blockIdx.x) * a.d + col] = sum;
  }
}

// d_att[slot] = the sum of the slot's block partials. Grid (R, D / 32):
// lane = column, warp k sums partials k, k + 8, ... in order, then warp 0
// sums the 8 warps' sums in order.
__global__ void __launch_bounds__(kWarps * 32) slot_sum_kernel(const Args a) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x;
  const int col = blockIdx.y * 32 + lane;
  const long long b0 = a.src_base[slot] / kBlockRows;
  const long long b1 = a.src_base[slot + 1] / kBlockRows;
  float s = 0.0f;
  if (col < a.d)
    for (long long b = b0 + warp; b < b1; b += kWarps)
      s += a.partial[b * a.d + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < a.d) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += red[k][lane];
    a.d_att[static_cast<long long>(slot) * a.d + col] = t;
  }
}

template <bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long n_src = a.src_base[a.n_rel];
  const long long blocks = n_src / kBlockRows;
  const bool logits = a.dz != nullptr;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    if (logits)
      csc_rows_kernel<VEC, NV, true>
          <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    else
      csc_rows_kernel<VEC, NV, false>
          <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!logits) return cudaSuccess;
  slot_sum_kernel<<<dim3(a.n_rel, (a.d + 31) / 32), kWarps * 32, 0, stream>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). Device pointers except
// src_base, a host array of n_rel + 1 source-row boundaries, each a
// multiple of 64 (the wrapper checks, as it checks 16-byte alignment of the
// float4 rows when D % 128 == 0). fold: 1 when g is the folded [N, D]
// cotangent. w may be null (weight 1); dz null (no logit term) leaves att,
// d_att and partial unread and unwritten.
extern "C" int kgwas_csc_segment_sum(
    const void* g, const void* w, const void* dz, const void* xs,
    const void* att, const void* dst, const void* csc_perm,
    const void* csc_offsets, const long long* src_base, void* d_xs,
    void* d_att, void* partial, int n_rel, long long n_rows_per_rel, int fold,
    int d, void* stream) {
  if (n_rel < 1 || n_rel > kMaxSlots || d < 1 || d > kMaxD)
    return cudaErrorInvalidValue;
  Args a;
  a.g = static_cast<const float*>(g);
  a.w = static_cast<const float*>(w);
  a.dz = static_cast<const float*>(dz);
  a.xs = static_cast<const float*>(xs);
  a.att = static_cast<const float*>(att);
  a.dst = static_cast<const int*>(dst);
  a.csc_perm = static_cast<const int*>(csc_perm);
  a.csc_offsets = static_cast<const int*>(csc_offsets);
  a.d_xs = static_cast<float*>(d_xs);
  a.d_att = static_cast<float*>(d_att);
  a.partial = static_cast<float*>(partial);
  for (int r = 0; r <= n_rel; ++r) {
    if (src_base[r] % kBlockRows) return cudaErrorInvalidValue;
    a.src_base[r] = src_base[r];
  }
  a.n_rows_per_rel = n_rows_per_rel;
  a.n_rel = n_rel;
  a.fold = fold;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return launch<true, 1>(a, s);
    case 256: return launch<true, 2>(a, s);
    case 384: return launch<true, 3>(a, s);
    case 512: return launch<true, 4>(a, s);
    default: return launch<false, 1>(a, s);
  }
}
