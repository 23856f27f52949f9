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
// Design. One warp per row, as in merged_gat_fwd.cu: the row's edge indices
// (and weights) load 32 at a time, one per lane, and are broadcast by
// shuffle; the next 32 are prefetched; source rows are read U at a time
// (float4 per lane at D % 128 == 0) and summed in registers in edge order.
// Every row is written, empty rows with 0. No atomics: two runs give the
// same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (x [S, D], src and w [E], row_offsets [n_rows + 1], out [n_rows, D]),
// against 2 D flops per edge: far below the card's float32 rate. The gather
// reads each source row once per edge, mostly from L2 (the SNP group's
// table is 21 MB at the 200k-SNP bench size). Each relation's trash row
// holds all of its pad edges (up to 511) and one warp walks them in
// sequence; the chain per edge is a load and an FMA, so that row costs
// little more than its bytes (as in csc_segment_sum.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::kFull;
using kgwas::kMaxCols;

constexpr int kWarps = 8;  // warps per block

struct Args {
  const float* x;          // [S, D]
  const int* src;          // [E]
  const int* row_offsets;  // [n_rows + 1]
  const float* w;          // [E] or null
  float* out;              // [n_rows, D]
  long long n_rows;
  int d;
};

template <bool VEC, int NV, bool WEIGHTED>
__global__ void __launch_bounds__(kWarps * 32)
csr_segment_sum_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = !VEC || NV > 2 ? 2 : 4;  // source rows in flight
  const int lane = threadIdx.x & 31;
  const long long o =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= a.n_rows) return;  // whole warp exits together

  const int beg = a.row_offsets[o];
  const int end = a.row_offsets[o + 1];
  R acc;
  acc.zero();
  int next_src = beg + lane < end ? a.src[beg + lane] : 0;
  float next_w = WEIGHTED && beg + lane < end ? a.w[beg + lane] : 1.0f;
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_src = next_src;
    const float my_w = next_w;
    // the next 32 edge indices load while these 32 are summed
    const bool more = base + 32 + lane < end;
    next_src = more ? a.src[base + 32 + lane] : 0;
    if (WEIGHTED) next_w = more ? a.w[base + 32 + lane] : 1.0f;
    for (int j = 0; j < cnt; j += U) {
      // a step past the row's end re-reads its last edge's row, masked below
      R x[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src_lane = min(j + u, cnt - 1);
        const int s = __shfl_sync(kFull, my_src, src_lane);
        wu[u] = WEIGHTED ? __shfl_sync(kFull, my_w, src_lane) : 1.0f;
        x[u].load(a.x + static_cast<size_t>(s) * a.d, lane, a.d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < cnt) {  // warp-uniform
#pragma unroll
          for (int c = 0; c < R::C; ++c)
            acc.v[c] = WEIGHTED ? fmaf(wu[u], x[u].v[c], acc.v[c])
                                : acc.v[c] + x[u].v[c];
        }
      }
    }
  }
  acc.store(a.out + o * a.d, lane, a.d);
}

template <bool VEC, int NV, bool WEIGHTED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  csr_segment_sum_kernel<VEC, NV, WEIGHTED>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
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

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; float4 rows need x and out 16-byte aligned when D % 128 == 0
// (the wrapper checks). w may be null: every weight 1.
extern "C" int kgwas_csr_segment_sum(const void* x, const void* src,
                                     const void* row_offsets, const void* w,
                                     void* out, long long n_rows, int d,
                                     void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s);
}
