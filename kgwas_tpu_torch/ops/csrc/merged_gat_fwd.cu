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
// Design. One warp per output row: per destination node when folding, so
// the R slot rows are summed in registers, with no atomics, and every run
// gives the same bits. The [E, D] message stream is never written: each
// edge's source row is read straight from xs (float4 per lane when
// D % 128 == 0), a_src is a warp-shuffle reduction against att[slot], and
// the softmax state lives in registers. Edge indices are loaded 32 at a
// time, one per lane, broadcast by shuffle, and the next 32 prefetched. A
// row's edges are taken U at a time (4 at D = 128): their U row loads are
// issued together, their U dot products reduce in one interleaved
// butterfly, and the softmax state is rescaled once per U edges.
//
// What bounds it. Each relation's trash row holds all of its pad edges (up
// to 511), and with the fold one warp walks them for every slot. Such a
// long row is bound by the latency of its own per-edge instruction chain
// (load, dot, 5 shuffles, logit, exp), not by bytes, so the chain avoids
// divisions and expf. Splitting long rows over several warps is the next
// step.
//
// Bound on this card. The least traffic is each input read once and each
// output written once: xs_all [S, D], src [E], row_offsets [R*N+1],
// a_dst [R*N], att [R, D], out [N or R*N, D], row_max and row_sum [R*N],
// all 4-byte words. At the 200k-SNP synthetic KG and D = 128 that is a few
// hundred MB per layer (~0.1 ms at 3.35 TB/s), against 4*D flops per edge
// (~1.7 GFLOP per layer, ~26 us at 67 TFLOP/s f32). The gather reads each
// source row once per edge; the tables (21 MB for the SNP group) mostly fit
// the 50 MB L2, so gathered bytes beyond the bound come from L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kFull;
using kgwas::kMaxCols;

constexpr float kNegBig = -1e9f;
constexpr float kExpClamp = 60.0f;
constexpr float kEps = 1e-16f;
constexpr int kWarps = 8;     // warps per block

enum Mode { kSoftmax = 0, kSigmoid = 1, kRaw = 2 };

struct Args {
  const float* xs;          // [S, D]
  const int* src;           // [E]
  const int* row_offsets;   // [R*N + 1]
  const float* att;         // [R, D]
  const float* a_dst;       // [R*N]
  float* out;               // [n_out_rows, D]
  float* row_max;           // [R*N]
  float* row_sum;           // [R*N]
  long long n_out_rows;     // N (fold) or R*N
  long long n_rows_per_rel; // N
  int fold_slots;           // R (fold) or 1
  int d;
  float slope;
  float temperature;
};

// leaky_relu(a_src + a_dst) / temperature, with the division folded into
// two multipliers (inv_t = 1/t, slope_t = slope/t): a long row is bound by
// its instruction chain, and a division is the longest link
__device__ __forceinline__ float edge_logit(float a_src, float a_dst,
                                            float slope_t, float inv_t) {
  const float z = a_src + a_dst;
  return z >= 0.0f ? z * inv_t : z * slope_t;
}

template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_fwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  // edges per step: as many rows in flight as the registers allow
  constexpr int U = !VEC || NV > 2 ? 2 : 4;
  const int lane = threadIdx.x & 31;
  const long long o =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= a.n_out_rows) return;  // whole warp exits together

  // one round trip for every slot's row bounds and a_dst: lane r holds
  // slot r's (fold_slots <= 32)
  const long long row0 = a.fold_slots > 1 ? o : o % a.n_rows_per_rel;
  const long long slot0 = a.fold_slots > 1 ? 0 : o / a.n_rows_per_rel;
  int my_beg = 0, my_end = 0;
  float my_ad = 0.0f;
  if (lane < a.fold_slots) {
    const long long row = (slot0 + lane) * a.n_rows_per_rel + row0;
    my_beg = a.row_offsets[row];
    my_end = a.row_offsets[row + 1];
    my_ad = a.a_dst[row];
  }

  const float inv_t = 1.0f / a.temperature;
  const float slope_t = a.slope / a.temperature;
  R res;
  res.zero();
  for (int r = 0; r < a.fold_slots; ++r) {
    const long long slot = slot0 + r;
    const long long row = slot * a.n_rows_per_rel + row0;
    R att;
    att.load(a.att + slot * a.d, lane, a.d);
    const float ad = __shfl_sync(kFull, my_ad, r);
    const int beg = __shfl_sync(kFull, my_beg, r);
    const int end = __shfl_sync(kFull, my_end, r);

    float m = kNegBig;
    float ssum = 0.0f;
    R acc;
    acc.zero();
    int next_src = beg + lane < end ? a.src[beg + lane] : 0;
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      const int my_src = next_src;
      // the next 32 edge indices load while these 32 edges are scored
      next_src = base + 32 + lane < end ? a.src[base + 32 + lane] : 0;
      for (int j = 0; j < cnt; j += U) {
        // U source rows in flight: the loads are unconditional (a step
        // past the row's end re-reads its last edge's row and is masked
        // below), so the compiler issues all U before the first use
        R x[U];
        float l[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = __shfl_sync(kFull, my_src, min(j + u, cnt - 1));
          x[u].load(a.xs + static_cast<size_t>(s) * a.d, lane, a.d);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.0f;
#pragma unroll
          for (int c = 0; c < R::C; ++c) p = fmaf(x[u].v[c], att.v[c], p);
          l[u] = p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) l[u] += __shfl_xor_sync(kFull, l[u], off);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          l[u] = edge_logit(l[u], ad, slope_t, inv_t);
        if (MODE == kSoftmax) {
          // one rescale per U edges, as the TPU kernel rescales once per
          // edge window
          float m_new = m;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (j + u < cnt) m_new = fmaxf(m_new, l[u]);
          const float scale = fast_exp(fminf(m - m_new, 0.0f));
          ssum *= scale;
#pragma unroll
          for (int c = 0; c < R::C; ++c) acc.v[c] *= scale;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j + u < cnt) {  // cnt is warp-uniform
              const float w = fast_exp(fminf(l[u] - m_new, kExpClamp));
              ssum += w;
#pragma unroll
              for (int c = 0; c < R::C; ++c)
                acc.v[c] = fmaf(w, x[u].v[c], acc.v[c]);
            }
          }
          m = m_new;
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j + u < cnt) {
              const float w = MODE == kSigmoid ? 1.0f / (1.0f + fast_exp(-l[u]))
                                               : l[u] * a.temperature;
#pragma unroll
              for (int c = 0; c < R::C; ++c)
                acc.v[c] = fmaf(w, x[u].v[c], acc.v[c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < R::C; ++c) {
      // division, not a multiply by the reciprocal: the same rounding as
      // the plain version's acc / (sum + eps)
      res.v[c] += MODE == kSoftmax ? acc.v[c] / (ssum + kEps) : acc.v[c];
    }
    if (lane == 0) {
      a.row_max[row] = m;
      a.row_sum[row] = ssum;
    }
  }
  res.store(a.out + o * a.d, lane, a.d);
}

template <int MODE, bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_out_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  merged_gat_fwd_kernel<MODE, VEC, NV>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
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

}  // namespace

// Returns the launch's cudaError_t (0 on success). Pointers are device
// pointers; float4 rows need xs, att and out 16-byte aligned when D % 128
// == 0 (the wrapper checks). mode: 0 softmax, 1 sigmoid, 2 raw.
extern "C" int kgwas_merged_gat_fwd(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, void* out, void* row_max, void* row_sum,
    long long n_out_rows, long long n_rows_per_rel, int fold_slots, int d,
    int mode, float slope, float temperature, void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
  a.src = static_cast<const int*>(src);
  a.row_offsets = static_cast<const int*>(row_offsets);
  a.att = static_cast<const float*>(att);
  a.a_dst = static_cast<const float*>(a_dst);
  a.out = static_cast<float*>(out);
  a.row_max = static_cast<float*>(row_max);
  a.row_sum = static_cast<float*>(row_sum);
  a.n_out_rows = n_out_rows;
  a.n_rows_per_rel = n_rows_per_rel;
  a.fold_slots = fold_slots;
  a.d = d;
  a.slope = slope;
  a.temperature = temperature;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSoftmax: return dispatch_width<kSoftmax>(a, s);
    case kSigmoid: return dispatch_width<kSigmoid>(a, s);
    case kRaw: return dispatch_width<kRaw>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
