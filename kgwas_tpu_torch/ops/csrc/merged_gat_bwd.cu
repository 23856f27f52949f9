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
// Design. One warp per output row, as in merged_gat_fwd.cu: per destination
// node when folding, so the node's cotangent row g[n] is loaded once for
// its R slot rows. Pass 1 walks the row's edges U at a time: each edge's
// source row is read from xs (float4 per lane at D % 128 == 0), its two dot
// products (with att and with g) reduce in one interleaved butterfly, and
// the warp sums dot_row. The lane whose index is the edge's position in its
// group of 32 keeps z_e and m_e and stores them into w and dz. Pass 2 reads
// them back (each lane its own positions, so no fence is needed), turns
// them into the final w_e and dz_e and sums dz over the row. Every sum is
// taken in a fixed order with no atomics: two runs give the same bits.
//
// What bounds it. Bytes: each input read once and each output written once
// (xs [S, D], g [N or R*N, D], src [E], w and dz [E], row_offsets, a_dst,
// row_max, row_sum and d_a_dst [R*N]), a few hundred MB per layer at the
// bench size. As in the forward, each relation's trash row holds all of its
// pad edges (up to 511), and one warp walks them in sequence: those rows are
// bound by the latency of their own per-edge chain, not by bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_rows.cuh"

namespace {

using kgwas::fast_exp;
using kgwas::kFull;
using kgwas::kMaxCols;

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
  const float* row_max;     // [R*N]
  const float* row_sum;     // [R*N]
  const float* g;           // [n_out_rows, D]
  float* w;                 // [E]
  float* dz;                // [E]
  float* d_a_dst;           // [R*N]
  long long n_out_rows;     // N (fold) or R*N
  long long n_rows_per_rel; // N
  int fold_slots;           // R (fold) or 1
  int d;
  float slope;
  float temperature;
};

template <int MODE, bool VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
merged_gat_bwd_kernel(const Args a) {
  using R = kgwas::Row<VEC, NV>;
  constexpr int U = !VEC || NV > 2 ? 2 : 4;  // edges per step
  const int lane = threadIdx.x & 31;
  const long long o =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (o >= a.n_out_rows) return;  // whole warp exits together

  // lane r holds slot r's row bounds, a_dst and log-sum-exp
  const long long row0 = a.fold_slots > 1 ? o : o % a.n_rows_per_rel;
  const long long slot0 = a.fold_slots > 1 ? 0 : o / a.n_rows_per_rel;
  int my_beg = 0, my_end = 0;
  float my_ad = 0.0f, my_lse = 0.0f;
  if (lane < a.fold_slots) {
    const long long row = (slot0 + lane) * a.n_rows_per_rel + row0;
    my_beg = a.row_offsets[row];
    my_end = a.row_offsets[row + 1];
    my_ad = a.a_dst[row];
    if (MODE == kSoftmax) my_lse = a.row_max[row] + logf(a.row_sum[row] + kEps);
  }

  const float inv_t = 1.0f / a.temperature;
  const float slope_t = a.slope / a.temperature;
  R gr;  // the cotangent row: g[n] with the fold, g[row] without
  gr.load(a.g + o * a.d, lane, a.d);
  for (int r = 0; r < a.fold_slots; ++r) {
    const long long slot = slot0 + r;
    const long long row = slot * a.n_rows_per_rel + row0;
    R att;
    att.load(a.att + slot * a.d, lane, a.d);
    const float ad = __shfl_sync(kFull, my_ad, r);
    const float lse = __shfl_sync(kFull, my_lse, r);
    const int beg = __shfl_sync(kFull, my_beg, r);
    const int end = __shfl_sync(kFull, my_end, r);

    // pass 1: z_e and m_e of every edge, and dot_row
    float dot = 0.0f;
    int next_src = beg + lane < end ? a.src[beg + lane] : 0;
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      const int my_src = next_src;
      next_src = base + 32 + lane < end ? a.src[base + 32 + lane] : 0;
      float my_z = 0.0f, my_m = 0.0f;
      for (int j = 0; j < cnt; j += U) {
        // U source rows in flight; a step past the end re-reads the last
        // edge's row and is masked below
        R x[U];
        float pa[U], pm[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = __shfl_sync(kFull, my_src, min(j + u, cnt - 1));
          x[u].load(a.xs + static_cast<size_t>(s) * a.d, lane, a.d);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.0f, q = 0.0f;
#pragma unroll
          for (int c = 0; c < R::C; ++c) {
            p = fmaf(x[u].v[c], att.v[c], p);
            q = fmaf(x[u].v[c], gr.v[c], q);
          }
          pa[u] = p;
          pm[u] = q;
        }
        // xor butterfly: every lane ends with the same sums
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            pa[u] += __shfl_xor_sync(kFull, pa[u], off);
            pm[u] += __shfl_xor_sync(kFull, pm[u], off);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float z = pa[u] + ad;
          if (lane == j + u) {
            my_z = z;
            my_m = pm[u];
          }
          if (MODE == kSoftmax && j + u < cnt) {  // warp-uniform
            const float l = z >= 0.0f ? z * inv_t : z * slope_t;
            dot = fmaf(fast_exp(fminf(l - lse, kExpClamp)), pm[u], dot);
          }
        }
      }
      if (base + lane < end) {
        a.w[base + lane] = my_z;
        a.dz[base + lane] = my_m;
      }
    }

    // pass 2: each lane finishes the edges it stored
    float da = 0.0f;
    for (int i = beg + lane; i < end; i += 32) {
      const float z = a.w[i];
      const float m = a.dz[i];
      const float l = z >= 0.0f ? z * inv_t : z * slope_t;
      const float kd = z >= 0.0f ? inv_t : slope_t;  // leaky'(z) / T
      float wt, dzv;
      if (MODE == kSoftmax) {
        wt = fast_exp(fminf(l - lse, kExpClamp));
        dzv = wt * (m - dot) * kd;
      } else if (MODE == kSigmoid) {
        wt = 1.0f / (1.0f + fast_exp(-l));
        dzv = m * wt * (1.0f - wt) * kd;
      } else {
        wt = l * a.temperature;
        dzv = z >= 0.0f ? m : m * a.slope;
      }
      a.w[i] = wt;
      a.dz[i] = dzv;
      da += dzv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(kFull, da, off);
    if (lane == 0) a.d_a_dst[row] = da;
  }
}

template <int MODE, bool VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.n_out_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  merged_gat_bwd_kernel<MODE, VEC, NV>
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
// pointers; float4 rows need xs, att and g 16-byte aligned when D % 128 ==
// 0 (the wrapper checks). mode: 0 softmax, 1 sigmoid, 2 raw.
extern "C" int kgwas_merged_gat_bwd(
    const void* xs, const void* src, const void* row_offsets, const void* att,
    const void* a_dst, const void* row_max, const void* row_sum,
    const void* g, void* w, void* dz, void* d_a_dst, long long n_out_rows,
    long long n_rows_per_rel, int fold_slots, int d, int mode, float slope,
    float temperature, void* stream) {
  Args a;
  a.xs = static_cast<const float*>(xs);
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
