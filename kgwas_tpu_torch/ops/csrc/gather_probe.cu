// Gather probe for Hopper (sm_90a), plain C entry point: a measuring tool
// on no path of the package (chip_smoke.py runs it).
//
// How fast can the card gather random 512-byte rows? The segment kernels
// (merged_gat_fwd.cu, merged_gat_bwd.cu, segment_softmax_spmm_fwd.cu,
// segment_softmax_spmm_bwd.cu, csc_segment_sum.cu, csr_segment_sum.cu)
// each read one feature row of D = 128 floats per edge from a table of
// 10-230 MB, in the order of a layout's index stream. This kernel does that
// gather and nothing else: each warp takes a run of per_warp indices, reads
// them 32 at a time (one per lane), and sums their rows as float4 per lane
// with U rows in flight, into one output row per warp. Its time over the
// gathered bytes (n * 512) is the gather's rate, the floor of any kernel
// that gathers the same rows in the same order.
//
// kgwas_gather_probe_bf16 does the same on bf16 rows of D = 128 (256
// bytes: 8 bytes a lane, widened to float and summed as float4): the
// gather of the kernels' bf16 instances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per block

template <int U>
__global__ void __launch_bounds__(kWarps * 32)
gather_probe_kernel(const float4* __restrict__ table,
                    const int* __restrict__ idx, long long n,
                    long long per_warp, float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long beg = w * per_warp;
  const long long end = min(beg + per_warp, n);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long base = beg; base < end; base += 32) {
    const int cnt = static_cast<int>(min(32LL, end - base));
    const int my = lane < cnt ? idx[base + lane] : 0;
    for (int j = 0; j < cnt; j += U) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = __shfl_sync(kFull, my, min(j + u, cnt - 1));
        x[u] = __ldg(table + static_cast<size_t>(s) * 32 + lane);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < cnt) {
          acc.x += x[u].x;
          acc.y += x[u].y;
          acc.z += x[u].z;
          acc.w += x[u].w;
        }
      }
    }
  }
  if (beg < n) out[w * 32 + lane] = acc;
}

template <int U>
__global__ void __launch_bounds__(kWarps * 32)
gather_probe_bf16_kernel(const uint2* __restrict__ table,
                         const int* __restrict__ idx, long long n,
                         long long per_warp, float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long beg = w * per_warp;
  const long long end = min(beg + per_warp, n);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long base = beg; base < end; base += 32) {
    const int cnt = static_cast<int>(min(32LL, end - base));
    const int my = lane < cnt ? idx[base + lane] : 0;
    for (int j = 0; j < cnt; j += U) {
      uint2 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = __shfl_sync(kFull, my, min(j + u, cnt - 1));
        x[u] = __ldg(table + static_cast<size_t>(s) * 32 + lane);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < cnt) {
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&x[u].x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&x[u].y));
          acc.x += lo.x;
          acc.y += lo.y;
          acc.z += hi.x;
          acc.w += hi.y;
        }
      }
    }
  }
  if (beg < n) out[w * 32 + lane] = acc;
}

template <int U, typename T>
cudaError_t launch_bf16(const T* table, const int* idx, long long n,
                        long long per_warp, float4* out, cudaStream_t stream) {
  const long long warps = (n + per_warp - 1) / per_warp;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  gather_probe_bf16_kernel<U><<<static_cast<unsigned>(blocks), kWarps * 32,
                                0, stream>>>(table, idx, n, per_warp, out);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch(const float4* table, const int* idx, long long n,
                   long long per_warp, float4* out, cudaStream_t stream) {
  const long long warps = (n + per_warp - 1) / per_warp;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaSuccess;
  gather_probe_kernel<U><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                           stream>>>(table, idx, n, per_warp, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). table [T, 128] float32
// and out [ceil(n / per_warp), 128] 16-byte aligned, idx [n] int32 in
// 0..T-1, all device pointers; u (rows in flight per warp) 1, 2, 4, 8 or
// 16.
extern "C" int kgwas_gather_probe(const void* table, const void* idx,
                                  long long n, long long per_warp, void* out,
                                  int u, void* stream) {
  const float4* t = static_cast<const float4*>(table);
  const int* i = static_cast<const int*>(idx);
  float4* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_warp < 1) return cudaErrorInvalidValue;
  switch (u) {
    case 1: return launch<1>(t, i, n, per_warp, o, s);
    case 2: return launch<2>(t, i, n, per_warp, o, s);
    case 4: return launch<4>(t, i, n, per_warp, o, s);
    case 8: return launch<8>(t, i, n, per_warp, o, s);
    case 16: return launch<16>(t, i, n, per_warp, o, s);
    default: return cudaErrorInvalidValue;
  }
}

// table: [S, 128] bf16; out: [warps, 128] float32
extern "C" int kgwas_gather_probe_bf16(const void* table, const void* idx,
                                       long long n, long long per_warp,
                                       void* out, int u, void* stream) {
  const uint2* t = static_cast<const uint2*>(table);
  const int* i = static_cast<const int*>(idx);
  float4* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_warp < 1) return cudaErrorInvalidValue;
  switch (u) {
    case 1: return launch_bf16<1>(t, i, n, per_warp, o, s);
    case 2: return launch_bf16<2>(t, i, n, per_warp, o, s);
    case 4: return launch_bf16<4>(t, i, n, per_warp, o, s);
    case 8: return launch_bf16<8>(t, i, n, per_warp, o, s);
    case 16: return launch_bf16<16>(t, i, n, per_warp, o, s);
    default: return cudaErrorInvalidValue;
  }
}
