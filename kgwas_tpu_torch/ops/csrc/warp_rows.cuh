// Feature rows held across the 32 lanes of a warp, and their dot products,
// shared by the port's kernels (merged_gat_fwd.cu, merged_gat_bwd.cu, csc_segment_sum.cu,
// csr_segment_sum.cu, segment_softmax_spmm_fwd.cu, segment_softmax_spmm_bwd.cu).
//
// A row of D float32 values is NV float4s per lane (D = 128 * NV, lane l
// holding columns 4 (32 k + l) .. + 3), so a warp reads or writes a row as
// 16-byte loads on neighbouring addresses; any other D <= 512 is up to
// kMaxCols scalars per lane at columns lane + 32 k.
//
// A bf16 row (the kernels' bf16 instances) is read into the same float
// registers at the same columns: at D = 128 * NV, 8 bytes (4 values) a
// lane per 128 columns, widened with __bfloat1622float2; any other even
// D, a value a lane per 32 columns. Every value of a bf16 row is exact in
// float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kgwas {

constexpr int kMaxCols = 16;  // generic rows: columns per lane (D <= 512)
constexpr unsigned kFull = 0xffffffffu;

// exp(x) as exp2(x * log2 e): the MUFU.EX2 path, a shorter chain than expf
__device__ __forceinline__ float fast_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool VEC, int NV>
struct Row {
  static constexpr int C = VEC ? 4 * NV : kMaxCols;
  float v[C];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* row, int lane, int d) {
    if (VEC) {
      const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float4 q = __ldg(p + k * 32 + lane);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int col = lane + 32 * k;
        v[k] = col < d ? __ldg(row + col) : 0.0f;
      }
    }
  }
  // the same columns of a bf16 row
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int lane,
                                       int d) {
    if (VEC) {
      const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const uint2 q = __ldg(p + k * 32 + lane);
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
        v[4 * k] = lo.x;
        v[4 * k + 1] = lo.y;
        v[4 * k + 2] = hi.x;
        v[4 * k + 3] = hi.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int col = lane + 32 * k;
        v[k] = col < d ? __bfloat162float(row[col]) : 0.0f;
      }
    }
  }
  // the same as load and store, for rows read or written once: the
  // cache-streaming forms (evict first), which leave L2 to the tables a
  // kernel gathers from
  __device__ __forceinline__ void load_once(const float* row, int lane,
                                            int d) {
    if (VEC) {
      const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float4 q = __ldcs(p + k * 32 + lane);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int col = lane + 32 * k;
        v[k] = col < d ? __ldcs(row + col) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store_once(float* row, int lane,
                                             int d) const {
    if (VEC) {
      float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
      for (int k = 0; k < NV; ++k)
        __stcs(p + k * 32 + lane,
               make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                           v[4 * k + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int col = lane + 32 * k;
        if (col < d) __stcs(row + col, v[k]);
      }
    }
  }
  __device__ __forceinline__ void store(float* row, int lane, int d) const {
    if (VEC) {
      float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
      for (int k = 0; k < NV; ++k)
        p[k * 32 + lane] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int col = lane + 32 * k;
        if (col < d) row[col] = v[k];
      }
    }
  }
};

// U per-lane partial sums p[0..U-1] summed over the warp, transposed: lane
// l returns the total of p[l / (32 / U)]. Each halving exchange sends the
// half of the values that the lane gives up and keeps the other half; the
// last 5 - log2 U steps are a plain butterfly. A fixed order: the same bits
// every run.
template <int U>
__device__ __forceinline__ float multi_sum(float (&p)[U], int lane) {
#pragma unroll
  for (int n = U, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? p[i] : p[i + n / 2];
      const float keep = upper ? p[i + n / 2] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / U; off > 0; off >>= 1)
    p[0] += __shfl_xor_sync(kFull, p[0], off);
  return p[0];
}

template <bool VEC, int NV>
__device__ __forceinline__ float row_dot(const Row<VEC, NV>& x,
                                         const Row<VEC, NV>& y) {
  float q = 0.0f;
#pragma unroll
  for (int c = 0; c < Row<VEC, NV>::C; ++c) q = fmaf(x.v[c], y.v[c], q);
  return q;
}

}  // namespace kgwas
