// Feature rows held across the 32 lanes of a warp, shared by the port's
// kernels (merged_gat_fwd.cu, merged_gat_bwd.cu, csc_segment_sum.cu,
// csr_segment_sum.cu, segment_softmax_spmm_fwd.cu, segment_softmax_spmm_bwd.cu).
//
// A row of D float32 values is NV float4s per lane (D = 128 * NV, lane l
// holding columns 4 (32 k + l) .. + 3), so a warp reads or writes a row as
// 16-byte loads on neighbouring addresses; any other D <= 512 is up to
// kMaxCols scalars per lane at columns lane + 32 k.
#pragma once

#include <cuda_runtime.h>

namespace kgwas {

constexpr int kMaxCols = 16;  // generic rows: columns per lane (D <= 512)
constexpr unsigned kFull = 0xffffffffu;

// exp(x) as exp2(x * log2 e): the MUFU.EX2 path, a shorter chain than expf
__device__ __forceinline__ float fast_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
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

}  // namespace kgwas
