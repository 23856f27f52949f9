// The static work schedule of the port's edge-stream kernels
// (merged_gat_fwd.cu, merged_gat_bwd.cu, segment_softmax_spmm_fwd.cu,
// csc_segment_sum.cu) and what a warp does with one of its items: find the
// item's rows, stage its edges' indices in shared memory, and gather their
// feature rows into a shared-memory ring with cp.async.
//
// A unit is one output row: a destination node when folding (its R slot
// rows r*N + n), else one row. The schedule (ops/schedule.py) is a list
// of items, in unit order, of two kinds (int4 each):
//
//   packed (u0, u1, -1, -1): units u0..u1-1, all their rows, at most
//       max_edges edges together and at most kItemMaxRows rows (the
//       merged GAT layer: at most kItemMaxUnits units);
//   chunk (row, part, e0, e1): edges e0..e1-1 (at most chunk_edges) of one
//       row of a unit with more than max_edges edges; its partial result
//       goes to scratch index part, and a second launch combines a unit's
//       parts in part order.
//
// Warps take the items from the last to the first: the pad units, and so
// each relation's trash row with its long chunks, sit at the end of the
// stream, and their chunks then start first.
//
// Inside an item the edges are taken in a virtual order, unit-major then
// slot (row k = i * F + r of unit i, slot r), each row's edges in stream
// order: the merged GAT kernels and the bf16 segment kernels through a
// cp.async ring of kGroup-row stages in shared memory, the float32 segment
// kernels gathering rows_in_flight rows into registers at a time.
#pragma once

#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace kgwas {

constexpr int kFwdMaxEdges = 512;   // most edges of a merged forward item
constexpr int kBwdMaxEdges = 256;   // most edges of the other kernels' items
constexpr int kItemMaxRows = 32;    // slot rows of a packed item: a lane each
constexpr int kItemMaxUnits = 8;    // units of a packed item
constexpr int kGroup = 8;           // edges per ring stage, 4 lanes each
constexpr int kStages = 2;          // ring stages: one loads, one is scored
constexpr float kNegBig = -1e9f;
constexpr float kEps = 1e-16f;
constexpr float kExpClamp = 60.0f;

enum Mode { kSoftmax = 0, kSigmoid = 1, kRaw = 2 };

// ---- cp.async: 16 bytes (.cg, L2 only) or 4 bytes (.ca) a lane
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this lane's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ring row length in floats: D, as float4s when VEC (the launch sizes the
// shared memory with it too: a __device__-only function called from the
// host compiles to a stub that exits the process)
template <bool VEC, int NV>
__host__ __device__ __forceinline__ int row_len(int d) {
  return VEC ? 128 * NV : d;
}

// one feature row from global to shared memory, the warp's lanes together
template <bool VEC, int NV>
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int lane, int d) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      cp_async16(dst + 4 * (32 * k + lane), src + 4 * (32 * k + lane));
  } else {
    for (int c = lane; c < d; c += 32) cp_async4(dst + c, src + c);
  }
}

// Lane part p (0..3) of edge q's dot products of its ring row with a (a
// global row, read through the read-only cache) and, with TWO, with b (a
// shared-memory row). With float4 rows part p takes the float4 columns
// 4t + p, in an order rotated by q, so that the 8 lanes of a quarter warp
// (2 edges, 4 parts) hit 8 different float4 banks.
template <bool VEC, int NV, bool TWO>
__device__ __forceinline__ void part_dots(const float* row, const float* a,
                                          const float* b, int q, int p,
                                          int d, float& da, float& db) {
  da = 0.0f;
  db = 0.0f;
  if (VEC) {
    constexpr int T = 8 * NV;  // float4 columns per part
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      int t = j + q;
      if (t >= T) t -= T;
      const int c = 4 * t + p;
      const float4 x = r4[c];
      const float4 y = __ldg(a4 + c);
      da = fmaf(x.x, y.x, da);
      da = fmaf(x.y, y.y, da);
      da = fmaf(x.z, y.z, da);
      da = fmaf(x.w, y.w, da);
      if (TWO) {
        const float4 z = b4[c];
        db = fmaf(x.x, z.x, db);
        db = fmaf(x.y, z.y, db);
        db = fmaf(x.z, z.z, db);
        db = fmaf(x.w, z.w, db);
      }
    }
  } else {
    for (int c = p; c < d; c += 4) {
      da = fmaf(row[c], __ldg(a + c), da);
      if (TWO) db = fmaf(row[c], b[c], db);
    }
  }
}

// The warp's view of its item. Lane k < n_rows holds slot row k's values.
struct ItemRows {
  bool chunk;
  int n_rows;       // slot rows of the item
  int n_units;      // units of a packed item (1 for a chunk)
  int part;         // a chunk's scratch index
  long long unit0;  // the item's first unit
  int total;        // edges of the item
  // lane k's row
  long long row;
  int beg, cnt, vbeg, slot;
};

// items[i] of the schedule; fold_slots F is R with the fold, else 1
__device__ __forceinline__ ItemRows item_rows(const int4 it,
                                              const int* __restrict__ ro,
                                              long long n_per_rel, int F,
                                              int lane) {
  ItemRows r;
  r.chunk = it.z >= 0;
  int end = 0;
  r.beg = 0;
  r.row = 0;
  if (r.chunk) {
    r.n_rows = 1;
    r.n_units = 1;
    r.part = it.y;
    r.row = it.x;
    r.unit0 = F > 1 ? r.row % n_per_rel : r.row;
    if (lane == 0) {
      r.beg = it.z;
      end = it.w;
    }
  } else {
    r.part = 0;
    r.unit0 = it.x;
    r.n_units = it.y - it.x;
    r.n_rows = r.n_units * F;
    if (lane < r.n_rows) {
      const long long u = r.unit0 + lane / F;
      r.row = F > 1 ? (lane % F) * n_per_rel + u : u;
      r.beg = ro[r.row];
      end = ro[r.row + 1];
    }
  }
  r.slot = static_cast<int>(r.row / n_per_rel);
  r.cnt = lane < r.n_rows ? end - r.beg : 0;
  int x = r.cnt;  // inclusive scan of the counts
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  r.vbeg = x - r.cnt;
  r.total = __shfl_sync(0xffffffffu, x, 31);
  return r;
}

// The unit i = k / F of an item's row k < kItemMaxRows without an integer
// division (a sequence of some twenty instructions for a divisor known only
// at run time): (k * unit_multiplier(F)) >> 16, exact for k, F <= 32.
__device__ __forceinline__ int unit_multiplier(int F) {
  return (65536 + F - 1) / F;
}
__device__ __forceinline__ int unit_of(int k, int mul) {
  return (k * mul) >> 16;
}

// Stages the item's edges: s_src[v] and s_k[v] (its row) for each virtual
// edge v, from s_beg / s_vbeg (row k's first edge and first virtual edge).
// A row holding virtual edge v is the last row k with s_vbeg[k] <= v.
__device__ __forceinline__ void stage_edges(const ItemRows& r,
                                            const int* __restrict__ src,
                                            int* s_beg, int* s_vbeg,
                                            int* s_src, unsigned char* s_k,
                                            int lane) {
  if (lane < r.n_rows) {
    s_beg[lane] = r.beg;
    s_vbeg[lane] = r.vbeg;
  }
  __syncwarp();
  for (int v = lane; v < r.total; v += 32) {
    int lo = 0, hi = r.n_rows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_vbeg[mid] <= v) lo = mid; else hi = mid;
    }
    s_k[v] = static_cast<unsigned char>(lo);
    s_src[v] = src[s_beg[lo] + v - s_vbeg[lo]];
  }
  __syncwarp();
}

// s_val[v] = table[s_src[v]] for the item's total edges, up to 4 windows
// of 32 loads issued before any is stored
__device__ __forceinline__ void gather_edge_values(
    const float* __restrict__ table, const int* s_src, float* s_val,
    int total, int lane) {
  constexpr int W = 4;
  for (int v0 = 0; v0 < total; v0 += 32 * W) {
    float x[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = v0 + 32 * w + lane;
      x[w] = v < total ? table[s_src[v]] : 0.0f;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = v0 + 32 * w + lane;
      if (v < total) s_val[v] = x[w];
    }
  }
  __syncwarp();
}

// The row k of each virtual edge v, s_k[v], of an item whose rows' edges
// follow each other in the stream (F = 1: consecutive rows, or a chunk), so
// that virtual edge v is stream edge first + v. Returns first.
__device__ __forceinline__ int stage_row_keys(const ItemRows& r,
                                              unsigned char* s_k, int lane) {
  if (r.chunk) {
    for (int v = lane; v < r.total; v += 32) s_k[v] = 0;
  } else {
    for (int j = 0; j < r.cnt; ++j)  // lane k over row k's edges
      s_k[r.vbeg + j] = static_cast<unsigned char>(lane);
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, r.beg, 0);
}

// cp.async of group g's source rows (edges 8g .. 8g+7 of the item) into
// ring stage g % kStages; rows past the item's end are not loaded
template <bool VEC, int NV>
__device__ __forceinline__ void load_group(float* ring, int rl, int g,
                                           int total, const int* s_src,
                                           const float* __restrict__ xs,
                                           int lane, int d) {
  float* stage = ring + (g % kStages) * kGroup * rl;
  const int n = min(kGroup, total - g * kGroup);
  for (int q = 0; q < n; ++q)
    copy_row<VEC, NV>(stage + q * rl,
                      xs + static_cast<size_t>(s_src[g * kGroup + q]) * d,
                      lane, d);
}

// ---- bf16 rows through a ring (the merged GAT kernels' bf16 instances)
//
// A ring row holds a bf16 feature row as it lies in device memory: at
// D = 128 * NV its 256 * NV bytes, copied 16 bytes a lane (two rows a warp
// instruction at D = 128); at any other even D its 2D bytes, 4 bytes a
// lane. A lane reads back the columns Row<VEC, NV>::load gives it from
// device memory, so a dot over ring rows sums in the same order.

// ring row length in 32-bit words (the launch sizes shared memory with it)
template <bool VEC, int NV>
__host__ __device__ __forceinline__ int row_words_bf16(int d) {
  return VEC ? 64 * NV : d / 2;
}

// ring stages of kGroup rows: two, one loading while one is used (at
// D = 128, 3 or 4 stages cost warps per SM and measured slower at full
// width: the items' latency, not the rows in flight, bounds the kernels)
constexpr int kStagesBf16 = 2;

// cp.async of group g's bf16 source rows (edges 8g .. 8g+7 of the item)
// into stage g % S of a ring of S kGroup-row stages of rw words; at
// D = 128 * NV a lane's 4 * NV 16-byte pieces of the group unrolled, at
// offsets known when compiling (a loop that divided and tested each piece
// measured slower in #7 bf16, whose time goes to instructions)
template <bool VEC, int NV, int S = kStagesBf16>
__device__ __forceinline__ void load_group_bf16(
    unsigned* ring, int rw, int g, int total, const int* s_src,
    const __nv_bfloat16* __restrict__ xs, int lane, int d) {
  const int n = min(kGroup, total - g * kGroup);
  if (VEC) {
    constexpr int P = 16 * NV;  // 16-byte pieces of a row
    constexpr int W = 64 * NV;  // its words (rw)
    unsigned* stage = ring + (g % S) * kGroup * W;
    const int* src = s_src + g * kGroup;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) {
      const int i = lane + 32 * j, q = i / P, c = i % P;
      if (q < n)
        cp_async16(reinterpret_cast<float*>(stage + q * W + 4 * c),
                   reinterpret_cast<const float*>(
                       xs + static_cast<size_t>(src[q]) * (128 * NV)) +
                       4 * c);
    }
  } else {
    unsigned* stage = ring + (g % S) * kGroup * rw;
    for (int q = 0; q < n; ++q) {
      const float* row = reinterpret_cast<const float*>(
          xs + static_cast<size_t>(s_src[g * kGroup + q]) * d);
      for (int c = lane; c < rw; c += 32)
        cp_async4(reinterpret_cast<float*>(stage + q * rw + c), row + c);
    }
  }
}

// An item's bf16 source rows through a ring of S stages of kGroup rows
// (segment_softmax_spmm_bwd.cu, csr_segment_sum.cu): group g, edges
// 8g .. 8g+7 of the item, lands in stage g % S. start() puts groups
// 0 .. S-1 in flight. The caller reads edges in order, at most one group
// past the oldest group it has not read in full (done): ready(e) waits
// until edge e's group has landed, row(e) is edge e's ring row, and
// release(e), once every edge below e is read, refills the stage of a
// group read in full with the group S later. Every call commits one
// cp.async group, empty past the item's end, so that wait_group counts
// the same groups in every warp. The walks of #1, #2 and #6 bf16
// (merged_gat_fwd.cu, merged_gat_bwd.cu, segment_softmax_spmm_fwd.cu)
// read each group whole before the next, so they keep their own simpler
// step (refill the stage read last, then wait for the next group); #7
// bf16's 8-edge batches straddle groups, which this ring allows.
template <bool VEC, int NV, int S>
struct EdgeRing {
  unsigned* ring;
  int rw;        // ring row length in 32-bit words
  int total;     // edges of the item
  int n_groups;
  int done;      // groups read in full, their stages refilled
  const int* s_src;
  const __nv_bfloat16* xs;
  int lane, d;

  __device__ __forceinline__ EdgeRing(unsigned* ring_, int rw_, int total_,
                                      const int* s_src_,
                                      const __nv_bfloat16* xs_, int lane_,
                                      int d_)
      : ring(ring_), rw(VEC ? 64 * NV : rw_), total(total_),
        n_groups((total_ + kGroup - 1) / kGroup), done(0), s_src(s_src_),
        xs(xs_), lane(lane_), d(d_) {}

  // cp.async of group g's rows into its stage (past the end: none)
  __device__ __forceinline__ void fill(int g) {
    if (g < n_groups)
      load_group_bf16<VEC, NV, S>(ring, rw, g, total, s_src, xs, lane, d);
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int g = 0; g < S; ++g) {
      fill(g);
      cp_async_commit();
    }
  }
  // groups 0 .. S + done - 1 are committed: edge e's group, done or the
  // one after it, has landed once at most S - 1 or S - 2 are pending
  __device__ __forceinline__ void ready(int e) {
    if (e / kGroup == done)
      cp_async_wait<S - 1>();
    else
      cp_async_wait<S - 2>();
    __syncwarp();
  }
  __device__ __forceinline__ const unsigned* row(int e) const {
    const unsigned u = static_cast<unsigned>(e);
    return ring + (u / kGroup % S * kGroup + u % kGroup) * rw;
  }
  __device__ __forceinline__ void release(int e) {
    if (e / kGroup > done) {  // warp-uniform
      __syncwarp();           // every lane is done with its stage
      fill(done + S);
      cp_async_commit();
      ++done;
    }
  }
};

// a lane's columns of a bf16 ring row, widened to float32
template <bool VEC, int NV>
__device__ __forceinline__ void load_ring_bf16(Row<VEC, NV>& x,
                                               const unsigned* row, int lane,
                                               int d) {
  if (VEC) {
    const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const uint2 q = p[k * 32 + lane];
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
      x.v[4 * k] = lo.x;
      x.v[4 * k + 1] = lo.y;
      x.v[4 * k + 2] = hi.x;
      x.v[4 * k + 3] = hi.y;
    }
  } else {
    const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(row);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int col = lane + 32 * k;
      x.v[k] = col < d ? __bfloat162float(r[col]) : 0.0f;
    }
  }
}

// Rows of one register batch when a warp gathers feature rows into
// registers (gather_rows): 4 at D = 128, fewer for wider rows. The segment
// kernels keep two batches in flight, one summed while the next arrives.
template <bool VEC, int NV>
__host__ __device__ constexpr int rows_in_flight() {
  return VEC ? (NV == 1 ? 4 : NV == 2 ? 2 : 1) : 1;
}

// U feature rows of table (float or bf16) into registers, all loads
// issued before any is used: rows idx[v .. v+U-1] of a shared-memory index
// array of n entries (a step past its end re-reads the last row).
template <bool VEC, int NV, int U, typename T>
__device__ __forceinline__ void gather_rows(Row<VEC, NV> (&x)[U],
                                            const T* __restrict__ table,
                                            const int* idx, int v, int n,
                                            int lane, int d) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    x[u].load(table + static_cast<size_t>(idx[min(v + u, n - 1)]) * d, lane,
              d);
}

// Segmented sum over a window of 32 virtual edges (keys k sorted, key 255
// for lanes past the end): the last lane of each key's run adds the run's
// sum to acc[k]. Fixed order: two runs give the same bits.
__device__ __forceinline__ void segmented_add(float val, int k, float* acc,
                                              int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, val, off);
    const int ky = __shfl_up_sync(0xffffffffu, k, off);
    if (lane >= off && ky == k) val += y;
  }
  const int kn = __shfl_down_sync(0xffffffffu, k, 1);
  if (k != 255 && (lane == 31 || kn != k)) acc[k] += val;
  __syncwarp();
}

// The same with max: acc[k] = max(acc[k], the run's max).
__device__ __forceinline__ void segmented_max(float val, int k, float* acc,
                                              int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, val, off);
    const int ky = __shfl_up_sync(0xffffffffu, k, off);
    if (lane >= off && ky == k) val = fmaxf(val, y);
  }
  const int kn = __shfl_down_sync(0xffffffffu, k, 1);
  if (k != 255 && (lane == 31 || kn != k)) acc[k] = fmaxf(acc[k], val);
  __syncwarp();
}

// The combine of one chunked row: its parts p0..p1-1 merged in part order,
// by log-sum-exp of the softmax state (m, s, acc) when SOFTMAX, else a
// plain sum of acc. Gives the row's max mx (NEG_BIG without SOFTMAX), sum
// and acc.
template <bool VEC, int NV, bool SOFTMAX>
__device__ __forceinline__ void merge_parts(const float* __restrict__ part_m,
                                            const float* __restrict__ part_s,
                                            const float* __restrict__ part_acc,
                                            int p0, int p1, int lane, int d,
                                            float& mx, float& sum,
                                            Row<VEC, NV>& acc) {
  mx = kNegBig;
  sum = 0.0f;
  acc.zero();
  if (SOFTMAX)
    for (int pi = p0; pi < p1; ++pi) mx = fmaxf(mx, part_m[pi]);
  for (int pi = p0; pi < p1; ++pi) {
    Row<VEC, NV> x;
    x.load(part_acc + static_cast<size_t>(pi) * d, lane, d);
    const float sc = SOFTMAX ? fast_exp(part_m[pi] - mx) : 1.0f;
    if (SOFTMAX) sum = fmaf(part_s[pi], sc, sum);
#pragma unroll
    for (int c = 0; c < Row<VEC, NV>::C; ++c)
      acc.v[c] = fmaf(sc, x.v[c], acc.v[c]);
  }
}

// the item warp w of the launch takes: the last item first
__device__ __forceinline__ long long item_of_warp(long long w,
                                                  long long n_items) {
  return n_items - 1 - w;
}

// dynamic shared memory of one warp, in floats: the ring, g_rows more
// rows, the staging arrays of items of at most max_edges edges, and
// n_extra floats of scratch
__host__ __device__ inline int warp_smem_floats(int rl, int g_rows,
                                                int max_edges, int n_extra) {
  return (kStages * kGroup + g_rows) * rl +
         max_edges              // s_src
         + 2 * kItemMaxRows     // s_beg, s_vbeg
         + max_edges / 4        // s_k (bytes)
         + n_extra;
}

}  // namespace kgwas
