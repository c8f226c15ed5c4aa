// The per-warp neighbourhood-moments walk: kernels K1 (moments.cu, over a
// class-major Morton sorted cloud) and K5 (moments_raw.cu, over a cloud in
// any layout, through an internal order), one source for both.
//
// For every valid point it sums, over the valid points of the same label
// within `radius` (self-inclusive), the ten moments n, Sx, Sy, Sz, Sxx,
// Syy, Szz, Sxy, Sxz, Syz of the neighbour's offset from the query point.
// The moments are centred on the query, so the sums stay O(r^2) and the
// f32 epilogue (cloud/covariance.py) loses no digits to cancellation.
//
// The walk works on an ordered cloud of n points (n % 32 == 0): point i of
// the order is raw point perm[i] (perm == nullptr: the identity), and
// points i >= n_raw pad it to whole chunks as invalid points. Its moments
// are stored straight to raw column perm[i] of `out`, so no pass restores
// the caller's order. The design (moments.cu says why):
//
// - `moments_prep_kernel` packs the ordered points as (x, y, z, label
//   bits) float4s and builds the 32-point chunk boxes with their bucket
//   ranges and each bucket's first and last chunk; `moments_tiles_kernel`
//   the boxes of 32-chunk tiles.
// - `moments_cost_kernel` finds each chunk's span (the chunks of its
//   buckets) and counts the chunks its warp's culling keeps (common.cuh
//   `cull_window`); the wrapper orders the warps heaviest first.
// - Persistent warps of `moments_walk_kernel` take them in that order off
//   an atomic counter. One warp sums all of a query's moments, in chunk
//   order, so the result does not depend on the run's order (no float
//   atomics). A kept chunk is staged as packed float4s in a warp-private
//   ring of two slots, the next one's loads in flight: one LDS.128
//   broadcast a pair.
//
// Labels: two points are neighbours only if their labels are equal (a
// negative label reads as 0). The culling works on buckets, min(label,
// num_classes): every label past the classes shares bucket num_classes, so
// the tables hold num_classes + 1 entries, while the pair test compares
// the labels themselves.
#pragma once

#include "common.cuh"

namespace {

using semicp::Box;
using semicp::kChunk;
using semicp::kFull;
using semicp::kWalkWarps;

// persistent warps of the walk on each SM (four blocks of kWalkWarps)
constexpr int kWarpsPerSm = 16;

// The culling's class of a label: min(label, num_classes), -1 invalid.
__device__ __forceinline__ int bucket(int lab, int num_classes) {
  return lab >= 0 ? min(lab, num_classes) : -1;
}

struct Unit {
  Box wb;
  int wcmin, wcmax;
  float4 p;  // this lane's point; p.w holds the label bits (-1 invalid)
  int lab;
  bool active;
  int2 span;
};

__device__ __forceinline__ Unit load_unit(const float4* __restrict__ pts4,
                                          const float4* __restrict__ chunk_box, int2 span,
                                          int u) {
  Unit s;
  s.wb = semicp::load_box(chunk_box, u);
  s.wcmin = static_cast<int>(s.wb.lo.w);
  s.wcmax = static_cast<int>(s.wb.hi.w);
  s.p = __ldg(pts4 + u * kChunk + (threadIdx.x & 31));
  s.lab = __float_as_int(s.p.w);
  s.active = s.lab >= 0;
  s.span = span;
  return s;
}

// qp: the warp's slot of 32 points in shared memory, filled with the
// unit's, each with its bucket as w (the culling's class test reads it)
__device__ __forceinline__ void stage_unit(const Unit& s, int num_classes,
                                           float4* __restrict__ qp) {
  __syncwarp();
  qp[threadIdx.x & 31] =
      make_float4(s.p.x, s.p.y, s.p.z, __int_as_float(bucket(s.lab, num_classes)));
  __syncwarp();
}

// Calls f(c0, mask) for each window of 32 chunks (an aligned tile of 1024
// points) of the unit's span whose tile box passes the warp-box and class
// test, with mask the chunks of it the warp walks. The tile test can only
// drop chunks the chunk test would drop too (a tile's box holds its
// chunks' boxes), so it changes the cost, not the walk. Tiles are tested
// 32 at a time, one a lane.
template <typename F>
__device__ __forceinline__ void unit_windows(const Unit& s,
                                             const float4* __restrict__ chunk_box,
                                             const float4* __restrict__ tile_box,
                                             const float4* __restrict__ qp, float lim, F&& f) {
  if (s.span.x > s.span.y) return;
  const int t_first = s.span.x / kChunk, t_last = s.span.y / kChunk;
  for (int t0 = t_first; t0 <= t_last; t0 += kChunk) {
    const int t = t0 + (threadIdx.x & 31);
    bool keep = false;
    if (t <= t_last) {
      const Box b = semicp::load_box(tile_box, t);
      keep = semicp::box_gap2(s.wb.lo, s.wb.hi, b.lo, b.hi) <= lim &&
             static_cast<int>(b.lo.w) <= s.wcmax && s.wcmin <= static_cast<int>(b.hi.w);
    }
    unsigned tiles = __ballot_sync(kFull, keep);
    while (tiles) {
      const int c0 = (t0 + __ffs(tiles) - 1) * kChunk;
      tiles &= tiles - 1;
      f(c0, semicp::cull_window<true>(chunk_box, c0, max(s.span.x, c0),
                                      min(s.span.y, c0 + kChunk - 1), s.wb, s.wcmin, s.wcmax,
                                      qp, lim));
    }
  }
}

// One warp per chunk of the ordered cloud: its points packed as (x, y, z,
// label bits), read from raw column perm[i] of the (3, n_raw) planes, its
// box and bucket range (the layout of corr/layout.py `pack_boxes`; an
// empty chunk has cmin = K + 1 > cmax = -1), and the first and last chunk
// of each bucket it holds (atomics, one lane a bucket).
__global__ void __launch_bounds__(128)
moments_prep_kernel(const float* __restrict__ xyz, const int* __restrict__ label,
                    const bool* __restrict__ valid, const long long* __restrict__ perm, int n,
                    int n_raw, int num_classes, float4* __restrict__ pts4,
                    float4* __restrict__ chunk_box, int* __restrict__ first,
                    int* __restrict__ last) {
  const int u = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (u >= n / kChunk) return;  // uniform across the warp
  const int i = u * kChunk + lane;
  const bool in = i < n_raw;
  const int r = in ? (perm ? static_cast<int>(perm[i]) : i) : 0;
  const float x = in ? xyz[r] : 0.f, y = in ? xyz[n_raw + r] : 0.f;
  const float z = in ? xyz[2 * n_raw + r] : 0.f;
  const bool v = in && valid[r];
  const int lab = v ? max(label[r], 0) : -1;
  const int bk = bucket(lab, num_classes);
  pts4[i] = make_float4(x, y, z, __int_as_float(lab));
  Box b = semicp::warp_box(x, y, z, v);
  int cmin = v ? bk : num_classes + 1, cmax = bk;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cmin = min(cmin, __shfl_xor_sync(kFull, cmin, off));
    cmax = max(cmax, __shfl_xor_sync(kFull, cmax, off));
  }
  if (lane == 0) {
    b.lo.w = static_cast<float>(cmin);
    b.hi.w = static_cast<float>(cmax);
    chunk_box[2 * u] = b.lo;
    chunk_box[2 * u + 1] = b.hi;
  }
  const unsigned peers = __match_any_sync(kFull, bk);
  if (v && lane == __ffs(peers) - 1) {
    atomicMin(first + bk, u);
    atomicMax(last + bk, u);
  }
}

// One warp per tile of 32 chunks: the tile's box and class range, the
// union of its chunks'.
__global__ void __launch_bounds__(128)
moments_tiles_kernel(const float4* __restrict__ chunk_box, int nc, float4* __restrict__ tile_box) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= (nc + kChunk - 1) / kChunk) return;  // uniform across the warp
  const int c = t * kChunk + lane;
  const float inf = semicp::pos_inf();
  Box b = {make_float4(inf, inf, inf, 3.0e9f), make_float4(-inf, -inf, -inf, -1.f)};
  if (c < nc) b = semicp::load_box(chunk_box, c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    b.lo.x = fminf(b.lo.x, __shfl_xor_sync(kFull, b.lo.x, off));
    b.lo.y = fminf(b.lo.y, __shfl_xor_sync(kFull, b.lo.y, off));
    b.lo.z = fminf(b.lo.z, __shfl_xor_sync(kFull, b.lo.z, off));
    b.lo.w = fminf(b.lo.w, __shfl_xor_sync(kFull, b.lo.w, off));
    b.hi.x = fmaxf(b.hi.x, __shfl_xor_sync(kFull, b.hi.x, off));
    b.hi.y = fmaxf(b.hi.y, __shfl_xor_sync(kFull, b.hi.y, off));
    b.hi.z = fmaxf(b.hi.z, __shfl_xor_sync(kFull, b.hi.z, off));
    b.hi.w = fmaxf(b.hi.w, __shfl_xor_sync(kFull, b.hi.w, off));
  }
  if (lane == 0) {
    tile_box[2 * t] = b.lo;
    tile_box[2 * t + 1] = b.hi;
  }
}

// One warp per chunk: its span (the first and last chunk holding a bucket
// of its range, each <= num_classes) and the number of chunks its walk
// visits.
__global__ void __launch_bounds__(128)
moments_cost_kernel(const float4* __restrict__ pts4, const float4* __restrict__ chunk_box,
                    const float4* __restrict__ tile_box, const int* __restrict__ first,
                    const int* __restrict__ last, const float* __restrict__ radius, int nc,
                    int num_classes, int2* __restrict__ span, int* __restrict__ count) {
  const int u = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (u >= nc) return;  // uniform across the warp
  const Box wb = semicp::load_box(chunk_box, u);
  int2 sp = make_int2(nc, -1);
  for (int k = static_cast<int>(wb.lo.w); k <= static_cast<int>(wb.hi.w); ++k) {
    sp.x = min(sp.x, first[k]);
    sp.y = max(sp.y, last[k]);
  }
  if ((threadIdx.x & 31) == 0) span[u] = sp;
  __shared__ float4 qp_all[4][kChunk];
  float4* qp = qp_all[threadIdx.x >> 5];
  const Unit s = load_unit(pts4, chunk_box, sp, u);
  stage_unit(s, num_classes, qp);
  const float lim = semicp::limit2(*radius);
  int total = 0;
  unit_windows(s, chunk_box, tile_box, qp, lim,
               [&](int, unsigned mask) { total += __popc(mask); });
  if ((threadIdx.x & 31) == 0) count[u] = total;
}

// Persistent warps over the chunks in `order`: each sums its 32 points'
// moments over the chunks its culling keeps and stores them to raw column
// perm[qi] of out (10, n_raw).
__global__ void __launch_bounds__(kWalkWarps * 32)
moments_walk_kernel(const float4* __restrict__ pts4, const float4* __restrict__ chunk_box,
                    const float4* __restrict__ tile_box, const int2* __restrict__ span,
                    const int* __restrict__ order, const long long* __restrict__ perm,
                    const float* __restrict__ radius, int nc, int n_raw, int num_classes,
                    unsigned* __restrict__ counter, float* __restrict__ out) {
  __shared__ float4 ring_all[kWalkWarps][2][kChunk];
  __shared__ float4 qp_all[kWalkWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  float4* qp = qp_all[warp];
  const int lane = threadIdx.x & 31;
  const float r = *radius;
  const float r2 = r * r;
  const float lim = semicp::limit2(r);
  int slot = 0;

  for (;;) {
    unsigned idx = 0;
    if (lane == 0) idx = atomicAdd(counter, 1u);
    idx = __shfl_sync(kFull, idx, 0);
    if (idx >= static_cast<unsigned>(nc)) break;
    const int u = order[idx];
    const Unit s = load_unit(pts4, chunk_box, __ldg(span + u), u);
    stage_unit(s, num_classes, qp);
    const float qx = s.p.x, qy = s.p.y, qz = s.p.z;
    const int ql = s.active ? s.lab : -2;  // an invalid query matches nothing

    float m[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) m[j] = 0.f;

    unit_windows(s, chunk_box, tile_box, qp, lim, [&](int c0, unsigned mask) {
      int c = mask ? __ffs(mask) - 1 : -1;
      if (c < 0) return;
      mask &= mask - 1;
      float4 nxt = __ldg(pts4 + (c0 + c) * kChunk + lane);
      while (c >= 0) {
        float4* sp = ring_all[warp][slot];
        sp[lane] = nxt;
        __syncwarp();
        c = mask ? __ffs(mask) - 1 : -1;
        if (c >= 0) {
          mask &= mask - 1;
          nxt = __ldg(pts4 + (c0 + c) * kChunk + lane);
        }
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) {
          const float4 t = sp[j];
          const float dx = t.x - qx, dy = t.y - qy, dz = t.z - qz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < r2 && __float_as_int(t.w) == ql) {
            m[0] += 1.f;
            m[1] += dx; m[2] += dy; m[3] += dz;
            m[4] += dx * dx; m[5] += dy * dy; m[6] += dz * dz;
            m[7] += dx * dy; m[8] += dx * dz; m[9] += dy * dz;
          }
        }
        slot ^= 1;
      }
    });
    const int qi = u * kChunk + lane;
    if (qi < n_raw) {
      const int col = perm ? static_cast<int>(__ldg(perm + qi)) : qi;
#pragma unroll
      for (int j = 0; j < 10; ++j) out[static_cast<size_t>(j) * n_raw + col] = m[j];
    }
  }
}

// The metadata and cost pass over the ordered cloud of n points (n % 32 ==
// 0): memsets of the bucket tables, then the prep, tile and cost kernels.
// Outputs and scratch as semicp_moments_cost (moments.cu) documents them.
cudaError_t launch_moments_cost(const float* xyz, const int* label, const bool* valid,
                                const long long* perm, const float* radius, int n, int n_raw,
                                int num_classes, float* pts4, float* chunk_box,
                                float* tile_box, int* span, int* first_last, int* count,
                                cudaStream_t stream) {
  const int nc = n / kChunk;
  const int nb = num_classes + 1;  // buckets: the classes, then every label past them
  int* first = first_last;
  int* last = first_last + nb;
  // 0x7f7f7f7f: after every chunk index; 0xffffffff: -1
  cudaError_t err = cudaMemsetAsync(first, 0x7f, nb * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(last, 0xff, nb * sizeof(int), stream)) != cudaSuccess) return err;
  moments_prep_kernel<<<(nc + 3) / 4, 128, 0, stream>>>(
      xyz, label, valid, perm, n, n_raw, num_classes, reinterpret_cast<float4*>(pts4),
      reinterpret_cast<float4*>(chunk_box), first, last);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nt = (nc + kChunk - 1) / kChunk;
  moments_tiles_kernel<<<(nt + 3) / 4, 128, 0, stream>>>(
      reinterpret_cast<const float4*>(chunk_box), nc, reinterpret_cast<float4*>(tile_box));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  moments_cost_kernel<<<(nc + 3) / 4, 128, 0, stream>>>(
      reinterpret_cast<const float4*>(pts4), reinterpret_cast<const float4*>(chunk_box),
      reinterpret_cast<const float4*>(tile_box), first, last, radius, nc, num_classes,
      reinterpret_cast<int2*>(span), count);
  return cudaGetLastError();
}

// The walk over the ordered cloud of n points, on the persistent grid.
cudaError_t launch_moments_walk(const float* pts4, const float* chunk_box, const float* tile_box,
                                const int* span, const int* order, const long long* perm,
                                const float* radius, int n, int n_raw, int num_classes,
                                unsigned* counter, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream)) != cudaSuccess) return err;
  moments_walk_kernel<<<sms * kWarpsPerSm / kWalkWarps, kWalkWarps * 32, 0, stream>>>(
      reinterpret_cast<const float4*>(pts4), reinterpret_cast<const float4*>(chunk_box),
      reinterpret_cast<const float4*>(tile_box), reinterpret_cast<const int2*>(span), order,
      perm, radius, n / kChunk, n_raw, num_classes, counter, out);
  return cudaGetLastError();
}

}  // namespace
