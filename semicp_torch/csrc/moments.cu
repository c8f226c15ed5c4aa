// Block-sparse neighbourhood moments (kernel K1).
//
// Replaces the Pallas kernel `neighborhood_moments_sparse` of the JAX
// package (semicp/cloud/pallas_cov.py, `_sparse_kernel`). For every point
// of a class-major Morton sorted cloud it sums, over the same-class valid
// points within `radius`, the ten moments n, Sx, Sy, Sz, Sxx, Syy, Szz,
// Sxy, Sxz, Syz of the neighbour's offset from the query point.
//
// Contract: the covariance after the epilogue (S2/n - mean mean^T,
// cloud/covariance.py), which is translation invariant. The moments are
// centred on the query itself, so the sums stay O(r^2) and the f32
// epilogue loses no digits to cancellation (the JAX kernel centres on
// the query tile's AABB midpoint for the same reason). Raw moments are
// not the contract.
//
// Bound on the H100: the f32 arithmetic on the walked pairs (about 10
// flops each: three differences, the squared distance, the compares;
// the ten sums are predicated). Device memory traffic is a few MB. The
// design answers the limits of the first port, which walked 256-query
// tiles against whole 512-point same-class target tiles, one block each:
//
// 1. The pruning unit is the warp. The query set is the target set, so a
//    query warp is a 32-point chunk of the cloud, and one set of chunk
//    boxes and class ranges (built once a call, cloud/moments.py) serves
//    both sides. A warp scans only the chunks of its classes' span of the
//    class-major order, and walks a chunk only if its box lies within the
//    radius of the warp's box and of one of its own points, with a class
//    range that holds that point's label (common.cuh `cull_window`).
// 2. Balance without splitting a sum. `moments_cost_kernel` counts the
//    chunks each warp will walk; the wrapper orders the warps heaviest
//    first (one argsort on the device), and persistent warps of
//    `moments_walk_kernel` take them in that order off an atomic counter.
//    One warp sums all of a query's moments, in chunk order, so the result
//    does not depend on the order of the run (no float atomics).
// 3. The inner loop is one LDS.128 broadcast per pair: a chunk is staged
//    as packed (x, y, z, label bits) float4s into a warp-private ring of
//    two slots, the next chunk's loads issued before the current one is
//    walked; only __syncwarp orders the ring.
// 4. No candidate lists and no torch metadata: `moments_prep_kernel`
//    packs the points and builds the chunk boxes and each class's first
//    and last chunk in one pass, the cost kernel turns those into each
//    chunk's span, and the culling runs on the device in both walks.
//
// Labels: two points are neighbours only if their labels are equal, as in
// the plain version, whatever the labels are (a negative label reads as
// 0, as the class-major sort reads it). The culling works on buckets,
// min(label, num_classes): every label past the classes shares bucket K,
// so the per-class tables hold K + 1 entries and are never indexed past
// them, while the pair test compares the labels themselves.

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

// One warp per chunk: its points packed as (x, y, z, label bits), its box
// and bucket range (the layout of corr/layout.py `pack_boxes`; an empty
// chunk has cmin = K + 1 > cmax = -1), and the first and last chunk of
// each bucket it holds (atomics, one lane a bucket).
__global__ void __launch_bounds__(128)
moments_prep_kernel(const float* __restrict__ xyz, const int* __restrict__ label,
                    const bool* __restrict__ valid, int n, int num_classes,
                    float4* __restrict__ pts4, float4* __restrict__ chunk_box,
                    int* __restrict__ first, int* __restrict__ last) {
  const int u = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (u >= n / kChunk) return;  // uniform across the warp
  const int i = u * kChunk + lane;
  const float x = xyz[i], y = xyz[n + i], z = xyz[2 * n + i];
  const bool v = valid[i];
  const int lab = v ? max(label[i], 0) : -1;
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
// moments over the chunks its culling keeps.
__global__ void __launch_bounds__(kWalkWarps * 32)
moments_walk_kernel(const float4* __restrict__ pts4, const float4* __restrict__ chunk_box,
                    const float4* __restrict__ tile_box, const int2* __restrict__ span,
                    const int* __restrict__ order, const float* __restrict__ radius, int nc,
                    int n, int num_classes, unsigned* __restrict__ counter,
                    float* __restrict__ out) {
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
#pragma unroll
    for (int j = 0; j < 10; ++j) out[static_cast<size_t>(j) * n + qi] = m[j];
  }
}

}  // namespace

// xyz (3,n) f32, label (n,) i32, valid (n,) bool; radius one f32 on the
// device. Out: pts4 (n,4) f32 (x, y, z, the label's int32 bits, -1 where
// invalid), chunk_box (n/32, 8) f32, span (n/32, 2) i32 (first > last when
// a chunk's warp scans nothing), count (n/32,) i32 the chunks each warp
// walks, tile_box (ceil(n/1024), 8) f32 the boxes of 32-chunk tiles.
// Scratch: first_last (2 * (num_classes + 1),) i32. n % 32 == 0.
extern "C" cudaError_t semicp_moments_cost(const float* xyz, const int* label,
                                           const bool* valid, const float* radius, int n,
                                           int num_classes, float* pts4, float* chunk_box,
                                           float* tile_box, int* span, int* first_last,
                                           int* count, cudaStream_t stream) {
  const int nc = n / kChunk;
  const int nb = num_classes + 1;  // buckets: the classes, then every label past them
  int* first = first_last;
  int* last = first_last + nb;
  // 0x7f7f7f7f: after every chunk index; 0xffffffff: -1
  cudaError_t err = cudaMemsetAsync(first, 0x7f, nb * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(last, 0xff, nb * sizeof(int), stream)) != cudaSuccess) return err;
  moments_prep_kernel<<<(nc + 3) / 4, 128, 0, stream>>>(xyz, label, valid, n, num_classes,
                                                        reinterpret_cast<float4*>(pts4),
                                                        reinterpret_cast<float4*>(chunk_box),
                                                        first, last);
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

// pts4, chunk_box, tile_box and span from semicp_moments_cost, order (n/32,) i32 the
// chunks heaviest first, counter one u32 of scratch. out (10,n) f32.
// n % 32 == 0.
extern "C" cudaError_t semicp_moments_sparse(const float* pts4, const float* chunk_box,
                                             const float* tile_box, const int* span,
                                             const int* order, const float* radius, int n,
                                             int num_classes, unsigned* counter, float* out,
                                             cudaStream_t stream) {
  const int nc = n / kChunk;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream)) != cudaSuccess) return err;
  const int blocks = sms * kWarpsPerSm / kWalkWarps;
  moments_walk_kernel<<<blocks, kWalkWarps * 32, 0, stream>>>(
      reinterpret_cast<const float4*>(pts4), reinterpret_cast<const float4*>(chunk_box),
      reinterpret_cast<const float4*>(tile_box), reinterpret_cast<const int2*>(span), order,
      radius, nc, n, num_classes, counter, out);
  return cudaGetLastError();
}
