// Neighbourhood moments over a cloud in any layout (kernel K5).
//
// Replaces the Pallas kernel `neighborhood_moments_pallas` of the JAX
// package (semicp/cloud/pallas_cov.py, `_kernel`), which tests every pair
// of points. It serves the raw layout: a bare CovConfig, or class_aware =
// False, where every label is 0. Contract as K1's (moments.cu): per point,
// the ten moments of its same-label valid neighbours within `radius`
// (self-inclusive, the exact difference form), centred on the query; the
// covariance after the epilogue is the contract, not raw moments. The
// labels are any int32s, the radius a device scalar, and nothing syncs.
//
// Bound on the H100: the pairs within the radius (about 24 flops each) or
// the bytes of one read of the cloud and one write of the moments,
// whichever is larger; the first port tested all N^2 pairs (1.07e9 at
// n_pad 32768) for a few million neighbours. Design: walk only what the
// function needs, with K1's walk (moments_walk.cuh) on an internal order.
//
// 1. The cloud is ordered for this call only, on the device, with no host
//    sync: `moments_raw_key_kernel` keys each point by label bucket
//    (labels past cloud/moments.py RAW_BUCKETS share one), then by a
//    Morton code at a cell as large as the radius from the valid points'
//    least corner (`moments_raw_lo_kernel`), invalid last
//    (corr/layout.py `radius_cell_key`, its plain version); the wrapper
//    sorts the keys (stable). A 32-point chunk then spans about one
//    radius, where K1's layout, fixed by the JAX package at a 2 m cell,
//    spans several. The walk pads the order to whole chunks itself.
// 2. The prep kernel reads each point through that order from the raw
//    planes (no gathered copy of the cloud); K1's chunk culling, cost pass
//    and heaviest-first persistent walk run on it.
// 3. The walk stores each query's moments straight to its raw column, so
//    no pass restores the caller's order.

#include "moments_walk.cuh"

namespace {

// A float's bits as an int whose order is the float's (negatives flipped),
// for atomicMin; kNoLo (the bytes 0x7f of the memset) is "no valid point".
constexpr int kNoLo = 0x7f7f7f7f;

__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return i == kNoLo ? 0.f : __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// lo[a]: the least coordinate of the valid points on axis a (as ordered
// ints; exact in any order), one atomicMin a warp and axis.
__global__ void __launch_bounds__(256)
moments_raw_lo_kernel(const float* __restrict__ xyz, const bool* __restrict__ valid, int n,
                      int* __restrict__ lo) {
  const float inf = semicp::pos_inf();
  float m[3] = {inf, inf, inf};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (valid[i]) {
#pragma unroll
      for (int a = 0; a < 3; ++a) m[a] = fminf(m[a], xyz[a * n + i]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[a] = fminf(m[a], __shfl_xor_sync(semicp::kFull, m[a], off));
    if ((threadIdx.x & 31) == 0 && m[a] < inf) atomicMin(lo + a, ordered(m[a]));
  }
}

// Spread 10 bits of v so there are two zero bits between each
// (corr/morton.py `_spread3`).
__device__ __forceinline__ long long spread3(long long v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x30000FF;
  v = (v | (v << 8)) & 0x300F00F;
  v = (v | (v << 4)) & 0x30C30C3;
  v = (v | (v << 2)) & 0x9249249;
  return v;
}

// corr/morton.py `morton_codes`' cell index: (x - lo) / cell truncated,
// clipped to 10 bits (clipped before the conversion, which is the same).
__device__ __forceinline__ long long cell_of(float x, float lo, float cell) {
  return static_cast<long long>(fminf(fmaxf((x - lo) / cell, 0.f), 1023.f));
}

__global__ void __launch_bounds__(256)
moments_raw_key_kernel(const float* __restrict__ xyz, const int* __restrict__ label,
                       const bool* __restrict__ valid, const float* __restrict__ cell_ptr,
                       const int* __restrict__ lo, int n, int num_buckets,
                       long long* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cell = *cell_ptr;
  const bool v = valid[i];
  // corr/morton.py INVALID_CODE where invalid
  const long long code =
      v ? spread3(cell_of(xyz[i], unordered(lo[0]), cell)) |
              (spread3(cell_of(xyz[n + i], unordered(lo[1]), cell)) << 1) |
              (spread3(cell_of(xyz[2 * n + i], unordered(lo[2]), cell)) << 2)
        : 1ll << 30;
  const long long b = v ? min(max(label[i], 0), num_buckets) : num_buckets + 1;
  key[i] = (b << 31) | code;
}

}  // namespace

// xyz (3,n) f32, label (n,) i32, valid (n,) bool; cell one f32 on the
// device (the radius, at least 1e-6). key (n,) i64: the internal order's
// key of each point, to be sorted stably. Scratch: lo (3,) i32.
extern "C" cudaError_t semicp_moments_raw_key(const float* xyz, const int* label,
                                              const bool* valid, const float* cell, int n,
                                              int num_buckets, int* lo, long long* key,
                                              cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(lo, 0x7f, 3 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  moments_raw_lo_kernel<<<min((n + 255) / 256, 264), 256, 0, stream>>>(xyz, valid, n, lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  moments_raw_key_kernel<<<(n + 255) / 256, 256, 0, stream>>>(xyz, label, valid, cell, lo, n,
                                                               num_buckets, key);
  return cudaGetLastError();
}

// xyz (3,n_raw) f32, label (n_raw,) i32, valid (n_raw,) bool in the raw
// layout; perm (n_raw,) i64 the internal order (the sorted keys' indices);
// n the order padded to whole chunks (n % 32 == 0); radius one f32 on the
// device. Outputs and scratch as semicp_moments_cost, over the n ordered
// points.
extern "C" cudaError_t semicp_moments_raw_cost(const float* xyz, const int* label,
                                               const bool* valid, const long long* perm,
                                               const float* radius, int n, int n_raw,
                                               int num_buckets, float* pts4, float* chunk_box,
                                               float* tile_box, int* span, int* first_last,
                                               int* count, cudaStream_t stream) {
  return launch_moments_cost(xyz, label, valid, perm, radius, n, n_raw, num_buckets, pts4,
                             chunk_box, tile_box, span, first_last, count, stream);
}

// The walk of semicp_moments_raw_cost's outputs, heaviest chunk first
// (order); out (10,n_raw) f32 in the raw layout, every column written.
extern "C" cudaError_t semicp_moments_raw(const float* pts4, const float* chunk_box,
                                          const float* tile_box, const int* span,
                                          const int* order, const long long* perm,
                                          const float* radius, int n, int n_raw,
                                          int num_buckets, unsigned* counter, float* out,
                                          cudaStream_t stream) {
  return launch_moments_walk(pts4, chunk_box, tile_box, span, order, perm, radius, n, n_raw,
                             num_buckets, counter, out, stream);
}
