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
// Bound on the H100: arithmetic on the candidate pairs. A query tile of
// 256 points visits the few same-class target tiles whose boxes lie
// within the radius (the uncapped lists come from corr/layout.py
// tile_candidates), so each query tests a few 512-point tiles; device
// memory traffic is small (each target tile is read once per visiting
// query tile, mostly from L2). Design: one block per
// query tile, one thread per query; each candidate tile is staged through
// shared memory in 256-point chunks (x, y, z, label) and every thread
// reads the same element (a broadcast), so the inner loop is 3 subtracts,
// 3 FMAs, two compares and ten predicated adds, all in registers.

#include "common.cuh"

namespace {

using semicp::kQB;

__global__ void __launch_bounds__(kQB)
moments_sparse_kernel(const float* __restrict__ xyz, const int* __restrict__ tlab,
                      const int* __restrict__ qlab, const int* __restrict__ cand,
                      const int* __restrict__ count, const float* __restrict__ radius,
                      int n, int n_cand, int tb, float* __restrict__ out) {
  __shared__ float sx[kQB], sy[kQB], sz[kQB];
  __shared__ int sl[kQB];

  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQB + t;
  const float qx = xyz[qi], qy = xyz[n + qi], qz = xyz[2 * n + qi];
  const int ql = qlab[qi];
  const float r = *radius;
  const float r2 = r * r;

  float m[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) m[j] = 0.f;

  const int cnt = count[blockIdx.x];
  for (int c = 0; c < cnt; ++c) {
    const int base = cand[blockIdx.x * n_cand + c] * tb;
    for (int s = 0; s < tb; s += kQB) {
      __syncthreads();
      const int g = base + s + t;
      sx[t] = xyz[g];
      sy[t] = xyz[n + g];
      sz[t] = xyz[2 * n + g];
      sl[t] = tlab[g];
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kQB; ++j) {
        const float dx = sx[j] - qx, dy = sy[j] - qy, dz = sz[j] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < r2 && sl[j] == ql) {
          m[0] += 1.f;
          m[1] += dx; m[2] += dy; m[3] += dz;
          m[4] += dx * dx; m[5] += dy * dy; m[6] += dz * dz;
          m[7] += dx * dy; m[8] += dx * dz; m[9] += dy * dz;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 10; ++j) out[j * n + qi] = m[j];
}

}  // namespace

// xyz (3,n) f32; tlab (n,) i32 = label, -1 where invalid; qlab (n,) i32 =
// label, -2 where invalid; cand (n/256, n_cand) i32 and count (n/256,) i32
// candidate target tiles of size tb per 256-point query tile; radius: one
// f32 on the device. out (10,n) f32. n % 256 == 0 and tb % 256 == 0.
extern "C" cudaError_t semicp_moments_sparse(const float* xyz, const int* tlab,
                                             const int* qlab, const int* cand,
                                             const int* count, const float* radius,
                                             int n, int n_cand, int tb, float* out,
                                             cudaStream_t stream) {
  moments_sparse_kernel<<<n / kQB, kQB, 0, stream>>>(xyz, tlab, qlab, cand, count,
                                                     radius, n, n_cand, tb, out);
  return cudaGetLastError();
}
