// Dense neighbourhood moments over a cloud in any layout (kernel K5).
//
// Replaces the Pallas kernel `neighborhood_moments_pallas` of the JAX
// package (semicp/cloud/pallas_cov.py, `_kernel`). For every point it sums,
// over all same-class valid points within `radius` (self-inclusive), the
// ten moments n, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz. It serves the
// raw layout (a bare CovConfig, or class_aware=False), where no tile
// pruning applies, so every point tests all N points.
//
// Contract: the covariance after the epilogue (S2/n - mean mean^T,
// cloud/covariance.py), which is translation invariant. As in K1 the
// moments are centred on the query point itself, so the sums stay O(r^2)
// and the f32 epilogue loses no digits to cancellation at tens of metres
// (the uncentred f32 moments of the TPU kernel and of the plain version
// do). Raw moments are not the contract. The distance is the exact
// difference form; counts can differ from the expanded form's only for a
// neighbour within rounding of the radius.
//
// Bound on the H100: arithmetic on the N x N pairs (3 subtracts, 3 FMAs,
// two compares and ten predicated adds each; 1.1e9 pairs at N = 32768).
// Device memory traffic is small: each block reads the N points once,
// mostly from L2. Design: one block of 256 threads per 64 queries; the
// block's four warp pairs each take every fourth point of a staged chunk,
// so a 2048-point cloud still runs 32 blocks. Each chunk of 256 points
// (x, y, z, label) is staged through shared memory and read as broadcasts;
// each thread keeps its ten sums in registers, and the four partial sums
// of a query are added in a fixed order at the end (deterministic).

#include "common.cuh"

namespace {

constexpr int kMQ = 64;              // queries per block
constexpr int kSplit = 4;            // partitions of each chunk per query
constexpr int kBlock = kMQ * kSplit;  // threads per block
constexpr int kChunk = kBlock;       // points staged per round
constexpr int kMom = 10;

__global__ void __launch_bounds__(kBlock)
moments_dense_kernel(const float* __restrict__ xyz, const int* __restrict__ tlab,
                     const int* __restrict__ qlab, const float* __restrict__ radius, int n,
                     float* __restrict__ out) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ int sl[kChunk];
  __shared__ float part[kSplit - 1][kMom][kMQ];

  const int t = threadIdx.x;
  const int lane = t % kMQ;  // the block's query
  const int p = t / kMQ;     // its partition (uniform within a warp)
  const int qi = blockIdx.x * kMQ + lane;
  const bool active = qi < n;
  const float qx = active ? xyz[qi] : 0.f;
  const float qy = active ? xyz[n + qi] : 0.f;
  const float qz = active ? xyz[2 * n + qi] : 0.f;
  const int ql = active ? qlab[qi] : -2;  // -2 matches no target
  const float r = *radius;
  const float r2 = r * r;

  float m[kMom];
#pragma unroll
  for (int j = 0; j < kMom; ++j) m[j] = 0.f;

  for (int s = 0; s < n; s += kChunk) {
    __syncthreads();
    const int g = s + t;
    const bool in = g < n;
    sx[t] = in ? xyz[g] : 0.f;
    sy[t] = in ? xyz[n + g] : 0.f;
    sz[t] = in ? xyz[2 * n + g] : 0.f;
    sl[t] = in ? tlab[g] : -1;
    __syncthreads();
#pragma unroll 4
    for (int j = p; j < kChunk; j += kSplit) {
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

  if (p > 0) {
#pragma unroll
    for (int j = 0; j < kMom; ++j) part[p - 1][j][lane] = m[j];
  }
  __syncthreads();
  if (p == 0 && active) {
#pragma unroll
    for (int j = 0; j < kMom; ++j) {
      float v = m[j];
#pragma unroll
      for (int pp = 0; pp < kSplit - 1; ++pp) v += part[pp][j][lane];
      out[j * n + qi] = v;
    }
  }
}

}  // namespace

// xyz (3,n) f32; tlab (n,) i32 = label, -1 where invalid; qlab (n,) i32 =
// label, -2 where invalid; radius: one f32 on the device. out (10,n) f32.
extern "C" cudaError_t semicp_moments_dense(const float* xyz, const int* tlab,
                                            const int* qlab, const float* radius, int n,
                                            float* out, cudaStream_t stream) {
  moments_dense_kernel<<<(n + kMQ - 1) / kMQ, kBlock, 0, stream>>>(xyz, tlab, qlab, radius,
                                                                   n, out);
  return cudaGetLastError();
}
