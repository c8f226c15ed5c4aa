// Per-class nearest neighbour over a class-sorted target, with the
// winner's attributes (kernel K4, the small-cloud engine).
//
// Replaces the Pallas kernel `class_nn_attrs_pallas` of the JAX package
// (semicp/corr/pallas_nn2.py, `_kernel`). Its contract is K2's, over every
// target: for each query and class k, the minimum expanded-form distance
// d2 = |q|^2 + |t|^2 - 2 q.t over the valid class-k targets and the
// winner's attribute row (x, y, z, cov6, then 1.0 in row 9 and zeros in
// rows 10-15). A class absent from the target gets d2 = INF and a zero
// row. Exact ties take the lowest index in class-sorted order (the TPU
// takes the first index within a tile and a strict < across tiles).
//
// Bound on the H100: arithmetic on the Q x N_valid pairs (four FMAs and a
// compare each). The TPU kernel visits every (query tile, target tile)
// pair and gates each class pass by the tile's [cmin, cmax]. Here the
// target is sorted by class, so each class is one contiguous segment
// [start_k, end_k) and only that segment is walked: no pair is tested
// twice and no label is compared. Design: one block per (128-query tile,
// class), one thread per query, so a small cloud still fills the card
// (Q/128 x K blocks). The block finds its segment by a binary search of
// the sorted labels (no host sync, no prepared table), streams it through
// shared memory in 128-point chunks (x, y, z, |t|^2) read as broadcasts,
// keeps the running best (d2, index) in registers and gathers the winner's
// row once at the end. Queries and targets need no padding to a tile.
// Precondition: `label_s` is non-decreasing (invalid = num_classes, last).

#include "common.cuh"

namespace {

using semicp::kAttr;
using semicp::kInf;

constexpr int kDQB = 128;  // queries per block and targets per staged chunk

__global__ void __launch_bounds__(kDQB)
nn_dense_kernel(const float* __restrict__ xyz_s, const int* __restrict__ label_s,
                const float* __restrict__ attrs, const float* __restrict__ q_xyz, int n,
                int q, float* __restrict__ out_d2, float* __restrict__ out_attr) {
  __shared__ float sx[kDQB], sy[kDQB], sz[kDQB], st2[kDQB];
  __shared__ int seg[2];

  const int t = threadIdx.x;
  const int k = blockIdx.y;
  const int qi = blockIdx.x * kDQB + t;
  if (t < 2) {  // first index whose label is >= k (t = 0) or >= k + 1 (t = 1)
    const int key = k + t;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (label_s[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    seg[t] = lo;
  }
  const bool active = qi < q;
  const float qx = active ? q_xyz[qi] : 0.f;
  const float qy = active ? q_xyz[q + qi] : 0.f;
  const float qz = active ? q_xyz[2 * q + qi] : 0.f;
  const float q2 = qx * qx + qy * qy + qz * qz;
  const float m2x = -2.f * qx, m2y = -2.f * qy, m2z = -2.f * qz;
  __syncthreads();
  const int start = seg[0], end = seg[1];

  float best = kInf;
  int best_i = -1;
  for (int s = start; s < end; s += kDQB) {
    __syncthreads();
    const int g = s + t;
    if (g < end) {
      const float x = xyz_s[g], y = xyz_s[n + g], z = xyz_s[2 * n + g];
      sx[t] = x;
      sy[t] = y;
      sz[t] = z;
      st2[t] = x * x + y * y + z * z;
    }
    __syncthreads();
    const int m = min(kDQB, end - s);
    for (int j = 0; j < m; ++j) {
      const float d2 = fmaf(m2z, sz[j], fmaf(m2y, sy[j], fmaf(m2x, sx[j], q2 + st2[j])));
      if (d2 < best) {  // strict: the lowest index wins an exact tie
        best = d2;
        best_i = s + j;
      }
    }
  }
  if (!active) return;

  const bool found = best_i >= 0;
  out_d2[k * q + qi] = found ? best : kInf;
  float* o = out_attr + static_cast<size_t>(k) * kAttr * q + qi;
#pragma unroll
  for (int r = 0; r < 9; ++r) o[r * q] = found ? attrs[r * n + best_i] : 0.f;
  o[9 * q] = found ? 1.f : 0.f;
#pragma unroll
  for (int r = 10; r < kAttr; ++r) o[r * q] = 0.f;
}

}  // namespace

// xyz_s (3,n) f32 and label_s (n,) i32 sorted by class (invalid =
// num_classes, last); attrs16 (16,n) f32 aligned to them (x,y,z | cov6 |
// ...); q_xyz (3,q) f32. out_d2 (K,q), out_attr (K,16,q) f32.
extern "C" cudaError_t semicp_nn_dense(const float* xyz_s, const int* label_s,
                                       const float* attrs16, const float* q_xyz, int n,
                                       int q, int num_classes, float* out_d2,
                                       float* out_attr, cudaStream_t stream) {
  const dim3 grid((q + kDQB - 1) / kDQB, num_classes);
  nn_dense_kernel<<<grid, kDQB, 0, stream>>>(xyz_s, label_s, attrs16, q_xyz, n, q, out_d2,
                                             out_attr);
  return cudaGetLastError();
}
