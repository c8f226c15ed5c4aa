// Shared constants and device functions of the semicp_torch CUDA kernels.
//
// The candidate walk of the sparse nearest neighbour (K2, K6) and the
// per-class Gaussian/softmax update of the E-step (K3, K6) live here, so
// that the split path and the fused kernel run the same arithmetic.
#pragma once

#include <cuda_runtime.h>

namespace semicp {

// "no neighbour" distance and the masked log-likelihood, as in the JAX
// package (corr/pallas_nn2.py INF, register/pallas_estep.py NEG/INF)
constexpr float kInf = 3.0e37f;
constexpr float kNeg = -3.0e37f;

// query tile: one block of kQB threads, one thread per query point
constexpr int kQB = 256;

// attribute rows of the NN outputs and of the prepared target slab
// (x, y, z | cov6 | 1 | |t|^2 | label | 4 spare; corr/nn_sparse.py)
constexpr int kAttr = 16;
constexpr int kRowT2 = 10;   // |t|^2 row of the prepared slab
constexpr int kRowLab = 11;  // label row (float class id; num_classes = invalid)

constexpr float kLog2Pi3 = 5.513631199228036f;  // 3 log(2 pi)

// Shared memory of nn_sparse_walk: the staging chunk (x, y, z, |t|^2,
// label) and the per-class running best (d2, index), one column per thread.
inline size_t nn_sparse_smem_bytes(int num_classes) {
  return 5 * kQB * sizeof(float) + static_cast<size_t>(num_classes) * kQB * 8;
}

// Per-class exact nearest neighbour of the query (qx, qy, qz) over the
// block's `cnt` candidate target tiles `cand` (tile ids, size tb) of the
// prepared slab `attrs` (16, n). Every thread of the block must call it
// (it stages each chunk of a tile with __syncthreads). On return
// best_d[k * kQB + t] / best_i[k * kQB + t] hold the minimum expanded-form
// d2 = |q|^2 + |t|^2 - 2 q.t of class k and its target index (-1 and INF
// where the class has no candidate). Exact ties take the lowest index.
//
// The current class's best is cached in registers and written back where
// the class changes: in the class-major layout a tile's labels are
// non-decreasing, so that is rare. Correctness does not depend on it.
__device__ __forceinline__ void nn_sparse_walk(const float* __restrict__ attrs,
                                               const int* __restrict__ cand, int cnt, int n,
                                               int tb, int num_classes, float qx, float qy,
                                               float qz, float* __restrict__ stage,
                                               float* __restrict__ best_d,
                                               int* __restrict__ best_i) {
  float* sx = stage;
  float* sy = sx + kQB;
  float* sz = sy + kQB;
  float* st2 = sz + kQB;
  int* sl = reinterpret_cast<int*>(st2 + kQB);

  const int t = threadIdx.x;
  const float q2 = qx * qx + qy * qy + qz * qz;
  const float m2x = -2.f * qx, m2y = -2.f * qy, m2z = -2.f * qz;

  for (int k = 0; k < num_classes; ++k) {
    best_d[k * kQB + t] = kInf;
    best_i[k * kQB + t] = -1;
  }

  int cur_k = -1;  // class whose best sits in (cur_d, cur_i)
  float cur_d = kInf;
  int cur_i = -1;

  for (int c = 0; c < cnt; ++c) {
    const int base = cand[c] * tb;
    for (int s = 0; s < tb; s += kQB) {
      __syncthreads();
      const int g = base + s + t;
      sx[t] = attrs[g];
      sy[t] = attrs[n + g];
      sz[t] = attrs[2 * n + g];
      st2[t] = attrs[kRowT2 * n + g];
      sl[t] = static_cast<int>(attrs[kRowLab * n + g]);
      __syncthreads();
      for (int j = 0; j < kQB; ++j) {
        const int lab = sl[j];
        if (lab < 0 || lab >= num_classes) continue;  // padding / invalid
        const float d2 = fmaf(m2z, sz[j], fmaf(m2y, sy[j], fmaf(m2x, sx[j], q2 + st2[j])));
        if (lab != cur_k) {
          if (cur_k >= 0) {
            best_d[cur_k * kQB + t] = cur_d;
            best_i[cur_k * kQB + t] = cur_i;
          }
          cur_k = lab;
          cur_d = best_d[lab * kQB + t];
          cur_i = best_i[lab * kQB + t];
        }
        const int gi = base + s + j;
        if (d2 < cur_d || (d2 == cur_d && gi < cur_i)) {
          cur_d = d2;
          cur_i = gi;
        }
      }
    }
  }
  if (cur_k >= 0) {
    best_d[cur_k * kQB + t] = cur_d;
    best_i[cur_k * kQB + t] = cur_i;
  }
}

// Running state of the E-step's online softmax over the classes of one
// point: max log-likelihood m, sum s, and the weighted planes A (6), b (3)
// and c, all rescaled to the running max.
struct EStepAcc {
  float m, s;
  float a[6];
  float b[3];
  float c;
};

__device__ __forceinline__ EStepAcc estep_init() {
  EStepAcc acc;
  acc.m = kNeg;
  acc.s = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) acc.a[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) acc.b[j] = 0.f;
  acc.c = 0.f;
  return acc;
}

// One class of the E-step for the moved source point (px, py, pz) with
// rotated covariance r (6): the class's nearest neighbour is the attribute
// row at `row` (x, y, z, cov6 in rows 0-8, `stride` floats apart). The
// class counts only within the gate, |x - p|^2 <= gate2; the caller checks
// that the neighbour exists and the point is valid. Then
//
//   Sigma = C + R C_z R^T, closed-form Cholesky -> Mahalanobis and logdet
//   loglik = -0.5 (maha + logdet + 3 log 2 pi) + log_sem
//
// enters the online softmax. The arithmetic is the closed form of the
// Pallas kernel (register/pallas_estep.py `_chol_sinv`) in f32 with IEEE
// exp/log/sqrt/divide. The six covariance rows and the log-prior are read
// only for a class within the gate: outside it the update is the identity.
__device__ __forceinline__ void estep_class(EStepAcc& acc, const float* __restrict__ row,
                                            size_t stride, float px, float py, float pz,
                                            const float (&r)[6], float gate2,
                                            const float* __restrict__ log_sem) {
  const float x = row[0], y = row[stride], z = row[2 * stride];
  const float dx = x - px, dy = y - py, dz = z - pz;
  if (!(dx * dx + dy * dy + dz * dz <= gate2)) return;

  const float s00 = row[3 * stride] + r[0], s11 = row[4 * stride] + r[1];
  const float s22 = row[5 * stride] + r[2], s01 = row[6 * stride] + r[3];
  const float s02 = row[7 * stride] + r[4], s12 = row[8 * stride] + r[5];
  const float l00 = sqrtf(fmaxf(s00, 1e-30f));
  const float l10 = s01 / l00;
  const float l20 = s02 / l00;
  const float l11 = sqrtf(fmaxf(s11 - l10 * l10, 1e-30f));
  const float l21 = (s12 - l20 * l10) / l11;
  const float l22 = sqrtf(fmaxf(s22 - l20 * l20 - l21 * l21, 1e-30f));
  const float logdet = 2.f * (logf(l00) + logf(l11) + logf(l22));
  const float dl = l00 * l11 * l22;
  const float rd = 1.f / (dl * dl);
  const float i0 = (s11 * s22 - s12 * s12) * rd;
  const float i1 = (s00 * s22 - s02 * s02) * rd;
  const float i2 = (s00 * s11 - s01 * s01) * rd;
  const float i3 = (s02 * s12 - s01 * s22) * rd;
  const float i4 = (s01 * s12 - s02 * s11) * rd;
  const float i5 = (s01 * s02 - s00 * s12) * rd;

  const float e0 = dx / l00;
  const float e1 = (dy - l10 * e0) / l11;
  const float e2 = (dz - l20 * e0 - l21 * e1) / l22;
  const float maha = e0 * e0 + e1 * e1 + e2 * e2;
  const float loglik = -0.5f * (maha + logdet + kLog2Pi3) + *log_sem;

  const float m_new = fmaxf(acc.m, loglik);
  const float mn_safe = fmaxf(m_new, 0.5f * kNeg);
  const float resc = expf(acc.m - mn_safe);
  const float p = expf(loglik - mn_safe);
  acc.s = acc.s * resc + p;

  const float t0 = i0 * x + i3 * y + i4 * z;  // Sigma^-1 x
  const float t1 = i3 * x + i1 * y + i5 * z;
  const float t2 = i4 * x + i5 * y + i2 * z;
  acc.a[0] = acc.a[0] * resc + p * i0;
  acc.a[1] = acc.a[1] * resc + p * i1;
  acc.a[2] = acc.a[2] * resc + p * i2;
  acc.a[3] = acc.a[3] * resc + p * i3;
  acc.a[4] = acc.a[4] * resc + p * i4;
  acc.a[5] = acc.a[5] * resc + p * i5;
  acc.b[0] = acc.b[0] * resc + p * t0;
  acc.b[1] = acc.b[1] * resc + p * t1;
  acc.b[2] = acc.b[2] * resc + p * t2;
  acc.c = acc.c * resc + p * (x * t0 + y * t1 + z * t2);
  acc.m = m_new;
}

// Normalise the softmax and write point i's planes: a6 (6, n), b3 (3, n),
// c (n,) and wsum (n,) (1 where any class counted, else 0).
__device__ __forceinline__ void estep_store(const EStepAcc& acc, int i, int n,
                                            float* __restrict__ a6, float* __restrict__ b3,
                                            float* __restrict__ c, float* __restrict__ wsum) {
  const float inv_s = acc.s > 0.f ? 1.f / fmaxf(acc.s, 1e-30f) : 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) a6[j * n + i] = acc.a[j] * inv_s;
#pragma unroll
  for (int j = 0; j < 3; ++j) b3[j * n + i] = acc.b[j] * inv_s;
  c[i] = acc.c * inv_s;
  wsum[i] = acc.s > 0.f ? 1.f : 0.f;
}

}  // namespace semicp
