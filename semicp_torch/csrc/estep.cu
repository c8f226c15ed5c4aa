// Fused E-step weights and class reduction (kernel K3).
//
// Replaces the Pallas kernel `estep_reduce_pallas` of the JAX package
// (semicp/register/pallas_estep.py, `_reduce_kernel`). For each source
// point it runs an online softmax over the K classes of the per-class
// nearest neighbours:
//
//   Sigma_k = C_k + R C_z R^T   (C_k from the winner's attribute row,
//                                R C_z R^T the rotated source covariance)
//   closed-form Cholesky -> Mahalanobis distance and logdet
//   loglik_k = -0.5 (maha + logdet + 3 log 2 pi) + log_sem_k
//   gated by exact |x_k - p|^2 <= gate^2, nn_d2_k < INF and valid
//
// and accumulates A = sum_k w_k Sigma_k^-1 (6 planes), b = sum_k w_k
// Sigma_k^-1 x_k (3), c = sum_k w_k x_k^T Sigma_k^-1 x_k and wsum. The
// arithmetic is the closed form of the Pallas kernel, in f32 with IEEE
// exp/log/sqrt/divide (the package is built without fast math).
//
// Bound on the H100: device memory. Per point it reads up to K x 11
// floats (nn_d2, log_sem and nine attribute rows) and writes 11, about
// 0.9 KB a point at K = 20, for a few flops per byte. Design: one thread
// per point, classes in a register loop, every access coalesced along
// the point axis. A class that fails the gate is skipped before its six
// covariance rows and log-prior are read: its softmax update is the
// identity (weight 0, rescale 1 or 0 on an empty accumulator), so only
// the gated-in classes cost bandwidth beyond the distance test.

#include "common.cuh"

namespace {

using semicp::kInf;
using semicp::kNeg;

constexpr int kBlock = 256;
constexpr int kAttr = 16;
constexpr float kLog2Pi3 = 5.513631199228036f;  // 3 log(2 pi)

__global__ void __launch_bounds__(kBlock)
estep_reduce_kernel(const float* __restrict__ nn_d2, const float* __restrict__ attrs,
                    const float* __restrict__ rc6, const float* __restrict__ moved,
                    const float* __restrict__ log_sem, const bool* __restrict__ valid,
                    const float* __restrict__ gate2_ptr, int num_classes, int n,
                    float* __restrict__ a6, float* __restrict__ b3,
                    float* __restrict__ c_out, float* __restrict__ wsum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float gate2 = *gate2_ptr;
  const float px = moved[i], py = moved[n + i], pz = moved[2 * n + i];
  float r[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[j] = rc6[j * n + i];

  float m = kNeg, s = 0.f;
  float accA[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float accB[3] = {0.f, 0.f, 0.f};
  float accC = 0.f;

  if (valid[i]) {
    for (int k = 0; k < num_classes; ++k) {
      const float* at = attrs + static_cast<size_t>(k) * kAttr * n + i;
      const float x = at[0], y = at[n], z = at[2 * n];
      const float dx = x - px, dy = y - py, dz = z - pz;
      if (!(dx * dx + dy * dy + dz * dz <= gate2 && nn_d2[k * n + i] < kInf)) continue;

      const float s00 = at[3 * n] + r[0], s11 = at[4 * n] + r[1], s22 = at[5 * n] + r[2];
      const float s01 = at[6 * n] + r[3], s02 = at[7 * n] + r[4], s12 = at[8 * n] + r[5];
      // closed-form Cholesky + adjugate inverse (pallas_estep._chol_sinv)
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
      const float loglik = -0.5f * (maha + logdet + kLog2Pi3) + log_sem[k * n + i];

      const float m_new = fmaxf(m, loglik);
      const float mn_safe = fmaxf(m_new, 0.5f * kNeg);
      const float resc = expf(m - mn_safe);
      const float p = expf(loglik - mn_safe);
      s = s * resc + p;

      const float t0 = i0 * x + i3 * y + i4 * z;  // Sigma^-1 x
      const float t1 = i3 * x + i1 * y + i5 * z;
      const float t2 = i4 * x + i5 * y + i2 * z;
      accA[0] = accA[0] * resc + p * i0;
      accA[1] = accA[1] * resc + p * i1;
      accA[2] = accA[2] * resc + p * i2;
      accA[3] = accA[3] * resc + p * i3;
      accA[4] = accA[4] * resc + p * i4;
      accA[5] = accA[5] * resc + p * i5;
      accB[0] = accB[0] * resc + p * t0;
      accB[1] = accB[1] * resc + p * t1;
      accB[2] = accB[2] * resc + p * t2;
      accC = accC * resc + p * (x * t0 + y * t1 + z * t2);
      m = m_new;
    }
  }

  const float inv_s = s > 0.f ? 1.f / fmaxf(s, 1e-30f) : 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) a6[j * n + i] = accA[j] * inv_s;
#pragma unroll
  for (int j = 0; j < 3; ++j) b3[j * n + i] = accB[j] * inv_s;
  c_out[i] = accC * inv_s;
  wsum[i] = s > 0.f ? 1.f : 0.f;
}

}  // namespace

// nn_d2 (K,n), attrs (K,16,n), rc6 (6,n), moved (3,n), log_sem (K,n) f32;
// valid (n,) bool; gate2: one f32 on the device. Outputs a6 (6,n), b3 (3,n),
// c (n,), wsum (n,) f32.
extern "C" cudaError_t semicp_estep_reduce(const float* nn_d2, const float* attrs,
                                           const float* rc6, const float* moved,
                                           const float* log_sem, const bool* valid,
                                           const float* gate2, int num_classes, int n,
                                           float* a6, float* b3, float* c, float* wsum,
                                           cudaStream_t stream) {
  estep_reduce_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      nn_d2, attrs, rc6, moved, log_sem, valid, gate2, num_classes, n, a6, b3, c, wsum);
  return cudaGetLastError();
}
