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
// the point axis. A class with no neighbour is skipped after one read of
// its distance, and one beyond the gate before its six covariance rows and
// log-prior are read: its softmax update is the identity (weight 0,
// rescale 1 or 0 on an empty accumulator), so only the gated-in classes
// cost bandwidth beyond the distance test. The per-class update is
// `estep_class` in common.cuh, shared with the fused E-step (K6).

#include "common.cuh"

namespace {

using semicp::kAttr;
using semicp::kInf;

constexpr int kBlock = 256;

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

  semicp::EStepAcc acc = semicp::estep_init();
  if (valid[i]) {
    for (int k = 0; k < num_classes; ++k) {
      if (!(nn_d2[k * n + i] < kInf)) continue;  // no neighbour of class k
      semicp::estep_class(acc, attrs + static_cast<size_t>(k) * kAttr * n + i, n, px, py,
                          pz, r, gate2, log_sem + k * n + i);
    }
  }
  semicp::estep_store(acc, i, n, a6, b3, c_out, wsum);
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
