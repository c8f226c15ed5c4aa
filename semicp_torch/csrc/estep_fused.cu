// One-kernel sparse E-step: per-class nearest neighbour, weights and class
// reduction (kernel K6).
//
// Replaces the Pallas kernel `estep_sparse_fused` of the JAX package
// (semicp/register/pallas_fused.py, `_fused_kernel`). For every moved
// source point it finds, per class, the nearest target over the query
// tile's gate-pruned candidate tiles (K2's walk), then runs K3's online
// softmax over the classes with each winner's row read straight from the
// target slab, and writes only the class-collapsed GN planes A (6), b (3),
// c and wsum. The split path's (K, 16, Q) winner intermediate, 0.67 GB at
// 524288 queries and K = 20, never reaches device memory.
//
// Contract: the port's K2 followed by K3, with exact ties to the lowest
// target index. The TPU kernel averages the rows of exact ties through its
// count row (ROW_CNT); that is an expected difference, not a fault. The
// walk (`nn_sparse_walk`) and the per-class update (`estep_class`) are the
// device functions of common.cuh that K2 and K3 run, so the three kernels
// share their arithmetic. The TPU's candidate cap and grid cap are SMEM
// limits and are not ported: the candidate lists are uncapped.
//
// Bound on the H100: arithmetic on the candidate pairs, as in K2 (the
// reduction adds a few hundred flops a point). Device memory traffic is
// the slab tiles (mostly from L2), one gather of nine floats per found
// class, and 11 floats written a point in place of K x 17. Design: one
// block per 256-query tile, one thread per query. The per-class best
// (d2, index) sits in shared memory (K x 256 x 8 B, 40 KB at K = 20; above
// 48 KB the launch raises the block's dynamic shared memory limit); the
// softmax state in registers.

#include "common.cuh"

namespace {

using semicp::kQB;

__global__ void __launch_bounds__(kQB)
estep_fused_kernel(const float* __restrict__ attrs, const int* __restrict__ cand,
                   const int* __restrict__ count, const float* __restrict__ q_xyz,
                   const bool* __restrict__ q_valid, const float* __restrict__ rc6,
                   const float* __restrict__ log_sem, const float* __restrict__ gate2_ptr,
                   int n, int q, int n_cand, int tb, int num_classes,
                   float* __restrict__ a6, float* __restrict__ b3,
                   float* __restrict__ c_out, float* __restrict__ wsum) {
  extern __shared__ float smem[];
  float* best_d = smem + 5 * kQB;                            // (K, kQB)
  int* best_i = reinterpret_cast<int*>(best_d + num_classes * kQB);

  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQB + t;
  const float px = q_xyz[qi], py = q_xyz[q + qi], pz = q_xyz[2 * q + qi];
  semicp::nn_sparse_walk(attrs, cand + blockIdx.x * n_cand, count[blockIdx.x], n, tb,
                         num_classes, px, py, pz, smem, best_d, best_i);

  const float gate2 = *gate2_ptr;
  float r[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[j] = rc6[j * q + qi];

  semicp::EStepAcc acc = semicp::estep_init();
  if (q_valid[qi]) {
    for (int k = 0; k < num_classes; ++k) {
      const int i = best_i[k * kQB + t];
      if (i < 0) continue;  // no candidate of class k
      semicp::estep_class(acc, attrs + i, n, px, py, pz, r, gate2, log_sem + k * q + qi);
    }
  }
  semicp::estep_store(acc, qi, q, a6, b3, c_out, wsum);
}

}  // namespace

// attrs16 (16,n) f32 from prepare_sparse (x,y,z | cov6 | 1 | |t|^2 | label);
// cand (q/256, n_cand) i32 and count (q/256,) i32 candidate target tiles of
// size tb per 256-query tile; q_xyz (3,q) f32; q_valid (q,) bool; rc6 (6,q)
// and log_sem (K,q) f32; gate2: one f32 on the device. Outputs a6 (6,q),
// b3 (3,q), c (q,), wsum (q,) f32. q % 256 == 0, tb % 256 == 0.
extern "C" cudaError_t semicp_estep_fused(const float* attrs16, const int* cand,
                                          const int* count, const float* q_xyz,
                                          const bool* q_valid, const float* rc6,
                                          const float* log_sem, const float* gate2, int n,
                                          int q, int n_cand, int tb, int num_classes,
                                          float* a6, float* b3, float* c, float* wsum,
                                          cudaStream_t stream) {
  const size_t smem = semicp::nn_sparse_smem_bytes(num_classes);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        estep_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  estep_fused_kernel<<<q / kQB, kQB, smem, stream>>>(attrs16, cand, count, q_xyz, q_valid,
                                                     rc6, log_sem, gate2, n, q, n_cand, tb,
                                                     num_classes, a6, b3, c, wsum);
  return cudaGetLastError();
}
