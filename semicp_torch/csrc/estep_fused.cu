// The sparse E-step without the winner slab: per-class nearest neighbour,
// weights and class reduction (kernel K6).
//
// Replaces the Pallas kernel `estep_sparse_fused` of the JAX package
// (semicp/register/pallas_fused.py, `_fused_kernel`). For every moved
// source point it finds, per class, the nearest target within the gate,
// then runs K3's online softmax over the classes with each winner's row
// read straight from the target slab, and writes only the class-collapsed
// GN planes A (6), b (3), c and wsum. The split path's (K, 16, Q) winner
// slab, 64 K Q bytes, is never written nor read.
//
// Contract: the port's K2 followed by K3, with exact ties to the lowest
// target index. The TPU kernel averages the rows of exact ties through its
// count row (ROW_CNT); that is an expected difference, not a fault. The
// TPU's candidate cap and grid cap are SMEM limits and are not ported.
//
// Bound on the H100: arithmetic on the walked pairs, as in K2 (the
// reduction adds about 120 flops a gated class). Device memory traffic is
// the (K, Q) keys written and read once (8 B a class and query), one
// gather of nine floats per gated class, and 11 floats written a point.
//
// Design: two stages in one C entry, each sized to its own work.
// 1. K2's item list and walk (nn_walk.cuh, the same source as
//    nn_sparse.cu): (query warp, 1024-point target tile) items taken off
//    an atomic counter by persistent warps, chunks culled per warp, and
//    per-class minima merged into keys (K, Q) u64 with a 64-bit atomicMin
//    on (ordered d2 bits, index). The walk is balanced and exact whatever
//    the order of the items; a per-warp unit that kept the minima in
//    registers would be bound by its heaviest query warp (several times
//    the mean on the bench scene).
// 2. `estep_keys_kernel`, one thread per query: for each class whose key
//    was set, the winner's index is the key's low word, and
//    `semicp::estep_class` (common.cuh, K3's per-class update) reads its
//    x, y, z and, within the gate, its covariance rows from the slab. The
//    keys are read coalesced along the query axis.

#include "nn_walk.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
estep_keys_kernel(const unsigned long long* __restrict__ keys, const float* __restrict__ attrs,
                  const float* __restrict__ q_xyz, const bool* __restrict__ q_valid,
                  const float* __restrict__ rc6, const float* __restrict__ log_sem,
                  const float* __restrict__ gate, int n, int q, int num_classes,
                  float* __restrict__ a6, float* __restrict__ b3, float* __restrict__ c_out,
                  float* __restrict__ wsum) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const float g = *gate;
  const float gate2 = __fmul_rn(g, g);
  const float px = q_xyz[qi], py = q_xyz[q + qi], pz = q_xyz[2 * q + qi];
  float r[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[j] = rc6[j * q + qi];

  semicp::EStepAcc acc = semicp::estep_init();
  if (q_valid[qi]) {
    for (int k = 0; k < num_classes; ++k) {
      const size_t kq = static_cast<size_t>(k) * q + qi;
      const unsigned long long key = keys[kq];
      if (key == kNone) continue;  // no neighbour of class k
      const int i = static_cast<int>(key & 0xffffffffu);
      semicp::estep_class(acc, attrs + i, n, px, py, pz, r, gate2, log_sem + kq);
    }
  }
  semicp::estep_store(acc, qi, q, a6, b3, c_out, wsum);
}

}  // namespace

// The arguments of semicp_nn_sparse (nn_sparse.cu) up to the scratch,
// with rc6 (6,q) and log_sem (K,q) f32 after q_valid; gate is one f32 on
// the device (the walk's limit and, squared, the E-step's gate). Scratch:
// keys (K,q) u64, items (q/32 * n/tb) i32, wbox (q/32, 8) f32, counters
// (3,) u64, all cleared here. Outputs a6 (6,q), b3 (3,q), c (q,), wsum (q,)
// f32. q % 32 == 0, tb % 32 == 0, tb <= 1024.
extern "C" cudaError_t semicp_estep_fused(const float* pts4, const int* label_s,
                                          const float* attrs16, const float* tile_box,
                                          const float* chunk_box, const float* q_xyz,
                                          const bool* q_valid, const float* rc6,
                                          const float* log_sem, const float* gate, int n, int q,
                                          int tb, int num_classes, unsigned long long* keys,
                                          int* items, float* wbox, unsigned long long* counters,
                                          float* a6, float* b3, float* c, float* wsum,
                                          cudaStream_t stream) {
  cudaError_t err = launch_nn_walk(pts4, label_s, tile_box, chunk_box, q_xyz, q_valid, gate,
                                   n, q, tb, num_classes, keys, items, wbox, counters, stream);
  if (err != cudaSuccess) return err;
  estep_keys_kernel<<<(q + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      keys, attrs16, q_xyz, q_valid, rc6, log_sem, gate, n, q, num_classes, a6, b3, c, wsum);
  return cudaGetLastError();
}
