// Block-sparse per-class nearest neighbour with the winner's attributes
// (kernel K2).
//
// Replaces the Pallas kernel `class_nn_attrs_sparse` of the JAX package
// (semicp/corr/pallas_nn2.py, `_sparse_kernel`, merge="twophase"). For
// every query and every class k it finds the minimum expanded-form
// distance d2 = |q|^2 + |t|^2 - 2 q.t over the class-k targets that lie
// within the correspondence gate of the query (and possibly some beyond),
// and writes the winner's attribute row: x, y, z, cov6, then 1.0 in row 9
// (found) and zeros in rows 10-15. A class with no candidate gets d2 = INF
// and a zero row. Exact ties take the lowest target index (the argmin
// semantics of the plain `class_nn`). The TPU kernel's one-hot MXU select,
// two-phase walk and candidate caps are TPU workarounds and are not
// ported.
//
// Bound on the H100: the f32 arithmetic on the walked pairs (a fmaf chain
// of 7 flops and a compare each); the (K, 16, Q) output, written once, is
// the only large memory traffic. The design answers four limits of the
// first port, which walked 256-query tiles against whole 1024-point
// target tiles from one block per query tile:
//
// 1. The pruning unit is the warp, not the TPU's tile. A query warp (32
//    queries) reduces its box with shuffles; a target tile is cut into
//    32-point chunks with their own boxes and class ranges (prepared once
//    an align in corr/nn_sparse.py `prepare_sparse`). A warp walks a chunk
//    only if it lies within the gate of the warp's box and of one of its
//    own valid queries (common.cuh `cull_window`, the slack of
//    `tile_candidates`). That walks about a fifth of the pairs.
// 2. Balance. The work is cut into items, one per (query warp, target
//    tile) pair whose boxes lie within the gate: `nn_items_kernel` lists
//    them (a warp-aggregated atomic append; the warp's box is kept for the
//    walk), and persistent warps of `nn_walk_kernel` take items off an
//    atomic counter, so no SM waits on one dense query tile. An item holds
//    at most 32 chunks. Items of one query warp run on different warps, so
//    each merges its per-class minima with a 64-bit atomicMin on the key
//    (order-preserving d2 bits << 32 | target index): exact, independent
//    of the order of the run, lowest index on ties, and right for the
//    slightly negative d2 that expanded-form cancellation can give.
//    `nn_gather_kernel` then writes d2 and gathers the winners' rows.
// 3. The inner loop is one LDS.128 broadcast per pair: a chunk is staged
//    as packed (x, y, z, |t|^2) float4s, |t|^2 = +inf marking an invalid
//    point, into a warp-private ring of two slots; the next chunk's loads
//    are issued before the current chunk is walked, and only __syncwarp
//    orders the ring (no block barrier). A chunk of one class runs its 32
//    pairs without a branch against the class's best in registers; mixed
//    chunks take the per-pair path with the label (common.cuh
//    `nn_chunk_walk`). The d2 is the fmaf chain of the first port, so the
//    winners and d2 bits within the gate are those of the first port.
// 4. No candidate lists are built in torch: the item list, the query warp
//    boxes and the culling are made on the device inside this call
//    (two memsets, three launches, no host sync).
//
// The item list and the walk are in nn_walk.cuh, one source with the fused
// E-step (K6, estep_fused.cu), which runs them too; this file adds the
// gather.

#include "nn_walk.cuh"

namespace {

using semicp::kAttr;

// One thread per (class, query): d2 and the winner's row from its key.
__global__ void __launch_bounds__(256)
nn_gather_kernel(const unsigned long long* __restrict__ keys, const float* __restrict__ attrs,
                 int n, int q, int num_classes, float* __restrict__ out_d2,
                 float* __restrict__ out_attr) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(num_classes) * q) return;
  const int k = static_cast<int>(idx / q);
  const int qi = static_cast<int>(idx - static_cast<size_t>(k) * q);
  const unsigned long long key = keys[idx];
  const bool found = key != kNone;
  const int i = found ? static_cast<int>(key & 0xffffffffu) : 0;
  out_d2[idx] = found ? semicp::key_d2(key) : kInf;
  float* o = out_attr + static_cast<size_t>(k) * kAttr * q + qi;
#pragma unroll
  for (int r = 0; r < 9; ++r)
    o[static_cast<size_t>(r) * q] = found ? __ldg(attrs + static_cast<size_t>(r) * n + i) : 0.f;
  o[static_cast<size_t>(9) * q] = found ? 1.f : 0.f;
#pragma unroll
  for (int r = 10; r < kAttr; ++r) o[static_cast<size_t>(r) * q] = 0.f;
}

}  // namespace

// pts4 (n,4) f32 (x, y, z, |t|^2 or +inf where invalid), label_s (n,) i32
// (num_classes where invalid or past the classes), attrs16 (16,n) f32,
// tile_box (n/tb, 8) and chunk_box (n/32, 8) f32 from prepare_sparse, their
// class ranges inside [0, num_classes); q_xyz (3,q) f32, q_valid
// (q,) bool, gate one f32 on the device. Scratch: keys (K,q) u64, items
// (q/32 * n/tb) i32, wbox (q/32, 8) f32, counters (3,) u64. out_d2 (K,q),
// out_attr (K,16,q) f32. q % 32 == 0, tb % 32 == 0, tb <= 1024.
extern "C" cudaError_t semicp_nn_sparse(const float* pts4, const int* label_s,
                                        const float* attrs16, const float* tile_box,
                                        const float* chunk_box, const float* q_xyz,
                                        const bool* q_valid, const float* gate, int n, int q,
                                        int tb, int num_classes, unsigned long long* keys,
                                        int* items, float* wbox, unsigned long long* counters,
                                        float* out_d2, float* out_attr, cudaStream_t stream) {
  cudaError_t err = launch_nn_walk(pts4, label_s, tile_box, chunk_box, q_xyz, q_valid, gate,
                                   n, q, tb, num_classes, keys, items, wbox, counters, stream);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(num_classes) * q;
  nn_gather_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      keys, attrs16, n, q, num_classes, out_d2, out_attr);
  return cudaGetLastError();
}
