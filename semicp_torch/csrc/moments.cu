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
// Bound on the H100: the f32 arithmetic on the walked pairs (about 10
// flops each: three differences, the squared distance, the compares;
// the ten sums are predicated). Device memory traffic is a few MB. The
// design (moments_walk.cuh, shared with K5) answers the limits of the
// first port, which walked 256-query tiles against whole 512-point
// same-class target tiles, one block each:
//
// 1. The pruning unit is the warp. The query set is the target set, so a
//    query warp is a 32-point chunk of the cloud, and one set of chunk
//    boxes and class ranges (built once a call) serves both sides. A warp
//    scans only the chunks of its classes' span of the class-major order,
//    and walks a chunk only if its box lies within the radius of the
//    warp's box and of one of its own points, with a class range that
//    holds that point's label (common.cuh `cull_window`).
// 2. Balance without splitting a sum. The cost pass counts the chunks
//    each warp will walk; the wrapper orders the warps heaviest first (one
//    argsort on the device), and persistent warps take them in that order
//    off an atomic counter.
// 3. The inner loop is one LDS.128 broadcast per pair from a warp-private
//    ring of two slots; only __syncwarp orders the ring.
// 4. No candidate lists and no torch metadata: the prep kernel builds the
//    chunk boxes and each class's first and last chunk in one pass, and
//    the culling runs on the device in both walks.

#include "moments_walk.cuh"

// xyz (3,n) f32, label (n,) i32, valid (n,) bool; radius one f32 on the
// device. Out: pts4 (n,4) f32 (x, y, z, the label's int32 bits, -1 where
// invalid), chunk_box (n/32, 8) f32, span (n/32, 2) i32 (first > last when
// a chunk's warp scans nothing), count (n/32,) i32 the chunks each warp
// walks, tile_box (ceil(n/1024), 8) f32 the boxes of 32-chunk tiles.
// Scratch: first_last (2 * (num_classes + 1),) i32. n % 32 == 0.
extern "C" cudaError_t semicp_moments_cost(const float* xyz, const int* label,
                                           const bool* valid, const float* radius, int n,
                                           int num_classes, float* pts4, float* chunk_box,
                                           float* tile_box, int* span, int* first_last,
                                           int* count, cudaStream_t stream) {
  return launch_moments_cost(xyz, label, valid, nullptr, radius, n, n, num_classes, pts4,
                             chunk_box, tile_box, span, first_last, count, stream);
}

// pts4, chunk_box, tile_box and span from semicp_moments_cost, order (n/32,) i32 the
// chunks heaviest first, counter one u32 of scratch. out (10,n) f32.
// n % 32 == 0.
extern "C" cudaError_t semicp_moments_sparse(const float* pts4, const float* chunk_box,
                                             const float* tile_box, const int* span,
                                             const int* order, const float* radius, int n,
                                             int num_classes, unsigned* counter, float* out,
                                             cudaStream_t stream) {
  return launch_moments_walk(pts4, chunk_box, tile_box, span, order, nullptr, radius, n, n,
                             num_classes, counter, out, stream);
}
