// The per-warp sparse nearest-neighbour walk: stage 1 of kernels K2
// (nn_sparse.cu) and K6 (estep_fused.cu), one source for both.
//
// For every valid query and every class k it leaves in keys[k * q + qi]
// the minimum over the class-k targets within the gate of the query (and
// possibly some beyond) of pack_key(d2, index), d2 = |q|^2 + |t|^2 -
// 2 q.t the expanded form, or kNone where no such target was walked.
// Exact ties take the lowest target index. The design (nn_sparse.cu's
// header says why):
//
// - The work is cut into items, one per (query warp, 1024-point target
//   tile) pair whose boxes lie within the gate: `nn_items_kernel` lists
//   them with a warp-aggregated atomic append and keeps the warp's box.
// - Persistent warps of `nn_walk_kernel` take items off an atomic counter.
//   A warp culls the tile's 32-point chunks against its box and then its
//   own valid queries (common.cuh `cull_window`), stages the kept chunks
//   as packed float4s in a warp-private ring of two slots, the next one's
//   loads in flight (`nn_chunk_walk`), and merges its per-class minima
//   into keys with a 64-bit atomicMin: exact and independent of the order
//   in which the items run.
// - `launch_nn_walk` clears the scratch with memsets on the stream and
//   launches both (no host sync, no candidate lists built in torch).
//
// counters: [0] items listed, [1] items taken, [2] chunks walked (each
// chunk is 32 x 32 query-target pairs; the wrappers leave it for a
// measurement to read).
#pragma once

#include "common.cuh"

namespace {

using semicp::Box;
using semicp::ClassBest;
using semicp::kChunk;
using semicp::kFull;
using semicp::kInf;
using semicp::kWalkWarps;

// the key of "no neighbour", the value the keys are cleared to
constexpr unsigned long long kNone = ~0ull;

// One warp per query warp: its box (kept in wbox, 8 floats) and the target
// tiles within the gate of it, appended to `items` as w * n_tt + tile.
__global__ void __launch_bounds__(128)
nn_items_kernel(const float* __restrict__ q_xyz, const bool* __restrict__ q_valid,
                const float4* __restrict__ tile_box, const float* __restrict__ gate, int q,
                int n_tt, float4* __restrict__ wbox, int* __restrict__ items,
                unsigned long long* __restrict__ counters) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= q / kChunk) return;  // uniform across the warp
  const int qi = w * kChunk + lane;
  const Box wb = semicp::warp_box(q_xyz[qi], q_xyz[q + qi], q_xyz[2 * q + qi], q_valid[qi]);
  if (lane == 0) {
    wbox[2 * w] = wb.lo;
    wbox[2 * w + 1] = wb.hi;
  }
  const float lim = semicp::limit2(*gate);
  for (int t0 = 0; t0 < n_tt; t0 += kChunk) {
    const int tt = t0 + lane;
    bool keep = false;
    if (tt < n_tt) {
      const Box b = semicp::load_box(tile_box, tt);
      keep = semicp::box_gap2(wb.lo, wb.hi, b.lo, b.hi) <= lim;
    }
    const unsigned m = __ballot_sync(kFull, keep);
    if (!m) continue;
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(&counters[0], static_cast<unsigned long long>(__popc(m)));
    base = __shfl_sync(kFull, base, 0);
    if (keep) items[base + __popc(m & ((1u << lane) - 1u))] = w * n_tt + tt;
  }
}

// Persistent warps over the items: each walks the chunks of one target
// tile that its query warp needs and merges the per-class minima into keys.
// Shared memory per warp: a ring of two staged chunks (points and labels),
// its 32 query points for the culling, and the per-class best (d2, index)
// of its queries.
__global__ void __launch_bounds__(kWalkWarps * 32)
nn_walk_kernel(const float4* __restrict__ pts4, const int* __restrict__ label_s,
               const float4* __restrict__ chunk_box, const float4* __restrict__ tile_box,
               const float* __restrict__ q_xyz, const bool* __restrict__ q_valid,
               const float4* __restrict__ wbox, const int* __restrict__ items,
               unsigned long long* __restrict__ counters, const float* __restrict__ gate, int q,
               int tb, int n_tt, int num_classes, unsigned long long* __restrict__ keys) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* ring = smem4 + warp * 2 * kChunk;
  int* ring_lab = reinterpret_cast<int*>(smem4 + kWalkWarps * 2 * kChunk) + warp * 2 * kChunk;
  float4* qp = smem4 + kWalkWarps * 2 * kChunk + kWalkWarps * kChunk / 2 + warp * kChunk;
  float* bd = reinterpret_cast<float*>(smem4 + kWalkWarps * 2 * kChunk + kWalkWarps * kChunk / 2 +
                                       kWalkWarps * kChunk) +
              warp * 2 * num_classes * kChunk;
  int* bi = reinterpret_cast<int*>(bd + num_classes * kChunk);

  const float lim = semicp::limit2(*gate);
  const unsigned long long total = counters[0];
  const int per_tile = tb / kChunk;  // <= 32: one window an item
  int slot = 0;

  for (;;) {
    unsigned long long it = 0;
    if (lane == 0) it = atomicAdd(&counters[1], 1ull);
    it = __shfl_sync(kFull, it, 0);
    if (it >= total) break;
    const int item = items[it];
    const int w = item / n_tt;
    const int tt = item - w * n_tt;
    const int qi = w * kChunk + lane;
    const float px = q_xyz[qi], py = q_xyz[q + qi], pz = q_xyz[2 * q + qi];
    const bool active = q_valid[qi];
    const Box wb = {wbox[2 * w], wbox[2 * w + 1]};
    const Box tbx = semicp::load_box(tile_box, tt);
    // prepare_sparse keeps class ranges inside [0, K); the clamp keeps the
    // per-class slots in bounds whatever the boxes say
    const int kmin = static_cast<int>(tbx.lo.w);
    const int kmax = min(static_cast<int>(tbx.hi.w), num_classes - 1);
    for (int k = kmin; k <= kmax; ++k) {
      bd[k * kChunk + lane] = kInf;
      bi[k * kChunk + lane] = -1;
    }
    const int c0 = tt * per_tile;
    qp[lane] = make_float4(px, py, pz, __int_as_float(active ? 0 : -1));
    __syncwarp();
    unsigned m = semicp::cull_window<false>(chunk_box, c0, c0, c0 + per_tile - 1, wb, 0, 0, qp,
                                            lim);
    if (lane == 0 && m) atomicAdd(&counters[2], static_cast<unsigned long long>(__popc(m)));

    const float q2 = px * px + py * py + pz * pz;
    const float m2x = -2.f * px, m2y = -2.f * py, m2z = -2.f * pz;
    ClassBest cur = {-1, kInf, -1};
    int c = m ? __ffs(m) - 1 : -1;
    if (c >= 0) m &= m - 1;
    float4 nxt = make_float4(0.f, 0.f, 0.f, 0.f);
    int nlab = 0;
    if (c >= 0) {
      nxt = __ldg(pts4 + (c0 + c) * kChunk + lane);
      nlab = __ldg(label_s + (c0 + c) * kChunk + lane);
    }
    while (c >= 0) {
      const int cc = c0 + c;
      float4* sp = ring + slot * kChunk;
      int* sl = ring_lab + slot * kChunk;
      sp[lane] = nxt;
      sl[lane] = nlab;
      __syncwarp();
      c = m ? __ffs(m) - 1 : -1;
      if (c >= 0) {
        m &= m - 1;
        nxt = __ldg(pts4 + (c0 + c) * kChunk + lane);
        nlab = __ldg(label_s + (c0 + c) * kChunk + lane);
      }
      const Box cb = semicp::load_box(chunk_box, cc);
      semicp::nn_chunk_walk(sp, sl, cc * kChunk, static_cast<int>(cb.lo.w),
                            static_cast<int>(cb.hi.w), num_classes, q2, m2x, m2y, m2z, cur, bd,
                            bi);
      slot ^= 1;
    }
    semicp::best_flush(cur, bd, bi);
    __syncwarp();
    if (active) {
      for (int k = kmin; k <= kmax; ++k) {
        const int i = bi[k * kChunk + lane];
        if (i >= 0)
          atomicMin(keys + static_cast<size_t>(k) * q + qi,
                    semicp::pack_key(bd[k * kChunk + lane], i));
      }
    }
    __syncwarp();
  }
}

size_t walk_smem_bytes(int num_classes) {
  // ring: 2 x 32 float4 + 2 x 32 labels; queries: 32 float4; best: K x 32 x
  // (f32 + i32), per warp
  return static_cast<size_t>(kWalkWarps) * (2 * kChunk * 16 + 2 * kChunk * 4 + kChunk * 16 +
                                            static_cast<size_t>(num_classes) * kChunk * 8);
}

// Stage 1 on `stream`: clear counters (3,) and keys (K, q), list the items,
// walk them. The arguments are those of semicp_nn_sparse (nn_sparse.cu).
cudaError_t launch_nn_walk(const float* pts4, const int* label_s, const float* tile_box,
                           const float* chunk_box, const float* q_xyz, const bool* q_valid,
                           const float* gate, int n, int q, int tb, int num_classes,
                           unsigned long long* keys, int* items, float* wbox,
                           unsigned long long* counters, cudaStream_t stream) {
  const int n_tt = n / tb;
  const int nw = q / kChunk;
  cudaError_t err = cudaMemsetAsync(counters, 0, 3 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(keys, 0xff, static_cast<size_t>(num_classes) * q * 8, stream);
  if (err != cudaSuccess) return err;
  nn_items_kernel<<<(nw + 3) / 4, 128, 0, stream>>>(q_xyz, q_valid,
                                                    reinterpret_cast<const float4*>(tile_box),
                                                    gate, q, n_tt,
                                                    reinterpret_cast<float4*>(wbox), items,
                                                    counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = walk_smem_bytes(num_classes);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nn_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_walk_kernel,
                                                           kWalkWarps * 32, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  nn_walk_kernel<<<sms * per_sm, kWalkWarps * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(pts4), label_s, reinterpret_cast<const float4*>(chunk_box),
      reinterpret_cast<const float4*>(tile_box), q_xyz, q_valid,
      reinterpret_cast<const float4*>(wbox), items, counters, gate, q, tb, n_tt, num_classes,
      keys);
  return cudaGetLastError();
}

}  // namespace
