// Shared constants and device functions of the semicp_torch CUDA kernels.
//
// The culling and chunk walk of the sparse kernels (K1; K2 and K6 through
// nn_walk.cuh) and the per-class Gaussian/softmax update of the E-step
// (K3, K6) live here, so that the split path and the fused kernel run the
// same arithmetic.
#pragma once

#include <cuda_runtime.h>

namespace semicp {

// "no neighbour" distance and the masked log-likelihood, as in the JAX
// package (corr/pallas_nn2.py INF, register/pallas_estep.py NEG/INF)
constexpr float kInf = 3.0e37f;
constexpr float kNeg = -3.0e37f;

// attribute rows of the NN outputs and of the prepared target slab
// (x, y, z | cov6 | 1 | |t|^2 | label | 4 spare; corr/nn_sparse.py)
constexpr int kAttr = 16;

constexpr float kLog2Pi3 = 5.513631199228036f;  // 3 log(2 pi)

// ---------------------------------------------------------------------------
// The per-warp chunk walk of the sparse kernels (K1; K2 and K6).
//
// A chunk is 32 consecutive points of a class-major Morton sorted cloud,
// one warp's width. Each chunk has a box of 8 floats, two float4s:
// (lo.x, lo.y, lo.z, cmin | hi.x, hi.y, hi.z, cmax), the AABB and class
// range of its valid points (corr/layout.py `pack_boxes`). A chunk with no
// valid point has lo = +inf, hi = -inf and cmin > cmax, so every distance
// to it is +inf and it is culled; no NaN can arise (inf - inf would need
// lo = +inf against hi = +inf). A warp walks a chunk only if the chunk's
// box lies within the squared limit of the warp's box and then of at
// least one active lane's own point (lanes testing 32 chunks at once, see
// `cull_window`). Box distance lower-bounds every pair distance, so the
// walk stays exact.
//
// The distances of the culling are rounded step by step (no contraction
// into FMAs), so corr/nn_sparse.py `nn_walked_chunks` and
// cloud/moments.py `moments_walked_chunks` reproduce the kernels' walks
// to the chunk and the walked-pair counts can be checked.
constexpr int kChunk = 32;
constexpr int kWalkWarps = 4;  // warps in a block of the persistent walks
constexpr unsigned kFull = 0xffffffffu;

struct Box {
  float4 lo, hi;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ Box load_box(const float4* __restrict__ boxes, int c) {
  return {__ldg(boxes + 2 * c), __ldg(boxes + 2 * c + 1)};
}

// The slack of corr/layout.py tile_candidates on a squared limit:
// g^2 (1 + 1e-5) + 1e-6, in f32.
__device__ __forceinline__ float limit2(float g) {
  return __fadd_rn(__fmul_rn(__fmul_rn(g, g), 1.00001f), 1e-6f);
}

__device__ __forceinline__ float gap(float alo, float ahi, float blo, float bhi) {
  return fmaxf(fmaxf(__fsub_rn(alo, bhi), __fsub_rn(blo, ahi)), 0.f);
}

// Squared distance between two boxes (zero where they overlap).
__device__ __forceinline__ float box_gap2(const float4& alo, const float4& ahi,
                                          const float4& blo, const float4& bhi) {
  const float dx = gap(alo.x, ahi.x, blo.x, bhi.x);
  const float dy = gap(alo.y, ahi.y, blo.y, bhi.y);
  const float dz = gap(alo.z, ahi.z, blo.z, bhi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The box of the warp's active lanes' points, by shuffles (+inf/-inf when
// no lane is active).
__device__ __forceinline__ Box warp_box(float px, float py, float pz, bool active) {
  const float inf = pos_inf();
  Box b;
  b.lo = active ? make_float4(px, py, pz, 0.f) : make_float4(inf, inf, inf, 0.f);
  b.hi = active ? make_float4(px, py, pz, 0.f) : make_float4(-inf, -inf, -inf, 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    b.lo.x = fminf(b.lo.x, __shfl_xor_sync(kFull, b.lo.x, off));
    b.lo.y = fminf(b.lo.y, __shfl_xor_sync(kFull, b.lo.y, off));
    b.lo.z = fminf(b.lo.z, __shfl_xor_sync(kFull, b.lo.z, off));
    b.hi.x = fmaxf(b.hi.x, __shfl_xor_sync(kFull, b.hi.x, off));
    b.hi.y = fmaxf(b.hi.y, __shfl_xor_sync(kFull, b.hi.y, off));
    b.hi.z = fmaxf(b.hi.z, __shfl_xor_sync(kFull, b.hi.z, off));
  }
  return b;
}

// The chunks c0 + j in [c_first, c_last] (j < 32) that the warp walks, as a
// bit mask.
// qp holds the warp's 32 query points in shared memory, with the int bits
// of w < 0 for an inactive lane; with kClass (the moments) w is the
// point's label, and a chunk must also share a class with the warp's
// range [wcmin, wcmax] and hold an active point's label in its own range.
// Lane j tests chunk c0 + j: first its box against the warp's box, then,
// if that passes, against each of the 32 points (LDS.128 broadcasts, no
// serial chain across chunks). Every lane of the warp must call it.
template <bool kClass>
__device__ __forceinline__ unsigned cull_window(const float4* __restrict__ boxes, int c0,
                                                int c_first, int c_last, const Box& wb,
                                                int wcmin, int wcmax,
                                                const float4* __restrict__ qp, float lim) {
  const int lane = threadIdx.x & 31;
  const int c = c0 + lane;
  bool keep = false;
  Box b;
  if (c >= c_first && c <= c_last) {
    b = load_box(boxes, c);
    keep = box_gap2(wb.lo, wb.hi, b.lo, b.hi) <= lim;
    if (kClass)
      keep = keep && static_cast<int>(b.lo.w) <= wcmax && wcmin <= static_cast<int>(b.hi.w);
  }
  if (!__ballot_sync(kFull, keep)) return 0u;
  bool hit = false;
  if (keep) {
    const int cmin = static_cast<int>(b.lo.w), cmax = static_cast<int>(b.hi.w);
#pragma unroll 4
    for (int i = 0; i < kChunk; ++i) {
      const float4 p = qp[i];
      const int l = __float_as_int(p.w);
      bool h = l >= 0 && box_gap2(p, p, b.lo, b.hi) <= lim;
      if (kClass) h = h && l >= cmin && l <= cmax;
      hit = hit || h;
    }
  }
  return __ballot_sync(kFull, hit);
}

// Running best of one class in registers: the class, its d2 and index.
struct ClassBest {
  int k;
  float d;
  int i;
};

// Write the cached class back to the warp's per-class slots (k * 32 + lane).
__device__ __forceinline__ void best_flush(const ClassBest& cur, float* __restrict__ bd,
                                           int* __restrict__ bi) {
  if (cur.k >= 0) {
    const int lane = threadIdx.x & 31;
    bd[cur.k * kChunk + lane] = cur.d;
    bi[cur.k * kChunk + lane] = cur.i;
  }
}

__device__ __forceinline__ void best_switch(ClassBest& cur, int k, float* __restrict__ bd,
                                            int* __restrict__ bi) {
  best_flush(cur, bd, bi);
  const int lane = threadIdx.x & 31;
  cur.k = k;
  cur.d = bd[k * kChunk + lane];
  cur.i = bi[k * kChunk + lane];
}

// The NN walk of one staged chunk (K2, K6): sp holds its 32 points as
// (x, y, z, |t|^2) with |t|^2 = +inf for an invalid point, sl their labels
// (num_classes = invalid), `base` the index of its first point and
// [cmin, cmax] its class range. d2 = |q|^2 + |t|^2 - 2 q.t is one fmaf
// chain, the same in every kernel that walks, so their bits agree. A chunk
// of one class (the usual case in the class-major layout) runs its 32
// pairs without a branch or a label read, against the class's best in
// registers; a mixed chunk takes the per-pair path, which skips every
// label outside [0, num_classes). Chunks are walked in ascending index
// order, so a strict < keeps the lowest index of a tie.
__device__ __forceinline__ void nn_chunk_walk(const float4* __restrict__ sp,
                                              const int* __restrict__ sl, int base, int cmin,
                                              int cmax, int num_classes, float q2, float m2x,
                                              float m2y, float m2z, ClassBest& cur,
                                              float* __restrict__ bd, int* __restrict__ bi) {
  if (cmin == cmax && static_cast<unsigned>(cmin) < static_cast<unsigned>(num_classes)) {
    if (cmin != cur.k) best_switch(cur, cmin, bd, bi);
    float d = cur.d;
    int idx = cur.i;
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const float4 t = sp[j];
      const float d2 = fmaf(m2z, t.z, fmaf(m2y, t.y, fmaf(m2x, t.x, q2 + t.w)));
      const bool better = d2 < d;
      d = better ? d2 : d;
      idx = better ? base + j : idx;
    }
    cur.d = d;
    cur.i = idx;
    return;
  }
  for (int j = 0; j < kChunk; ++j) {
    const int lab = sl[j];
    if (static_cast<unsigned>(lab) >= static_cast<unsigned>(num_classes)) continue;
    const float4 t = sp[j];
    const float d2 = fmaf(m2z, t.z, fmaf(m2y, t.y, fmaf(m2x, t.x, q2 + t.w)));
    if (lab != cur.k) best_switch(cur, lab, bd, bi);
    if (d2 < cur.d) {
      cur.d = d2;
      cur.i = base + j;
    }
  }
}

// The (d2, index) pair as one 64-bit key whose unsigned order is the
// lexicographic order of (d2, index): the f32 bits mapped to an order-
// preserving unsigned (negatives flipped, positives with the sign bit
// set; -0 is taken as +0) in the high word, the index in the low word.
// atomicMin on such keys merges per-class minima exactly and in any order.
__device__ __forceinline__ unsigned long long pack_key(float d2, int i) {
  const unsigned u = __float_as_uint(d2 + 0.f);
  const unsigned e = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(e) << 32) | static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  const unsigned e = static_cast<unsigned>(key >> 32);
  return __uint_as_float((e & 0x80000000u) ? (e ^ 0x80000000u) : ~e);
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
