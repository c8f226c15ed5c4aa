// The Gauss-Newton / LM M-step over SE(3) and the end of the EM pass, in
// one persistent launch (kernel G1).
//
// No Pallas kernel of the JAX package corresponds: `gn_solve`
// (semicp/register/gauss_newton.py:37) is a `lax.while_loop` inside the one
// XLA program of the EM loop, and XLA fuses its body, the convergence test
// (semicp/register/em_icp.py:202-210) and the next E-step's inputs
// (em_icp.py:120, 131, 150) into a few device kernels. G1 is all of it in
// one launch.
//
// Contract (register/gauss_newton.py `em_tail_plain`): from T = T_in,
// lambda = lm_lambda0, cost = -1, step = +inf, H = 0, each of at most
// max_iters passes runs while step > step_eps (a NaN step stops the loop
// after the pass that produced it, whose update is applied):
//
//   p = T z; (H, g, cost') = the 28 sums of residuals.py (_H_INDEX layout)
//   delta = solve(H + lambda diag(diag H), -g)   (f32 LU, partial pivoting)
//   T <- exp(delta) T                            (geom/se3.py thresholds)
//   lambda <- worse ? lambda up : max(lambda down, lambda0),
//   worse = cost >= 0 & cost' > cost; then cost <- cost', step <- |delta|.
//
// The returned H and cost are the last pass's, at the pose before its
// update. Then, at the final T: em_step = ||se3_log(T T_in^-1)||, n_corr =
// sum of wsum, and the next E-step's inputs moved = T z (3, n) and rc =
// R cov6 R^T (6, n). With solve = 0 (the first E-step of an align) only
// moved and rc are written, at T_in.
//
// Bound on the H100: bytes. The 13 planes z, a6, b3, c, wsum and cov6 are
// read once and moved and rc written once (116 B a point, 15 MB at
// N = 131072: 4.5 us at 3.35 TB/s); a GN pass is about 130 flops a point.
// What the old design lost was latency: a launch a pass, the planes
// streamed again from L2 in each, a ticket and one thread solving while
// the grid drained. The design:
//
// - One cooperative launch with no more blocks than can be co-resident
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Each block keeps a
//   fixed contiguous share of the points for the whole solve; passes are
//   separated by a grid barrier, and the loop ends inside the kernel once
//   the step is not above step_eps.
// - The block's 13 planes (z, a6, b3, c) are staged in shared memory once
//   with cp.async, and every pass and the final transform read them there.
//   Above what two blocks an SM can hold, the planes are read from L2 in
//   every pass (`semicp_gn_plan` picks the path from N).
// - Deterministic with one barrier a pass: each block writes one partial
//   row (28 sums, and in the first pass the wsum sum as a 29th) into one of
//   two buffers that alternate by pass parity. After the barrier every
//   block adds all rows in block order and solves the same 6x6 system, so
//   every block holds the same state to the bit. No float atomics; only
//   block 0 writes the state.
// - Arithmetic as before: each point's 28 terms in residuals.py's order
//   with __fmul_rn/__fadd_rn (no FMA contraction), so they equal the plain
//   version's to the bit; moved and rc in apply_T_planar's and
//   sym3.rotate's order, so they equal the plain version's at the same T.
//
// Distributed mode, G1d (`gn_solve(..., axis_name=...)`,
// gauss_newton.py:37-84, whose psums of H, g and the cost run in every GN
// pass; the port's dist/align_dist.py). A collective cannot run inside a
// launch, but the psums need not run in every pass: the E-step freezes the
// planes for the M-step, and a pass's 28 sums are polynomials of degree
// <= 2 in p = T z. With zt = (z, 1) and pt = (T z, 1) = T zt, the 74
// pose-independent sums of a_k zt zt^T (60), b_j zt (12), c and wsum fix
// every pass's system: sum a_k pt pt^T = T (sum a_k zt zt^T) T^T, and each
// of the 28 sums is an integer combination of those (the term table,
// gauss_newton.py `_MOMENT_TERMS`, which the tail kernel reads from the
// device).
// So the one collective of an M-step runs before its GN loop. Each call
// on each rank is two launches with the group's all-reduce between them:
//
//   gn_moments_kernel    the 74 sums over this rank's points in float64
//                        (c cancels against 2 b.p and p.A p in the cost:
//                        float32 sums would lose it), each point's 56 B of
//                        planes read once; each block's partial row, one
//                        grid barrier, then block 0 adds the rows in block
//                        order into a row of 80 doubles. No float atomics:
//                        two calls give the same bits.
//   all_reduce(row)      NCCL or gloo, in the stream's order; every rank
//                        then holds the same row to the bit.
//   gn_dist_tail_kernel  every block runs the same GN passes from the row:
//                        warp 0 forms the pass's moments at the pose and
//                        its 28 sums in float64, rounds them to f32, and
//                        thread 0 runs G1's `gn_update` on G1's state
//                        layout, until step <= step_eps or max_iters. Block
//                        0 writes the state (n_corr from the row, em_step);
//                        then every block writes moved and rc at the final
//                        T for its points, as G1's tail does.
//
// Ranks agree to the bit: the loop reads nothing but the all-reduced row
// and the state. Bound: bytes, 116 B a point (z, a6, b3, c, wsum read by
// the moments kernel, z and cov6 by the tail, moved and rc written); the
// GN passes cost the tail kernel microseconds, whatever N.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kSums = 28;    // A (6), B (9), C (6), u (3), u x p (3), cost
constexpr int kRow = 32;     // a partial row: the 28 sums, the wsum sum, 3 spare
constexpr int kGroups = kBlock / (kRow / 4);  // float4 columns read per block row
constexpr int kPlanes = 13;  // z (3), a6 (6), b3 (3), c (1)
// the state, f32: T (4,4) row-major, H (6,6), cost, GN step, lambda, passes
// run, em_step, n_corr
constexpr int kT = 0, kH = 16, kCost = 52, kStep = 53, kLam = 54, kPasses = 55, kEmStep = 56,
              kNCorr = 57, kState = 64;

struct GNArgs {
  const float *z, *cov6, *a6, *b3, *c, *wsum, *T_in;
  int n, share, solve, max_iters;
  float lam0, up, down, step_eps;
  float *state, *partials, *moved, *rc;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Plane p of the 13 staged ones, in global memory.
__device__ __forceinline__ const float* plane(const GNArgs& a, int p) {
  const size_t n = static_cast<size_t>(a.n);
  if (p < 3) return a.z + p * n;
  if (p < 9) return a.a6 + (p - 3) * n;
  if (p < 12) return a.b3 + (p - 9) * n;
  return a.c;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// One point's 28 terms (residuals.py `_system_terms` and the cost of
// `normal_equations_collapsed`) at p = T z, T the top three rows of the pose.
__device__ __forceinline__ void point_terms(const float (&T)[12], const float (&v)[kPlanes],
                                            float (&s)[kSums]) {
  const float zx = v[0], zy = v[1], zz = v[2];
  const float px = add(add(add(mul(T[0], zx), mul(T[1], zy)), mul(T[2], zz)), T[3]);
  const float py = add(add(add(mul(T[4], zx), mul(T[5], zy)), mul(T[6], zz)), T[7]);
  const float pz = add(add(add(mul(T[8], zx), mul(T[9], zy)), mul(T[10], zz)), T[11]);
  const float a00 = v[3], a11 = v[4], a22 = v[5], a01 = v[6], a02 = v[7], a12 = v[8];
  const float bx = v[9], by = v[10], bz = v[11], c = v[12];
  const float ap0 = add(add(mul(a00, px), mul(a01, py)), mul(a02, pz));  // A p
  const float ap1 = add(add(mul(a01, px), mul(a11, py)), mul(a12, pz));
  const float ap2 = add(add(mul(a02, px), mul(a12, py)), mul(a22, pz));
  const float t0 = sub(bx, ap0), t1 = sub(by, ap1), t2 = sub(bz, ap2);  // u = b - A p
  const float bp = add(add(mul(bx, px), mul(by, py)), mul(bz, pz));
  const float cost =
      add(add(add(sub(c, mul(2.f, bp)), mul(px, ap0)), mul(py, ap1)), mul(pz, ap2));
  // B = A P, P = hat(p)
  const float b00 = sub(mul(a01, pz), mul(a02, py));
  const float b01 = add(-mul(a00, pz), mul(a02, px));
  const float b02 = sub(mul(a00, py), mul(a01, px));
  const float b10 = sub(mul(a11, pz), mul(a12, py));
  const float b11 = add(-mul(a01, pz), mul(a12, px));
  const float b12 = sub(mul(a01, py), mul(a11, px));
  const float b20 = sub(mul(a12, pz), mul(a22, py));
  const float b21 = add(-mul(a02, pz), mul(a22, px));
  const float b22 = sub(mul(a02, py), mul(a12, px));
  // C = P^T A P = -P B
  s[0] = a00; s[1] = a11; s[2] = a22; s[3] = a01; s[4] = a02; s[5] = a12;
  s[6] = b00; s[7] = b01; s[8] = b02; s[9] = b10; s[10] = b11; s[11] = b12;
  s[12] = b20; s[13] = b21; s[14] = b22;
  s[15] = sub(mul(pz, b10), mul(py, b20));
  s[16] = sub(mul(pz, b11), mul(py, b21));
  s[17] = sub(mul(pz, b12), mul(py, b22));
  s[18] = add(-mul(pz, b01), mul(px, b21));
  s[19] = add(-mul(pz, b02), mul(px, b22));
  s[20] = sub(mul(py, b02), mul(px, b12));
  s[21] = t0; s[22] = t1; s[23] = t2;
  s[24] = sub(mul(t1, pz), mul(t2, py));
  s[25] = sub(mul(t2, px), mul(t0, pz));
  s[26] = sub(mul(t0, py), mul(t1, px));
  s[27] = cost;
}

// This block's partial row over its points [lo, lo + cnt) at pose T: the
// 28 sums, and with `first` the wsum sum as the 29th. Written to row
// blockIdx.x of `rows`. red: kGroups x kRow floats of shared memory.
template <bool kStaged>
__device__ __forceinline__ void block_sums(const GNArgs& a, const float* __restrict__ stage,
                                           int lo, int cnt, const float (&T)[12], bool first,
                                           float (*red)[kRow], float* __restrict__ rows) {
  float acc[kSums + 1];
#pragma unroll
  for (int j = 0; j <= kSums; ++j) acc[j] = 0.f;
  for (int li = threadIdx.x; li < cnt; li += kBlock) {
    float v[kPlanes], s[kSums];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      v[p] = kStaged ? stage[p * a.share + li] : __ldg(plane(a, p) + lo + li);
    point_terms(T, v, s);
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j] = add(acc[j], s[j]);
    if (first) acc[kSums] = add(acc[kSums], __ldg(a.wsum + lo + li));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j <= kSums; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] = add(acc[j], __shfl_xor_sync(semicp::kFull, acc[j], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j <= kSums; ++j) red[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x <= kSums) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = add(v, red[w][threadIdx.x]);
    __stcg(rows + blockIdx.x * kRow + threadIdx.x, v);
  }
}

// The grid's sums from all partial rows, in block order, the same in every
// block: thread (g, q) adds float4 column q of rows g, g + 32, ..., then
// each sum adds the 32 groups in order. Leaves them in sums[0, 29).
__device__ __forceinline__ void grid_sums(const float* __restrict__ rows, float (*red)[kRow],
                                          float* __restrict__ sums) {
  const int g = threadIdx.x >> 3, q = threadIdx.x & 7;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = g; b < static_cast<int>(gridDim.x); b += kGroups) {
    const float4 x = __ldcg(r4 + b * (kRow / 4) + q);
    v = make_float4(add(v.x, x.x), add(v.y, x.y), add(v.z, x.z), add(v.w, x.w));
  }
  red[g][4 * q] = v.x;
  red[g][4 * q + 1] = v.y;
  red[g][4 * q + 2] = v.z;
  red[g][4 * q + 3] = v.w;
  __syncthreads();
  if (threadIdx.x <= kSums) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kGroups; ++w) s = add(s, red[w][threadIdx.x]);
    sums[threadIdx.x] = s;
  }
  __syncthreads();
}

// x = M^-1 r for the 6x6 M, LU with partial pivoting in f32 (the first
// largest pivot wins, as LAPACK's isamax picks it). A zero pivot gives
// non-finite x, as in the plain version.
__device__ __forceinline__ void solve6(float (&M)[6][6], float (&r)[6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(M[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(M[i][k]) > best) {
        best = fabsf(M[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {  // swap rows k and p (a static index keeps M in registers)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = M[k][j];
          M[k][j] = M[i][j];
          M[i][j] = t;
        }
        const float t = r[k];
        r[k] = r[i];
        r[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = M[i][k] / M[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) M[i][j] = sub(M[i][j], mul(f, M[k][j]));
      r[i] = sub(r[i], mul(f, r[k]));
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = r[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) v = sub(v, mul(M[i][j], x[j]));
    x[i] = v / M[i][i];
  }
}

// E = se3_exp(delta) (geom/se3.py: the same Taylor thresholds and series),
// top three rows.
__device__ __forceinline__ void se3_exp(const float (&d)[6], float (&E)[3][4]) {
  const float wx = d[3], wy = d[4], wz = d[5];
  const float theta2 = add(add(mul(wx, wx), mul(wy, wy)), mul(wz, wz));
  const bool small = theta2 < 1e-8f;
  const float safe2 = small ? 1.f : theta2;
  const float theta = sqrtf(safe2);
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? sub(1.f, theta2 / 6.f) : sn / theta;              // R
  const float b = small ? sub(0.5f, theta2 / 24.f) : sub(1.f, cs) / safe2;
  const float va = b;                                                        // V
  const float vb = small ? sub(1.f / 6.f, theta2 / 120.f) : sub(theta, sn) / mul(safe2, theta);
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = add(add(mul(W[i][0], W[0][j]), mul(W[i][1], W[1][j])), mul(W[i][2], W[2][j]));
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i][j] = add(add(eye, mul(a, W[i][j])), mul(b, W2[i][j]));
      V[i][j] = add(add(eye, mul(va, W[i][j])), mul(vb, W2[i][j]));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    E[i][3] = add(add(mul(V[i][0], d[0]), mul(V[i][1], d[1])), mul(V[i][2], d[2]));
}

// One GN pass's update of the state st (shared memory) from its sums.
__device__ void gn_update(const float* __restrict__ s, float* __restrict__ st, const GNArgs& a) {
  const int kIndex[6][6] = {{0, 3, 4, 6, 7, 8},      {3, 1, 5, 9, 10, 11},
                            {4, 5, 2, 12, 13, 14},   {6, 9, 12, 15, 16, 17},
                            {7, 10, 13, 16, 18, 19}, {8, 11, 14, 17, 19, 20}};
  float H[6][6], M[6][6], r[6], delta[6];
  const float lam = st[kLam];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float v = s[kIndex[i][j]];
      H[i][j] = (i < 3) == (j < 3) ? v : -v;  // [[A, -B], [-B^T, C]]
      M[i][j] = H[i][j];
    }
    M[i][i] = add(H[i][i], mul(lam, H[i][i]));
    r[i] = i < 3 ? s[21 + i] : -s[21 + i];   // -g, g = [-u, u x p]
  }
  solve6(M, r, delta);
  float E[3][4];
  se3_exp(delta, E);
  float T[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) T[j] = st[kT + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[kT + 4 * i + j] =
          add(add(add(mul(E[i][0], T[j]), mul(E[i][1], T[4 + j])), mul(E[i][2], T[8 + j])),
              mul(E[i][3], T[12 + j]));
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) st[kH + 6 * i + j] = H[i][j];
  const float cost = s[27], prev = st[kCost];
  const bool worse = prev >= 0.f && cost > prev;
  st[kLam] = worse ? mul(lam, a.up) : fmaxf(mul(lam, a.down), a.lam0);
  st[kCost] = cost;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) ss = add(ss, mul(delta[i], delta[i]));
  st[kStep] = sqrtf(ss);
  st[kPasses] = add(st[kPasses], 1.f);
}

// ||se3_log(T Ti^-1)|| for two poses (row-major 4x4): geom/se3.py's
// se3_inverse, the quaternion so3_log (branchless Shepperd, the first
// largest pivot) and the V^-1 series, with the same thresholds.
__device__ float em_step(const float* __restrict__ T, const float* __restrict__ Ti) {
  float inv[4][4];  // [[R^T, -R^T t], [0, 0, 0, 1]]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) inv[i][j] = Ti[4 * j + i];
    inv[i][3] = -(inv[i][0] * Ti[3] + inv[i][1] * Ti[7] + inv[i][2] * Ti[11]);
    inv[3][i] = 0.f;
  }
  inv[3][3] = 1.f;
  float D[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      D[i][j] = T[4 * i] * inv[0][j] + T[4 * i + 1] * inv[1][j] + T[4 * i + 2] * inv[2][j] +
                T[4 * i + 3] * inv[3][j];
  const float r00 = D[0][0], r01 = D[0][1], r02 = D[0][2];
  const float r10 = D[1][0], r11 = D[1][1], r12 = D[1][2];
  const float r20 = D[2][0], r21 = D[2][1], r22 = D[2][2];
  const float tr = r00 + r11 + r22;
  const float piv[4] = {1.f + tr, 1.f + 2.f * r00 - tr, 1.f + 2.f * r11 - tr,
                        1.f + 2.f * r22 - tr};
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (piv[k] > piv[best]) best = k;
  const float s = sqrtf(fmaxf(piv[best], 1e-12f)) * 2.f;
  const float a = (r21 - r12) / s, b = (r02 - r20) / s, c = (r10 - r01) / s;
  const float d = (r01 + r10) / s, e = (r02 + r20) / s, f = (r12 + r21) / s;
  const float h = 0.25f * s;
  float q[4];
  if (best == 0) { q[0] = h; q[1] = a; q[2] = b; q[3] = c; }
  else if (best == 1) { q[0] = a; q[1] = h; q[2] = d; q[3] = e; }
  else if (best == 2) { q[0] = b; q[1] = d; q[2] = h; q[3] = f; }
  else { q[0] = c; q[1] = e; q[2] = f; q[3] = h; }
  const float sign = q[0] < 0.f ? -1.f : 1.f;
  float qn = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] *= sign;
    qn += q[k] * q[k];
  }
  qn = sqrtf(qn);
  const float qw = q[0] / qn, vx = q[1] / qn, vy = q[2] / qn, vz = q[3] / qn;
  const float vn2 = vx * vx + vy * vy + vz * vz;  // so3_log
  const bool small = vn2 < 1e-8f;
  const float vn = sqrtf(small ? 1.f : vn2);
  const float theta = 2.f * atan2f(sqrtf(vn2), qw);
  const float scale = small ? 2.f / fmaxf(qw, 1e-6f) : theta / vn;
  const float w[3] = {vx * scale, vy * scale, vz * scale};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];  // se3_log
  const bool small2 = th2 < 1e-8f;
  const float safe2 = small2 ? 1.f : th2;
  const float th = sqrtf(safe2);
  const float cc = small2 ? 1.f / 12.f + th2 / 720.f
                          : 1.f / safe2 - (1.f + cosf(th)) / (2.f * th * sinf(th));
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float out = th2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float vinv = (i == j ? 1.f : 0.f) - 0.5f * W[i][j] + cc * w2;
      v += vinv * D[j][3];
    }
    out += v * v;
  }
  return sqrtf(out);
}

// The next E-step's inputs of point i at pose T (top three rows): moved =
// T z (apply_T_planar's order) and rc = R C R^T (sym3.rotate's order).
__device__ __forceinline__ void move_point(const float (&T)[12], float zx, float zy, float zz,
                                           const float* __restrict__ cov6, int i, size_t ns,
                                           float* __restrict__ moved, float* __restrict__ rc) {
  moved[i] = add(add(add(mul(T[0], zx), mul(T[1], zy)), mul(T[2], zz)), T[3]);
  moved[ns + i] = add(add(add(mul(T[4], zx), mul(T[5], zy)), mul(T[6], zz)), T[7]);
  moved[2 * ns + i] = add(add(add(mul(T[8], zx), mul(T[9], zy)), mul(T[10], zz)), T[11]);
  const float xx = __ldg(cov6 + i), yy = __ldg(cov6 + ns + i);
  const float zz6 = __ldg(cov6 + 2 * ns + i), xy = __ldg(cov6 + 3 * ns + i);
  const float xz = __ldg(cov6 + 4 * ns + i), yz = __ldg(cov6 + 5 * ns + i);
  float row[3][3];  // row a of C R^T (sym3.rotate `row`)
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float r0 = T[4 * r], r1 = T[4 * r + 1], r2 = T[4 * r + 2];
    row[r][0] = add(add(mul(xx, r0), mul(xy, r1)), mul(xz, r2));
    row[r][1] = add(add(mul(xy, r0), mul(yy, r1)), mul(yz, r2));
    row[r][2] = add(add(mul(xz, r0), mul(yz, r1)), mul(zz6, r2));
  }
  // sym3.rotate `dot`: row ra against row b of R
  auto dot = [&](int ra, int b) {
    return add(add(mul(row[ra][0], T[4 * b]), mul(row[ra][1], T[4 * b + 1])),
               mul(row[ra][2], T[4 * b + 2]));
  };
  rc[i] = dot(0, 0);
  rc[ns + i] = dot(1, 1);
  rc[2 * ns + i] = dot(2, 2);
  rc[3 * ns + i] = dot(0, 1);
  rc[4 * ns + i] = dot(0, 2);
  rc[5 * ns + i] = dot(1, 2);
}

template <bool kStaged>
__global__ void __launch_bounds__(kBlock, 2) gn_em_kernel(const GNArgs a) {
  extern __shared__ float stage[];           // kPlanes x share (kStaged)
  __shared__ __align__(16) float red[kGroups][kRow];
  __shared__ float sums[kRow];
  __shared__ float st[kState];               // the state, the same in every block
  __shared__ float t_in[16];
  const int n = a.n;
  const int lo = blockIdx.x * a.share;
  const int cnt = max(0, min(n - lo, a.share));
  if (threadIdx.x < 16) t_in[threadIdx.x] = a.T_in[threadIdx.x];
  if (threadIdx.x < kState) {
    const int t = threadIdx.x;
    st[t] = t < 16 ? a.T_in[t]
                   : t == kCost ? -1.f
                   : t == kStep ? semicp::pos_inf()
                   : t == kLam ? a.lam0 : 0.f;
  }
  if (kStaged) {
#pragma unroll 1
    for (int p = 0; p < kPlanes; ++p) {
      const float* src = plane(a, p) + lo;
      for (int li = threadIdx.x; li < cnt; li += kBlock)
        cp_async4(stage + p * a.share + li, src + li);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  if (a.solve) {
    cg::grid_group grid = cg::this_grid();
    for (int it = 0;; ++it) {
      // uniform over the grid: every block holds the same state
      const bool run = it < a.max_iters && st[kStep] > a.step_eps;
      if (it > 0 && !run) break;
      float T[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) T[j] = st[kT + j];
      float* rows = a.partials + static_cast<size_t>(it & 1) * gridDim.x * kRow;
      block_sums<kStaged>(a, stage, lo, cnt, T, it == 0, red, rows);
      grid.sync();
      grid_sums(rows, red, sums);
      if (it == 0 && threadIdx.x == 0) st[kNCorr] = sums[kSums];
      if (!run) break;  // max_iters = 0: the wsum sum only
      if (threadIdx.x == 0) gn_update(sums, st, a);
      __syncthreads();
    }
    __syncthreads();
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) st[kEmStep] = em_step(st + kT, t_in);
      __syncthreads();
      if (threadIdx.x < kState) a.state[threadIdx.x] = st[threadIdx.x];
    }
  }

  // the next E-step's inputs at the final pose
  float T[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) T[j] = st[kT + j];
  const size_t ns = static_cast<size_t>(n);
  for (int li = threadIdx.x; li < cnt; li += kBlock) {
    const int i = lo + li;
    float zx, zy, zz;
    if (kStaged) {
      zx = stage[li];
      zy = stage[a.share + li];
      zz = stage[2 * a.share + li];
    } else {
      zx = __ldg(a.z + i);
      zy = __ldg(a.z + ns + i);
      zz = __ldg(a.z + 2 * ns + i);
    }
    move_point(T, zx, zy, zz, a.cov6, i, ns, a.moved, a.rc);
  }
}

// ---- G1d, the distributed mode ----

constexpr int kMom = 80;       // the moment row: 74 sums, then zeros
constexpr int kMomUsed = 74;   // [10 k + s] a_k zt zt^T, [60 + 4 j + m] b_j zt, [72] c, [73] wsum
constexpr int kPoseMom = 73;   // the row's first 73 sums at a pose (pt for zt)
constexpr int kMomGroups = kBlock / (kMom / 2);  // double2 columns read per block row
constexpr int kTerms = 10;     // the most terms of one of the 28 sums

// (m, l) of the symmetric zt zt^T in the row's order, and its inverse
__constant__ signed char kSym4[10][2] = {{0, 0}, {1, 1}, {2, 2}, {0, 1}, {0, 2},
                                         {1, 2}, {0, 3}, {1, 3}, {2, 3}, {3, 3}};
__constant__ signed char kSym4Index[4][4] = {{0, 3, 4, 6}, {3, 1, 5, 7}, {4, 5, 2, 8},
                                             {6, 7, 8, 9}};

struct MomArgs {
  const float *z, *a6, *b3, *c, *wsum;
  int n, share;
  double *partials, *row;
};

// This rank's moment row: each thread's sums over its points in float64,
// each block's partial row, one grid barrier, then block 0 adds the rows
// in block order into row (kMom doubles).
__global__ void __launch_bounds__(kBlock, 1) gn_moments_kernel(const MomArgs m) {
  __shared__ double red[kWarps][kMomUsed];
  __shared__ double2 red2[kMomGroups][kMom / 2];
  const size_t ns = static_cast<size_t>(m.n);
  const int lo = blockIdx.x * m.share;
  const int cnt = max(0, min(m.n - lo, m.share));
  double acc[kMomUsed];
#pragma unroll
  for (int j = 0; j < kMomUsed; ++j) acc[j] = 0.0;
  for (int li = threadIdx.x; li < cnt; li += kBlock) {
    const int i = lo + li;
    const double x = __ldg(m.z + i), y = __ldg(m.z + ns + i), z = __ldg(m.z + 2 * ns + i);
    const double zt[4] = {x, y, z, 1.0};
    const double zz[10] = {x * x, y * y, z * z, x * y, x * z, y * z, x, y, z, 1.0};  // kSym4
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const double a = __ldg(m.a6 + k * ns + i);
#pragma unroll
      for (int q = 0; q < 10; ++q) acc[10 * k + q] += a * zz[q];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double b = __ldg(m.b3 + j * ns + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[60 + 4 * j + q] += b * zt[q];
    }
    acc[72] += __ldg(m.c + i);
    acc[73] += __ldg(m.wsum + i);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMomUsed; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(semicp::kFull, acc[j], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kMomUsed; ++j) red[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < kMom) {
    double v = 0.0;
    if (threadIdx.x < kMomUsed) {
      v = red[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][threadIdx.x];
    }
    __stcg(m.partials + static_cast<size_t>(blockIdx.x) * kMom + threadIdx.x, v);
  }
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  // thread (g, q) adds double2 column q of rows g, g + kMomGroups, ...;
  // then each column adds the groups in order
  const int g = threadIdx.x / (kMom / 2), q = threadIdx.x % (kMom / 2);
  if (g < kMomGroups) {
    const double2* r2 = reinterpret_cast<const double2*>(m.partials);
    double2 v = make_double2(0.0, 0.0);
    for (int b = g; b < static_cast<int>(gridDim.x); b += kMomGroups) {
      const double2 x = __ldcg(r2 + static_cast<size_t>(b) * (kMom / 2) + q);
      v.x += x.x;
      v.y += x.y;
    }
    red2[g][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMom / 2) {
    double2 v = red2[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kMomGroups; ++w) {
      v.x += red2[w][threadIdx.x].x;
      v.y += red2[w][threadIdx.x].y;
    }
    m.row[2 * threadIdx.x] = v.x;
    m.row[2 * threadIdx.x + 1] = v.y;
  }
}

// Warp 0's share of every GN pass, read from the tables once a launch:
// the pose moments this lane forms (entries lane, lane + 32, lane + 64 of
// F: sum a_k pt_r pt_c at k < 6, sum b_j pt_r at k = 6 + j) and the terms
// coef x F[idx] of its sum (lanes < 28), from the term table terms (2, 28,
// kTerms) int32: [0] indices, -1 after the last; [1] coefficients.
struct PassLane {
  int k[3], r[3], c[3];
  int idx[kTerms];
  double coef[kTerms];
};

__device__ __forceinline__ PassLane pass_lane(int lane, const int* __restrict__ terms) {
  PassLane pl;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int e = lane + 32 * q;
    pl.k[q] = e < 60 ? e / 10 : e < kPoseMom - 1 ? 6 + ((e - 60) >> 2) : -1;
    pl.r[q] = e < 60 ? kSym4[e % 10][0] : (e - 60) & 3;
    pl.c[q] = e < 60 ? kSym4[e % 10][1] : 3;
  }
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const int idx = lane < kSums ? __ldg(terms + lane * kTerms + t) : -1;
    const int coef = lane < kSums ? __ldg(terms + (kSums + lane) * kTerms + t) : 0;
    pl.idx[t] = idx < 0 ? 0 : idx;
    pl.coef[t] = idx < 0 ? 0.0 : static_cast<double>(coef);
  }
  return pl;
}

// One GN pass's 28 sums at the state's pose from the moment row mom, by
// warp 0: F = the row's sums at the pose (pt = T zt: T M_k T^T for each
// a_k, M_b T^T, c), then each sum from its terms, rounded to f32 into s.
__device__ __forceinline__ void pass_sums(const PassLane& pl, const double* __restrict__ mom,
                                          const float* __restrict__ st, double* __restrict__ F,
                                          float* __restrict__ s) {
  const int lane = threadIdx.x;
  auto Tt = [&](int r, int col) -> double {  // the pose, its fourth row (0, 0, 0, 1)
    return r < 3 ? static_cast<double>(st[kT + 4 * r + col]) : (col == 3 ? 1.0 : 0.0);
  };
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = pl.k[q], r = pl.r[q], col = pl.c[q];
    double v = 0.0;
    if (k >= 6) {
      const double* M = mom + 60 + 4 * (k - 6);
#pragma unroll
      for (int a = 0; a < 4; ++a) v += Tt(r, a) * M[a];
    } else if (k >= 0) {
      const double* M = mom + 10 * k;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        double w = 0.0;
#pragma unroll
        for (int b = 0; b < 4; ++b) w += M[kSym4Index[a][b]] * Tt(col, b);
        v += Tt(r, a) * w;
      }
    }
    if (k >= 0) F[lane + 32 * q] = v;
  }
  if (lane == 0) F[kPoseMom - 1] = mom[72];
  __syncwarp();
  if (lane < kSums) {
    double v = 0.0;
#pragma unroll
    for (int t = 0; t < kTerms; ++t) v += pl.coef[t] * F[pl.idx[t]];
    s[lane] = __double2float_rn(v);
  }
}

struct TailArgs {
  const double* row;
  const int* terms;
  const float *T_in, *z, *cov6;
  int n, max_iters;
  float lam0, up, down, step_eps;
  float *state, *moved, *rc;
};

// Every GN pass from the all-reduced row, the same in every block, then
// em_step and n_corr (block 0 writes the state) and moved and rc of the
// block's points at the final pose.
__global__ void __launch_bounds__(kBlock) gn_dist_tail_kernel(const TailArgs d) {
  __shared__ double mom[kMomUsed];
  __shared__ double F[kPoseMom];
  __shared__ float s[kRow];
  __shared__ float st[kState];
  __shared__ float t_in[16];
  const int t = threadIdx.x;
  if (t < kMomUsed) mom[t] = d.row[t];
  if (t < 16) t_in[t] = d.T_in[t];
  if (t < kState)
    st[t] = t < 16 ? d.T_in[t]
                   : t == kCost ? -1.f
                   : t == kStep ? semicp::pos_inf()
                   : t == kLam ? d.lam0 : 0.f;
  __syncthreads();
  GNArgs a{};
  a.lam0 = d.lam0;
  a.up = d.up;
  a.down = d.down;
  const PassLane pl = pass_lane(t & 31, d.terms);
  // uniform over the grid: every block holds the same state
  for (int it = 0; it < d.max_iters && st[kStep] > d.step_eps; ++it) {
    if (t < 32) pass_sums(pl, mom, st, F, s);
    __syncthreads();
    if (t == 0) gn_update(s, st, a);
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    if (t == 0) {
      st[kNCorr] = __double2float_rn(mom[73]);
      st[kEmStep] = em_step(st + kT, t_in);
    }
    __syncthreads();
    if (t < kState) d.state[t] = st[t];
  }
  float T[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) T[j] = st[kT + j];
  const size_t ns = static_cast<size_t>(d.n);
  for (int i = blockIdx.x * kBlock + t; i < d.n; i += gridDim.x * kBlock)
    move_point(T, __ldg(d.z + i), __ldg(d.z + ns + i), __ldg(d.z + 2 * ns + i), d.cov6, i, ns,
               d.moved, d.rc);
}

}  // namespace

// The launch plan of G1 for n points on the current device: out[0] blocks,
// out[1] the points of a block, out[2] dynamic shared memory bytes, out[3]
// 1 if the planes are staged in shared memory. With stage = 0, or when two
// blocks an SM (then one) cannot hold their share, the planes are read
// from L2 in every pass. The grid never exceeds the co-resident blocks.
extern "C" cudaError_t semicp_gn_plan(int n, int stage, int* out) {
  int dev, sms, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, gn_em_kernel<true>);
  const int max_dyn = optin - static_cast<int>(fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_em_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_dyn);
  if (err != cudaSuccess) return err;
  const int want = std::max(1, (n + kBlock - 1) / kBlock);
  for (int per_sm = 2; stage && per_sm >= 1; --per_sm) {
    const int blocks = std::min(want, per_sm * sms);
    const int share = (n + blocks - 1) / blocks;
    const long smem = static_cast<long>(kPlanes) * share * sizeof(float);
    if (smem > max_dyn) continue;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, gn_em_kernel<true>, kBlock,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (nb * sms >= blocks) {
      out[0] = blocks;
      out[1] = share;
      out[2] = static_cast<int>(smem);
      out[3] = 1;
      return cudaSuccess;
    }
  }
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, gn_em_kernel<false>, kBlock, 0);
  if (err != cudaSuccess) return err;
  const int blocks = std::max(1, std::min(want, nb * sms));
  out[0] = blocks;
  out[1] = (n + blocks - 1) / blocks;
  out[2] = 0;
  out[3] = 0;
  return cudaSuccess;
}

// z (3,n), cov6 (6,n), a6 (6,n), b3 (3,n), c (n,), wsum (n,), T_in (4,4) f32,
// all on the device; blocks, share, smem and staged from semicp_gn_plan.
// state (64,) f32: T at [0, 16), H at [16, 52), cost 52, GN step 53,
// lambda 54, passes run 55, em_step 56, n_corr 57. partials (2, blocks,
// 32) f32: scratch. moved (3,n), rc (6,n): outputs. With solve = 0 only
// moved and rc are written (at T_in); a6, b3, c, wsum, state and partials
// are not read. One cooperative launch on `stream`, no host sync.
extern "C" cudaError_t semicp_gn_solve(const float* z, const float* cov6, const float* a6,
                                       const float* b3, const float* c, const float* wsum,
                                       const float* T_in, int n, int blocks, int share, int smem,
                                       int staged, int solve, int max_iters, float lam0,
                                       float lm_up, float lm_down, float step_eps, float* state,
                                       float* partials, float* moved, float* rc,
                                       cudaStream_t stream) {
  GNArgs a{z, cov6, a6, b3, c, wsum, T_in, n, share, solve, max_iters, lam0, lm_up, lm_down,
           step_eps, state, partials, moved, rc};
  void* args[] = {&a};
  const cudaError_t err =
      staged && solve
          ? cudaLaunchCooperativeKernel(gn_em_kernel<true>, dim3(blocks), dim3(kBlock), args,
                                        static_cast<size_t>(smem), stream)
          : cudaLaunchCooperativeKernel(gn_em_kernel<false>, dim3(blocks), dim3(kBlock), args,
                                        0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// G1d's launch plan for n points on the current device: out[0] blocks of
// the moments kernel (no more than can be co-resident: a grid barrier),
// out[1] its points a block, out[2] blocks of the tail kernel (one wave).
extern "C" cudaError_t semicp_gn_dist_plan(int n, int* out) {
  int dev, sms, nb_m = 0, nb_t = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb_m, gn_moments_kernel, kBlock, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb_t, gn_dist_tail_kernel, kBlock, 0);
  if (err != cudaSuccess) return err;
  const int want = std::max(1, (n + kBlock - 1) / kBlock);
  const int blocks = std::max(1, std::min(want, nb_m * sms));
  out[0] = blocks;
  out[1] = (n + blocks - 1) / blocks;
  out[2] = std::max(1, std::min(want, nb_t * sms));
  return cudaSuccess;
}

// This rank's moment row. z (3,n), a6 (6,n), b3 (3,n), c (n,), wsum (n,)
// f32 on the device; blocks and share from semicp_gn_dist_plan; partials
// (blocks, 80) f64 scratch; row (80,) f64 out: [10 k + s] sum a_k zt_m
// zt_l (zt = (z, 1), (m, l) = kSym4[s]), [60 + 4 j + m] sum b_j zt_m,
// [72] sum c, [73] sum wsum, zeros after. One cooperative launch on
// `stream`.
extern "C" cudaError_t semicp_gn_dist_moments(const float* z, const float* a6, const float* b3,
                                              const float* c, const float* wsum, int n,
                                              int blocks, int share, double* partials,
                                              double* row, cudaStream_t stream) {
  MomArgs m{z, a6, b3, c, wsum, n, share, partials, row};
  void* args[] = {&m};
  const cudaError_t err = cudaLaunchCooperativeKernel(gn_moments_kernel, dim3(blocks),
                                                      dim3(kBlock), args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The M-step from the all-reduced row (80,) f64 and the end of the EM
// pass: state (64,) as semicp_gn_solve's (T, H, cost, step, lambda,
// passes run, em_step against T_in, n_corr = row[73]); moved (3,n) and rc
// (6,n) of z (3,n) and cov6 (6,n) at the final T. terms (2, 28, 10) int32
// on the device: the term table of each GN pass's 28 sums (gauss_newton.py
// `_term_table`). T_in (4,4) must not lie in state. blocks from
// semicp_gn_dist_plan. One launch on `stream`.
extern "C" cudaError_t semicp_gn_dist_tail(const double* row, const int* terms, const float* T_in,
                                           const float* z, const float* cov6, int n, int blocks,
                                           int max_iters, float lm_lambda0, float lm_up,
                                           float lm_down, float step_eps, float* state,
                                           float* moved, float* rc, cudaStream_t stream) {
  TailArgs d{row,        terms, T_in,    z,        cov6,  n,     max_iters,
             lm_lambda0, lm_up, lm_down, step_eps, state, moved, rc};
  gn_dist_tail_kernel<<<blocks, kBlock, 0, stream>>>(d);
  return cudaGetLastError();
}
