// Gauss-Newton / LM M-step over SE(3) on the collapsed planes (kernel G1).
//
// No Pallas kernel of the JAX package corresponds: `gn_solve`
// (semicp/register/gauss_newton.py:37) is a `lax.while_loop` inside the one
// XLA program of the EM loop, and XLA fuses its body (the normal-equation
// reduction, the 6x6 solve, se3_exp and the LM schedule) into a few device
// kernels. Dispatched op by op from the host, that body is about 175 torch
// launches a pass. G1 is the body as one launch a pass.
//
// Contract (register/gauss_newton.py `gn_solve_plain`): from T = T0,
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
// update.
//
// Bound on the H100: one read of the 13 input planes (52 B a point; 6.8 MB
// at N = 131072, which stays in L2 from pass to pass) and about 130 flops a
// point for each pass that runs: a few microseconds an EM pass. The cost
// that matters is latency, so the design keeps every pass on the device:
//
// - `gn_init_kernel` writes the state (T, lambda, cost, step, H, passes)
//   and clears the ticket; then `gn_pass_kernel` is launched max_iters
//   times with no host sync. A pass whose step is not above step_eps
//   returns at once, as the masked loop of the plain version freezes.
// - Sum stage (`point_sums`): each block covers its points grid-stride
//   and forms the 28 terms of a point in registers, in residuals.py's
//   order of operations rounded step by step (no FMA contraction), so a
//   point's terms equal the plain version's to the bit. Warp shuffles,
//   then shared memory, leave one partial of 28 floats a block.
// - The last block to finish (a fence and an atomic ticket that it
//   resets) adds the partials in block order: no float atomics, so two
//   runs give the same bits. Update stage (`gn_update`): one thread
//   assembles H and g, damps, solves, applies se3_exp and the LM schedule
//   and writes the state. A distributed solve would add its all-reduce of
//   the 28 sums between the two stages.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kSums = 28;  // A (6), B (9), C (6), u (3), u x p (3), cost
// the state, f32: T (4,4) row-major, H (6,6), cost, step, lambda, passes run
constexpr int kT = 0, kH = 16, kCost = 52, kStep = 53, kLam = 54, kPasses = 55, kState = 64;

struct GNParams {
  float lam0, up, down, step_eps;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// One point's 28 terms (residuals.py `_system_terms` and the cost of
// `normal_equations_collapsed`) at p = T z, T the top three rows of the pose.
__device__ __forceinline__ void point_terms(const float (&T)[12], float zx, float zy, float zz,
                                            const float (&a)[6], float bx, float by, float bz,
                                            float c, float (&s)[kSums]) {
  const float px = add(add(add(mul(T[0], zx), mul(T[1], zy)), mul(T[2], zz)), T[3]);
  const float py = add(add(add(mul(T[4], zx), mul(T[5], zy)), mul(T[6], zz)), T[7]);
  const float pz = add(add(add(mul(T[8], zx), mul(T[9], zy)), mul(T[10], zz)), T[11]);
  const float a00 = a[0], a11 = a[1], a22 = a[2], a01 = a[3], a02 = a[4], a12 = a[5];
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

// Sum stage: this block's partial of the 28 sums over its points, written
// to partials[blockIdx.x * 28 + j]. sh: kWarps x 28 floats of shared memory.
__device__ __forceinline__ void point_sums(const float* __restrict__ z,
                                           const float* __restrict__ a6,
                                           const float* __restrict__ b3,
                                           const float* __restrict__ c, int n,
                                           const float (&T)[12], float (*sh)[kSums],
                                           float* __restrict__ partials) {
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {
    float a[6], s[kSums];
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] = __ldg(a6 + static_cast<size_t>(j) * n + i);
    point_terms(T, __ldg(z + i), __ldg(z + n + i), __ldg(z + 2 * static_cast<size_t>(n) + i), a,
                __ldg(b3 + i), __ldg(b3 + n + i), __ldg(b3 + 2 * static_cast<size_t>(n) + i),
                __ldg(c + i), s);
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j] = add(acc[j], s[j]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] = add(acc[j], __shfl_xor_sync(semicp::kFull, acc[j], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) sh[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = sh[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = add(v, sh[w][threadIdx.x]);
    partials[blockIdx.x * kSums + threadIdx.x] = v;
    __threadfence();
  }
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

// Update stage: one thread, from the 28 sums of a pass at the state's pose.
__device__ void gn_update(const float* __restrict__ s, float* __restrict__ state,
                          const GNParams& prm) {
  const int kIndex[6][6] = {{0, 3, 4, 6, 7, 8},      {3, 1, 5, 9, 10, 11},
                                {4, 5, 2, 12, 13, 14},   {6, 9, 12, 15, 16, 17},
                                {7, 10, 13, 16, 18, 19}, {8, 11, 14, 17, 19, 20}};
  float H[6][6], M[6][6], r[6], delta[6];
  const float lam = state[kLam];
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
  for (int j = 0; j < 16; ++j) T[j] = state[kT + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      state[kT + 4 * i + j] =
          add(add(add(mul(E[i][0], T[j]), mul(E[i][1], T[4 + j])), mul(E[i][2], T[8 + j])),
              mul(E[i][3], T[12 + j]));
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) state[kH + 6 * i + j] = H[i][j];
  const float cost = s[27], prev = state[kCost];
  const bool worse = prev >= 0.f && cost > prev;
  state[kLam] = worse ? mul(lam, prm.up) : fmaxf(mul(lam, prm.down), prm.lam0);
  state[kCost] = cost;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) ss = add(ss, mul(delta[i], delta[i]));
  state[kStep] = sqrtf(ss);
  state[kPasses] = add(state[kPasses], 1.f);
}

__global__ void gn_init_kernel(const float* __restrict__ T0, float lam0,
                               float* __restrict__ state, unsigned* __restrict__ ticket) {
  const int t = threadIdx.x;
  float v = 0.f;
  if (t < 16) v = T0[t];
  else if (t == kCost) v = -1.f;
  else if (t == kStep) v = semicp::pos_inf();
  else if (t == kLam) v = lam0;
  state[t] = v;
  if (t == 0) *ticket = 0u;
}

__global__ void __launch_bounds__(kBlock, 2)
gn_pass_kernel(const float* __restrict__ z, const float* __restrict__ a6,
               const float* __restrict__ b3, const float* __restrict__ c, int n, GNParams prm,
               float* __restrict__ state, float* __restrict__ partials,
               unsigned* __restrict__ ticket) {
  __shared__ float sh[kWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ bool last;
  // the loop has exited: every block reads the same state, so the whole
  // grid returns
  if (!(__ldcg(state + kStep) > prm.step_eps)) return;
  float T[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) T[j] = __ldcg(state + kT + j);
  point_sums(z, a6, b3, c, n, T, sh, partials);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials in block order: thread (g, j) adds blocks g, g + 8, ...
  // of sum j, then sum j adds the eight in order
  const int j = threadIdx.x & 31, g = threadIdx.x >> 5;
  if (j < kSums) {
    float v = 0.f;
    for (int b = g; b < static_cast<int>(gridDim.x); b += kWarps)
      v = add(v, __ldcg(partials + b * kSums + j));
    sh[g][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = sh[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = add(v, sh[w][threadIdx.x]);
    sums[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *ticket = 0u;
    gn_update(sums, state, prm);
  }
}

}  // namespace

// z (3,n), a6 (6,n), b3 (3,n), c (n,) f32; T0 (4,4) f32, all on the device.
// state (64,) f32: T at [0, 16), H at [16, 52), cost 52, step 53, lambda 54,
// passes run 55. partials (blocks, 28) f32 and ticket (1,) u32: scratch.
// Launches the set-up and max_iters passes on `stream`, no host sync.
extern "C" cudaError_t semicp_gn_solve(const float* z, const float* a6, const float* b3,
                                       const float* c, const float* T0, int n, int blocks,
                                       int max_iters, float lam0, float lm_up, float lm_down,
                                       float step_eps, float* state, float* partials,
                                       unsigned* ticket, cudaStream_t stream) {
  gn_init_kernel<<<1, kState, 0, stream>>>(T0, lam0, state, ticket);
  cudaError_t err = cudaGetLastError();
  const GNParams prm{lam0, lm_up, lm_down, step_eps};
  for (int it = 0; it < max_iters && err == cudaSuccess; ++it) {
    gn_pass_kernel<<<blocks, kBlock, 0, stream>>>(z, a6, b3, c, n, prm, state, partials, ticket);
    err = cudaGetLastError();
  }
  return err;
}
