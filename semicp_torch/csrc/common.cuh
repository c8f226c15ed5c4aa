// Shared constants of the semicp_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace semicp {

// "no neighbour" distance and the masked log-likelihood, as in the JAX
// package (corr/pallas_nn2.py INF, register/pallas_estep.py NEG/INF)
constexpr float kInf = 3.0e37f;
constexpr float kNeg = -3.0e37f;

// query tile: one block of kQB threads, one thread per query point
constexpr int kQB = 256;

}  // namespace semicp
