"""E-step weights and class reduction: the plain version and kernel K3.

Port of `semicp/register/pallas_estep.py`. For each source point, a
softmax over the K per-class nearest neighbours of

    log N(x_k - p; 0, C_k + R C_z R^T) + log_sem_k

gated by the exact |x_k - p|^2 <= gate^2, a found neighbour and a valid
point, reduced over the classes into the planes the M-step needs:
A = sum_k w Sigma^-1 (6), b = sum_k w Sigma^-1 x (3), c = sum_k w
x^T Sigma^-1 x, and wsum.

* `estep_reduce_plain` is the JAX package's `estep_reduce_xla` with
  `estep_weights_xla`: explicit (K, N) weights, then reductions. It is
  the CPU path and K3's reference.
* `estep_reduce` launches K3 (csrc/estep.cu) on a CUDA tensor: one pass,
  an online softmax over K in registers.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.geom import sym3
from semicp_torch.register.residuals import gaussian_loglik_planar

NEG = -3.0e37
INF = 3.0e37


def estep_weights_plain(sigma, d, log_sem, mask):
    """Un-reduced (K, N) weights and Sigma^-1 planes (6, K, N)."""
    sig_t = tuple(sigma[i] for i in range(6))
    loglik = gaussian_loglik_planar(sig_t, tuple(d[i] for i in range(3))) + log_sem
    loglik = torch.where(mask, loglik, torch.full_like(loglik, NEG))
    safe_mx = torch.clamp(torch.amax(loglik, dim=0, keepdim=True), min=NEG * 0.5)
    unnorm = torch.where(mask, torch.exp(loglik - safe_mx), torch.zeros_like(loglik))
    tot = torch.sum(unnorm, dim=0, keepdim=True)
    w = torch.where(tot > 0.0, unnorm / torch.clamp(tot, min=1e-30), torch.zeros_like(unnorm))
    return w, torch.stack(sym3.inv(sig_t), 0)


def estep_reduce_plain(nn_d2, attrs, rc6, moved, log_sem, valid, gate2):
    """Reduce contract with explicit (K, N) weights.

    nn_d2 (K,N), attrs (K,16,N), rc6 (6,N) rotated source covariance,
    moved (3,N), log_sem (K,N), valid (N,) bool, gate2 float or 0-dim.
    Returns (a6 (6,N), b3 (3,N), c (N,), wsum (N,)).
    """
    x = attrs[:, 0:3].movedim(1, 0)                              # (3,K,N)
    sigma = attrs[:, 3:9].movedim(1, 0) + rc6[:, None, :]        # (6,K,N)
    d = x - moved[:, None, :]
    exact_d2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    gate = (exact_d2 <= gate2) & (nn_d2 < INF) & valid[None, :]
    w, sinv = estep_weights_plain(sigma, d, log_sem, gate)
    a6 = torch.einsum("kn,skn->sn", w, sinv)
    t = torch.stack([
        sinv[0] * x[0] + sinv[3] * x[1] + sinv[4] * x[2],
        sinv[3] * x[0] + sinv[1] * x[1] + sinv[5] * x[2],
        sinv[4] * x[0] + sinv[5] * x[1] + sinv[2] * x[2],
    ])                                                           # (3,K,N)
    b3 = torch.einsum("kn,skn->sn", w, t)
    c = torch.einsum("kn,kn->n", w, x[0] * t[0] + x[1] * t[1] + x[2] * t[2])
    return a6, b3, c, torch.sum(w, dim=0)


def estep_reduce(nn_d2, attrs, rc6, moved, log_sem, valid, gate2):
    """The reduce contract: `estep_reduce_plain` on a CPU tensor, K3 on CUDA."""
    if not nn_d2.is_cuda:
        return estep_reduce_plain(nn_d2, attrs, rc6, moved, log_sem, valid, gate2)
    K, n = nn_d2.shape
    dev = nn_d2.device
    args = {"nn_d2": (nn_d2, torch.float32, (K, n)),
            "attrs": (attrs, torch.float32, (K, 16, n)),
            "rc6": (rc6, torch.float32, (6, n)),
            "moved": (moved, torch.float32, (3, n)),
            "log_sem": (log_sem, torch.float32, (K, n)),
            "valid": (valid, torch.bool, (n,))}
    for name, (t, dtype, shape) in args.items():
        kernels.check(t, name, dtype, shape)
    g2 = kernels.device_scalar(gate2, torch.float32, dev)
    a6 = torch.empty((6, n), dtype=torch.float32, device=dev)
    b3 = torch.empty((3, n), dtype=torch.float32, device=dev)
    c = torch.empty((n,), dtype=torch.float32, device=dev)
    wsum = torch.empty((n,), dtype=torch.float32, device=dev)
    kernels.launch("semicp_estep_reduce", "estep_reduce", dev,
                   nn_d2.data_ptr(), attrs.data_ptr(), rc6.data_ptr(), moved.data_ptr(),
                   log_sem.data_ptr(), valid.data_ptr(), g2.data_ptr(), K, n,
                   a6.data_ptr(), b3.data_ptr(), c.data_ptr(), wsum.data_ptr())
    return a6, b3, c, wsum
