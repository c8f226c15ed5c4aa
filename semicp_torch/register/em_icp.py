"""EM semantic registration — the port's `align()` entry point.

Port of `semicp/register/em_icp.py` (the pairwise path). Each EM pass:

  E-step: per-class nearest neighbour of every moved source point
          (kernel K2 over gate-pruned target tiles, corr/nn_sparse.py,
          or K4 over a class-sorted target for small clouds,
          corr/nn_dense.py), then the weight softmax collapsed over the
          classes into per-point GN planes (kernel K3, register/estep.py);
          at map scale both in one kernel (K6, register/fused.py)
  M-step: frozen-correspondence Gauss-Newton/LM, then the convergence
          measure ||log(T_new T_old^-1)||, the correspondence count and
          the next E-step's moved source and rotated covariances
          (gauss_newton.py `em_tail`; on CUDA kernel G1, one launch)
  check:  ||log(T_new T_old^-1)|| < trans_eps

The JAX `while_loop` becomes a host loop whose only device sync is the
convergence flag, read once per EM pass. The host's waits on the device,
that read and the result's copy (`_to_host`), are the span `em.wait`; a
health check's re-solve counts one `align.retry`, each E-step one
`estep`, and each that ran K6's branch one `estep.fused` (0 on every other
branch, so that the counter is always present). Everything else is queued
without waiting on the device: G1 keeps the pose and loop state on the
device, and the host never reads them. On CUDA an EM pass is the E-step's
kernels (K2 or K4, then K3; or K6), G1 and the flag.

Engines, as in the JAX package: "sparse" (K2), "dense" (K4) and the
plain "xla". On CUDA "auto" resolves to "sparse" at n_pad >=
corr.sparse_min_n and to "dense" below it; on a CPU it resolves to
"xla", and the kernel wrappers of a forced engine run their plain
versions. The sparse engine runs the fused E-step (K6) where
`use_fused_estep` says so, on every device. "xla" is for CPU tensors.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.config import Config
from semicp_torch.corr.layout import LAYOUT_CM, sort_cloud_cm
from semicp_torch.corr.nn_dense import class_nn_attrs_dense, sort_cloud_by_class
from semicp_torch.corr.nn_sparse import (
    class_nn_attrs_plain,
    class_nn_attrs_sparse,
    prepare_sparse,
)
from semicp_torch.register.estep import estep_reduce
from semicp_torch.register.fused import estep_sparse_fused
from semicp_torch.register.gauss_newton import em_tail, move_source, tail_outputs
from semicp_torch.utils.metrics import count, elapsed

ENGINES = ("auto", "dense", "sparse", "xla")


@dataclass(frozen=True)
class AlignResult:
    T: torch.Tensor            # (4,4) source->target transform
    iterations: torch.Tensor   # () int32 outer EM iterations executed
    converged: torch.Tensor    # () bool
    cost: torch.Tensor         # () float32 final weighted Mahalanobis cost
    n_corr: torch.Tensor       # () float32 effective correspondence count
    H: torch.Tensor            # (6,6) GN Hessian at the final pose


def use_fused_estep(cfg: Config, q_pad: int) -> bool:
    """The JAX package's fused E-step dispatch rule (sparse engine only)."""
    return bool(cfg.em.fused_estep) or q_pad >= cfg.em.fused_auto_min_q


def resolve_engine(cfg: Config, device) -> str:
    """Correspondence engine for clouds on `device` (see module docstring)."""
    eng = cfg.corr.engine
    if eng not in ENGINES:
        raise ValueError(f"corr.engine={eng!r}: expected one of {ENGINES}")
    cuda = torch.device(device).type == "cuda"
    if eng == "auto":
        if not cuda:
            return "xla"
        return "sparse" if cfg.cloud.n_pad >= cfg.corr.sparse_min_n else "dense"
    if eng == "xla" and cuda:
        raise NotImplementedError(
            "corr.engine='xla' is the plain dense path, for CPU tensors only; on CUDA "
            "use 'dense' (kernel K4) or 'auto'")
    return eng


def _prepare_target(tgt: Cloud, cfg: Config, engine: str):
    """Loop-invariant target preparation (once per align)."""
    K = cfg.cloud.num_classes
    if engine == "sparse":
        return "sparse", prepare_sparse(tgt, K, cfg.corr.cell)
    if engine == "dense":
        xyz_s, label_s, attrs16, seg = sort_cloud_by_class(tgt.xyz, tgt.label, tgt.cov6,
                                                           tgt.valid, K)
        return "sorted", {"xyz_s": xyz_s, "label_s": label_s, "attrs16": attrs16, "seg": seg}
    return "cloud", tgt


def _estep(tgt_prep, src: Cloud, log_sem, moved, rc, cfg: Config, gate, gate2):
    """Per-class NN + weight/class reduction for all source points, moved
    to the current pose: moved (3,N) and their rotated covariances rc
    (6,N), as `move_source` or the last EM pass's G1 left them.

    Returns (a6 (6,N), b3 (3,N), c (N), wsum (N)).
    """
    K = cfg.cloud.num_classes
    kind, prep = tgt_prep
    fused = kind == "sparse" and use_fused_estep(cfg, src.n_pad)
    count("estep")
    count("estep.fused", int(fused))
    if fused:
        # one kernel: no (K, 16, N) intermediate in device memory
        return estep_sparse_fused(prep, moved, src.valid, rc, log_sem, K, gate)
    if kind == "sparse":
        nn_d2, attrs = class_nn_attrs_sparse(prep, moved, src.valid, K, gate)
    elif kind == "sorted":
        nn_d2, attrs = class_nn_attrs_dense(prep["xyz_s"], prep["label_s"], prep["attrs16"],
                                            prep["seg"], moved, K)
    else:
        nn_d2, attrs = class_nn_attrs_plain(prep.xyz, prep.label, prep.valid,
                                            prep.cov6, moved, K)
    return estep_reduce(nn_d2, attrs, rc, moved, log_sem, src.valid, gate2)


def _log_sem(src: Cloud, cfg: Config):
    """Loop-invariant (K, N) semantic log-prior (confusion-matrix model)."""
    K = cfg.cloud.num_classes
    if cfg.em.uniform_semantics:
        return torch.zeros((K, src.n_pad), dtype=torch.float32, device=src.device)
    classes = torch.arange(K, dtype=torch.int32, device=src.device)[:, None]
    match = src.label[None, :] == classes
    hit = math.log(cfg.em.alpha)
    miss = math.log((1.0 - cfg.em.alpha) / max(K - 1, 1))
    return torch.where(match, hit, miss).to(torch.float32)


def _align(src: Cloud, tgt: Cloud, T0, gate: float, max_iters: int, cfg: Config,
           engine: str) -> AlignResult:
    dev = src.device
    if engine == "sparse" and src.layout != LAYOUT_CM:
        # canonical sort once, so query tiles cover compact regions
        src = sort_cloud_cm(src, cfg.cloud.num_classes, cfg.corr.cell)
    tgt_prep = _prepare_target(tgt, cfg, engine)
    log_sem = _log_sem(src, cfg)
    # scalars are filled in on the device: a host copy would block
    gate_t = torch.full((), gate, dtype=torch.float32, device=dev)
    gate2 = gate_t * gate_t

    T = T0
    it = 0
    step = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.float32, device=dev)
    H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    # G1's outputs, kept for the align (two states, alternating by pass)
    out = tail_outputs(src.n_pad, dev, 2) if src.xyz.is_cuda else [None, None]
    moved, rc = move_source(T, src.xyz, src.cov6, out[0])
    while it < max_iters:
        a6, b3, c, wsum = _estep(tgt_prep, src, log_sem, moved, rc, cfg, gate_t, gate2)
        T, cost, _, H, step, n_corr, moved, rc = em_tail(T, src.xyz, src.cov6, a6, b3, c,
                                                         wsum, cfg.gn, out[it % 2])
        it += 1
        t0 = time.perf_counter()
        go_on = bool(step > cfg.em.trans_eps)   # the one sync per EM pass
        elapsed("em.wait", t0)
        if not go_on:
            break
    return AlignResult(
        T=T,
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        converged=step <= cfg.em.trans_eps,
        cost=cost,
        n_corr=n_corr,
        H=H,
    )


def make_align_fn(cfg: Config):
    """Return align(src, tgt, T0=None, gate=None, max_iters=None) -> AlignResult.

    `gate` and `max_iters` override cfg.corr.max_dist and cfg.em.max_iters
    per call. Clouds must be preprocessed (preprocess_cloud) and on one
    device; the result lives there too.
    """

    def fn(src: Cloud, tgt: Cloud, T0=None, gate=None, max_iters=None) -> AlignResult:
        dev = src.device
        if tgt.device != dev:
            raise ValueError(f"source on {dev} but target on {tgt.device}")
        engine = resolve_engine(cfg, dev)
        if T0 is None:
            T0 = torch.eye(4, dtype=torch.float32, device=dev)
        T0 = torch.as_tensor(T0, dtype=torch.float32, device=dev).contiguous()
        g = float(cfg.corr.max_dist if gate is None else gate)
        mi = int(cfg.em.max_iters if max_iters is None else max_iters)
        return _align(src, tgt, T0, g, mi, cfg, engine)

    return fn


def _to_host(res: AlignResult, src: Cloud, tgt: Cloud):
    """The whole result, and min(|src|, |tgt|), in one device-to-host copy.

    Returns (host AlignResult, n_expect); every field equals the device
    one to the bit (the iteration count is a small integer, exact in f32).
    """
    n_expect = torch.minimum(src.count, tgt.count).to(torch.float32)
    flat = torch.cat([res.T.reshape(16), res.H.reshape(36), torch.stack([
        res.iterations.to(torch.float32), res.converged.to(torch.float32),
        res.cost, res.n_corr, n_expect])])
    t0 = time.perf_counter()
    flat = flat.cpu()
    elapsed("em.wait", t0)
    host = AlignResult(T=flat[:16].reshape(4, 4), iterations=flat[52].to(torch.int32),
                       converged=flat[53] > 0.5, cost=flat[54], n_corr=flat[55],
                       H=flat[16:52].reshape(6, 6))
    return host, float(flat[56])


def _healthy(host: AlignResult, n_expect: float, frac: float) -> bool:
    return bool(host.converged) and float(host.n_corr) >= frac * n_expect


def make_robust_align_fn(cfg: Config):
    """align fn with a host-side recovery retry (run_slam's).

    A constant-velocity warm start occasionally lands EM in a wrong local
    minimum, which keeps far fewer gated correspondences than the clouds'
    overlap supports. If the warm-started solve does not converge or its
    correspondence count drops below `em.retry_overlap_frac` of
    min(|src|, |tgt|), re-solve from identity and keep whichever solution
    retains more correspondences. The result is the host copy that
    carries the health check (`_to_host`): one device-to-host copy per
    solve, and a retry costs one more solve.
    """
    base = make_align_fn(cfg)
    frac = cfg.em.retry_overlap_frac

    def fn(src: Cloud, tgt: Cloud, T0=None, gate=None, max_iters=None) -> AlignResult:
        host, n_expect = _to_host(base(src, tgt, T0, gate=gate, max_iters=max_iters), src, tgt)
        if frac <= 0.0 or T0 is None or _healthy(host, n_expect, frac):
            return host
        count("align.retry")
        host2 = _to_host(base(src, tgt, None, gate=gate, max_iters=max_iters), src, tgt)[0]
        return host2 if float(host2.n_corr) > float(host.n_corr) else host

    return fn


class PipelinedAligner:
    """Odometry aligner with a deferred health check.

    The warm start chains on the device: submit(t+1) passes align(t)'s
    result pose, never read by the host, as T0. Frame t's result is
    fetched only after align(t+1) has been queued, in one device-to-host
    copy that carries its health check and its whole record; the resolved
    result returned is that host copy.

    Retry semantics on an unhealthy frame match make_robust_align_fn
    (re-solve from identity, keep the solution with more gated
    correspondences). The next frame's align has already consumed the
    pre-retry warm start by design; if that basin was bad, its own
    health check catches it one frame late. On healthy sequences the
    resolved trajectory is bit-identical to the serial robust chain.

    Usage: `resolved = submit(src, tgt)` returns the PREVIOUS pair's
    resolved AlignResult (None for the first); `flush()` resolves the
    final in-flight pair.
    """

    def __init__(self, cfg: Config):
        self._base = make_align_fn(cfg)
        self._frac = cfg.em.retry_overlap_frac
        self._pending = None          # (src, tgt, T0, res) awaiting health
        self._warm = None             # device-side warm-start pose chain

    def submit(self, src: Cloud, tgt: Cloud):
        T0 = self._warm
        res = self._base(src, tgt, T0)
        self._warm = res.T            # stays on the device
        prev, self._pending = self._pending, (src, tgt, T0, res)
        return self._resolve(*prev) if prev is not None else None

    def flush(self):
        if self._pending is None:
            return None
        prev, self._pending = self._pending, None
        return self._resolve(*prev)

    def _resolve(self, src, tgt, T0, res) -> AlignResult:
        host, n_expect = _to_host(res, src, tgt)
        if self._frac <= 0.0 or T0 is None or _healthy(host, n_expect, self._frac):
            return host
        count("align.retry")
        host2 = _to_host(self._base(src, tgt, None), src, tgt)[0]
        return host2 if float(host2.n_corr) > float(host.n_corr) else host


def align(src: Cloud, tgt: Cloud, cfg: Config | None = None, T_init=None) -> AlignResult:
    """Align source onto target: returns T with x_tgt ~= T @ x_src.

    Convenience wrapper; reuse `make_align_fn` in loops.
    """
    return make_align_fn(cfg or Config())(src, tgt, T_init)
