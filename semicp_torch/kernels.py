"""Build, load and count the package's hand-written CUDA kernels.

The sources in `csrc/` have a plain C interface. At first use each is
compiled by its own `nvcc` process, all started together, and the objects
are linked into one shared library under `_build/` (named by a hash of
the sources and flags, so an edited source rebuilds), bound with ctypes.
Nothing here runs at import: the CPU tests import every module on a
machine with no `nvcc`.

Every kernel wrapper checks its arguments, launches on PyTorch's current
stream, raises if the launch reports an error, and adds one to its entry
in `LAUNCHES` — there and nowhere else — so a run can show that the main
path went through the kernels. An auxiliary pass of a kernel (the moments'
cost count) launches with no counter. The data-dependent kernels leave a
device tensor in `WALKED`: the walks (K1, K2, K5, K6) the chunks they
walked, each chunk being 32 x 32 query-target pairs, and G1 its state, whose
element 55 counts the GN passes that ran (G1's distributed mode too, whose
counter `gn_dist` counts an M-step: its two launches, the moments and the
tail, and the all-reduce between them); reading one syncs, so only a
measurement does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"moments_sparse": 0, "nn_sparse": 0, "estep_reduce": 0,
            "moments_dense": 0, "nn_dense": 0, "estep_fused": 0, "gn_solve": 0,
            "gn_dist": 0}
WALKED: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # xyz, label, valid, radius, n, num_classes, pts4, chunk_box, tile_box, span,
    # first_last, count, stream
    "semicp_moments_cost": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # pts4, chunk_box, tile_box, span, order, radius, n, num_classes, counter, out, stream
    "semicp_moments_sparse": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    # pts4, label_s, attrs16, tile_box, chunk_box, q_xyz, q_valid, gate, n, q, tb,
    # num_classes, keys, items, wbox, counters, out_d2, out_attr, stream
    "semicp_nn_sparse": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P),
    # nn_d2, attrs, rc6, moved, log_sem, valid, gate2, num_classes, n, a6, b3, c, wsum, stream
    "semicp_estep_reduce": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    # xyz, label, valid, cell, n, num_buckets, lo, key, stream
    "semicp_moments_raw_key": (_P, _P, _P, _P, _I, _I, _P, _P, _P),
    # xyz, label, valid, perm, radius, n, n_raw, num_buckets, pts4, chunk_box, tile_box,
    # span, first_last, count, stream
    "semicp_moments_raw_cost": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # pts4, chunk_box, tile_box, span, order, perm, radius, n, n_raw, num_buckets, counter,
    # out, stream
    "semicp_moments_raw": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # xyz_s, seg, attrs16, q_xyz, n, q, num_classes, out_d2, out_attr, stream
    "semicp_nn_dense": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # pts4, label_s, attrs16, tile_box, chunk_box, q_xyz, q_valid, rc6, log_sem, gate, n,
    # q, tb, num_classes, keys, items, wbox, counters, a6, b3, c, wsum, stream
    "semicp_estep_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P),
    # n, stage, out (4,) int32: blocks, share, smem, staged
    "semicp_gn_plan": (_I, _I, ctypes.POINTER(ctypes.c_int)),
    # z, cov6, a6, b3, c, wsum, T_in, n, blocks, share, smem, staged, solve, max_iters,
    # lm_lambda0, lm_up, lm_down, step_eps, state, partials, moved, rc, stream
    "semicp_gn_solve": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                        _F, _P, _P, _P, _P, _P),
    # n, out (3,) int32: moments blocks, share, tail blocks
    "semicp_gn_dist_plan": (_I, ctypes.POINTER(ctypes.c_int)),
    # z, a6, b3, c, wsum, n, blocks, share, partials, row, stream
    "semicp_gn_dist_moments": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # row, terms, T_in, z, cov6, n, blocks, max_iters, lm_lambda0, lm_up, lm_down, step_eps,
    # state, moved, rc, stream
    "semicp_gn_dist_tail": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P),
}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless it is built already."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD / f"libsemicp_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    # one compiler per source, all at once: the build is as long as the
    # slowest source, not the sum
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    errors = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{out}")
    if not errors:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, counter: str | None, device: torch.device, *args) -> None:
    """Call C entry `name` on `device`'s current stream; raise on a launch
    error. Counts one launch of `counter` unless it is None."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    if counter is not None:
        LAUNCHES[counter] += 1


def device_scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x as a (1,) tensor on `device`. A Python number is filled in on the
    device: `torch.tensor(x, device=cuda)` would be a blocking host copy
    that waits for every queued kernel."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).reshape(1)
    return torch.full((1,), float(x), dtype=dtype, device=device)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate one kernel argument: CUDA, dtype, shape and contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
