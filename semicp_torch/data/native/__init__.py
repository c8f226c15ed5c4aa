"""ctypes bindings for the native C++ scan loader (loader.cpp).

Port of `semicp/data/native/__init__.py`. On first use the library is
compiled with g++ into `semicp_torch/_build/` (named by a hash of the
source and flags, so an edited source rebuilds), not beside the source.
When g++ is missing or the build fails, `native_available()` is false
and callers take the numpy loaders of `semicp_torch.data.kitti`. Host
code only: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "loader.cpp"
_BUILD = Path(__file__).parents[2] / "_build"
# no -march=native: a library left in _build/ may be loaded on another host
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> Path | None:
    """Compile loader.cpp unless built already; None when g++ fails."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libsemicp_loader-{h}.so"
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _load():
    """The loaded library, built on first use; None if it cannot be."""
    global _lib, _tried
    with _lock:          # the prefetch thread and the main thread may race here
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.semicp_bin_count.restype = ctypes.c_long
        lib.semicp_bin_count.argtypes = [ctypes.c_char_p]
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.semicp_load_bin_planar.restype = ctypes.c_long
        lib.semicp_load_bin_planar.argtypes = [ctypes.c_char_p, fp, fp, fp, fp, ctypes.c_long]
        lib.semicp_load_labels.restype = ctypes.c_long
        lib.semicp_load_labels.argtypes = [ctypes.c_char_p, ip, ip, ctypes.c_long]
        lib.semicp_voxel_downsample.restype = ctypes.c_long
        lib.semicp_voxel_downsample.argtypes = [fp, fp, fp, ip, ctypes.c_long,
                                                ctypes.c_float, fp, fp, fp, ip]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def load_bin_planar(path) -> tuple[np.ndarray, np.ndarray]:
    """Native .bin parse -> (xyz (3,N) float32 planar, intensity (N,))."""
    lib = _load()
    n = lib.semicp_bin_count(str(path).encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    xs, ys, zs, it = (np.empty(n, np.float32) for _ in range(4))
    got = lib.semicp_load_bin_planar(str(path).encode(), xs, ys, zs, it, n)
    if got != n:
        raise IOError(f"short read on {path}: {got}/{n}")
    return np.stack([xs, ys, zs]), it


def load_labels_remapped(path, lut: np.ndarray, n_expect: int) -> np.ndarray:
    """Native .label parse, remapped through `lut` (65536 entries)."""
    lib = _load()
    out = np.empty(n_expect, np.int32)
    got = lib.semicp_load_labels(str(path).encode(),
                                 np.ascontiguousarray(lut, np.int32), out, n_expect)
    if got < 0:
        raise IOError(f"cannot read {path}")
    return out[:got]


def voxel_downsample_planar(xyz3n: np.ndarray, labels: np.ndarray, voxel: float):
    """Native voxel downsample on planar (3,N) input; returns planar output."""
    lib = _load()
    n = xyz3n.shape[1]
    xs, ys, zs = (np.ascontiguousarray(xyz3n[i], np.float32) for i in range(3))
    lab = np.ascontiguousarray(labels, np.int32)
    oxs, oys, ozs = (np.empty(n, np.float32) for _ in range(3))
    olab = np.empty(n, np.int32)
    m = lib.semicp_voxel_downsample(xs, ys, zs, lab, n, voxel, oxs, oys, ozs, olab)
    if m < 0:
        raise ValueError("voxel must be > 0")
    return np.stack([oxs[:m], oys[:m], ozs[:m]]), olab[:m]
