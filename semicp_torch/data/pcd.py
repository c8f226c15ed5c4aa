"""PCD (Point Cloud Data) file I/O — labeled-cloud interchange format.

Port of `semicp/data/pcd.py`, host-side numpy, no PCL dependency. One
difference: an LZF stream cut inside a back-reference raises ValueError
here, like every other malformed stream (the JAX package's decoder
raises IndexError there).

Supported: ASCII, `binary`, and `binary_compressed` (LZF) DATA
encodings, arbitrary field subsets (we consume x/y/z and, when present,
an integer `label` field — the PointXYZL layout). binary_compressed
reading matches pcl::io::loadPCDFile's layout: two uint32 sizes, an LZF
stream, and FIELD-MAJOR (SoA) uncompressed content; the decompressor is
pure Python (a loader-path cost only). Writing emits ascii/binary.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PCD_DTYPES = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def _lzf_decompress(src: bytes, expected: int) -> bytes:
    """Decompress a libLZF stream (the PCD binary_compressed codec).

    Control bytes < 32 are literal runs of ctrl+1 bytes; otherwise a
    back-reference of (ctrl >> 5) + 2 bytes (+1 extension byte when the
    3-bit length saturates) at offset ((ctrl & 0x1f) << 8) + next + 1.
    Overlapping back-references copy byte-serially (run replication).
    """
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            if i + run > n:
                raise ValueError("PCD: truncated LZF literal run")
            out += src[i:i + run]
            i += run
        else:
            length = ctrl >> 5
            if i + (length == 7) >= n:
                raise ValueError("PCD: truncated LZF back-reference")
            if length == 7:
                length += src[i]
                i += 1
            length += 2
            ref = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("PCD: corrupt LZF stream (bad back-reference)")
            for _ in range(length):
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(
            f"PCD: LZF stream decompressed to {len(out)} bytes but the "
            f"header declares {expected}")
    return bytes(out)


def _parse_header(fh) -> dict:
    """Consume the PCD header; leaves fh positioned at the data section."""
    hdr: dict = {}
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("PCD: truncated header (no DATA line)")
        text = line.decode("ascii", "replace").strip()
        if not text or text.startswith("#"):
            continue
        key, _, rest = text.partition(" ")
        key = key.upper()
        vals = rest.split()
        if key in ("FIELDS", "TYPE"):
            hdr[key] = vals
        elif key in ("SIZE", "COUNT"):
            hdr[key] = [int(v) for v in vals]
        elif key in ("WIDTH", "HEIGHT", "POINTS"):
            hdr[key] = int(vals[0])
        elif key == "DATA":
            hdr[key] = vals[0].lower()
            return hdr
        elif key in ("VERSION", "VIEWPOINT"):
            hdr[key] = rest
        # unknown keys are skipped (PCD headers are extensible)


def load_pcd(path) -> tuple[np.ndarray, np.ndarray | None]:
    """Load a .pcd file -> (xyz (N, 3) float32, label (N,) int32 or None).

    The label comes from a `label` field when present (pcl::PointXYZL);
    otherwise None. Non-finite points (PCL's NaN invalids) are dropped.
    """
    path = Path(path)
    with open(path, "rb") as fh:
        hdr = _parse_header(fh)
        fields = hdr.get("FIELDS")
        if not fields:
            raise ValueError(f"{path}: PCD header missing FIELDS")
        sizes = hdr.get("SIZE", [4] * len(fields))
        types = hdr.get("TYPE", ["F"] * len(fields))
        counts = hdr.get("COUNT", [1] * len(fields))
        n = hdr.get("POINTS", hdr.get("WIDTH", 0) * max(hdr.get("HEIGHT", 1), 1))
        data = hdr.get("DATA", "ascii")

        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            dt = _PCD_DTYPES.get((typ.upper(), size))
            if dt is None:
                raise ValueError(f"{path}: unsupported field {name} {typ}{size}")
            for c in range(cnt):
                np_fields.append((f"{name}{c}" if cnt > 1 else name, dt))
        dtype = np.dtype(np_fields)

        if data == "binary":
            rec = np.frombuffer(fh.read(dtype.itemsize * n), dtype=dtype, count=n)
        elif data == "ascii":
            txt = np.loadtxt(fh, dtype=np.float64, ndmin=2)
            if txt.shape[0] < n:
                # mirror the binary path's frombuffer(count=n) error on a
                # truncated data section instead of loading short silently
                raise ValueError(
                    f"{path}: PCD declares POINTS {n} but the ascii data "
                    f"section holds only {txt.shape[0]} rows")
            if txt.shape[0] != n:
                txt = txt[:n]
            rec = np.empty(txt.shape[0], dtype=dtype)
            for i, (name, _) in enumerate(np_fields):
                rec[name] = txt[:, i]
        elif data == "binary_compressed":
            sizes_hdr = fh.read(8)
            if len(sizes_hdr) != 8:
                raise ValueError(f"{path}: truncated binary_compressed sizes")
            comp_size, uncomp_size = np.frombuffer(sizes_hdr, np.uint32)
            comp = fh.read(int(comp_size))
            if len(comp) != int(comp_size):
                raise ValueError(
                    f"{path}: binary_compressed data truncated "
                    f"({len(comp)} of {int(comp_size)} bytes)")
            raw = _lzf_decompress(comp, int(uncomp_size))
            # PCL writes the uncompressed section FIELD-MAJOR (SoA): for
            # each field in order, all N points' values consecutively
            rec = np.empty(n, dtype=dtype)
            off = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                dt = _PCD_DTYPES[(typ.upper(), size)]
                block = np.frombuffer(raw, dtype=dt, count=n * cnt, offset=off)
                off += size * cnt * n
                if cnt == 1:
                    rec[name] = block
                else:
                    block = block.reshape(n, cnt)
                    for c in range(cnt):
                        rec[f"{name}{c}"] = block[:, c]
            if off != int(uncomp_size):
                raise ValueError(
                    f"{path}: binary_compressed field layout holds {off} "
                    f"bytes but the stream decompressed to {int(uncomp_size)}")
        else:
            raise ValueError(f"{path}: unknown DATA encoding {data!r}")

    for axis in ("x", "y", "z"):
        if axis not in rec.dtype.names:
            raise ValueError(f"{path}: PCD has no {axis!r} field")
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    label = None
    if "label" in rec.dtype.names:
        label = rec["label"].astype(np.int32)
    keep = np.isfinite(xyz).all(axis=1)
    if not keep.all():
        xyz = xyz[keep]
        label = label[keep] if label is not None else None
    return xyz, label


def save_pcd(path, xyz: np.ndarray, label: np.ndarray | None = None,
             binary: bool = True) -> None:
    """Write (N, 3) points (+ optional int labels) as a PointXYZL .pcd.

    Output loads in PCL as pcl::PointXYZ (no label) or pcl::PointXYZL,
    so trajectories/maps produced here round-trip into the reference's
    toolchain.
    """
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"save_pcd: xyz must be (N, 3), got {xyz.shape}")
    n = xyz.shape[0]
    fields = ["x", "y", "z"]
    sizes, types = ["4"] * 3, ["F"] * 3
    if label is not None:
        label = np.asarray(label)
        if label.shape != (n,):
            raise ValueError(f"save_pcd: label must be ({n},), got {label.shape}")
        fields.append("label")
        sizes.append("4")
        types.append("U")
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(sizes)}",
        f"TYPE {' '.join(types)}",
        f"COUNT {' '.join(['1'] * len(fields))}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if binary:
            np_fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
            if label is not None:
                np_fields.append(("label", np.uint32))
            rec = np.empty(n, dtype=np.dtype(np_fields))
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            if label is not None:
                rec["label"] = label.astype(np.uint32)
            fh.write(rec.tobytes())
        else:
            lab = label if label is not None else None
            for i in range(n):
                row = f"{xyz[i, 0]:.6f} {xyz[i, 1]:.6f} {xyz[i, 2]:.6f}"
                if lab is not None:
                    row += f" {int(lab[i])}"
                fh.write((row + "\n").encode("ascii"))
