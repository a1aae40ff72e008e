"""PCD point-cloud file IO (ASCII + binary), numpy-based with an optional
native C++ fast path (native/pcd_io.cpp via ctypes) for large files.

Replaces the reference's Open3D ``ReadPointCloud``/``WritePointCloudToPCD``
usage (``output.cpp:45-52``, ``SubmapCollection.cpp:279``,
``SlamMapInitializer.cpp:57``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_FIELD_ORDER = ["x", "y", "z", "normal_x", "normal_y", "normal_z", "r", "g", "b"]


def _native_lib():
    """Load the optional C++ PCD codec; None if unavailable."""
    from open3d_slam_torch.io import native
    return native.load()


def write_pcd(path: str, points: np.ndarray,
              normals: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              binary: bool = True):
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    fields = ["x", "y", "z"]
    arrays = [points]
    if normals is not None and len(normals):
        fields += ["normal_x", "normal_y", "normal_z"]
        arrays.append(np.asarray(normals, np.float32))
    if colors is not None and len(colors):
        fields += ["rgb"]
        c = np.clip(np.asarray(colors, np.float64) * 255.0, 0, 255).astype(np.uint32)
        rgb = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        arrays.append(rgb.view(np.float32).reshape(n, 1))
    # Every array is (n, k) already: an empty cloud writes a header alone.
    data = np.concatenate(arrays, axis=1).astype(np.float32)

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read a PCD file -> dict with 'points' and optionally 'normals'/'colors'.

    Supports DATA ascii and DATA binary with float32 fields (the formats this
    package and Open3D write).  Binary files go through the native C++ codec
    when available (mmap + OpenMP decode), falling back to numpy.
    """
    try:
        from open3d_slam_torch.io import native
        out = native.read_pcd_native(path)
        if out is not None:
            return out
    except Exception:
        pass
    with open(path, "rb") as f:
        header = {}
        fields = []
        sizes = []
        types = []
        counts = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            header[key] = rest
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(x) for x in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(x) for x in rest.split()]
            elif key == "DATA":
                data_mode = rest.strip()
                break
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        if not counts:
            counts = [1] * len(fields)

        # Build numpy dtype for one point record.
        np_types = []
        for s, t, c in zip(sizes, types, counts):
            base = {("F", 4): np.float32, ("F", 8): np.float64,
                    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
                    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32}[(t, s)]
            np_types.append((base, c))

        if data_mode == "binary":
            dt = np.dtype([(f"f{i}", b, (c,)) for i, (b, c) in enumerate(np_types)])
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            cols = {name: np.asarray(raw[f"f{i}"]).reshape(n, np_types[i][1])
                    for i, name in enumerate(fields)}
        elif data_mode == "ascii":
            txt = np.loadtxt(f, dtype=np.float64, ndmin=2)
            cols = {}
            j = 0
            for name, (base, c) in zip(fields, np_types):
                cols[name] = txt[:, j:j + c]
                j += c
        else:
            raise ValueError(f"unsupported PCD data mode {data_mode!r} "
                             "(binary_compressed not supported)")

    out: Dict[str, np.ndarray] = {}
    out["points"] = np.concatenate(
        [cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    if all(k in cols for k in ("normal_x", "normal_y", "normal_z")):
        out["normals"] = np.concatenate(
            [cols["normal_x"], cols["normal_y"], cols["normal_z"]],
            axis=1).astype(np.float32)
    if "rgb" in cols:
        rgb = cols["rgb"].astype(np.float32).view(np.uint32).reshape(-1)
        r = ((rgb >> 16) & 0xFF).astype(np.float32) / 255.0
        g = ((rgb >> 8) & 0xFF).astype(np.float32) / 255.0
        b = (rgb & 0xFF).astype(np.float32) / 255.0
        out["colors"] = np.stack([r, g, b], axis=1)
    elif all(k in cols for k in ("r", "g", "b")):
        out["colors"] = np.concatenate(
            [cols["r"], cols["g"], cols["b"]], axis=1).astype(np.float32)
    return out
