"""Cloud format conversions.

Port of ``open3d_slam_tpu.io.conversions``, the ROS-free analog of the
reference's ``open3d_conversions`` package
(``open3d_utils/open3d_conversions/src/open3d_conversions.cpp:19-95``):
``PointCloud2``-style structured numpy record arrays (fields x, y, z and
optionally rgb / r, g, b / intensity / normal_*) <-> the padded
``PointCloud``.  Intensity becomes a grey colour, as in the reference.  The
mesh message round trip (``open3d_conversions.cpp:260-307``) runs on the
host alone.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.device import resolve_device
from open3d_slam_torch.utils.pointcloud import PointCloud


def _structured_to_arrays(arr: np.ndarray) -> Dict[str, Optional[np.ndarray]]:
    """Structured array -> {"points", "normals", "colors"} float32 arrays
    (None where the fields are absent)."""
    names = arr.dtype.names
    if not names or not all(k in names for k in "xyz"):
        raise ValueError("a structured cloud needs x, y and z fields")
    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
    normals = None
    if all(f"normal_{a}" in names for a in "xyz"):
        normals = np.stack([arr["normal_x"], arr["normal_y"], arr["normal_z"]],
                           axis=1).astype(np.float32)
    colors = None
    if "rgb" in names:
        rgb = np.ascontiguousarray(arr["rgb"]).view(np.uint32).reshape(-1)
        colors = np.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF],
                          axis=1).astype(np.float32) / 255.0
    elif all(c in names for c in "rgb"):
        colors = np.stack([arr["r"], arr["g"], arr["b"]], axis=1).astype(np.float32)
        if colors.max() > 1.0:
            colors /= 255.0
    elif "intensity" in names:
        i = arr["intensity"].astype(np.float32)
        i = i / max(float(i.max()), 1e-6)
        colors = np.stack([i, i, i], axis=1)
    return {"points": pts, "normals": normals, "colors": colors}


def _arrays_to_structured(points: np.ndarray, normals: Optional[np.ndarray] = None,
                          colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Points (and normals, colours in [0, 1]) -> structured array; colours
    are packed 8 bits a channel into the float32 ``rgb`` field."""
    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    if normals is not None:
        fields += [("normal_x", np.float32), ("normal_y", np.float32),
                   ("normal_z", np.float32)]
    if colors is not None:
        fields += [("rgb", np.float32)]
    out = np.zeros(points.shape[0], dtype=fields)
    out["x"], out["y"], out["z"] = points.T
    if normals is not None:
        out["normal_x"], out["normal_y"], out["normal_z"] = normals.T
    if colors is not None:
        c = np.clip(colors * 255.0, 0, 255).astype(np.uint32)
        out["rgb"] = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]).view(np.float32)
    return out


def structured_to_pointcloud(arr: np.ndarray, capacity: Optional[int] = None,
                             device="cuda") -> PointCloud:
    """Structured array -> padded PointCloud on ``device`` (``cuda`` unless
    the caller asks for another)."""
    return pclib.from_numpy(**_structured_to_arrays(arr), capacity=capacity,
                            device=resolve_device(device))


def pointcloud_to_structured(pc: PointCloud) -> np.ndarray:
    """Padded PointCloud -> structured array of its valid points."""
    return _arrays_to_structured(**pclib.to_numpy(pc))


class TriangleMesh:
    """Minimal host-side triangle mesh (vertices, triangles, optional vertex
    colours): the conversion layer's ``open3d::geometry::TriangleMesh``."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray,
                 vertex_colors: Optional[np.ndarray] = None):
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
        self.vertex_colors = (None if vertex_colors is None else
                              np.asarray(vertex_colors, np.float32).reshape(-1, 3))


def mesh_to_polygon_msg(mesh: TriangleMesh) -> dict:
    """TriangleMesh -> PolygonMesh-style dict {"cloud": structured vertex
    array, "polygons": (T, 3) int32} (``open3d_conversions.cpp:260-286``)."""
    return {"cloud": _arrays_to_structured(mesh.vertices, colors=mesh.vertex_colors),
            "polygons": mesh.triangles.copy()}


def polygon_msg_to_mesh(msg: dict) -> TriangleMesh:
    """PolygonMesh-style dict -> TriangleMesh (``open3d_conversions.cpp:292-307``);
    an index outside the vertex cloud raises."""
    data = _structured_to_arrays(msg["cloud"])
    tri = np.asarray(msg["polygons"], np.int32).reshape(-1, 3)
    if len(tri) and (tri.min() < 0 or tri.max() >= data["points"].shape[0]):
        raise ValueError("polygon index out of range of the vertex cloud")
    return TriangleMesh(data["points"], tri, vertex_colors=data["colors"])
