"""Carry state from the JAX package into the port.

The port has no weights: its state is point clouds and parameters.  Both
arrive here as plain numpy arrays and dictionaries (a cloud's
``points``/``mask``/``normals``/``colors``, and ``dataclasses.asdict`` of the
JAX ``SlamParameters``), so the two packages can compute on the same inputs
without the port importing anything of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from open3d_slam_torch.utils.config import SlamParameters, load_parameters, to_dict
from open3d_slam_torch.utils.pointcloud import PointCloud


def cloud_from_arrays(points: np.ndarray, mask: np.ndarray,
                      normals: Optional[np.ndarray] = None,
                      colors: Optional[np.ndarray] = None,
                      device="cpu") -> PointCloud:
    """A padded cloud, row for row (padding rows and capacity kept)."""
    def f32(a):
        return None if a is None else torch.as_tensor(
            np.array(a, np.float32), device=device)
    return PointCloud(points=f32(points),
                      mask=torch.as_tensor(np.array(mask, bool), device=device),
                      normals=f32(normals), colors=f32(colors))


def cloud_to_arrays(pc: PointCloud) -> Dict[str, Optional[np.ndarray]]:
    """The inverse of ``cloud_from_arrays``: every row, padding included."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    return {"points": host(pc.points), "mask": host(pc.mask),
            "normals": host(pc.normals), "colors": host(pc.colors)}


def params_from_dict(d: Dict[str, Any]) -> SlamParameters:
    """The port's parameters from a nested dict of the same tree (unknown
    keys raise, as a config file's do)."""
    return load_parameters(d)


def params_to_dict(p: SlamParameters) -> Dict[str, Any]:
    return to_dict(p)
