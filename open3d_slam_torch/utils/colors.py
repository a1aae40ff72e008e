"""Fixed color palette for submap visualization.

Port of ``open3d_slam_tpu.utils.colors``: the reference's ``Color`` palette
(``ros/open3d_slam_ros/src/Color.cpp``) used to tint per-submap clouds in
the assembled colored map (``helpers_ros.cpp:51-70``).
"""
from __future__ import annotations

import numpy as np

from open3d_slam_torch.utils import pointcloud as pclib

# RGB in [0, 1], the classic distinguishable set the reference cycles.
PALETTE = np.array([
    [0.0, 0.0, 0.0],      # black
    [0.0, 0.0, 1.0],      # blue
    [0.0, 1.0, 0.0],      # green
    [1.0, 1.0, 0.0],      # yellow
    [1.0, 0.0, 0.0],      # red
    [1.0, 0.0, 1.0],      # magenta
    [0.0, 1.0, 1.0],      # cyan
    [1.0, 0.5, 0.0],      # orange
    [0.6, 0.2, 0.8],      # purple
    [0.5, 0.3, 0.0],      # brown
    [1.0, 0.4, 0.6],      # pink
    [0.7, 0.7, 0.7],      # gray
], dtype=np.float32)


def submap_color(submap_id: int) -> np.ndarray:
    return PALETTE[submap_id % len(PALETTE)]


def assemble_colored_submap_cloud(submaps) -> dict:
    """Concatenate submap clouds, each tinted by its id (numpy dict)."""
    parts = []
    cols = []
    for s in submaps:
        data = pclib.to_numpy(s.map_cloud)
        n = data["points"].shape[0]
        if n == 0:
            continue
        parts.append(data["points"])
        cols.append(np.tile(submap_color(s.id), (n, 1)))
    if not parts:
        return {"points": np.zeros((0, 3), np.float32),
                "colors": np.zeros((0, 3), np.float32)}
    return {"points": np.concatenate(parts),
            "colors": np.concatenate(cols)}
