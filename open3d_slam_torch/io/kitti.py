"""KITTI odometry dataset loading.

The reference demonstrates KITTI seq 00/02/17 maps
(``documentation/source/examples.rst:7-36`` via rosbag replay).  This loads
the raw KITTI velodyne format directly: ``*.bin`` files of float32
(x, y, z, intensity) records, plus optional ``times.txt`` and ground-truth
``poses.txt`` (3x4 row-major, camera frame).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from open3d_slam_torch.io.datasets import SyntheticSequence


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 4) float32: x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_times(path: str) -> List[float]:
    with open(path) as f:
        return [float(line) for line in f if line.strip()]


def read_poses(path: str) -> List[np.ndarray]:
    """KITTI poses.txt: 3x4 row-major per line -> 4x4 matrices."""
    out = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            T = np.eye(4)
            T[:3, :4] = np.array(vals).reshape(3, 4)
            out.append(T)
    return out


def load_kitti_sequence(velodyne_dir: str,
                        times_file: Optional[str] = None,
                        poses_file: Optional[str] = None,
                        max_scans: Optional[int] = None,
                        every_nth: int = 1) -> SyntheticSequence:
    """Directory of ``*.bin`` scans -> replayable sequence (intensity dropped)."""
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    files = files[::every_nth]
    if max_scans:
        files = files[:max_scans]
    scans = [read_velodyne_bin(os.path.join(velodyne_dir, f))[:, :3]
             for f in files]
    if times_file and os.path.exists(times_file):
        ts = read_times(times_file)[::every_nth][:len(scans)]
    else:
        ts = [0.1 * i for i in range(len(scans))]
    gt: List[np.ndarray] = []
    if poses_file and os.path.exists(poses_file):
        gt = read_poses(poses_file)[::every_nth][:len(scans)]
    return SyntheticSequence(scans=scans, timestamps=ts, ground_truth=gt)
