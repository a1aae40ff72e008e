"""Dataset utilities: synthetic LiDAR sequences + on-disk sequence replay.

The reference replays rosbags (``RosbagRangeDataProcessorRos.cpp:52-125``);
this package replays directories of PCD/NPZ scans with timestamps, plus a
synthetic structured-world generator used by tests, benchmarks, and demos
(the environment has no ROS).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticWorldConfig:
    extent: float = 40.0          # half-size of the world in x/y
    wall_height: float = 4.0
    n_ground: int = 120000
    n_walls: int = 60000
    n_pillars: int = 40000
    n_pillar_count: int = 24
    noise: float = 0.01
    seed: int = 0


class SyntheticWorld:
    """A structured scene (ground plane + boundary walls + pillars) sampled
    densely; scans are range-limited views from a sensor pose."""

    def __init__(self, cfg: Optional[SyntheticWorldConfig] = None):
        self.cfg = cfg or SyntheticWorldConfig()
        c = self.cfg
        rng = np.random.default_rng(c.seed)
        e = c.extent
        ground = np.stack([
            rng.uniform(-e, e, c.n_ground),
            rng.uniform(-e, e, c.n_ground),
            np.zeros(c.n_ground)], axis=1)
        # 4 boundary walls.
        nw = c.n_walls // 4
        walls = []
        for sgn in (-1, 1):
            walls.append(np.stack([
                rng.uniform(-e, e, nw), sgn * e * np.ones(nw),
                rng.uniform(0, c.wall_height, nw)], axis=1))
            walls.append(np.stack([
                sgn * e * np.ones(nw), rng.uniform(-e, e, nw),
                rng.uniform(0, c.wall_height, nw)], axis=1))
        # Pillars: vertical boxes at random locations.
        pillars = []
        npp = c.n_pillars // max(c.n_pillar_count, 1)
        for _ in range(c.n_pillar_count):
            cx, cy = rng.uniform(-0.8 * e, 0.8 * e, 2)
            w = rng.uniform(0.3, 1.0)
            face = rng.integers(0, 4, npp)
            fx = np.where(face == 0, -w, np.where(face == 1, w, rng.uniform(-w, w, npp)))
            fy = np.where(face == 2, -w, np.where(face == 3, w, rng.uniform(-w, w, npp)))
            pillars.append(np.stack([
                cx + fx, cy + fy, rng.uniform(0, c.wall_height, npp)], axis=1))
        pts = np.concatenate([ground] + walls + pillars).astype(np.float64)
        pts += rng.normal(scale=c.noise, size=pts.shape)
        self.points = pts
        self._rng = rng

    def render_scan(self, pose: np.ndarray, max_range: float = 30.0,
                    n_points: int = 20000, min_range: float = 0.5) -> np.ndarray:
        """Range-limited view of the world from ``pose``, in SENSOR frame.

        Not a spinning-beam simulation — a uniform subsample of visible
        surface points, which is what the registration pipeline consumes.
        """
        t = pose[:3, 3]
        d = np.linalg.norm(self.points - t, axis=1)
        vis = (d < max_range) & (d > min_range)
        idx = np.flatnonzero(vis)
        if len(idx) > n_points:
            idx = self._rng.choice(idx, n_points, replace=False)
        world_pts = self.points[idx]
        R = pose[:3, :3]
        return ((world_pts - t) @ R).astype(np.float32)


def structured_scene(rng: np.random.Generator, n: int,
                     extent: float = 14.0) -> np.ndarray:
    """Ground + perimeter walls + random boxes, (n, 3) float32: geometry with
    a unique global registration optimum, for global localization (a
    pillar-field yard aliases under ~5 m translations; a wrong basin can
    score fitness 1.0).  A copy of ``bench.py``'s ``_structured_scene``, draw
    for draw."""
    ng = n // 2
    ground = np.stack([rng.uniform(-extent, extent, ng),
                       rng.uniform(-extent, extent, ng),
                       rng.normal(0, 0.02, ng)], axis=1)
    nw = n // 8
    walls = []
    for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1)):
        w = np.empty((nw, 3))
        w[:, axis] = sign * extent + rng.normal(0, 0.02, nw)
        w[:, 1 - axis] = rng.uniform(-extent, extent, nw)
        w[:, 2] = rng.uniform(0, 3.0, nw)
        walls.append(w)
    boxes = []
    m = max(1, n // 24)
    for _ in range(8):
        cx, cy = rng.uniform(-extent * 0.7, extent * 0.7, 2)
        w, h = rng.uniform(0.5, 1.5), rng.uniform(1.0, 3.0)
        face = rng.integers(0, 4, m)
        fx = np.where(face == 0, -w, np.where(face == 1, w, rng.uniform(-w, w, m)))
        fy = np.where(face == 2, -w, np.where(face == 3, w, rng.uniform(-w, w, m)))
        boxes.append(np.stack([cx + fx, cy + fy, rng.uniform(0, h, m)], axis=1))
    pts = np.concatenate([ground] + walls + boxes).astype(np.float32)
    return pts[rng.permutation(len(pts))[:n]]


def planted_scan(map_points: np.ndarray, pose_rng: np.random.Generator,
                 n_scan: int, reach: float = 14.0):
    """A scan of ``map_points`` from a random planar pose (yaw in [0, 2 pi),
    x, y in [-9, 9] m), in the sensor frame: the map points within ``reach``
    (in x, y) of the pose, ``n_scan`` of them drawn without replacement.
    Returns (scan (k, 3) float32, T_true (4, 4)), draw for draw as
    ``bench.py``'s ``bench_multistart_localization``."""
    T_true = np.eye(4)
    yaw = pose_rng.uniform(0, 2 * np.pi)
    T_true[:3, :3] = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                               [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    T_true[:2, 3] = pose_rng.uniform(-9.0, 9.0, 2)
    d = np.linalg.norm(map_points[:, :2] - T_true[:2, 3], axis=1)
    vis = map_points[d < reach]
    sel = pose_rng.choice(len(vis), min(n_scan, len(vis)), replace=False)
    return ((vis[sel] - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32), T_true


def circle_trajectory(n_poses: int, radius: float = 15.0, z: float = 1.5,
                      angle_total: float = 2 * np.pi,
                      yaw_follows_path: bool = True) -> List[np.ndarray]:
    """Ground-truth poses along a circle (loop-closure friendly)."""
    poses = []
    for i in range(n_poses):
        a = angle_total * i / max(n_poses - 1, 1)
        t = np.array([radius * np.cos(a), radius * np.sin(a), z])
        yaw = a + np.pi / 2 if yaw_follows_path else 0.0
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = t
        poses.append(T)
    return poses


def straight_trajectory(n_poses: int, step: float = 0.5, z: float = 1.5) -> List[np.ndarray]:
    poses = []
    for i in range(n_poses):
        T = np.eye(4)
        T[:3, 3] = [i * step, 0.0, z]
        poses.append(T)
    return poses


@dataclasses.dataclass
class SyntheticSequence:
    """Scans + ground truth, ready to feed the SLAM pipeline."""
    scans: List[np.ndarray]            # (Ni, 3) float32, sensor frame
    timestamps: List[float]
    ground_truth: List[np.ndarray]     # 4x4 world poses

    def __len__(self):
        return len(self.scans)


def make_synthetic_sequence(n_scans: int = 50, dt: float = 0.1,
                            trajectory: str = "circle",
                            n_points: int = 20000,
                            max_range: float = 30.0,
                            world_cfg: Optional[SyntheticWorldConfig] = None,
                            **traj_kw) -> SyntheticSequence:
    world = SyntheticWorld(world_cfg)
    if trajectory == "circle":
        poses = circle_trajectory(n_scans, **traj_kw)
    elif trajectory == "straight":
        poses = straight_trajectory(n_scans, **traj_kw)
    else:
        raise ValueError(trajectory)
    scans = [world.render_scan(T, max_range=max_range, n_points=n_points)
             for T in poses]
    ts = [i * dt for i in range(n_scans)]
    return SyntheticSequence(scans=scans, timestamps=ts, ground_truth=poses)


# ---------------------------------------------------------------------------
# Disk replay: directory of .npz scans  (scan_000000.npz: points, t)
# ---------------------------------------------------------------------------


def save_sequence(seq: SyntheticSequence, folder: str):
    os.makedirs(folder, exist_ok=True)
    for i, (scan, t) in enumerate(zip(seq.scans, seq.timestamps)):
        np.savez_compressed(os.path.join(folder, f"scan_{i:06d}.npz"),
                            points=scan, t=t)
    np.save(os.path.join(folder, "ground_truth.npy"),
            np.stack(seq.ground_truth))


def load_sequence(folder: str) -> SyntheticSequence:
    """Replay a scan folder: auto-detects the format.

    - ``scan_*.npz`` (points + t) with optional ``ground_truth.npy``,
    - KITTI odometry: a ``velodyne/`` subdir (or ``*.bin`` files directly)
      with optional ``times.txt`` / ``poses.txt``,
    - a folder of ``*.pcd`` files sorted by name (0.1 s nominal spacing,
      the reference's default ``scanDuration``).

    The directory-of-files replay is the rosbag-replay analog
    (reference ``RosbagRangeDataProcessorRos::readRosbag``).
    """
    entries = os.listdir(folder)
    velodyne_dir = None
    if "velodyne" in entries and os.path.isdir(os.path.join(folder, "velodyne")):
        velodyne_dir = os.path.join(folder, "velodyne")
    elif any(f.endswith(".bin") for f in entries):
        velodyne_dir = folder
    if velodyne_dir is not None:
        from open3d_slam_torch.io import kitti
        return kitti.load_kitti_sequence(
            velodyne_dir,
            times_file=os.path.join(folder, "times.txt"),
            poses_file=os.path.join(folder, "poses.txt"))

    pcd_files = sorted(f for f in entries if f.endswith(".pcd"))
    if pcd_files and not any(f.endswith(".npz") for f in entries):
        from open3d_slam_torch.io import pcd as pcd_io
        scans = [np.asarray(pcd_io.read_pcd(os.path.join(folder, f))["points"],
                            np.float32) for f in pcd_files]
        ts = [0.1 * i for i in range(len(scans))]
        return SyntheticSequence(scans=scans, timestamps=ts, ground_truth=[])

    files = sorted(f for f in entries
                   if f.startswith("scan_") and f.endswith(".npz"))
    scans, ts = [], []
    for f in files:
        data = np.load(os.path.join(folder, f))
        scans.append(data["points"].astype(np.float32))
        ts.append(float(data["t"]))
    gt_path = os.path.join(folder, "ground_truth.npy")
    gt = list(np.load(gt_path)) if os.path.exists(gt_path) else []
    return SyntheticSequence(scans=scans, timestamps=ts, ground_truth=gt)
