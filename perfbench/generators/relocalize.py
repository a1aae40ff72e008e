"""Kidnapped-robot traffic: a saved site map and VLP-16 sweeps taken at
planted poses in it, rendered on the card in float64 with the benchmark's
own LiDAR generator (``lidar.py``: its yard, sweep renderer and beam table,
used as they are).

The site map is what a mapping run of the site leaves for localization
mode to load: one lap of the traffic's route, each sweep rendered at the
true poses along it (the sensor moving through the sweep, with the beam's
range noise and dropouts), cropped at the configuration's scan-processing
radii, accumulated in the world frame and voxelized to the centroids of
the configuration's map voxels (``mapper.map_builder.map_voxel_size``).
Each centroid is kept inside its own voxel as float32 divides it, so the
program's voxel grid of the same size keeps every point.  The yard and the
map are the same for every seed.

A query is one sweep from a static sensor at a planted pose: a uniform
angle on the route's circle, offset radially by a uniform draw within the
traffic's ``radial_offset_m``, yaw uniform in [0, 2 pi), roll and pitch 0,
the route's height.  The seed draws the poses, the range noise and the
dropouts; query i draws from streams of its own, so it does not depend on
how many were rendered before it.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from perfbench.generators import lidar

F64 = torch.float64
MAP_STREAM, NOISE_STREAM, POSE_STREAM = 0, 1, 2
KEY_BITS = 21                   # bits of each voxel coordinate in a packed key


class Site(NamedTuple):
    map_points: np.ndarray      # (N, 3) float32, world frame
    scans: List[np.ndarray]     # each (n_i, 3) float32, in its sensor's frame
    poses: np.ndarray           # (Q, 4, 4) float64, the planted sensor poses
    map_scans: int              # sweeps accumulated into the map


class PlantedPoses:
    """A trajectory that holds pose i through the times [i, i + 1): a
    sweep started at time i is taken from a static sensor at pose i."""

    def __init__(self, poses: torch.Tensor):
        self._poses = poses

    def poses(self, t: torch.Tensor) -> torch.Tensor:
        return self._poses.to(t.device)[torch.floor(t).long()]


def _world(traffic: dict) -> tuple:
    w, c = traffic["world"], traffic["trajectory"]
    traj = lidar.CircleTrajectory(c["radius"], c["period_s"], c["z"])
    # The footprints keep clear of the whole circle, as the mapping cell's.
    clear_t = torch.linspace(0.0, float(w["keep_clear_duration_s"]), 256, dtype=F64)
    clear = traj.poses(clear_t)[:, :2, 3].numpy()
    world = lidar.YardWorld(w["extent"], w["n_buildings"], w["n_poles"], w["seed"], clear,
                            w.get("clear_radius", 3.0))
    return world, traj


def _voxel_centroids(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """float32 centroids of the float32 ``points`` in each voxel of edge
    ``voxel`` (floor(p / voxel) in float32), summed in float64; a centroid
    that float32 would key into another voxel is moved toward its voxel's
    centre until it keys into its own."""
    size = torch.tensor(voxel, dtype=torch.float32, device=points.device)
    coords = torch.floor(points / size).to(torch.int64)
    low = coords.min(dim=0).values
    c = coords - low
    if int(c.max()) >= 1 << KEY_BITS:
        raise ValueError("the site is too large for the packed voxel keys")
    key = (c[:, 0] << (2 * KEY_BITS)) | (c[:, 1] << KEY_BITS) | c[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    n = len(uniq)
    sums = torch.zeros((n, 3), dtype=F64, device=points.device).index_add_(
        0, inv, points.to(F64))
    counts = torch.bincount(inv, minlength=n).to(F64)
    mean = sums / counts[:, None]
    own = torch.zeros((n, 3), dtype=torch.int64, device=points.device)
    own[inv] = coords
    centre = (own.to(F64) + 0.5) * voxel
    out = mean.to(torch.float32)
    for _ in range(60):
        off = (torch.floor(out / size).to(torch.int64) != own).any(dim=1)
        if not bool(off.any()):
            return out
        mean = torch.where(off[:, None], mean + 0.25 * (centre - mean), mean)
        out = mean.to(torch.float32)
    raise RuntimeError("voxel centroids that float32 keys into another voxel")


def site_map(traffic: dict, config: dict, device) -> tuple:
    """The site map (float32 (N, 3), world frame) and the number of sweeps
    it accumulates."""
    world, traj = _world(traffic)
    beam = lidar.Beam(config["sensor"])
    rate = float(traffic["rate_hz"])
    m = config["slam_parameters"]["mapper"]
    crop = m["scan_processing"]["cropper"]
    r_min, r_max = float(crop["cropping_min_radius"]), float(crop["cropping_max_radius"])
    voxel = float(m["map_builder"]["map_voxel_size"])
    ren = lidar.SweepRenderer(world, traj, beam, 1.0 / rate, device)
    dev = ren.device
    k, nb = beam.azimuth_steps, len(beam.elevations_deg)
    n_scans = int(math.ceil(float(traffic["map"]["laps"]) * traj.period * rate))
    parts = []
    for b0 in range(0, n_scans, 16):
        idx = list(range(b0, min(b0 + 16, n_scans)))
        t0 = torch.tensor([i / rate for i in idx], dtype=F64, device=dev)
        s = len(idx)
        times = t0[:, None] + ren.phase[None] * ren.scan_duration
        T = traj.poses(times.reshape(-1)).reshape(s, k, 4, 4)
        o_w = T[:, :, None, :3, 3].expand(s, k, nb, 3).reshape(s, k * nb, 3)
        d_w = torch.einsum("skij,kbj->skbi", T[:, :, :3, :3], ren.dirs).reshape(s, k * nb, 3)
        t_hit = world.raycast(o_w.reshape(-1, 3), d_w.reshape(-1, 3)).reshape(s, k * nb)
        noise, keep = torch.empty_like(t_hit), torch.empty_like(t_hit)
        for j, i in enumerate(idx):
            g = torch.Generator(device=dev)
            g.manual_seed(lidar.stream_seed(traffic["map"]["seed"], MAP_STREAM, i))
            noise[j] = torch.randn(k * nb, generator=g, dtype=F64, device=dev)
            keep[j] = torch.rand(k * nb, generator=g, dtype=F64, device=dev)
        r = t_hit + beam.range_noise_std * noise
        valid = (torch.isfinite(t_hit) & (r > beam.min_range) & (r < beam.max_range)
                 & (keep > beam.dropout) & (r >= r_min) & (r <= r_max))
        parts.append((o_w + r[..., None] * d_w)[valid].to(torch.float32))
    return _voxel_centroids(torch.cat(parts), voxel).cpu().numpy(), n_scans


def planted_poses(traffic: dict, seed: int, first: int, n: int) -> np.ndarray:
    """The planted sensor poses of queries ``first`` .. ``first + n - 1``."""
    c, q = traffic["trajectory"], traffic["queries"]
    out = np.zeros((n, 4, 4))
    for j in range(n):
        rng = np.random.default_rng(lidar.stream_seed(seed, POSE_STREAM, first + j))
        a = rng.uniform(0.0, 2.0 * math.pi)
        rad = float(c["radius"]) + rng.uniform(-1.0, 1.0) * float(q["radial_offset_m"])
        yaw = rng.uniform(0.0, 2.0 * math.pi)
        out[j, :2, :2] = [[math.cos(yaw), -math.sin(yaw)], [math.sin(yaw), math.cos(yaw)]]
        out[j, 2, 2] = out[j, 3, 3] = 1.0
        out[j, :3, 3] = [rad * math.cos(a), rad * math.sin(a), float(q["z"])]
    return out


def queries(traffic: dict, sensor: dict, seed: int, first: int, n: int, device) -> tuple:
    """Queries ``first`` .. ``first + n - 1``: (scans, planted poses)."""
    world, _ = _world(traffic)
    poses = planted_poses(traffic, seed, first, n)
    ren = lidar.SweepRenderer(world, PlantedPoses(torch.as_tensor(poses)), lidar.Beam(sensor),
                              1.0 / float(traffic["rate_hz"]), device)
    scans = ren.render(seed, [float(j) for j in range(n)],
                       [(NOISE_STREAM, first + j) for j in range(n)])
    return scans, poses


def kidnapped(traffic: dict, config: dict, seed: int, n_queries: int, device) -> Site:
    """The ``kidnapped`` generator: the site map and ``n_queries`` queries."""
    points, n_scans = site_map(traffic, config, device)
    scans, poses = queries(traffic, config["sensor"], seed, 0, n_queries, device)
    return Site(points, scans, poses, n_scans)
