"""Space carving: free-space ray-march removal of stale map points.

Port of the sparse-map carve of ``open3d_slam_tpu.ops.carving`` (reference
``getIdxsOfCarvedPoints``, ``helpers.cpp:235-271``): every scan ray is
sampled from the sensor in steps of the carve voxel size up to
``max(voxel, min(range - truncation, max_ray_len))``; map points in any
visited voxel are removed, gated by ``|dir . normal| > min_dot``.  All rays'
samples form one (N_rays x N_steps) batch of exact packed keys, sorted once;
map points test membership with a binary search.  Out-of-region map points
get key -1 and are conservatively kept.
"""
from __future__ import annotations

from typing import Tuple

import torch

from open3d_slam_torch.ops.voxel import (EXACT_EXTENT, INT32_MAX, pack_coords,
                                         region_base_from_center, voxel_coords)
from open3d_slam_torch.utils.pointcloud import PointCloud

_AXIS_MULT = (EXACT_EXTENT * EXACT_EXTENT, EXACT_EXTENT, 1)


def _sensor_base(sensor_position: torch.Tensor, key_voxel_size) -> torch.Tensor:
    inv = 1.0 / torch.full((), float(key_voxel_size), dtype=torch.float32,
                           device=sensor_position.device)
    center = torch.floor(sensor_position * inv).to(torch.int32)
    return region_base_from_center(center)


def _ray_visit_keys(scan_points: torch.Tensor, scan_mask: torch.Tensor,
                    sensor_position: torch.Tensor, step_size,
                    truncation_distance, max_ray_length, key_voxel_size,
                    max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted exact keys of all voxels visited by the scan's rays, region
    base); invalid samples get INT32_MAX.  Shape (N * S,)."""
    dev = scan_points.device
    step = torch.full((), float(step_size), dtype=torch.float32, device=dev)
    base = _sensor_base(sensor_position, key_voxel_size)
    d = scan_points - sensor_position[None, :]
    length = torch.linalg.norm(d, dim=-1)
    direction = d / torch.clamp(length[:, None], min=1e-9)
    max_path = torch.maximum(step, torch.clamp(length - truncation_distance,
                                               max=max_ray_length))
    steps = torch.arange(max_steps, dtype=torch.float32, device=dev)[None, :] * step
    inv = 1.0 / torch.full((), float(key_voxel_size), dtype=torch.float32, device=dev)
    keys = torch.zeros((scan_points.shape[0], max_steps), dtype=torch.int32, device=dev)
    in_range = torch.ones((scan_points.shape[0], max_steps), dtype=torch.bool, device=dev)
    for a, mult in enumerate(_AXIS_MULT):
        pos_a = sensor_position[a] + direction[:, a:a + 1] * steps
        rel_a = torch.floor(pos_a * inv).to(torch.int32) - base[a]
        in_range &= (rel_a >= 0) & (rel_a < EXACT_EXTENT)
        keys = keys + rel_a * mult
    valid = (steps < max_path[:, None]) & scan_mask[:, None] & in_range
    keys = torch.where(valid, keys, torch.full_like(keys, INT32_MAX))
    return torch.sort(keys.reshape(-1)).values, base


def carve_mask(map_pc: PointCloud, scan_pc: PointCloud,
               sensor_position: torch.Tensor, voxel_size, truncation_distance,
               max_ray_length, min_dot_product_with_normal,
               max_steps: int = 256) -> torch.Tensor:
    """Boolean keep-mask over ``map_pc`` after carving with ``scan_pc``."""
    keys_sorted, base = _ray_visit_keys(
        scan_pc.points, scan_pc.mask, sensor_position, step_size=voxel_size,
        truncation_distance=truncation_distance, max_ray_length=max_ray_length,
        key_voxel_size=voxel_size, max_steps=max_steps)
    map_keys = pack_coords(voxel_coords(map_pc.points, voxel_size), base)
    pos = torch.searchsorted(keys_sorted, map_keys, side="left")
    pos = torch.clamp(pos, 0, keys_sorted.shape[0] - 1)
    hit = (keys_sorted[pos] == map_keys) & (map_keys >= 0)
    if map_pc.normals is not None:
        to_pt = map_pc.points - sensor_position[None, :]
        dirs = to_pt / torch.clamp(torch.linalg.norm(to_pt, dim=-1, keepdim=True), min=1e-9)
        n = map_pc.normals
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
        gate = torch.abs(torch.sum(dirs * n, dim=-1)) > min_dot_product_with_normal
    else:
        gate = torch.ones_like(hit)
    return map_pc.mask & ~(hit & gate & map_pc.mask)
