"""Fused submap insertion: one key sort + segmented means, no scatter.

Port of ``open3d_slam_tpu.ops.sorted_store``: transform the scan into the
map frame, crop it, and re-merge it with the existing map by voxel key
(``voxel.merge_clouds_by_voxel``).  Keys are stateless — recomputed from the
points each insert with the pack region re-anchored at the current pose — so
carving and loop-closure transforms need no invariant maintenance.  Every
row (map point or scan point) weighs 1 in its voxel's mean, as the
reference's re-voxelization does (``helpers.cpp:115-183``).
"""
from __future__ import annotations

from typing import Optional

import torch

from open3d_slam_torch.ops.voxel import (INT32_MAX, OUT_OF_REGION,
                                         merge_clouds_by_voxel, pack_coords,
                                         region_base_from_center, voxel_coords)
from open3d_slam_torch.utils import se3
from open3d_slam_torch.utils.pointcloud import PointCloud


def point_keys(points: torch.Tensor, valid: torch.Tensor, voxel_size: float,
               base: torch.Tensor,
               mergeable: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed voxel keys; invalid -> INT32_MAX; out-of-region or not
    ``mergeable`` -> OUT_OF_REGION (kept verbatim as singletons)."""
    packed = pack_coords(voxel_coords(points, voxel_size), base)
    ok = packed >= 0
    if mergeable is not None:
        ok = ok & mergeable
    keys = torch.where(ok, packed, torch.full_like(packed, OUT_OF_REGION))
    return torch.where(valid, keys, torch.full_like(keys, INT32_MAX))


def insert_scan_fused(map_cloud: PointCloud, scan: PointCloud, T: torch.Tensor,
                      cropper, voxel_size: float,
                      enable: torch.Tensor) -> PointCloud:
    """Transform the scan to the map frame, crop, merge by voxel with the
    map.  ``enable`` (device bool) turns the insert into a merge of zero scan
    rows without a host round-trip."""
    C, S = map_cloud.capacity, scan.capacity
    dev = map_cloud.device
    base = region_base_from_center(voxel_coords(T[:3, 3], voxel_size))
    spts = se3.transform_points(T, scan.points)
    snrm = se3.rotate_vectors(T, scan.normals) if scan.normals is not None else None
    valid_scan = scan.mask & enable
    inside = cropper.is_inside(spts, T[:3, 3])
    mkeys = point_keys(map_cloud.points, map_cloud.mask, voxel_size, base)
    skeys = point_keys(spts, valid_scan, voxel_size, base, mergeable=inside)

    def cat(a, b):
        if a is None and b is None:
            return None
        a2 = a if a is not None else torch.zeros((C, 3), dtype=torch.float32, device=dev)
        b2 = b if b is not None else torch.zeros((S, 3), dtype=torch.float32, device=dev)
        return torch.cat([a2, b2], dim=0)

    return merge_clouds_by_voxel(
        torch.cat([mkeys, skeys]), torch.cat([map_cloud.points, spts]),
        cat(map_cloud.normals, snrm), cat(map_cloud.colors, scan.colors),
        voxel_size, base, out_capacity=C)
