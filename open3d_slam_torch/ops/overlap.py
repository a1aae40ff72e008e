"""Voxel-grid overlap masks between two clouds.

Port of ``open3d_slam_tpu.ops.overlap`` (reference
``computeIndicesOfOverlappingPoints``, ``helpers.cpp:307-332``): points of the
source (moved by source->target) and of the target that share an occupied
voxel are selected, by exact packed voxel keys relative to the joint minimum
coordinate.  Points outside the ``EXACT_EXTENT`` region are left out.
"""
from __future__ import annotations

from typing import Tuple

import torch

from open3d_slam_torch.ops.voxel import INT32_MAX, pack_coords, voxel_coords
from open3d_slam_torch.utils import se3
from open3d_slam_torch.utils.pointcloud import PointCloud


def _member(sorted_keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    pos = torch.clamp(torch.searchsorted(sorted_keys, query, side="left"),
                      0, sorted_keys.shape[0] - 1)
    return (sorted_keys[pos] == query) & (query >= 0)


def overlapping_masks(source: PointCloud, target: PointCloud,
                      source_to_target: torch.Tensor,
                      voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(source_mask, target_mask) of the points in mutually occupied voxels."""
    vs = torch.tensor(float(voxel_size), dtype=torch.float32, device=source.device)
    src_coords = voxel_coords(se3.transform_points(source_to_target, source.points), vs)
    tgt_coords = voxel_coords(target.points, vs)
    big = torch.full((), 2 ** 30, dtype=torch.int32, device=source.device)
    src_min = torch.where(source.mask[:, None], src_coords, big).min(dim=0).values
    tgt_min = torch.where(target.mask[:, None], tgt_coords, big).min(dim=0).values
    base = torch.minimum(src_min, tgt_min)
    neg = torch.full((), -1, dtype=torch.int32, device=source.device)
    src_keys = torch.where(source.mask, pack_coords(src_coords, base), neg)
    tgt_keys = torch.where(target.mask, pack_coords(tgt_coords, base), neg)
    imax = torch.full((), INT32_MAX, dtype=torch.int32, device=source.device)
    src_sorted = torch.sort(torch.where(src_keys >= 0, src_keys, imax)).values
    tgt_sorted = torch.sort(torch.where(tgt_keys >= 0, tgt_keys, imax)).values
    return (_member(tgt_sorted, src_keys) & source.mask,
            _member(src_sorted, tgt_keys) & target.mask)
