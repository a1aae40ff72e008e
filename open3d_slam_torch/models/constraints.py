"""Constraint types and the odometry-constraint builders.

Port of ``open3d_slam_tpu.models.constraints`` (reference ``Constraint``,
``Constraints.hpp``, and ``constraint_builders.cpp``): between a parent and
a child submap, overlap extraction, the optional ICP refinement of the
constraint (``is_refine_odometry_constraints_between_submaps``:
point-to-plane ICP, kernel K4), then the information matrix from the
nearest-neighbour correspondences (kernel K3 through
``hashgrid.query_nearest``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from open3d_slam_torch.ops import hashgrid, overlap as overlap_ops, pose_graph as pg_ops
from open3d_slam_torch.ops import registration
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.device import prefetch_to_host, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud

# magic.hpp mirrors
VOXEL_SIZE_CORR_SEARCH_IF_ZERO = 0.04
ICP_RUN_UNTIL_CONVERGENCE_ITERS = 100
VOXEL_EXPANSION_OVERLAP = 20.0
VOXEL_EXPANSION_ICP_CORR = 1.5
SOURCE_COMPACT_CAP = 32768
TARGET_COMPACT_CAP = 65536


@dataclasses.dataclass
class Constraint:
    """Pose-graph constraint between two submaps (``Constraints.hpp``)."""

    source_submap_idx: int
    target_submap_idx: int
    source_to_target: np.ndarray           # 4x4
    information_matrix: np.ndarray         # 6x6
    is_odometry_constraint: bool = True
    is_information_matrix_valid: bool = False
    timestamp: Optional[float] = None


def get_map_voxel_size(map_voxel_size: float) -> float:
    return VOXEL_SIZE_CORR_SEARCH_IF_ZERO if abs(map_voxel_size) <= 1e-3 else map_voxel_size


def constraint_outputs(source: PointCloud, target: PointCloud,
                       is_compute_overlap: bool, icp_max_corr_distance: float,
                       voxel_size_overlap: float,
                       is_estimate_information_matrix: bool,
                       is_skip_icp_refinement: bool,
                       src_compact_cap: int, tgt_compact_cap: int):
    """The whole constraint estimation on the device: overlap -> compact ->
    (ICP refinement) -> correspondences -> information matrix.  Returns
    (T (4, 4), info (6, 6)) as device tensors.

    Clouds over the compaction capacities keep a uniform stride of their
    points; the information matrix is scaled by the full/compacted count
    ratio so that edge weights keep the reference's full-cloud magnitudes
    (``GetInformationMatrixFromPointClouds`` sums over all correspondences)."""
    dev = source.device
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    if is_compute_overlap:
        src_m, tgt_m = overlap_ops.overlapping_masks(source, target, eye4,
                                                     voxel_size_overlap)
        source = source.with_(mask=source.mask & src_m)
        target = target.with_(mask=target.mask & tgt_m)
    n_src_full = source.count().to(torch.float32)
    source = pclib.compact_to(source, src_compact_cap)
    target = pclib.compact_to(target, tgt_compact_cap)
    info_scale = torch.clamp(
        n_src_full / torch.clamp(source.count().to(torch.float32), min=1.0), min=1.0)
    T_icp = eye4
    info = torch.eye(6, dtype=torch.float32, device=dev)
    grid = hashgrid.build(target, cell_size=icp_max_corr_distance)
    if not is_skip_icp_refinement:
        T_icp = registration.icp_point_to_plane(
            source, grid, eye4, icp_max_corr_distance,
            max_iterations=ICP_RUN_UNTIL_CONVERGENCE_ITERS).transformation
    if is_estimate_information_matrix:
        pts = se3.transform_points(T_icp, source.points)
        idx, _, found = hashgrid.query_nearest(grid, pts, icp_max_corr_distance)
        q = grid.points_sorted[idx.long()]
        info = info_scale * pg_ops.information_matrix_from_correspondences(
            q, found & source.mask)
    return T_icp, info


def finalize_constraint(c: Constraint, outputs) -> Constraint:
    """Fill a dispatched constraint's (T, info) from its device outputs (a
    ``Prefetched`` pair, or the tensors)."""
    items = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
    T_icp, info = to_host(*items)
    c.source_to_target = np.asarray(T_icp, np.float64)
    if c.is_information_matrix_valid:
        c.information_matrix = np.asarray(info, np.float64)
    return c


def build_constraint(source_idx: int, target_idx: int, submaps,
                     is_compute_overlap: bool, icp_max_corr_distance: float,
                     voxel_size_overlap: float,
                     is_estimate_information_matrix: bool,
                     is_skip_icp_refinement: bool,
                     pending_out: Optional[list] = None) -> Constraint:
    """``buildConstraint`` (``constraint_builders.cpp:43-90``).  With
    ``pending_out`` the device work is queued and its outputs prefetched but
    not pulled: ``(constraint, prefetched)`` is appended for a later
    ``finalize_constraint`` (an optimisation round reads constraints scans
    later)."""
    source = submaps.get_submap(source_idx).map_cloud
    target = submaps.get_submap(target_idx).map_cloud
    outputs = constraint_outputs(
        source, target, bool(is_compute_overlap), float(icp_max_corr_distance),
        float(voxel_size_overlap), bool(is_estimate_information_matrix),
        bool(is_skip_icp_refinement), min(source.capacity, SOURCE_COMPACT_CAP),
        min(target.capacity, TARGET_COMPACT_CAP))
    c = Constraint(source_submap_idx=source_idx, target_submap_idx=target_idx,
                   source_to_target=np.eye(4), information_matrix=np.eye(6),
                   is_odometry_constraint=True,
                   is_information_matrix_valid=is_estimate_information_matrix)
    if pending_out is not None:
        pending_out.append((c, prefetch_to_host(*outputs)))
        return c
    return finalize_constraint(c, outputs)


def build_odometry_constraint(source_idx: int, target_idx: int, submaps,
                              pending_out: Optional[list] = None) -> Constraint:
    """``buildOdometryConstraint`` (``constraint_builders.cpp:33-41``)."""
    p = submaps.params
    vox = get_map_voxel_size(p.map_builder.map_voxel_size)
    return build_constraint(
        source_idx, target_idx, submaps, is_compute_overlap=True,
        icp_max_corr_distance=VOXEL_EXPANSION_ICP_CORR * vox,
        voxel_size_overlap=VOXEL_EXPANSION_OVERLAP * vox,
        is_estimate_information_matrix=True,
        is_skip_icp_refinement=not p.is_refine_odometry_constraints_between_submaps,
        pending_out=pending_out)


def _has_constraint(source_idx, target_idx, constraints: List[Constraint]) -> bool:
    return any(c.source_submap_idx == source_idx and c.target_submap_idx == target_idx
               for c in constraints)


def compute_odometry_constraints(submaps, constraints: List[Constraint],
                                 candidates=None, pending_out: Optional[list] = None):
    """Both overloads of ``computeOdometryConstraints``
    (``constraint_builders.cpp:92-118``); appends in place."""
    if candidates is not None:
        pairs = [(submaps.get_submap(c.submap_id).parent_id, c.submap_id)
                 for c in candidates if c.submap_id >= 1]
    else:
        active = submaps.get_active_submap().id
        pairs = [(submaps.get_submap(t).parent_id, t)
                 for t in range(1, submaps.get_num_submaps())]
        pairs = [(s, t) for s, t in pairs if s != active and t != active]
    for source, target in pairs:
        if not _has_constraint(source, target, constraints):
            constraints.append(build_odometry_constraint(
                source, target, submaps, pending_out=pending_out))
