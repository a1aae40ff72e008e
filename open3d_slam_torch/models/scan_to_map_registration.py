"""Scan-to-map registration: dual-crop preprocessing + ICP against a map patch.

Port of ``open3d_slam_tpu.models.scan_to_map_registration`` (reference
``ScanToMapRegistration.cpp:21-102``): the wide (map-builder crop) cloud is
the *merge* cloud, the narrow (scan-processing crop) cloud the *match*
cloud; the map patch is the active submap cropped at the current pose and
compacted in its packed-voxel order, so the target stays spatially coherent
for the kernel's tile skip.  The patch carries GICP covariances only when
the registration type is GeneralizedIcp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from open3d_slam_torch.models.cloud_registration import (
    CloudRegistrationStrategy, PreparedCloud, _prepare_target_fn)
from open3d_slam_torch.models.odometry import UniformScores, preprocess_chain
from open3d_slam_torch.models.submap import Submap
from open3d_slam_torch.ops import croppers
from open3d_slam_torch.ops.registration import RegistrationResult
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import to_device
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry


class ProcessedScans(NamedTuple):
    match: PointCloud
    merge: PointCloud


@telemetry.spanned("mapper.patch_prepare")
def _patch_prepare(map_cloud: PointCloud, cropper, pose_t: torch.Tensor,
                   cell: float, patch_capacity: int, with_covs: bool,
                   with_kernel_target: bool = False) -> PreparedCloud:
    """Crop the map patch at the pose -> compact -> registration target."""
    patch = map_cloud.with_(
        mask=map_cloud.mask & cropper.is_inside(map_cloud.points, pose_t))
    return _prepare_target_fn(pclib.compact_to(patch, patch_capacity), cell,
                              with_covs=with_covs, with_kernel_target=with_kernel_target)


class ScanToMapIcp:
    def __init__(self, params: MapperParameters, processed_capacity: int = 16384,
                 patch_capacity: int = 65536, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.processed_capacity = processed_capacity
        self.patch_capacity = patch_capacity
        self.registration = CloudRegistrationStrategy(
            params.scan_matcher.scan_to_map_reg_type, params.scan_matcher.icp)
        self.map_builder_cropper = croppers.from_cropper_params(params.map_builder.cropper)
        self.scan_matcher_cropper = croppers.from_cropper_params(params.scan_processing.cropper)
        self.draw_scores = UniformScores(1, self.device)

    def preprocess(self, cloud: PointCloud) -> PointCloud:
        """``ScanToMapIcp::preprocess`` (``ScanToMapRegistration.cpp:35-41``)."""
        sp = self.params.scan_processing
        ratio = sp.down_sampling_ratio
        n_keep = int(round(self.processed_capacity * ratio)) if ratio < 1.0 else 0
        icp = self.params.scan_matcher.icp
        return preprocess_chain(
            cloud, self.map_builder_cropper, float(icp.max_distance_knn),
            self.draw_scores, voxel_size=sp.voxel_size,
            out_capacity=self.processed_capacity, n_keep=n_keep,
            keep_capacity=pclib.padded_capacity(max(n_keep, 1)),
            needs_normals=self.registration.needs_normals(), max_nn=icp.knn)

    def process_for_scan_matching_and_merging(self, cloud: PointCloud,
                                              map_to_range_sensor: np.ndarray) -> ProcessedScans:
        """(``ScanToMapRegistration.cpp:42-54``): wide = merge, narrow = match."""
        wide = self.preprocess(cloud)
        return ProcessedScans(match=self.scan_matcher_cropper.crop(wide), merge=wide)

    def scan_to_map_registration(self, scan: PointCloud, active_submap: Submap,
                                 map_to_range_sensor: np.ndarray,
                                 initial_guess) -> RegistrationResult:
        """(``ScanToMapRegistration.cpp:55-62``): crop the map patch at the
        current pose, register the scan against it."""
        pose_t = to_device(np.asarray(map_to_range_sensor)[:3, 3], self.device)
        cell = max(self.params.scan_matcher.icp.max_correspondence_distance, 1e-6)
        prepared = _patch_prepare(active_submap.map_cloud, self.scan_matcher_cropper,
                                  pose_t, cell, self.patch_capacity,
                                  self.registration.reg_type == "GeneralizedIcp",
                                  self.registration.needs_kernel_target())
        if not torch.is_tensor(initial_guess):
            initial_guess = to_device(initial_guess, self.device)
        return self.registration.register(scan, prepared,
                                          initial_guess.to(torch.float32))

    def is_merge_scan_valid(self, pc: PointCloud) -> bool:
        """(``ScanToMapRegistration.cpp:64-80``): a merged cloud needs normals
        unless the registration is point-to-point."""
        if self.params.scan_matcher.scan_to_map_reg_type == "PointToPointIcp":
            return True
        return pc.normals is not None

    def prepare_initial_map(self, pc: PointCloud) -> PointCloud:
        """(``ScanToMapRegistration.cpp:81-84``): normals for a loaded map."""
        return self.registration.estimate_normals_if_needed(pc)


def scan_to_map_registration_factory(params: MapperParameters,
                                     processed_capacity: int = 16384,
                                     patch_capacity: int = 65536,
                                     device="cuda") -> ScanToMapIcp:
    return ScanToMapIcp(params, processed_capacity, patch_capacity, device)
