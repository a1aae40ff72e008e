"""Submap: one radius-bounded local map.

Port of ``open3d_slam_tpu.models.submap`` (reference
``Submap.cpp:27-259``): the sparse ``map_cloud`` grown by scan insertion
(carve every N scans, then re-merge by voxel inside the cropping volume),
the dense map (``insert_scan_dense_map``: the raw scan cropped, merged into
a ``dense_map.VoxelizedPointCloud`` and carved every N scans), the rigid
``transform``, ``compute_submap_center`` and the place-recognition features
(``compute_features``: a 0.5 m-voxel cloud, its normals through kernel K2,
and FPFH).

The dense store is allocated when the submap is created, at
``dense_capacity`` voxels, when the configuration builds a dense map
(``mapper.is_build_dense_map``); otherwise the submap holds none.
"""
from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from open3d_slam_torch.ops import carving, croppers, dense_map, fpfh as fpfh_ops
from open3d_slam_torch.ops import normals as normals_ops, sorted_store, voxel
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import prefetch_to_host, to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud


def _ensure_normals(pc: PointCloud) -> PointCloud:
    if pc.normals is None:
        return pc.with_(normals=torch.zeros_like(pc.points))
    return pc


class Submap:
    def __init__(self, submap_id: int, parent_id: int, params: MapperParameters,
                 map_capacity: int = 262144, dense_capacity: int = 262144,
                 feature_capacity: int = 8192, device="cuda"):
        self.id = submap_id
        self.parent_id = parent_id
        self.params = params
        self.device = torch.device(device)
        self.map_capacity = map_capacity
        self.feature_capacity = feature_capacity
        self.map_cloud: PointCloud = pclib.empty(map_capacity, with_normals=True,
                                                 device=self.device)
        self.map_builder_cropper = croppers.from_cropper_params(params.map_builder.cropper)
        self.dense_map: Optional[dense_map.VoxelizedPointCloud] = (
            dense_map.empty(dense_capacity,
                            max(params.dense_map_builder.map_voxel_size, 1e-3),
                            device=self.device)
            if params.is_build_dense_map else None)
        self.dense_map_cropper = croppers.from_cropper_params(params.dense_map_builder.cropper)
        # ColorRangeCropper on the dense map's input (Submap.cpp:80).
        self.color_cropper = croppers.ColorRangeCropper()
        self.map_to_submap = np.eye(4)
        self.map_to_range_sensor = np.eye(4)
        self.submap_center: Optional[np.ndarray] = None
        self.n_scans_inserted_map = 0
        self.n_scans_inserted_dense = 0
        self.creation_time: Optional[float] = None
        self.feature_cloud: Optional[PointCloud] = None
        self.fpfh: Optional[torch.Tensor] = None
        self._feature_time: Optional[float] = None
        self._pending_feat_count = None   # prefetched saturation check

    def is_empty(self) -> bool:
        return self.n_scans_inserted_map == 0

    def insert_scan(self, raw_scan: PointCloud, preprocessed_scan: PointCloud,
                    map_to_range_sensor: np.ndarray, timestamp: float,
                    is_perform_carving: bool = True) -> bool:
        """``Submap::insertScan`` (``Submap.cpp:39-75``): carve on the
        cadence, then the fused voxel-key merge."""
        p = self.params
        self.map_to_range_sensor = np.asarray(map_to_range_sensor, np.float64)
        T = to_device(self.map_to_range_sensor, self.device)
        if p.is_use_initial_map and self.n_scans_inserted_map == 0:
            # A loaded map is held whole, at its own capacity if larger.
            self.map_capacity = max(self.map_capacity, preprocessed_scan.capacity)
            down = voxel.voxel_downsample(preprocessed_scan, p.map_builder.map_voxel_size,
                                          out_capacity=self.map_capacity)
            self.map_cloud = _ensure_normals(down)
            self.n_scans_inserted_map += 1
            return True
        cv = p.map_builder.carving
        carve_due = (is_perform_carving and self.n_scans_inserted_map > 0 and
                     self.n_scans_inserted_map % cv.carve_space_every_n_scans == 1)
        map_cloud = _ensure_normals(self.map_cloud)
        scan = _ensure_normals(preprocessed_scan)
        if carve_due:
            max_steps = int(np.ceil(cv.max_raytracing_length / max(cv.voxel_size, 1e-3))) + 1
            scan_in_map = scan.with_(points=se3.transform_points(T, scan.points),
                                     normals=se3.rotate_vectors(T, scan.normals))
            keep = carving.carve_mask(map_cloud, scan_in_map, T[:3, 3], cv.voxel_size,
                                      cv.truncation_distance, cv.max_raytracing_length,
                                      cv.min_dot_product_with_normal, max_steps=max_steps)
            map_cloud = map_cloud.with_(mask=keep)
        enable = torch.ones((), dtype=torch.bool, device=self.device)
        self.map_cloud = sorted_store.insert_scan_fused(
            map_cloud, scan, T, self.map_builder_cropper,
            p.map_builder.map_voxel_size, enable)
        self.n_scans_inserted_map += 1
        return True

    def insert_scan_dense_map(self, raw_scan: PointCloud,
                              map_to_range_sensor: np.ndarray, timestamp: float,
                              is_perform_carving: bool = True) -> bool:
        """``Submap::insertScanDenseMap`` (``Submap.cpp:77-92``): crop the raw
        scan (radius, then colour), merge it in the map frame, and every N
        scans carve the voxels its rays pass through.  The cadence is the
        host's counter and ``voxel_size`` a Python float, so nothing here
        waits on the device."""
        p = self.params
        T = to_device(map_to_range_sensor, self.device)
        cropped = self.color_cropper.crop(self.dense_map_cropper.crop(raw_scan))
        self.dense_map = dense_map.insert(
            self.dense_map, cropped.with_(points=se3.transform_points(T, cropped.points)))
        cv = p.dense_map_builder.carving
        carve_due = (is_perform_carving and self.n_scans_inserted_dense > 0 and
                     self.n_scans_inserted_dense % cv.carve_space_every_n_scans == 1)
        if carve_due:
            voxel_size = self.dense_map.voxel_size
            dedup = voxel.remove_duplicate_points_in_voxels(raw_scan, voxel_size)
            scan_in_map = dedup.with_(points=se3.transform_points(T, dedup.points))
            step = 2.0 * cv.neighborhood_radius_dense_map
            max_steps = int(np.ceil(cv.max_raytracing_length / max(step, 1e-3))) + 1
            keys, base = carving.carved_voxel_keys(
                scan_in_map, T[:3, 3], voxel_size, cv.neighborhood_radius_dense_map,
                cv.truncation_distance, cv.max_raytracing_length, max_steps=max_steps)
            self.dense_map = dense_map.remove_keys(
                self.dense_map, keys, base,
                neighbor_deltas=carving.face_neighbor_deltas(self.device))
        self.n_scans_inserted_dense += 1
        return True

    def transform(self, T: np.ndarray):
        """Rigidly move the whole submap (``Submap.cpp:94-107``)."""
        Tj = to_device(T, self.device)
        self.map_cloud = self.map_cloud.with_(
            points=se3.transform_points(Tj, self.map_cloud.points),
            normals=(None if self.map_cloud.normals is None
                     else se3.rotate_vectors(Tj, self.map_cloud.normals)))
        if self.dense_map is not None:
            self.dense_map = dense_map.transform(self.dense_map, Tj)
        if self.feature_cloud is not None:
            self.feature_cloud = self.feature_cloud.with_(
                points=se3.transform_points(Tj, self.feature_cloud.points),
                normals=(None if self.feature_cloud.normals is None
                         else se3.rotate_vectors(Tj, self.feature_cloud.normals)))
        T64 = np.asarray(T, np.float64)
        self.map_to_range_sensor = self.map_to_range_sensor @ T64
        self.map_to_submap = T64 @ self.map_to_submap
        if self.submap_center is not None:
            self.submap_center = T64[:3, :3] @ self.submap_center + T64[:3, 3]

    def get_map_to_submap_center(self) -> np.ndarray:
        if self.submap_center is not None:
            return self.submap_center
        return self.map_to_submap[:3, 3]

    def compute_submap_center(self):
        """Mean of the valid map points (one counted pull, on a submap switch)."""
        mc = self.map_cloud
        n = torch.clamp(mc.count().to(torch.float32), min=1.0)
        center = torch.where(mc.mask[:, None], mc.points,
                             torch.zeros((), device=mc.device)).sum(dim=0) / n
        self.submap_center = to_host(center)[0].astype(np.float64)

    def _check_pending_feature_saturation(self):
        if self._pending_feat_count is None:
            return
        n_feat = int(to_host(self._pending_feat_count)[0])   # prefetched
        self._pending_feat_count = None
        if n_feat >= self.feature_capacity:
            print(f"WARNING: submap {self.id} feature cloud saturated at "
                  f"{self.feature_capacity} voxels — raise "
                  f"CapacityParameters.feature_cloud or place-recognition "
                  f"quality degrades (uniform-stride subsample in effect)")

    def compute_features(self, force: bool = False):
        """0.5 m-voxel sparse cloud, its normals and FPFH
        (``computeFeatures``, ``Submap.cpp:228-248``), rate-limited like the
        reference.  The saturation check reads the voxel count copied at the
        previous feature event, so it never waits on the device."""
        p = self.params.place_recognition
        min_dt = self.params.submaps.min_seconds_between_feature_computation
        now = _time.monotonic()
        if (not force and self.fpfh is not None and self._feature_time is not None
                and now - self._feature_time < min_dt):
            return
        sparse = voxel.voxel_downsample(self.map_cloud, p.feature_voxel_size,
                                        out_capacity=self.feature_capacity)
        self._check_pending_feature_saturation()
        self._pending_feat_count = prefetch_to_host(sparse.count())
        sparse = normals_ops.estimate_normals(
            sparse, radius=p.normal_estimation_radius, max_nn=p.normal_knn,
            orientation_reference=torch.zeros(3, dtype=torch.float32, device=self.device))
        self.feature_cloud = sparse
        self.fpfh = fpfh_ops.compute_fpfh(sparse, p.feature_radius,
                                          max_nn=min(p.feature_knn, 64))
        self._feature_time = now
