"""Submap: one radius-bounded local map.

Port of the main-path parts of ``open3d_slam_tpu.models.submap`` (reference
``Submap.cpp:27-259``): the sparse ``map_cloud`` grown by scan insertion
(carve every N scans, then re-merge by voxel inside the cropping volume),
the rigid ``transform`` and ``compute_submap_center``.  The dense map and
the place-recognition features arrive with later slices of the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from open3d_slam_torch.ops import carving, croppers, sorted_store, voxel
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud


def _ensure_normals(pc: PointCloud) -> PointCloud:
    if pc.normals is None:
        return pc.with_(normals=torch.zeros_like(pc.points))
    return pc


class Submap:
    def __init__(self, submap_id: int, parent_id: int, params: MapperParameters,
                 map_capacity: int = 262144, device="cuda"):
        self.id = submap_id
        self.parent_id = parent_id
        self.params = params
        self.device = torch.device(device)
        self.map_capacity = map_capacity
        self.map_cloud: PointCloud = pclib.empty(map_capacity, with_normals=True,
                                                 device=self.device)
        self.map_builder_cropper = croppers.from_cropper_params(params.map_builder.cropper)
        self.map_to_submap = np.eye(4)
        self.map_to_range_sensor = np.eye(4)
        self.submap_center: Optional[np.ndarray] = None
        self.n_scans_inserted_map = 0
        self.creation_time: Optional[float] = None

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

    def transform(self, T: np.ndarray):
        """Rigidly move the whole submap (``Submap.cpp:94-107``)."""
        Tj = to_device(T, self.device)
        self.map_cloud = self.map_cloud.with_(
            points=se3.transform_points(Tj, self.map_cloud.points),
            normals=(None if self.map_cloud.normals is None
                     else se3.rotate_vectors(Tj, self.map_cloud.normals)))
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
