"""Submap collection: active-submap lifecycle and the overlap-scan buffer.

Port of ``open3d_slam_tpu.models.submap_collection`` (reference
``SubmapCollection.cpp:28-364``): scan insertion with the active-submap
switch by radius / adjacency / occupancy-fitness revisit, the dense-map
insert into the active submap, the
overlap-scan buffer replayed into a newly activated submap, the
finished-submap and loop-closure-candidate queues,
``force_new_submap_creation``, feature computation for finished submaps
(``computeFeatures``, :219-243), the adjacency update after a loop closure
and the pose-graph ``transform`` with parent chaining for submaps the graph
does not hold (:284-335).
"""
from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from open3d_slam_torch.models.adjacency import AdjacencyMatrix
from open3d_slam_torch.models.submap import Submap
from open3d_slam_torch.ops.voxel import INT32_MAX, pack_coords, voxel_coords
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry

VOXEL_EXPANSION_ADJACENCY_REVISITING = 2.5  # magic.hpp:15


class TimestampedSubmapId(NamedTuple):
    submap_id: int
    time: float


class OptimizedTransform(NamedTuple):
    submap_id: int
    dT: np.ndarray


class ScanTimeTransform(NamedTuple):
    cloud: PointCloud
    timestamp: float
    map_to_range_sensor: np.ndarray


def _occupancy_fitness(map_points: torch.Tensor, map_mask: torch.Tensor,
                       scan: PointCloud, T: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Fraction of scan points landing in occupied voxels of the map, by
    exact packed-key membership (``isSwitchingSubmapsConsistant``,
    ``SubmapCollection.cpp:352-364``)."""
    map_coords = voxel_coords(map_points, cell_size)
    base = torch.min(torch.where(map_mask[:, None], map_coords,
                                 torch.full_like(map_coords, 2 ** 30)), dim=0).values
    keys = torch.where(map_mask, pack_coords(map_coords, base),
                       torch.full_like(map_coords[:, 0], INT32_MAX))
    keys_sorted = torch.sort(keys).values
    qk = pack_coords(voxel_coords(se3.transform_points(T, scan.points), cell_size), base)
    pos = torch.clamp(torch.searchsorted(keys_sorted, qk, side="left"),
                      0, keys_sorted.shape[0] - 1)
    hit = (keys_sorted[pos] == qk) & (qk >= 0) & scan.mask
    n = torch.clamp(scan.mask.to(torch.float32).sum(), min=1.0)
    return hit.to(torch.float32).sum() / n


class SubmapCollection:
    def __init__(self, params: MapperParameters, map_capacity: int = 262144,
                 dense_capacity: int = 262144, feature_capacity: int = 8192,
                 device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.map_capacity = map_capacity
        self.dense_capacity = dense_capacity
        self.feature_capacity = feature_capacity
        self.submaps: List[Submap] = []
        self.adjacency = AdjacencyMatrix()
        self.active_submap_idx = 0
        self._submap_id_counter = 0
        self.num_scans_merged_in_active_submap = 0
        self.map_to_range_sensor = np.eye(4)
        self.timestamp: Optional[float] = None
        self.overlap_scans_buffer: deque = deque(
            maxlen=max(1, params.submaps.num_scans_overlap))
        self.finished_submaps_idxs: List[TimestampedSubmapId] = []
        self.loop_closure_candidates_idxs: List[TimestampedSubmapId] = []
        self.last_finished_submap_idx: Optional[int] = None
        self._force_new_submap = False
        self.create_new_submap(self.map_to_range_sensor)

    def is_empty(self) -> bool:
        return not self.submaps

    def get_num_submaps(self) -> int:
        return len(self.submaps)

    def get_active_submap(self) -> Submap:
        return self.submaps[self.active_submap_idx]

    def get_submap(self, idx: int) -> Submap:
        return self.submaps[idx]

    def pop_finished_submap_ids(self) -> List[TimestampedSubmapId]:
        out, self.finished_submaps_idxs = self.finished_submaps_idxs, []
        return out

    def pop_loop_closure_candidates(self) -> List[TimestampedSubmapId]:
        out, self.loop_closure_candidates_idxs = self.loop_closure_candidates_idxs, []
        return out

    def get_total_num_points(self) -> int:
        if not self.submaps:
            return 0
        counts = to_host(*[s.map_cloud.count() for s in self.submaps])
        return int(sum(int(c) for c in counts))

    def set_map_to_range_sensor(self, T: np.ndarray):
        self.map_to_range_sensor = np.asarray(T, np.float64)

    def create_new_submap(self, map_to_submap: np.ndarray):
        submap_id = self._submap_id_counter
        self._submap_id_counter += 1
        s = Submap(submap_id, self.active_submap_idx, self.params,
                   map_capacity=self.map_capacity, dense_capacity=self.dense_capacity,
                   feature_capacity=self.feature_capacity, device=self.device)
        s.map_to_submap = np.asarray(map_to_submap, np.float64).copy()
        self.submaps.append(s)
        self.active_submap_idx = len(self.submaps) - 1
        self.num_scans_merged_in_active_submap = 0

    def find_closest_submap(self, map_to_range_sensor: np.ndarray) -> int:
        p0 = map_to_range_sensor[:3, 3]
        return int(np.argmin([np.linalg.norm(p0 - s.get_map_to_submap_center())
                              for s in self.submaps]))

    def is_switching_submaps_consistent(self, scan: PointCloud, candidate_idx: int,
                                        map_to_range_sensor: np.ndarray) -> bool:
        cell = VOXEL_EXPANSION_ADJACENCY_REVISITING * max(
            self.params.map_builder.map_voxel_size, 0.04)
        cand = self.submaps[candidate_idx]
        fit = _occupancy_fitness(cand.map_cloud.points, cand.map_cloud.mask, scan,
                                 to_device(map_to_range_sensor, self.device), cell)
        fitness = float(to_host(fit)[0])
        return fitness > self.params.submaps.adjacency_based_revisiting_min_fitness

    def update_active_submap(self, map_to_range_sensor: np.ndarray, scan: PointCloud):
        """``updateActiveSubmap`` (``SubmapCollection.cpp:94-131``)."""
        if self._force_new_submap:
            self.create_new_submap(self.map_to_range_sensor)
            self._force_new_submap = False
            return
        if self.num_scans_merged_in_active_submap < self.params.submaps.min_num_range_data:
            return
        if self.params.is_use_initial_map:
            return
        closest_idx = self.find_closest_submap(self.map_to_range_sensor)
        closest = self.submaps[closest_idx]
        active = self.submaps[self.active_submap_idx]
        d = np.linalg.norm(self.map_to_range_sensor[:3, 3] - closest.get_map_to_submap_center())
        if d < self.params.submaps.radius:
            if closest_idx == self.active_submap_idx:
                return
            if (self.adjacency.is_adjacent(closest.id, active.id) and
                    self.is_switching_submaps_consistent(scan, closest_idx,
                                                         map_to_range_sensor)):
                self.active_submap_idx = closest_idx
            else:
                d_active = np.linalg.norm(self.map_to_range_sensor[:3, 3] -
                                          active.get_map_to_submap_center())
                if d_active > self.params.submaps.radius:
                    self.create_new_submap(self.map_to_range_sensor)
        else:
            self.create_new_submap(self.map_to_range_sensor)

    @telemetry.spanned("submap.insert")
    def insert_scan(self, raw_scan: PointCloud, preprocessed_scan: PointCloud,
                    map_to_range_sensor: np.ndarray, timestamp: float) -> bool:
        """``insertScan`` (``SubmapCollection.cpp:172-207``)."""
        self.map_to_range_sensor = np.asarray(map_to_range_sensor, np.float64)
        self.timestamp = timestamp
        if not self.submaps:
            self.create_new_submap(self.map_to_range_sensor)
        if self.submaps[self.active_submap_idx].is_empty() and len(self.submaps) == 1:
            self.submaps[self.active_submap_idx].insert_scan(
                raw_scan, preprocessed_scan, map_to_range_sensor, timestamp, True)
            self.num_scans_merged_in_active_submap += 1
            return True
        self.overlap_scans_buffer.append(ScanTimeTransform(
            preprocessed_scan, timestamp, self.map_to_range_sensor.copy()))
        prev_active = self.active_submap_idx
        self.update_active_submap(map_to_range_sensor, preprocessed_scan)
        if prev_active != self.active_submap_idx:
            self.submaps[prev_active].insert_scan(
                raw_scan, preprocessed_scan, map_to_range_sensor, timestamp, True)
            self.submaps[prev_active].compute_submap_center()
            self.last_finished_submap_idx = prev_active
            self.finished_submaps_idxs.append(TimestampedSubmapId(prev_active, timestamp))
            self.num_scans_merged_in_active_submap = 0
            self.adjacency.add_edge(self.submaps[prev_active].id,
                                    self.submaps[self.active_submap_idx].id)
            while self.overlap_scans_buffer:
                s = self.overlap_scans_buffer.popleft()
                self.submaps[self.active_submap_idx].insert_scan(
                    s.cloud, s.cloud, s.map_to_range_sensor, s.timestamp, False)
        else:
            self.submaps[self.active_submap_idx].insert_scan(
                raw_scan, preprocessed_scan, map_to_range_sensor, timestamp, True)
        self.num_scans_merged_in_active_submap += 1
        return True

    def insert_scan_dense_map(self, raw_scan: PointCloud,
                              map_to_range_sensor: np.ndarray, timestamp: float):
        self.submaps[self.active_submap_idx].insert_scan_dense_map(
            raw_scan, map_to_range_sensor, timestamp, True)

    def force_new_submap_creation(self):
        """``forceNewSubmapCreation`` (``SubmapCollection.cpp:163-170``):
        insert an EMPTY cloud so the switch bookkeeping runs without
        double-inserting any data."""
        if not self.submaps or self.timestamp is None:
            return
        self._force_new_submap = True
        if self.overlap_scans_buffer:
            template = self.overlap_scans_buffer[-1].cloud
            empty_scan = template.with_(mask=torch.zeros_like(template.mask))
        else:
            empty_scan = pclib.empty(8, with_normals=True, device=self.device)
        self.insert_scan(empty_scan, empty_scan, self.map_to_range_sensor, self.timestamp)
        self._force_new_submap = False

    def compute_features(self, finished_ids: List[TimestampedSubmapId]):
        """``computeFeatures`` (``SubmapCollection.cpp:219-243``): features of
        each finished submap, which then becomes a loop-closure candidate."""
        for tid in finished_ids:
            self.submaps[tid.submap_id].compute_features()
            self.loop_closure_candidates_idxs.append(tid)

    def update_adjacency_matrix(self, loop_closure_constraints):
        for c in loop_closure_constraints:
            self.adjacency.add_edge(c.source_submap_idx, c.target_submap_idx)
            self.adjacency.mark_as_loop_closure_submap(c.source_submap_idx)
            self.adjacency.mark_as_loop_closure_submap(c.target_submap_idx)

    def transform(self, transform_increments: List[OptimizedTransform]):
        """Apply the optimised pose-graph increments; a submap the graph does
        not hold follows its nearest optimised ancestor
        (``SubmapCollection.cpp:284-335``)."""
        optimized = set()
        by_id = {u.submap_id: u for u in transform_increments}
        for u in transform_increments:
            if u.submap_id < len(self.submaps):
                self.submaps[u.submap_id].transform(u.dT)
                optimized.add(u.submap_id)
        to_update = [i for i in range(len(self.submaps)) if i not in optimized]
        to_update_set = set(to_update)
        for idx in to_update:
            if not transform_increments:
                break
            current = idx
            while True:
                parent = self.submaps[current].parent_id
                if parent not in to_update_set:
                    if parent in by_id:
                        self.submaps[idx].transform(by_id[parent].dT)
                    break
                if parent == current:
                    raise RuntimeError("parent chain loop")
                current = parent
        self.overlap_scans_buffer.clear()
