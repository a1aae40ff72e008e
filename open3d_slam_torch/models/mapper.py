"""Mapper: scan-to-map refinement + map insertion.

Port of ``open3d_slam_tpu.models.mapper`` (reference ``Mapper.cpp:30-223``):
odometry motion prediction, scan-to-map GICP against the active submap
patch, the fitness gate (``Mapper.cpp:151-156``), the min-movement gate
before merging (``Mapper.cpp:170-176``).  Dispatch and finalize are split:
dispatch queues the device work and returns a ``MapperPending``; finalize
makes the ONE blocking device->host pull of the step (the queued odometry
results together with the scan-to-map scalars), then runs the host gates and
the submap insert.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from open3d_slam_torch.models.buffers import TransformInterpolationBuffer
from open3d_slam_torch.models.scan_to_map_registration import (
    ScanToMapIcp, scan_to_map_registration_factory)
from open3d_slam_torch.models.submap_collection import SubmapCollection
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry


class MapperPending:
    """Device-side state of one dispatched-but-unfinalized mapping step."""
    __slots__ = ("timestamp", "raw_scan", "processed", "result", "odom_pending")

    def __init__(self, timestamp, raw_scan, processed, result, odom_pending):
        self.timestamp = timestamp
        self.raw_scan = raw_scan
        self.processed = processed
        self.result = result
        self.odom_pending = odom_pending


class Mapper:
    def __init__(self, params: MapperParameters,
                 odom_to_range_sensor_buffer: TransformInterpolationBuffer,
                 submaps: SubmapCollection, processed_capacity: int = 16384,
                 patch_capacity: int = 65536, buffer_size_limit: int = 2000,
                 device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.odom_to_range_sensor_buffer = odom_to_range_sensor_buffer
        self.submaps = submaps
        self.scan_to_map_reg: ScanToMapIcp = scan_to_map_registration_factory(
            params, processed_capacity, patch_capacity, device=self.device)
        self.map_to_range_sensor = np.eye(4)
        self.map_to_range_sensor_prev = np.eye(4)
        self.map_to_range_sensor_last_scan_insertion = np.eye(4)
        self.map_to_range_sensor_buffer = TransformInterpolationBuffer(buffer_size_limit)
        self.last_measurement_timestamp: Optional[float] = None
        self.is_new_initial_value_set = False
        self.is_ignore_odometry_prediction = False
        self.preprocessed_scan: Optional[PointCloud] = None
        self.n_refinement_skips = 0
        self.n_merge_skips_min_movement = 0

    def loop_closure_update(self, correction: np.ndarray):
        """``loopClosureUpdate`` (``Mapper.cpp:44-47``)."""
        c = np.asarray(correction, np.float64)
        self.map_to_range_sensor = c @ self.map_to_range_sensor
        self.map_to_range_sensor_prev = c @ self.map_to_range_sensor_prev

    def get_assembled_map_point_cloud(self) -> dict:
        """All submap clouds concatenated (``getAssembledMapPointCloud``,
        ``Mapper.cpp:183-208``) as numpy arrays."""
        parts = [pclib.to_numpy(s.map_cloud) for s in self.submaps.submaps]
        parts = [d for d in parts if d["points"].shape[0] > 0]
        if not parts:
            return {"points": np.zeros((0, 3), np.float32)}
        return {k: np.concatenate([d[k] for d in parts if k in d], axis=0)
                for k in parts[0]}

    def set_map_to_range_sensor(self, T: np.ndarray):
        self.map_to_range_sensor = np.asarray(T, np.float64)

    def has_processed_measurements(self) -> bool:
        return not self.map_to_range_sensor_buffer.empty()

    def get_map_to_range_sensor(self, t: float) -> np.ndarray:
        return self.map_to_range_sensor_buffer.lookup_clamped(t)

    def get_map_to_odom(self, t: float) -> np.ndarray:
        """``getMapToOdom`` (``Mapper.cpp:58-63``)."""
        odom = self.odom_to_range_sensor_buffer.lookup_clamped(t)
        return self.map_to_range_sensor_buffer.lookup_clamped(t) @ np.linalg.inv(odom)

    def get_active_submap(self):
        return self.submaps.get_active_submap()

    def set_map_to_range_sensor_initial(self, T: np.ndarray):
        """``setMapToRangeSensorInitial`` (``Mapper.cpp:88-92``)."""
        T = np.asarray(T, np.float64)
        self.map_to_range_sensor_prev = T.copy()
        self.map_to_range_sensor = T.copy()
        self.is_new_initial_value_set = True

    @telemetry.spanned("mapper.preprocess")
    def preprocess_scan(self, raw_scan: PointCloud):
        """Pose-independent preprocessing (phase A of the mapping dispatch),
        ``ScanToMapRegistration.cpp:42-54``."""
        return self.scan_to_map_reg.process_for_scan_matching_and_merging(
            raw_scan, self.map_to_range_sensor)

    @telemetry.spanned("mapper.dispatch")
    def dispatch_range_measurement(self, raw_scan: PointCloud, timestamp: float,
                                   odom_pending=None, processed=None):
        """``addRangeMeasurement`` (``Mapper.cpp:101-181``), dispatch half.
        Returns ``(pending, ok)``; ``pending`` is None when a synchronous path
        (first scan, out-of-order drop, fresh initial value) handled it."""
        p = self.params
        self.submaps.set_map_to_range_sensor(self.map_to_range_sensor)

        def _finalize_odom():
            if odom_pending is not None:
                odom_pending.owner.finalize_pending(upto=odom_pending.timestamp)

        if self.submaps.get_active_submap().is_empty():
            _finalize_odom()
            if p.is_use_initial_map:
                if not self.scan_to_map_reg.is_merge_scan_valid(raw_scan):
                    raise ValueError("initial map invalid: this registration "
                                     "type needs normals")
                self.submaps.insert_scan(raw_scan, raw_scan, np.eye(4), timestamp)
            else:
                if processed is None:
                    processed = self.preprocess_scan(raw_scan)
                self.submaps.insert_scan(raw_scan, processed.merge, np.eye(4), timestamp)
                self.map_to_range_sensor_buffer.push(timestamp, self.map_to_range_sensor)
            return None, True

        if (self.last_measurement_timestamp is not None and
                timestamp < self.last_measurement_timestamp):
            _finalize_odom()
            print("MAPPER WARNING: measurements came out of order!")
            return None, False

        want_prediction = (not self.is_new_initial_value_set and
                           not self.is_ignore_odometry_prediction and
                           self.last_measurement_timestamp is not None)
        if odom_pending is not None and want_prediction:
            # Device-side prediction map_prev @ inv(odom_prev) @ odom_now,
            # falling back to map_prev when this scan's odometry failed.
            odom_prev = self.odom_to_range_sensor_buffer.lookup_clamped(
                self.last_measurement_timestamp)
            M = to_device(self.map_to_range_sensor_prev @ np.linalg.inv(odom_prev),
                          self.device)
            prev32 = to_device(self.map_to_range_sensor_prev, self.device)
            estimate = torch.where(odom_pending.ok, M @ odom_pending.cum_new, prev32)
        else:
            is_odom_okay = (odom_pending is not None or
                            self.odom_to_range_sensor_buffer.has(timestamp))
            estimate = self.map_to_range_sensor_prev.copy()
            if is_odom_okay and want_prediction and odom_pending is None:
                odom_now = self.odom_to_range_sensor_buffer.lookup_clamped(timestamp)
                odom_prev = self.odom_to_range_sensor_buffer.lookup_clamped(
                    self.last_measurement_timestamp)
                estimate = self.map_to_range_sensor_prev @ (
                    np.linalg.inv(odom_prev) @ odom_now)
        self.is_ignore_odometry_prediction = False

        if processed is None:
            processed = self.preprocess_scan(raw_scan)
        result = self.scan_to_map_reg.scan_to_map_registration(
            processed.match, self.submaps.get_active_submap(),
            self.map_to_range_sensor, estimate)
        self.preprocessed_scan = processed.match

        if self.is_new_initial_value_set:
            _finalize_odom()
            self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
            self.map_to_range_sensor_buffer.push(timestamp, self.map_to_range_sensor)
            self.is_new_initial_value_set = False
            self.is_ignore_odometry_prediction = True
            return None, True
        return MapperPending(timestamp, raw_scan, processed, result, odom_pending), True

    @telemetry.spanned("mapper.finalize")
    def finalize_range_measurement(self, mp: MapperPending) -> bool:
        """Finalize half: the ONE blocking device->host pull per scan, then
        the host gates and the submap insert (``Mapper.cpp:151-181``)."""
        p = self.params
        timestamp, result, odom_pending = mp.timestamp, mp.result, mp.odom_pending
        if odom_pending is not None:
            owner = odom_pending.owner
            # Only pendings up to THIS measurement: the next scan's odometry
            # may already be in flight.
            pend = [q for q in owner._pending if q.timestamp <= odom_pending.timestamp]
            flat = to_host(*[t for q in pend for t in (q.fitness, q.rmse, q.T)],
                           result.fitness, result.transformation)
            owner.finalize_pending([flat[3 * i:3 * i + 3] for i in range(len(pend))],
                                   upto=odom_pending.timestamp)
            if not self.odom_to_range_sensor_buffer.has(timestamp):
                print("WARNING: odom buffer does not have the desired "
                      "transform; scan-to-map refinement attempted anyway")
            fitness, result_T = flat[-2], flat[-1]
        else:
            fitness, result_T = to_host(result.fitness, result.transformation)
        fitness = float(fitness)
        if (not p.is_ignore_min_refinement_fitness and
                fitness < p.scan_matcher.min_refinement_fitness):
            self.n_refinement_skips += 1
            print(f"Skipping the refinement step, fitness: {fitness:.3f}")
            return False

        self.map_to_range_sensor = np.asarray(result_T, np.float64)
        self.map_to_range_sensor_buffer.push(timestamp, self.map_to_range_sensor)
        self.submaps.set_map_to_range_sensor(self.map_to_range_sensor)
        if p.is_use_initial_map and not p.is_merge_scans_into_map:
            self.last_measurement_timestamp = timestamp
            self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
            return True
        motion = np.linalg.inv(self.map_to_range_sensor_last_scan_insertion) @ \
            self.map_to_range_sensor
        if np.linalg.norm(motion[:3, 3]) >= p.min_movement_between_mapping_steps:
            self.submaps.insert_scan(mp.raw_scan, mp.processed.merge,
                                     self.map_to_range_sensor, timestamp)
            self.map_to_range_sensor_last_scan_insertion = self.map_to_range_sensor.copy()
        else:
            self.n_merge_skips_min_movement += 1
        self.last_measurement_timestamp = timestamp
        self.map_to_range_sensor_prev = self.map_to_range_sensor.copy()
        return True

    def add_range_measurement(self, raw_scan: PointCloud, timestamp: float,
                              odom_pending=None) -> bool:
        """``addRangeMeasurement`` (``Mapper.cpp:101-181``), blocking form:
        dispatch, then finalize at once."""
        mp, ok = self.dispatch_range_measurement(raw_scan, timestamp,
                                                 odom_pending=odom_pending)
        return ok if mp is None else self.finalize_range_measurement(mp)
