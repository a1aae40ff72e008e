"""SlamWrapper: the end-to-end per-scan SLAM replay.

Port of the main path of ``open3d_slam_tpu.models.slam_wrapper`` (reference
``SlamWrapper.cpp:43-487``): ingest (NaN removal, out-of-order rejection),
the odometry stage, the mapping stage (scan-to-map registration, gates,
submap insert), pipelined replay with one scan in flight, and
``finish_processing``.  The reference's worker threads become a sequential,
deterministic host pipeline feeding the device.

Loop closure, the pose graph, the dense map and motion compensation arrive
with later slices of the port; a configuration that turns any of them on is
refused.  The wrapper runs on ``cuda`` unless the caller asks for another
device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from open3d_slam_torch.models.buffers import CircularBuffer
from open3d_slam_torch.models.mapper import Mapper
from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.submap_collection import SubmapCollection
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import SlamParameters
from open3d_slam_torch.utils.device import resolve_device
from open3d_slam_torch.utils.timeutil import TelemetryRegistry

_NOT_PORTED = {
    "mapper.is_attempt_loop_closures": "the loop-closure slice",
    "mapper.is_build_dense_map": "the dense-map slice",
    "motion_compensation.is_undistort_input_cloud": "the motion-compensation slice",
}


def _check_supported(p: SlamParameters):
    flags = {
        "mapper.is_attempt_loop_closures": p.mapper.is_attempt_loop_closures,
        "mapper.is_build_dense_map": p.mapper.is_build_dense_map,
        "motion_compensation.is_undistort_input_cloud":
            p.motion_compensation.is_undistort_input_cloud,
    }
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"{name} is set, but it is not ported yet: it arrives with "
                f"{_NOT_PORTED[name]} of the port (see ROADMAP.md); set it "
                "to false")


class TimestampedPointCloud:
    __slots__ = ("time", "cloud", "odom_pending")

    def __init__(self, time, cloud, odom_pending=None):
        self.time = time
        self.cloud = cloud
        self.odom_pending = odom_pending   # OdometryPending riding along


class SlamWrapper:
    def __init__(self, params: Optional[SlamParameters] = None, device=None):
        self.params = params or SlamParameters()
        p = self.params
        _check_supported(p)
        self.device = resolve_device(device)
        cap = p.capacities
        self.telemetry = TelemetryRegistry(
            enabled=p.mapper.is_print_timing_statistics, device=self.device)
        self.odometry = LidarOdometry(p.odometry,
                                      processed_capacity=cap.processed_scan,
                                      device=self.device)
        self.submaps = SubmapCollection(p.mapper, map_capacity=cap.submap_points,
                                        device=self.device)
        self.mapper = Mapper(p.mapper, self.odometry.odom_buffer, self.submaps,
                             processed_capacity=cap.processed_scan,
                             patch_capacity=cap.map_patch, device=self.device)
        self.odometry_buffer = CircularBuffer(max(1, p.odometry.odometry_buffer_size))
        self.mapping_buffer = CircularBuffer(max(1, p.mapper.mapping_buffer_size))
        self.latest_scan_to_map_refinement_time: Optional[float] = None
        self._raw_capacity = cap.raw_scan
        # in-flight pipelined mapping step: (MapperPending, measurement)
        self._map_pending = None

    # ------------------------------------------------------------------
    # Ingest (SlamWrapper::addRangeScan, :102-115)

    def add_range_scan(self, points: np.ndarray, timestamp: float,
                       colors: Optional[np.ndarray] = None) -> bool:
        """Ingest one scan (NaN rows dropped, out-of-order scans refused)."""
        finite = np.isfinite(points).all(axis=1)
        points = points[finite]
        if colors is not None:
            colors = np.asarray(colors, np.float32)[finite]
        back = self.odometry_buffer.peek_back()
        if back is not None and timestamp < back.time:
            print("you are trying to add a range scan out of order! Dropping!")
            return False
        cloud = pclib.from_numpy(points.astype(np.float32),
                                 capacity=self._raw_capacity, colors=colors,
                                 device=self.device)
        self.odometry_buffer.push(TimestampedPointCloud(timestamp, cloud))
        return True

    # ------------------------------------------------------------------
    # Stages

    def _odometry_step(self) -> bool:
        """odometryWorker body (:258-289), dispatch only: the results ride the
        measurement into the mapping stage and are pulled there together
        with the scan-to-map result."""
        measurement = self.odometry_buffer.pop()
        if measurement is None:
            return False
        with self.telemetry.timer("odometry", sampled=True):
            r = self.odometry.add_range_scan_async(measurement.cloud, measurement.time)
        measurement.odom_pending = None if isinstance(r, bool) else r
        if r is False:
            print(f"WARNING: odometry dropped scan at t={measurement.time}; "
                  "pose not updated for this scan")
        self.mapping_buffer.push(measurement)
        self.telemetry.maybe_print()
        return True

    def _mapping_step(self) -> bool:
        """mappingWorker body (:290-347): dispatch + immediate finalize."""
        flushed = self._flush_map_pending()
        measurement = self.mapping_buffer.pop()
        if measurement is None:
            return flushed
        with self.telemetry.timer("mapping", sampled=True):
            mp, _ = self.mapper.dispatch_range_measurement(
                measurement.cloud, measurement.time,
                odom_pending=measurement.odom_pending)
            if mp is not None:
                self.mapper.finalize_range_measurement(mp)
        self._after_mapping(measurement)
        return True

    def _after_mapping(self, measurement: TimestampedPointCloud):
        self.latest_scan_to_map_refinement_time = measurement.time
        self.telemetry.maybe_print()

    def _flush_map_pending(self) -> bool:
        """Finalize the in-flight pipelined mapping step, if any."""
        if self._map_pending is None:
            return False
        mp, measurement = self._map_pending
        self._map_pending = None
        with self.telemetry.timer("mapping", sampled=True):
            self.mapper.finalize_range_measurement(mp)
        self._after_mapping(measurement)
        return True

    # ------------------------------------------------------------------
    # Driving

    def process_queued(self) -> int:
        """Run stages until all queues drain; returns #scans processed."""
        n = 0
        while True:
            did_odo = self._odometry_step()
            did_map = self._mapping_step()
            if did_map:
                n += 1
            if not (did_odo or did_map):
                break
        return n

    def process_scan(self, points: np.ndarray, timestamp: float,
                     colors: Optional[np.ndarray] = None) -> bool:
        """Ingest + drain (sequential mode)."""
        if not self.add_range_scan(points, timestamp, colors=colors):
            return False
        return self.process_queued() > 0

    def process_scan_pipelined(self, points: np.ndarray, timestamp: float,
                               colors: Optional[np.ndarray] = None) -> bool:
        """Pipelined ingest, one scan in flight across stage boundaries.  Per
        call, in order:

          1. ingest scan t, queue its odometry on the device;
          2. queue scan t's pose-independent mapper preprocessing;
          3. finalize scan t-1's mapping (the one blocking pull of the step,
             made while the card runs 1 and 2);
          4. queue scan t's scan-to-map registration (after t-1's submap
             insert, so the map patch is current).

        Gate order, arithmetic and the random-downsample draws are those of
        the sequential mode, so both give the same trajectory.  Call
        ``finish_processing`` before reading trajectories or maps."""
        if not self.add_range_scan(points, timestamp, colors=colors):
            return False
        self._odometry_step()
        measurement = self.mapping_buffer.pop()
        if measurement is None:
            return True
        processed = None
        if not self.submaps.get_active_submap().is_empty():
            processed = self.mapper.preprocess_scan(measurement.cloud)
        self._flush_map_pending()
        mp, _ = self.mapper.dispatch_range_measurement(
            measurement.cloud, measurement.time,
            odom_pending=measurement.odom_pending, processed=processed)
        if mp is not None:
            self._map_pending = (mp, measurement)
        else:
            self._after_mapping(measurement)
        return True

    def finish_processing(self):
        """``finishProcessing`` (:126-166): drain, then close the active
        submap."""
        self.process_queued()
        self.odometry.finalize_pending()
        print("Finishing all submaps!")
        self.submaps.force_new_submap_creation()
        self.telemetry.maybe_print(force=True)
        print("All submaps finished!")

    def warmup(self, scans=None, timestamps=None):
        """Replay a few ``scans`` (e.g. the clouds the reference skips,
        ``magic::skipFirstNPointClouds``) through a scratch wrapper, so that
        kernel builds and library initialisation fall before the replay
        clock starts.  The wrapper's own state is not touched."""
        if not scans:
            return
        scratch = SlamWrapper(self.params, device=self.device)
        ts = (timestamps if timestamps is not None
              else [0.1 * i for i in range(len(scans))])
        for s, t in zip(scans, ts):
            scratch.process_scan_pipelined(np.asarray(s), float(t))
        scratch._flush_map_pending()

    # ------------------------------------------------------------------

    def get_trajectory(self) -> Tuple[List[float], List[np.ndarray]]:
        buf = self.mapper.map_to_range_sensor_buffer
        return list(buf._times), [t.copy() for t in buf._transforms]

    def get_health(self) -> dict:
        """Run-health counters (the reference's online telemetry,
        ``Odometry.cpp:51-66``, ``Mapper.cpp:151-156``)."""
        return {
            "n_submaps": self.submaps.get_num_submaps(),
            "n_odometry_failures": self.odometry.n_failed,
            "n_refinement_skips": self.mapper.n_refinement_skips,
            "n_merge_skips_min_movement": self.mapper.n_merge_skips_min_movement,
            "n_map_points": self.submaps.get_total_num_points(),
        }
