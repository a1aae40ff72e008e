"""SlamWrapper: the end-to-end SLAM orchestrator.

Port of ``open3d_slam_tpu.models.slam_wrapper`` (reference
``SlamWrapper.cpp:43-487``): ingest (NaN removal, out-of-order rejection),
constant-velocity undistortion, the odometry stage, the mapping stage
(scan-to-map registration, gates, submap insert), feature computation and
odometry constraints for finished submaps, the resumable loop-closure job,
the pose-graph solve and the rewrite of submaps and mapper pose, pipelined
replay with one scan in flight, and ``finish_processing`` with its final
closure round.  The reference's worker threads become a sequential,
deterministic host pipeline feeding the device.

Localization mode: ``set_initial_map`` and ``set_initial_transform``.  The
dense map arrives with a later slice of the port; a configuration that turns
it on is refused.  The wrapper runs on ``cuda`` unless the caller asks for
another device.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from open3d_slam_torch.models.buffers import CircularBuffer
from open3d_slam_torch.models.constraints import (
    Constraint, compute_odometry_constraints, finalize_constraint)
from open3d_slam_torch.models.mapper import Mapper
from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.optimization import OptimizationProblem
from open3d_slam_torch.models.place_recognition import PlaceRecognition
from open3d_slam_torch.models.submap_collection import SubmapCollection
from open3d_slam_torch.ops import motion_compensation as mc_ops
from open3d_slam_torch.utils import pointcloud as pclib
from open3d_slam_torch.utils.config import SlamParameters
from open3d_slam_torch.utils.device import resolve_device, to_device, to_host
from open3d_slam_torch.utils.timeutil import TelemetryRegistry


def _check_supported(p: SlamParameters):
    if p.mapper.is_build_dense_map:
        raise NotImplementedError(
            "mapper.is_build_dense_map is set, but it is not ported yet: it "
            "arrives with the dense-map slice of the port (see ROADMAP.md); "
            "set it to false")


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
                                        feature_capacity=cap.feature_cloud,
                                        device=self.device)
        self.mapper = Mapper(p.mapper, self.odometry.odom_buffer, self.submaps,
                             processed_capacity=cap.processed_scan,
                             patch_capacity=cap.map_patch, device=self.device)
        self.optimization_problem = OptimizationProblem(
            p.mapper, max_nodes=cap.max_submaps, max_edges=cap.max_constraints,
            device=self.device)
        self.place_recognition = PlaceRecognition(p.mapper, device=self.device)
        self.odometry_buffer = CircularBuffer(max(1, p.odometry.odometry_buffer_size))
        self.mapping_buffer = CircularBuffer(max(1, p.mapper.mapping_buffer_size))
        self.loop_closure_candidates: List = []
        self.odometry_constraints: List[Constraint] = []
        self.last_loop_closure_constraints: List[Constraint] = []
        self.num_latest_loop_closure_constraints = -1
        self.is_optimized_graph_available = False
        self.n_loop_closures_accepted = 0
        self.n_optimizations_applied = 0
        self.latest_scan_to_map_refinement_time: Optional[float] = None
        self.folder_path = "."
        self._raw_capacity = cap.raw_scan
        # in-flight pipelined mapping step: (MapperPending, measurement)
        self._map_pending = None
        self._lc_job = None                          # in-flight loop-closure job
        self._pending_constraint_pulls: List = []    # queued, not yet pulled

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

    def _undistort(self, measurement: TimestampedPointCloud, which: str):
        """Constant-velocity undistortion with the velocity of the last
        ``num_poses_velocity_estimation`` poses of the odometry (``which`` =
        "odom") or mapper ("map") pose buffer, as they stand when the scan is
        dispatched (``MotionCompensation.cpp:32-57``)."""
        p = self.params.motion_compensation
        if not p.is_undistort_input_cloud:
            return measurement.cloud
        buf = (self.odometry.odom_buffer if which == "odom"
               else self.mapper.map_to_range_sensor_buffer)
        if len(buf) <= p.num_poses_velocity_estimation:
            return measurement.cloud
        finish = buf.latest_measurement(0)
        start = buf.latest_measurement(p.num_poses_velocity_estimation)
        dt = finish.time - start.time
        if dt <= 0:
            return measurement.cloud
        lin, ang = mc_ops.estimate_velocities(
            torch.as_tensor(start.transform, dtype=torch.float32),
            torch.as_tensor(finish.transform, dtype=torch.float32), dt)
        return mc_ops.undistort_constant_velocity(
            measurement.cloud, to_device(lin, self.device), to_device(ang, self.device),
            p.scan_duration, is_spinning_clockwise=p.is_spinning_clockwise)

    def _odometry_step(self) -> bool:
        """odometryWorker body (:258-289), dispatch only: the results ride the
        measurement into the mapping stage and are pulled there together
        with the scan-to-map result."""
        measurement = self.odometry_buffer.pop()
        if measurement is None:
            return False
        with self.telemetry.timer("odometry", sampled=True):
            cloud = self._undistort(measurement, "odom")
            r = self.odometry.add_range_scan_async(cloud, measurement.time)
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
            cloud = self._undistort(measurement, "map")
            mp, _ = self.mapper.dispatch_range_measurement(
                cloud, measurement.time, odom_pending=measurement.odom_pending)
            if mp is not None:
                self.mapper.finalize_range_measurement(mp)
        self._after_mapping(measurement)
        return True

    def _after_mapping(self, measurement: TimestampedPointCloud):
        """Stages downstream of the mapper (:388-405): features and odometry
        constraints of finished submaps, one step of the loop-closure job,
        and the optimised graph when one is waiting."""
        self.latest_scan_to_map_refinement_time = measurement.time
        if self.params.mapper.is_attempt_loop_closures:
            self.compute_features_if_ready()
            self.attempt_loop_closures_if_ready()
        self.check_if_optimized_graph_available()
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
    # Loop closure (loopClosureWorker, :406-448) and the graph update

    def compute_features_if_ready(self):
        finished = self.submaps.pop_finished_submap_ids()
        if finished:
            with self.telemetry.timer("submap_features"):
                self.submaps.compute_features(finished)
            with self.telemetry.timer("odometry_constraints"):
                # Queued only: the (T, info) outputs are prefetched and read
                # when an optimisation round needs the constraints.
                compute_odometry_constraints(
                    self.submaps, self.odometry_constraints, candidates=finished,
                    pending_out=self._pending_constraint_pulls)

    def _flush_pending_constraints(self):
        pend, self._pending_constraint_pulls = self._pending_constraint_pulls, []
        for c, outputs in pend:
            finalize_constraint(c, outputs)

    def attempt_loop_closures_if_ready(self):
        cands = self.submaps.pop_loop_closure_candidates()
        if cands:
            self.loop_closure_candidates.extend(cands)
        self._advance_loop_closures()

    def _advance_loop_closures(self, drain: bool = False):
        """The loop-closure job as a resumable state machine: each call
        advances it by one phase (RANSAC queued -> gates + refinement queued
        -> gates + constraints), and only once that phase's prefetched
        outputs have landed, so the replay never waits on closure work.  With
        ``drain`` (``finish_processing``) the job runs to completion."""
        while True:
            if self._lc_job is None:
                if (not self.loop_closure_candidates or
                        self.is_optimized_graph_available):
                    return
                tid = self.loop_closure_candidates.pop(0)
                with self.telemetry.timer("lc_start"):
                    self._lc_job = self.place_recognition.start_loop_closure_job(
                        self.submaps.map_to_range_sensor, self.submaps,
                        self.submaps.adjacency, tid.submap_id,
                        self.submaps.active_submap_idx, tid.time)
                if self._lc_job is None:
                    self.num_latest_loop_closure_constraints = 0
                    continue
                if not drain:
                    return
            if not drain and not self._lc_job.outputs_ready():
                return
            with self.telemetry.timer("lc_" + self._lc_job.phase):
                done = self.place_recognition.advance_loop_closure_job(self._lc_job)
            if done:
                job, self._lc_job = self._lc_job, None
                self._finish_loop_closure(job.constraints)
            if not drain:
                return

    def _finish_loop_closure(self, constraints: List[Constraint]):
        """Post-detection half of loopClosureWorker (:427-448): odometry
        constraints, then the pose-graph build and solve."""
        self.num_latest_loop_closure_constraints = len(constraints)
        if not constraints:
            return
        self.n_loop_closures_accepted += len(constraints)
        with self.telemetry.timer("optimization"):
            self._flush_pending_constraints()
            odom_constraints = list(self.odometry_constraints)
            compute_odometry_constraints(self.submaps, odom_constraints)
            opt = self.optimization_problem
            opt.clear_odometry_constraints()
            opt.insert_loop_closure_constraints(constraints)
            opt.insert_odometry_constraints(odom_constraints)
            opt.build_optimization_problem(self.submaps)
            if self.params.mapper.is_dump_submaps_to_file_before_and_after_loop_closures:
                self.dump_submaps("before")
                opt.dump_to_file(os.path.join(self.folder_path, "poseGraph.json"))
            opt.solve()
            self.last_loop_closure_constraints = constraints
            self.is_optimized_graph_available = True

    def check_if_optimized_graph_available(self):
        """(:421-432 / :349-361)."""
        if self.is_optimized_graph_available:
            self.is_optimized_graph_available = False
            self.update_submaps_and_trajectory()
            if self.params.mapper.is_dump_submaps_to_file_before_and_after_loop_closures:
                self.dump_submaps("after")

    def update_submaps_and_trajectory(self):
        """``updateSubmapsAndTrajectory`` (:450-485)."""
        self.n_optimizations_applied += 1
        increments = self.optimization_problem.get_optimized_transform_increments()
        self.submaps.transform(increments)
        if self.last_loop_closure_constraints:
            latest = max(self.last_loop_closure_constraints,
                         key=lambda c: (c.timestamp or 0.0))
            assert latest.source_submap_idx > latest.target_submap_idx
            self.mapper.loop_closure_update(increments[latest.source_submap_idx].dT)
        # Applied loop-closure constraints are zeroed out (:473-480).
        for c in self.optimization_problem.loop_closure_constraints:
            c.source_to_target = np.eye(4)
        self.submaps.update_adjacency_matrix(
            self.optimization_problem.loop_closure_constraints)

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
        the sequential mode, so both give the same trajectory, with one
        exception: the mapper's undistortion estimates its velocity from the
        poses available when scan t is dispatched, before scan t-1 is
        finalized, so one scan staler than in sequential mode (as the
        reference's free-running undistortion thread reads whatever its pose
        buffer holds, ``MotionCompensation.cpp:32-57``).  With undistortion
        off the two modes agree exactly.  Call ``finish_processing`` before
        reading trajectories or maps."""
        if not self.add_range_scan(points, timestamp, colors=colors):
            return False
        self._odometry_step()
        measurement = self.mapping_buffer.pop()
        if measurement is None:
            return True
        cloud = self._undistort(measurement, "map")
        processed = None
        if not self.submaps.get_active_submap().is_empty():
            processed = self.mapper.preprocess_scan(cloud)
        self._flush_map_pending()
        mp, _ = self.mapper.dispatch_range_measurement(
            cloud, measurement.time, odom_pending=measurement.odom_pending,
            processed=processed)
        if mp is not None:
            self._map_pending = (mp, measurement)
        else:
            self._after_mapping(measurement)
        return True

    def finish_processing(self):
        """``finishProcessing`` (:126-166): drain, close the active submap,
        then a final feature / loop-closure / optimisation round."""
        self.process_queued()
        self.odometry.finalize_pending()
        print("Finishing all submaps!")
        self.num_latest_loop_closure_constraints = -1
        self.submaps.force_new_submap_creation()
        if self.params.mapper.is_attempt_loop_closures:
            self.compute_features_if_ready()
            cands = self.submaps.pop_loop_closure_candidates()
            if cands:
                self.loop_closure_candidates.extend(cands)
            self._advance_loop_closures(drain=True)
            self.check_if_optimized_graph_available()
        self._flush_pending_constraints()
        self.telemetry.maybe_print(force=True)
        print("All submaps finished!")

    def warmup(self, scans=None, timestamps=None):
        """Run each device stage once before the replay clock starts, so
        that kernel builds and library initialisation (cuBLAS, cuSOLVER)
        fall outside it.  A few ``scans`` (e.g. the clouds the reference
        skips, ``magic::skipFirstNPointClouds``) go through a scratch
        wrapper; with loop closures on, each closure function then runs once
        on dummy inputs at the configured capacities.  The wrapper's own
        state is not touched."""
        if scans:
            scratch = SlamWrapper(self.params, device=self.device)
            ts = (timestamps if timestamps is not None
                  else [0.1 * i for i in range(len(scans))])
            for s, t in zip(scans, ts):
                scratch.process_scan_pipelined(np.asarray(s), float(t))
            scratch._flush_map_pending()
        if self.params.mapper.is_attempt_loop_closures:
            self._warmup_closure_functions()

    def _warmup_closure_functions(self):
        from open3d_slam_torch.models import constraints as cmod
        from open3d_slam_torch.models.submap import Submap
        from open3d_slam_torch.ops import pose_graph as pg_ops
        p, cap, dev = self.params.mapper, self.params.capacities, self.device
        rng = np.random.default_rng(0)
        pts = rng.uniform(-20, 20, (cap.submap_points, 3)).astype(np.float32)
        nrm = np.zeros_like(pts)
        nrm[:, 2] = 1.0
        map_c = pclib.from_numpy(pts, capacity=cap.submap_points, normals=nrm, device=dev)
        sub = Submap(0, 0, p, map_capacity=cap.submap_points,
                     feature_capacity=cap.feature_cloud, device=dev)
        sub.map_cloud = map_c
        sub.compute_features(force=True)
        vox = cmod.get_map_voxel_size(p.map_builder.map_voxel_size)
        out_c = cmod.constraint_outputs(
            map_c, map_c, True, cmod.VOXEL_EXPANSION_ICP_CORR * vox,
            cmod.VOXEL_EXPANSION_OVERLAP * vox, True,
            not p.is_refine_odometry_constraints_between_submaps,
            min(map_c.capacity, cmod.SOURCE_COMPACT_CAP),
            min(map_c.capacity, cmod.TARGET_COMPACT_CAP))
        pr = self.place_recognition
        draws = torch.randint(0, 1 << 30, (pr.num_ransac_hypotheses, 3), device=dev)
        res_r = pr.ransac(sub.feature_cloud, sub.fpfh, sub.feature_cloud, sub.fpfh, draws)
        out_ref = pr.refine(map_c, map_c, torch.eye(4, device=dev))
        n_cap, e_cap = cap.max_submaps, cap.max_constraints
        nmask = torch.zeros(n_cap, dtype=torch.bool, device=dev)
        nmask[:2] = True
        emask = torch.zeros(e_cap, dtype=torch.bool, device=dev)
        emask[0] = True
        graph = pg_ops.PoseGraphData(
            node_poses=torch.eye(4, device=dev).repeat(n_cap, 1, 1), node_mask=nmask,
            edge_source=torch.zeros(e_cap, dtype=torch.int64, device=dev),
            edge_target=torch.ones(e_cap, dtype=torch.int64, device=dev),
            edge_transform=torch.eye(4, device=dev).repeat(e_cap, 1, 1),
            edge_information=torch.eye(6, device=dev).repeat(e_cap, 1, 1),
            edge_uncertain=torch.zeros(e_cap, dtype=torch.bool, device=dev),
            edge_mask=emask)
        g = p.global_optimization
        out_g = pg_ops.optimize(graph, g.max_correspondence_distance,
                                g.loop_closure_preference, g.edge_prune_threshold,
                                g.reference_node)
        to_host(res_r.num_inliers, out_c[1], out_ref[0], out_g[1])

    # ------------------------------------------------------------------
    # Initialization / localization mode

    def set_initial_map(self, map_points: np.ndarray, timestamp: float = 0.0):
        """``setInitialMap`` (``SlamWrapper.cpp:209-220``): the map, with the
        normals its registration type needs, goes through the mapper's
        first-scan path with ``is_use_initial_map`` (``Mapper.cpp:105-115``)."""
        cloud = pclib.from_numpy(np.asarray(map_points, np.float32),
                                 capacity=self.params.capacities.submap_points,
                                 device=self.device)
        cloud = self.mapper.scan_to_map_reg.prepare_initial_map(cloud)
        self.mapper.add_range_measurement(cloud, timestamp)

    def set_initial_transform(self, T: np.ndarray):
        """``setInitialTransform`` (``SlamWrapper.cpp:222-225``)."""
        self.odometry.set_initial_transform(T)
        self.mapper.set_map_to_range_sensor_initial(T)

    # ------------------------------------------------------------------
    # Saving (SlamWrapper.cpp:65-78, :242-256)

    def save_map(self, folder: Optional[str] = None) -> str:
        from open3d_slam_torch.io import pcd
        folder = folder or self.folder_path
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, "map.pcd")
        pcd.write_pcd(path, **self.mapper.get_assembled_map_point_cloud())
        return path

    def dump_submaps(self, prefix: str, dense: bool = False,
                     folder: Optional[str] = None):
        """Each submap's sparse map cloud as ``<prefix>_<i>.pcd``.  Dense
        submaps arrive with the dense-map slice."""
        from open3d_slam_torch.io import pcd
        if dense:
            raise NotImplementedError("dense submaps arrive with the dense-map "
                                      "slice of the port (see ROADMAP.md)")
        folder = folder or self.folder_path
        os.makedirs(folder, exist_ok=True)
        for i, s in enumerate(self.submaps.submaps):
            pcd.write_pcd(os.path.join(folder, f"{prefix}_{i}.pcd"),
                          **pclib.to_numpy(s.map_cloud))

    # ------------------------------------------------------------------

    def get_trajectory(self) -> Tuple[List[float], List[np.ndarray]]:
        buf = self.mapper.map_to_range_sensor_buffer
        return list(buf._times), [t.copy() for t in buf._transforms]

    def get_health(self) -> dict:
        """Run-health counters (the reference's online telemetry,
        ``SlamWrapper.cpp:282-286``, ``Odometry.cpp:51-66``,
        ``Mapper.cpp:151-156``)."""
        return {
            "n_submaps": self.submaps.get_num_submaps(),
            "n_loop_closures_accepted": self.n_loop_closures_accepted,
            "n_optimizations_applied": self.n_optimizations_applied,
            "n_odometry_failures": self.odometry.n_failed,
            "n_refinement_skips": self.mapper.n_refinement_skips,
            "n_merge_skips_min_movement": self.mapper.n_merge_skips_min_movement,
            "n_map_points": self.submaps.get_total_num_points(),
        }
