"""Place recognition: loop-closure constraint detection.

Port of ``open3d_slam_tpu.models.place_recognition`` (reference
``PlaceRecognition``, ``src/PlaceRecognition.cpp:40-286``):

  * candidate gating by adjacency, search radius, consecutiveness and the
    minimum number of submaps between closures
    (``getLoopClosureCandidatesIdxs``, :231-284);
  * FPFH + RANSAC global registration of the sparse feature clouds
    (:81-85), one candidate at a time, then the correspondence-count gate;
  * the drift consistency check (``isRegistrationConsistent``, :182-229);
  * overlap extraction and GICP refinement with the mapper's registration
    type at 100 iterations (``updateRegistrationAlgorithm``, :44-49; kernel
    K1), the refinement fitness gate and a second consistency check;
  * the 6x6 information matrix from the aligned overlap (:148-150; kernel K3).

The reference detects closures in a worker thread.  Here the detection is a
resumable job: each phase's device work is queued and its outputs prefetched
(``utils/device.prefetch_to_host``), and the next phase runs once they have
landed, so the replay never waits on a closure phase.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from open3d_slam_torch.models.adjacency import AdjacencyMatrix
from open3d_slam_torch.models.cloud_registration import CloudRegistrationStrategy
from open3d_slam_torch.models.constraints import (
    Constraint, ICP_RUN_UNTIL_CONVERGENCE_ITERS, SOURCE_COMPACT_CAP,
    TARGET_COMPACT_CAP, VOXEL_EXPANSION_OVERLAP, get_map_voxel_size)
from open3d_slam_torch.ops import hashgrid, overlap as overlap_ops, ransac
from open3d_slam_torch.ops import pose_graph as pg_ops
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import prefetch_to_host, to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud


class SeededTriplets:
    """RANSAC triplet draws from a seeded generator (the counterpart of the
    JAX package's ``PRNGKey(7)``, split once per job).  Called with the
    padded candidate count and the hypothesis count; returns (k_padded, H, 3)
    integers in [0, 2^30).  Tests replace it with the JAX package's draws."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, k_padded: int, n_hypotheses: int) -> torch.Tensor:
        return torch.randint(0, 1 << 30, (k_padded, n_hypotheses, 3),
                             generator=self.generator, device=self.device)


def _rpy(R: np.ndarray):
    """Roll, pitch, yaw of a rotation matrix, in float64 on the host."""
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    return np.arctan2(R[2, 1], R[2, 2]), pitch, np.arctan2(R[1, 0], R[0, 0])


class PlaceRecognition:
    def __init__(self, params: MapperParameters, num_ransac_hypotheses: int = 4096,
                 device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.num_ransac_hypotheses = num_ransac_hypotheses
        self.draw_triplets = SeededTriplets(7, self.device)
        self.recognition_counter = 0
        icp = dataclasses.replace(
            params.scan_matcher.icp, max_num_iter=ICP_RUN_UNTIL_CONVERGENCE_ITERS,
            max_correspondence_distance=params.place_recognition.max_icp_correspondence_distance)
        self.registration = CloudRegistrationStrategy(
            params.scan_matcher.scan_to_map_reg_type, icp)

    def ransac(self, src_sparse: PointCloud, src_feat: torch.Tensor,
               tgt_sparse: PointCloud, tgt_feat: torch.Tensor,
               draws: torch.Tensor) -> ransac.RansacResult:
        """FPFH + RANSAC of the finished submap against one candidate."""
        p = self.params.place_recognition
        return ransac.ransac_feature_registration(
            src_sparse, src_feat, tgt_sparse, tgt_feat, draws,
            max_correspondence_distance=p.ransac_max_correspondence_distance,
            edge_length_similarity=p.correspondence_checker_edge_length,
            distance_threshold=p.correspondence_checker_distance,
            mutual_filter=True)

    def refine(self, source_full: PointCloud, target_full: PointCloud,
               T_ransac: torch.Tensor):
        """Closure refinement on the device: overlap -> compact -> GICP ->
        correspondences -> scaled information matrix.  Returns (fitness, T,
        info) tensors.  The information matrix is computed before the host
        gates read the fitness, as the JAX package does."""
        p = self.params.place_recognition
        vox = get_map_voxel_size(self.params.map_builder.map_voxel_size)
        src_m, tgt_m = overlap_ops.overlapping_masks(
            source_full, target_full, T_ransac, VOXEL_EXPANSION_OVERLAP * vox)
        src_masked = source_full.with_(mask=source_full.mask & src_m)
        n_src_full = src_masked.count().to(torch.float32)
        source = pclib.compact_to(src_masked, min(source_full.capacity, SOURCE_COMPACT_CAP))
        target = pclib.compact_to(target_full.with_(mask=target_full.mask & tgt_m),
                                  min(target_full.capacity, TARGET_COMPACT_CAP))
        info_scale = torch.clamp(
            n_src_full / torch.clamp(source.count().to(torch.float32), min=1.0), min=1.0)
        prepared = self.registration.prepare_target(target)
        res = self.registration.register(source, prepared, T_ransac)
        pts = se3.transform_points(res.transformation, source.points)
        idx, _, found = hashgrid.query_nearest(prepared.grid, pts,
                                               p.max_icp_correspondence_distance)
        q = prepared.grid.points_sorted[idx.long()]
        info = info_scale * pg_ops.information_matrix_from_correspondences(
            q, found & source.mask)
        return res.fitness, res.transformation, info

    def is_registration_consistent(self, T: np.ndarray) -> bool:
        """Drift bounds (``PlaceRecognition.cpp:182-229``)."""
        p = self.params.place_recognition.consistency_check
        roll, pitch, yaw = _rpy(np.asarray(T, np.float64)[:3, :3])
        t = T[:3, 3]
        return (abs(roll) <= p.max_drift_roll and abs(pitch) <= p.max_drift_pitch and
                abs(yaw) <= p.max_drift_yaw and abs(t[0]) <= p.max_drift_x and
                abs(t[1]) <= p.max_drift_y and abs(t[2]) <= p.max_drift_z)

    def get_loop_closure_candidates_idxs(self, map_to_range_sensor: np.ndarray,
                                         submaps, adjacency: AdjacencyMatrix,
                                         last_finished_idx: int,
                                         active_idx: int) -> List[int]:
        """(``PlaceRecognition.cpp:231-284``)."""
        p = self.params.place_recognition
        out = []
        finished_center = submaps.get_submap(last_finished_idx).get_map_to_submap_center()
        consecutive_threshold = int(math.ceil(
            p.loop_closure_search_radius / self.params.submaps.radius))
        for i in range(submaps.get_num_submaps()):
            if i == active_idx:
                continue
            if adjacency.is_adjacent(submaps.get_submap(i).id,
                                     submaps.get_submap(active_idx).id):
                continue
            if abs(i - last_finished_idx) == 1 or adjacency.is_adjacent(
                    submaps.get_submap(i).id, submaps.get_submap(last_finished_idx).id):
                continue
            center = submaps.get_submap(i).get_map_to_submap_center()
            if float(np.linalg.norm(finished_center - center)) > p.loop_closure_search_radius:
                continue
            if abs(i - last_finished_idx) <= consecutive_threshold:
                continue
            if (adjacency.get_distance_to_nearest_loop_closure_submap(last_finished_idx)
                    < p.min_submaps_between_loop_closures):
                continue
            out.append(i)
        return out

    def start_loop_closure_job(self, map_to_range_sensor: np.ndarray, submaps,
                               adjacency: AdjacencyMatrix, last_finished_idx: int,
                               active_idx: int, timestamp: float):
        """Candidate gating and the RANSAC phase, queued with its outputs
        prefetched.  Returns a job for ``advance_loop_closure_job``, or None
        when there is nothing to match."""
        source_submap = submaps.get_submap(last_finished_idx)
        if source_submap.fpfh is None:
            return None
        candidates = self.get_loop_closure_candidates_idxs(
            map_to_range_sensor, submaps, adjacency, last_finished_idx, active_idx)
        print(f"considering submap {last_finished_idx} for loop closure, "
              f"num candidate submaps: {len(candidates)}")   # :61-62
        cands = [(i, submaps.get_submap(i)) for i in candidates
                 if submaps.get_submap(i).fpfh is not None]
        if not cands:
            return None
        k = len(cands)
        # The JAX package pads the candidates to a fixed batch; the draws
        # keep that padded shape so that both draw the same triplets.
        k_padded = 8 if k <= 8 else 1 << (k - 1).bit_length()
        draws = self.draw_triplets(k_padded, self.num_ransac_hypotheses)
        results = [self.ransac(source_submap.feature_cloud, source_submap.fpfh,
                               s.feature_cloud, s.fpfh, draws[j])
                   for j, (_, s) in enumerate(cands)]
        pulled = prefetch_to_host(torch.stack([r.num_inliers for r in results]),
                                  torch.stack([r.transformation for r in results]))
        return _LoopClosureJob(last_finished_idx, timestamp, cands, pulled,
                               source_submap.map_cloud)

    def advance_loop_closure_job(self, job) -> bool:
        """Advance one phase; True when the job is complete (then read
        ``job.constraints``)."""
        p = self.params.place_recognition
        if job.phase == "ransac":
            n_inliers_all, T_ransac_all = to_host(job.ransac_res)
            for pair_idx, (i, target_submap) in enumerate(job.cands):
                n_inliers = int(n_inliers_all[pair_idx])
                if n_inliers < p.ransac_min_correspondence_set_size:
                    print(f"REJECTED loop closure, {n_inliers} correspondences, "
                          f"submap {job.source_idx} with {i}")
                    continue
                T_ransac = np.asarray(T_ransac_all[pair_idx], np.float64)
                if not self.is_registration_consistent(T_ransac):
                    print(f"REJECTED loop closure, ransac inconsistent, "
                          f"submap {job.source_idx} with {i}")
                    continue
                out = self.refine(job.source_cloud, target_submap.map_cloud,
                                  to_device(T_ransac, self.device))
                job.refines.append((i, prefetch_to_host(*out)))
            job.phase = "refine"
            return not job.refines
        assert job.phase == "refine"
        pulled = to_host(*[out for _, out in job.refines])
        for n, (i, _) in enumerate(job.refines):
            fitness_a, T_icp_a, info_a = pulled[3 * n:3 * n + 3]
            fitness = float(fitness_a)
            if fitness < p.min_refinement_fitness:
                print(f"REJECTED loop closure, refinement score {fitness:.3f}, "
                      f"submap {job.source_idx} with {i}")
                continue
            T_icp = np.asarray(T_icp_a, np.float64)
            if not self.is_registration_consistent(T_icp):
                print(f"REJECTED loop closure, icp inconsistent, "
                      f"submap {job.source_idx} with {i}")
                continue
            job.constraints.append(Constraint(
                source_submap_idx=job.source_idx, target_submap_idx=i,
                source_to_target=T_icp, information_matrix=np.asarray(info_a, np.float64),
                is_odometry_constraint=False, is_information_matrix_valid=True,
                timestamp=job.timestamp))
            self.recognition_counter += 1
            print(f"ACCEPTED loop closure: submap {job.source_idx} with {i}, "
                  f"fitness {fitness:.3f}")
        return True

    def build_loop_closure_constraints(self, map_to_range_sensor: np.ndarray, submaps,
                                       adjacency: AdjacencyMatrix, last_finished_idx: int,
                                       active_idx: int, timestamp: float) -> List[Constraint]:
        """(``PlaceRecognition.cpp:50-176``), blocking: start the job and run
        it to completion."""
        job = self.start_loop_closure_job(map_to_range_sensor, submaps, adjacency,
                                          last_finished_idx, active_idx, timestamp)
        if job is None:
            return []
        while not self.advance_loop_closure_job(job):
            pass
        return job.constraints


class _LoopClosureJob:
    __slots__ = ("phase", "source_idx", "timestamp", "cands", "ransac_res",
                 "source_cloud", "refines", "constraints")

    def __init__(self, source_idx, timestamp, cands, ransac_res, source_cloud):
        self.phase = "ransac"
        self.source_idx = source_idx
        self.timestamp = timestamp
        self.cands = cands
        self.ransac_res = ransac_res        # Prefetched (num_inliers, T)
        self.source_cloud = source_cloud
        self.refines = []                   # [(target_idx, Prefetched outputs)]
        self.constraints: List[Constraint] = []

    def outputs_ready(self) -> bool:
        """True when the current phase's device outputs have landed."""
        if self.phase == "ransac":
            return self.ransac_res.ready()
        return all(out.ready() for _, out in self.refines)
