"""Optimization problem: pose-graph assembly, solve and increments.

Port of ``open3d_slam_tpu.models.optimization`` (reference
``OptimizationProblem``, ``src/OptimizationProblem.cpp:25-212``).  Submaps
already live in a common map frame, so odometry edges carry about identity
transforms and node poses are chained from the constraint transforms
(``setupOdometryEdgesAndPoseGraphNodes``, :64-99); the optimised node pose is
the per-submap delta applied on update (``getOptimizedTransformIncrements``,
:191-202).  The solve runs on the device through ``ops/pose_graph.optimize``
and its result comes back in one counted pull.  JSON dump/load mirrors the
pose-graph file IO (:142-149).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from open3d_slam_torch.models.constraints import Constraint
from open3d_slam_torch.models.submap_collection import OptimizedTransform
from open3d_slam_torch.ops import pose_graph as pg_ops
from open3d_slam_torch.utils.config import MapperParameters
from open3d_slam_torch.utils.device import to_device, to_host


class OptimizationProblem:
    def __init__(self, params: MapperParameters, max_nodes: int = 128,
                 max_edges: int = 512, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.odometry_constraints: List[Constraint] = []
        self.loop_closure_constraints: List[Constraint] = []
        self.node_poses: List[np.ndarray] = []
        self.node_poses_optimized: Optional[List[np.ndarray]] = None
        self._num_odometry_edges_prev = 0
        self.is_running_optimization = False
        self.edge_weights: Optional[np.ndarray] = None
        self.num_edges_pruned_last_solve = 0

    def add_odometry_constraint(self, c: Constraint):
        self.odometry_constraints.append(c)

    def insert_odometry_constraints(self, cs: List[Constraint]):
        self.odometry_constraints.extend(cs)

    def insert_loop_closure_constraints(self, cs: List[Constraint]):
        """Dedup on (source, target) (``OptimizationProblem.cpp:177-189``)."""
        for c in cs:
            if not any(c.source_submap_idx == c2.source_submap_idx and
                       c.target_submap_idx == c2.target_submap_idx
                       for c2 in self.loop_closure_constraints):
                self.loop_closure_constraints.append(c)

    def clear_odometry_constraints(self):
        self.odometry_constraints.clear()
        self._num_odometry_edges_prev = 0

    def clear_loop_closure_constraints(self):
        self.loop_closure_constraints.clear()

    def build_optimization_problem(self, submaps):
        """``buildOptimizationProblem`` (:50-62): nodes chained from the
        odometry constraints (correction space)."""
        self.odometry_constraints.sort(key=lambda c: c.source_submap_idx)
        if not self.node_poses:
            self.node_poses = [np.eye(4)]
            odometry = np.eye(4)
        else:
            base = (self.node_poses_optimized[-1]
                    if self.node_poses_optimized else self.node_poses[-1])
            odometry = np.linalg.inv(base)
        for i in range(self._num_odometry_edges_prev, len(self.odometry_constraints)):
            odometry = self.odometry_constraints[i].source_to_target @ odometry
            self.node_poses.append(np.linalg.inv(odometry))
        self._num_odometry_edges_prev = len(self.odometry_constraints)

    def solve(self):
        """``solve`` (:25-44), on the device."""
        self.is_running_optimization = True
        n = len(self.node_poses)
        ne = len(self.odometry_constraints) + len(self.loop_closure_constraints)
        n_cap, e_cap = self.max_nodes, self.max_edges
        if n > n_cap or ne > e_cap:
            raise RuntimeError(f"pose graph exceeds capacity ({n}/{n_cap} nodes, "
                               f"{ne}/{e_cap} edges) — raise CapacityParameters")
        poses = np.tile(np.eye(4, dtype=np.float32), (n_cap, 1, 1))
        opt = self.node_poses_optimized or []
        for i, P in enumerate(opt):
            poses[i] = P
        for i in range(len(opt), n):
            poses[i] = self.node_poses[i]
        nmask = np.zeros(n_cap, bool)
        nmask[:n] = True
        src = np.zeros(e_cap, np.int64)
        tgt = np.zeros(e_cap, np.int64)
        T = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
        info = np.tile(np.eye(6, dtype=np.float32), (e_cap, 1, 1))
        unc = np.zeros(e_cap, bool)
        emask = np.zeros(e_cap, bool)
        for c in self.odometry_constraints:
            assert c.target_submap_idx > c.source_submap_idx, \
                "odometry constraint must have source < target"
        for k, c in enumerate(self.odometry_constraints + self.loop_closure_constraints):
            src[k], tgt[k] = c.source_submap_idx, c.target_submap_idx
            T[k] = c.source_to_target
            info[k] = c.information_matrix
            unc[k] = k >= len(self.odometry_constraints)
            emask[k] = True
        dev = self.device
        graph = pg_ops.PoseGraphData(
            node_poses=to_device(poses, dev), node_mask=to_device(nmask, dev, torch.bool),
            edge_source=to_device(src, dev, torch.int64),
            edge_target=to_device(tgt, dev, torch.int64),
            edge_transform=to_device(T, dev), edge_information=to_device(info, dev),
            edge_uncertain=to_device(unc, dev, torch.bool),
            edge_mask=to_device(emask, dev, torch.bool))
        p = self.params.global_optimization
        X, w, pruned = to_host(*pg_ops.optimize(
            graph, max_correspondence_distance=p.max_correspondence_distance,
            preference_loop_closure=p.loop_closure_preference,
            edge_prune_threshold=p.edge_prune_threshold,
            reference_node=p.reference_node))
        # Pruned loop-closure edges are dropped for good: a rejected closure
        # must not bend the graph again on the next solve.
        n_odo = len(self.odometry_constraints)
        kept_lc = [c for i, c in enumerate(self.loop_closure_constraints)
                   if not pruned[n_odo + i]]
        n_pruned = len(self.loop_closure_constraints) - len(kept_lc)
        if n_pruned:
            print(f"Pose graph pruning: dropped {n_pruned} uncertain edge(s) "
                  f"below weight {p.edge_prune_threshold}")
        self.loop_closure_constraints = kept_lc
        self.edge_weights = w.astype(np.float32)
        self.num_edges_pruned_last_solve = n_pruned
        self.node_poses_optimized = [X[i] for i in range(n)]
        self.is_running_optimization = False

    def get_optimized_transform_increments(self) -> List[OptimizedTransform]:
        """deltaT = optimised node pose (:191-202)."""
        assert self.node_poses_optimized is not None, "did you run the optimization?"
        return [OptimizedTransform(submap_id=i, dT=P)
                for i, P in enumerate(self.node_poses_optimized)]

    def dump_to_file(self, filename: str):
        """Pose graph as JSON (mirrors Open3D pose-graph IO, :142-145)."""
        data = {
            "nodes": [np.asarray(P).tolist() for P in self.node_poses],
            "nodes_optimized": ([np.asarray(P).tolist() for P in self.node_poses_optimized]
                                if self.node_poses_optimized else None),
            "edges": [dict(source=c.source_submap_idx, target=c.target_submap_idx,
                           transformation=np.asarray(c.source_to_target).tolist(),
                           information=np.asarray(c.information_matrix).tolist(),
                           uncertain=not c.is_odometry_constraint)
                      for c in self.odometry_constraints + self.loop_closure_constraints],
        }
        with open(filename, "w") as f:
            json.dump(data, f)

    def load_from_file(self, filename: str):
        with open(filename) as f:
            data = json.load(f)
        self.node_poses = [np.asarray(P) for P in data["nodes"]]
        if data.get("nodes_optimized"):
            self.node_poses_optimized = [np.asarray(P) for P in data["nodes_optimized"]]
        self.odometry_constraints = []
        self.loop_closure_constraints = []
        for e in data["edges"]:
            c = Constraint(
                source_submap_idx=e["source"], target_submap_idx=e["target"],
                source_to_target=np.asarray(e["transformation"]),
                information_matrix=np.asarray(e["information"]),
                is_odometry_constraint=not e["uncertain"],
                is_information_matrix_valid=True)
            (self.odometry_constraints if not e["uncertain"]
             else self.loop_closure_constraints).append(c)
        self._num_odometry_edges_prev = len(self.odometry_constraints)
