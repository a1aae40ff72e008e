"""Multi-process scale-out harness.

Port of ``open3d_slam_tpu.parallel.multihost``.  The JAX module drives
``jax.distributed``; this one drives ``torch.distributed``, one process per
card, configured by ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) in place of
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.

  * ``initialize`` — the process group (NCCL on ``cuda:LOCAL_RANK``, gloo on
    the CPU); a world of one still gets its group, so the collectives run.
  * ``global_mesh`` — the (data, block) mesh over every process.
  * ``batch_map_sequences`` — each rank maps its round-robin share of the
    sequences with ``SlamWrapper``; the padded trajectories are gathered and
    summed in rank order.
  * ``registration_throughput_stage`` — a batch of point-to-plane
    registrations sharded over the data axis (K2 normals, K4 with a target
    per element).
  * ``pose_graph_refinement_stage`` — a batch of pose graphs, each rank
    optimizing its share.

Run as a 2-process demonstration on the CPU:

    python -m open3d_slam_torch.parallel.multihost --spawn 2 --block 2 --device cpu

which starts 2 processes in a gloo group, runs every stage and prints
``multihost: PASS`` from rank 0; on a card, ``--device cuda`` (one process
per card: NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from open3d_slam_torch.parallel import mesh as mesh_lib

TIMEOUT_S = 600.0


def free_port() -> int:
    """A TCP port on this host that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> int:
    """Join the default process group (idempotent); returns this rank.

    ``address`` ("host:port") defaults to ``MASTER_ADDR``/``MASTER_PORT``,
    ``num_processes`` to ``WORLD_SIZE`` (1), ``process_id`` to ``RANK`` (0).
    A world of one with no port given takes a free one.  ``device``: the
    card unless the caller asks for the CPU; on the card each process takes
    ``cuda:LOCAL_RANK`` (default: its rank) with NCCL, on the CPU gloo.  A
    collective that waits longer than ``timeout_s`` fails."""
    if dist.is_initialized():
        return dist.get_rank()
    from open3d_slam_torch.utils.device import resolve_device
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
    rank = int(env.get("RANK", "0")) if process_id is None else process_id
    if address is None:
        port = env.get("MASTER_PORT")
        if port is None:
            if world > 1:
                raise ValueError("a world of more than one process needs MASTER_PORT "
                                 "or an address")
            port = free_port()
        address = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{port}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def global_mesh(block: int = 1):
    """(data, block) mesh over every process (after ``initialize``)."""
    n = dist.get_world_size()
    if n % block:
        raise ValueError(f"{n} processes do not split into blocks of {block}")
    return mesh_lib.make_mesh((n // block, block))


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def batch_map_sequences(sequences, params=None) -> List[np.ndarray]:
    """Map N sequences, round-robin over the processes.

    Each rank runs full SLAM (odometry + mapping) with ``SlamWrapper`` on its
    device over sequences [rank::world]; the trajectories, padded to the
    longest (float64, zeros where a rank owns nothing), are gathered and
    summed in rank order, so every rank returns all N (each (max_len, 4, 4))."""
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper
    from open3d_slam_torch.utils.config import SlamParameters

    rank, world = dist.get_rank(), dist.get_world_size()
    n_seq = len(sequences)
    max_len = max(len(s.scans) for s in sequences)
    dev = mesh_lib.collective_device()
    local = np.zeros((n_seq, max_len, 4, 4), np.float64)
    for i in range(rank, n_seq, world):
        seq = sequences[i]
        slam = SlamWrapper(params or SlamParameters(), device=dev)
        for scan, t in zip(seq.scans, seq.timestamps):
            slam.process_scan(scan, t)
        _, poses = slam.get_trajectory()
        for j, T in enumerate(poses[:max_len]):
            local[i, j] = T
    # Each sequence has one owner, so the sum takes the owner's poses (a
    # zero is added to each of them).
    merged = mesh_lib.gather_sum(torch.from_numpy(local).to(dev)).cpu().numpy()
    return [merged[i] for i in range(n_seq)]


def batch_map_inputs(n_sequences: int = 2, n_scans: int = 6,
                     refine_every_scan: bool = False):
    """The batch-map stage's sequences and small-capacity parameters (the
    JAX stage's): straight 0.4 m steps through 20 m worlds seeded 11, 12,
    ..., 3000 points a scan, loop closures and the dense map off.  With
    ``refine_every_scan`` the registrations' gates are widened (1 m
    correspondences, 12 iterations, normals from 10 neighbours within
    1.2 m), so that every scan is refined and each trajectory has a pose
    per scan, and the timing printout is off."""
    from open3d_slam_torch.io import datasets
    from open3d_slam_torch.utils.config import CapacityParameters, SlamParameters

    seqs = []
    for i in range(n_sequences):
        cfgw = datasets.SyntheticWorldConfig(
            extent=20.0, n_ground=20000, n_walls=15000, n_pillars=8000, seed=11 + i)
        seqs.append(datasets.make_synthetic_sequence(
            n_scans=n_scans, trajectory="straight", step=0.4, n_points=3000,
            max_range=18.0, world_cfg=cfgw))
    params = SlamParameters()
    params.capacities = CapacityParameters(
        raw_scan=4096, processed_scan=2048, submap_points=16384,
        dense_submap_voxels=4096, map_patch=4096, feature_cloud=1024)
    params.odometry.scan_processing.voxel_size = 0.4
    params.mapper.scan_processing.voxel_size = 0.4
    params.mapper.map_builder.map_voxel_size = 0.4
    params.mapper.is_build_dense_map = False
    params.mapper.is_attempt_loop_closures = False
    if refine_every_scan:
        for o in (params.odometry, params.mapper):
            o.scan_matcher.icp.max_correspondence_distance = 1.0
            o.scan_matcher.icp.max_num_iter = 12
            o.scan_matcher.icp.max_distance_knn = 1.2
            o.scan_matcher.icp.knn = 10
        params.mapper.is_print_timing_statistics = False
    return seqs, params


def batch_map_stage(n_sequences: int = 2, n_scans: int = 6) -> dict:
    """``batch_map_sequences`` on N small synthetic sequences: every rank
    receives all N trajectories with the owners' poses.  Returns
    {"n_sequences", "n_nonzero", "max_start_err"}: the trajectories that
    have poses, and the largest gap of their first pose to the identity
    (mapping starts at the origin); the same on every rank."""
    seqs, params = batch_map_inputs(n_sequences, n_scans)
    mapped = [t for t in batch_map_sequences(seqs, params) if np.abs(t).sum() > 0]
    err = max((float(np.abs(t[0] - np.eye(4)).max()) for t in mapped), default=float("inf"))
    return {"n_sequences": n_sequences, "n_nonzero": len(mapped), "max_start_err": err}


def registration_throughput_stage(mesh, batch: int = 32, n_src: int = 512,
                                  n_tgt: int = 2048) -> float:
    """Batched point-to-plane ICP sharded over the data axis; returns the
    mean fitness of the whole batch (must be ~1).  Every rank prepares the
    whole batch (K2 normals at r = 1 m, k = 10; grids of 0.8 m) and
    registers its slice (K4, a target per element, 10 iterations)."""
    from open3d_slam_torch.ops import hashgrid, normals as normals_ops
    from open3d_slam_torch.parallel import sharded_icp
    from open3d_slam_torch.utils.pointcloud import PointCloud

    dev = mesh_lib.collective_device()
    # As the JAX stage draws them: element b from default_rng(b), a 16 m
    # square of ground with 5 cm of noise, its source n_src of its points.
    tgts, srcs = [], []
    for b in range(batch):
        r = np.random.default_rng(b)
        t = np.stack([r.uniform(-8, 8, n_tgt), r.uniform(-8, 8, n_tgt),
                      0.05 * r.standard_normal(n_tgt)], axis=1).astype(np.float32)
        tgts.append(t)
        srcs.append(t[r.choice(n_tgt, n_src, replace=False)]
                    + np.array([0.1, -0.05, 0.02], np.float32))
    srcs, tgts = np.stack(srcs), np.stack(tgts)
    src_pc = PointCloud(points=torch.from_numpy(srcs).to(dev),
                        mask=torch.ones((batch, n_src), dtype=torch.bool, device=dev))
    tgt_pts = torch.from_numpy(tgts).to(dev)
    tgt_mask = torch.ones((batch, n_tgt), dtype=torch.bool, device=dev)
    nrm = torch.stack([normals_ops.estimate_normals(
        PointCloud(points=tgt_pts[b], mask=tgt_mask[b]), 1.0, max_nn=10).normals
        for b in range(batch)])
    grids = hashgrid.build_batched(PointCloud(points=tgt_pts, mask=tgt_mask, normals=nrm), 0.8)
    inits = torch.eye(4, device=dev).repeat(batch, 1, 1)
    res = sharded_icp.batched_icp_p2l(src_pc, grids, inits, 0.8, max_iterations=10, mesh=mesh)
    return float(res.fitness.mean())


def chain_graph(n_nodes: int = 16, drift: float = 0.1):
    """The refinement stage's graph, in numpy: a chain along +y whose odometry
    edges each say 1 + ``drift`` m, nodes placed by them, and one loop
    closure from the last node to the first (information x10, uncertain)
    that says the true n_nodes - 1 m.  Edges (s, t, T) in the port's
    convention, X_t^-1 X_s = T: the JAX stage's edge (i, i + 1) with
    X_i^-1 X_{i+1} = T is the port's edge (i + 1, i).  Returns
    (nodes (N, 4, 4), source (E,), target (E,), T (E, 4, 4), information
    (E, 6, 6), uncertain (E,))."""
    nodes = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    nodes[:, 1, 3] = np.arange(n_nodes, dtype=np.float32) * (1.0 + drift)
    e = n_nodes
    src = np.array([i + 1 for i in range(n_nodes - 1)] + [n_nodes - 1], np.int64)
    tgt = np.array(list(range(n_nodes - 1)) + [0], np.int64)
    Te = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    Te[:-1, 1, 3] = 1.0 + drift
    Te[-1, 1, 3] = float(n_nodes - 1)
    info = np.tile(np.eye(6, dtype=np.float32), (e, 1, 1))
    info[-1] *= 10.0
    unc = np.zeros(e, bool)
    unc[-1] = True
    return nodes, src, tgt, Te, info, unc


def pose_graph_refinement_stage(mesh, n_graphs: int = 8, n_nodes: int = 16) -> float:
    """Batched pose-graph LM sharded over the data axis: each rank optimizes
    its share of ``n_graphs`` drifted chains closed by a loop
    (``chain_graph``).  Returns the largest endpoint error over all graphs,
    gathered in rank order (must be ~0)."""
    from open3d_slam_torch.ops import pose_graph as pg

    dev = mesh_lib.collective_device()
    nodes, src, tgt, Te, info, unc = (torch.from_numpy(a).to(dev)
                                      for a in chain_graph(n_nodes))
    graph = pg.PoseGraphData(
        node_poses=nodes, node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        edge_source=src, edge_target=tgt, edge_transform=Te, edge_information=info,
        edge_uncertain=unc, edge_mask=torch.ones(len(src), dtype=torch.bool, device=dev))
    mine = mesh_lib.shard_batch(mesh, torch.arange(n_graphs, device=dev))
    errs = torch.stack([
        (pg.optimize(graph, 10.0, 2.0, 0.25, 0, max_iterations=20)[0][-1, 1, 3]
         - (n_nodes - 1)).abs() for _ in range(len(mine))])
    return float(mesh_lib.gather_cat(errs, mesh_lib.data_group(mesh)).max())


# ---------------------------------------------------------------------------
# The command-line harness
# ---------------------------------------------------------------------------


def _worker_main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="start N local processes and run every stage in each")
    ap.add_argument("--block", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args(argv)

    if args.spawn:
        return _spawn_local(args)

    initialize(device=args.device)
    try:
        mesh = global_mesh(block=args.block)
        fit = registration_throughput_stage(mesh)
        err = pose_graph_refinement_stage(mesh)
        bm = batch_map_stage()
        ok = (fit > 0.95 and err < 0.05 and bm["n_nonzero"] == bm["n_sequences"]
              and bm["max_start_err"] < 1e-3)
        if dist.get_rank() == 0:
            result = {"processes": dist.get_world_size(),
                      "global_devices": dist.get_world_size(),
                      "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                      "registration_fitness": round(fit, 4),
                      "pose_graph_endpoint_err": round(err, 5),
                      "batch_map_sequences": bm,
                      "ok": ok}
            if args.device == "cuda":
                result["device"] = torch.cuda.get_device_name()
            print(json.dumps(result), flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(result, f)
            print("multihost: PASS" if ok else "multihost: FAIL", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def _spawn_local(args):
    """Start ``args.spawn`` local processes, each running the worker with
    ``torchrun``'s environment; if one fails, stop the others."""
    port = free_port()
    procs = []
    for rank in range(args.spawn):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(args.spawn),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if args.device == "cpu":
            # A share of the cores each: OpenMP's spinning threads would
            # oversubscribe them.
            env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.spawn)))
        cmd = [sys.executable, "-m", "open3d_slam_torch.parallel.multihost",
               "--block", str(args.block), "--device", args.device]
        if args.out and rank == 0:
            cmd += ["--out", args.out]
        procs.append(subprocess.Popen(cmd, env=env))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        rcs = [p.wait() for p in procs]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(_worker_main())
