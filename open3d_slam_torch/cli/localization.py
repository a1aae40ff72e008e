"""Localization CLI: map-initialized mode, with multi-start global
localization.

Port of ``open3d_slam_tpu.cli.localization`` (the reference's
``SlamMapInitializer`` flow, ``SlamMapInitializer.cpp:51-78`` +
``mapping_node.cpp:37-41``): load a PCD map, set the initial transform, run
with ``is_use_initial_map`` (merging scans only with ``--merge-scans``).
``--global-init`` localizes the first scan without an initial pose
(``SlamMapInitializer.relocalize``: batched multi-start ICP over
``--num-hypotheses`` pose hypotheses, by default
``capacities.localization_hypotheses``).  Runs on ``cuda`` unless
``--device cpu``.

Usage:
  python -m open3d_slam_torch.cli.localization --map map.pcd --sequence DIR
      --param configs/velodyne_puck16.yaml (--initial-pose x y z r p y |
      --global-init [--num-hypotheses N]) [--save-poses out.npz]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from open3d_slam_torch.io import datasets, pcd
from open3d_slam_torch.models.map_initializer import SlamMapInitializer
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import config as cfg
from open3d_slam_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="open3d_slam localization on PyTorch/CUDA")
    ap.add_argument("--map", required=True, help="PCD map file")
    ap.add_argument("--sequence", help="folder of scan_*.npz to localize")
    ap.add_argument("--param", help="YAML/JSON parameter override file")
    ap.add_argument("--initial-pose", nargs=6, type=float, default=None,
                    metavar=("x", "y", "z", "roll", "pitch", "yaw"),
                    help="initial pose (m, rad)")
    ap.add_argument("--global-init", action="store_true",
                    help="batched multi-start ICP global localization")
    ap.add_argument("--num-hypotheses", type=int, default=None,
                    help="pose hypotheses of --global-init (default: the "
                         "configuration's capacities.localization_hypotheses)")
    ap.add_argument("--merge-scans", action="store_true",
                    help="keep extending the loaded map")
    ap.add_argument("--interactive-init-scans", type=int, default=0,
                    metavar="N",
                    help="treat the first N scans as an interactive "
                         "initialization window: merging off and the "
                         "min-refinement-fitness gate ignored until the "
                         "window closes (SlamMapInitializer::initializeWorker "
                         "gate relaxation, SlamMapInitializer.cpp:79-93)")
    ap.add_argument("--save-poses", metavar="PATH",
                    help="write the localized trajectory (times, 4x4 poses) "
                         "to this .npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def pose_from_xyzrpy(x, y, z, roll, pitch, yaw) -> np.ndarray:
    """4x4 pose from a position and roll/pitch/yaw (R = Rz Ry Rx)."""
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [x, y, z]
    return T


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    params = cfg.load_parameters_from_file(args.param) if args.param else cfg.SlamParameters()
    params.mapper.is_use_initial_map = True
    params.mapper.is_merge_scans_into_map = bool(args.merge_scans)
    params.mapper.is_attempt_loop_closures = False

    map_data = pcd.read_pcd(args.map)
    print(f"loaded map with {map_data['points'].shape[0]} points")

    slam = SlamWrapper(params, device=device)
    initializer = SlamMapInitializer(slam)
    initializer.initialize(map_data["points"])

    if not args.sequence:
        print("map loaded; provide --sequence to localize scans")
        return 0
    seq = datasets.load_sequence(args.sequence)

    if args.global_init:
        n = args.num_hypotheses or params.capacities.localization_hypotheses
        t0 = time.monotonic()
        _, fitness = initializer.relocalize(seq.scans[0], num_hypotheses=n)
        print(f"global init: fitness {fitness:.3f} in "
              f"{time.monotonic() - t0:.2f} s over {n} hypotheses")
    elif args.initial_pose is not None:
        slam.set_initial_transform(pose_from_xyzrpy(*args.initial_pose))

    if args.interactive_init_scans > 0:
        initializer.begin_interactive_init()
    for i, (scan, ts) in enumerate(zip(seq.scans, seq.timestamps)):
        if args.interactive_init_scans and i == args.interactive_init_scans:
            initializer.finish_initialization()
        slam.process_scan(scan, ts)
        initializer.notify_scan_processed()
        T = slam.mapper.map_to_range_sensor
        print(f"t={ts:.2f} pose xyz=({T[0, 3]:.2f}, {T[1, 3]:.2f}, {T[2, 3]:.2f})")
    if args.save_poses:
        times, poses = slam.get_trajectory()
        np.savez(args.save_poses, times=np.asarray(times), poses=np.stack(poses))
        print("wrote", args.save_poses)
    return 0


if __name__ == "__main__":
    sys.exit(main())
