"""Mapping CLI — the port's ``mapping_node``.

Port of ``open3d_slam_tpu.cli.mapping`` (``mapping_node.cpp:14-46`` with
the offline replay of ``RosbagRangeDataProcessorRos.cpp:52-125``): load the
layered config, replay a scan sequence as fast as possible (pipelined unless
``--no-pipeline``), optionally accumulating N clouds into one scan and
stopping after a wall-clock budget, ``finish_processing``, save the map,
the submaps or the dense submaps, then evaluate the trajectory against the
sequence's ground truth.  Runs on ``cuda`` unless ``--device cpu`` is given.
With ``--trace-out PATH`` the program's spans (``utils.timeutil.telemetry``)
are recorded from the warm-up's end to the replay's and written to PATH
as Chrome-trace JSON, on the Unix clock a ``torch.profiler`` export uses.

Usage:
  python -m open3d_slam_torch.cli.mapping --sim vlp16_yard_circle
      [--device cuda|cpu] [--max-scans N] [--param <yaml>] [--undistort]
      [--eval-json PATH] [--save-map] [--save-submaps] [--save-dense-submaps]
      [--save-folder DIR] [--num-accumulated-range-data N] [--max-wall-sec S]
      [--trace-out PATH]
  python -m open3d_slam_torch.cli.mapping --kitti DIR   (velodyne/*.bin,
      times.txt, poses.txt; the HDL-64 config unless --param is given)
  python -m open3d_slam_torch.cli.mapping --sequence DIR --param <yaml>
      --save-map --save-folder DIR    (then cli.localization --map DIR/map.pcd)
  python -m open3d_slam_torch.cli.mapping --synthetic N --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from open3d_slam_torch.io import datasets, lidar_sim
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import config as cfg, evaluation
from open3d_slam_torch.utils.device import resolve_device
from open3d_slam_torch.utils.timeutil import telemetry

SKIP_FIRST_N_POINT_CLOUDS = 5  # magic.hpp:15, DataProcessorRos.cpp:34-41


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="open3d_slam mapping on PyTorch/CUDA")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate and run an N-scan synthetic circle sequence")
    ap.add_argument("--sequence", help="folder of scan_*.npz, *.pcd or KITTI "
                    "scans (io.datasets.load_sequence)")
    ap.add_argument("--sim", metavar="NAME",
                    help="run a named simulated spinning-beam sequence "
                         "(io.lidar_sim.BENCHMARK_SEQUENCES; 'list' to enumerate)")
    ap.add_argument("--kitti", metavar="DIR",
                    help="replay a KITTI odometry sequence directory (velodyne/*.bin "
                         "and optional times.txt, poses.txt); defaults to the "
                         "HDL-64 sensor config")
    ap.add_argument("--max-scans", type=int, default=0,
                    help="replay at most this many scans of the sequence")
    ap.add_argument("--param", help="YAML/JSON parameter override file")
    ap.add_argument("--undistort", action="store_true",
                    help="enable constant-velocity motion compensation")
    ap.add_argument("--eval-json", metavar="PATH",
                    help="write ATE/RPE/RTF metrics as JSON")
    ap.add_argument("--save-folder", default="./o3d_slam_out")
    ap.add_argument("--save-map", action="store_true",
                    help="write the assembled map to <save-folder>/map.pcd")
    ap.add_argument("--save-submaps", action="store_true",
                    help="write each submap's map to <save-folder>/submap_<i>.pcd")
    ap.add_argument("--save-dense-submaps", action="store_true",
                    help="write each submap's dense map to "
                         "<save-folder>/dense_submap_<i>.pcd")
    ap.add_argument("--num-accumulated-range-data", type=int, default=1,
                    help="clouds concatenated into one scan (DataProcessorRos)")
    ap.add_argument("--max-wall-sec", type=float, default=0.0,
                    help="stop the replay after this many wall seconds (0: no "
                         "limit); finish_processing still runs")
    ap.add_argument("--no-skip-first", action="store_true",
                    help="replay the first clouds too (the reference skips 5)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serialize the per-scan stages instead of the default "
                         "pipelined replay")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="record the program's spans and write them to PATH as "
                         "Chrome-trace JSON (Unix microseconds) when the replay ends")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def load_params(param_file: Optional[str]) -> cfg.SlamParameters:
    """A parameter file, or the packaged layered defaults."""
    return cfg.load_parameters_from_file(param_file or cfg.config_path("default.yaml"))


def run_sequence(slam: SlamWrapper, seq: datasets.SyntheticSequence,
                 skip_first: int = SKIP_FIRST_N_POINT_CLOUDS,
                 pipelined: bool = True, num_accumulated: int = 1,
                 max_wall_sec: float = 0.0) -> float:
    """Offline replay; returns the realtime factor (data time / wall time).
    Every ``num_accumulated`` clouds are concatenated into one scan, stamped
    with the last one's time; with ``max_wall_sec`` > 0 the replay stops
    after that many wall seconds."""
    t_start = time.monotonic()
    n = 0
    accum = []
    t_first = t_last = None
    for i, (scan, ts) in enumerate(zip(seq.scans, seq.timestamps)):
        if max_wall_sec > 0 and time.monotonic() - t_start > max_wall_sec:
            print(f"--max-wall-sec {max_wall_sec:g} reached; stopping at scan "
                  f"{i}/{len(seq.scans)}")
            break
        if i < skip_first:
            continue
        accum.append(scan)
        if len(accum) < num_accumulated:
            continue
        points = np.concatenate(accum, axis=0)
        accum = []
        # Backpressure (RosbagRangeDataProcessorRos.cpp:69-84): the replay
        # keeps at most one scan in flight, so the buffers never fill here.
        while slam.is_odometry_buffer_full() or slam.is_mapping_buffer_full():
            slam.process_queued()
        if pipelined:
            slam.process_scan_pipelined(points, ts)
        else:
            slam.process_scan(points, ts)
        t_first = ts if t_first is None else t_first
        t_last = ts
        n += 1
    slam.finish_processing()
    wall = time.monotonic() - t_start
    data = t_last - t_first if n > 1 else 0.0
    rtf = data / wall if wall > 0 else 0.0
    print(f"DONE: {data:.1f} s of data in {wall:.1f} s -> {rtf:.2f}x realtime "
          f"({n} scans)")
    return rtf


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sim and args.sim not in lidar_sim.BENCHMARK_SEQUENCES:
        print("available --sim sequences:",
              ", ".join(sorted(lidar_sim.BENCHMARK_SEQUENCES)))
        return 0 if args.sim == "list" else 2
    device = resolve_device(args.device)

    if args.sim:
        spec = lidar_sim.BENCHMARK_SEQUENCES[args.sim]
        if args.param is None:   # each sim sequence names its sensor config
            args.param = cfg.config_path(spec.param_file)
            print("using sensor config", args.param)
        print(f"rendering simulated sequence {spec.name} ({spec.n_scans} scans)...")
        seq = lidar_sim.make_sim_sequence(spec, cache_dir="")
        seq_name = spec.name
    elif args.kitti:
        from open3d_slam_torch.io import kitti
        vdir = args.kitti
        if os.path.isdir(os.path.join(vdir, "velodyne")):
            seq_dir, vdir = vdir, os.path.join(vdir, "velodyne")
        else:
            seq_dir = os.path.dirname(vdir.rstrip("/")) or vdir
        seq = kitti.load_kitti_sequence(
            vdir, times_file=os.path.join(seq_dir, "times.txt"),
            poses_file=os.path.join(seq_dir, "poses.txt"),
            max_scans=args.max_scans or None)
        seq_name = "kitti_" + os.path.basename(os.path.abspath(seq_dir))
        if args.param is None:
            args.param = cfg.config_path("velodyne_hdl64_kitti.yaml")
            print("using sensor config", args.param)
    elif args.sequence:
        seq = datasets.load_sequence(args.sequence)
        seq_name = os.path.basename(os.path.normpath(args.sequence))
    elif args.synthetic:
        seq = datasets.make_synthetic_sequence(
            n_scans=args.synthetic, trajectory="circle",
            radius=12.0, angle_total=2 * np.pi * 1.05)
        seq_name = f"synthetic_circle_{args.synthetic}"
    else:
        print("need --sequence, --sim, --kitti or --synthetic", file=sys.stderr)
        return 2
    if args.max_scans:
        seq = datasets.SyntheticSequence(
            scans=seq.scans[:args.max_scans],
            timestamps=seq.timestamps[:args.max_scans],
            ground_truth=seq.ground_truth[:args.max_scans])

    params = load_params(args.param)
    if args.undistort:
        params.motion_compensation.is_undistort_input_cloud = True
    if args.save_map:
        params.saving.is_save_map = True
    if args.save_submaps:
        params.saving.is_save_submaps = True
    if args.save_dense_submaps:
        params.saving.is_save_dense_submaps = True
    slam = SlamWrapper(params, device=device)
    slam.folder_path = args.save_folder
    n_skip = 0 if args.no_skip_first else SKIP_FIRST_N_POINT_CLOUDS
    t0 = time.time()
    slam.warmup(scans=seq.scans[:n_skip], timestamps=seq.timestamps[:n_skip])
    print(f"warmed up in {time.time() - t0:.1f} s")
    if args.trace_out:
        telemetry.start_recording()
    rtf = run_sequence(slam, seq, skip_first=n_skip, pipelined=not args.no_pipeline,
                       num_accumulated=args.num_accumulated_range_data,
                       max_wall_sec=args.max_wall_sec)
    if args.trace_out:
        rec = telemetry.stop_recording()
        os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)), exist_ok=True)
        rec.write_chrome_trace(args.trace_out)
        print(f"wrote {len(rec.spans)} spans to {args.trace_out}")
    if params.saving.is_save_map or params.saving.is_save_at_mission_end:
        print("saved map to", slam.save_map())
    if params.saving.is_save_submaps:
        slam.dump_submaps("submap")
    if params.saving.is_save_dense_submaps:
        slam.dump_submaps("dense_submap", dense=True)

    times, poses = slam.get_trajectory()
    if not seq.ground_truth or len(poses) <= 2:
        print("no ground truth or fewer than 3 poses: nothing to evaluate",
              file=sys.stderr)
        return 1 if args.eval_json else 0
    ate_res, rpe_res = evaluation.evaluate_trajectory(
        seq.ground_truth, poses, gt_times=seq.timestamps, est_times=times,
        rpe_delta=10)
    print(ate_res)
    print(rpe_res)
    if args.eval_json:
        metrics = {
            "sequence": seq_name, "device": str(device),
            "n_scans": len(seq.scans), "n_poses": ate_res.n,
            "ate_rmse_m": ate_res.rmse, "ate_mean_m": ate_res.mean,
            "ate_max_m": ate_res.max, "rpe_trans_rmse_m": rpe_res.trans_rmse,
            "rpe_rot_rmse_deg": rpe_res.rot_rmse_deg,
            "drift_pct": rpe_res.drift_pct, "rtf": rtf,
            **slam.get_health(),
            "argv": list(argv) if argv is not None else sys.argv[1:],
        }
        out_dir = os.path.dirname(os.path.abspath(args.eval_json))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.eval_json, "w") as f:
            json.dump(metrics, f)
        print("wrote", args.eval_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
