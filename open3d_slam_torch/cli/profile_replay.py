"""Where a scan's time goes on the card: a profiled replay of the VLP-16
configuration as users run it (loop closures and undistortion on).

    python -m open3d_slam_torch.cli.profile_replay

Renders ``vlp16_yard_circle``, replays ``WARM_SCANS`` scans through
``SlamWrapper.process_scan_pipelined`` at the ``velodyne_puck16``
capacities, then measures the next ``MEASURED_SCANS`` scans twice:

  * stage pass: every stage below is bracketed by ``torch.cuda.synchronize``
    and timed on the host clock, so each stage's time holds its own device
    work (the syncs remove the pipeline overlap, so the stages add up to more
    than the pipelined scan);
  * profiler pass: the same number of later scans, pipelined and unsynced,
    under ``torch.profiler``; prints the wall time per scan, the device's
    busy and idle share, and the operations that take most device time.

Needs a CUDA card.  Stages (nested ones are part of their parent):
odometry.preprocess > normals (layout, kth_prepass, moments_kernel);
odometry.register > gicp; mapper.preprocess > normals; mapper.patch_prepare;
mapper.register > gicp; submap.insert; closure.features (features and
odometry constraints of a finished submap) > normals, knn; closure.job (one
phase of the loop-closure job, with the pose-graph solve when a closure is
accepted) > gicp, knn.  A closure stage appears only in windows where a
submap finishes.
"""
from __future__ import annotations

import collections
import json
import sys
import time

import numpy as np
import torch

from open3d_slam_torch.io import lidar_sim
from open3d_slam_torch.models import scan_to_map_registration as s2m
from open3d_slam_torch.models.cloud_registration import CloudRegistrationStrategy
from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.models.submap import Submap
from open3d_slam_torch.ops import cuda_gicp, cuda_knn, cuda_normals
from open3d_slam_torch.utils import config as cfg, device as devmod

WARM_SCANS = 40       # the passes then measure scans 40-69 and 70-99
MEASURED_SCANS = 30


class StageTimer:
    """Replaces methods with synchronised, timed versions while active."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._patched = []

    def wrap(self, owner, attr, label_of):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            label = label_of(*args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[label] += (time.perf_counter() - t) * 1e3
            self.calls[label] += 1
            return out

        self._patched.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched = []


def _register_label(strategy, source, target, init):
    return ("odometry.register" if source.capacity == target.cloud.capacity
            else "mapper.register")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    params = cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))
    params.mapper.is_print_timing_statistics = False
    params.motion_compensation.is_undistort_input_cloud = True
    seq = lidar_sim.make_sim_sequence(
        lidar_sim.BENCHMARK_SEQUENCES["vlp16_yard_circle"], cache_dir="")
    scans = list(zip(seq.scans, seq.timestamps))
    slam = SlamWrapper(params, device="cuda")
    for pts, ts in scans[:WARM_SCANS]:
        slam.process_scan_pipelined(pts, ts)
    torch.cuda.synchronize()

    # Stage pass.
    st = StageTimer()
    st.wrap(LidarOdometry, "preprocess", lambda *a: "odometry.preprocess")
    st.wrap(s2m.ScanToMapIcp, "preprocess", lambda *a: "mapper.preprocess")
    st.wrap(s2m, "_patch_prepare", lambda *a: "mapper.patch_prepare")
    st.wrap(CloudRegistrationStrategy, "register", _register_label)
    st.wrap(Submap, "insert_scan", lambda *a: "submap.insert")
    st.wrap(cuda_normals, "normals_layout", lambda *a: "normals.layout")
    st.wrap(cuda_normals, "kth_neighbor_d2_within", lambda *a: "normals.kth_prepass")
    st.wrap(cuda_normals, "radius_moments_at", lambda *a: "normals.moments_kernel")
    st.wrap(cuda_gicp, "gicp_normal_eq",
            lambda q, *r: f"gicp_kernel[{q.shape[1]}x{r[2].shape[-1]}]")
    st.wrap(cuda_knn, "nn_argmin", lambda q, t, *r: f"knn_kernel[{q.shape[0]}x{t.shape[1]}]")
    st.wrap(SlamWrapper, "compute_features_if_ready", lambda *a: "closure.features")
    st.wrap(SlamWrapper, "_advance_loop_closures", lambda *a: "closure.job")
    window = scans[WARM_SCANS:WARM_SCANS + MEASURED_SCANS]
    devmod.host_syncs.count = 0
    t = time.perf_counter()
    for pts, ts in window:
        slam.process_scan_pipelined(pts, ts)
    torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t) * 1e3 / len(window)
    st.restore()
    n = len(window)
    stages = {k: {"ms_per_scan": v / n, "calls_per_scan": st.calls[k] / n}
              for k, v in sorted(st.ms.items())}
    print(json.dumps({"stage_pass_ms_per_scan": synced_ms, "stages": stages}, indent=1))

    # Profiler pass.
    window = scans[WARM_SCANS + MEASURED_SCANS:WARM_SCANS + 2 * MEASURED_SCANS]
    devmod.host_syncs.count = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for pts, ts in window:
            slam.process_scan_pipelined(pts, ts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    syncs = devmod.host_syncs.count
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, end = 0.0, -1.0
    for a, b in spans:                  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:25]
    n = len(window)
    print(json.dumps({
        "profiled_scans": n, "wall_ms_per_scan": wall_ms / n,
        "device_events": len(spans),
        "device_busy_ms_per_scan": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "host_syncs_per_scan": syncs / n,
        "top_device_ops": [{"name": e.key[:90],
                            "ms_per_scan": e.self_device_time_total / 1e3 / n,
                            "calls_per_scan": e.count / n} for e in top],
    }, indent=1))
    slam.finish_processing()
    _, poses = slam.get_trajectory()
    return 0 if all(np.isfinite(T).all() for T in poses) else 1


if __name__ == "__main__":
    sys.exit(main())
