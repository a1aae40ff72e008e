"""LiDAR odometry (scan-to-scan).

Port of ``open3d_slam_tpu.models.odometry`` (reference ``Odometry.cpp``):
preprocess (crop -> voxelize -> random downsample -> compact -> normals),
register the PREVIOUS processed cloud against the NEW one, fitness gate
``fitness > 0.1``, cumulative pose ``odomToRangeSensorCumulative *= T^-1``.

The step is dispatch-only: its results ride an ``OdometryPending`` into the
mapping stage and are pulled there in ONE device->host transfer together
with the scan-to-map result.  The float64 host chain is the truth; the
float32 device mirror of the cumulative pose feeds the mapper's motion
prediction and is re-anchored on the host chain at every finalize.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from open3d_slam_torch.models.buffers import TransformInterpolationBuffer
from open3d_slam_torch.models.cloud_registration import (
    PreparedCloud, cloud_registration_factory)
from open3d_slam_torch.ops import croppers, gn_graph, normals as normals_ops, voxel
from open3d_slam_torch.utils import pointcloud as pclib, se3
from open3d_slam_torch.utils.config import OdometryParameters
from open3d_slam_torch.utils.device import to_device, to_host
from open3d_slam_torch.utils.pointcloud import PointCloud
from open3d_slam_torch.utils.timeutil import telemetry


class UniformScores:
    """Seeded uniform downsample scores, one generator per owner (the
    counterpart of the JAX package's per-owner ``PRNGKey``).  Called with the
    row count; tests replace an owner's ``draw_scores`` with JAX's draws."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __call__(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.generator, device=self.device)


_CHANNELS = ("points", "mask", "normals", "colors")


def _chain(cloud: PointCloud, scores: Optional[torch.Tensor], cropper, radius: float,
           voxel_size: float, out_capacity: int, n_keep: int, keep_capacity: int,
           needs_normals: bool, max_nn: int) -> PointCloud:
    with telemetry.stage("downsample"):
        cropped = cropper.crop(cloud)
        down = voxel.voxel_downsample(cropped, voxel_size, out_capacity=out_capacity)
        if n_keep > 0:
            kept = voxel.random_downsample(down, n_keep, scores)
            kept = pclib.compact_to(kept, keep_capacity)
    if n_keep > 0:
        if needs_normals:
            kept = normals_ops.estimate_normals_at(kept, down, radius, max_nn=max_nn)
        return kept
    if needs_normals:
        down = normals_ops.estimate_normals(down, radius, max_nn=max_nn)
    return down


def preprocess_chain(cloud: PointCloud, cropper, radius: float,
                     draw_scores: Callable[[int], torch.Tensor],
                     voxel_size: float, out_capacity: int, n_keep: int,
                     keep_capacity: int, needs_normals: bool,
                     max_nn: int) -> PointCloud:
    """crop -> voxelize -> [random downsample -> compact] -> normals
    (``Odometry.cpp:25-30`` order).  With a downsample, normals are
    estimated only at the kept points with the FULL voxelized cloud as
    support, which gives the same planes as estimate-then-downsample.

    The downsample scores are drawn first, eagerly, from the owner's
    ``draw_scores`` (none without a downsample).  On the card
    (``gn_graph.MODE == "graph"``) the rest is one CUDA graph per key
    (``gn_graph.run_program``: the cropper, every size and radius, and the
    layouts of the cloud's channels and the scores), replayed on static
    copies of the cloud and the scores and cloned out; it reads nothing
    back, and its outputs are the eager chain's bit for bit.  The crop and
    the downsampling are the caller's layer's ``downsample`` span and the
    normals its ``normals.*`` spans: on the card they mark the capture only,
    and a replay counts ``graph_replays`` in the caller's ``preprocess``
    span."""
    scores = draw_scores(out_capacity) if n_keep > 0 else None
    sizes = (float(radius), voxel_size, out_capacity, n_keep, keep_capacity,
             needs_normals, max_nn)
    inputs = {c: getattr(cloud, c) for c in _CHANNELS if getattr(cloud, c) is not None}
    if scores is not None:
        inputs["scores"] = scores

    def program(x):
        def body():
            out = _chain(PointCloud(x["points"], x["mask"], x.get("normals"), x.get("colors")),
                         x.get("scores"), cropper, *sizes)
            return tuple(getattr(out, c) for c in _CHANNELS if getattr(out, c) is not None)
        return body

    outs = gn_graph.run_program("preprocess", (cropper, *sizes), inputs, program)
    # The chain keeps the cloud's channels and adds normals where it estimates them.
    present = [c for c in _CHANNELS if c in inputs or (c == "normals" and needs_normals)]
    return PointCloud(**dict(zip(present, outs)))


class OdometryPending:
    """Device-side result of one dispatched odometry step."""
    __slots__ = ("owner", "timestamp", "fitness", "rmse", "T", "cum_new",
                 "ok", "is_initial")

    def __init__(self, owner, timestamp, fitness, rmse, T, cum_new, ok,
                 is_initial=False):
        self.owner = owner
        self.timestamp = timestamp
        self.fitness = fitness      # device scalar
        self.rmse = rmse            # device scalar
        self.T = T                  # device (4, 4)
        self.cum_new = cum_new      # device (4, 4): cumulative AFTER this scan
        self.ok = ok                # device bool: fitness gate
        self.is_initial = is_initial


class LidarOdometry:
    def __init__(self, params: Optional[OdometryParameters] = None,
                 processed_capacity: int = 16384,
                 buffer_size_limit: int = 2000, device="cuda"):
        self.params = params or OdometryParameters()
        self.device = torch.device(device)
        self.processed_capacity = processed_capacity
        self.registration = cloud_registration_factory(self.params.scan_matcher)
        self.cropper = croppers.from_cropper_params(self.params.scan_processing.cropper)
        self.odom_to_range_sensor_cumulative = np.eye(4)
        self.odom_buffer = TransformInterpolationBuffer(buffer_size_limit)
        self.prev: Optional[PreparedCloud] = None
        self.last_timestamp: Optional[float] = None
        self._initial_transform: Optional[np.ndarray] = None
        self.draw_scores: Callable[[int], torch.Tensor] = UniformScores(0, self.device)
        self._cum_dev = torch.eye(4, device=self.device)
        self._pending: list = []
        self.n_failed = 0

    def _eye(self) -> torch.Tensor:
        return torch.eye(4, dtype=torch.float32, device=self.device)

    @telemetry.spanned("odometry.preprocess")
    def preprocess(self, cloud: PointCloud) -> PointCloud:
        sp = self.params.scan_processing
        ratio = sp.down_sampling_ratio
        n_keep = int(round(self.processed_capacity * ratio)) if ratio < 1.0 else 0
        return preprocess_chain(
            cloud, self.cropper, float(self.params.scan_matcher.icp.max_distance_knn),
            self.draw_scores, voxel_size=sp.voxel_size,
            out_capacity=self.processed_capacity, n_keep=n_keep,
            keep_capacity=pclib.padded_capacity(max(n_keep, 1)),
            needs_normals=self.registration.needs_normals(),
            max_nn=self.params.scan_matcher.icp.knn)

    @telemetry.spanned("odometry.scan")
    def add_range_scan_async(self, cloud: PointCloud, timestamp: float):
        """Dispatch one odometry step without blocking.  Returns an
        ``OdometryPending``, True for the first scan, False for an
        out-of-order drop (``Odometry.cpp:32-79``)."""
        if self.prev is None:
            self.prev = self.registration.prepare_target(self.preprocess(cloud))
            self.odom_buffer.push(timestamp, self.odom_to_range_sensor_cumulative)
            self.last_timestamp = timestamp
            self._cum_dev = to_device(self.odom_to_range_sensor_cumulative, self.device)
            return True
        if self.last_timestamp is not None and timestamp < self.last_timestamp:
            print("LIDAR ODOMETRY WARNING: measurements came out of order!")
            return False
        prepared = self.registration.prepare_target(self.preprocess(cloud))
        # The source is the previous target: its layout's Morton order is
        # the source's query order.
        prev_target = self.prev.kernel_target
        result = self.registration.register(
            self.prev.cloud, prepared, self._eye(),
            source_order=None if prev_target is None else prev_target[-1].order)
        ok = result.fitness > 0.1   # magic gate, Odometry.cpp:51
        if self._initial_transform is not None:
            cum_new = self._cum_dev
        else:
            cum_new = torch.where(ok, self._cum_dev @ se3.inverse(result.transformation),
                                  self._cum_dev)
        self._cum_dev = cum_new
        self.prev = prepared
        pending = OdometryPending(self, timestamp, result.fitness,
                                  result.inlier_rmse, result.transformation,
                                  cum_new, ok,
                                  is_initial=self._initial_transform is not None)
        self._pending.append(pending)
        self.last_timestamp = timestamp
        return pending

    def finalize_pending(self, pulled=None, upto: Optional[float] = None) -> bool:
        """Resolve queued results into EXACT host state (float64 cumulative,
        gate prints, buffer pushes): one pull for the whole queue unless
        ``pulled`` (values in queue order) comes from the caller's batched
        transfer; ``upto`` keeps later pendings in flight."""
        if not self._pending:
            return True
        if upto is None:
            pend, self._pending = self._pending, []
        else:
            pend = [q for q in self._pending if q.timestamp <= upto]
            self._pending = [q for q in self._pending if q.timestamp > upto]
        if not pend:
            return True
        if pulled is None:
            flat = to_host(*[t for p in pend for t in (p.fitness, p.rmse, p.T)])
            pulled = [flat[3 * i:3 * i + 3] for i in range(len(pend))]
        last_ok = True
        for p, (fitness, rmse, T) in zip(pend, pulled):
            fitness = float(fitness)
            last_ok = fitness > 0.1
            if not last_ok:
                self.n_failed += 1
                print(f"Odometry failed! fitness={fitness:.3f} rmse={float(rmse):.3f}")
                continue
            if self._initial_transform is not None:
                self.odom_to_range_sensor_cumulative = self._initial_transform.copy()
                self._initial_transform = None
            else:
                self.odom_to_range_sensor_cumulative = (
                    self.odom_to_range_sensor_cumulative @
                    np.linalg.inv(np.asarray(T, np.float64)))
            self.odom_buffer.push(p.timestamp, self.odom_to_range_sensor_cumulative)
        # Re-anchor the device mirror on the float64 host chain and rebase
        # the in-flight pendings on it.
        cum = to_device(self.odom_to_range_sensor_cumulative, self.device)
        for q in self._pending:
            if q.is_initial:
                cum = q.cum_new
            else:
                cum = torch.where(q.ok, cum @ se3.inverse(q.T), cum)
            q.cum_new = cum
        self._cum_dev = cum
        return last_ok

    def add_range_scan(self, cloud: PointCloud, timestamp: float) -> bool:
        """Process one scan and return isOdomOkay (``Odometry.cpp:32-79``):
        dispatch, then finalize at once (one pull)."""
        r = self.add_range_scan_async(cloud, timestamp)
        if isinstance(r, OdometryPending):
            return self.finalize_pending()
        return r

    def get_odom_to_range_sensor(self, t: float) -> np.ndarray:
        return self.odom_buffer.lookup_clamped(t)

    def get_pre_processed_cloud(self) -> Optional[PointCloud]:
        return None if self.prev is None else self.prev.cloud

    def has_processed_measurements(self) -> bool:
        return not self.odom_buffer.empty()

    def set_initial_transform(self, T: np.ndarray):
        """``setInitialTransform`` (``Odometry.cpp:102-110``)."""
        self._initial_transform = np.asarray(T, np.float64).copy()
        self.odom_to_range_sensor_cumulative = np.asarray(T, np.float64).copy()
        self._cum_dev = to_device(self.odom_to_range_sensor_cumulative, self.device)
