"""The scan preprocess chain (``odometry.preprocess_chain``: crop, voxel
merge, random downsample, compact, K2's normals) through the static buffers
its CUDA graph reads (``gn_graph.run_program``), run here with the eager
runner (``MODE = "static"``), against the eager chain (``MODE = "eager"``),
bit for bit, on both owners of the VLP-16 configuration:

- odometry (``LidarOdometry.preprocess``: ratio 1.0, normals of the
  voxelized cloud);
- mapper (``ScanToMapIcp.preprocess``: ratio 0.25, normals at the kept
  points against the voxelized support);

over three successive scans, each owner's generator advancing; the first
call's cloud is unchanged after the third.  An owner whose ``draw_scores``
is a fixed draw keeps exactly the voxels with that draw's smallest scores.
"""
import dataclasses

import numpy as np
import pytest
import torch

from open3d_slam_torch.models.odometry import LidarOdometry
from open3d_slam_torch.models.scan_to_map_registration import ScanToMapIcp
from open3d_slam_torch.ops import gn_graph, voxel
from open3d_slam_torch.utils import config as cfg, pointcloud as tpc

RAW, PROCESSED = 4096, 1024


def _scan(seed: int) -> tpc.PointCloud:
    """A ground, two walls and a few points past the croppers' radii, with
    noise, in a cloud of ``RAW`` rows (the rest invalid)."""
    rng = np.random.default_rng(seed)
    n = 3000
    ground = np.stack([rng.uniform(-12, 12, n // 2), rng.uniform(-12, 12, n // 2),
                       np.full(n // 2, -1.0)], axis=1)
    wall_x = np.stack([np.full(n // 4, 6.0), rng.uniform(-12, 12, n // 4),
                       rng.uniform(-1, 2, n // 4)], axis=1)
    wall_y = np.stack([rng.uniform(-12, 12, n - n // 2 - n // 4 - 20),
                       np.full(n - n // 2 - n // 4 - 20, -7.0),
                       rng.uniform(-1, 2, n - n // 2 - n // 4 - 20)], axis=1)
    far = rng.uniform(-60, 60, (20, 3))
    pts = np.concatenate([ground, wall_x, wall_y, far])
    pts += rng.normal(scale=0.02, size=pts.shape) + rng.uniform(-0.5, 0.5, 3)
    return tpc.from_numpy(pts.astype(np.float32), capacity=RAW, device="cpu")


def _owner(kind: str):
    p = cfg.load_parameters_from_file(cfg.config_path("velodyne_puck16.yaml"))
    if kind == "odometry":
        assert p.odometry.scan_processing.down_sampling_ratio == 1.0
        return LidarOdometry(p.odometry, processed_capacity=PROCESSED, device="cpu")
    assert p.mapper.scan_processing.down_sampling_ratio == 0.25
    return ScanToMapIcp(p.mapper, processed_capacity=PROCESSED, device="cpu")


class _FixedDraw:
    """A draw that is the same on every call: a seeded permutation of the
    rows, scaled into [0, 1)."""

    def __init__(self, n: int):
        self.scores = torch.from_numpy(
            np.random.default_rng(5).permutation(n).astype(np.float32) / n)

    def __call__(self, n: int) -> torch.Tensor:
        assert n == self.scores.shape[0]
        return self.scores.clone()


def _channels(pc: tpc.PointCloud):
    return {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)
            if getattr(pc, f.name) is not None}


@pytest.mark.parametrize("case", ["odometry", "mapper", "mapper_fixed_draw"])
def test_static_preprocess_chain_is_the_eager_chain_bit_for_bit(monkeypatch, case):
    """Three successive scans through the static buffers equal the eager
    chain's clouds channel by channel, with the same channels; the first
    call's clone out is not overwritten by the later calls; the static
    path keeps one key and captures nothing."""
    gn_graph.clear()
    kind = "mapper" if case.startswith("mapper") else "odometry"
    owners = {"eager": _owner(kind), "static": _owner(kind)}
    if case == "mapper_fixed_draw":
        for o in owners.values():
            o.draw_scores = _FixedDraw(PROCESSED)
    outs = {"eager": [], "static": []}
    for i in range(3):
        scan = _scan(100 + i)
        for mode, owner in owners.items():
            monkeypatch.setattr(gn_graph, "MODE", mode)
            outs[mode].append(owner.preprocess(scan))
        if i == 0:
            first = {k: v.clone() for k, v in _channels(outs["static"][0]).items()}
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    for want, got in zip(outs["eager"], outs["static"]):
        w, g = _channels(want), _channels(got)
        assert set(w) == set(g) == {"points", "mask", "normals"}
        for name in w:
            assert w[name].dtype == g[name].dtype and torch.equal(w[name], g[name]), name
    assert all(torch.equal(v, _channels(outs["static"][0])[k]) for k, v in first.items())
    # The scans differ, and so do their clouds.
    assert not torch.equal(outs["static"][0].points, outs["static"][1].points)
    n_keep = PROCESSED // 4 if kind == "mapper" else 0
    counts = [int(o.mask.sum()) for o in outs["static"]]
    assert counts == [n_keep or c for c in counts] and min(counts) > 0
    keys = [k for k, _ in gn_graph._entries if k[0] == "preprocess"]
    assert len(keys) == 1 and gn_graph.captured() == (0, 0)
    if case == "mapper_fixed_draw":
        owner = owners["static"]
        sp = owner.params.scan_processing
        scan = _scan(102)
        down = voxel.voxel_downsample(owner.map_builder_cropper.crop(scan), sp.voxel_size,
                                      out_capacity=PROCESSED)
        scores = owner.draw_scores(PROCESSED)
        valid = torch.nonzero(down.mask).flatten()
        lowest = valid[torch.argsort(scores[valid], stable=True)[:n_keep]]
        want = down.points[torch.sort(lowest).values]
        got = outs["static"][2]
        assert torch.equal(got.points[got.mask], want)
    gn_graph.clear()
