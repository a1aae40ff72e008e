"""The traffic generators repeat exactly for a seed and differ across seeds."""
import numpy as np
import pytest

from perfbench import core
from perfbench.generators import lidar

SEED = 2**31 + 12345          # seeds may pass 32 signed bits


def _sequence(seed, n, sensor_cols=90, log=0):
    files = core.cell_files(core.benchmark(), "vlp16_mapping.revisit_loops")
    sensor = dict(files["config"]["sensor"], azimuth_steps=sensor_cols)
    return lidar.circle_logs(files["traffic"], sensor, seed, log + 1, n, "cpu")[log]


def test_scans_repeat_for_a_seed_and_differ_across_seeds():
    a, b, c = _sequence(SEED, 4), _sequence(SEED, 6), _sequence(SEED + 1, 4)
    for i in range(4):          # a scan does not depend on how many came before
        np.testing.assert_array_equal(a.scans[i], b.scans[i])
    np.testing.assert_array_equal(a.ground_truth, b.ground_truth[:4])
    np.testing.assert_array_equal(a.ground_truth, c.ground_truth)   # one route
    assert not any(np.array_equal(a.scans[i], c.scans[i]) for i in range(4))
    assert all(s.dtype == np.float32 and s.shape[1] == 3 for s in a.scans)
    d = _sequence(SEED, 4, log=1)       # each log starts elsewhere on the lap
    assert not np.array_equal(a.ground_truth, d.ground_truth)


def test_a_scan_hits_the_world_where_its_pose_says():
    seq = _sequence(SEED, 1, sensor_cols=1800)
    pts = seq.scans[0]
    assert 0.5 * 28800 < len(pts) <= 28800
    r = np.linalg.norm(pts, axis=1)
    assert r.min() > 0.9 and r.max() < 100.0


def test_the_same_yard_for_every_seed():
    files = core.cell_files(core.benchmark(), "vlp16_mapping.revisit_loops")
    w = files["traffic"]["world"]
    worlds = [lidar.YardWorld(w["extent"], w["n_buildings"], w["n_poles"], w["seed"], None)
              for _ in range(2)]
    np.testing.assert_array_equal(worlds[0].box_lo, worlds[1].box_lo)
    np.testing.assert_array_equal(worlds[0].cylinders, worlds[1].cylinders)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31 + 5, 2**40])
def test_stream_seeds_take_large_seeds(seed):
    s = lidar.stream_seed(seed, 3, 0)
    assert 0 <= s < 2**63
