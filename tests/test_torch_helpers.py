"""The last helpers the port took from the JAX package, against it on the
same inputs: the buffers' accessors and ``ThreadSafeBuffer``, the point
cloud's channel checks and ``masked_points``, the universal time scale and
``Timer.elapsed_ms`` and ``se3.identity`` (the JAX package's
``TelemetryRegistry.sync`` beside them; the port's recorder has none).
Host-side values are equal, not close (same float64 arithmetic); the
masked points are float32 on both sides and equal."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_tpu.models import buffers as jbuf
from open3d_slam_tpu.utils import pointcloud as jpc, se3 as jse3, timeutil as jtime
from open3d_slam_torch.models import buffers as tbuf
from open3d_slam_torch.utils import pointcloud as tpc, se3 as tse3, timeutil as ttime


def _shift(T):
    T = np.array(T)
    T[:3, 3] += [1.0, -2.0, 0.5]
    return T


def _filled(mod, rng):
    buf = mod.TransformInterpolationBuffer(size_limit=6)
    for t in np.cumsum(rng.uniform(0.05, 0.2, 9)):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        buf.push(float(t), T)
    return buf


@pytest.mark.parametrize("apply", ["interval", "all"])
def test_interpolation_buffer_accessors_match_jax(rng, apply):
    """earliest/latest after the size cap dropped the oldest, then a
    rewrite of an interval or of every pose, read back pose by pose."""
    a, b = _filled(jbuf, np.random.default_rng(3)), _filled(tbuf, np.random.default_rng(3))
    assert tbuf.TransformInterpolationBuffer().empty()
    assert (b.earliest_time(), b.latest_time()) == (a.earliest_time(), a.latest_time())
    t0, t1 = a._times[1], a._times[3]
    for buf in (a, b):
        if apply == "interval":
            buf.apply_to_all_in_interval(t0, t1, _shift)
        else:
            buf.apply_to_all(_shift)
    assert b._times == a._times
    for ta, tb in zip(a._transforms, b._transforms):
        np.testing.assert_array_equal(tb, ta)
    moved = [t0 <= t <= t1 or apply == "all" for t in a._times]
    assert sum(moved) == (3 if apply == "interval" else len(a._times))


def test_circular_and_thread_safe_buffers_match_jax():
    for mod in (jbuf, tbuf):
        assert mod.CircularBuffer(2).peek_front() is None
    a, b = jbuf.CircularBuffer(3), tbuf.CircularBuffer(3)
    for i in range(5):
        a.push(i)
        b.push(i)
        assert (b.peek_front(), b.peek_back(), len(b)) == (a.peek_front(), a.peek_back(), len(a))
    a.clear()
    b.clear()
    assert len(b) == len(a) == 0 and b.pop() is a.pop() is None

    ja, tb = jbuf.ThreadSafeBuffer(), tbuf.ThreadSafeBuffer()
    assert tb.pop_all() == ja.pop_all() == []
    threads = [threading.Thread(target=lambda k=k: [tb.push((k, i)) for i in range(500)])
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(tb) == 4000
    got = tb.pop_all()
    assert sorted(got) == [(k, i) for k in range(8) for i in range(500)]
    assert len(tb) == 0
    for k in range(3):
        ja.push(k)
        tb.push(k)
    assert tb.pop_all() == ja.pop_all() == [0, 1, 2]


def test_pointcloud_channels_and_masked_points_match_jax(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    for kw in ({}, {"normals": pts}, {"colors": np.abs(pts)}):
        a = jpc.from_numpy(pts, capacity=128, **kw)
        b = tpc.from_numpy(pts, capacity=128, **kw)
        assert (b.has_normals(), b.has_colors()) == (a.has_normals(), a.has_colors())
    a, b = jpc.from_numpy(pts, capacity=128), tpc.from_numpy(pts, capacity=128)
    np.testing.assert_array_equal(b.masked_points().numpy(), np.asarray(a.masked_points()))
    np.testing.assert_array_equal(b.masked_points(-5.0).numpy(),
                                  np.asarray(a.masked_points(-5.0)))
    assert float(b.masked_points()[127, 0]) == 1e9


@pytest.mark.parametrize("seconds", [0.0, 1e-7, 0.1, 2.5e-5, 12345.678901, -3.25])
def test_time_scale_matches_jax(seconds):
    assert ttime.from_seconds(seconds) == jtime.from_seconds(seconds)
    ticks = jtime.from_seconds(seconds)
    assert ttime.to_seconds(ticks) == jtime.to_seconds(ticks)
    unix = 1.7e9 + seconds
    assert ttime.from_unix_seconds(unix) == jtime.from_unix_seconds(unix)
    t = jtime.from_unix_seconds(unix)
    assert ttime.to_unix_seconds(t) == jtime.to_unix_seconds(t)
    assert ttime.TICKS_PER_SECOND == jtime.TICKS_PER_SECOND
    assert ttime.EPOCH_OFFSET_SECONDS == jtime.EPOCH_OFFSET_SECONDS


def test_timer_elapsed_identity_and_sync():
    timer = ttime.Timer("stage")
    timer.start()
    first = timer.elapsed_ms()
    assert 0.0 <= first <= timer.elapsed_ms()
    assert timer.stop() >= first and timer.count == 1
    np.testing.assert_array_equal(tse3.identity().numpy(), np.asarray(jse3.identity()))
    assert tse3.identity(torch.float64).dtype == torch.float64
    for enabled in (True, False):
        jx = jnp.ones(3)
        assert jtime.TelemetryRegistry(enabled=enabled).sync(jx) is jx
