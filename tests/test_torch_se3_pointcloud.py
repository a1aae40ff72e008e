"""Port vs JAX: SE(3) utilities, the padded point cloud and the pose buffer.

Inputs come from a numpy seed and go through both packages.  Tolerance:
float32 round-off only (the two compute the same formulas, with reductions
in another order), so 1e-5 absolute on unit-scale outputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.models import buffers as jbuf
from open3d_slam_tpu.utils import pointcloud as jpc, se3 as jse3
from open3d_slam_torch.models import buffers as tbuf
from open3d_slam_torch.utils import pointcloud as tpc, se3 as tse3

ATOL = 1e-5


def _xi(rng, n, rot=0.8, trans=3.0):
    return np.concatenate([rng.uniform(-rot, rot, (n, 3)),
                           rng.uniform(-trans, trans, (n, 3))], 1).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jse3, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(tse3, fn_name)(*[torch.from_numpy(np.array(a)) for a in arrays])
    return j, t


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "se3_exp"])
def test_exp_maps_match_jax(rng, fn):
    xi = _xi(rng, 64)
    arg = xi if fn == "se3_exp" else xi[:, :3]
    j, t = _both(fn, arg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("fn", ["so3_log", "se3_log", "inverse",
                                "quat_from_matrix"])
def test_log_inverse_quat_match_jax(rng, fn):
    T = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 64))))
    arg = T[:, :3, :3] if fn in ("so3_log", "quat_from_matrix") else T
    j, t = _both(fn, arg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_points_and_rpy_match_jax(rng):
    T = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 1)[0])))
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    # |p| ~ 30 m: 1e-5 relative is ~3e-4 m.
    for fn in ("transform_points", "rotate_vectors"):
        j, t = _both(fn, T, pts)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-4)
    rpy = rng.uniform(-1.0, 1.0, (3, 16)).astype(np.float32)
    j, t = _both("rpy_to_matrix", *rpy)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    jr = jse3.matrix_to_rpy(j)
    tr = tse3.matrix_to_rpy(t)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_interpolate_and_buffer_lookup_match_jax(rng):
    T = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 2))), np.float64)
    alpha = np.float32(0.3)
    j, t = _both("interpolate", T[0].astype(np.float32), T[1].astype(np.float32), alpha)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    # The pose buffer interpolates in float32 and returns float64.
    jb, tb = jbuf.TransformInterpolationBuffer(), tbuf.TransformInterpolationBuffer()
    for b in (jb, tb):
        b.push(0.0, T[0])
        b.push(0.1, T[1])
    for when in (-1.0, 0.0, 0.025, 0.07, 0.1, 5.0):
        got, want = tb.lookup_clamped(when), jb.lookup_clamped(when)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n_valid,out_cap", [(300, 512), (700, 256), (0, 64)])
def test_compact_to_matches_jax(rng, n_valid, out_cap):
    """Valid-first STABLE order; a uniform stride of the valid points when
    they overflow the new capacity.  Exact: pure gathers."""
    n = 1024
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    nrm = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_valid, replace=False)] = True
    j = jpc.compact_to(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask),
                                      normals=jnp.asarray(nrm)), out_cap)
    t = tpc.compact_to(tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                                      normals=torch.from_numpy(nrm)), out_cap)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    m = t.mask.numpy()
    np.testing.assert_array_equal(t.points.numpy()[m], np.asarray(j.points)[m])
    np.testing.assert_array_equal(t.normals.numpy()[m], np.asarray(j.normals)[m])


def test_from_to_numpy_and_empty(rng):
    pts = rng.uniform(-1, 1, (37, 3)).astype(np.float32)
    t = tpc.from_numpy(pts, colors=pts * 0.5)
    j = jpc.from_numpy(pts, colors=pts * 0.5)
    assert t.capacity == j.capacity == 64
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(tpc.to_numpy(t)["points"], pts)
    np.testing.assert_array_equal(tpc.to_numpy(t)["colors"], pts * 0.5)
    e = tpc.empty(16, with_normals=True)
    assert e.capacity == 16 and int(e.count()) == 0 and e.normals is not None
    assert tpc.padded_capacity(1) == jpc.padded_capacity(1) == 256
    assert tpc.padded_capacity(4097) == jpc.padded_capacity(4097) == 4352
