"""Port vs JAX: the voxel merge engine, voxel and random downsampling, and
the fused submap insert.

The output order (packed-key order, valid first) and the masks must match
exactly.  Positions are per-voxel means rebuilt as voxel centre + mean
residual; the JAX package takes the segment sums as differences of a
float32 running sum and the port as differences of an exact fixed-point
one, so means agree to the float32 running sum's rounding.  Positions sum
voxel-local residuals and normals unit vectors, so 1e-4 holds at these
sizes; colours sum absolute values in [0, 1], whose running sum over n rows
rounds to about n * 2^-24, so they get n * 2^-22.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.ops import croppers as jcrop, sorted_store as jstore, voxel as jvox
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_torch.ops import croppers as tcrop, sorted_store as tstore, voxel as tvox
from open3d_slam_torch.utils import pointcloud as tpc

ATOL = 1e-4


def _cloud(rng, n, n_valid, extent=6.0, colors=True):
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32) if colors else None
    mask = np.zeros(n, bool)
    mask[:n_valid] = True
    rng.shuffle(mask)
    j = jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask), normals=jnp.asarray(nrm),
                       colors=None if col is None else jnp.asarray(col))
    t = tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                       normals=torch.from_numpy(nrm),
                       colors=None if col is None else torch.from_numpy(col))
    return j, t


def _assert_same_cloud(t, j, n_rows=4096):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    m = t.mask.numpy()
    np.testing.assert_allclose(t.points.numpy()[m], np.asarray(j.points)[m], atol=ATOL)
    color_atol = n_rows * 2.0 ** -22     # n_rows: rows merged
    for a, b, atol in ((t.normals, j.normals, ATOL), (t.colors, j.colors, color_atol)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], atol=atol)


@pytest.mark.parametrize("voxel,out_cap", [
    (0.5, 4096),   # every voxel fits: the contiguous branch
    (0.25, 512),   # more voxels than slots: the uniform-stride branch
])
def test_voxel_downsample_matches_jax(rng, voxel, out_cap):
    j, t = _cloud(rng, 4096, 3500)
    _assert_same_cloud(tvox.voxel_downsample(t, voxel, out_capacity=out_cap),
                       jvox.voxel_downsample(j, voxel, out_capacity=out_cap))


def test_merge_exact_passthrough_matches_jax(rng):
    """OUT_OF_REGION rows are singletons carried bit-exactly through the sort;
    in-region rows merge by voxel."""
    j, t = _cloud(rng, 2048, 1800, colors=False)
    inside = np.asarray(j.points)[:, 0] < 2.0
    jk, jb = jvox.span_keys(j.points, j.mask & jnp.asarray(inside), 0.5)
    jk = jnp.where(j.mask & ~jnp.asarray(inside), jnp.int32(jvox.OUT_OF_REGION), jk)
    tk, tb = tvox.span_keys(t.points, t.mask & torch.from_numpy(inside), 0.5)
    tk = torch.where(t.mask & ~torch.from_numpy(inside),
                     torch.full_like(tk, tvox.OUT_OF_REGION), tk)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jm = jvox.merge_clouds_by_voxel(jk, j.points, j.normals, None, 0.5, jb, 2048,
                                    exact_passthrough=True)
    tm = tvox.merge_clouds_by_voxel(tk, t.points, t.normals, None, 0.5, tb, 2048,
                                    exact_passthrough=True)
    _assert_same_cloud(tm, jm)
    m = tm.mask.numpy()
    singles = m & (np.asarray(jm.points)[:, 0] >= 2.0)
    assert singles.sum() > 100
    np.testing.assert_array_equal(tm.points.numpy()[singles],
                                  np.asarray(jm.points)[singles])


def test_random_downsample_with_jax_scores(rng):
    """The port takes the uniform scores as an input: fed JAX's draws it keeps
    exactly JAX's rows."""
    j, t = _cloud(rng, 2048, 1500)
    key = jax.random.PRNGKey(7)
    jr = jvox.random_downsample(j, 600, key)
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (2048,))))
    tr = tvox.random_downsample(t, 600, scores)
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    assert int(tr.count()) == 600


@pytest.mark.parametrize("with_map", [False, True])
def test_insert_scan_fused_matches_jax(rng, with_map):
    """Transform, crop and re-merge a scan into a map (the submap insert)."""
    jmap, tmap = _cloud(rng, 4096, 2500 if with_map else 0, extent=10.0, colors=False)
    jscan, tscan = _cloud(rng, 1024, 1000, extent=12.0, colors=False)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.7, -0.3, 0.1]
    jc, tc = jcrop.max_radius(9.0), tcrop.max_radius(9.0)
    jo = jstore.insert_scan_fused(jmap, jscan, jnp.asarray(T), jc, 0.4, jnp.bool_(True))
    to = tstore.insert_scan_fused(tmap, tscan, torch.from_numpy(T), tc, 0.4,
                                  torch.tensor(True))
    _assert_same_cloud(to, jo)
