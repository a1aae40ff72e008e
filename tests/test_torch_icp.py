"""Port vs JAX: kernel K4 (fused point-to-plane normal equations), its
helpers, and the registration loops built on it (``batched_icp_point_to_plane``
in both layouts, ``icp_point_to_plane``), with ``icp_point_to_point`` and
``evaluate_registration`` over kernel K3, on the JAX kernel path (Pallas in
interpret mode).

Tolerances.  The inlier count is exact: both sides test the same
term-by-term rounded float32 distances with the same lowest-index tie break.
The 7x7 Gram is a sum over a few hundred rows taken in another order: each
entry within 1e-5 of sqrt(|G_ii| |G_jj|), the inlier d2 sum within 1e-5 of
itself (``plain_disagreement``).  The loops take float32 steps from Grams
that differ in summation order: poses within 1e-5, fitness within 1e-6
(a ratio of equal counts), rmse within 1e-4, iteration counts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_tpu.ops import hashgrid as jh, normals as jn, pallas_icp
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.utils import pointcloud as jpc, se3 as jse3
from open3d_slam_torch.ops import cuda_icp as ti
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.ops.hashgrid import HashGrid
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import jax_kernel_path

TOL = 1e-5


def _scene(rng, n_tgt=512, n_src=128, offset=(0.08, -0.05, 0.02)):
    """A couple of noisy planes so normals are well defined (the scene of
    tests/test_pallas_icp.py)."""
    half = n_tgt // 2
    ground = np.stack([rng.uniform(-5, 5, half), rng.uniform(-5, 5, half),
                       0.01 * rng.standard_normal(half)], axis=1)
    wall = np.stack([rng.uniform(-5, 5, n_tgt - half),
                     5.0 + 0.01 * rng.standard_normal(n_tgt - half),
                     rng.uniform(0, 3, n_tgt - half)], axis=1)
    tgt = np.concatenate([ground, wall]).astype(np.float32)
    src = tgt[rng.choice(n_tgt, n_src, replace=False)] + np.asarray(offset, np.float32)
    return src, tgt


def _T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def grid_pair(rng):
    """The same hash-sorted target grid (with normals and 12 padding rows)
    in both packages, and a source cloud with a few invalid rows."""
    src, tgt = _scene(rng)
    tmask = np.ones(512, bool)
    tmask[500:] = False
    jt = jn.estimate_normals(jpc.PointCloud(points=jnp.asarray(tgt),
                                            mask=jnp.asarray(tmask)), 0.8, max_nn=12)
    jgrid = jh.build(jt, 0.5)
    tgrid = HashGrid(hashes_sorted=_T(jgrid.hashes_sorted), points_sorted=_T(jgrid.points_sorted),
                     normals_sorted=_T(jgrid.normals_sorted), order=_T(jgrid.order),
                     cell_size=0.5)
    smask = np.ones(128, bool)
    smask[::17] = False
    return (jpc.PointCloud(points=jnp.asarray(src), mask=jnp.asarray(smask)), jgrid,
            tpc.PointCloud(points=_T(src), mask=_T(smask)), tgrid)


def _jax_target(grid):
    valid = grid.hashes_sorted != jh.INT32_MAX
    return pallas_icp.prepare_target(grid.points_sorted, grid.normals_sorted, valid)


def _held(got, want, n_in_min):
    dis = ti.plain_disagreement(torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want)))
    assert dis["n_in_equal"] and dis["rest_equal"], dis
    assert dis["gram"] <= TOL and dis["d2s"] <= TOL, dis
    assert float(np.asarray(want)[:, 7, 0].min()) >= n_in_min


def test_prepare_target_and_unpack_match_jax(grid_pair):
    _, jgrid, _, tgrid = grid_pair
    want = _jax_target(jgrid)
    got = ti.prepare_target(tgrid.points_sorted, tgrid.normals_sorted,
                            tgrid.hashes_sorted != treg.INT32_MAX)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = np.random.default_rng(3).normal(size=(2, 8, 128)).astype(np.float32)
    for g, w in zip(ti.unpack(torch.from_numpy(out)), pallas_icp.unpack(jnp.asarray(out))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", ["shared", "per_element"])
def test_p2l_normal_eq_plain_matches_pallas(grid_pair, rng, layout):
    """Both layouts of the JAX signature: one target shared by a batch of
    three posed copies of the source (a shared (M, 1) mask), or a target and
    a mask per element (the second element's target shifted)."""
    jsrc, jgrid, _, _ = grid_pair
    t_t, tn_t, tc, tv = _jax_target(jgrid)
    shifts = np.asarray([[0, 0, 0], [0.05, 0.1, 0], [-0.2, 0.0, 0.03]], np.float32)
    q = np.asarray(jsrc.points)[None] + shifts[:, None]
    mask = np.asarray(jsrc.mask, np.float32)[:, None]
    if layout == "per_element":
        q = q[:2]
        mask = np.stack([mask, (rng.uniform(size=(128, 1)) > 0.3).astype(np.float32)])
        shift = np.asarray([0.0, 0.07, 0.0], np.float32)[:, None]
        t_t = jnp.stack([t_t, t_t + shift])
        tn_t, tc, tv = (jnp.stack([a, a]) for a in (tn_t, tc, tv))
        tc = tc.at[1].set(jnp.sum(t_t[1] * tn_t[1], axis=0, keepdims=True))
    r2 = jnp.full((1, 1), 0.25, jnp.float32)
    jin = (jnp.asarray(q), jnp.asarray(mask), t_t, tn_t, tc, tv, r2)
    want = pallas_icp.p2l_normal_eq(*jin, block_m=64, block_n=128, interpret=True)
    got = ti.p2l_normal_eq(*(_T(a) for a in jin))
    assert got.shape == (q.shape[0], 8, 128)
    _held(got, want, 60)


def test_p2l_normal_eq_all_targets_invalid(grid_pair):
    jsrc, jgrid, _, _ = grid_pair
    t_t, tn_t, tc, tv = _jax_target(jgrid)
    jin = (jsrc.points[None], jsrc.mask.astype(jnp.float32)[:, None], t_t, tn_t, tc,
           jnp.zeros_like(tv), jnp.full((1, 1), 1e6, jnp.float32))
    want = np.asarray(pallas_icp.p2l_normal_eq(*jin, block_m=64, block_n=128,
                                               interpret=True))
    got = ti.p2l_normal_eq(*(_T(a) for a in jin)).numpy()
    assert not want.any() and not got.any()


def test_p2l_normal_eq_ties_go_to_the_lowest_index():
    """Every target at two indices 256 apart (other tiles of the Pallas
    kernel), the second copy with another normal and offset: only the
    first copy may win, so the Grams agree only if both sides pick it."""
    rng = np.random.default_rng(11)
    base = np.round(rng.uniform(-3, 3, (256, 3)), 1).astype(np.float32)
    pts = np.concatenate([base, base])
    nrm = np.zeros((512, 3), np.float32)
    nrm[:256, 2] = 1.0
    nrm[256:, 0] = 1.0
    q = (base[rng.choice(256, 64)] + np.float32(0.01))[None]
    t_t, tn_t, tc, tv = pallas_icp.prepare_target(jnp.asarray(pts), jnp.asarray(nrm),
                                                  jnp.ones(512, bool))
    jin = (jnp.asarray(q), jnp.ones((64, 1), jnp.float32), t_t, tn_t, tc, tv,
           jnp.full((1, 1), 0.04, jnp.float32))
    want = pallas_icp.p2l_normal_eq(*jin, block_m=64, block_n=128, interpret=True)
    got = ti.p2l_normal_eq(*(_T(a) for a in jin))
    _held(got, want, 64)
    JtJ = got[0, :6, :6].numpy()
    assert JtJ[3, 3] == 0.0 and JtJ[5, 5] == 64.0     # n = +z won everywhere


@pytest.mark.parametrize("layout", ["shared", "per_element"])
def test_batched_icp_point_to_plane_matches_jax(grid_pair, layout):
    """The fused Gauss-Newton loop over a batch of inits: shared source and
    grid, or a source and a grid per element (stacked copies)."""
    jsrc, jgrid, tsrc, tgrid = grid_pair
    inits = np.stack([np.eye(4), np.asarray(jse3.se3_exp(
        jnp.asarray([0.0, 0.0, 0.03, 0.1, -0.05, 0.0], jnp.float32)))]).astype(np.float32)
    if layout == "per_element":
        jsrc = jsrc.__class__(points=jnp.stack([jsrc.points] * 2),
                              mask=jnp.stack([jsrc.mask] * 2))
        jgrid = jgrid.__class__(**{k: (jnp.stack([getattr(jgrid, k)] * 2)
                                       if k != "cell_size" else jgrid.cell_size)
                                   for k in ("hashes_sorted", "points_sorted",
                                             "normals_sorted", "order", "cell_size")})
        tsrc = tsrc.with_(points=torch.stack([tsrc.points] * 2),
                          mask=torch.stack([tsrc.mask] * 2))
        tgrid = HashGrid(*(torch.stack([getattr(tgrid, k)] * 2) for k in
                           ("hashes_sorted", "points_sorted", "normals_sorted", "order")),
                         cell_size=tgrid.cell_size)
    want = jreg.batched_icp_point_to_plane(jsrc, jgrid, jnp.asarray(inits), 0.5,
                                           max_iterations=30, interpret=True)
    got = treg.batched_icp_point_to_plane(tsrc, tgrid, torch.from_numpy(inits), 0.5,
                                          max_iterations=30)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=TOL)
    np.testing.assert_allclose(got.transformation[0, :3, 3].numpy(), [-0.08, 0.05, -0.02],
                               atol=0.02)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(got.inlier_rmse.numpy(), np.asarray(want.inlier_rmse),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))


def test_rank_stage_is_evaluate_registration(grid_pair):
    """``max_iterations=0`` returns the statistics at the inits unchanged."""
    jsrc, jgrid, tsrc, tgrid = grid_pair
    inits = torch.eye(4).repeat(3, 1, 1)
    inits[1, 0, 3] = 0.3
    got = treg.batched_icp_point_to_plane(tsrc, tgrid, inits, 0.5, max_iterations=0)
    assert torch.equal(got.transformation, inits) and not got.num_iterations.any()
    for i in range(3):
        ev = treg.evaluate_registration(tsrc, tgrid, inits[i], 0.5)
        np.testing.assert_allclose(float(got.fitness[i]), float(ev.fitness), rtol=1e-6)
        np.testing.assert_allclose(float(got.inlier_rmse[i]), float(ev.inlier_rmse),
                                   rtol=1e-5)


@pytest.mark.parametrize("retraction", ["euler", "exp"])
def test_icp_point_to_plane_matches_jax(grid_pair, retraction):
    jsrc, jgrid, tsrc, tgrid = grid_pair
    exp = retraction == "exp"
    with jax_kernel_path():
        want = jreg.icp_point_to_plane(jsrc, jgrid, jnp.eye(4), 0.5, max_iterations=50,
                                       use_exp_retraction=exp)
    got = treg.icp_point_to_plane(tsrc, tgrid, torch.eye(4), 0.5, max_iterations=50,
                                  use_exp_retraction=exp)
    assert got.transformation.shape == (4, 4)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=TOL)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse), rtol=1e-4)
    assert int(got.num_iterations) == int(want.num_iterations) > 1


def test_icp_point_to_point_matches_jax(grid_pair):
    """Point-to-point ICP with K3 correspondences against the JAX loop on
    its Pallas nearest-neighbour route; the Kabsch SVD is LAPACK's on both
    sides."""
    jsrc, jgrid, tsrc, tgrid = grid_pair
    init = np.array(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.02, 0.1, 0.0, 0.0],
                                               jnp.float32)))
    with jax_kernel_path():
        want = jreg.icp_point_to_point(jsrc, jgrid, jnp.asarray(init), 0.5,
                                       max_iterations=30)
    got = treg.icp_point_to_point(tsrc, tgrid, torch.from_numpy(init), 0.5,
                                  max_iterations=30)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=TOL)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse), rtol=1e-4)
    assert int(got.num_iterations) == int(want.num_iterations) > 1


def test_batched_point_to_point_equals_independent_runs(grid_pair):
    """The mid stage of global localization: all hypotheses' correspondences
    in one K3 launch per iteration, each hypothesis's result that of its own
    ``icp_point_to_point`` run (converged ones freeze)."""
    _, _, tsrc, tgrid = grid_pair
    rng = np.random.default_rng(5)
    inits = torch.eye(4).repeat(4, 1, 1)
    inits[:, :3, 3] = torch.from_numpy(rng.uniform(-0.3, 0.3, (4, 3)).astype(np.float32))
    batch = treg.batched_icp_point_to_point(tsrc, tgrid, inits, 0.5, max_iterations=12)
    for i in range(4):
        one = treg.icp_point_to_point(tsrc, tgrid, inits[i], 0.5, max_iterations=12)
        assert torch.equal(batch.transformation[i], one.transformation)
        assert torch.equal(batch.fitness[i], one.fitness)
        assert torch.equal(batch.inlier_rmse[i], one.inlier_rmse)
        assert int(batch.num_iterations[i]) == int(one.num_iterations)


def test_evaluate_registration_matches_jax(grid_pair):
    jsrc, jgrid, tsrc, tgrid = grid_pair
    T = np.array(jse3.se3_exp(jnp.asarray([0.01, 0.0, 0.02, 0.1, 0.0, 0.05],
                                            jnp.float32)))
    with jax_kernel_path():
        want = jreg.evaluate_registration(jsrc, jgrid, jnp.asarray(T), 0.5)
    got = treg.evaluate_registration(tsrc, tgrid, torch.from_numpy(T), 0.5)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(float(got.inlier_rmse), float(want.inlier_rmse), rtol=1e-5)
    assert int(got.num_iterations) == 0 and float(got.fitness) > 0.5


def test_euler_retraction_and_result_stats_match_jax(rng):
    x = rng.normal(scale=0.2, size=(5, 6)).astype(np.float32)
    want = np.asarray(jreg._euler_xyz_transform(jnp.asarray(x)))
    got = treg._euler_xyz_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    d2 = rng.uniform(0, 1, 64).astype(np.float32)
    w = rng.uniform(size=64) > 0.4
    smask = w | (rng.uniform(size=64) > 0.5)
    wf, wr = jreg._result_stats(jnp.asarray(d2), jnp.asarray(w), jnp.asarray(smask))
    gf, gr = treg._result_stats(torch.from_numpy(d2), torch.from_numpy(w),
                                torch.from_numpy(smask))
    np.testing.assert_allclose(float(gf), float(wf), rtol=1e-6)
    np.testing.assert_allclose(float(gr), float(wr), rtol=1e-6)
