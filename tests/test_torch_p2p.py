"""Point-to-point ICP: the weighted Kabsch step (``cuda_p2p``) against the
JAX package's ``registration._p2p_step``, and the loop restated as a start
and an iteration (``registration.batched_icp_point_to_point``), run in chunks
of ``gn_graph.DONE_CHECK_EVERY`` iterations and a remainder, against the JAX
package's ``lax.while_loop`` (``icp_point_to_point``, its K3 on the Pallas
kernel in interpret mode); the static buffers that the CUDA graphs read,
run here with the eager runner (``MODE = "static"``).

Tolerances.  The step's moments are float32 sums taken in another order than
JAX's, and its SVD is float64 where JAX's is float32: each entry of R within
``ROT_TOL`` (1e-5, some twenty roundings of an entry of size 1), t within
``ROT_TOL`` times (1 + |p_bar|), since an error e in R moves R p_bar by up to
e |p_bar| (|p_bar| is ~36 m in the far case).  The loop is held as
``test_torch_icp.test_icp_point_to_point_matches_jax`` holds it: poses within
1e-5, fitness within 1e-6 and RMSE within 1e-4 relative, iteration counts
equal.  Within the port the static path is held to the eager loop's bits.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_tpu.ops import hashgrid as jh
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.utils import pointcloud as jpc, se3 as jse3
from open3d_slam_torch.ops import cuda_p2p, gn_graph
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.ops.hashgrid import HashGrid
from open3d_slam_torch.utils import device as devmod, pointcloud as tpc

from torch_parity import jax_kernel_path

ROT_TOL = 1e-5
TOL = 1e-5
B, M = 6, 256
N_TGT, N_SRC, MAX_DIST = 512, 128, 0.5
# Initial poses: near the answer and farther, so that hypotheses converge at
# different iterations (the freeze), and one that hits the limit.
_XI = [[0.0, 0.0, 0.02, 0.1, 0.0, 0.0], [0.01, -0.02, 0.0, -0.15, 0.1, 0.02],
       [0.0, 0.03, -0.05, 0.2, -0.2, 0.05], [0.04, 0.0, 0.1, -0.3, 0.25, -0.05]]


def _rotations(rng, n, max_angle):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    xi = axes * rng.uniform(0.0, max_angle, (n, 1))
    return np.stack([np.asarray(jse3.se3_exp(jnp.asarray(np.r_[x, 0, 0, 0], jnp.float32)))[:3, :3]
                     for x in xi])


def _step_case(case, seed=0):
    """(pts, q, w) of ``B`` hypotheses of ``M`` correspondences."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, M, 3)) * np.array([4.0, 2.5, 1.0])
    if case == "planar":
        pts[..., 2] = 0.0
    if case == "far":
        pts += np.array([30.0, -20.0, 5.0])
    R = _rotations(rng, B, 0.4)
    q = np.einsum("bij,bmj->bmi", R, pts) + rng.normal(scale=0.5, size=(B, 1, 3)) \
        + rng.normal(scale=0.03, size=(B, M, 3))
    if case == "reflection":
        q[..., 2] = -q[..., 2]
    w = rng.uniform(size=(B, M)) < 0.8
    if case == "no_inliers":
        w[:] = False
    return pts.astype(np.float32), q.astype(np.float32), w


@pytest.mark.parametrize("case", ["full_rank", "reflection", "planar", "no_inliers", "far"])
def test_p2p_step_plain_matches_jax(case):
    """The plain Kabsch step of a batch against JAX's ``_p2p_step`` of each
    hypothesis: full-rank H, det(H) < 0 (the reflection sign), planar
    inliers (rank 2), no inliers (dT = I exactly) and points ~36 m from the
    origin; the wrapper on CPU tensors is the plain version."""
    pts, q, w = _step_case(case)
    got = cuda_p2p.p2p_step_plain(*(torch.from_numpy(a) for a in (pts, q, w))).numpy()
    want = np.stack([np.asarray(jreg._p2p_step(jnp.asarray(pts[i]), jnp.asarray(q[i]),
                                               jnp.asarray(w[i]))) for i in range(B)])
    if case == "no_inliers":
        assert np.array_equal(got, np.broadcast_to(np.eye(4, dtype=np.float32), got.shape))
    if case == "reflection":
        H = np.stack([cuda_p2p.p2p_moments(*(torch.from_numpy(a[i:i + 1]) for a in (pts, q, w)))
                      [0][0].numpy() for i in range(B)])
        assert (np.linalg.det(H.astype(np.float64)) < 0).all()
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=ROT_TOL)
    assert np.allclose(np.linalg.det(got[:, :3, :3].astype(np.float64)), 1.0, atol=1e-5)
    p_bar = np.array([pts[i][w[i]].mean(0) if w[i].any() else np.zeros(3) for i in range(B)])
    scale = 1.0 + np.linalg.norm(p_bar, axis=1)
    t_err = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    assert (t_err <= ROT_TOL * scale).all(), (t_err, scale)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    wrapped = cuda_p2p.p2p_step(*(torch.from_numpy(a) for a in (pts, q, w)))
    assert np.array_equal(wrapped.numpy(), got)


def test_p2p_step_wrapper_rules():
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError):
        cuda_p2p.p2p_step(torch.empty(2, 8, 3, **meta), torch.empty(2, 8, 3, **meta),
                          torch.empty(2, 8, device="meta", dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_p2p.p2p_step(torch.zeros(2, 8, 3), torch.zeros(2, 7, 3),
                          torch.zeros(2, 8, dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_p2p.p2p_step(torch.zeros(0, 8, 3), torch.zeros(0, 8, 3),
                          torch.zeros(0, 8, dtype=torch.bool))


@pytest.mark.parametrize("m", [0, 1, 2047, 2048, 2049, 4097, 14337, 16384, 16385, 65536,
                               80001, 1 << 22])
def test_cluster_size_depends_on_m_alone(m):
    """The kernel's cluster of CTAs per hypothesis: min(8, ceil(M / 2048)),
    within [1, 8], a function of M alone (the wrapper passes it for every
    B), and every CTA's chunk of ceil(M / C) points holds at least one."""
    c = cuda_p2p.cluster_size(m)
    assert 1 <= c <= cuda_p2p.MAX_CLUSTER == 8
    assert c == max(1, min(8, -(-m // 2048)))
    assert c == 1 or cuda_p2p.cluster_size(m - 1) <= c
    chunk = -(-m // c)
    assert chunk * c >= m and (m == 0 or (c - 1) * chunk < m)
    params = inspect.signature(cuda_p2p.cluster_size).parameters
    assert list(params) == ["m"]


def test_split_tool_cuts_the_kernel_source():
    """``cli.p2p_split``'s cuts each find their text once in the kernel's
    source, so its variants stay those its docstring names."""
    from open3d_slam_torch.cli import p2p_split
    from open3d_slam_torch.ops import cuda_build
    with open(f"{cuda_build.CSRC_DIR}/p2p_step.cu") as f:
        text = f.read()
    variants = p2p_split.variant_sources("cluster", text)
    assert list(variants) == ["launch", "stage", "passes", "full", "nojacobi", "nostage"]
    assert variants["full"] == text
    assert len(set(variants.values())) == len(variants)


def _scene():
    """The scene of ``test_torch_icp.grid_pair``: a noisy ground and wall, a
    hash-sorted target grid with 12 padding rows in both packages, a source
    with a few invalid rows."""
    rng = np.random.default_rng(3)
    half = N_TGT // 2
    ground = np.stack([rng.uniform(-5, 5, half), rng.uniform(-5, 5, half),
                       0.01 * rng.standard_normal(half)], axis=1)
    wall = np.stack([rng.uniform(-5, 5, N_TGT - half),
                     5.0 + 0.01 * rng.standard_normal(N_TGT - half),
                     rng.uniform(0, 3, N_TGT - half)], axis=1)
    tgt = np.concatenate([ground, wall]).astype(np.float32)
    src = tgt[rng.choice(N_TGT, N_SRC, replace=False)] + np.float32([0.08, -0.05, 0.02])
    tmask = np.ones(N_TGT, bool)
    tmask[500:] = False
    smask = np.ones(N_SRC, bool)
    smask[::17] = False
    jgrid = jh.build(jpc.PointCloud(points=jnp.asarray(tgt), mask=jnp.asarray(tmask)), 0.5)
    tgrid = HashGrid(*(torch.from_numpy(np.array(a)) for a in (
        jgrid.hashes_sorted, jgrid.points_sorted)), normals_sorted=None,
        order=torch.from_numpy(np.array(jgrid.order)), cell_size=0.5)
    inits = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32))) for x in _XI])
    return (jpc.PointCloud(points=jnp.asarray(src), mask=jnp.asarray(smask)), jgrid,
            tpc.PointCloud(points=torch.from_numpy(src), mask=torch.from_numpy(smask)), tgrid,
            inits.astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def jax_runs(scene):
    """JAX's ``icp_point_to_point`` from each init, per iteration limit."""
    jsrc, jgrid, _, _, inits = scene
    out = {}
    with jax_kernel_path():
        for iters in (4, 7, 12):
            out[iters] = [jreg.icp_point_to_point(jsrc, jgrid, jnp.asarray(T), MAX_DIST,
                                                  max_iterations=iters) for T in inits]
    return out


def _port(scene, batch, max_iterations, inits=None):
    """The port's batched loop: (result, counted host reads)."""
    _, _, tsrc, tgrid, init_np = scene
    inits = torch.from_numpy(init_np[:batch]) if inits is None else inits
    devmod.host_syncs.count = 0
    res = treg.batched_icp_point_to_point(tsrc, tgrid, inits, MAX_DIST,
                                          max_iterations=max_iterations)
    return res, devmod.host_syncs.count


def _same(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
               ("transformation", "fitness", "inlier_rmse", "num_iterations"))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("max_iterations", [4, 7, 12])
def test_point_to_point_loop_matches_jax_while_loop(scene, jax_runs, monkeypatch, batch,
                                                    max_iterations):
    """Chunks of 4 and the remainder, the freeze and the limit: the eager
    loop against JAX's ``lax.while_loop`` from each init; at most one
    counted read of ``done`` per whole chunk; the static-buffer path
    bit-equal to the eager loop with the same reads."""
    got, syncs = _port(scene, batch, max_iterations)
    for i in range(batch):
        want = jax_runs[max_iterations][i]
        np.testing.assert_allclose(got.transformation[i].numpy(),
                                   np.asarray(want.transformation), atol=TOL)
        np.testing.assert_allclose(float(got.fitness[i]), float(want.fitness), rtol=1e-6)
        np.testing.assert_allclose(float(got.inlier_rmse[i]), float(want.inlier_rmse),
                                   rtol=1e-4)
        assert int(got.num_iterations[i]) == int(want.num_iterations)
    every = gn_graph.DONE_CHECK_EVERY
    assert syncs == min(max_iterations // every, -(-int(got.num_iterations.max()) // every))
    assert syncs <= -(-max_iterations // every)
    monkeypatch.setattr(gn_graph, "MODE", "static")
    gn_graph.clear()
    static, static_syncs = _port(scene, batch, max_iterations)
    assert _same(static, got) and static_syncs == syncs
    (loop,) = gn_graph._entries.values()
    assert isinstance(loop.state, treg.P2PState)
    gn_graph.clear()


def test_static_point_to_point_leaves_an_earlier_result_alone(scene, monkeypatch):
    """Two calls of one key with other inits: the first result is cloned out
    of the static buffers, so the second leaves it as it was; each equals
    the eager loop's; another iteration limit reuses the key."""
    monkeypatch.setattr(gn_graph, "MODE", "static")
    gn_graph.clear()
    inits = torch.from_numpy(scene[4])
    first, _ = _port(scene, 4, 12, inits)
    kept = [t.clone() for t in (first.transformation, first.fitness, first.inlier_rmse,
                                first.num_iterations)]
    moved = inits.clone()
    moved[:, :3, 3] += torch.tensor([0.05, -0.03, 0.0])
    second, _ = _port(scene, 4, 12, moved)
    assert not torch.equal(second.transformation, first.transformation)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, (first.transformation, first.fitness, first.inlier_rmse, first.num_iterations)))
    third, _ = _port(scene, 4, 7, inits)
    assert len(gn_graph._entries) == 1 and gn_graph.captured() == (0, 0)
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    for res, T, iters in ((first, inits, 12), (second, moved, 12), (third, inits, 7)):
        assert _same(res, _port(scene, 4, iters, T)[0])
    gn_graph.clear()


@pytest.mark.parametrize("n", [1, 7, 128, 1000])
def test_row_sum_is_a_fixed_order_per_row(n):
    """The loop's d2 sum: within float32 rounding of a float64 sum, and each
    row's sum that of the row alone, bit for bit, at lengths that are and
    are not powers of two."""
    x = torch.from_numpy(np.random.default_rng(n).uniform(0.0, 4.0, (5, n)).astype(np.float32))
    got = treg._row_sum(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1).numpy(), rtol=1e-6)
    assert all(torch.equal(got[i], treg._row_sum(x[i:i + 1])[0]) for i in range(5))


def test_apply_left_is_the_pose_product():
    """The loop's dT @ T in its fixed order, within float32 rounding of the
    product, and row by row what each pose gives alone."""
    rng = np.random.default_rng(1)
    dT = torch.from_numpy(np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32)))
                                    for x in rng.normal(scale=0.3, size=(6, 6))]))
    T = torch.from_numpy(np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32)))
                                   for x in rng.normal(scale=2.0, size=(6, 6))]))
    got = treg._apply_left(dT, T)
    np.testing.assert_allclose(got.numpy(), (dT.double() @ T.double()).numpy(), atol=1e-5)
    assert all(torch.equal(got[i], treg._apply_left(dT[i:i + 1], T[i:i + 1])[0])
               for i in range(6))
