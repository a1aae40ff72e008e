"""The Gauss-Newton step of the fused loops and the pose applied before each
sweep (``ops/cuda_gn_step.py``, kernels in ``csrc/gn_step.cu``), on the CPU
through their plain versions, against the JAX package.

- ``gn_step_plain`` (the statistics, the stop test, the 6x6 solve, the
  retraction, dT P and the freeze) against the JAX loop body's pieces:
  ``pallas_icp.unpack``'s statistics, ``_solve6``, ``se3.se3_exp`` or
  ``_euler_xyz_transform``, Open3D's stop rule; both retractions, B = 1 and
  B = 5, at the start and in an iteration with some elements done.  Counts
  and flags exact; fitness and RMSE to 1e-6 relative (the same IEEE
  operations); the solve to 1e-4 relative and 1e-5 absolute, as
  ``test_torch_gn_graph.test_solve6_plain_matches_jax``; poses to 1e-5 (R
  entries, and t relative to 1 + |t|: float32 steps from solves in another
  order).
- ``gn_apply_plain`` against ``se3.transform_points`` and
  ``pallas_gicp.rotate_cov6``: within 1e-6 of the largest term's magnitude
  (a few float32 roundings of a three-term sum).
- The kernels' orders against the loops' earlier chain in the port: the
  point apply's chain of fused multiply-adds gives ``se3.transform_points``'s
  and ``cuda_gicp.rotate_cov6``'s bits; ``solve6_plain`` is within the
  solve's tolerance of ``solve6_chain``.
- The fused GICP and point-to-plane loops through the new wrappers against
  the same loops written as the chain they ran before (``_ChainLoop``):
  equal, bit for bit (the CPU path runs the plain versions, which are that
  chain).
- The wrappers' rules: a CUDA-free device raises, bad shapes raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_tpu.ops import pallas_gicp as jg, pallas_icp as ji
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.utils import se3 as jse3
from open3d_slam_torch.ops import cuda_gicp as tg, cuda_gn_step, cuda_solve6
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.ops.gn_graph import GNState
from open3d_slam_torch.utils import se3

POSE_TOL = 1e-5


def _inputs(rng, batch):
    """A fused kernel's output (positive definite JtJ, Jtr, inlier counts and
    d2 sums; element 0 without inliers when B > 1), valid-source counts,
    poses P and the state before them (some elements done, some fitness and
    RMSE changes below the stop test's 1e-6)."""
    A = rng.normal(size=(batch, 6, 12)).astype(np.float32)
    out = np.zeros((batch, 8, 128), np.float32)
    out[:, :6, :6] = A @ A.transpose(0, 2, 1) * rng.uniform(1, 1e3, size=(batch, 1, 1))
    out[:, :6, 6] = rng.normal(scale=0.1, size=(batch, 6))
    out[:, 7, 0] = np.floor(rng.uniform(100, 4000, size=batch))
    out[:, 7, 1] = out[:, 7, 0] * rng.uniform(0.001, 0.05, size=batch)
    if batch > 1:
        out[0, 7, :2] = 0.0
    n_src = np.floor(rng.uniform(4000, 5000, size=batch)).astype(np.float32)
    xi = np.concatenate([rng.normal(scale=0.3, size=(batch, 3)),
                         rng.normal(scale=5.0, size=(batch, 3))], 1).astype(np.float32)
    P = np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xi)))
    fit = out[:, 7, 0] / np.maximum(n_src, 1.0)
    rmse = np.sqrt(out[:, 7, 1] / np.maximum(out[:, 7, 0], 1.0))
    fit = (fit + np.resize([0.0, 1e-3, 5e-7], batch)).astype(np.float32)
    rmse = (rmse + np.resize([5e-7, 0.0, 1e-3], batch)).astype(np.float32)
    it = np.arange(batch, dtype=np.int32) + 3
    done = np.resize([False, True, False], batch)
    return out, n_src, P, fit, rmse, it, done


def _jax_step(out, n_src, P, fit, rmse, it, done, exp, start):
    """The JAX loop body's pieces, in its order: the statistics of the
    kernel's output, the stop test, the step, the freeze."""
    JtJ, Jtr, n_in, d2s = (np.asarray(a) for a in ji.unpack(jnp.asarray(out)))
    fitn = np.asarray(jnp.asarray(n_in) / jnp.clip(jnp.asarray(n_src), 1.0, None))
    rmsen = np.asarray(jnp.sqrt(jnp.asarray(d2s) / jnp.clip(jnp.asarray(n_in), 1.0, None)))
    if start:
        it, done = np.zeros_like(it), np.zeros_like(done)
    else:
        conv = (np.abs(fit - fitn) < 1e-6) & (np.abs(rmse - rmsen) < 1e-6)
        it, done = it + (~done).astype(np.int32), done | conv
    delta = jax.vmap(jreg._solve6)(jnp.asarray(JtJ), jnp.asarray(Jtr))
    dT = jse3.se3_exp(delta) if exp else jreg._euler_xyz_transform(delta)
    P_next = np.asarray(jnp.where(jnp.asarray(done)[:, None, None], jnp.asarray(P),
                                  dT @ jnp.asarray(P)))
    return fitn, rmsen, it, done, np.asarray(delta), P_next


def _pose_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dR = np.abs(a[:, :3, :3] - b[:, :3, :3]).max()
    dt = (np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) / (1.0 + np.abs(b[:, :3, 3]).max(-1))).max()
    return max(float(dR), float(dt))


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("exp_retraction", [True, False])
@pytest.mark.parametrize("start", [True, False])
def test_gn_step_plain_matches_jax(batch, exp_retraction, start):
    rng = np.random.default_rng(batch + 10 * exp_retraction + 100 * start)
    out, n_src, P, fit, rmse, it, done = _inputs(rng, batch)
    t = torch.from_numpy
    prev = None if start else GNState(t(P), t(P), t(fit), t(rmse), t(it), t(done))
    delta = torch.empty((batch, 6))
    got = cuda_gn_step.gn_step(t(out), t(n_src), t(P), prev, exp_retraction, 1e-6, 1e-6,
                               delta)
    fitn, rmsen, it_w, done_w, delta_w, P_w = _jax_step(out, n_src, P, fit, rmse, it, done,
                                                        exp_retraction, start)
    np.testing.assert_array_equal(got.T.numpy(), P)
    np.testing.assert_allclose(got.fit.numpy(), fitn, rtol=1e-6)
    np.testing.assert_allclose(got.rmse.numpy(), rmsen, rtol=1e-6)
    np.testing.assert_array_equal(got.it.numpy(), it_w)
    np.testing.assert_array_equal(got.done.numpy(), done_w)
    np.testing.assert_allclose(delta.numpy(), delta_w, rtol=1e-4, atol=1e-5)
    assert _pose_gap(got.P, P_w) <= POSE_TOL
    assert np.array_equal(got.P.numpy()[done_w], P[done_w])
    if not start and batch > 1:
        assert done_w.any() and not done_w.all()


@pytest.mark.parametrize("batch,lead,cov", [(1, 1, True), (3, 3, True), (4, 0, False),
                                            (2, 1, False)])
def test_gn_apply_plain_matches_jax(batch, lead, cov):
    rng = np.random.default_rng(lead + 7 * batch)
    m = 257
    xi = np.concatenate([rng.normal(scale=0.5, size=(batch, 3)),
                         rng.normal(scale=10.0, size=(batch, 3))], 1).astype(np.float32)
    T = np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xi)))
    pts = rng.normal(scale=20.0, size=(m, 3) if lead == 0 else (lead, m, 3)).astype(np.float32)
    c6 = rng.normal(size=(max(lead, 1), m, 6)).astype(np.float32) if cov else None
    got, got_c = cuda_gn_step.gn_apply(torch.from_numpy(T), torch.from_numpy(pts),
                                       None if c6 is None else torch.from_numpy(c6))
    want = np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    assert got.shape == (batch, m, 3)
    scale = np.abs(T[:, None, :3, :3]).max() * np.abs(pts).max() + np.abs(T[:, :3, 3]).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    if cov:
        want_c = np.asarray(jg.rotate_cov6(jnp.asarray(T[:, :3, :3]), jnp.asarray(c6)))
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0,
                                   atol=1e-6 * 9 * np.abs(c6).max())
    else:
        assert got_c is None


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def _dot3(a, b):
    """The kernels' order: fma(a2, b2, fma(a1, b1, a0 b0))."""
    return _fma(a[2], b[2], _fma(a[1], b[1], (a[0] * b[0]).astype(np.float32)))


def test_kernel_order_pieces_match_the_chain():
    """The kernels' orders against the loops' earlier chain in the port: the
    point apply's ascending chain of fused multiply-adds (``csrc/gn_step.cu``,
    written out here in numpy) gives ``gn_apply_plain``'s bits, which are
    ``se3.transform_points`` and ``cuda_gicp.rotate_cov6``; ``solve6_plain``
    (the step kernel's solve) is within float32 rounding of ``solve6_chain``
    (LAPACK here)."""
    rng = np.random.default_rng(3)
    T = se3.se3_exp(torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)))
    pts = torch.from_numpy(rng.normal(scale=20.0, size=(4, 1000, 3)).astype(np.float32))
    c6 = torch.from_numpy(rng.normal(size=(4, 1000, 6)).astype(np.float32))
    got, got_c = cuda_gn_step.gn_apply_plain(T, pts, c6)
    assert torch.equal(got, se3.transform_points(T, pts))
    assert torch.equal(got_c, tg.rotate_cov6(T[..., :3, :3], c6))
    R, t = T[:, None, :3, :3].numpy(), T[:, None, :3, 3].numpy()
    p, c = pts.numpy(), c6.numpy()
    want = np.stack([_dot3([p[..., k] for k in range(3)], [R[..., i, k] for k in range(3)])
                     + t[..., i] for i in range(3)], -1)
    np.testing.assert_array_equal(got.numpy(), want)
    C = [[c[..., 0], c[..., 1], c[..., 2]], [c[..., 1], c[..., 3], c[..., 4]],
         [c[..., 2], c[..., 4], c[..., 5]]]
    RC = [[_dot3([R[..., i, j] for j in range(3)], [C[j][k] for j in range(3)])
           for k in range(3)] for i in range(3)]
    want_c = np.stack([_dot3(RC[i], [R[..., j, k] for k in range(3)])
                       for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], -1)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    out, *_ = _inputs(rng, 6)
    JtJ, Jtr, _, _ = tg.unpack(torch.from_numpy(out))
    np.testing.assert_allclose(cuda_solve6.solve6_plain(JtJ, Jtr).numpy(),
                               cuda_gn_step.solve6_chain(JtJ, Jtr).numpy(),
                               rtol=1e-4, atol=1e-5)


class _ChainLoop:
    """The fused loops as they ran before ``gn_step`` and ``gn_apply``: the
    chain of ``_stats``, ``_solve6``, the retraction, ``dT @ T`` and the
    freeze around the same kernel wrappers, eager, in the same chunks."""

    @staticmethod
    def run(kind, x, max_iterations, exp):
        from open3d_slam_torch.ops import cuda_icp as ti, gn_graph

        def stats_eq(T):         # the earlier registration.make_stats_eq
            pts = se3.transform_points(T, x["points"]).contiguous()
            if kind == "gicp":
                qc = tg.rotate_cov6(T[..., :3, :3], x["qcov6"]).contiguous()
                out = tg.gicp_normal_eq(pts, x["maskf"], qc, x["td"], x["tv"], x["r2"])
            else:
                out = ti.p2l_normal_eq(pts, x["maskf"], x["t_t"], x["tn_t"], x["tc"], x["tv"],
                                       x["r2"])
            return cuda_gn_step.stats(out, x["n_src"])

        retract = se3.se3_exp if exp else cuda_gn_step.euler_xyz_transform

        def start():
            JtJ, Jtr, fit, rmse = stats_eq(x["inits"])
            b = x["inits"].shape[0]
            return (x["inits"], JtJ, Jtr, fit, rmse, torch.zeros(b, dtype=torch.int32),
                    torch.zeros(b, dtype=torch.bool))

        def step(s):
            T, JtJ, Jtr, fit, rmse, it, done = s
            dT = retract(cuda_gn_step.solve6_chain(JtJ, Jtr))
            T_new = torch.where(done[:, None, None], T, dT @ T)
            JtJ, Jtr, fitn, rmsen = stats_eq(T_new)
            conv = ((fit - fitn).abs() < 1e-6) & ((rmse - rmsen).abs() < 1e-6)
            return (T_new, JtJ, Jtr, fitn, rmsen, it + (~done).to(torch.int32), done | conv)

        state = start()
        for k in gn_graph.chunk_lengths(max_iterations):
            for _ in range(k):
                state = step(state)
            if k == gn_graph.DONE_CHECK_EVERY and bool(state[6].all()):
                break
        return state


def _scene(kind, batch):
    """Planes with normals and covariances, sources moved off them by each
    element's own pose."""
    from open3d_slam_torch.ops import cuda_icp as ti, normals as tn
    from open3d_slam_torch.utils import pointcloud as tpc
    rng = np.random.default_rng(21)
    n, m = 1024, 256
    half = n // 2
    tgt = np.concatenate([
        np.stack([rng.uniform(-5, 5, half), rng.uniform(-5, 5, half),
                  0.01 * rng.standard_normal(half)], 1),
        np.stack([rng.uniform(-5, 5, n - half), 5 + 0.01 * rng.standard_normal(n - half),
                  rng.uniform(0, 3, n - half)], 1)]).astype(np.float32)
    tgt = tgt[np.lexsort((tgt[:, 2], tgt[:, 1], tgt[:, 0]))]
    src = (tgt[rng.choice(n, m, replace=False)] + np.float32([0.08, -0.05, 0.02])
           + rng.normal(scale=0.02, size=(m, 3)).astype(np.float32))
    t_pc = tn.estimate_normals(tpc.PointCloud(torch.from_numpy(tgt),
                                              torch.ones(n, dtype=torch.bool)), 0.8, max_nn=12)
    s_mask = torch.from_numpy(np.arange(m) % 13 != 0)
    s_pc = tn.estimate_normals(tpc.PointCloud(torch.from_numpy(src), s_mask), 0.8, max_nn=12)
    xi = np.zeros((batch, 6), np.float32)
    xi[:, 2] = np.linspace(0.0, 0.04, batch)
    xi[:, 3] = np.linspace(0.0, 0.2, batch)
    inits = se3.se3_exp(torch.from_numpy(xi)).contiguous()
    x = dict(inits=inits, points=s_pc.points[None].expand(batch, m, 3).contiguous(),
             maskf=s_mask.to(torch.float32)[:, None].contiguous(),
             n_src=s_mask.to(torch.float32).sum(),
             r2=torch.full((1, 1), 0.25))
    if kind == "gicp":
        x["qcov6"] = tg.cov6_from_full(tn.covariances_from_normals(s_pc))[None].expand(
            batch, m, 6).contiguous()
        x["td"], x["tv"], _ = tg.prepare_target(t_pc.points, tn.covariances_from_normals(t_pc),
                                                t_pc.mask)
    else:
        x["t_t"], x["tn_t"], x["tc"], x["tv"], _ = ti.prepare_target(t_pc.points,
                                                                     t_pc.normals, t_pc.mask)
    return x


@pytest.mark.parametrize("kind,exp", [("gicp", True), ("p2l", False), ("p2l", True)])
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_loops_match_the_earlier_chain(kind, exp, batch):
    x = _scene(kind, batch)
    want = _ChainLoop.run(kind, x, 30, exp)
    if kind == "gicp":
        got = treg._icp_gicp_fused_batch(x["points"], x["maskf"], x["n_src"], x["qcov6"],
                                         x["td"], x["tv"], x["inits"], 0.5, 30, 1e-6, 1e-6)
    else:
        got = treg._icp_p2l_fused_batch(x["points"], x["maskf"], x["n_src"], x["t_t"],
                                        x["tn_t"], x["tc"], x["tv"], x["inits"], 0.5, 30, 1e-6,
                                        1e-6, exp)
    T, _, _, fit, rmse, it, _ = want
    assert torch.equal(got.num_iterations, it) and torch.equal(got.transformation, T)
    assert torch.equal(got.fitness, fit) and torch.equal(got.inlier_rmse, rmse)
    assert float(got.fitness.min()) > 0.5 and int(it.min()) > 1


def test_wrapper_rules():
    meta = dict(device="meta", dtype=torch.float32)
    P = torch.empty(2, 4, 4, **meta)
    with pytest.raises(RuntimeError):
        cuda_gn_step.gn_step(torch.empty(2, 8, 128, **meta), torch.empty(2, **meta), P, None,
                             True)
    with pytest.raises(RuntimeError):
        cuda_gn_step.gn_apply(P, torch.empty(2, 16, 3, **meta))
    with pytest.raises(ValueError):
        cuda_gn_step.gn_step(torch.zeros(2, 8, 64), torch.zeros(2), torch.zeros(2, 4, 4),
                             None, True)
    with pytest.raises(ValueError):
        cuda_gn_step.gn_step(torch.zeros(2, 8, 128), torch.zeros(2), torch.zeros(2, 4, 4),
                             None, True, delta=torch.zeros(2, 5))
    with pytest.raises(ValueError):
        cuda_gn_step.gn_apply(torch.zeros(2, 4, 4), torch.zeros(3, 16, 3))
    with pytest.raises(ValueError):
        cuda_gn_step.gn_apply(torch.zeros(2, 4, 4), torch.zeros(16, 3), torch.zeros(2, 15, 6))
