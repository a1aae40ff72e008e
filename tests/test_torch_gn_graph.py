"""The Gauss-Newton loops of K1 and K4 as a state and an iteration
(``registration._gn_start``, ``_gn_iteration``), run in chunks of
``DONE_CHECK_EVERY`` iterations and a remainder (``gn_graph.drive``), against
the JAX package's ``lax.while_loop``s (``_icp_gicp_fused_batch``,
``_icp_p2l_fused_batch``) on their interpreted Pallas kernels; the static
buffers that the CUDA graphs read (``gn_graph.run``), run here with the
eager runner (``MODE = "static"``); and the 6x6 solve's kernel module
(``cuda_solve6``) against the JAX ``_solve6``.

Tolerances as ``test_torch_gicp.test_icp_generalized_matches_jax_fused_loop``:
poses to 1e-5 (float32 steps from Grams summed in another order), fitness
to 1e-6 and RMSE to 1e-4 relative, iteration counts exact.  Within the port
the static path is held to the eager loop's bits.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from open3d_slam_tpu.ops import normals as jn, pallas_gicp as jg, pallas_icp as ji
from open3d_slam_tpu.ops import registration as jreg
from open3d_slam_tpu.utils import pointcloud as jpc, se3 as jse3
from open3d_slam_torch.ops import cuda_build, cuda_gicp as tg, cuda_icp as ti
from open3d_slam_torch.ops import cuda_solve6, gn_graph, hashgrid
from open3d_slam_torch.ops import pose_graph as tpg
from open3d_slam_torch.ops import registration as treg
from open3d_slam_torch.utils import device as devmod, pointcloud as tpc

from test_torch_pose_graph_kernels import ARGS as PG_ARGS, _torch as pg_torch, random_graph
from test_torch_preprocess_graph import _owner as preprocess_owner, _scan

N_TGT, N_SRC, MAX_DIST = 512, 128, 0.5
# Poses the batch starts from: at the answer's neighbourhood and farther,
# so that elements converge at different iterations (the freeze).
_XI = [[0, 0, 0, 0, 0, 0], [0.0, 0.0, 0.03, 0.1, -0.05, 0.0],
       [0.02, -0.01, 0.0, -0.12, 0.08, 0.03], [0.05, 0.03, -0.15, 0.3, -0.2, 0.1]]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    half = N_TGT // 2
    ground = np.stack([rng.uniform(-5, 5, half), rng.uniform(-5, 5, half),
                       0.01 * rng.standard_normal(half)], axis=1)
    wall = np.stack([rng.uniform(-5, 5, N_TGT - half),
                     5.0 + 0.01 * rng.standard_normal(N_TGT - half),
                     rng.uniform(0, 3, N_TGT - half)], axis=1)
    tgt = np.concatenate([ground, wall]).astype(np.float32)
    tgt = tgt[np.lexsort((tgt[:, 2], tgt[:, 1], tgt[:, 0]))]
    src = tgt[rng.choice(N_TGT, N_SRC, replace=False)] + np.float32([0.08, -0.05, 0.02])
    tmask = np.ones(N_TGT, bool)
    tmask[500:] = False
    smask = np.ones(N_SRC, bool)
    smask[::17] = False
    t_pc = jn.estimate_normals(jpc.PointCloud(points=jnp.asarray(tgt), mask=jnp.asarray(tmask)),
                               0.8, max_nn=12)
    s_pc = jn.estimate_normals(jpc.PointCloud(points=jnp.asarray(src), mask=jnp.asarray(smask)),
                               0.8, max_nn=12)
    return dict(tgt=np.array(t_pc.points), tnrm=np.array(t_pc.normals), tmask=tmask,
                tcov=np.array(jn.covariances_from_normals(t_pc)),
                src=np.array(s_pc.points), smask=smask,
                scov=np.array(jn.covariances_from_normals(s_pc)))


def _inits(batch):
    return np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32)))
                     for x in _XI[:batch]]).astype(np.float32)


def _port(kind, sc, batch, max_iterations):
    """The port's fused loop on the scene: (result, host syncs)."""
    T = torch.from_numpy
    points = T(np.broadcast_to(sc["src"], (batch, N_SRC, 3)).copy())
    maskf = T(sc["smask"]).to(torch.float32)[:, None].contiguous()
    n_src = T(sc["smask"]).to(torch.float32).sum()
    inits = T(_inits(batch))
    devmod.host_syncs.count = 0
    if kind == "gicp":
        td, tv, _ = tg.prepare_target(T(sc["tgt"]), T(sc["tcov"]), T(sc["tmask"]))
        qcov6 = tg.cov6_from_full(T(sc["scov"]))[None].expand(batch, N_SRC, 6).contiguous()
        res = treg._icp_gicp_fused_batch(points, maskf, n_src, qcov6, td, tv, inits,
                                         MAX_DIST, max_iterations, 1e-6, 1e-6)
    else:
        t_t, tn_t, tc, tv, _ = ti.prepare_target(T(sc["tgt"]), T(sc["tnrm"]), T(sc["tmask"]))
        res = treg._icp_p2l_fused_batch(points, maskf, n_src, t_t, tn_t, tc, tv, inits,
                                        MAX_DIST, max_iterations, 1e-6, 1e-6)
    return res, devmod.host_syncs.count


def _jax(kind, sc, batch, max_iterations):
    points = jnp.broadcast_to(jnp.asarray(sc["src"]), (batch, N_SRC, 3))
    maskf = jnp.asarray(sc["smask"], jnp.float32)[:, None]
    n_src = jnp.float32(sc["smask"].sum())
    inits = jnp.asarray(_inits(batch))
    if kind == "gicp":
        td, tv = jg.prepare_target(jnp.asarray(sc["tgt"]), jnp.asarray(sc["tcov"]),
                                   jnp.asarray(sc["tmask"]))
        qcov6 = jnp.broadcast_to(jg.cov6_from_full(jnp.asarray(sc["scov"])), (batch, N_SRC, 6))
        return jreg._icp_gicp_fused_batch(points, maskf, n_src, qcov6, td, tv, inits,
                                          MAX_DIST, max_iterations, 1e-6, 1e-6, None, 64, 128,
                                          interpret=True)
    t_t, tn_t, tc, tv = ji.prepare_target(jnp.asarray(sc["tgt"]), jnp.asarray(sc["tnrm"]),
                                          jnp.asarray(sc["tmask"]))
    return jreg._icp_p2l_fused_batch(points, maskf, n_src, t_t, tn_t, tc, tv, inits,
                                     MAX_DIST, max_iterations, 1e-6, 1e-6, False, None, 64,
                                     128, interpret=True)


def _same(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in
               ("transformation", "fitness", "inlier_rmse", "num_iterations"))


@pytest.mark.parametrize("kind", ["gicp", "p2l"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("max_iterations", [4, 7, 50])
def test_chunked_loop_matches_jax_while_loop(scene, monkeypatch, kind, batch, max_iterations):
    """Chunks of 4 and the remainder, the freeze and the limit: the eager
    loop against JAX's ``lax.while_loop``, and the static-buffer path
    bit-equal to the eager loop with the same ``done`` reads."""
    want = _jax(kind, scene, batch, max_iterations)
    got, syncs = _port(kind, scene, batch, max_iterations)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-5)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-6)
    np.testing.assert_allclose(got.inlier_rmse.numpy(), np.asarray(want.inlier_rmse),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    assert int(got.num_iterations.max()) <= max_iterations
    # One read of done after each whole chunk, until every element is done.
    every = gn_graph.DONE_CHECK_EVERY
    assert syncs == min(max_iterations // every, -(-int(got.num_iterations.max()) // every))
    monkeypatch.setattr(gn_graph, "MODE", "static")
    static, static_syncs = _port(kind, scene, batch, max_iterations)
    assert _same(static, got) and static_syncs == syncs


def test_static_buffers_leave_an_earlier_result_alone(scene, monkeypatch):
    """Two calls of one key with other inputs: the first result is cloned
    out of the static buffers, so the second leaves it as it was; each
    equals the eager loop's; a call with another remainder reuses the key."""
    monkeypatch.setattr(gn_graph, "MODE", "static")
    gn_graph.clear()
    first, _ = _port("gicp", scene, 4, 50)
    kept = [t.clone() for t in (first.transformation, first.fitness, first.inlier_rmse,
                                first.num_iterations)]
    moved = dict(scene, src=scene["src"] + np.float32([0.05, 0.0, -0.02]))
    second, _ = _port("gicp", moved, 4, 50)
    assert not torch.equal(second.transformation, first.transformation)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, (first.transformation, first.fitness, first.inlier_rmse, first.num_iterations)))
    third, _ = _port("gicp", scene, 4, 7)
    assert gn_graph.captured() == (0, 0)       # the eager runner captures nothing
    assert len(gn_graph._entries) == 1
    monkeypatch.setattr(gn_graph, "MODE", "eager")
    for res, sc, it in ((first, scene, 50), (second, moved, 50), (third, scene, 7)):
        assert _same(res, _port("gicp", sc, 4, it)[0])
    gn_graph.clear()


def _registration(kind):
    """A loop of ``kind`` on the scene: the first call, one with other
    values of the same signature, one with another batch (other shapes)."""
    def call(sc, variant):
        batch = 1 if variant == "other_shape" else 4
        if variant == "again":
            sc = dict(sc, src=sc["src"] + np.float32([0.05, 0.0, -0.02]))
        if kind != "p2p":
            res, _ = _port(kind, sc, batch, 7)
        else:
            T = torch.from_numpy
            grid = hashgrid.build(tpc.PointCloud(T(sc["tgt"]), T(sc["tmask"])), 0.5)
            res = treg.batched_icp_point_to_point(
                tpc.PointCloud(T(sc["src"]), T(sc["smask"])), grid, T(_inits(batch)),
                MAX_DIST, max_iterations=7)
        return (res.transformation, res.fitness, res.inlier_rmse, res.num_iterations)
    return call


def _preprocess(sc, variant):
    """The mapper's scan preprocess chain; a fresh owner draws the same
    scores every time.  Another shape: the scan padded with invalid rows."""
    scan = _scan(101 if variant == "again" else 100)
    if variant == "other_shape":
        scan = tpc.PointCloud(torch.cat([scan.points, torch.zeros(512, 3)]),
                              torch.cat([scan.mask, torch.zeros(512, dtype=torch.bool)]))
    out = preprocess_owner("mapper").preprocess(scan)
    return (out.points, out.mask, out.normals)


def _pose_graph(sc, variant):
    """The pose-graph solve; another shape: other capacities."""
    caps = dict(n_cap=24, e_cap=40) if variant == "other_shape" else {}
    graph = tpg.PoseGraphData(**pg_torch(random_graph(4 if variant == "again" else 3,
                                                       **caps)))
    return tpg.optimize(graph, *PG_ARGS, max_iterations=3)


# Each caller of the runner, by the name its keys start with.
_CALLERS = {"gicp": _registration("gicp"), "p2l": _registration("p2l"),
            "p2p": _registration("p2p"), "preprocess": _preprocess,
            "pose_graph": _pose_graph}


@pytest.mark.parametrize("name", sorted(_CALLERS))
def test_the_runner_keys_every_caller(scene, monkeypatch, name):
    """``gn_graph`` alone decides the path and the key of every caller.
    Under ``MODE = "static"`` calls whose inputs differ only in shape make
    two keys, each named for its caller, and calls with an equal signature
    reuse one.  Under ``MODE = "graph"`` CPU tensors run eagerly, make no
    key, and give the static runner's bits."""
    call = _CALLERS[name]
    variants = ("first", "again", "other_shape")
    monkeypatch.setattr(gn_graph, "MODE", "static")
    gn_graph.clear()
    static = {}
    for v in variants:
        static[v] = call(scene, v)
        assert len(gn_graph._entries) == (2 if v == "other_shape" else 1)
    assert all(torch.equal(a, b) for a, b in zip(call(scene, "first"), static["first"]))
    assert len(gn_graph._entries) == 2 and gn_graph.captured() == (0, 0)
    assert {key[0] for key, capture in gn_graph._entries} == {name}
    assert not any(torch.equal(a, b) for a, b in zip(static["first"][:1], static["again"]))
    monkeypatch.setattr(gn_graph, "MODE", "graph")
    gn_graph.clear()
    for v in variants:
        got = call(scene, v)
        assert all(torch.equal(a, b) for a, b in zip(got, static[v])), v
    assert len(gn_graph._entries) == 0
    gn_graph.clear()


def test_chunk_lengths():
    assert gn_graph.chunk_lengths(50) == [4] * 12 + [2]
    assert gn_graph.chunk_lengths(8) == [4, 4]
    assert gn_graph.chunk_lengths(3) == [3]
    assert gn_graph.chunk_lengths(0) == []


def test_graph_launches_are_credited_per_replay():
    """A launch recorded by a capture counts into the capture's Counter, not
    ``launches``, and ``credit`` adds it once per replay."""
    key = ("gicp_normal_eq", (1, 8, 8))
    before = cuda_build.launches[key]
    with cuda_build.graph_launches() as counts:
        cuda_build.count_launch(*key)
        assert cuda_build.capture_counts() is counts
    assert cuda_build.capture_counts() is None
    assert counts[key] == 1 and cuda_build.launches[key] == before
    cuda_build.credit(counts)
    cuda_build.credit(counts)
    assert cuda_build.launches[key] == before + 2


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_solve6_plain_matches_jax(batch):
    """The kernel's plain version (its order of operations) against the JAX
    ``_solve6``, as ``test_torch_gicp.test_solve6_matches_jax`` holds
    ``_solve6``; and equal to the wrapper on CPU tensors."""
    rng = np.random.default_rng(batch)
    A = rng.normal(size=(batch, 6, 6)).astype(np.float32)
    JtJ = A @ A.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)
    Jtr = rng.normal(size=(batch, 6)).astype(np.float32)
    got = cuda_solve6.solve6_plain(torch.from_numpy(JtJ), torch.from_numpy(Jtr)).numpy()
    for i in range(batch):
        want = np.asarray(jreg._solve6(jnp.asarray(JtJ[i]), jnp.asarray(Jtr[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-5)
    # Strided views, as the fused kernels' unpacked output gives them.
    out = torch.zeros(batch, 8, 128)
    out[:, :6, :6] = torch.from_numpy(JtJ)
    out[:, :6, 6] = torch.from_numpy(Jtr)
    JtJ_v, Jtr_v, _, _ = tg.unpack(out)
    assert torch.equal(cuda_solve6.solve6(JtJ_v, Jtr_v), torch.from_numpy(got))


def test_solve6_wrapper_rules():
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError):
        cuda_solve6.solve6(torch.empty(2, 6, 6, **meta), torch.empty(2, 6, **meta))
    with pytest.raises(ValueError):
        cuda_solve6.solve6(torch.zeros(2, 5, 5), torch.zeros(2, 5))
