"""The port's scale-out layer (``open3d_slam_torch.parallel``: mesh,
sharded ICP, the multi-process harness) against the JAX package's.

Ranks are real processes in a gloo group, started here with
``torch.multiprocessing``'s spawn; the JAX reference runs in this process on
the 8-device virtual CPU mesh of ``tests/conftest.py``, and arrays cross
between them as numpy.  Each rank takes one thread and each group its own
free port; every wait has a timeout, so a hung collective fails its test.
This module imports no JAX at its top level: the spawned ranks import it to
find their functions.

Tolerances: the port's K4/K1 loops sum the shards' normal equations in rank
order and the JAX package in its own order (the probe route's float32
einsums, or the Pallas kernel's tiles), so poses are held to 1e-4 against
JAX and fitness to 1e-4; the JAX package's own block-vs-single test allows
1e-4 (plain route) and 1e-3 (fused).  Within the port, sharding over data is
bit-equal to the unsharded batch, a 1-rank group bit-equal to no group, and
every rank of a block group ends with the same pose and iteration count.
"""
import json
import os
import queue
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from open3d_slam_torch.ops import cuda_gicp, hashgrid, registration as reg_ops
from open3d_slam_torch.parallel import mesh as mesh_lib, multihost, sharded_icp
from open3d_slam_torch.utils import collectives
from open3d_slam_torch.utils.pointcloud import PointCloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240.0
POSE_TOL = 1e-4
FIT_TOL = 1e-4


def _rank_main(rank, world, port, fn, args, results):
    torch.set_num_threads(1)
    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                             timeout_s=RANK_TIMEOUT_S)
        results.put((rank, fn(rank, world, *args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(world, fn, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one gloo
    group; returns their results in rank order, or fails with a rank's
    traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(got) < world:
            try:
                rank, out, err = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                pytest.fail(f"ranks {sorted(set(range(world)) - set(got))} gave no "
                            f"result in {RANK_TIMEOUT_S} s")
            if err is not None:
                pytest.fail(f"rank {rank} of {world} failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [got[r] for r in range(world)]


def _np(res: reg_ops.RegistrationResult) -> dict:
    return {k: getattr(res, k).numpy() for k in
            ("transformation", "fitness", "inlier_rmse", "num_iterations")}


# ---------------------------------------------------------------------------
# 1. The mesh


def _rank_mesh(rank, world, shape, batch):
    m = mesh_lib.make_mesh(shape)
    x = torch.arange(batch * 3, dtype=torch.float32).reshape(batch, 3)
    pc = PointCloud(points=x, mask=torch.ones(batch, dtype=torch.bool))
    part = mesh_lib.shard_batch(m, {"x": x, "pc": pc, "n": 7})
    assert part["n"] == 7 and torch.equal(part["pc"].points, part["x"])
    assert mesh_lib.replicated(m, x) is x
    total = mesh_lib.gather_sum(torch.tensor([float(rank)]), mesh_lib.block_group(m))
    return {"coordinate": list(m.get_coordinate()),
            "data": dist.get_process_group_ranks(mesh_lib.data_group(m)),
            "block": dist.get_process_group_ranks(mesh_lib.block_group(m)),
            "rows": part["x"].numpy(), "block_sum": float(total[0]),
            "cat": mesh_lib.gather_cat(part["x"], mesh_lib.data_group(m)).numpy()}


def test_mesh_coordinates_groups_and_shards_match_jax():
    """4 ranks at (2, 2): rank r at (r // 2, r % 2); its data group the
    ranks of its column, its block group those of its row; ``shard_batch``
    gives each rank the rows JAX's P("data") gives the device at the same
    mesh position."""
    import jax
    from jax.sharding import Mesh
    from open3d_slam_tpu.parallel import mesh as jmesh

    shape, batch = (2, 2), 6
    out = _run_ranks(4, _rank_mesh, shape, batch)
    devs = np.array(jax.devices()[:4]).reshape(shape)
    jm = Mesh(devs, ("data", "block"))
    index_map = jmesh.data_sharding(jm).devices_indices_map((batch, 3))
    x = np.arange(batch * 3, dtype=np.float32).reshape(batch, 3)
    for r, o in enumerate(out):
        pos = [int(v) for v in np.argwhere(devs == jax.devices()[r])[0]]
        assert o["coordinate"] == pos == [r // 2, r % 2]
        assert o["data"] == [pos[1], 2 + pos[1]]
        assert o["block"] == [2 * pos[0], 2 * pos[0] + 1]
        np.testing.assert_array_equal(o["rows"], x[index_map[jax.devices()[r]]])
        assert o["block_sum"] == float(sum(o["block"]))
        np.testing.assert_array_equal(o["cat"], x)


# ---------------------------------------------------------------------------
# 2. Data-sharded batched point-to-plane


def _surface_batch(batch, n_src=256, n_tgt=1024):
    """The inputs of tests/test_parallel.py's data-sharded test."""
    import reference_icp as ref
    rng = np.random.default_rng(42)
    srcs, tgts = [], []
    for b in range(batch):
        t = ref.make_surface_scan(np.random.default_rng(b), n=n_tgt, extent=8.0)
        s = t[rng.choice(n_tgt, n_src, replace=False)] + np.array([0.1, -0.05, 0.02], np.float32)
        srcs.append(s)
        tgts.append(t[:n_tgt])
    return np.stack(srcs).astype(np.float32), np.stack(tgts).astype(np.float32)


def _batch_inputs(srcs, tgts, nrm, cell):
    b = srcs.shape[0]
    src = PointCloud(points=torch.from_numpy(srcs),
                     mask=torch.ones(srcs.shape[:2], dtype=torch.bool))
    grids = hashgrid.build_batched(PointCloud(
        points=torch.from_numpy(tgts), mask=torch.ones(tgts.shape[:2], dtype=torch.bool),
        normals=torch.from_numpy(nrm)), cell)
    return src, grids, torch.eye(4).repeat(b, 1, 1)


def _rank_data_sharded(rank, world, srcs, tgts, nrm):
    m = mesh_lib.make_mesh()
    src, grids, inits = _batch_inputs(srcs, tgts, nrm, 0.8)
    sharded = sharded_icp.batched_icp_p2l(src, grids, inits, 0.8, max_iterations=10, mesh=m)
    whole = reg_ops.batched_icp_point_to_plane(src, grids, inits, 0.8, max_iterations=10)
    return _np(sharded), _np(whole)


def test_data_sharded_batched_p2l_matches_unsharded_and_jax():
    """B = 16 scan pairs on 2 ranks: bit-equal to the port's unsharded
    batch on every rank, and within 1e-4 of JAX's ``batched_icp_p2l`` on
    the (8, 1) mesh (the port is handed JAX's target normals)."""
    import jax
    import jax.numpy as jnp
    from open3d_slam_tpu.ops import hashgrid as jhashgrid, normals as jnormals
    from open3d_slam_tpu.parallel import mesh as jmesh, sharded_icp as jsharded
    from open3d_slam_tpu.utils.pointcloud import PointCloud as JCloud

    batch = 16
    srcs, tgts = _surface_batch(batch)
    tgt_pc = jax.vmap(lambda p: jnormals.estimate_normals(p, 1.0, max_nn=10))(
        JCloud(points=jnp.asarray(tgts), mask=jnp.ones(tgts.shape[:2], bool)))
    nrm = np.asarray(tgt_pc.normals)
    grids = jax.vmap(lambda p: jhashgrid.build(p, 0.8))(tgt_pc)
    src_pc = JCloud(points=jnp.asarray(srcs), mask=jnp.ones(srcs.shape[:2], bool))
    jm = jmesh.make_mesh((8, 1))
    sh = jmesh.data_sharding(jm)
    put = lambda tree: jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
    run = jax.jit(lambda s, g, T0: jsharded.batched_icp_p2l(s, g, T0, 0.8, max_iterations=10))
    with jax.set_mesh(jm):
        want = run(put(src_pc), put(grids), put(jnp.tile(jnp.eye(4), (batch, 1, 1))))

    out = _run_ranks(2, _rank_data_sharded, srcs, tgts, nrm)
    for sharded, whole in out:
        for k in sharded:
            np.testing.assert_array_equal(sharded[k], whole[k], err_msg=k)
        np.testing.assert_array_equal(sharded["transformation"], out[0][0]["transformation"])
    got = out[0][0]
    assert (got["fitness"] > 0.9).all(), got["fitness"]
    np.testing.assert_allclose(got["transformation"], np.asarray(want.transformation),
                               atol=POSE_TOL)
    np.testing.assert_allclose(got["fitness"], np.asarray(want.fitness), atol=FIT_TOL)
    np.testing.assert_array_equal(got["num_iterations"], np.asarray(want.num_iterations))
    np.testing.assert_allclose(got["transformation"][:, :3, 3],
                               np.tile([-0.1, 0.05, -0.02], (batch, 1)), atol=0.05)


# ---------------------------------------------------------------------------
# 3. Block-sharded point-to-plane, and a 1-rank group


def _plane_problem(n_tgt):
    """The inputs of tests/test_parallel.py's block-sharded tests: a
    surface scan of n_tgt points with PCA normals and 512 of its points
    moved by (0.15, -0.1, 0.05) m, drawn from ``default_rng(42)``."""
    import reference_icp as ref
    rng = np.random.default_rng(42)
    t = ref.make_surface_scan(rng, n=n_tgt, extent=8.0)
    nrm = ref.plane_normals(t)
    s = t[rng.choice(n_tgt, 512, replace=False)] + np.array([0.15, -0.1, 0.05], np.float32)
    return s.astype(np.float32), t.astype(np.float32), nrm


def _cloud(pts, normals=None):
    return PointCloud(points=torch.from_numpy(pts),
                      mask=torch.ones(len(pts), dtype=torch.bool),
                      normals=None if normals is None else torch.from_numpy(normals))


def _rank_block_p2l(rank, world, problems):
    m = mesh_lib.make_mesh((1, world))
    calls = []
    gather_sum = collectives.gather_sum

    def counted(t, group=None):
        calls.append(t.shape)
        return gather_sum(t, group)

    collectives.gather_sum = counted
    out = []
    try:
        for s, t, nrm in problems:
            grid = hashgrid.build(_cloud(t, nrm), 0.8)
            run = sharded_icp.make_block_sharded_icp(m, 0.8, max_iterations=10)
            del calls[:]
            res = run(sharded_icp.split_points_for_blocks(_cloud(s), world), grid, torch.eye(4))
            out.append((_np(res), len(calls)))
    finally:
        collectives.gather_sum = gather_sum
    return out


def test_block_sharded_p2l_matches_jax_on_every_rank():
    """512 source points in 4 shards on 4 ranks: every rank ends with the
    same pose, fitness and iteration count after the same number of
    collectives; within 1e-4 of JAX's ``make_block_sharded_icp`` on the
    (2, 4) mesh (its CPU route) against a 2048-point target, and of JAX's
    fused psum route (``_icp_p2l_fused_batch`` under ``shard_map``, Pallas
    K4 interpreted) against a 1024-point target."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from open3d_slam_tpu.ops import hashgrid as jhashgrid, pallas_icp
    from open3d_slam_tpu.ops import registration as jreg
    from open3d_slam_tpu.parallel import mesh as jmesh, sharded_icp as jsharded
    from open3d_slam_tpu.utils import pointcloud as jpc

    plain, fused = _plane_problem(2048), _plane_problem(1024)
    jm = jmesh.make_mesh((2, 4))
    s, t, nrm = plain
    grid = jhashgrid.build(jpc.from_numpy(t, normals=nrm), cell_size=0.8)
    scan = jpc.from_numpy(s, capacity=512)
    with jax.set_mesh(jm):
        want_plain = jsharded.make_block_sharded_icp(jm, 0.8, max_iterations=10)(
            jsharded.split_points_for_blocks(scan, 4), grid, jnp.eye(4))

    s, t, nrm = fused
    grid = jhashgrid.build(jpc.from_numpy(t, normals=nrm), cell_size=0.8)
    scan = jpc.from_numpy(s, capacity=512)
    t_t, tn_t, tc, tv = pallas_icp.prepare_target(
        grid.points_sorted, grid.normals_sorted, grid.hashes_sorted != jhashgrid.INT32_MAX)

    def inner(src, t_t, tn_t, tc, tv):
        maskf = src.mask[0].astype(jnp.float32)[:, None]
        n_src = jax.lax.psum(jnp.sum(src.mask[0].astype(jnp.float32)), "block")
        res = jreg._icp_p2l_fused_batch(
            src.points[0][None], maskf, n_src, t_t, tn_t, tc, tv, jnp.eye(4)[None], 0.8, 10,
            1e-6, 1e-6, False, "block", 64, 128, interpret=True)
        return res.transformation[0], res.fitness[0], res.num_iterations[0]

    want_fused = shard_map(inner, mesh=jm, in_specs=(P("block"), P(), P(), P(), P()),
                           out_specs=P(), check_vma=False)(
        jsharded.split_points_for_blocks(scan, 4), t_t, tn_t, tc, tv)

    out = _run_ranks(4, _rank_block_p2l, [plain, fused])
    for i, (T_want, fit_want) in enumerate(
            [(want_plain.transformation, want_plain.fitness), want_fused[:2]]):
        first, n_calls = out[0][i]
        for rank_out in out:
            got, calls = rank_out[i]
            # The count, one evaluation at the start and one an iteration,
            # up to the loop's next read of ``done``.
            assert calls == n_calls >= int(first["num_iterations"]) + 2
            for k in got:
                np.testing.assert_array_equal(got[k], first[k], err_msg=k)
        np.testing.assert_allclose(first["transformation"], np.asarray(T_want), atol=POSE_TOL)
        assert abs(float(first["fitness"]) - float(fit_want)) < FIT_TOL
    assert int(out[0][0][0]["num_iterations"]) == int(want_plain.num_iterations)
    assert int(out[0][1][0]["num_iterations"]) == int(want_fused[2])


def _rank_one_group(rank, world, s, t, nrm):
    g = dist.group.WORLD
    grid = hashgrid.build(_cloud(t, nrm), 0.8)
    scan = _cloud(s)
    out = {}
    for name, grp in (("none", None), ("group", g)):
        out[f"p2l_{name}"] = _np(reg_ops.icp_point_to_plane(scan, grid, torch.eye(4), 0.8,
                                                            max_iterations=10, group=grp))
    covs_sorted = (torch.eye(3).repeat(len(t), 1, 1) * 0.01)[grid.order.long()]
    scan_covs = torch.eye(3).repeat(len(s), 1, 1) * 0.01
    for name, grp in (("none", None), ("group", g)):
        out[f"gicp_{name}"] = _np(reg_ops.icp_generalized(
            scan, scan_covs, grid, covs_sorted, torch.eye(4), 0.8, max_iterations=10,
            group=grp))
    return out


def test_one_rank_group_is_bit_equal_to_no_group():
    """A world of one: the point-to-plane and GICP loops with the group
    (the collective runs) give exactly what they give without one."""
    s, t, nrm = _plane_problem(1024)
    (out,) = _run_ranks(1, _rank_one_group, s, t, nrm)
    for kind in ("p2l", "gicp"):
        for k, v in out[f"{kind}_none"].items():
            np.testing.assert_array_equal(out[f"{kind}_group"][k], v, err_msg=f"{kind} {k}")
    assert out["p2l_none"]["fitness"] > 0.9


# ---------------------------------------------------------------------------
# 4. Block-sharded GICP


def _rank_block_gicp(rank, world, pts_sorted, covs_sorted, valid, scan, scan_covs, iters):
    m = mesh_lib.make_mesh((1, world))
    prepared = cuda_gicp.prepare_target(torch.from_numpy(pts_sorted),
                                        torch.from_numpy(covs_sorted), torch.from_numpy(valid))
    run = sharded_icp.make_block_sharded_gicp(m, 1.0, max_iterations=iters)
    res = run(sharded_icp.split_points_for_blocks(_cloud(scan), world),
              sharded_icp.split_points_for_blocks(torch.from_numpy(scan_covs), world),
              None, None, torch.eye(4), prepared=prepared)
    return _np(res)


def test_block_sharded_gicp_matches_jax_fused_psum():
    """The deployed GICP loop's psum route: a 256-point scan against a
    1024-point map, 2 shards on 2 ranks (``make_block_sharded_gicp``),
    against JAX's ``_icp_gicp_fused_batch(..., "block", interpret=True)``
    under ``shard_map`` on the (4, 2) mesh (the port is handed JAX's
    covariances); every rank ends equal."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from open3d_slam_tpu.ops import hashgrid as jhashgrid, normals as jnormals, pallas_gicp
    from open3d_slam_tpu.ops import registration as jreg
    from open3d_slam_tpu.parallel import mesh as jmesh
    from open3d_slam_tpu.utils.pointcloud import PointCloud as JCloud

    rng = np.random.default_rng(7)
    base = rng.uniform(-10, 10, size=(1024, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) * 0.1
    src = base[rng.choice(1024, 256, replace=False)] + np.array([0.2, -0.1, 0.0], np.float32)
    iters, n_block = 10, 2
    scan = JCloud(points=jnp.asarray(src), mask=jnp.ones((256,), bool))
    map_pc = jnormals.estimate_normals(
        JCloud(points=jnp.asarray(base), mask=jnp.ones((1024,), bool)), 1.2, max_nn=10)
    grid = jhashgrid.build(map_pc, 1.0)
    covs_sorted = jnormals.covariances_from_normals(map_pc)[grid.order]
    valid = grid.hashes_sorted != jhashgrid.INT32_MAX
    td, tv = pallas_gicp.prepare_target(grid.points_sorted, covs_sorted, valid)
    scan_covs = jnormals.covariances_from_normals(jnormals.estimate_normals(scan, 1.2, max_nn=10))
    qcov6 = pallas_gicp.cov6_from_full(scan_covs)

    def shard(pts_s, maskf_s, qcov6_s, td_r, tv_r):
        res = jreg._icp_gicp_fused_batch(
            pts_s[0][None], maskf_s[0], jnp.float32(256.0), qcov6_s[0][None], td_r, tv_r,
            jnp.eye(4)[None], 1.0, iters, 1e-6, 1e-6, "block", 64, 128, interpret=True)
        return res.transformation[0], res.fitness[0], res.num_iterations[0]

    want = shard_map(shard, mesh=jmesh.make_mesh((4, n_block)),
                     in_specs=(P("block"), P("block"), P("block"), P(), P()),
                     out_specs=P(), check_vma=False)(
        scan.points.reshape(n_block, -1, 3), jnp.ones((n_block, 256 // n_block, 1)),
        qcov6.reshape(n_block, -1, 6), td, tv)

    out = _run_ranks(n_block, _rank_block_gicp, np.asarray(grid.points_sorted),
                     np.asarray(covs_sorted), np.asarray(valid), src, np.asarray(scan_covs),
                     iters)
    for got in out:
        for k in got:
            np.testing.assert_array_equal(got[k], out[0][k], err_msg=k)
    got = out[0]
    np.testing.assert_allclose(got["transformation"], np.asarray(want[0]), atol=POSE_TOL)
    assert abs(float(got["fitness"]) - float(want[1])) < FIT_TOL
    assert int(got["num_iterations"]) == int(want[2])
    assert float(got["fitness"]) > 0.5


# ---------------------------------------------------------------------------
# 5. Pose-graph refinement


def _rank_pose_graph(rank, world):
    return multihost.pose_graph_refinement_stage(mesh_lib.make_mesh())


def test_pose_graph_refinement_matches_jax_with_swapped_edges():
    """The stage on 2 ranks against JAX's on the (8, 1) mesh: the port's
    graph is JAX's with every edge's ends swapped (the two packages read
    an edge in opposite directions), so the optimized chains agree within
    1e-4 m and the endpoint error is under the stage's 0.05 m."""
    import jax.numpy as jnp
    from open3d_slam_tpu.ops import pose_graph as jpg
    from open3d_slam_tpu.parallel import mesh as jmesh, multihost as jmultihost
    from open3d_slam_torch.ops import pose_graph as pg

    want = jmultihost.pose_graph_refinement_stage(jmesh.make_mesh((8, 1)))
    errs = _run_ranks(2, _rank_pose_graph)
    assert errs[0] == errs[1] < 0.05
    assert abs(errs[0] - want) < POSE_TOL

    nodes, src, tgt, Te, info, unc = multihost.chain_graph(16)
    e = len(src)
    X = pg.optimize(pg.PoseGraphData(
        torch.from_numpy(nodes), torch.ones(16, dtype=torch.bool), torch.from_numpy(src),
        torch.from_numpy(tgt), torch.from_numpy(Te), torch.from_numpy(info),
        torch.from_numpy(unc), torch.ones(e, dtype=torch.bool)),
        10.0, 2.0, 0.25, 0, max_iterations=20)[0].numpy()
    Xj = jpg.optimize(jpg.PoseGraphData(
        node_poses=jnp.asarray(nodes), node_mask=jnp.ones(16, bool),
        edge_source=jnp.asarray(tgt.astype(np.int32)), edge_target=jnp.asarray(src.astype(np.int32)),
        edge_transform=jnp.asarray(Te), edge_information=jnp.asarray(info),
        edge_uncertain=jnp.asarray(unc), edge_mask=jnp.ones(e, bool)),
        10.0, 2.0, 0.25, 0, max_iterations=20)[0]
    np.testing.assert_allclose(X, np.asarray(Xj), atol=POSE_TOL)


# ---------------------------------------------------------------------------
# 6. The harness and the batch-map stage


def test_two_process_harness_passes():
    """The port's ``tests/test_multihost.py``: 2 processes, block 2, on
    the CPU; the JAX harness's checks."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "multihost.json")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        proc = subprocess.run(
            [sys.executable, "-m", "open3d_slam_torch.parallel.multihost", "--spawn", "2",
             "--block", "2", "--device", "cpu", "--out", out],
            env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S, cwd=REPO)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert "multihost: PASS" in proc.stdout
        with open(out) as f:
            result = json.load(f)
    assert result["processes"] == result["global_devices"] == 2
    assert result["mesh"] == {"data": 1, "block": 2}
    assert result["registration_fitness"] > 0.95
    assert result["pose_graph_endpoint_err"] < 0.05
    bm = result["batch_map_sequences"]
    assert bm["n_nonzero"] == bm["n_sequences"] == 2
    assert bm["max_start_err"] < 1e-3


def _rank_batch_map(rank, world, n_scans):
    from open3d_slam_torch.models.slam_wrapper import SlamWrapper
    seqs, params = multihost.batch_map_inputs(2, n_scans, refine_every_scan=True)
    trajs = multihost.batch_map_sequences(seqs, params)
    # The sequence another rank mapped, replayed here alone.
    other = seqs[(rank + 1) % world]
    slam = SlamWrapper(params, device="cpu")
    for scan, t in zip(other.scans, other.timestamps):
        slam.process_scan(scan, t)
    return trajs, np.stack(slam.get_trajectory()[1])


def test_batch_map_sequences_equal_each_sequences_own_replay():
    """Two sequences on 2 ranks: every rank receives both trajectories,
    each equal, entry for entry, to the sequence's replay alone in another
    process."""
    n_scans = 3
    out = _run_ranks(2, _rank_batch_map, n_scans)
    for rank, (trajs, replay) in enumerate(out):
        assert len(trajs) == 2
        for other_trajs, _ in out:
            for a, b in zip(trajs, other_trajs):
                np.testing.assert_array_equal(a, b)
        seq = (rank + 1) % 2
        assert replay.shape == (n_scans, 4, 4)
        np.testing.assert_array_equal(trajs[seq], replay)
        assert np.abs(replay[-1, :3, 3] - replay[0, :3, 3]).max() > 0.5
