"""Port vs JAX: the pose graph (``ops/pose_graph.py``,
``models/optimization.py``), the odometry constraint builder, motion
compensation, and the prefetched host pulls the loop-closure job rides on.

An edge (s, t, T) of the port holds when X_t^-1 X_s = T, Open3D's
convention; the JAX package's ``optimize`` reads it as X_s^-1 X_t = T.  So
the JAX side gets every edge with its ends swapped, which makes the two the
same function (``ops/pose_graph.py`` says why the port differs).

Tolerances: LM runs 2 x 25 float32 steps in both packages, with Cholesky
solves that round differently, so optimised poses and line-process weights
agree to 1e-4 and the pruning decision exactly; the information matrix is a
sum of products, 1e-5 relative; a constraint's (T, info) 1e-4 relative; the
undistorted points and velocities 1e-5.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from open3d_slam_tpu.models import constraints as jcons, optimization as jopt
from open3d_slam_tpu.ops import motion_compensation as jmc, pose_graph as jpg
from open3d_slam_tpu.utils import pointcloud as jpc
from open3d_slam_tpu.utils.config import MapperParameters as JMapperParameters
from open3d_slam_torch.models import constraints as tcons, optimization as topt
from open3d_slam_torch.ops import motion_compensation as tmc, pose_graph as tpg
from open3d_slam_torch.utils import device as tdevice, pointcloud as tpc

from torch_parity import jax_kernel_path, to_torch_params, small_jax_params

POSE_ATOL = 1e-4
INFO_RTOL = 1e-5
MC_ATOL = 1e-5


def rt(yaw, x, y, z=0.0):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", yaw).as_matrix()
    T[:3, 3] = [x, y, z]
    return T


def chain_with_two_closures():
    """Ten nodes on a drifting arc; a good closure 9 -> 0 and a bogus one
    7 -> 2 (the graphs of tests/test_pose_graph.py, together), as
    (source, target, X_t^-1 X_s, information scale, uncertain)."""
    n = 10
    gt = [rt(0.3 * i, 2.0 * np.cos(0.3 * i), 2.0 * np.sin(0.3 * i)) for i in range(n)]
    step = [np.linalg.inv(gt[i]) @ gt[i + 1] for i in range(n - 1)]
    bias = rt(0.01, 0.05, 0.0)
    nodes = [np.eye(4)]
    for s in step:
        nodes.append(nodes[-1] @ s @ bias)
    edges = [(i, i + 1, np.linalg.inv(step[i] @ bias), 50.0, False) for i in range(n - 1)]
    edges.append((n - 1, 0, np.linalg.inv(gt[0]) @ gt[n - 1], 20.0, True))
    edges.append((7, 2, rt(-1.0, 0.1, 8.0), 100.0, True))
    return nodes, edges


def swapped(edges):
    """The same edges as the JAX package's ``optimize`` reads them."""
    return [(t, s, T, scale, unc) for s, t, T, scale, unc in edges]


def graph_arrays(nodes, edges, n_cap=16, e_cap=32):
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cap, 1, 1))
    poses[:len(nodes)] = np.stack(nodes)
    a = dict(node_poses=poses, node_mask=np.arange(n_cap) < len(nodes),
             edge_source=np.zeros(e_cap, np.int32), edge_target=np.zeros(e_cap, np.int32),
             edge_transform=np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1)),
             edge_information=np.tile(np.eye(6, dtype=np.float32), (e_cap, 1, 1)),
             edge_uncertain=np.zeros(e_cap, bool), edge_mask=np.zeros(e_cap, bool))
    for i, (s, t, T, scale, unc) in enumerate(edges):
        a["edge_source"][i], a["edge_target"][i] = s, t
        a["edge_transform"][i] = T
        a["edge_information"][i] = np.eye(6) * scale
        a["edge_uncertain"][i], a["edge_mask"][i] = unc, True
    return a


def test_optimize_matches_jax():
    nodes, edges = chain_with_two_closures()
    jg = jpg.PoseGraphData(**{k: jnp.asarray(v)
                              for k, v in graph_arrays(nodes, swapped(edges)).items()})
    tg = tpg.PoseGraphData(**{k: torch.from_numpy(v)
                              for k, v in graph_arrays(nodes, edges).items()})
    args = (1000.0, 2.0, 0.2, 0)
    jX, jw, jpr = (np.asarray(x) for x in jpg.optimize(jg, *args))
    tX, tw, tpr = (x.numpy() for x in tpg.optimize(tg, *args))
    np.testing.assert_array_equal(tpr, jpr)
    assert jpr[len(nodes)] and not jpr[len(nodes) - 1] and not jpr[:len(nodes) - 1].any()
    np.testing.assert_allclose(tX, jX, atol=POSE_ATOL)
    np.testing.assert_allclose(tw, jw, atol=POSE_ATOL)
    # The good closure pulled the drifted end back.
    assert np.linalg.norm(tX[9][:3, 3] - nodes[9][:3, 3]) > 0.1


def test_information_matrix_matches_jax(rng):
    q = rng.normal(0, 5, (300, 3)).astype(np.float32)
    m = rng.uniform(size=300) > 0.3
    want = np.asarray(jpg.information_matrix_from_correspondences(jnp.asarray(q),
                                                                  jnp.asarray(m)))
    got = tpg.information_matrix_from_correspondences(torch.from_numpy(q),
                                                      torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=INFO_RTOL, atol=INFO_RTOL * np.abs(want).max())


def _constraints(cls, edges):
    return [cls(source_submap_idx=s, target_submap_idx=t, source_to_target=T.copy(),
                information_matrix=np.eye(6) * scale, is_odometry_constraint=not unc,
                is_information_matrix_valid=True, timestamp=float(i))
            for i, (s, t, T, scale, unc) in enumerate(edges)]


def correction_space_graph():
    """Submap-correction edges as the mapper builds them: odometry edges
    near identity (submaps already share the map frame), a good closure
    9 -> 0 with a small correction and a bogus one 7 -> 2."""
    edges = [(i, i + 1, rt(0.002 * (i % 3), 0.01, -0.005 * (i % 2)), 50.0, False)
             for i in range(9)]
    edges.append((9, 0, rt(-0.02, -0.08, 0.05), 20.0, True))
    edges.append((7, 2, rt(0.9, 3.0, -4.0), 100.0, True))
    return edges


def _problem(mod, cons_mod, mp, edges, **kw):
    prob = mod.OptimizationProblem(mp, max_nodes=16, max_edges=32, **kw)
    cs = _constraints(cons_mod.Constraint, edges)
    prob.insert_odometry_constraints([c for c in cs if c.is_odometry_constraint])
    prob.insert_loop_closure_constraints([c for c in cs if not c.is_odometry_constraint])
    prob.insert_loop_closure_constraints(cs[-1:])     # a duplicate is dropped
    prob.build_optimization_problem(None)
    return prob


def test_optimization_problem_solve_and_round_trip(tmp_path):
    """Node chaining on submap-correction edges against the JAX
    ``OptimizationProblem``, then the solve on the chain graph above (whose
    nodes are set as the start) against the JAX ``optimize``.  The solve is
    held on that graph only: on correction-space graphs every residual is
    a near-identity SE(3) log, which float32 rounds to ~1e-3 of itself
    (cos near 1), and LM then stalls at a path-dependent point in both
    packages (1.7 cm apart on ``correction_space_graph``, as on two
    machines)."""
    jp = JMapperParameters()
    tp = to_torch_params(small_jax_params()).mapper
    edges = correction_space_graph()
    jprob = _problem(jopt, jcons, jp, edges)
    tprob = _problem(topt, tcons, tp, edges, device="cpu")
    assert len(tprob.loop_closure_constraints) == len(jprob.loop_closure_constraints) == 2
    assert len(tprob.node_poses) == 10
    for a, b in zip(tprob.node_poses, jprob.node_poses):
        np.testing.assert_allclose(a, b, atol=1e-12)
    nodes, edges = chain_with_two_closures()
    tprob = _problem(topt, tcons, tp, edges, device="cpu")
    tprob.node_poses = [n.copy() for n in nodes]
    tprob.solve()
    jg = jpg.PoseGraphData(**{k: jnp.asarray(v) for k, v in
                              graph_arrays(nodes, swapped(edges)).items()})
    jX, jw, jpr = (np.asarray(x) for x in jpg.optimize(jg, 1000.0, 2.0, 0.2, 0))
    assert tprob.num_edges_pruned_last_solve == int(jpr.sum()) == 1
    assert len(tprob.loop_closure_constraints) == 1
    np.testing.assert_allclose(np.stack(tprob.node_poses_optimized), jX[:10],
                               atol=POSE_ATOL)
    np.testing.assert_allclose(tprob.edge_weights[:11], jw[:11], atol=POSE_ATOL)
    inc = tprob.get_optimized_transform_increments()
    assert [u.submap_id for u in inc] == list(range(10))
    # Dump, load into a fresh problem, and everything comes back.
    path = tmp_path / "poseGraph.json"
    tprob.dump_to_file(str(path))
    back = topt.OptimizationProblem(tp, max_nodes=16, max_edges=32, device="cpu")
    back.load_from_file(str(path))
    for a, b in zip(back.node_poses, tprob.node_poses):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back.node_poses_optimized, tprob.node_poses_optimized):
        np.testing.assert_array_equal(a, b)
    for got, want in ((back.odometry_constraints, tprob.odometry_constraints),
                      (back.loop_closure_constraints, tprob.loop_closure_constraints)):
        assert [(c.source_submap_idx, c.target_submap_idx, c.is_odometry_constraint)
                for c in got] == [(c.source_submap_idx, c.target_submap_idx,
                                   c.is_odometry_constraint) for c in want]
        for c, d in zip(got, want):
            np.testing.assert_array_equal(c.source_to_target, d.source_to_target)
            np.testing.assert_array_equal(c.information_matrix, d.information_matrix)
    assert back._num_odometry_edges_prev == len(tprob.odometry_constraints)


def test_build_constraint_matches_jax(rng):
    """Overlap, compaction and the information matrix from K3's
    correspondences, between two overlapping submap clouds; with
    ``pending_out`` the outputs are prefetched and filled in later."""
    n = 4096
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.2
    a = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    b = (pts + np.float32([2.0, 0.5, 0.0]) + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
    mp = small_jax_params().mapper
    mp.map_builder.map_voxel_size = 0.1
    submaps = {}
    for name, mod in (("jax", jpc), ("torch", tpc)):
        clouds = [mod.from_numpy(a, capacity=n), mod.from_numpy(b, capacity=n)]
        params = mp if name == "jax" else to_torch_params(small_jax_params()).mapper
        if name == "torch":
            params.map_builder.map_voxel_size = 0.1
        submaps[name] = types.SimpleNamespace(
            params=params,
            get_submap=lambda i, c=clouds: types.SimpleNamespace(map_cloud=c[i]))
    with jax_kernel_path():
        jc = jcons.build_odometry_constraint(0, 1, submaps["jax"])
    pending = []
    tc = tcons.build_odometry_constraint(0, 1, submaps["torch"], pending_out=pending)
    assert len(pending) == 1 and np.array_equal(tc.information_matrix, np.eye(6))
    assert pending[0][1].ready()
    tcons.finalize_constraint(*pending[0])
    assert (tc.source_submap_idx, tc.target_submap_idx) == (0, 1)
    assert tc.is_odometry_constraint and tc.is_information_matrix_valid
    np.testing.assert_allclose(tc.source_to_target, jc.source_to_target, rtol=1e-4, atol=0)
    info_j = np.asarray(jc.information_matrix)
    assert info_j[5, 5] > 300       # correspondences found
    np.testing.assert_allclose(tc.information_matrix, info_j, rtol=1e-4,
                               atol=1e-4 * np.abs(info_j).max())


def test_refined_odometry_constraints_are_refused(rng):
    """Refused until the localization slice; now
    ``build_odometry_constraint`` runs the refinement: point-to-plane ICP
    (K4) of the overlap before the information matrix.  Three planes with
    normals, the child submap's cloud turned 0.01 rad and shifted 4 cm: the
    constraint recovers the motion, and (T, info) match the JAX function's."""
    n = 2048
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    plane = rng.integers(0, 3, n)
    pts[np.arange(n), plane] = np.float32(5.0) * (plane > 0)   # x = 0, y = 5, z = 5
    nrm = np.eye(3, dtype=np.float32)[plane]
    R = Rotation.from_euler("z", 0.01).as_matrix().astype(np.float32)
    shift = np.float32([0.04, -0.03, 0.02])
    clouds = [(pts, nrm), ((pts @ R.T + shift).astype(np.float32), nrm @ R.T)]
    outs = {}
    for name, mod in (("jax", jpc), ("torch", tpc)):
        mp = small_jax_params().mapper if name == "jax" else to_torch_params(
            small_jax_params()).mapper
        mp.map_builder.map_voxel_size = 0.1
        mp.is_refine_odometry_constraints_between_submaps = True
        subs = [mod.from_numpy(p, capacity=n, normals=q) for p, q in clouds]
        submaps = types.SimpleNamespace(
            params=mp, get_submap=lambda i, c=subs: types.SimpleNamespace(map_cloud=c[i]))
        if name == "jax":
            with jax_kernel_path():
                outs[name] = jcons.build_odometry_constraint(0, 1, submaps)
        else:
            outs[name] = tcons.build_odometry_constraint(0, 1, submaps)
    tc, jc = outs["torch"], outs["jax"]
    np.testing.assert_allclose(tc.source_to_target[:3, 3], shift, atol=5e-3)
    np.testing.assert_allclose(tc.source_to_target, jc.source_to_target, atol=1e-4)
    info_j = np.asarray(jc.information_matrix)
    assert info_j[5, 5] > 0.5 * n
    np.testing.assert_allclose(tc.information_matrix, info_j, rtol=1e-4,
                               atol=1e-4 * np.abs(info_j).max())


@pytest.mark.parametrize("clockwise", [True, False])
def test_undistortion_matches_jax(rng, clockwise):
    T0 = rt(0.1, 1.0, 2.0, 0.3)
    T1 = T0 @ rt(0.05, 0.4, -0.1, 0.02)
    T1[:3, :3] = T1[:3, :3] @ Rotation.from_euler("x", 0.02).as_matrix()
    jl, ja = jmc.estimate_velocities(jnp.asarray(T0, jnp.float32),
                                     jnp.asarray(T1, jnp.float32), 0.3)
    tl, ta = tmc.estimate_velocities(torch.tensor(T0, dtype=torch.float32),
                                     torch.tensor(T1, dtype=torch.float32), 0.3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MC_ATOL, rtol=MC_ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=MC_ATOL, rtol=MC_ATOL)
    pts = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    pts[:4] = [[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]]   # phase edges
    mask = rng.uniform(size=2048) > 0.1
    jout = jmc.undistort_constant_velocity(
        jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), jl, ja, 0.1,
        is_spinning_clockwise=clockwise)
    tout = tmc.undistort_constant_velocity(
        tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), tl, ta, 0.1,
        is_spinning_clockwise=clockwise)
    np.testing.assert_array_equal(tout.mask.numpy(), mask)
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points),
                               atol=MC_ATOL, rtol=MC_ATOL)
    assert np.abs(tout.points.numpy() - pts).max() > 0.05


def test_prefetch_to_host_on_cpu():
    """On CPU tensors the prefetch is a no-op and always ready; reading it
    is one counted pull, like any other."""
    a, b = torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.eye(2)
    pre = tdevice.prefetch_to_host(a, None, b)
    assert pre.ready() and pre.event is None
    before = tdevice.host_syncs.count
    x, y, z = tdevice.to_host(pre, torch.tensor([7.0]))
    assert tdevice.host_syncs.count == before + 1
    np.testing.assert_array_equal(x, a.numpy())
    np.testing.assert_array_equal(y, np.eye(2))
    assert z.tolist() == [7.0]
