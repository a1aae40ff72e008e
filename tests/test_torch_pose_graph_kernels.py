"""The pose-graph LM step's kernel module (``ops/cuda_pose_graph.py``) and
the restructured solve (``ops/pose_graph.py``) against the JAX package.

The plain versions run here (CPU tensors); the CUDA kernels are held
against them on the card (``test_torch_kernels_on_card.py``).  The JAX side
reads each edge with its ends swapped (``test_torch_pose_graph.py`` says
why), so the JAX ``_edge_residual(X, a, b, T)`` is the port's residual with
a = edge_target, b = edge_source, as ``optimize`` hands them to the kernels.

Tolerances: residuals 1e-5 of (1 + the edge's largest component) (float32
SE(3) logs of the same products in another order; 1e-3 for one residual
rotation at pi - 1e-4, where the log is ill-conditioned); blocks, given the
residuals, 1e-5 of the largest entry; H and b against a float64
``np.add.at`` assembly 1e-5 of max |H| (float32 einsums); the retraction
1e-6; the whole solve 1e-6 after one LM step a stage, and after 2 or 25 the
``POSE_ATOL`` of ``test_torch_pose_graph.py`` (1e-4) with the pruning
decision exact: the accept decisions amplify rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from open3d_slam_tpu.ops import pose_graph as jpg
from open3d_slam_tpu.utils import se3 as jse3
from open3d_slam_torch.ops import cuda_build, cuda_pose_graph as cpg, gn_graph
from open3d_slam_torch.ops import pose_graph as tpg

from test_torch_pose_graph import POSE_ATOL, chain_with_two_closures, graph_arrays, swapped

ARGS = (1000.0, 2.0, 0.2, 0)       # correspondence distance, preference, prune, reference


def _pose(rng, angle_scale, shift_scale):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(0, angle_scale, 3)).as_matrix()
    T[:3, 3] = rng.normal(0, shift_scale, 3)
    return T


def random_graph(seed, n_cap=16, e_cap=32, n=12, e=24):
    """A random graph in the port's convention: poses, edges between them
    whose transforms are near the poses' X_t^-1 X_s, and two edges whose
    residuals take so3_log's other branches (angle near pi, angle ~1e-6),
    with random information, uncertain flags and mask."""
    rng = np.random.default_rng(seed)
    nodes = [_pose(rng, 0.5, 3.0) for _ in range(n)]
    edges = []
    for k in range(e):
        s, t = rng.choice(n, 2, replace=False)
        T = np.linalg.inv(nodes[t]) @ nodes[s] @ _pose(rng, 0.05, 0.1)
        if k == 0:          # residual rotation ~pi - 1e-4
            axis = rng.normal(size=3)
            R = Rotation.from_rotvec(axis / np.linalg.norm(axis) * (np.pi - 1e-4)).as_matrix()
            T = np.linalg.inv(nodes[t]) @ nodes[s] @ np.block(
                [[R, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])
        elif k == 1:        # residual rotation ~1e-6
            T = np.linalg.inv(nodes[t]) @ nodes[s] @ _pose(rng, 1e-6, 1e-3)
        edges.append((s, t, T, float(rng.uniform(1, 100)), bool(rng.uniform() < 0.4)))
    a = graph_arrays(nodes, edges, n_cap, e_cap)
    A = rng.normal(size=(e_cap, 6, 6))
    a["edge_information"] = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32) * \
        a["edge_information"][:, :1, :1]
    a["edge_mask"][:e] = rng.uniform(size=e) < 0.9
    return a


def chain_graph():
    nodes, edges = chain_with_two_closures()
    return graph_arrays(nodes, edges)


GRAPHS = {"random": lambda: random_graph(3), "chain": chain_graph}


def _torch(a):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in a.items()}


def _mu(a):
    m = a["edge_mask"]
    return np.float32(ARGS[1]) * np.float32(a["edge_information"][m, 5, 5].sum() /
                                            max(m.sum(), 1))


def _linearize(a):
    g = _torch(a)
    mu = torch.tensor(_mu(a))
    return g, cpg.pg_linearize_plain(g["node_poses"], g["edge_target"], g["edge_source"],
                                     g["edge_transform"], g["edge_information"],
                                     g["edge_uncertain"], g["edge_mask"], mu)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_linearize_plain_matches_jax(name):
    """Residuals against the JAX ``_edge_residual``; weights and blocks
    against the JAX ``_adjoint`` of the same relative poses, in float64."""
    a = GRAPHS[name]()
    g, blocks = _linearize(a)
    X = jnp.asarray(a["node_poses"])
    ea, eb = jnp.asarray(a["edge_target"]), jnp.asarray(a["edge_source"])
    r = np.asarray(jpg._edge_residual(X, ea, eb, jnp.asarray(a["edge_transform"])))
    gap = np.abs(blocks.r.numpy() - r) / (1.0 + np.abs(r).max(axis=1, keepdims=True))
    if name == "random":
        # Edge 0's rotation is pi - 1e-4, where theta = arccos((trace - 1) / 2)
        # turns one rounding of the trace into ~1e-4 (1 / sin(theta) = 1e4):
        # both packages, float32.  Its tolerance is 1e-3, the rest's 1e-5.
        angles = np.linalg.norm(r[:2, :3], axis=1)
        assert angles[0] > np.pi - 1e-3 and angles[1] < 1e-5      # the branches ran
        assert gap[0].max() <= 1e-3
        gap = gap[1:]
    assert gap.max() <= 1e-5, gap.max()
    rel = jse3.inverse(X[ea]) @ X[eb]
    J = -np.asarray(jpg._adjoint(jse3.inverse(rel)), np.float64)
    info = a["edge_information"].astype(np.float64)
    r64 = blocks.r.numpy().astype(np.float64)      # the blocks given the port's r
    quad = np.einsum("ei,eij,ej->e", r64, info, r64)
    mu = float(_mu(a))
    w = np.where(a["edge_uncertain"], (mu / (mu + quad)) ** 2, 1.0) * a["edge_mask"]
    np.testing.assert_allclose(blocks.w.numpy(), w, atol=1e-5, rtol=1e-5)
    lam = info * blocks.w.numpy().astype(np.float64)[:, None, None]
    want = {"H_ss": np.einsum("eki,ekl,elj->eij", J, lam, J),
            "H_st": np.einsum("eki,ekj->eij", J, lam), "H_tt": lam,
            "b_s": np.einsum("eki,ekl,el->ei", J, lam, r64),
            "b_t": np.einsum("eij,ej->ei", lam, r64),
            "cost": blocks.w.numpy() * quad}
    for k, v in want.items():
        np.testing.assert_allclose(getattr(blocks, k).numpy(), v, rtol=0,
                                   atol=1e-5 * max(np.abs(v).max(), 1.0), err_msg=k)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_assemble_plain_matches_float64_scatter(name):
    """H + prior + damping diag(H) and b against a float64 ``np.add.at``
    assembly of the same blocks; the cost is their sum."""
    a = GRAPHS[name]()
    g, blocks = _linearize(a)
    N = a["node_poses"].shape[0]
    prior = torch.rand(N, generator=torch.Generator().manual_seed(0)) * 1e6 + 1e-8
    damping = torch.tensor(0.25)
    H, b, cost = cpg.pg_assemble_plain(blocks, g["edge_target"], g["edge_source"], prior,
                                       damping)
    s, t = a["edge_target"].astype(np.int64), a["edge_source"].astype(np.int64)
    B = {k: getattr(blocks, k).numpy().astype(np.float64) for k in blocks._fields}
    Hw = np.zeros((N, N, 6, 6))
    np.add.at(Hw, (s, s), B["H_ss"])
    np.add.at(Hw, (s, t), B["H_st"])
    np.add.at(Hw, (t, s), B["H_st"].transpose(0, 2, 1))
    np.add.at(Hw, (t, t), B["H_tt"])
    Hw = Hw.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N) + np.diag(
        np.repeat(prior.numpy().astype(np.float64), 6))
    Hw = Hw + 0.25 * np.diag(np.diag(Hw))
    bw = np.zeros((N, 6))
    np.add.at(bw, s, B["b_s"])
    np.add.at(bw, t, B["b_t"])
    scale = np.abs(Hw).max()
    np.testing.assert_allclose(H.numpy(), Hw, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), bw.reshape(-1), rtol=0,
                               atol=1e-5 * max(np.abs(bw).max(), 1.0))
    np.testing.assert_allclose(float(cost), B["cost"].sum(), rtol=1e-5)


@pytest.mark.parametrize("accept", [True, False])
def test_step_plain_matches_jax(accept):
    """The retraction against the JAX ``se3_exp`` product, and the accept
    test and damping update both ways: a cost above the new one accepts
    (X_new, damping halved), one below rejects (X kept, damping times 4)."""
    a = random_graph(5)
    g, blocks = _linearize(a)
    N = a["node_poses"].shape[0]
    delta = torch.from_numpy(np.random.default_rng(1).normal(0, 0.01, 6 * N).astype(np.float32))
    X_new = np.asarray(jnp.asarray(a["node_poses"]) @ jse3.se3_exp(
        jnp.asarray(delta.numpy().reshape(N, 6))))
    r_new = jpg._edge_residual(jnp.asarray(X_new), jnp.asarray(a["edge_target"]),
                               jnp.asarray(a["edge_source"]), jnp.asarray(a["edge_transform"]))
    cost_new = float(np.sum(blocks.w.numpy() * np.einsum(
        "ei,eij,ej->e", np.asarray(r_new), a["edge_information"], np.asarray(r_new))))
    cost = torch.tensor(cost_new * (1.5 if accept else 0.5), dtype=torch.float32)
    damping = torch.tensor(1e-4)
    X, d = cpg.pg_step_plain(g["node_poses"], delta, g["edge_target"], g["edge_source"],
                             g["edge_transform"], g["edge_information"], blocks.w, cost,
                             damping)
    np.testing.assert_allclose(X.numpy(), X_new if accept else a["node_poses"], atol=1e-6,
                               rtol=0)
    assert float(d) == pytest.approx(5e-5 if accept else 4e-4, rel=1e-6)


@pytest.mark.parametrize("caps", [(16, 32), (128, 512)])
@pytest.mark.parametrize("iterations", [1, 2, 25])
def test_optimize_matches_jax(iterations, caps):
    """The restructured solve (the kernels' plain versions here) against
    the JAX ``optimize`` on the chain graph with two closures."""
    nodes, edges = chain_with_two_closures()
    jg = jpg.PoseGraphData(**{k: jnp.asarray(v) for k, v in
                              graph_arrays(nodes, swapped(edges), *caps).items()})
    tg = tpg.PoseGraphData(**{k: torch.from_numpy(v) for k, v in
                              graph_arrays(nodes, edges, *caps).items()})
    jX, jw, jpr = (np.asarray(x) for x in jpg.optimize(jg, *ARGS, max_iterations=iterations))
    tX, tw, tpr = (x.numpy() for x in tpg.optimize(tg, *ARGS, max_iterations=iterations))
    tol = 1e-6 if iterations == 1 else POSE_ATOL
    np.testing.assert_array_equal(tpr, jpr)
    np.testing.assert_allclose(tX, jX, atol=tol, rtol=0)
    np.testing.assert_allclose(tw, jw, atol=tol, rtol=0)


@pytest.fixture
def static_mode():
    gn_graph.clear()
    gn_graph.MODE = "static"
    yield
    gn_graph.MODE = "graph"
    gn_graph.clear()


def test_static_buffers_bit_equal_to_eager(static_mode):
    """MODE "static" (the graph's copy-in and clone-out with an eager
    runner) gives the eager solve's bits; a second call with another graph
    through the same buffers leaves the first call's result alone."""
    graphs = [tpg.PoseGraphData(**_torch(a)) for a in (chain_graph(), random_graph(7))]
    gn_graph.MODE = "eager"
    want = [tpg.optimize(g, *ARGS, max_iterations=3) for g in graphs]
    gn_graph.MODE = "static"
    first = tpg.optimize(graphs[0], *ARGS, max_iterations=3)
    keep = [t.clone() for t in first]
    second = tpg.optimize(graphs[1], *ARGS, max_iterations=3)
    assert gn_graph.captured() == (0, 0) and len(gn_graph._entries) == 1
    for got, exp in ((first, want[0]), (second, want[1]), (keep, want[0])):
        assert all(torch.equal(x, y) for x, y in zip(got, exp))
    assert not torch.equal(first[0], second[0])


def test_no_host_copy_in_the_solve(monkeypatch):
    """The program builds every tensor on its device: no ``torch.tensor`` or
    ``torch.as_tensor`` of a host value (a capture refuses the copy), and no
    kernel launch counted on the CPU."""
    g = tpg.PoseGraphData(**{k: torch.from_numpy(v) for k, v in chain_graph().items()})
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _fn=fn, _n=name, **k:
                            made.append(_n) or _fn(*a, **k))
    before = dict(cuda_build.launches)
    tpg.optimize(g, *ARGS, max_iterations=2)
    assert made == [] and dict(cuda_build.launches) == before


def test_wrappers_refuse_a_device_without_kernel():
    """Only CPU tensors take the plain versions; any other device launches
    a kernel or raises (here the meta device, which has none)."""
    a = random_graph(2)
    g = {k: v.to("meta") for k, v in _torch(a).items()}
    mu = torch.ones((), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        cpg.pg_linearize(g["node_poses"], g["edge_target"], g["edge_source"],
                         g["edge_transform"], g["edge_information"], g["edge_uncertain"],
                         g["edge_mask"], mu)
    with pytest.raises(ValueError, match="expected"):
        cpg.pg_linearize(g["node_poses"][:, :3], g["edge_target"], g["edge_source"],
                         g["edge_transform"], g["edge_information"], g["edge_uncertain"],
                         g["edge_mask"], mu)
