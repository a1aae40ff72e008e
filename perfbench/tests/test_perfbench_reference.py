"""The pose-graph reference solves the program's problem: on a graph with
drift, loop closures and a false closure it reaches the cost of the
program's own solve run in float64 through its plain route, pruning the
same edges, and a solve that returns where it started reads a cost share
of 1."""
import numpy as np
import pytest
import torch

from perfbench.reference import pose_graph as pg


def _graph(seed=0, n=10):
    rng = np.random.default_rng(seed)
    drift = np.stack([pg.se3_exp(np.r_[0, 0, 0.002 * i, 0.01 * i, -0.004 * i, 0.001 * i]
                                 + rng.normal(0, 1e-4, 6)) for i in range(n)])
    src, tgt, T, info, unc = [], [], [], [], []
    for i in range(n - 1):
        src.append(i + 1), tgt.append(i), unc.append(False)
        T.append(np.linalg.inv(drift[i]) @ drift[i + 1])
    for i, j in [(n - 1, 0), (n - 2, 1), (n - 3, 2)]:
        src.append(i), tgt.append(j), unc.append(True), T.append(np.eye(4))
    src.append(n // 2), tgt.append(0), unc.append(True)
    T.append(pg.se3_exp(np.r_[0, 0, 0.3, 2.0, 0, 0]))       # a false closure
    for _ in src:
        info.append(np.diag([3e5, 3e5, 6e5, 6e3, 6e3, 6e3]))
    return pg.Graph(drift, np.array(src), np.array(tgt), np.array(T), np.array(info),
                    np.array(unc))


def _program(g):
    from open3d_slam_torch.ops import pose_graph as prog
    f64 = torch.float64
    d = prog.PoseGraphData(
        node_poses=torch.tensor(g.poses, dtype=f64),
        node_mask=torch.ones(len(g.poses), dtype=torch.bool),
        edge_source=torch.tensor(g.source), edge_target=torch.tensor(g.target),
        edge_transform=torch.tensor(g.transform, dtype=f64),
        edge_information=torch.tensor(g.information, dtype=f64),
        edge_uncertain=torch.tensor(g.uncertain),
        edge_mask=torch.ones(len(g.source), dtype=torch.bool))
    X, _, pruned = prog.optimize_plain(d, 1000.0, 2.0, 0.2, 0)
    return X.numpy(), ~pruned.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_the_reference_agrees_with_the_programs_float64_solve(seed):
    g = _graph(seed)
    X, kept = pg.optimize(g, 2.0, 0.2, 0)
    Xp, kept_p = _program(g)
    np.testing.assert_array_equal(kept, kept_p)
    assert not kept[-1]                     # the false closure is pruned
    assert pg.point_gap(X, g.poses, 20.0) > 0.01
    # The program damps its reference node and does not hold it, so the two
    # answers may differ along the graph's free rigid motion, which moves no
    # cost: they are compared by the cost they reach.
    share = pg.solve_cost_share([{"graph": g, "result": Xp}], 2.0, 0.2, 0, 20.0)
    assert abs(share["share"]) < 1e-6


def test_a_solve_that_returns_its_start_reads_one():
    g = _graph(2)
    out = pg.solve_cost_share([{"graph": g, "result": g.poses}], 2.0, 0.2, 0, 20.0)
    assert out["share"] == pytest.approx(1.0)


def test_exp_and_log_invert_each_other():
    rng = np.random.default_rng(3)
    for scale in (1e-7, 1e-3, 0.3):       # rotations short of pi
        xi = rng.normal(size=(50, 6)) * scale
        np.testing.assert_allclose(pg.se3_log(pg.se3_exp(xi)), xi, atol=1e-12 + 1e-9 * scale)
