"""The plain reference for the pose graph: Open3D's robust global
optimisation of submap corrections, solved in float64 with numpy.

A graph is what the mapping program handed its solve: the node poses X it
started from (4x4 corrections of the submaps, in the map frame) and its
edges (source s, target t, transform T, information L, uncertain).  An edge
holds when X_t^-1 X_s = T; its residual is r = log(T^-1 X_t^-1 X_s), a
6-vector (rotation, translation), and its squared error s = r^T L r.
Odometry edges count s; an uncertain edge (a loop closure) counts the
Geman-McClure cost mu s / (mu + s), whose line-process weight is
w = (mu / (mu + s))^2, with mu = preference times the mean of the edges'
L[5, 5] (Open3D's ``GlobalOptimizationLevenbergMarquardt``).  The reference
node is held where it started.  The solve runs in two stages: all edges,
then the uncertain edges whose weight fell under the prune threshold are
dropped and the rest solved again from the first stage's poses.

Each stage is iteratively reweighted Levenberg-Marquardt to convergence
(the weights at the current poses, the right-perturbation Jacobians of
Open3D's first-order linearisation, the step taken when it lowers the
weighted cost).  Everything here imports nothing of the program.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Graph(NamedTuple):
    poses: np.ndarray       # (N, 4, 4) the poses the solve starts from
    source: np.ndarray      # (E,) int
    target: np.ndarray      # (E,) int
    transform: np.ndarray   # (E, 4, 4)
    information: np.ndarray  # (E, 6, 6)
    uncertain: np.ndarray   # (E,) bool


def hat(v: np.ndarray) -> np.ndarray:
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
    out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
    return out


def _series(theta2: np.ndarray):
    """sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3, each by its Taylor series
    below t = 1e-4."""
    t = np.sqrt(theta2)
    small = theta2 < 1e-8
    ts = np.where(small, 1.0, t)
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(ts) / ts)
    b = np.where(small, 0.5 - theta2 / 24.0, (1.0 - np.cos(ts)) / ts ** 2)
    c = np.where(small, 1.0 / 6.0 - theta2 / 120.0, (ts - np.sin(ts)) / ts ** 3)
    return a, b, c


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(..., 6) (rotation, translation) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    a, b, c = _series(np.sum(w * w, -1))
    a, b, c = a[..., None, None], b[..., None, None], c[..., None, None]
    eye = np.eye(3)
    out = np.zeros(xi.shape[:-1] + (4, 4))
    out[..., :3, :3] = eye + a * W + b * W2
    out[..., :3, 3] = ((eye + b * W + c * W2) @ v[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def se3_log(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6) (rotation, translation); rotations short of pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    skew = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-4
    ts = np.where(small, 1.0, theta)
    scale = np.where(small, 0.5 + theta ** 2 / 12.0, ts / (2.0 * np.sin(ts)))
    w = skew * scale[..., None]
    W = hat(w)
    a, b, _ = _series(theta ** 2)
    # V^-1 = I - W/2 + (1 - a / (2 b)) / theta^2 W^2
    k = np.where(small, 1.0 / 12.0 + theta ** 2 / 720.0,
                 (1.0 - a / (2.0 * np.where(small, 1.0, b))) / ts ** 2)
    Vinv = np.eye(3) - 0.5 * W + k[..., None, None] * (W @ W)
    return np.concatenate([w, (Vinv @ t[..., None])[..., 0]], -1)


def adjoint(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6, 6) for (rotation, translation) vectors."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros(T.shape[:-2] + (6, 6))
    out[..., :3, :3] = R
    out[..., 3:, 3:] = R
    out[..., 3:, :3] = hat(t) @ R
    return out


def residuals(X: np.ndarray, g: Graph) -> np.ndarray:
    rel = np.linalg.inv(X[g.target]) @ X[g.source]
    return se3_log(np.linalg.inv(g.transform) @ rel)


def _weights(r: np.ndarray, g: Graph, mu: float, keep: np.ndarray) -> np.ndarray:
    s = np.einsum("ei,eij,ej->e", r, g.information, r)
    w = np.where(g.uncertain, (mu / (mu + s)) ** 2, 1.0)
    return np.where(keep, w, 0.0)


def _weighted_cost(X, g, w) -> float:
    r = residuals(X, g)
    return float(np.sum(w * np.einsum("ei,eij,ej->e", r, g.information, r)))


def _stage(X: np.ndarray, g: Graph, mu: float, keep: np.ndarray, fixed: int,
           max_iterations: int) -> np.ndarray:
    n = X.shape[0]
    free = np.array([i for i in range(n) if i != fixed])
    col = -np.ones(n, int)
    col[free] = np.arange(len(free))
    damping = 1e-4
    for _ in range(max_iterations):
        r = residuals(X, g)
        w = _weights(r, g, mu, keep)
        lam = g.information * w[:, None, None]
        # Right perturbations X_s exp(d_s), X_t exp(d_t): dr/dd_s = I,
        # dr/dd_t = -Ad((X_t^-1 X_s)^-1), to first order in r.
        J_t = -adjoint(np.linalg.inv(np.linalg.inv(X[g.target]) @ X[g.source]))
        nf = len(free)
        H = np.zeros((nf, nf, 6, 6))
        b = np.zeros((nf, 6))
        jac = (np.broadcast_to(np.eye(6), J_t.shape), J_t)
        ends = (col[g.source], col[g.target])
        for p in (0, 1):
            on = ends[p] >= 0
            np.add.at(b, ends[p][on], np.einsum("eki,ekl,el->ei", jac[p], lam, r)[on])
            for q in (0, 1):
                both = on & (ends[q] >= 0)
                np.add.at(H, (ends[p][both], ends[q][both]),
                          np.einsum("eki,ekl,elj->eij", jac[p], lam, jac[q])[both])
        H = H.transpose(0, 2, 1, 3).reshape(6 * nf, 6 * nf)
        b = b.reshape(6 * nf)
        cost = float(np.sum(w * np.einsum("ei,eij,ej->e", r, g.information, r)))
        Hd = H + damping * np.diag(np.diag(H)) + 1e-12 * np.eye(len(b))
        delta = np.linalg.solve(Hd, -b)
        X_new = X.copy()
        X_new[free] = X[free] @ se3_exp(delta.reshape(-1, 6))
        if _weighted_cost(X_new, g, w) < cost:
            X, damping = X_new, max(damping * 0.5, 1e-12)
            if np.max(np.abs(delta)) < 1e-12:
                break
        else:
            damping *= 4.0
            if damping > 1e12:
                break
    return X


def _float64(g: Graph) -> Graph:
    g = Graph(*(np.asarray(a) for a in g))
    return g._replace(poses=g.poses.astype(np.float64),
                      transform=g.transform.astype(np.float64),
                      information=g.information.astype(np.float64),
                      uncertain=g.uncertain.astype(bool))


def _mu(g: Graph, preference: float) -> float:
    return preference * float(np.mean(g.information[:, 5, 5])) if len(g.source) else 1.0


def optimize(g: Graph, preference: float, prune_threshold: float, reference_node: int,
             max_iterations: int = 100):
    """The two-stage solve.  Returns (poses (N, 4, 4), kept (E,) bool)."""
    g = _float64(g)
    mu = _mu(g, preference)
    everything = np.ones(len(g.source), bool)
    X1 = _stage(g.poses.copy(), g, mu, everything, reference_node, max_iterations)
    w1 = _weights(residuals(X1, g), g, mu, everything)
    kept = ~(g.uncertain & (w1 < prune_threshold))
    return _stage(X1, g, mu, kept, reference_node, max_iterations), kept


def point_gap(A: np.ndarray, B: np.ndarray, reach: float) -> float:
    """The largest distance by which two stacks of corrections (N, 4, 4)
    move the same point, over the origin and the points ``reach`` metres
    out along x and y: a correction's rotation shows as it moves a map."""
    pts = np.array([[0, 0, 0], [reach, 0, 0], [-reach, 0, 0], [0, reach, 0],
                    [0, -reach, 0]], np.float64)
    pa = np.einsum("nij,pj->npi", A[:, :3, :3], pts) + A[:, None, :3, 3]
    pb = np.einsum("nij,pj->npi", B[:, :3, :3], pts) + B[:, None, :3, 3]
    return float(np.max(np.linalg.norm(pa - pb, axis=-1))) if len(A) else 0.0


def objective(X: np.ndarray, g: Graph, preference: float, kept: np.ndarray) -> float:
    """The robust cost the solve minimises, over the edges ``kept``:
    odometry edges' s, loop closures' mu s / (mu + s)."""
    mu = _mu(g, preference)
    r = residuals(X, g)
    sq = np.einsum("ei,eij,ej->e", r, g.information, r)
    rho = np.where(g.uncertain, mu * sq / (mu + sq), sq)
    return float(np.sum(np.where(kept, rho, 0.0)))


def solve_cost_share(solves: List[dict], preference: float, prune_threshold: float,
                     reference_node: int, reach: float) -> dict:
    """Each solve the program made, as ``{"graph": Graph, "result": (N, 4,
    4)}``, solved again here and judged by the cost it minimises: the share
    of the reference's cost reduction that the program's answer misses,
    summed over the solves, (F(program) - F(reference)) / (F(start) -
    F(reference)), F on the reference's kept edges.  A solve that returns
    where it started reads 1.  Beside it, the largest distance between the
    program's corrections and the reference's (``point_gap``) and the
    reference's own corrections, in metres."""
    missed = reduced = gap = corr = 0.0
    kept_differs = 0
    for s in solves:
        g = _float64(s["graph"])
        X, kept = optimize(g, preference, prune_threshold, reference_node)
        done = np.asarray(s["result"], np.float64)
        best = objective(X, g, preference, kept)
        missed += objective(done, g, preference, kept) - best
        reduced += objective(g.poses, g, preference, kept) - best
        gap = max(gap, point_gap(done, X, reach))
        corr = max(corr, point_gap(g.poses, X, reach))
        if "kept" in s:
            kept_differs += int(np.sum(np.asarray(s["kept"]) != kept))
    return {"share": missed / reduced if reduced > 0 else float("inf"), "gap_m": gap,
            "correction_m": corr, "solves": len(solves), "kept_differs": kept_differs}
