"""The plain reference for relocalization: multi-start global localization
of one scan in a saved map, in plain PyTorch and float64, with brute-force
nearest neighbours.

It computes what the program's funnel (``parallel/multi_start.py``) defines:

- ``rank_scores``: the score fitness - inlier RMSE of any set of poses
  against a map at a correspondence distance d: a source point is an inlier
  when its nearest map point lies within d, fitness is the inliers over the
  valid source points, the RMSE the root mean squared distance over the
  inliers;
- ``point_to_plane``: batched point-to-plane Gauss-Newton ICP as Open3D's
  ``TransformationEstimationPointToPlane``: rows [p x n, n], residual
  n.(p - q), the 6x6 normal equations with the jitter 1e-6 trace/6, the
  Euler-XYZ retraction dT = Rz Ry Rx + t applied on the left, Open3D's
  relative fitness/RMSE stop, converged poses frozen; the result is the pose
  the last statistics were taken at, with those statistics;
- ``point_to_point``: the same loop with the weighted Kabsch step;
- ``funnel``: the whole funnel from given hypotheses and given subsampled
  scans (coarse point-to-plane, rank, point-to-point of the best ``top_k``,
  refine, final), its coarse and mid maps made here as voxel centroids.

Where it departs from the program's semantics, on purpose:

- nearest neighbours are exact over the whole map (each query against
  every map point of the axis-aligned box within d of its chunk of
  queries, which holds every point within d): the program's K4 and K3
  sweep the map exactly too, but K3 finds its candidates through a hash
  grid of cell d, and ties between equidistant map points may resolve to
  another point;
- map normals, unless given, are this module's own: PCA of the map points within the
  hybrid radius min(``radius``, the distance of the ``knn``-th nearest)
  (the point itself among them; fewer than 3 give (0, 0, 1)), by
  ``torch.linalg.eigh``, where the program runs K2 and a closed-form
  eigensolver; a normal's sign does not change a point-to-plane step;
- voxel centroids are float64 means, where the program sums fixed-point
  residuals in float32;
- every sum is float64, where the program accumulates float32 in kernel
  orders, so an inlier within a float32 rounding of d may flip.

``DTYPE`` is the precision of the arithmetic; a lower one (the benchmark's
control computes the reference in bfloat16) rounds the inputs to it and
takes every distance, residual and sum in it; the 6x6 solve stays float64.
Matmuls and cuDNN never use TF32 here.  Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch

F64 = torch.float64
DTYPE = torch.float64           # the precision of the arithmetic
CELL_M = 2.0                    # queries are grouped by cells of this size
CHUNK_PAIRS = 1 << 24           # distance entries per chunk
NORMAL_BOX_M = 0.5              # first search box half-width for normals
JITTER = 1e-6
REL_FITNESS = REL_RMSE = 1e-6   # the program's stop rule


@contextlib.contextmanager
def no_tf32():
    """Matmuls and cuDNN in full precision while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _dtype(dtype):
    return DTYPE if dtype is None else dtype


def _cell_order(q: torch.Tensor) -> torch.Tensor:
    """An order of the rows of ``q`` (K, 3) by ``CELL_M`` cells in (x, y),
    so that a run of them is compact in both."""
    c = torch.floor(q[:, :2] / CELL_M).to(torch.int64)
    c = c - c.min(dim=0).values
    return torch.argsort(c[:, 0] * (int(c[:, 1].max()) + 1) + c[:, 1], stable=True)


class Map:
    """A map's points, float64, sorted by x, with the ``normals`` given or,
    without them, normals made when first asked for (``normals_at``)."""

    def __init__(self, points, knn: int = 20, radius: float = 3.0, device=None, normals=None):
        pts = torch.as_tensor(points).to(device=device, dtype=F64).reshape(-1, 3)
        order = torch.argsort(pts[:, 0], stable=True)
        self.points = pts[order]
        self.xs = self.points[:, 0].contiguous()
        self.knn, self.radius = int(knn), float(radius)
        self._normals = torch.zeros_like(self.points)
        self._have = torch.zeros(len(self.points), dtype=torch.bool, device=self.points.device)
        if normals is not None:
            self._normals = torch.as_tensor(normals).to(self.points.device, F64).reshape(
                -1, 3)[order]
            self._have[:] = True

    def __len__(self):
        return len(self.points)

    def _boxes(self, q: torch.Tensor, half: float):
        """Yields (rows of ``q``, candidate map indices) per chunk: every map
        point within ``half`` of a row, in each axis, is a candidate."""
        order = _cell_order(q)
        start = 0
        while start < len(order):
            # Halve the chunk until its box's candidates fit the budget.
            rows = order[start:start + 4096]
            while True:
                c = q[rows]
                lo, hi = c.min(dim=0).values - half, c.max(dim=0).values + half
                a = int(torch.searchsorted(self.xs, lo[0:1]).item())
                b = int(torch.searchsorted(self.xs, hi[0:1], right=True).item())
                cand = self.points[a:b]
                inside = ((cand[:, 1] >= lo[1]) & (cand[:, 1] <= hi[1]) &
                          (cand[:, 2] >= lo[2]) & (cand[:, 2] <= hi[2]))
                idx = torch.nonzero(inside)[:, 0] + a
                if len(rows) * max(len(idx), 1) <= CHUNK_PAIRS or len(rows) <= 16:
                    break
                rows = rows[:len(rows) // 2]
            yield rows, idx
            start += len(rows)

    def nearest(self, q: torch.Tensor, max_dist: float, dtype=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """For each row of ``q`` (K, 3): the squared distance to its nearest
        map point and that point's index, or (inf, -1) when no map point
        lies within ``max_dist``."""
        dt = _dtype(dtype)
        q = q.to(F64)
        d2 = torch.full((len(q),), math.inf, dtype=F64, device=q.device)
        arg = torch.full((len(q),), -1, dtype=torch.int64, device=q.device)
        for rows, idx in self._boxes(q, max_dist):
            if len(idx) == 0:
                continue
            c, t = q[rows].to(dt), self.points[idx].to(dt)
            d = ((c[:, None, 0] - t[None, :, 0]) ** 2 + (c[:, None, 1] - t[None, :, 1]) ** 2
                 + (c[:, None, 2] - t[None, :, 2]) ** 2)
            best, k = d.min(dim=1)
            best = best.to(F64)
            ok = best <= max_dist ** 2
            d2[rows] = torch.where(ok, best, d2[rows])
            arg[rows] = torch.where(ok, idx[k], arg[rows])
        return d2, arg

    def normals_at(self, idx: torch.Tensor, dtype=None) -> torch.Tensor:
        """Normals (K, 3) of the map points ``idx`` (K,), computed once per
        point: PCA of the map points within its hybrid radius."""
        need = torch.unique(idx[~self._have[idx]])
        if len(need):
            self._normals[need] = self._estimate(need, _dtype(dtype))
            self._have[need] = True
        return self._normals[idx]

    def _estimate(self, need: torch.Tensor, dt) -> torch.Tensor:
        q = self.points[need]
        out = torch.zeros_like(q)
        todo = torch.ones(len(q), dtype=torch.bool, device=q.device)
        ez = torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=q.device)
        # A box of NORMAL_BOX_M holds the neighbourhood exactly when the k-th
        # nearest lies within it; the rest are searched again in a box of
        # ``radius``.
        for half in (min(NORMAL_BOX_M, self.radius), self.radius):
            sel = torch.nonzero(todo)[:, 0]
            if len(sel) == 0:
                break
            for rows, idx in self._boxes(q[sel], half):
                rows = sel[rows]
                c, t = q[rows].to(dt), self.points[idx].to(dt)
                d = ((c[:, None, 0] - t[None, :, 0]) ** 2 + (c[:, None, 1] - t[None, :, 1]) ** 2
                     + (c[:, None, 2] - t[None, :, 2]) ** 2).to(F64)
                k = min(self.knn, len(idx))
                dk = torch.topk(d, k, dim=1, largest=False).values[:, -1]
                exact = ((dk <= half ** 2) & (k == self.knn)) | (half >= self.radius)
                # Every point as near as the k-th, within the radius: the
                # program's hybrid radius min(radius, d_k), with its 1e-5
                # relative inflation.
                reach = torch.clamp(dk, max=self.radius ** 2) * (1.0 + 1e-5)
                w = (d <= reach[:, None]).to(F64)
                e = (t.to(F64) - t.to(F64).mean(dim=0))
                n = w.sum(dim=1)
                mu = (w @ e) / n[:, None]
                second = torch.einsum("kn,ni,nj->kij", w, e, e) / n[:, None, None]
                cov = second - mu[:, :, None] * mu[:, None, :]
                nrm = torch.linalg.eigh(cov).eigenvectors[:, :, 0]
                nrm = torch.where((n < 3.0)[:, None], ez.expand_as(nrm), nrm)
                out[rows[exact]] = nrm[exact]
                todo[rows[exact]] = False
        return out


def _transform(T: torch.Tensor, pts: torch.Tensor, dt) -> torch.Tensor:
    """(B, 4, 4) poses applied to (M, 3) points -> (B, M, 3), elementwise."""
    R, t = T[:, :3, :3].to(dt), T[:, :3, 3].to(dt)
    p = pts.to(dt)
    return (p[None, :, 0:1] * R[:, None, :, 0] + p[None, :, 1:2] * R[:, None, :, 1]
            + p[None, :, 2:3] * R[:, None, :, 2] + t[:, None, :])


def _stats(d2: torch.Tensor, w: torch.Tensor, n_src: float, dt):
    """(fitness, rmse) per pose of (B, M) squared distances and inliers."""
    n_in = w.sum(dim=1).to(F64)
    d2s = torch.where(w, d2.to(dt), torch.zeros((), dtype=dt, device=d2.device)).sum(dim=1)
    return n_in / max(n_src, 1.0), torch.sqrt(d2s.to(F64) / n_in.clamp(min=1.0))


def _correspond(m: Map, T: torch.Tensor, pts: torch.Tensor, max_dist: float, dt):
    """The source at each pose, its nearest map points within ``max_dist``
    (squared distances, indices, inliers)."""
    b, k = T.shape[0], pts.shape[0]
    moved = _transform(T, pts, dt)
    d2, idx = m.nearest(moved.reshape(-1, 3).to(F64), max_dist, dt)
    d2, idx = d2.reshape(b, k), idx.reshape(b, k)
    return moved, d2, idx, idx >= 0


def evaluate(m: Map, pts: torch.Tensor, poses: torch.Tensor, max_dist: float,
             dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fitness, rmse) of each of the (B, 4, 4) ``poses`` of the valid source
    points ``pts`` (M, 3) against the map (Open3D ``EvaluateRegistration``)."""
    dt = _dtype(dtype)
    with no_tf32():
        poses = torch.as_tensor(poses).to(pts.device, F64).reshape(-1, 4, 4)
        _, d2, _, w = _correspond(m, poses, pts.to(F64), max_dist, dt)
        return _stats(d2, w, float(len(pts)), dt)


def rank_scores(m: Map, pts: torch.Tensor, poses: torch.Tensor, max_dist: float,
                dtype=None) -> torch.Tensor:
    """fitness - inlier RMSE of each pose: the funnel's rank score."""
    fit, rmse = evaluate(m, pts, poses, max_dist, dtype)
    return fit - rmse


def euler_xyz(x: torch.Tensor) -> torch.Tensor:
    """(B, 6) (alpha, beta, gamma, t) -> (B, 4, 4): Rz(gamma) Ry(beta) Rx(alpha)
    and t (Open3D's ``TransformVector6dToMatrix4d``)."""
    a, b, g = x[:, 0], x[:, 1], x[:, 2]
    ca, sa, cb, sb, cg, sg = a.cos(), a.sin(), b.cos(), b.sin(), g.cos(), g.sin()
    T = torch.zeros((len(x), 4, 4), dtype=x.dtype, device=x.device)
    T[:, 0, 0], T[:, 0, 1], T[:, 0, 2] = cg * cb, cg * sb * sa - sg * ca, cg * sb * ca + sg * sa
    T[:, 1, 0], T[:, 1, 1], T[:, 1, 2] = sg * cb, sg * sb * sa + cg * ca, sg * sb * ca - cg * sa
    T[:, 2, 0], T[:, 2, 1], T[:, 2, 2] = -sb, cb * sa, cb * ca
    T[:, :3, 3] = x[:, 3:6]
    T[:, 3, 3] = 1.0
    return T


def _solve(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    tr = JtJ.diagonal(dim1=-2, dim2=-1).sum(-1)
    A = JtJ + (JITTER * (tr / 6.0).clamp(min=1e-12))[:, None, None] * torch.eye(
        6, dtype=F64, device=JtJ.device)
    return torch.linalg.solve(A, -Jtr)


def _kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) rigid transforms taking the inlier ``p`` onto ``q`` (B, M, 3),
    Umeyama without scale; the identity without inliers (with one or two
    the rotation is not determined, and may differ from the program's)."""
    wf = w.to(F64)[..., None]
    n = wf.sum(dim=1).clamp(min=1.0)
    mp, mq = (p.to(F64) * wf).sum(dim=1) / n, (q.to(F64) * wf).sum(dim=1) / n
    H = torch.einsum("bmi,bmj->bij", (p.to(F64) - mp[:, None]) * wf, q.to(F64) - mq[:, None])
    U, _, Vh = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vh.transpose(1, 2) @ U.transpose(1, 2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=1))
    R = Vh.transpose(1, 2) @ D @ U.transpose(1, 2)
    T = torch.eye(4, dtype=F64, device=p.device).repeat(len(p), 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = mq - (R @ mp[..., None])[..., 0]
    few = w.sum(dim=1) == 0
    return torch.where(few[:, None, None], torch.eye(4, dtype=F64, device=p.device), T)


def _loop(m: Map, pts: torch.Tensor, inits: torch.Tensor, max_dist: float,
          iterations: int, step, dt) -> Dict[str, torch.Tensor]:
    """The loops' shared schedule: statistics at the poses, Open3D's
    relative stop test against the last ones, the next step from the same
    correspondences, converged poses frozen."""
    T = torch.as_tensor(inits).to(pts.device, F64).reshape(-1, 4, 4)
    n_src = float(len(pts))
    moved, d2, idx, w = _correspond(m, T, pts, max_dist, dt)
    fit, rmse = _stats(d2, w, n_src, dt)
    done = torch.zeros(len(T), dtype=torch.bool, device=T.device)
    it = torch.zeros(len(T), dtype=torch.int64, device=T.device)
    for _ in range(iterations):
        P = torch.where(done[:, None, None], T, step(moved, d2, idx, w) @ T)
        moved, d2, idx, w = _correspond(m, P, pts, max_dist, dt)
        fit_n, rmse_n = _stats(d2, w, n_src, dt)
        conv = ((fit - fit_n).abs() < REL_FITNESS) & ((rmse - rmse_n).abs() < REL_RMSE)
        it = it + (~done).to(torch.int64)
        done = done | conv
        T, fit, rmse = P, fit_n, rmse_n
        if bool(done.all()):
            break
    return {"T": T, "fitness": fit, "rmse": rmse, "iterations": it}


def point_to_plane(m: Map, pts: torch.Tensor, inits: torch.Tensor, max_dist: float,
                   iterations: int, dtype=None) -> Dict[str, torch.Tensor]:
    """Point-to-plane ICP of the valid source points ``pts`` (M, 3) from each
    of ``inits`` (B, 4, 4) against the map and its normals."""
    dt = _dtype(dtype)

    def step(moved, d2, idx, w):
        safe = idx.clamp(min=0)
        n = m.normals_at(safe.reshape(-1), dt).reshape(idx.shape + (3,)).to(dt)
        q = m.points[safe].to(dt)
        wf = w.to(dt)[..., None]
        r = ((moved - q) * n).sum(dim=-1, keepdim=True)
        J = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1) * wf
        JtJ = torch.einsum("bmi,bmj->bij", J, J).to(F64)
        Jtr = (J * (r * wf)).sum(dim=1).to(F64)
        return euler_xyz(_solve(JtJ, Jtr))

    with no_tf32():
        return _loop(m, pts.to(F64), inits, max_dist, iterations, step, dt)


def point_to_point(m: Map, pts: torch.Tensor, inits: torch.Tensor, max_dist: float,
                   iterations: int, dtype=None) -> Dict[str, torch.Tensor]:
    """Point-to-point ICP (the weighted Kabsch step) of ``pts`` (M, 3) from
    each of ``inits`` (B, 4, 4) against the map."""
    dt = _dtype(dtype)

    def step(moved, d2, idx, w):
        return _kabsch(moved, m.points[idx.clamp(min=0)], w)

    with no_tf32():
        return _loop(m, pts.to(F64), inits, max_dist, iterations, step, dt)


def voxel_centroids(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """The mean of the points in each voxel of edge ``voxel`` (float64)."""
    p = points.to(F64)
    keys = torch.floor(p / voxel).to(torch.int64)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if len(inv) else 0
    s = torch.zeros((n, 3), dtype=F64, device=p.device).index_add_(0, inv, p)
    c = torch.zeros(n, dtype=F64, device=p.device).index_add_(
        0, inv, torch.ones(len(p), dtype=F64, device=p.device))
    return s / c[:, None]


def funnel(map_points: torch.Tensor, scans: Dict[str, torch.Tensor],
           hypotheses: torch.Tensor, coarse_corr: float, mid_corr: float,
           max_corr: float, knn: int = 20, radius: float = 3.0, top_k: int = 64,
           coarse_iters: int = 10, mid_iters: int = 12, refine_iters: int = 12,
           final_iters: int = 10, dtype=None) -> Dict[str, torch.Tensor]:
    """The whole funnel from ``hypotheses`` (H, 4, 4) and the subsampled
    scans ``scans`` ("small", "mid", "rank", "full": valid points (M, 3)),
    with the maps it defines: the coarse map the voxel centroids of edge
    max(0.5, coarse_corr / 4) with normals, the mid map those of max(0.4,
    mid_corr / 5), the map itself with normals for the rank, refine and
    final stages.  Top-k by a stable descending sort of the rank score, the
    winner the first maximum.  Returns each stage's poses and scores."""
    dev = map_points.device
    full = Map(map_points, knn, radius, dev)
    coarse_map = Map(voxel_centroids(map_points, max(0.5, coarse_corr / 4.0)), knn, radius,
                     dev)
    mid_map = Map(voxel_centroids(map_points, max(0.4, mid_corr / 5.0)), knn, radius, dev)
    coarse = point_to_plane(coarse_map, scans["small"], hypotheses, coarse_corr,
                            coarse_iters, dtype)
    score = rank_scores(full, scans["rank"], coarse["T"], max_corr, dtype)
    best = torch.sort(score, descending=True, stable=True).indices[:top_k]
    mid = point_to_point(mid_map, scans["mid"], coarse["T"][best], mid_corr, mid_iters, dtype)
    refined = point_to_plane(full, scans["rank"], mid["T"], max_corr, refine_iters, dtype)
    win = int(torch.argmax(refined["fitness"] - refined["rmse"]))
    final = point_to_plane(full, scans["full"], refined["T"][win:win + 1], max_corr,
                           final_iters, dtype)
    return {"coarse_T": coarse["T"], "rank_score": score, "best": best, "mid_T": mid["T"],
            "refined_T": refined["T"][win], "final_T": final["T"][0],
            "final_fitness": final["fitness"][0]}


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    """The translation (m) and rotation (degrees) between two 4x4 poses."""
    a, b = (torch.as_tensor(x).detach().to("cpu", F64).reshape(4, 4) for x in (a, b))
    t = float(torch.linalg.norm(a[:3, 3] - b[:3, 3]))
    # |R_a - R_b|_F = 2 sqrt(2) sin(angle / 2): exact near 0, where the
    # trace's arccos is not.
    s = float(torch.linalg.norm(a[:3, :3] - b[:3, :3])) / (2.0 * math.sqrt(2.0))
    return t, math.degrees(2.0 * math.asin(min(1.0, s)))
