"""Trajectory evaluation: ATE and RPE (TUM-benchmark style).

The reference validates only qualitatively (map images,
``documentation/source/examples.rst:7-36``); BASELINE.md demands quantitative
ATE/RPE, so this module implements the standard metrics:

* **ATE** — absolute trajectory error: rigidly align (closed-form, no scale)
  the estimated trajectory to ground truth, then report translation-error
  statistics over all poses.
* **RPE** — relative pose error over a fixed frame delta (and a
  distance-normalized drift variant): local consistency, insensitive to
  where along the path a loop closure snapped the graph.

Pure NumPy, host-side.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def associate(times_a: Sequence[float], times_b: Sequence[float],
              max_dt: float = 0.05) -> List[Tuple[int, int]]:
    """Match each time in ``a`` to the nearest time in ``b`` within ``max_dt``
    (greedy, monotone, ONE-TO-ONE; both lists assumed sorted).  A matched
    ``b`` index is consumed so a denser estimate trajectory cannot map many
    poses onto one ground-truth pose (which would bias ATE/RPE)."""
    out, j = [], 0
    tb = list(times_b)
    for i, t in enumerate(times_a):
        while j + 1 < len(tb) and abs(tb[j + 1] - t) <= abs(tb[j] - t):
            j += 1
        if j < len(tb) and abs(tb[j] - t) <= max_dt:
            out.append((i, j))
            j += 1            # consume: enforce one-to-one matching
            if j >= len(tb):
                break
    return out


def rigid_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form SE(3) ``T`` minimizing ||T @ src - dst|| (Umeyama/Kabsch,
    no scale).  ``src``/``dst``: (N, 3)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def _rot_angle_deg(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


@dataclasses.dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float
    n: int

    def __str__(self):
        return (f"ATE rmse {self.rmse:.3f} m  mean {self.mean:.3f} m  "
                f"median {self.median:.3f} m  max {self.max:.3f} m  (n={self.n})")


@dataclasses.dataclass
class RpeResult:
    trans_rmse: float        # m per delta
    trans_mean: float
    rot_rmse_deg: float      # deg per delta
    rot_mean_deg: float
    drift_pct: float         # translation drift, % of distance traveled
    delta: int
    n: int

    def __str__(self):
        return (f"RPE(d={self.delta}) trans rmse {self.trans_rmse:.3f} m  "
                f"rot rmse {self.rot_rmse_deg:.3f} deg  "
                f"drift {self.drift_pct:.2f}%  (n={self.n})")


def ate(gt_poses: Sequence[np.ndarray], est_poses: Sequence[np.ndarray],
        align: bool = True) -> AteResult:
    """Absolute trajectory error after (optional) rigid alignment."""
    n = min(len(gt_poses), len(est_poses))
    if n == 0:
        return AteResult(rmse=0.0, mean=0.0, median=0.0, max=0.0, n=0)
    gt_t = np.stack([np.asarray(T)[:3, 3] for T in gt_poses[:n]])
    es_t = np.stack([np.asarray(T)[:3, 3] for T in est_poses[:n]])
    if align and n >= 3:
        A = rigid_align(es_t, gt_t)
        es_t = es_t @ A[:3, :3].T + A[:3, 3]
    err = np.linalg.norm(es_t - gt_t, axis=1)
    return AteResult(rmse=float(np.sqrt((err ** 2).mean())),
                     mean=float(err.mean()), median=float(np.median(err)),
                     max=float(err.max()), n=n)


def rpe(gt_poses: Sequence[np.ndarray], est_poses: Sequence[np.ndarray],
        delta: int = 10) -> RpeResult:
    """Relative pose error over a fixed frame delta."""
    n = min(len(gt_poses), len(est_poses))
    terr, rerr, seg_len = [], [], []
    for i in range(n - delta):
        dg = np.linalg.inv(np.asarray(gt_poses[i])) @ np.asarray(gt_poses[i + delta])
        de = np.linalg.inv(np.asarray(est_poses[i])) @ np.asarray(est_poses[i + delta])
        E = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(E[:3, 3]))
        rerr.append(_rot_angle_deg(E[:3, :3]))
        seg_len.append(np.linalg.norm(dg[:3, 3]))
    if not terr:
        return RpeResult(0.0, 0.0, 0.0, 0.0, 0.0, delta, 0)
    terr, rerr = np.asarray(terr), np.asarray(rerr)
    total = float(np.sum(seg_len))
    drift = 100.0 * float(np.sum(terr)) / total if total > 0 else 0.0
    return RpeResult(trans_rmse=float(np.sqrt((terr ** 2).mean())),
                     trans_mean=float(terr.mean()),
                     rot_rmse_deg=float(np.sqrt((rerr ** 2).mean())),
                     rot_mean_deg=float(rerr.mean()),
                     drift_pct=drift, delta=delta, n=len(terr))


def evaluate_trajectory(gt_poses: Sequence[np.ndarray],
                        est_poses: Sequence[np.ndarray],
                        gt_times: Optional[Sequence[float]] = None,
                        est_times: Optional[Sequence[float]] = None,
                        rpe_delta: int = 10) -> Tuple[AteResult, RpeResult]:
    """Associate (when both time lists given), then compute ATE + RPE."""
    if gt_times is not None and est_times is not None:
        pairs = associate(est_times, gt_times)
        est_poses = [est_poses[i] for i, _ in pairs]
        gt_poses = [gt_poses[j] for _, j in pairs]
    return ate(gt_poses, est_poses), rpe(gt_poses, est_poses, delta=rpe_delta)
