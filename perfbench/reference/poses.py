"""The plain reference the cells' answers are judged against: poses.

The benchmark makes every input from the seed, the true poses with them (the
simulated trajectory), so the reference's answer to
"where was the sensor" is the pose the inputs were made from, expressed in
the frame the program answers in.  Everything here is numpy in float64; it
imports nothing of the program.
"""
from __future__ import annotations

import numpy as np


def rotation_angle_deg(R: np.ndarray) -> np.ndarray:
    """Angle of each rotation in a (..., 3, 3) stack, in degrees."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def pose_gaps(est: np.ndarray, ref: np.ndarray):
    """Per pose: the translation gap (m) and the rotation gap (degrees)
    between two (N, 4, 4) stacks of poses in the same frame."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    t = np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=1)
    r = rotation_angle_deg(np.einsum("nji,njk->nik", ref[:, :3, :3], est[:, :3, :3]))
    return t, r


def relative_gaps(est: np.ndarray, ref: np.ndarray, d: int):
    """The gaps of the motion over ``d`` poses: for each i, the pose i + d
    seen from pose i, in the estimate against the reference."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if len(est) <= d:
        return np.zeros(0), np.zeros(0)
    return pose_gaps(np.linalg.inv(est[:-d]) @ est[d:], np.linalg.inv(ref[:-d]) @ ref[d:])


def in_first_frame(ground_truth: np.ndarray) -> np.ndarray:
    """True poses in the frame of the first one: a SLAM run's map frame is
    its first scan's sensor frame."""
    gt = np.asarray(ground_truth, np.float64)
    return np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
