"""Constant-velocity scan undistortion.

Port of ``open3d_slam_tpu.ops.motion_compensation`` (reference
``ConstantVelocityMotionCompensation``, ``src/MotionCompensation.cpp:32-139``):
velocities from two poses of a pose buffer, a per-point azimuth spin phase in
[0, 1], and the per-point correction ``R_rpy(phase * dt * w) p + phase * dt *
v``.  Vectorised over all points on the cloud's device.
"""
from __future__ import annotations

import math

import torch

from open3d_slam_torch.utils import se3
from open3d_slam_torch.utils.pointcloud import PointCloud


def compute_phase(points: torch.Tensor, is_spinning_clockwise: bool) -> torch.Tensor:
    """Azimuth spin phase in [0, 1] per point (``computePhase`` semantics)."""
    angle = torch.atan2(points[:, 1], points[:, 0])
    wrapped = torch.where(angle < 0.0, angle + 2.0 * math.pi, angle)
    phase = wrapped / (2.0 * math.pi)
    if is_spinning_clockwise:
        phase = torch.where(wrapped == 0.0, torch.zeros_like(phase), 1.0 - phase)
    return phase


def undistort_constant_velocity(pc: PointCloud, linear_velocity: torch.Tensor,
                                angular_velocity_rpy: torch.Tensor,
                                scan_duration: float,
                                is_spinning_clockwise: bool = True) -> PointCloud:
    """``p_out = R_rpy(phase * dt * w) p + phase * dt * v``, the reference's
    ``motion * p`` with motion = makeTransform(xyz, fromRPY(rpy))."""
    dt = float(scan_duration)
    phase = compute_phase(pc.points, is_spinning_clockwise)
    xyz = phase[:, None] * dt * linear_velocity[None, :]
    rpy = phase[:, None] * dt * angular_velocity_rpy[None, :]
    R = se3.rpy_to_matrix(rpy[:, 0], rpy[:, 1], rpy[:, 2])   # (N, 3, 3)
    pts = torch.einsum("nij,nj->ni", R, pc.points) + xyz
    return pc.with_(points=pts)


def estimate_velocities(T_start: torch.Tensor, T_finish: torch.Tensor, dt: float):
    """Velocities from two poses, dT = T_start^-1 T_finish
    (``estimateLinearAndAngularVelocity``, ``MotionCompensation.cpp:32-57``):
    linear = dT.t / dt, angular = RPY(dT.R) / dt."""
    dT = se3.inverse(T_start) @ T_finish
    denom = float(dt) + 1e-6
    lin = dT[:3, 3] / denom
    r, p, y = se3.matrix_to_rpy(dT[:3, :3])
    return lin, torch.stack([r, p, y]) / denom
