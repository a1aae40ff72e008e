"""SE(3) / SO(3) utilities — the port of ``open3d_slam_tpu.utils.se3``.

Poses are 4x4 float32 tensors (leading batch dims allowed); small pose
updates use the SE(3) exponential map so the Gauss-Newton solvers can retract
6-vector increments on the device.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, numerically safe near ||w|| = 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS)
    small = (theta2[..., 0, 0] < 1e-8)[..., None, None]
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of a rotation matrix -> axis-angle 3-vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_hat = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                               R[..., 0, 2] - R[..., 2, 0],
                               R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)[..., None]
    th = theta[..., None]
    safe_sin = torch.where(sin_theta.abs() < _EPS,
                           torch.full_like(sin_theta, _EPS), sin_theta)
    scale = torch.where(th < 1e-5, 1.0 + th ** 2 / 6.0, th / safe_sin)
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    ct = cos_theta[..., None]
    axis = torch.sqrt(torch.clamp((diag - ct) / (1.0 - ct + _EPS), min=0.0))
    sign = torch.stack([torch.sign(R[..., 2, 1] - R[..., 1, 2] + _EPS),
                        torch.sign(R[..., 0, 2] - R[..., 2, 0] + _EPS),
                        torch.sign(R[..., 1, 0] - R[..., 0, 1] + _EPS)], dim=-1)
    w_pi = axis * sign * th
    return torch.where(near_pi[..., None], w_pi, w_hat * scale)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: xi = (omega, v) -> 4x4 transform."""
    w = xi[..., :3]
    v = xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    t2c = theta2.clamp(min=_EPS)
    b = (1.0 - torch.cos(theta)) / t2c
    c = (theta - torch.sin(theta)) / (t2c * theta)
    small = (theta2[..., 0, 0] < 1e-8)[..., None, None]
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    V = _eye3(W) + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return make_transform(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map -> (omega, v) 6-vector."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    cot_term = 1.0 / theta2.clamp(min=_EPS) * (
        1.0 - (theta * torch.sin(theta)) /
        (2.0 * (1.0 - torch.cos(theta))).clamp(min=_EPS))
    small = (theta2[..., 0, 0] < 1e-8)[..., None, None]
    cot_term = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, cot_term)
    Vinv = _eye3(W) - 0.5 * W + cot_term * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 transform(s) from rotation + translation."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to (N, 3) points (leading batch dims on T)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate (N, 3) direction vectors by the rotation part of T."""
    return vecs @ T[..., :3, :3].transpose(-1, -2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)     # (..., 4 branches, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    return q * torch.sign(q[..., :1] + _EPS)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Quaternion slerp (Eigen ``Quaterniond::slerp`` semantics)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs()
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    denom = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / denom)
    w1 = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / denom)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def interpolate(T0: torch.Tensor, T1: torch.Tensor, alpha) -> torch.Tensor:
    """Pose interpolation: lerp translation + slerp rotation."""
    alpha = torch.as_tensor(alpha, dtype=T0.dtype, device=T0.device)
    a = alpha[..., None]
    t = (1.0 - a) * T0[..., :3, 3] + a * T1[..., :3, 3]
    q0 = quat_from_matrix(T0[..., :3, :3])
    q1 = quat_from_matrix(T1[..., :3, :3])
    R = matrix_from_quat(slerp(q0, q1, a))
    return make_transform(R, t)


def rpy_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    """Roll/pitch/yaw -> rotation matrix (Rz * Ry * Rx)."""
    roll, pitch, yaw = (torch.as_tensor(v, dtype=torch.float32)
                        for v in (roll, pitch, yaw))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(cy), torch.ones_like(cy)
    Rz = torch.stack([torch.stack([cy, -sy, z], -1), torch.stack([sy, cy, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    Ry = torch.stack([torch.stack([cp, z, sp], -1), torch.stack([z, o, z], -1),
                      torch.stack([-sp, z, cp], -1)], -2)
    Rx = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, cr, -sr], -1),
                      torch.stack([z, sr, cr], -1)], -2)
    return Rz @ Ry @ Rx


def matrix_to_rpy(R: torch.Tensor):
    """Rotation matrix -> (roll, pitch, yaw); inverse of rpy_to_matrix."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw
