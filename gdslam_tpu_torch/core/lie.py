"""SE3 Lie-group operations for pose optimization (port of gdslam_tpu.core.lie).

Closed-form, batched on leading dims, float32. Branches are `torch.where`
on Taylor fallbacks so the functions are safe at theta -> 0. The SE3
tangent is (upsilon, omega) = (translation, rotation), as in the JAX
package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched on leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V matrix such that se3 translation t = V @ upsilon."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(theta2 > _EPS, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # from an identity made on the device: writing the Python scalar 1.0 into
    # an element of a CUDA tensor is an upload, which waits for the card
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[:-2] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [upsilon(3), omega(3)] -> 4x4 homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to 3D point(s); broadcasts on leading dims."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def so3_project(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project near-orthogonal R onto SO(3) by Newton-Schulz polar iteration
    R <- 0.5 R (3I - R^T R). The velocity cycle's transpose-inverse
    amplifies any deviation from SO(3) geometrically, so the state boundary
    re-projects (see the JAX package's lie.so3_project)."""
    I3 = _eye3(R)
    for _ in range(iters):
        R = 0.5 * (R @ (3.0 * I3 - R.transpose(-1, -2) @ R))
    return R


def se3_orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation block of (a batch of) rigid transforms onto
    SO(3), keeping translation."""
    return rt_to_mat(so3_project(T[..., :3, :3]), T[..., :3, 3])


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [qx, qy, qz, qw] (TUM order), qw >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    zero = torch.zeros_like(m00)
    qw2 = torch.maximum(zero, 1.0 + m00 + m11 + m22)
    qx2 = torch.maximum(zero, 1.0 + m00 - m11 - m22)
    qy2 = torch.maximum(zero, 1.0 - m00 + m11 - m22)
    qz2 = torch.maximum(zero, 1.0 - m00 - m11 + m22)
    cands = torch.stack([
        torch.stack([qx2, m01 + m10, m02 + m20, m21 - m12], dim=-1),
        torch.stack([m01 + m10, qy2, m12 + m21, m02 - m20], dim=-1),
        torch.stack([m02 + m20, m12 + m21, qz2, m10 - m01], dim=-1),
        torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1),
    ], dim=-2)
    best = torch.argmax(torch.stack([qx2, qy2, qz2, qw2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [qx, qy, qz, qw] -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > _EPS, 2.0 / n, 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def rotm_to_euler(R: torch.Tensor) -> torch.Tensor:
    """XYZ Euler angles, matching the reference's `rotm2euler`
    (Geometry.cc:1003-1031) used for reference-frame selection; near the
    gimbal lock (sy < 1e-6) z is 0 and x comes from the second row."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)
