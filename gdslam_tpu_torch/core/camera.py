"""Pinhole camera model with radial-tangential distortion (port of
gdslam_tpu.core.camera): closed-form Brown-Conrady forward model and a
fixed-iteration fixed-point inverse (cv::undistortPoints style), and the
full-frame undistortion table (GeoMaskMaker.cc:39-70)."""

from __future__ import annotations

import torch

from gdslam_tpu_torch.config import CameraConfig


def intrinsic_matrix(cam: CameraConfig, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx],
                         [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def dist_coeffs(cam: CameraConfig, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[k1, k2, p1, p2, k3] (OpenCV ordering)."""
    return torch.tensor([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], dtype=dtype, device=device)


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized coords [..., 2];
    dist = [k1, k2, p1, p2, k3] (a tensor or a sequence), in the JAX
    package's operation order."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_d: torch.Tensor, dist: tuple, iters: int = 8) -> torch.Tensor:
    """Invert distortion by fixed-point iteration. dist = (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = dist
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - dx) / radial,
                          (xy_d[..., 1] - dy) / radial], dim=-1)
    return xy


def undistort_points(uv: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Undistort pixel coords [..., 2] -> undistorted pixel coords
    (Frame::UndistortKeyPoints: undistortPoints with P = K)."""
    if not cam.has_distortion:
        return uv
    xy_d = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xy = undistort_normalized(xy_d, (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3))
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_lut(cam: CameraConfig, device="cpu") -> torch.Tensor:
    """[H, W, 2] undistorted pixel coords of every pixel (the table the
    reference builds once in the GeoMaskMaker ctor, GeoMaskMaker.cc:39-70)."""
    v = torch.arange(cam.height, dtype=torch.float32, device=device)[:, None].expand(
        cam.height, cam.width)
    u = torch.arange(cam.width, dtype=torch.float32, device=device)[None, :].expand(
        cam.height, cam.width)
    return undistort_points(torch.stack([u, v], dim=-1), cam)


def backproject(uv: torch.Tensor, z: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Pixel coords + depth -> camera-frame 3D points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def project(pts: torch.Tensor, cam: CameraConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3D points -> (pixel coords [..., 2], depth [...])."""
    z = pts[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u = pts[..., 0] / z_safe * cam.fx + cam.cx
    v = pts[..., 1] / z_safe * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z
