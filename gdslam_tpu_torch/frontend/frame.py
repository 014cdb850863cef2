"""Per-frame feature post-processing: mask culling, undistortion, RGB-D
stereo association (port of gdslam_tpu.frontend.frame), and the frame of a
rectified stereo pair.

Mirrors Frame's RGB-D constructor (reference Frame.cc:236-317): erode the
static mask (31x31 at 640 px wide, separable min-pool) and keep keypoints
where it is 1; undistort; mvuRight = u - bf/z with depth sampled at the
distorted keypoint location (ComputeStereoFromRGBD, Frame.cc:815-838).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gdslam_tpu_torch.config import CameraConfig
from gdslam_tpu_torch.core import camera
from gdslam_tpu_torch.frontend.extractor import Features


class Frame(NamedTuple):
    """Processed frame: features + geometry, fixed-size padded."""

    uv: torch.Tensor        # [N, 2] undistorted keypoint pixels
    uv_raw: torch.Tensor    # [N, 2] original (distorted) pixels
    ur: torch.Tensor        # [N] right-view u coordinate (<0 = no depth)
    depth: torch.Tensor     # [N] keypoint depth (0 = invalid)
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N]
    response: torch.Tensor  # [N]
    desc: torch.Tensor      # [N, 32] uint8
    valid: torch.Tensor     # [N] bool (extraction valid AND mask-pass)


def _erode_ksize(width: int) -> int:
    """31x31 at 640 px wide, scaled with the image width (odd, >= 3)."""
    return max(3, int(round(31 * width / 640.0)) | 1)


def _same_max_pool(m: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable ksize x ksize max over [H, W] with XLA's 'SAME' window:
    (ksize - 1) // 2 cells of -inf before and ksize // 2 after on each axis
    (0 before and 1 after for ksize = 2), so the output stays [H, W]."""
    lo, hi = (ksize - 1) // 2, ksize // 2
    m = m[None, None]
    m = F.max_pool2d(F.pad(m, (0, 0, lo, hi), value=-float("inf")), (ksize, 1), 1)
    m = F.max_pool2d(F.pad(m, (lo, hi, 0, 0), value=-float("inf")), (1, ksize), 1)
    return m[0, 0]


def erode_mask(mask: torch.Tensor, ksize: int = 31) -> torch.Tensor:
    """Binary erosion with a ksize x ksize square SE (separable min-pool,
    'SAME' window; outside the image counts as +inf, as in reduce_window)."""
    return -_same_max_pool(-mask.float(), ksize) > 0.5


def dilate_mask(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Binary dilation with a square SE (separable max-pool, 'SAME' window)."""
    return _same_max_pool(mask.float(), ksize) > 0.5


def _mask_pass(feats: Features, static_mask: torch.Tensor, cam: CameraConfig):
    """The keypoints' pixels (u, v) and which are valid and on the eroded
    static mask."""
    u = torch.round(feats.uv[:, 0]).to(torch.int64).clamp(0, cam.width - 1)
    v = torch.round(feats.uv[:, 1]).to(torch.int64).clamp(0, cam.height - 1)
    return u, v, feats.valid & erode_mask(static_mask, _erode_ksize(cam.width))[v, u]


def build_frame_stereo(feats: Features, ur: torch.Tensor, kp_depth: torch.Tensor,
                       static_mask: torch.Tensor, cam: CameraConfig) -> Frame:
    """Assemble a Frame from per-keypoint stereo matches (ur, depth): the
    stereo constructor (Frame.cc:53-154), where depth comes from
    ComputeStereoMatches instead of a depth map."""
    _, _, keep = _mask_pass(feats, static_mask, cam)
    return Frame(uv=camera.undistort_points(feats.uv, cam), uv_raw=feats.uv, ur=ur,
                 depth=kp_depth, level=feats.level, angle=feats.angle,
                 response=feats.response, desc=feats.desc, valid=keep)


def build_frame(feats: Features, depth_map: torch.Tensor, static_mask: torch.Tensor,
                cam: CameraConfig) -> Frame:
    """Assemble a Frame from extractor output + depth + static mask
    ([H, W], 1 = static/keep, 0 = dynamic/cull)."""
    u, v, keep = _mask_pass(feats, static_mask, cam)
    z = depth_map[v, u]
    z = torch.where(z > 0, z, 0.0)
    uv_und = camera.undistort_points(feats.uv, cam)
    # a 0-d tensor numerator: `float / tensor` in torch is a reciprocal times
    # the float, which rounds differently from the reference's division
    bf = torch.full((), cam.bf, dtype=z.dtype, device=z.device)
    ur = torch.where(z > 0, uv_und[:, 0] - bf / torch.clamp(z, min=1e-6), -1.0)
    return Frame(uv=uv_und, uv_raw=feats.uv, ur=ur, depth=z, level=feats.level,
                 angle=feats.angle, response=feats.response, desc=feats.desc,
                 valid=keep)
