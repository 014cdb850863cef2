"""FAST-9/16 corner strength + 3x3 NMS on dense maps (port of
gdslam_tpu.ops.fast).

The 16 Bresenham-circle taps are 16 rolled copies of the image, and the
corner score is max-over-9-arcs of min-over-arc |difference|. `torch.roll`
wraps around exactly like `jnp.roll`; the 3-px border is zeroed after.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_taps(img: torch.Tensor) -> torch.Tensor:
    """[16, ..., H, W] rolled images so tap k at pixel p = img[p + offset_k]."""
    return torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))
                        for dy, dx in CIRCLE_OFFSETS], dim=0)


def _arc9_min_strength(d: torch.Tensor) -> torch.Tensor:
    """d: [16, ..., H, W] signed strengths -> max over the 16 circular 9-arcs
    of the min over the arc (negative: no arc)."""
    m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
    m9 = torch.minimum(m8, torch.roll(d, -8, dims=0))
    return m9.amax(dim=0)


def fast_strength(img: torch.Tensor) -> torch.Tensor:
    """Threshold-free FAST-9/16 corner strength (OpenCV cornerScore
    semantics); <= 0 means not a corner. Border 3 px zeroed."""
    taps = _circle_taps(img)
    center = img[None]
    strength = torch.maximum(_arc9_min_strength(taps - center),
                             _arc9_min_strength(center - taps))
    H, W = img.shape[-2], img.shape[-1]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inner = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(inner, strength, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep scores that are the strict max of their 3x3 neighborhood."""
    neigh = [torch.roll(score, (dy, dx), dims=(-2, -1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    nmax = torch.stack(neigh, 0).amax(dim=0)
    return torch.where(score > nmax, score, 0.0)
