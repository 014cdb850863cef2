"""Farneback dense optical flow as a pyramid of tensor programs (port of
gdslam_tpu.ops.flow).

Replaces cv::calcOpticalFlowFarneback as used by GeoMaskMaker::GetFlow
(reference GeoMaskMaker.cc:158-166): approximate each neighborhood by a
quadratic polynomial via Gaussian-weighted least squares ("polynomial
expansion"), then solve for the displacement field that maps one expansion
onto the other, smoothed over a window, iterated coarse-to-fine over a
pyramid that halves each level (`// 2`, through resize_bilinear).

Planar: the flow, the expansion and the 2 x 2 normal equations are kept as
separate [H, W] planes. Summation orders that differ from the JAX package:
the 5 x 5 correlations are one `conv2d` (cuDNN on the card, TF32 off
package-wide), and the 15-tap box blur is `avg_pool2d` (the sum over the
window divided by 15, where the JAX package adds 15 taps weighted by 1/15).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gdslam_tpu_torch.ops import image as image_ops


def _poly_exp_filters(n: int, sigma: float) -> np.ndarray:
    """Least-squares projection filters for basis (1, x, y, x2, y2, xy)."""
    xs = np.arange(-n, n + 1)
    X, Y = np.meshgrid(xs, xs)  # [k, k], X varies along axis 1
    w = np.exp(-(X ** 2 + Y ** 2) / (2 * sigma ** 2))
    B = np.stack([np.ones_like(X), X, Y, X ** 2, Y ** 2, X * Y],
                 axis=-1).reshape(-1, 6).astype(np.float64)
    Wd = np.diag(w.reshape(-1))
    M = np.linalg.solve(B.T @ Wd @ B, B.T @ Wd)      # [6, k*k]
    k = 2 * n + 1
    return np.asarray(M.reshape(6, k, k), np.float32)


_POLY_FILTERS = _poly_exp_filters(2, 1.2)          # poly_n=5 -> radius 2


@functools.lru_cache(maxsize=None)
def _poly_filters_on(device: torch.device) -> torch.Tensor:
    """[6, 1, 5, 5] on `device`, uploaded once (an upload waits for the card)."""
    return torch.from_numpy(_POLY_FILTERS[:, None]).to(device)


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source rows of numpy 'reflect' padding (edge not repeated) of an axis
    of n by `pad` on both sides, also where pad >= n (numpy reflects again;
    torch's F.pad refuses), uploaded once per shape."""
    i = np.arange(-pad, n + pad)
    period = max(2 * (n - 1), 1)
    j = np.mod(i, period)
    return torch.from_numpy(np.where(j >= n, period - j, j)).to(device)


def _reflect(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    return x.index_select(dim, _reflect_index(x.shape[dim], pad, x.device))


def _correlate(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Correlate [H, W] with [C, 1, k, k] kernels -> [C, H, W] (reflect
    pad). conv2d does not flip its kernel, so it is a correlation."""
    p = kernels.shape[-1] // 2
    x = _reflect(_reflect(img, p, 0), p, 1)
    return F.conv2d(x[None, None], kernels)[0]


def _expansion_planes(img: torch.Tensor):
    """The per-pixel quadratic fit as planes: (a00, a01, a11, b0, b1), a10 == a01."""
    r = _correlate(img, _poly_filters_on(img.device))
    return r[3], r[5] * 0.5, r[4], r[1], r[2]


def poly_expansion(img: torch.Tensor):
    """Per-pixel quadratic fit: returns (A [H, W, 2, 2], b [H, W, 2])."""
    a00, a01, a11, b0, b1 = _expansion_planes(img)
    A = torch.stack([torch.stack([a00, a01], dim=-1), torch.stack([a01, a11], dim=-1)], dim=-2)
    return A, torch.stack([b0, b1], dim=-1)


def _box_blur(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box filter on [C, H, W]: rows, then columns, each with
    numpy-reflect padding (the winsize smoothing)."""
    p = size // 2
    y = F.avg_pool2d(_reflect(x, p, 1)[None], (size, 1), stride=1)
    return F.avg_pool2d(_reflect(y, p, 3), (1, size), stride=1)[0]


def _flow_step(e1, img2, fx, fy, winsize: int):
    """One Farneback displacement update on planes. Warps image 2 by the
    current flow and re-expands it (the JAX package's warping formulation),
    forms the 2 x 2 normal equations A^T A d = A^T db, smooths them over the
    window and solves them in closed form."""
    H, W = fx.shape
    v = torch.arange(H, dtype=torch.float32, device=fx.device)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=fx.device)[None, :]
    img2w = image_ops.bilinear_sample(img2, torch.stack([u + fx, v + fy], dim=-1))
    e2 = _expansion_planes(img2w)
    a00, a01, a11 = (0.5 * (p + q) for p, q in zip(e1[:3], e2[:3]))
    db0 = -0.5 * (e2[3] - e1[3]) + (a00 * fx + a01 * fy)
    db1 = -0.5 * (e2[4] - e1[4]) + (a01 * fx + a11 * fy)
    # A is symmetric, so G = A^T A is too: g01 == g10
    g = torch.stack([a00 * a00 + a01 * a01, a00 * a01 + a01 * a11, a01 * a01 + a11 * a11,
                     a00 * db0 + a01 * db1, a01 * db0 + a11 * db1])
    g00, g01, g11, h0, h1 = _box_blur(g, winsize)
    det = g00 * g11 - g01 * g01
    det = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
    return (g11 * h0 - g01 * h1) / det, (g00 * h1 - g01 * h0) / det


def farneback_flow(img1: torch.Tensor, img2: torch.Tensor, levels: int = 3,
                   winsize: int = 15, iterations: int = 3, finest_level: int = 0,
                   upsample: bool = True) -> torch.Tensor:
    """Dense flow img1 -> img2, [H, W, 2] (du, dv) in pixels.

    finest_level > 0 stops the coarse-to-fine refinement early.
    upsample=False returns the flow AT finest_level's resolution, in that
    level's pixel units (for the reduced-grid Mahalanobis masker); with
    upsample=True it is upsampled once more, to the next finer level (the
    full resolution when finest_level is 0 or 1), as in the JAX package."""
    H, W = img1.shape
    p1, p2 = [img1], [img2]
    shapes = [(H, W)]
    for _ in range(1, levels):
        h, w = shapes[-1][0] // 2, shapes[-1][1] // 2
        p1.append(image_ops.resize_bilinear(p1[-1], h, w))
        p2.append(image_ops.resize_bilinear(p2[-1], h, w))
        shapes.append((h, w))
    fx = torch.zeros(shapes[-1], device=img1.device)
    fy = torch.zeros(shapes[-1], device=img1.device)
    for lv in range(levels - 1, finest_level - 1, -1):
        e1 = _expansion_planes(p1[lv])
        for _ in range(iterations):
            fx, fy = _flow_step(e1, p2[lv], fx, fy, winsize)
        if lv == finest_level and not upsample:
            break
        if lv > 0:
            h, w = shapes[lv - 1]
            fx = 2.0 * image_ops.resize_bilinear(fx, h, w)
            fy = 2.0 * image_ops.resize_bilinear(fy, h, w)
    return torch.stack([fx, fy], dim=-1)
