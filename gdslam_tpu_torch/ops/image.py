"""Image primitives: separable Gaussian blur, bilinear resize and sampling,
pyramid (port of gdslam_tpu.ops.image).

Replaces the reference's cv::resize INTER_LINEAR pyramid (scale 1.2,
8 levels; ORBextractor.cc:1107-1132) and the 7x7 sigma-2 GaussianBlur
before descriptor computation (ORBextractor.cc:1085-1086). All levels live
in one [L, H, W] canvas with per-level valid sizes, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """Matches cv::getGaussianKernel semantics (normalized), float32."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, through a float64 carrier (a
    product of two float32 values is exact there): the fused multiply-add
    into which XLA's CPU compiler contracts a product and a sum, where the
    port must round as the JAX package does. b and c may be Python floats,
    taken as float32 constants."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    return (a.double() * b + c).float()


def _reflect_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """numpy 'reflect' padding (edge not repeated) along one dim."""
    n = x.shape[dim]
    dev = x.device          # built on the device: an upload would wait for the card
    idx = torch.cat([torch.arange(pad, 0, -1, device=dev), torch.arange(n, device=dev),
                     torch.arange(n - 2, n - 2 - pad, -1, device=dev)])
    return x.index_select(dim, idx)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur on [..., H, W] with reflect padding: a sum of
    ksize shifted slices per axis, taps added in order (no convolution
    library call, so no TF32 and the JAX package's summation order)."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    H, W = img.shape[-2], img.shape[-1]
    x = _reflect_pad(img, pad, img.ndim - 2)
    out = 0
    for i in range(ksize):
        out = out + x[..., i:i + H, :] * k[i]
    x = _reflect_pad(out, pad, img.ndim - 1)
    out = 0
    for i in range(ksize):
        out = out + x[..., :, i:i + W] * k[i]
    return out


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample img [H, W] at float pixel coords uv [..., 2] = (u=x, v=y); each
    of the four taps outside the image reads `fill`, so a footprint that is
    partly inside (u0 = -1 or v0 = -1 included) stays exact. Four direct
    gathers, weighted and summed in the JAX package's order (its quad packing
    of the taps was a TPU device for gathers)."""
    H, W = img.shape
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
    flat = img.reshape(-1)

    def tap(vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = flat[vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)]
        return torch.where(inb, val, fill)

    w00 = (1 - du) * (1 - dv)
    w01 = du * (1 - dv)
    w10 = (1 - du) * dv
    w11 = du * dv
    return (w00 * tap(v0i, u0i) + w01 * tap(v0i, u0i + 1)
            + w10 * tap(v0i + 1, u0i) + w11 * tap(v0i + 1, u0i + 1))


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] 1-D linear-interpolation matrix (pixel-center aligned,
    cv::resize INTER_LINEAR semantics)."""
    s = n_in / n_out
    x = (np.arange(n_out) + 0.5) * s - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    f = np.clip(x - x0, 0.0, 1.0)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), x0] += 1.0 - f
    M[np.arange(n_out), x1] += f
    return M


@functools.lru_cache(maxsize=None)
def _interp_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """The interpolation matrix on `device`, uploaded once: a host array sent
    to the card is a blocking copy, which waits for the card on every use."""
    return torch.from_numpy(_interp_matrix(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR-compatible resize: R @ img @ C^T with the
    static interpolation matrices (rows first, as the JAX einsum contracts)."""
    H, W = img.shape
    return (_interp_matrix_on(H, out_h, img.device) @ img) @ _interp_matrix_on(W, out_w, img.device).T


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Per-level (h, w) using the reference's rounding (ORBextractor.cc:1110)."""
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale ** lv)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def build_pyramid(img: torch.Tensor, height: int, width: int,
                  n_levels: int = 8, scale: float = 1.2) -> tuple[torch.Tensor, tuple]:
    """Build the scale pyramid into one [L, H, W] canvas; level lv occupies
    the top-left (h_lv, w_lv) region, the rest is zero. Each level is
    resized from the previous one (the reference's successive cv::resize)."""
    shapes = pyramid_shapes(height, width, n_levels, scale)
    canvas = torch.zeros((n_levels, height, width), dtype=img.dtype, device=img.device)
    canvas[0] = img
    prev = img
    for lv in range(1, n_levels):
        h, w = shapes[lv]
        level = resize_bilinear(prev, h, w)
        canvas[lv, :h, :w] = level
        prev = level
    return canvas, tuple(shapes)
