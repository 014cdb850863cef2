"""ORB keypoint orientation + rBRIEF descriptors (port of gdslam_tpu.ops.orb).

Replaces the reference's IC_Angle (ORBextractor.cc:77-104) and
computeOrbDescriptor (ORBextractor.cc:108-147). The sampling pattern is the
JAX package's seeded Gaussian BRIEF pattern, computed here with the same
numpy calls, and rotation is quantized to the same 30 bins, so descriptors
are bit-compatible with the JAX package's. Patches are direct gathers with
zero fill outside the image (the JAX package's one-hot matmuls were a TPU
device; both copy pixel values exactly).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH = 31
HALF_PATCH = 15
N_BITS = 256
PATCH_EXT = 37        # 2*18+1: covers any rotation of the r<=13 pattern
_EXT_HALF = PATCH_EXT // 2
N_ANGLE_BINS = 30     # 12-degree rotation quantization


def _np_pattern(seed: int = 42, n_bits: int = N_BITS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    r = np.sqrt((pts ** 2).sum(-1, keepdims=True))
    pts = np.where(r > 13.0, pts * (13.0 / r), pts)
    return np.round(pts).astype(np.float32)  # [256, 2 taps, (x, y)]


BRIEF_PATTERN = _np_pattern()   # [256, 2, 2]


def _np_ic_tables():
    """31x31 circular footprint + x/y coordinate grids for IC moments."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = (xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH
    return (mask.astype(np.float32), xs.astype(np.float32), ys.astype(np.float32))


_IC_MASK, _IC_X, _IC_Y = _np_ic_tables()


def _np_bin_taps() -> np.ndarray:
    """[N_ANGLE_BINS, 512] flat index into the 37x37 patch of each tap
    (2 per bit) of the pattern rotated into each bin — the columns of the
    JAX package's one-hot `_np_bin_matrix`, computed identically."""
    pat = _np_pattern()
    taps = np.zeros((N_ANGLE_BINS, 512), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[..., 0] * ca - pat[..., 1] * sa).astype(int)
        ry = np.round(pat[..., 0] * sa + pat[..., 1] * ca).astype(int)
        rx = np.clip(rx, -_EXT_HALF, _EXT_HALF)
        ry = np.clip(ry, -_EXT_HALF, _EXT_HALF)
        taps[b] = ((ry + _EXT_HALF) * PATCH_EXT + (rx + _EXT_HALF)).reshape(-1)
    return taps


_BIN_TAPS = _np_bin_taps()


def extract_patches(img: torch.Tensor, uv: torch.Tensor,
                    size: int = PATCH_EXT) -> torch.Tensor:
    """[K, size, size] patches centered at round(uv), out-of-image = 0."""
    H, W = img.shape
    half = size // 2
    off = torch.arange(-half, half + 1, device=img.device)
    u = torch.round(uv[:, 0]).to(torch.int64)
    v = torch.round(uv[:, 1]).to(torch.int64)
    rows = v[:, None] + off[None]                              # [K, size]
    cols = u[:, None] + off[None]
    inside = ((rows >= 0) & (rows < H))[:, :, None] & \
        ((cols >= 0) & (cols < W))[:, None, :]
    flat = rows.clamp(0, H - 1)[:, :, None] * W + cols.clamp(0, W - 1)[:, None, :]
    vals = img.reshape(-1)[flat]
    return torch.where(inside, vals, torch.zeros((), dtype=img.dtype, device=img.device))


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device):
    """The IC mask, its x and y weights and the rotated tap table on
    `device`, uploaded once (a host array sent to the card is a blocking
    copy, which waits for the card on every use). Read-only."""
    return tuple(torch.from_numpy(t).to(device) for t in (_IC_MASK, _IC_X, _IC_Y, _BIN_TAPS))


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Orientation from [K, 37, 37] patches (31x31 circular interior)."""
    dev = patches.device
    inner = patches[:, 3:3 + PATCH, 3:3 + PATCH].float()
    mask, xs, ys, _ = _tables_on(dev)
    w = inner * mask
    m10 = torch.sum(w * xs, dim=(1, 2))
    m01 = torch.sum(w * ys, dim=(1, 2))
    return torch.atan2(m01, m10)


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """Rotation bin per keypoint: round(angle / 12 deg) mod 30 (half to
    even, as jnp.round)."""
    return torch.remainder(torch.round(angle / (2 * np.pi / N_ANGLE_BINS)).to(torch.int64),
                           N_ANGLE_BINS)


def brief_from_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Packed [K, 32] uint8 descriptors from [K, 37, 37] patches + angles:
    bit i = I(tap 2i) < I(tap 2i+1) with the pattern rotated into the
    keypoint's bin."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1).float()
    taps = _tables_on(patches.device)[3][angle_bins(angle)]             # [K, 512]
    V = torch.gather(flat, 1, taps)
    return pack_bits(V[:, 0::2] < V[:, 1::2])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 32] uint8 (little-endian bit order)."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] bool."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    b = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return b.reshape(packed.shape[:-1] + (256,)).to(torch.bool)


def feature_quotas(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level keypoint budget, geometric in 1/scale (ORBextractor.cc:410)."""
    f = 1.0 / scale
    first = n_features * (1 - f) / (1 - f ** n_levels)
    quotas, total = [], 0
    for lv in range(n_levels - 1):
        q = int(round(first * f ** lv))
        quotas.append(q)
        total += q
    quotas.append(max(n_features - total, 0))
    return quotas
