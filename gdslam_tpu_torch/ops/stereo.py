"""Rectified stereo matching: descriptor coarse match + SAD subpixel refine
(port of gdslam_tpu.ops.stereo), as the hand-written CUDA kernel
`csrc/stereo_match.cu` and its plain PyTorch twin.

Replaces Frame::ComputeStereoMatches (reference Frame.cc:638-813): for each
left keypoint, the right keypoint of least Hamming distance inside its row
band (|dv| <= 2 scale^level), disparity range [-1, bf / min_z] and level
+-1, accepted under 75; then an 11x11 SAD window slid +-5 px around it and a
parabola through the best three offsets (clipped to +-1, interior offsets
only) refine the disparity. Outputs mvuRight and mvDepth (-1 / 0 where a
keypoint is unmatched or its disparity is <= 0.1).

`stereo_match` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises, and counts its calls in
`stereo_match.launches` (one a call). The kernel buckets the right
keypoints by row and walks only the buckets of each left keypoint's row
band (`row_buckets_plain` and `band_segments_plain` are the plain twins of
the bucket table and of the walked segments); it builds the buckets in
every block's shared memory (one launch) where they fit (up to ~4100 right
keypoints), else by a first launch into a scratch buffer (two launches;
`row_buckets` makes that first launch alone, for its card test).
Each SAD is summed in one fixed order on both routes (each window row left
to right, then the rows top to bottom), so the kernel equals its twin to
the bit; the row band comes from one table of f32 powers (`band_table`)
that both read.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gdslam_tpu_torch.ops import cuda_build, hamming
from gdslam_tpu_torch.ops import orb as orb_ops

SAD_HALF = 5          # 11x11 window (Frame.cc:702 w=5)
SLIDE = 5             # +-5 px search (Frame.cc:714 L=5)
TH_ORB_DIST = 75      # (TH_HIGH + TH_LOW) / 2 (Frame.cc:660)
BIG = 1 << 20         # the cost of a pair outside the gates
BAND_LEVELS = 32      # entries of the row-band table (levels clamp into it)
MAX_ROWS = 4096       # rows of the kernel's bucket table, at most (keypoints past clamp)
REC_WORDS = 12        # a bucket record: u, v, level, j and the 32-byte descriptor


@functools.lru_cache(maxsize=None)
def _band_table_cached(scale_factor: float, device: torch.device) -> torch.Tensor:
    lv = np.arange(BAND_LEVELS, dtype=np.float64)
    tab = (2.0 * np.float64(np.float32(scale_factor)) ** lv).astype(np.float32)
    return torch.from_numpy(tab).to(device)


def band_table(scale_factor: float, device) -> torch.Tensor:
    """[BAND_LEVELS] f32 row bands 2 * scale^level, each the correctly
    rounded f32 of the exact power of the f32 scale, which is what the JAX
    package's `2.0 * scale ** level` gives on the CPU (a device's own pow
    may differ by an ulp, and an ulp can flip |dv| <= band). Uploaded once
    per device; read-only."""
    return _band_table_cached(float(scale_factor), torch.device(device))


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def stereo_match_plain(left_uv, left_level, left_desc, left_valid,
                       right_uv, right_level, right_desc, right_valid,
                       bf: float, min_z: float, img_left=None, img_right=None,
                       scale_factor: float = 1.2):
    """The same function in plain PyTorch over the dense [N, M] cost."""
    dev = left_uv.device
    if right_uv.shape[0] == 0:                      # nothing to match against
        n = left_uv.shape[0]
        return torch.full((n,), -1.0, device=dev), torch.zeros(n, device=dev)
    b_over = _f32(bf / min_z, dev)
    ham = hamming.hamming_matrix(left_desc, right_desc)
    band = band_table(scale_factor, dev)[left_level.long().clamp(0, BAND_LEVELS - 1)]
    row_ok = torch.abs(left_uv[:, None, 1] - right_uv[None, :, 1]) <= band[:, None]
    disp = left_uv[:, None, 0] - right_uv[None, :, 0]
    disp_ok = (disp >= -1.0) & (disp <= b_over)
    lvl_ok = torch.abs(left_level[:, None] - right_level[None, :]) <= 1
    mask = row_ok & disp_ok & lvl_ok & left_valid[:, None] & right_valid[None, :]
    cost = torch.where(mask, ham, BIG)
    best = cost.amin(dim=1)
    idx = torch.argmin(cost, dim=1)                 # the first index among ties
    matched = best < TH_ORB_DIST

    uR0 = right_uv[idx, 0]
    if img_left is not None and img_right is not None:
        sad = _sads(img_left, img_right, left_uv, uR0)          # [N, 11]
        k = torch.argmin(sad, dim=1)
        interior = (k > 0) & (k < 2 * SLIDE)
        km = torch.clamp(k, 1, 2 * SLIDE - 1)
        s_m1 = sad.gather(1, (km - 1)[:, None])[:, 0]
        s_0 = sad.gather(1, km[:, None])[:, 0]
        s_p1 = sad.gather(1, (km + 1)[:, None])[:, 0]
        denom = torch.clamp(s_m1 - 2 * s_0 + s_p1, min=1e-6)
        delta = torch.clamp(0.5 * (s_m1 - s_p1) / denom, -1.0, 1.0)
        refine = (km - SLIDE).float() + torch.where(interior, delta, 0.0)
        uR = uR0 + refine
    else:
        uR = uR0

    disparity = left_uv[:, 0] - uR
    ok = matched & (disparity > 0.1) & (disparity <= b_over)
    depth = torch.where(ok, _f32(bf, dev) / torch.clamp(disparity, min=1e-6), 0.0)
    ur = torch.where(ok, uR, -1.0)
    return ur, depth


def _sads(img_left, img_right, left_uv, uR0) -> torch.Tensor:
    """[N, 11] SAD of the left 11x11 patch against the right window at each
    offset -5..5 around (round(uR0), round(vL)); pixels outside the image
    are 0. Each SAD: every window row summed left to right, then the rows
    top to bottom (the kernel's order)."""
    lp = orb_ops.extract_patches(img_left, left_uv, 2 * SAD_HALF + 1)        # [N, 11, 11]
    strip = orb_ops.extract_patches(img_right, torch.stack([uR0, left_uv[:, 1]], 1),
                                    2 * (SAD_HALF + SLIDE) + 1)             # [N, 21, 21]
    rows = strip[:, SLIDE:SLIDE + 2 * SAD_HALF + 1]                          # [N, 11, 21]
    wins = rows.unfold(2, 2 * SAD_HALF + 1, 1)                               # [N, 11 r, 11 k, 11 c]
    d = torch.abs(wins - lp[:, :, None, :])
    row = d[..., 0]
    for c in range(1, 2 * SAD_HALF + 1):
        row = row + d[..., c]                                                # [N, r, k]
    tot = row[:, 0]
    for r in range(1, 2 * SAD_HALF + 1):
        tot = tot + row[:, r]
    return tot


def bucket_rows(height: int) -> int:
    """Rows of the kernel's bucket table for images of `height` rows (0:
    no images given): one a pixel row, at most MAX_ROWS."""
    return min(height, MAX_ROWS) if height > 0 else MAX_ROWS


def _clamp_row(r: torch.Tensor, rows: int) -> torch.Tensor:
    """f32 rows as bucket indices, as the kernel's clamp_row: NaN to 0,
    then clamped into [0, rows)."""
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return r.clamp(0, rows - 1).long()


def row_buckets_plain(right_uv, right_valid, rows: int) -> tuple:
    """The kernel's bucket table in plain PyTorch: (order [M] int64,
    offsets [rows + 1] int64). The valid right keypoints, bucketed by row
    b = clamp(floor(v), 0, rows - 1), are order[offsets[b]:offsets[b + 1]]
    (ascending j here; in no set order on the card); order past
    offsets[rows] is -1."""
    b = _clamp_row(torch.floor(right_uv[:, 1]), rows)
    b = torch.where(right_valid, b, torch.full_like(b, rows))    # invalid: past the end
    key, order = torch.sort(b, stable=True)
    order = torch.where(key < rows, order, torch.full_like(order, -1))
    counts = torch.bincount(b, minlength=rows + 1)[:rows]
    offsets = torch.zeros(rows + 1, dtype=torch.int64, device=right_uv.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


def band_segments_plain(left_uv, left_level, rows: int, scale_factor: float = 1.2) -> tuple:
    """(lo [N], hi [N]) int64: the buckets the kernel walks for each left
    keypoint, floor(vL - band) - 1 .. floor(vL + band) + 1 in f32, clamped
    as the buckets are; its records are order[offsets[lo]:offsets[hi + 1]]."""
    band = band_table(scale_factor, left_uv.device)[left_level.long().clamp(0, BAND_LEVELS - 1)]
    v = left_uv[:, 1]
    return (_clamp_row(torch.floor(v - band) - 1.0, rows),
            _clamp_row(torch.floor(v + band) + 1.0, rows))


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stereo_match_launch.argtypes = [p, p, p, p, i, p, p, p, p, i, p, p, p, i, i, f, f,
                                        i, p, p, p, i, p]
    lib.stereo_match_launch.restype = i
    lib.stereo_buckets_launch.argtypes = [p, p, p, p, i, i, p, i, p]
    lib.stereo_buckets_launch.restype = i


def _library():
    return cuda_build.load("stereo_match", _declare)


def stereo_match(left_uv, left_level, left_desc, left_valid,
                 right_uv, right_level, right_desc, right_valid,
                 bf: float, min_z: float, img_left=None, img_right=None,
                 scale_factor: float = 1.2):
    """Returns (ur [N], depth [N]) f32 per left keypoint (-1 / 0 where
    unmatched). left_uv [N, 2] f32, left_level [N] int32, left_desc [N, 32]
    uint8 packed, left_valid [N] bool; right_* likewise with M rows; the
    images [H, W] f32, or both None for no SAD refinement. min_z: the least
    depth (the baseline: Frame.cc:655 maxD = bf / minZ). One call of the
    kernel on the card (one launch; two past ~4100 right keypoints)."""
    name = "stereo_match"
    device = left_uv.device
    if device.type == "cpu":
        return stereo_match_plain(left_uv, left_level, left_desc, left_valid,
                                  right_uv, right_level, right_desc, right_valid,
                                  bf, min_z, img_left, img_right, scale_factor)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    N, M = left_uv.shape[0], right_uv.shape[0]
    f32, u8, i32, b8 = torch.float32, torch.uint8, torch.int32, torch.bool
    for what, t, dt, shape in (
            ("left_uv", left_uv, f32, (N, 2)), ("left_level", left_level, i32, (N,)),
            ("left_desc", left_desc, u8, (N, 32)), ("left_valid", left_valid, b8, (N,)),
            ("right_uv", right_uv, f32, (M, 2)), ("right_level", right_level, i32, (M,)),
            ("right_desc", right_desc, u8, (M, 32)), ("right_valid", right_valid, b8, (M,))):
        cuda_build.check(name, what, t, dt, shape, device)
    if (img_left is None) != (img_right is None):
        raise ValueError(f"{name}: give both images or neither")
    H = W = 0
    if img_left is not None:
        H, W = img_left.shape
        cuda_build.check(name, "img_left", img_left, f32, (H, W), device)
        cuda_build.check(name, "img_right", img_right, f32, (H, W), device)
    lib = _library()
    if left_desc.data_ptr() % 16 or right_desc.data_ptr() % 16:
        raise ValueError(f"{name}: descriptors must be 16-byte aligned")
    if left_uv.data_ptr() % 8 or right_uv.data_ptr() % 8:
        raise ValueError(f"{name}: uv must be 8-byte aligned")
    band = band_table(scale_factor, device)
    rows = bucket_rows(H)
    out = torch.empty(2, N, dtype=f32, device=device)
    if N:
        scratch = _scratch(M, rows, device)
        cuda_build.launch(
            name, device, lib.stereo_match_launch,
            left_uv.data_ptr(), left_level.data_ptr(), left_desc.data_ptr(),
            left_valid.data_ptr(), N, right_uv.data_ptr(), right_level.data_ptr(),
            right_desc.data_ptr(), right_valid.data_ptr(), M, band.data_ptr(),
            img_left.data_ptr() if img_left is not None else None,
            img_right.data_ptr() if img_right is not None else None, H, W,
            float(np.float32(bf)), float(np.float32(bf / min_z)), rows, scratch.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr())
        stereo_match.launches += 1
    return out[0], out[1]


stereo_match.launches = 0


def _scratch(M: int, rows: int, device) -> torch.Tensor:
    """The bucket table's device buffer: M records of REC_WORDS int32 words,
    then the offsets [rows + 1], as int32."""
    return torch.empty(REC_WORDS * M + rows + 1, dtype=torch.int32, device=device)


def row_buckets(right_uv, right_level, right_desc, right_valid, rows: int) -> tuple:
    """The kernel's bucket table on its own (on the card the bucket launch
    that stereo_match makes past a block's shared memory, here for any M;
    `row_buckets_plain` on the CPU): (order [M] int64, offsets
    [rows + 1] int64), as row_buckets_plain's but with no set order inside
    a bucket and order past offsets[rows] unspecified. For checking the
    build; stereo_match builds its own."""
    name = "row_buckets"
    device = right_uv.device
    if device.type == "cpu":
        return row_buckets_plain(right_uv, right_valid, rows)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    M = right_uv.shape[0]
    for what, t, dt, shape in (("right_uv", right_uv, torch.float32, (M, 2)),
                               ("right_level", right_level, torch.int32, (M,)),
                               ("right_desc", right_desc, torch.uint8, (M, 32)),
                               ("right_valid", right_valid, torch.bool, (M,))):
        cuda_build.check(name, what, t, dt, shape, device)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows, expected 1..{MAX_ROWS}")
    lib = _library()
    if right_desc.data_ptr() % 16:
        raise ValueError(f"{name}: descriptors must be 16-byte aligned")
    scratch = _scratch(M, rows, device)
    cuda_build.launch(name, device, lib.stereo_buckets_launch, right_uv.data_ptr(),
                      right_level.data_ptr(), right_desc.data_ptr(), right_valid.data_ptr(), M,
                      rows, scratch.data_ptr())
    row_buckets.launches += 1
    return (scratch[:REC_WORDS * M].view(M, REC_WORDS)[:, 3].long(),
            scratch[REC_WORDS * M:].long())


row_buckets.launches = 0
