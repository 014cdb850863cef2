"""The ORB front end's per-level work: four hand-written CUDA kernels
(`csrc/orb_extract.cu`) and their plain PyTorch twins.

`frontend/extractor.extract` runs, after the pyramid:

- `gaussian_blur7` (twin: `ops/image.gaussian_blur`): the 7-tap sigma-2
  blur of the whole [L, H, W] canvas, reflect padding at the canvas's edges;
- `orb_fast_cells` (twin `fast_cells_plain`): for every level and 16 x 16 cell,
  FAST-9/16 strength, thresholds 20 and 7, strict 3x3 NMS, the per-cell
  fallback to the low threshold, the edge margin and the cell's top two;
- `orb_quota_select` (twin `quota_select_plain`): each level's quota of
  candidates in the order of `lax.top_k` (larger score, then lower index),
  zero-padded where a level has fewer candidates than its quota; the
  response, level and level-0 coordinates of every row;
- `orb_describe` (twin `describe_plain`): the intensity-centroid angle over the
  31 x 31 disc of the raw level and the 256 rBRIEF tests of the blurred
  level in the angle's 12-degree bin, packed little-endian.

Two roundings are defined here rather than left to a library. The IC
moments are summed row by row: each of the 31 rows over its 31 columns in
order, then the 31 row sums in order (top to bottom). `torch.sum` has no
defined order on the card, and above level 0 the moments are not integers,
so the twin writes that order out with elementwise ops and the kernel
follows it; against the JAX package's XLA sum it moves an angle by ~1e-5
rad. The rotation bin is round_half_even(angle * RCP_BIN) mod 30, RCP_BIN
the float32 reciprocal of the float32 bin width: the product XLA makes of
the JAX package's `angle / (2 pi / 30)` (a division there, on the CPU,
rounds differently one time in a few thousand near a bin edge), and the
same product on either device.

Each wrapper takes its twin only for tensors on the CPU; for a CUDA tensor
it launches its kernel, counting the launch in `<wrapper>.launches`, or
raises. None reads anything back from the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gdslam_tpu_torch.ops import cuda_build
from gdslam_tpu_torch.ops import fast as fast_ops
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops import orb as orb_ops

LIB = "orb_extract"
EDGE_MARGIN = 16      # reference detects within minBorder=19-3 (ORBextractor.cc:774)
CELL = 16             # candidate cell size (px), top-2 kept per cell
MAX_LEVELS = 16       # the kernels' level table
MAX_CAND = 16384      # candidates a level orb_quota_select sorts in shared memory
BLUR_TAPS = tuple(float(v) for v in image_ops.gaussian_kernel_1d(7, 2.0))
RCP_BIN = float(np.float32(1.0) / np.float32(2 * np.pi / orb_ops.N_ANGLE_BINS))


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.orb_fast_cells_launch.argtypes = [p, i, i, i, p, p, f, f, p, p, i, p]
    lib.orb_quota_select_launch.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, i, p]
    lib.gaussian_blur7_launch.argtypes = [p, p, i, i, i, p, i, p]
    lib.orb_describe_launch.argtypes = [p, p, i, i, p, p, i, p, f, p, p, i, p]
    lib.orb_angle_bins_launch.argtypes = [p, p, p, i, f, p, p, i, p]
    for fn in (lib.orb_fast_cells_launch, lib.orb_quota_select_launch,
               lib.gaussian_blur7_launch, lib.orb_describe_launch, lib.orb_angle_bins_launch):
        fn.restype = i


def _ints(vals) -> ctypes.Array:
    return (ctypes.c_int * len(vals))(*vals)


def _floats(vals) -> ctypes.Array:
    return (ctypes.c_float * len(vals))(*vals)


def n_candidates(shapes) -> list[int]:
    """Candidates per level: two per whole 16 x 16 cell."""
    return [2 * (h // CELL) * (w // CELL) for h, w in shapes]


def level_scales(n_levels: int, scale: float) -> list[float]:
    """float32(scale ** l) per level, as Python floats (the f32 constant that
    `uv_lv * scale ** l` multiplies by on either device)."""
    return [float(np.float32(float(scale) ** lv)) for lv in range(n_levels)]


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    twin); raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check_levels(name: str, shapes, H: int, W: int) -> None:
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{name}: {len(shapes)} levels, at most {MAX_LEVELS}")
    for h, w in shapes:
        if not (1 <= h <= H and 1 <= w <= W):
            raise ValueError(f"{name}: a level of {h} x {w} does not fit the {H} x {W} canvas")


# ----------------------------------------------------------------------------
# the plain twins
# ----------------------------------------------------------------------------

def _level_score(img_lv: torch.Tensor, h: int, w: int, th_hi: float,
                 th_lo: float) -> torch.Tensor:
    """One threshold-free FAST pass per level, then the high threshold with
    the per-cell low-threshold fallback (ORBextractor.cc:809-815)."""
    strength = fast_ops.fast_strength(img_lv)
    s_hi = fast_ops.nms3x3(torch.where(strength > th_hi, strength, 0.0))
    s_lo = fast_ops.nms3x3(torch.where(strength > th_lo, strength, 0.0))
    Hc, Wc = h // CELL, w // CELL
    hi_cells = s_hi[:Hc * CELL, :Wc * CELL].reshape(Hc, CELL, Wc, CELL).amax(dim=(1, 3))
    has_hi = (hi_cells > 0).repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)
    has_hi = torch.nn.functional.pad(has_hi, (0, w - Wc * CELL, 0, h - Hc * CELL))
    return torch.where(has_hi, s_hi, s_lo)


def _level_candidates(score: torch.Tensor, h: int, w: int):
    """Per-cell top-2 candidates from a score map. Returns (scores, uv)."""
    H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = (ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN) & \
         (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN)
    score = torch.where(ok, score, 0.0)

    Hc, Wc = H // CELL, W // CELL
    cells = score[:Hc * CELL, :Wc * CELL].reshape(Hc, CELL, Wc, CELL)
    cells = cells.permute(0, 2, 1, 3).reshape(Hc, Wc, CELL * CELL)
    vals, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :2], idx[..., :2]                 # [Hc, Wc, 2]
    in_y = idx // CELL
    in_x = idx % CELL
    cy = torch.arange(Hc, device=dev)[:, None, None]
    cx = torch.arange(Wc, device=dev)[None, :, None]
    u = (cx * CELL + in_x).reshape(-1).float()
    v = (cy * CELL + in_y).reshape(-1).float()
    return vals.reshape(-1), torch.stack([u, v], dim=-1)


def fast_cells_plain(canvas: torch.Tensor, shapes, th_hi: float, th_lo: float):
    """Every level's per-cell top-2 candidates: scores [C] f32 and uv [C, 2]
    f32 (level coordinates), level by level, cells row-major, two a cell."""
    scores, uvs = [], []
    for lv, (h, w) in enumerate(shapes):
        s, uv = _level_candidates(_level_score(canvas[lv, :h, :w], h, w, float(th_hi),
                                               float(th_lo)), h, w)
        scores.append(s)
        uvs.append(uv)
    return torch.cat(scores), torch.cat(uvs, 0)


def quota_select_plain(scores: torch.Tensor, cand_uv: torch.Tensor, shapes, quotas,
                       scale: float):
    """Each level's top quota of candidates, larger score then lower index
    first (lax.top_k's order), zero-padded past a level's candidates (padded
    rows take candidate 0's uv). Returns response [N], uv_lv [N, 2] (level
    coordinates), uv [N, 2] (level 0), level [N] int32 and valid [N]."""
    resp, uv_lv, uv0, lvls = [], [], [], []
    start = 0
    for lv, (n, k, sc) in enumerate(zip(n_candidates(shapes), quotas,
                                        level_scales(len(shapes), scale))):
        cand_s, c_uv = scores[start:start + n], cand_uv[start:start + n]
        start += n
        k_eff = min(k, n)                   # tiny levels: fewer cells than quota
        top_s, top_i = torch.sort(cand_s, descending=True, stable=True)
        top_s, top_i = top_s[:k_eff], top_i[:k_eff]
        if k_eff < k:
            top_s = torch.nn.functional.pad(top_s, (0, k - k_eff))
            top_i = torch.nn.functional.pad(top_i, (0, k - k_eff))
        u = c_uv[top_i]                     # [k, 2] level coords
        resp.append(top_s)
        uv_lv.append(u)
        uv0.append(u * sc)
        lvls.append(torch.full((k,), lv, dtype=torch.int32, device=scores.device))
    response = torch.cat(resp)
    return response, torch.cat(uv_lv, 0), torch.cat(uv0, 0), torch.cat(lvls), response > 0


def _row_ordered_sum(q: torch.Tensor) -> torch.Tensor:
    """[K, 31, 31] -> [K]: each row's columns in order, then the rows in
    order (the kernel's order)."""
    r = q[:, :, 0]
    for j in range(1, q.shape[2]):
        r = r + q[:, :, j]
    m = r[:, 0]
    for i in range(1, q.shape[1]):
        m = m + r[:, i]
    return m


def ic_moments(raw_patches: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01) of [K, 37, 37] patches over the 31 x 31 disc, summed row
    by row (`_row_ordered_sum`)."""
    mask, xs, ys, _ = orb_ops._tables_on(raw_patches.device)
    w = raw_patches[:, 3:3 + orb_ops.PATCH, 3:3 + orb_ops.PATCH] * mask
    return _row_ordered_sum(w * xs), _row_ordered_sum(w * ys)


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """Rotation bin per keypoint: round_half_even(angle * RCP_BIN) mod 30."""
    return torch.remainder(torch.round(angle * RCP_BIN).to(torch.int64), orb_ops.N_ANGLE_BINS)


def describe_plain(canvas: torch.Tensor, blurred: torch.Tensor, uv_lv: torch.Tensor,
                   level: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """IC angle [N] f32 from canvas[level] and packed rBRIEF [N, 32] uint8
    from blurred[level], around round(uv_lv)."""
    m10, m01 = ic_moments(orb_ops.extract_patches(canvas, uv_lv, level=level))
    angle = torch.atan2(m01, m10)
    flat = orb_ops.extract_patches(blurred, uv_lv, level=level).reshape(uv_lv.shape[0], -1)
    taps = orb_ops._tables_on(canvas.device)[3][angle_bins(angle)]       # [N, 512]
    V = torch.gather(flat, 1, taps)
    return angle, orb_ops.pack_bits(V[:, 0::2] < V[:, 1::2])


# ----------------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------------

def gaussian_blur7(canvas: torch.Tensor) -> torch.Tensor:
    """The 7-tap sigma-2 Gaussian blur of an [L, H, W] f32 canvas (numpy
    "reflect" at its edges; H, W >= 4). One launch on the card."""
    name = "gaussian_blur7"
    if not _device(name, canvas):
        return image_ops.gaussian_blur(canvas, 7, 2.0)
    L, H, W = canvas.shape
    cuda_build.check(name, "canvas", canvas, torch.float32, (L, H, W), canvas.device)
    if H < 4 or W < 4:
        raise ValueError(f"{name}: a {H} x {W} canvas is too small to reflect 3 px")
    lib = cuda_build.load(LIB, _declare)
    out = torch.empty_like(canvas)
    cuda_build.launch(name, canvas.device, lib.gaussian_blur7_launch, canvas.data_ptr(),
                      out.data_ptr(), L, H, W, _floats(BLUR_TAPS))
    gaussian_blur7.launches += 1
    return out


def orb_fast_cells(canvas: torch.Tensor, shapes, th_hi: float, th_lo: float):
    """Every level's per-cell top-2 candidates (fast_cells_plain's outputs)
    from the [L, H, W] f32 canvas whose level l fills (h_l, w_l) = shapes[l].
    One launch on the card, all levels."""
    name = "orb_fast_cells"
    if not _device(name, canvas):
        return fast_cells_plain(canvas, shapes, th_hi, th_lo)
    L, H, W = canvas.shape
    cuda_build.check(name, "canvas", canvas, torch.float32, (L, H, W), canvas.device)
    _check_levels(name, shapes, H, W)
    if len(shapes) > L:
        raise ValueError(f"{name}: {len(shapes)} levels on a canvas of {L}")
    lib = cuda_build.load(LIB, _declare)
    C = sum(n_candidates(shapes))
    scores = torch.empty(C, dtype=torch.float32, device=canvas.device)
    uv = torch.empty(C, 2, dtype=torch.float32, device=canvas.device)
    cuda_build.launch(name, canvas.device, lib.orb_fast_cells_launch, canvas.data_ptr(), H, W,
                      len(shapes), _ints([h for h, _ in shapes]), _ints([w for _, w in shapes]),
                      float(th_hi), float(th_lo), scores.data_ptr(), uv.data_ptr())
    orb_fast_cells.launches += 1
    return scores, uv


def orb_quota_select(scores: torch.Tensor, cand_uv: torch.Tensor, shapes, quotas, scale: float):
    """Each level's quota of candidates (quota_select_plain's outputs). One
    launch on the card, a level per block; at most MAX_CAND candidates a
    level there."""
    name = "orb_quota_select"
    counts = n_candidates(shapes)
    for lv, (n, k) in enumerate(zip(counts, quotas)):
        if k > 0 and n == 0:
            raise ValueError(f"{name}: level {lv} has no {CELL} x {CELL} cell for its quota {k}")
    if not _device(name, scores):
        return quota_select_plain(scores, cand_uv, shapes, quotas, scale)
    dev, C, N = scores.device, sum(counts), sum(quotas)
    cuda_build.check(name, "scores", scores, torch.float32, (C,), dev)
    cuda_build.check(name, "cand_uv", cand_uv, torch.float32, (C, 2), dev)
    if not 1 <= len(shapes) <= MAX_LEVELS or len(quotas) != len(shapes) or min(quotas) < 0:
        raise ValueError(f"{name}: {len(shapes)} levels and quotas {list(quotas)}")
    if max(counts) > MAX_CAND:
        raise ValueError(f"{name}: {max(counts)} candidates in one level; the kernel sorts at "
                         f"most {MAX_CAND} (a level of about {MAX_CAND // 2 * CELL * CELL} px)")
    lib = cuda_build.load(LIB, _declare)
    response = torch.empty(N, dtype=torch.float32, device=dev)
    uv_lv = torch.empty(N, 2, dtype=torch.float32, device=dev)
    uv = torch.empty(N, 2, dtype=torch.float32, device=dev)
    level = torch.empty(N, dtype=torch.int32, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    cuda_build.launch(name, dev, lib.orb_quota_select_launch, scores.data_ptr(),
                      cand_uv.data_ptr(), len(shapes), _ints([h for h, _ in shapes]),
                      _ints([w for _, w in shapes]), _ints(list(quotas)),
                      _floats(level_scales(len(shapes), scale)), response.data_ptr(),
                      uv_lv.data_ptr(), uv.data_ptr(), level.data_ptr(), valid.data_ptr())
    orb_quota_select.launches += 1
    return response, uv_lv, uv, level, valid


@functools.lru_cache(maxsize=None)
def _taps_i32_on(device: torch.device) -> torch.Tensor:
    """The rotated pattern's [30, 512] flat tap indices as int32 on `device`,
    uploaded once (an upload per call would wait for the card). Read-only."""
    return torch.from_numpy(orb_ops._BIN_TAPS.astype(np.int32)).to(device)


def orb_describe(canvas: torch.Tensor, blurred: torch.Tensor, uv_lv: torch.Tensor,
             level: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """IC angle [N] f32 and packed rBRIEF [N, 32] uint8 of the keypoints at
    level coordinates uv_lv [N, 2] f32 on levels level [N] int32 of the raw
    and blurred [L, H, W] canvases. One launch on the card, a warp a
    keypoint."""
    name = "orb_describe"
    if not _device(name, canvas):
        return describe_plain(canvas, blurred, uv_lv, level)
    dev = canvas.device
    L, H, W = canvas.shape
    N = uv_lv.shape[0]
    cuda_build.check(name, "canvas", canvas, torch.float32, (L, H, W), dev)
    cuda_build.check(name, "blurred", blurred, torch.float32, (L, H, W), dev)
    cuda_build.check(name, "uv_lv", uv_lv, torch.float32, (N, 2), dev)
    cuda_build.check(name, "level", level, torch.int32, (N,), dev)
    lib = cuda_build.load(LIB, _declare)
    angle = torch.empty(N, dtype=torch.float32, device=dev)
    desc = torch.empty(N, 32, dtype=torch.uint8, device=dev)
    cuda_build.launch(name, dev, lib.orb_describe_launch, canvas.data_ptr(), blurred.data_ptr(),
                      H, W, uv_lv.data_ptr(), level.data_ptr(), N, _taps_i32_on(dev).data_ptr(),
                      RCP_BIN, angle.data_ptr(), desc.data_ptr())
    orb_describe.launches += 1
    return angle, desc


def angle_bins_on_card(m10: torch.Tensor, m01: torch.Tensor,
                       angle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """orb_describe's own atan2f of (m01, m10) and bin of `angle` ([n] f32
    CUDA tensors each), for the tests: (atan2 [n] f32, bins [n] int32). Its
    twin is (torch.atan2(m01, m10), angle_bins(angle)). Not counted."""
    name, dev, n = "orb_angle_bins", angle.device, angle.shape[0]
    for what, t in (("m10", m10), ("m01", m01), ("angle", angle)):
        cuda_build.check(name, what, t, torch.float32, (n,), dev)
    lib = cuda_build.load(LIB, _declare)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    bins = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_build.launch(name, dev, lib.orb_angle_bins_launch, m10.data_ptr(), m01.data_ptr(),
                      angle.data_ptr(), n, RCP_BIN, out.data_ptr(), bins.data_ptr())
    return out, bins


gaussian_blur7.launches = orb_fast_cells.launches = orb_quota_select.launches = 0
orb_describe.launches = 0
WRAPPERS = (orb_fast_cells, orb_quota_select, gaussian_blur7, orb_describe)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
