"""ORB feature extractor: pyramid -> FAST -> distribution -> angle -> rBRIEF
(port of gdslam_tpu.frontend.extractor).

Dense FAST score maps (threshold 20, per-cell fallback 7), 3x3 NMS,
per-16-px-cell top-2 and per-level top-quota selection stand in for the
reference's DistributeOctTree (ORBextractor.cc:539-853). The output is a
fixed-size padded `Features` (N = n_features, invalid entries masked).

Tie order: `lax.top_k` keeps the lower index among equal scores, and the
selection order decides which keypoint lands in which row. `torch.topk`
promises no order, so selection is a stable descending sort, sliced.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gdslam_tpu_torch.config import OrbConfig
from gdslam_tpu_torch.ops import fast as fast_ops
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops import orb as orb_ops

EDGE_MARGIN = 16      # reference detects within minBorder=19-3 (ORBextractor.cc:774)
CELL = 16             # candidate cell size (px), top-2 kept per cell


class Features(NamedTuple):
    """Fixed-size padded feature set for one image."""

    uv: torch.Tensor        # [N, 2] float32, level-0 pixel coords (distorted)
    response: torch.Tensor  # [N] float32 FAST score (0 => invalid)
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int32 pyramid octave
    desc: torch.Tensor      # [N, 32] uint8 packed rBRIEF
    valid: torch.Tensor     # [N] bool


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, lower index first among ties (the
    order `lax.top_k` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    vals, idx = top_k_stable(cells, 2)                    # [Hc, Wc, 2]
    in_y = idx // CELL
    in_x = idx % CELL
    cy = torch.arange(Hc, device=dev)[:, None, None]
    cx = torch.arange(Wc, device=dev)[None, :, None]
    u = (cx * CELL + in_x).reshape(-1).float()
    v = (cy * CELL + in_y).reshape(-1).float()
    return vals.reshape(-1), torch.stack([u, v], dim=-1)


def _level_score(img_lv: torch.Tensor, h: int, w: int, cfg: OrbConfig) -> torch.Tensor:
    """One threshold-free FAST pass per level, then the high threshold with
    the per-cell low-threshold fallback (ORBextractor.cc:809-815)."""
    strength = fast_ops.fast_strength(img_lv)
    s_hi = fast_ops.nms3x3(torch.where(strength > float(cfg.ini_th_fast), strength, 0.0))
    s_lo = fast_ops.nms3x3(torch.where(strength > float(cfg.min_th_fast), strength, 0.0))
    Hc, Wc = h // CELL, w // CELL
    hi_cells = s_hi[:Hc * CELL, :Wc * CELL].reshape(Hc, CELL, Wc, CELL).amax(dim=(1, 3))
    has_hi = (hi_cells > 0).repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)
    has_hi = torch.nn.functional.pad(has_hi, (0, w - Wc * CELL, 0, h - Hc * CELL))
    return torch.where(has_hi, s_hi, s_lo)


def extract(img: torch.Tensor, cfg: OrbConfig, height: int, width: int) -> Features:
    """Run the full ORB pipeline on a grayscale image [H, W] float32.

    f32 throughout: reduced-precision pyramids flip BRIEF bits (the JAX
    package measured a >10x ATE loss from bf16)."""
    canvas, shapes = image_ops.build_pyramid(img, height, width, cfg.n_levels,
                                             cfg.scale_factor)
    blurred = image_ops.gaussian_blur(canvas, 7, 2.0)
    quotas = orb_ops.feature_quotas(cfg.n_features, cfg.n_levels, cfg.scale_factor)

    all_uv, all_resp, all_ang, all_lvl, all_desc = [], [], [], [], []
    for lv in range(cfg.n_levels):
        h, w = shapes[lv]
        score_lv = _level_score(canvas[lv, :h, :w], h, w, cfg)
        cand_s, cand_uv = _level_candidates(score_lv, h, w)
        k = quotas[lv]
        k_eff = min(k, cand_s.shape[0])   # tiny levels: fewer cells than quota
        top_s, top_i = top_k_stable(cand_s, k_eff)
        if k_eff < k:
            top_s = torch.nn.functional.pad(top_s, (0, k - k_eff))
            top_i = torch.nn.functional.pad(top_i, (0, k - k_eff))
        uv_lv = cand_uv[top_i]                       # [k, 2] level coords
        ang = orb_ops.ic_angle_from_patches(orb_ops.extract_patches(canvas[lv], uv_lv))
        desc = orb_ops.brief_from_patches(orb_ops.extract_patches(blurred[lv], uv_lv), ang)
        sc = float(cfg.scale_factor) ** lv
        all_uv.append(uv_lv * sc)
        all_resp.append(top_s)
        all_ang.append(ang)
        all_lvl.append(torch.full((k,), lv, dtype=torch.int32, device=img.device))
        all_desc.append(desc)

    resp = torch.cat(all_resp)
    return Features(uv=torch.cat(all_uv, 0), response=resp, angle=torch.cat(all_ang),
                    level=torch.cat(all_lvl), desc=torch.cat(all_desc, 0),
                    valid=resp > 0)


@functools.lru_cache(maxsize=None)
def scale_factors(cfg: OrbConfig, device=None) -> torch.Tensor:
    """[n_levels] scale per pyramid level on `device`, uploaded once per
    configuration (a host list sent to the card is a blocking copy, which
    waits for the card on every use). Read-only."""
    return torch.tensor([cfg.scale_factor ** i for i in range(cfg.n_levels)],
                        dtype=torch.float32, device=device)
