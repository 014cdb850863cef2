"""ORB feature extractor: pyramid -> FAST -> distribution -> angle -> rBRIEF
(port of gdslam_tpu.frontend.extractor).

Dense FAST score maps (threshold 20, per-cell fallback 7), 3x3 NMS,
per-16-px-cell top-2 and per-level top-quota selection stand in for the
reference's DistributeOctTree (ORBextractor.cc:539-853). The output is a
fixed-size padded `Features` (N = n_features, invalid entries masked).

After the pyramid (two matrix products a level), the work is four kernels
of `ops/orb_kernel.py` on the card, their plain twins on the CPU: the blur,
the FAST cells of every level, the per-level quota and the angle and
descriptors. Nothing is read back from the card.

Tie order: `lax.top_k` keeps the lower index among equal scores, and the
selection order decides which keypoint lands in which row. `torch.topk`
promises no order, so selection is a stable descending sort, sliced.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gdslam_tpu_torch.config import OrbConfig
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops import orb as orb_ops
from gdslam_tpu_torch.ops import orb_kernel


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


def extract(img: torch.Tensor, cfg: OrbConfig, height: int, width: int) -> Features:
    """Run the full ORB pipeline on a grayscale image [H, W] float32.

    f32 throughout: reduced-precision pyramids flip BRIEF bits (the JAX
    package measured a >10x ATE loss from bf16)."""
    canvas, shapes = image_ops.build_pyramid(img, height, width, cfg.n_levels,
                                             cfg.scale_factor)
    blurred = orb_kernel.gaussian_blur7(canvas, shapes)
    quotas = orb_ops.feature_quotas(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    cand_s, cand_uv = orb_kernel.orb_fast_cells(canvas, shapes, cfg.ini_th_fast,
                                                cfg.min_th_fast)
    resp, uv_lv, uv, level, valid = orb_kernel.orb_quota_select(cand_s, cand_uv, shapes, quotas,
                                                                cfg.scale_factor)
    angle, desc = orb_kernel.orb_describe(canvas, blurred, uv_lv, level)
    return Features(uv=uv, response=resp, angle=angle, level=level, desc=desc, valid=valid)


@functools.lru_cache(maxsize=None)
def scale_factors(cfg: OrbConfig, device=None) -> torch.Tensor:
    """[n_levels] scale per pyramid level on `device`, uploaded once per
    configuration (a host list sent to the card is a blocking copy, which
    waits for the card on every use). Read-only."""
    return torch.tensor([cfg.scale_factor ** i for i in range(cfg.n_levels)],
                        dtype=torch.float32, device=device)
