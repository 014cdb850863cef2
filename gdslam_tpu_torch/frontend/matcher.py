"""Projection-guided descriptor matching (port of
gdslam_tpu.frontend.matcher).

Replaces ORBmatcher's grid-windowed searches (reference ORBmatcher.cc:
SearchByProjection :45, motion model :1328) with the fused kernel
`ops.match_kernel.match_top2`: per keypoint, the best candidate row subject
to radius / level / validity gates, the second best for the ratio test, and
per candidate row the best cost for the one-to-one rule. Rotation
consistency is a small torch pass on the result.

Descriptors are packed [*, 32] uint8 here (the JAX function takes the
+-1 int8 form); the costs are the same for valid rows.

Thresholds follow ORBmatcher.cc:37-39: TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.ops.match_kernel import BIG, match_top2

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30


class MatchResult(NamedTuple):
    point_idx: torch.Tensor   # [N] int32 candidate row matched per keypoint (-1)
    distance: torch.Tensor    # [N] int32 Hamming distance (valid rows only)
    n_matches: torch.Tensor   # scalar


def rotation_consistency(dangle: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram bins (ORBmatcher::ComputeThreeMaxima, cc:1601)."""
    frac = torch.remainder(dangle, 2 * math.pi) / (2 * math.pi)
    bins = torch.clamp((frac * HISTO_LENGTH).to(torch.int64), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=dangle.device)
    hist = hist.scatter_add(0, bins, matched.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    keep_bin = (hist >= top3[2]) & (hist.float() > 0.1 * top3[0].float())
    return matched & keep_bin[bins]


def match_candidates(cand_uv: torch.Tensor, cand_valid: torch.Tensor,
                     cand_desc: torch.Tensor, cand_level: torch.Tensor,
                     cand_angle: torch.Tensor, cand_radius: torch.Tensor,
                     kp_uv: torch.Tensor, kp_valid: torch.Tensor,
                     kp_desc: torch.Tensor, kp_level: torch.Tensor,
                     kp_angle: torch.Tensor,
                     th_hamming: int = TH_HIGH, level_slack: int = 1,
                     use_rotation: bool = True,
                     nn_ratio: float = 1.0) -> MatchResult:
    """Per-keypoint best candidate row subject to radius/level/Hamming
    gates, with one-to-one enforcement (each candidate row keeps only its
    best keypoint). cand_*: M projected candidates; kp_*: N keypoints."""
    best, second, arg, best_cand = match_top2(
        cand_uv.contiguous(), cand_desc.contiguous(), cand_radius.contiguous(),
        cand_level.to(torch.int32).contiguous(), cand_valid.contiguous(),
        kp_uv.contiguous(), kp_desc.contiguous(), kp_level.to(torch.int32).contiguous(),
        kp_valid.contiguous(), level_slack)
    good = best <= th_hamming
    if nn_ratio < 1.0:
        good = good & (best.float() < nn_ratio * torch.clamp(second, max=BIG).float())
    # a keypoint with no candidate has best == BIG and is not good; row 0
    # stands in for its index below
    arg_safe = arg.clamp(min=0).long()
    good = good & (best <= best_cand[arg_safe])
    if use_rotation:
        good = good & rotation_consistency(kp_angle - cand_angle[arg_safe], good)
    return MatchResult(point_idx=torch.where(good, arg, -1).to(torch.int32),
                       distance=torch.where(good, best, BIG).to(torch.int32),
                       n_matches=good.sum())


def project_for_search(pt_pos: torch.Tensor, pt_valid: torch.Tensor,
                       T_cw: torch.Tensor, K: tuple, image_wh: tuple,
                       scale_factors: torch.Tensor,
                       pt_max_dist: torch.Tensor | None = None,
                       pt_normal: torch.Tensor | None = None,
                       base_radius: float = 4.0):
    """Project world points and derive search windows (Frame::isInFrustum,
    Frame.cc:441-497; MapPoint::PredictScale; RadiusByViewingCos).
    Returns (uv [M,2], level [M] int32, radius [M], valid [M])."""
    fx, fy, cx, cy = K
    W, H = image_wh
    Xc = lie.se3_apply(T_cw, pt_pos)
    z = Xc[:, 2]
    z_ok = z > 1e-6
    zs = torch.where(z_ok, z, 1.0)
    u = fx * Xc[:, 0] / zs + cx
    v = fy * Xc[:, 1] / zs + cy
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    valid = pt_valid & z_ok & in_img

    n_levels = scale_factors.shape[0]
    if pt_max_dist is not None:
        Rcw = T_cw[:3, :3]
        ow = -Rcw.T @ T_cw[:3, 3]
        po = pt_pos - ow
        dist = torch.linalg.norm(po, dim=1)
        valid = valid & (dist >= 0.8 * pt_max_dist / scale_factors[-1]) \
                      & (dist <= 1.2 * pt_max_dist)
        ratio = pt_max_dist / torch.clamp(dist, min=1e-6)
        level = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-6))
                                       / torch.log(scale_factors[1])),
                            0, n_levels - 1).to(torch.int32)
        if pt_normal is not None:
            view_cos = torch.einsum("ni,ni->n", po, pt_normal) / torch.clamp(dist, min=1e-6)
            valid = valid & (view_cos > 0.5)
            radius_factor = torch.where(view_cos > 0.998, 2.5, 4.0)
        else:
            radius_factor = torch.full_like(dist, 4.0)
    else:
        level = torch.zeros(pt_pos.shape[0], dtype=torch.int32, device=pt_pos.device)
        radius_factor = torch.full((pt_pos.shape[0],), base_radius, device=pt_pos.device)

    radius = radius_factor * scale_factors[level.long()] * (base_radius / 4.0)
    return torch.stack([u, v], 1), level, radius, valid
