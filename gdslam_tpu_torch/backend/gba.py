"""Keyframe culling (port of gdslam_tpu.backend.gba's `keyframe_culling`).

`global_bundle_adjustment`, the other function of the JAX module, is
driven by loop closing and comes with that slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from gdslam_tpu_torch.backend import map_arena as ma


def keyframe_culling(arena: ma.MapArena, protect_last: int = 2) -> ma.MapArena:
    """Discard keyframes with >= 90% redundant observations
    (LocalMapping::KeyFrameCulling semantics). The last `protect_last`
    keyframes and keyframe 0 are never culled."""
    obs = arena.kf_obs
    has = obs >= 0
    redundant = has & (arena.pt_n_obs[obs.clamp(min=0).long()] >= 4)
    frac = redundant.sum(dim=1) / has.sum(dim=1).clamp(min=1)
    ids = torch.arange(arena.kmax, device=obs.device)
    cullable = arena.kf_valid & (frac > 0.9) & (ids != 0) & (ids < arena.n_kf - protect_last)
    # decrement observation counts of culled keyframes' points
    gone = cullable[:, None] & has
    dec = torch.zeros(arena.pmax, dtype=torch.int32, device=obs.device).index_add(
        0, torch.where(gone, obs, 0).reshape(-1).long(), gone.reshape(-1).to(torch.int32))
    return arena._replace(
        kf_valid=arena.kf_valid & ~cullable,
        kf_obs=torch.where(cullable[:, None], -1, arena.kf_obs),
        pt_n_obs=(arena.pt_n_obs - dec).clamp(min=0),
    )
