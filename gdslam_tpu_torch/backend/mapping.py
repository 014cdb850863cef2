"""LocalMapping point upkeep (port of gdslam_tpu.backend.mapping).

Only `refresh_points` is ported: MapPoint::ComputeDistinctiveDescriptors
(MapPoint.cc:242-308, median-Hamming best descriptor) and
UpdateNormalAndDepth (MapPoint.cc:330-371) over a sliding window of recent
keyframes plus each point's reference keyframe, run once per keyframe
insertion for every point the new keyframe observes. Epipolar
triangulation and duplicate fusion come with the keyframe program's next
slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.ops import hamming


def refresh_points(arena: ma.MapArena, kf_id: int, cfg: SlamConfig,
                   window: int = 8) -> ma.MapArena:
    """Recompute distinctive descriptors + normals/depth ranges for every
    point the keyframe `kf_id` observes, from its observations in the last
    `window` keyframes plus its reference (birth) keyframe.

    Scatters write only the rows they mean to: where one point is observed
    by two keypoints of a keyframe, the later keypoint wins, as in the JAX
    package's serial scatter on the CPU."""
    dev = arena.kf_obs.device
    N, W, P, K = arena.n_features, window, arena.pmax, arena.kmax
    base = max(kf_id - W + 1, 0)
    rows = base + torch.arange(W, device=dev)
    rows_c = rows.clamp(max=K - 1)                  # the JAX gather clamps
    row_ok = (rows <= kf_id) & arena.kf_valid[rows_c]

    touched = arena.kf_obs[kf_id]
    t_ok = touched >= 0
    t_idx = torch.where(t_ok, touched, P - 1).long()

    # Inverse map: for each window keyframe, point id -> keypoint index.
    obs_w = arena.kf_obs[rows_c]                                     # [W, N]
    kp_iota = torch.arange(N, device=dev).expand(W, N)
    inv = torch.full((W, P + 1), -1, dtype=torch.int64, device=dev)
    inv = inv.scatter_reduce(1, torch.where(obs_w >= 0, obs_w, P).long(),
                             torch.where(obs_w >= 0, kp_iota, -1), "amax")
    # Column 0 as the JAX package computes it (gdslam_tpu/backend/mapping.py:
    # 272-276): its scatter sends every unobserved keypoint to point id 0 with
    # the value -1 and XLA on the CPU applies duplicates in row order, so
    # inv[w, 0] is the keypoint of the last row that is unobserved or observes
    # point 0, if that row observes point 0, else -1. (For every other column
    # "last wins" equals amax: the values are the row indices themselves.)
    last0 = torch.where(obs_w <= 0, kp_iota, -1).amax(dim=1)         # [W]
    last0_obs = obs_w.gather(1, last0.clamp(min=0)[:, None])[:, 0]
    inv[:, 0] = torch.where((last0 >= 0) & (last0_obs == 0), last0, -1)

    kp_in_w = inv[:, t_idx]                                          # [W, N]
    has = (kp_in_w >= 0) & row_ok[:, None] & t_ok[None, :]
    cand = arena.kf_desc[rows_c[:, None], kp_in_w.clamp(min=0)]      # [W, N, 32]
    cand_n = cand.permute(1, 0, 2)                                   # [N, W, 32]

    # Extra candidate: the point's reference-keyframe (birth) observation,
    # skipped when that keyframe already sits inside the recency window.
    ref_kf = arena.pt_ref_kf[t_idx]
    ref_rows = ref_kf.clamp(0, K - 1).long()
    eq = arena.kf_obs[ref_rows] == t_idx[:, None]                    # [N, N]
    ref_kp = torch.argmax(eq.to(torch.int32), dim=1)                 # first match
    ref_has = eq.any(dim=1) & t_ok & (ref_kf >= 0) & arena.kf_valid[ref_rows] & \
        ~((ref_rows >= base) & (ref_rows <= kf_id))
    ref_desc = arena.kf_desc[ref_rows, ref_kp]                       # [N, 32]
    cand_n = torch.cat([cand_n, ref_desc[:, None, :]], dim=1)        # [N, W+1, 32]
    ham = hamming.hamming_packed(cand_n[:, :, None, :], cand_n[:, None, :, :])
    has_n = torch.cat([has.T, ref_has[:, None]], dim=1)              # [N, W+1]
    pair_ok = has_n[:, :, None] & has_n[:, None, :]
    # median distance per candidate: sort with invalid -> +inf, take the
    # element at (count-1)//2 like the reference's vDists[0.5*(N-1)]
    hmask = torch.where(pair_ok, ham.float(), float("inf"))
    hsort = torch.sort(hmask, dim=2).values
    cnt = pair_ok.sum(dim=2)
    med_idx = ((cnt - 1) // 2).clamp(min=0)
    med = torch.gather(hsort, 2, med_idx[..., None])[..., 0]
    med = torch.where(has_n, med, float("inf"))
    best_w = torch.argmin(med, dim=1)                                # first among ties
    n_cand = has_n.sum(dim=1)
    ar = torch.arange(N, device=dev)
    new_desc = cand_n[ar, best_w]
    upd = t_ok & (n_cand >= 2) & torch.isfinite(med[ar, best_w])

    # Normals: mean unit ray over the window's observing centers.
    Tw = arena.kf_pose[rows_c]
    centers = -torch.einsum("wij,wi->wj", Tw[:, :3, :3], Tw[:, :3, 3])  # [W, 3]
    pos = arena.pt_pos[t_idx]
    rays = pos[None, :, :] - centers[:, None, :]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=2, keepdim=True), min=1e-9)
    rays = torch.where(has[..., None], rays, 0.0)
    nsum = rays.sum(dim=0)
    T_ref = arena.kf_pose[ref_rows]
    c_ref = -torch.einsum("nij,ni->nj", T_ref[:, :3, :3], T_ref[:, :3, 3])
    r_ref = pos - c_ref
    r_ref = r_ref / torch.clamp(torch.linalg.norm(r_ref, dim=1, keepdim=True), min=1e-9)
    nsum = nsum + torch.where(ref_has[:, None], r_ref, 0.0)
    new_normal = nsum / torch.clamp(torch.linalg.norm(nsum, dim=1, keepdim=True), min=1e-9)

    # Depth range from the newest observation (kf_id itself).
    T_new = arena.kf_pose[kf_id]
    o_new = -T_new[:3, :3].T @ T_new[:3, 3]
    dist = torch.linalg.norm(pos - o_new[None], dim=1)
    sf = float(cfg.orb.scale_factor)
    max_d = dist * sf ** arena.kf_level[kf_id].float()
    min_d = max_d / (sf ** (cfg.orb.n_levels - 1))

    write = ma.last_wins(t_idx, upd, P)
    return arena._replace(
        pt_desc=ma.scatter_rows(arena.pt_desc, t_idx, new_desc, write),
        pt_normal=ma.scatter_rows(arena.pt_normal, t_idx, new_normal, write),
        pt_min_dist=ma.scatter_rows(arena.pt_min_dist, t_idx, min_d, write),
        pt_max_dist=ma.scatter_rows(arena.pt_max_dist, t_idx, max_d, write),
    )
