"""LocalMapping map-growth duties: epipolar triangulation + point upkeep
(port of gdslam_tpu.backend.mapping).

- `create_new_map_points`: CreateNewMapPoints (LocalMapping.cc:207-453):
  triangulate unassociated keypoints of the new keyframe against its best
  covisible neighbours. The per-pair search (SearchForTriangulation +
  epipolar check, ORBmatcher.cc:657, 140) is one dense [N, N] Hamming matrix
  masked by the epipolar-line distance gate; the triangulation is the
  closed-form two-ray midpoint; the parallax / cheirality / reprojection /
  scale-consistency gates (LocalMapping.cc:330-430) are boolean masks.
- `refresh_points`: MapPoint::ComputeDistinctiveDescriptors
  (MapPoint.cc:242-308, median-Hamming best descriptor) and
  UpdateNormalAndDepth (MapPoint.cc:330-371) over a sliding window of recent
  keyframes plus each point's reference keyframe, run once per keyframe
  insertion for every point the new keyframe observes.
- `fuse_into_keyframe` / `replace_points`: ORBmatcher::Fuse duplicate
  detection (ORBmatcher.cc:825-977) with MapPoint::Replace (MapPoint.cc:177):
  when one keypoint is claimed by two map points, the point with fewer
  observations is merged into the other through a redirect table over kf_obs.

Where the JAX functions scatter with duplicate indices (a dump slot that is
also a live slot), the port writes the result of XLA's serial scatter on
the CPU through `map_arena.last_writer`, so it has no scatter order to rely
on (see ROADMAP.md section 3).
"""

from __future__ import annotations

import functools

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import camera as cam_ops
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend import extractor, matcher
from gdslam_tpu_torch.ops import hamming

BIG = 1 << 20
TH_LOW = 50


@functools.lru_cache(maxsize=None)
def _Kinv_on(fx: float, fy: float, cx: float, cy: float, device: torch.device) -> torch.Tensor:
    """The inverse intrinsic matrix on `device`, inverted on the host and
    uploaded once per camera (an upload waits for the card). Read-only."""
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32)
    return torch.linalg.inv(K).to(device)


def _nanmedian(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median of x[ok] as jnp.nanmedian gives it: the mean of the two
    middle values for an even count (torch.nanmedian takes the lower), NaN
    for none."""
    s = torch.sort(torch.where(ok, x, float("inf"))).values
    n = ok.sum()
    lo = ma.row(s, ((n - 1) // 2).clamp(min=0))
    hi = ma.row(s, (n // 2).clamp(max=x.shape[0] - 1))
    return torch.where(n > 0, lo * 0.5 + hi * 0.5, float("nan"))


def create_new_map_points(arena: ma.MapArena, kf_id: int, cfg: SlamConfig,
                          n_neighbors: int = 10) -> ma.MapArena:
    """Triangulate new map points for keyframe `kf_id` against its
    `n_neighbors` best covisible keyframes (LocalMapping.cc:207-453).

    Eligible keypoints: valid, unassociated, and without reliable depth
    (close-depth keypoints already became points at insertion). The
    neighbours and the point cursor stay on the device: nothing is read on
    the host."""
    cam = cfg.camera
    dev = arena.kf_pose.device
    Kinv = _Kinv_on(cam.fx, cam.fy, cam.cx, cam.cy, dev)
    sf = float(cfg.orb.scale_factor)
    n_levels = cfg.orb.n_levels
    N, P = arena.n_features, arena.pmax
    ratio_factor = 1.5 * sf

    n_neighbors = min(n_neighbors, arena.kmax - 1)
    # Neighbour selection: best covisible keyframes; the temporal predecessor
    # always participates (a freshly-split map can have zero covisibility
    # while still sharing a view).
    w = arena.covis[kf_id].clone()
    w[max(kf_id - 1, 0)].add_(1)
    w = torch.where(arena.kf_valid, w, -1)
    w[kf_id].fill_(-1)
    top_w, nb_ids = extractor.top_k_stable(w, n_neighbors)
    nb_ok = (top_w > 0) & (nb_ids < arena.n_kf)

    T1 = arena.kf_pose[kf_id]
    R1, t1 = T1[:3, :3], T1[:3, 3]
    o1 = -R1.T @ t1
    uv1 = arena.kf_uv[kf_id]
    lvl1 = arena.kf_level[kf_id]
    desc1 = arena.kf_desc[kf_id]
    th_depth_m = cam.bf * cam.th_depth / cam.fx
    sigma2_1 = sf ** (2.0 * lvl1.float())
    ones = torch.ones((N, 1), device=dev)
    x1h = torch.cat([uv1, ones], dim=1)                               # [N, 3]
    r1d = torch.einsum("ji,nj->ni", R1, torch.einsum("ij,nj->ni", Kinv, x1h))
    depth1 = arena.kf_depth[kf_id]
    has_depth = (depth1 > 0).any()
    far1 = arena.kf_kp_valid[kf_id] & ((depth1 <= 0) | (depth1 > th_depth_m))
    all_rows = torch.ones(N, dtype=torch.bool, device=dev)

    for k in range(n_neighbors):
        nb_id, ok = nb_ids[k], nb_ok[k]
        obs1 = arena.kf_obs[kf_id]
        free1 = far1 & (obs1 < 0)
        T2 = ma.row(arena.kf_pose, nb_id)
        R2, t2 = T2[:3, :3], T2[:3, 3]
        o2 = -R2.T @ t2
        uv2 = ma.row(arena.kf_uv, nb_id)
        lvl2 = ma.row(arena.kf_level, nb_id)
        depth2 = ma.row(arena.kf_depth, nb_id)
        obs2 = ma.row(arena.kf_obs, nb_id)
        free2 = ma.row(arena.kf_kp_valid, nb_id) & (obs2 < 0) & \
            ((depth2 <= 0) | (depth2 > th_depth_m))
        # Baseline gate (LocalMapping.cc:246-268): metric for RGB-D/stereo;
        # for frames without depth, baseline / median scene depth >= 0.01.
        baseline = torch.linalg.norm(o2 - o1)
        rows2 = obs2.clamp(min=0).long()
        has2 = (obs2 >= 0) & arena.pt_valid[rows2]
        z2 = lie.se3_apply(T2, arena.pt_pos[rows2])[:, 2]
        med2 = _nanmedian(z2, has2)
        med2 = torch.where(torch.isfinite(med2), med2, 1.0)
        ok = ok & torch.where(has_depth, baseline > cam.bf / cam.fx,
                              baseline / med2.clamp(min=1e-6) >= 0.01)

        # Fundamental matrix F12 = K^-T [t12]x R12 K^-1 (ComputeF12,
        # LocalMapping.cc:573-588).
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        F12 = Kinv.T @ lie.hat(t12) @ R12 @ Kinv

        # Epipolar line of kp1 in image 2: l2 = F12^T x1.
        l2 = x1h @ F12                                                # [N, 3]
        num = l2[:, None, 0] * uv2[None, :, 0] + l2[:, None, 1] * uv2[None, :, 1] + \
            l2[:, None, 2]
        den = l2[:, 0] ** 2 + l2[:, 1] ** 2
        dsq = (num * num) / den[:, None].clamp(min=1e-12)
        sigma2_2 = sf ** (2.0 * lvl2.float())
        epi_ok = dsq < 3.84 * sigma2_2[None, :]       # CheckDistEpipolarLine

        ham = hamming.hamming_matrix(desc1, ma.row(arena.kf_desc, nb_id))
        cost = torch.where(epi_ok & free1[:, None] & free2[None, :], ham, BIG)
        best, _, arg = hamming.best_two(cost, dim=1)                  # per kp1
        matched = best <= TH_LOW
        # one-to-one: kp2 keeps only its best kp1 (equal costs all pass)
        best_col = cost.amin(dim=0)
        matched = matched & (best <= best_col[arg.long()])

        i2 = torch.where(matched, arg, 0).long()
        # Triangulate: the midpoint of the two rays' common perpendicular
        # (closed form); the parallax / reprojection gates below reject the
        # cases where it differs from the reference's SVD DLT.
        uv2m = uv2[i2]
        r2d = torch.einsum("ji,nj->ni", R2,
                           torch.einsum("ij,nj->ni", Kinv, torch.cat([uv2m, ones], dim=1)))
        # solve [d1.d1  -d1.d2; d1.d2  -d2.d2] [s;t] = [d1.(o2-o1); d2.(o2-o1)]
        d11 = torch.sum(r1d * r1d, dim=1)
        d22 = torch.sum(r2d * r2d, dim=1)
        d12 = torch.sum(r1d * r2d, dim=1)
        b_vec = o2 - o1
        b1 = r1d @ b_vec
        b2 = r2d @ b_vec
        den = d11 * d22 - d12 * d12
        den = torch.where(den.abs() > 1e-12, den, 1e-12)
        s_par = (b1 * d22 - b2 * d12) / den
        t_par = (b1 * d12 - b2 * d11) / den
        Xw = 0.5 * ((o1 + s_par[:, None] * r1d) + (o2 + t_par[:, None] * r2d))
        # Parallax gate: rays must subtend a usable angle.
        r1 = Xw - o1
        r2 = Xw - o2
        d1 = torch.linalg.norm(r1, dim=1)
        d2 = torch.linalg.norm(r2, dim=1)
        cos_par = torch.sum(r1 * r2, dim=1) / (d1 * d2).clamp(min=1e-9)
        par_ok = (cos_par > 0) & (cos_par < 0.9998)
        # Cheirality + reprojection in both views.
        uvp1, z1 = cam_ops.project(lie.se3_apply(T1, Xw), cam)
        uvp2, z2 = cam_ops.project(lie.se3_apply(T2, Xw), cam)
        e1 = torch.sum((uvp1 - uv1) ** 2, dim=1)
        e2 = torch.sum((uvp2 - uv2m) ** 2, dim=1)
        reproj_ok = (z1 > 0) & (z2 > 0) & \
            (e1 < 5.991 * sigma2_1) & (e2 < 5.991 * sigma2_2[i2])
        # Scale consistency (LocalMapping.cc:410-428).
        ratio_dist = d2 / d1.clamp(min=1e-9)
        ratio_oct = sf ** (lvl1 - lvl2[i2]).float()
        scale_ok = (ratio_dist * ratio_factor > ratio_oct) & \
            (ratio_dist < ratio_oct * ratio_factor)

        create = matched & par_ok & reproj_ok & scale_ok & ok
        order = torch.cumsum(create.to(torch.int32), 0) - 1
        create = create & (arena.n_pt + order < P)
        slot = torch.where(create, arena.n_pt + order, 0).to(torch.int32)

        normal = r1 / d1[:, None].clamp(min=1e-9) + r2 / d2[:, None].clamp(min=1e-9)
        normal = normal / torch.linalg.norm(normal, dim=1, keepdim=True).clamp(min=1e-9)
        max_d = d1 * sf ** lvl1.float()
        min_d = max_d / (sf ** (n_levels - 1))

        # Rows that create nothing aim at slot 0 with slot 0's old value
        # (gdslam_tpu/backend/mapping.py:209-211): only the created rows are
        # written, and slot 0 by the serial scatter's rule.
        write = ma.last_writer(slot, create, P)

        def scatter(dst, src):
            return ma.scatter_rows(dst, slot, src, write)

        # The neighbour's row is written at i2, which is keypoint 0 for
        # every unmatched row (:216-217), and two rows of equal cost can
        # name one i2: the last row to name a keypoint decides it.
        obs2_new = ma.scatter_rows(obs2, i2, slot, ma.last_writer(i2, create, N))
        arena = arena._replace(
            pt_pos=scatter(arena.pt_pos, Xw),
            pt_desc=scatter(arena.pt_desc, desc1),
            pt_normal=scatter(arena.pt_normal, normal),
            pt_min_dist=scatter(arena.pt_min_dist, min_d),
            pt_max_dist=scatter(arena.pt_max_dist, max_d),
            pt_valid=scatter(arena.pt_valid, all_rows),
            pt_ref_kf=scatter(arena.pt_ref_kf, torch.full_like(slot, kf_id)),
            pt_n_obs=scatter(arena.pt_n_obs, torch.full_like(slot, 2)),
            n_pt=torch.clamp(arena.n_pt + create.sum(), max=P).to(torch.int32),
            # the neighbour's row second, as the reference sets it second
            kf_obs=ma.set_row(arena.kf_obs, kf_id, torch.where(create, slot, obs1))
                     .index_copy_(0, nb_id.reshape(1), obs2_new[None]),
        )
    return ma.update_covisibility(arena, kf_id)


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


def fuse_into_keyframe(arena: ma.MapArena, kf_id: int, cfg: SlamConfig):
    """ORBmatcher::Fuse into the new keyframe (ORBmatcher.cc:825-977, driven
    by LocalMapping::SearchInNeighbors LocalMapping.cc:454-535): project all
    valid map points into keyframe `kf_id`; a matched keypoint that is free
    gains the observation, a matched keypoint already claimed by a different
    point triggers MapPoint::Replace: the point with fewer observations is
    merged into the other. Returns (arena, kf_id's refreshed obs row)."""
    cam = cfg.camera
    P = arena.pmax
    sfs = extractor.scale_factors(cfg.orb, arena.kf_pose.device)
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, arena.kf_pose[kf_id],
        (cam.fx, cam.fy, cam.cx, cam.cy), (cam.width, cam.height), sfs,
        pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal, base_radius=3.0)
    cap = min(4096, P)
    # lower id first among equal scores (the JAX package's approx_max_k,
    # which is exact on the CPU)
    cand_ids = extractor.top_k_stable(torch.where(vis, 1 + arena.pt_n_obs, 0).float(), cap)[1]
    cvalid = vis[cand_ids]
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid, arena.pt_desc[cand_ids], level_p[cand_ids],
        torch.zeros(cap, device=vis.device), radius_p[cand_ids],
        arena.kf_uv[kf_id], arena.kf_kp_valid[kf_id], arena.kf_desc[kf_id],
        arena.kf_level[kf_id], arena.kf_angle[kf_id],
        th_hamming=TH_LOW, level_slack=1, use_rotation=False)
    matched = res.point_idx >= 0
    cand_pt = cand_ids[torch.where(matched, res.point_idx, 0).long()].to(torch.int32)
    cur_pt = arena.kf_obs[kf_id]
    # Case 1: a free keypoint gains the observation, unless the point is
    # already observed by another keypoint of this keyframe (keeps the
    # one-observation-per-point-per-keyframe invariant BA relies on).
    in_row = torch.zeros(P + 1, dtype=torch.bool, device=vis.device)
    in_row.index_fill_(0, torch.where(cur_pt >= 0, cur_pt, P).long(), True)
    gain = matched & (cur_pt < 0) & ~in_row[cand_pt.long()]
    arena = arena._replace(
        kf_obs=ma.set_row(arena.kf_obs, kf_id, torch.where(gain, cand_pt, cur_pt)),
        pt_n_obs=torch.index_add(arena.pt_n_obs, 0,
                                 torch.where(gain, cand_pt, P - 1).long(),
                                 gain.to(torch.int32)))
    # Case 2: keypoint claimed by a different point -> Replace (keep the
    # point with more observations).
    dup = matched & (cur_pt >= 0) & (cand_pt != cur_pt)
    a, b = cand_pt, cur_pt.clamp(min=0)
    a_wins = arena.pt_n_obs[a.long()] >= arena.pt_n_obs[b.long()]
    arena = replace_points(arena, torch.where(a_wins, b, a), torch.where(a_wins, a, b), dup)
    return arena, torch.where(arena.kf_kp_valid[kf_id], arena.kf_obs[kf_id], -1)


def replace_points(arena: ma.MapArena, src: torch.Tensor, dst: torch.Tensor,
                   do: torch.Tensor) -> ma.MapArena:
    """MapPoint::Replace (MapPoint.cc:177): merge point `src` into `dst`.

    src/dst: [M] int32 point ids, do: [M] bool. Every kf_obs entry pointing
    at src is redirected to dst; src is invalidated; counters accumulate.
    One-step redirects only (chains resolve over subsequent calls). Where
    two rows name one src, the later row's dst stands; the rows outside
    `do` aim at point P - 1 with its old values
    (gdslam_tpu/backend/mapping.py:427-436)."""
    P = arena.pmax
    s = torch.where(do, src, P - 1).long()
    d = torch.where(do, dst, P - 1).long()
    write = ma.last_writer(s, do, P)
    redirect = ma.scatter_rows(torch.arange(P, dtype=torch.int32, device=src.device),
                               s, dst, write)
    obs = arena.kf_obs
    obs = torch.where(obs >= 0, redirect[obs.clamp(min=0).long()], obs)

    def inc(a):
        return torch.index_add(a, 0, d, torch.where(do, a[s], 0))

    return arena._replace(
        kf_obs=obs,
        pt_valid=ma.scatter_rows(arena.pt_valid, s, torch.zeros_like(do), write),
        pt_n_obs=inc(arena.pt_n_obs),
        pt_found=inc(arena.pt_found),
        pt_visible=inc(arena.pt_visible),
    )
