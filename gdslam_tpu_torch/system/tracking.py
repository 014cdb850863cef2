"""Tracking front-end: the per-frame state machine (port of
gdslam_tpu.system.tracking).

Re-design of the reference Tracking class (Tracking.cc:408-652 `Track`,
762-815 `StereoInitialization`, 1196-1257 `TrackWithMotionModel`,
1259-1303 `TrackLocalMap`, 1306-1470 keyframe decision/creation): a thin
host state machine drives tensor programs against the fixed-shape
MapArena. Host branching happens at frame granularity.

The RGB-D tracker runs as the JAX package runs it by default: the full
keyframe program (fuse -> insert -> triangulate -> fuse duplicates ->
refresh -> cull -> local BA), relocalization, keyframe culling and arena
compaction, and the pipelined commit protocol; with a loop closer
(`Tracking.loop_closer`, a backend.loop_closing.LoopCloser) also loop
closing at every keyframe and relocalization from the BoW database. A
rectified stereo pair (`process_stereo`: both views extracted, per-keypoint
depth from the stereo matcher kernel) and a monocular image (`process_mono`:
the two-view H/F bootstrap, then monocular observations) take the same
common body, `_process_built_frame`.

Host reads: the tracking programs read nothing on the host. The wide-radius
retry of the motion model, which the JAX package decides on the device with
lax.cond, is decided here from the frame's statistics: a frame is dispatched
with the narrow search, and redone with the wide one if that found fewer
than 10 inliers (rare), so a tracked frame costs one read (its statistics
and its pose in one copy) and a keyframe one more, or one read per
`commit_every` frames when pipelined.
"""

from __future__ import annotations

import enum
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from gdslam_tpu_torch.backend import ba as ba_mod
from gdslam_tpu_torch.backend import gba
from gdslam_tpu_torch.backend import keyframe_db as kdb
from gdslam_tpu_torch.backend import loop_closing
from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend import mapping, optimizer, solvers
from gdslam_tpu_torch.backend import vocabulary as voc
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import camera as cam_ops
from gdslam_tpu_torch.core import lie, prng
from gdslam_tpu_torch.frontend import extractor, initializer, matcher
from gdslam_tpu_torch.frontend.frame import Frame, build_frame, build_frame_stereo
from gdslam_tpu_torch.ops import stereo as stereo_ops
from gdslam_tpu_torch.ops.match_kernel import BIG, match_top2

LOCAL_POINT_CAP = 4096   # dense local-map candidate budget


def _all_pairs_top2(rows: tuple, keys: tuple, n_levels: int):
    """match_top2 with no window: every (uv, desc, level, valid) row of
    `rows` a candidate of every keypoint of `keys` (an infinite radius, a
    level slack of n_levels), the JAX package's dense masked best / second /
    arg over the same 1 << 20 sentinel."""
    radius = torch.full((rows[0].shape[0],), float("inf"), device=rows[0].device)
    (uv_c, desc_c, lvl_c, val_c), (uv_k, desc_k, lvl_k, val_k) = rows, keys
    return match_top2(uv_c.contiguous(), desc_c.contiguous(), radius,
                      lvl_c.to(torch.int32).contiguous(), val_c.contiguous(),
                      uv_k.contiguous(), desc_k.contiguous(),
                      lvl_k.to(torch.int32).contiguous(), val_k.contiguous(), n_levels)


def _dense_ratio_matches(frame: Frame, kf_uv, kf_desc, kf_level, kf_valid, n_levels: int):
    """Brute-force Hamming matching with 0.75 ratio test, the vocabulary-free
    stand-in for SearchByBoW during relocalization: per keypoint of `frame`
    its best keypoint in the candidate keyframe ([N] int32, -1 none) and the
    number of matches.

    The JAX function is an all-pairs best / second / arg over a cost masked
    by validity alone. That is `match_top2` with the keyframe's keypoints as
    the candidate rows, no window (an infinite radius, a level slack of
    n_levels) and the same 1 << 20 sentinel, so this is a call of the
    matcher kernel, the first on its all-pairs path."""
    best, second, arg, _ = _all_pairs_top2(
        (kf_uv, kf_desc, kf_level, kf_valid),
        (frame.uv, frame.desc, frame.level, frame.valid), n_levels)
    good = (best < 50) & (best.float() < 0.75 * second.clamp(max=BIG).float())
    return torch.where(good, arg, -1), good.sum()


def bootstrap_matches(first: Frame, frame: Frame, n_levels: int):
    """The monocular bootstrap's matches of the first frame's keypoints in
    `frame`: (good [N1] bool, idx [N1] int32), as the JAX package's dense
    `best_two` over `descriptors_pm1(desc, valid)` gives them (best < 50,
    best < 0.9 second, the first keypoint valid).

    This is `match_top2` with the frame's keypoints as the candidate rows, no
    window (an infinite radius, a level slack of n_levels). The JAX cost
    gives an invalid descriptor the distance 128 against everything instead
    of excluding it, which leaves `good` as the kernel's but changes the
    argmin; and the index of every row matters, since the bootstrap writes
    -1 through the index of each unmatched row. So idx is rebuilt from the
    kernel's best and arg: 0 for an invalid first keypoint; arg where best <
    128; the lower of arg and the lowest invalid frame row where best ==
    128; the lowest invalid frame row, if there is one, where best > 128 or
    no valid candidate exists."""
    best, second, arg, _ = _all_pairs_top2(
        (frame.uv, frame.desc, frame.level, frame.valid),
        (first.uv, first.desc, first.level, first.valid), n_levels)
    good = (best < 50) & (best.float() < 0.9 * second.float()) & first.valid
    invalid = ~frame.valid
    has_invalid = invalid.any()
    first_invalid = torch.argmax(invalid.to(torch.int32)).to(torch.int32)
    tie = torch.where(has_invalid, torch.minimum(arg, first_invalid), arg)
    above = torch.where(has_invalid, first_invalid, arg)
    idx = torch.where(best < 128, arg, torch.where(best == 128, tie, above))
    return good, torch.where(first.valid, idx, 0)


def bootstrap_assoc(assoc1: torch.Tensor, matched: torch.Tensor, idx: torch.Tensor,
                    n2: int) -> torch.Tensor:
    """The second bootstrap keyframe's associations [n2]: the JAX package's
    `(-ones).at[idx].set(where(matched, assoc1, -1))`, where every first-frame
    row writes (an unmatched one -1) and the last write to a target wins (XLA's
    serial scatter on the CPU), made explicit so it holds on the card."""
    dump = -torch.ones(n2, dtype=assoc1.dtype, device=assoc1.device)
    return ma.scatter_rows(dump, idx, torch.where(matched, assoc1, -1),
                           ma.last_wins(idx, torch.ones_like(matched), n2))


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian of a 1-d tensor: the mean of the two middle values of
    an even count, (low + high) * 0.5 (torch.nanmedian takes the lower
    one); NaN when every value is NaN. No host read."""
    s = torch.sort(x).values                      # NaNs sort to the end
    c = (~torch.isnan(x)).sum()
    lo = torch.clamp(torch.div(c - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.minimum(torch.div(c, 2, rounding_mode="floor"), c - 1), min=0)
    mid = s.index_select(0, torch.stack([lo, hi]))
    return (mid[0] + mid[1]) * 0.5


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameState(NamedTuple):
    """Device-resident last-frame context."""

    frame: Frame
    T_cw: torch.Tensor      # [4, 4]
    assoc: torch.Tensor     # [N] int32 map-point id per keypoint (-1)


def _K(cfg: SlamConfig):
    c = cfg.camera
    return (c.fx, c.fy, c.cx, c.cy)


def _inv_sigma2(level: torch.Tensor, scale: float) -> torch.Tensor:
    return 1.0 / (scale ** (2.0 * level.float()))


def _top_ids(score: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the `cap` best scores, lower index first among ties (the
    JAX package's approx_max_k, which is exact on the CPU)."""
    return extractor.top_k_stable(score.float(), cap)[1]


# ----------------------------------------------------------------------------
# Device programs
# ----------------------------------------------------------------------------

def stereo_initialize(arena: ma.MapArena, frame: Frame, T_cw: torch.Tensor,
                      cfg: SlamConfig):
    """First keyframe + map points from every depth-valid keypoint
    (StereoInitialization, Tracking.cc:762-815)."""
    assoc = -torch.ones(frame.uv.shape[0], dtype=torch.int32, device=T_cw.device)
    return _insert_keyframe(arena, frame, T_cw, assoc, 0.0, cfg, max_depth=1e9)


def _insert_keyframe(arena: ma.MapArena, frame: Frame, T_cw: torch.Tensor,
                     assoc: torch.Tensor, timestamp: float, cfg: SlamConfig,
                     max_depth: float | None = None, kf_id: int | None = None):
    """Insert keyframe + create map points for unmatched close-depth
    keypoints, or any among the 100 nearest (CreateNewKeyFrame,
    Tracking.cc:1392-1470). `kf_id` is the arena's keyframe cursor; a caller
    that mirrors it on the host passes it, else it is read from the device."""
    cam = cfg.camera
    if kf_id is None:
        kf_id = int(arena.n_kf)
    if max_depth is None:
        max_depth = cam.bf * cam.th_depth / cam.fx  # mThDepth (Tracking.cc:120)
    T_wc = lie.se3_inverse(T_cw)
    eligible = frame.valid & (frame.depth > 0) & (assoc < 0)
    keyed = torch.where(eligible, frame.depth, float("inf"))
    depth_rank = torch.argsort(torch.argsort(keyed, stable=True), stable=True)
    create = eligible & ((frame.depth < max_depth) | (depth_rank < 100))
    order = torch.cumsum(create.to(torch.int32), 0) - 1
    # capacity guard: slots past pmax are never created
    create = create & (arena.n_pt + order < arena.pmax)
    slot = torch.where(create, arena.n_pt + order, 0)
    pc = cam_ops.backproject(frame.uv, frame.depth, cam)
    pw = lie.se3_apply(T_wc, pc)
    dvec = pw - T_wc[:3, 3]
    dist = torch.linalg.norm(dvec, dim=1)
    normal = dvec / torch.clamp(dist[:, None], min=1e-9)
    sf = float(cfg.orb.scale_factor)
    max_d = dist * sf ** frame.level.float()
    min_d = max_d / (sf ** (cfg.orb.n_levels - 1))

    # The JAX scatter (gdslam_tpu/system/tracking.py:112, :124-126) sends
    # every row that creates nothing to slot 0 carrying slot 0's old value,
    # and XLA on the CPU applies duplicate indices in row order, so the first
    # keyframe's point in slot 0 is lost unless its keypoint is the last such
    # row. ma.last_writer gives that result without a scatter of duplicates.
    write = ma.last_writer(slot, create, arena.pmax)

    def scatter(dst, src):
        return ma.scatter_rows(dst, slot, src, write)

    arena = arena._replace(
        pt_pos=scatter(arena.pt_pos, pw),
        pt_desc=scatter(arena.pt_desc, frame.desc),
        pt_normal=scatter(arena.pt_normal, normal),
        pt_min_dist=scatter(arena.pt_min_dist, min_d),
        pt_max_dist=scatter(arena.pt_max_dist, max_d),
        pt_valid=scatter(arena.pt_valid, torch.ones_like(create)),
        pt_ref_kf=scatter(arena.pt_ref_kf, torch.full_like(slot, kf_id)),
        n_pt=torch.clamp(arena.n_pt + create.sum(), max=arena.pmax).to(torch.int32),
    )
    new_assoc = torch.where(create, slot, assoc).to(torch.int32)
    obs_row = torch.where(frame.valid, new_assoc, -1)
    arena = arena._replace(
        kf_pose=ma.set_row(arena.kf_pose, kf_id, T_cw),
        kf_valid=ma.set_row(arena.kf_valid, kf_id, True),
        kf_time=ma.set_row(arena.kf_time, kf_id, float(timestamp)),
        kf_uv=ma.set_row(arena.kf_uv, kf_id, frame.uv),
        kf_ur=ma.set_row(arena.kf_ur, kf_id, frame.ur),
        kf_depth=ma.set_row(arena.kf_depth, kf_id, frame.depth),
        kf_level=ma.set_row(arena.kf_level, kf_id, frame.level),
        kf_angle=ma.set_row(arena.kf_angle, kf_id, frame.angle),
        kf_desc=ma.set_row(arena.kf_desc, kf_id, frame.desc),
        kf_kp_valid=ma.set_row(arena.kf_kp_valid, kf_id, frame.valid),
        kf_obs=ma.set_row(arena.kf_obs, kf_id, obs_row),
        n_kf=arena.n_kf + 1,
    )
    # observation counts for matched existing points
    obs_inc = obs_row >= 0
    arena = arena._replace(pt_n_obs=torch.index_add(
        arena.pt_n_obs, 0, torch.where(obs_inc, obs_row, arena.pmax - 1).long(),
        obs_inc.to(torch.int32)))
    return ma.update_covisibility(arena, kf_id), new_assoc


def keyframe_program(arena: ma.MapArena, frame: Frame, T_cw: torch.Tensor,
                     assoc: torch.Tensor, timestamp: float, cfg: SlamConfig,
                     use_triangulation: bool, use_ba: bool, kf_id: int | None = None):
    """The whole keyframe insertion: proactive fuse -> insert -> epipolar
    CreateNewMapPoints -> duplicate fusion (Replace) -> descriptor/normal
    refresh -> point culling -> local BA -> reference-match statistic. With
    `kf_id` (the keyframe cursor, mirrored on the host) nothing is read on
    the host. Returns (arena, assoc, T_refined, ref_matches)."""
    if kf_id is None:
        kf_id = int(arena.n_kf)
    assoc = fuse_associate(arena, frame, T_cw, assoc, cfg)
    arena, assoc = _insert_keyframe(arena, frame, T_cw, assoc, timestamp, cfg, kf_id=kf_id)
    if use_triangulation:
        arena = mapping.create_new_map_points(arena, kf_id, cfg)
        arena, assoc = mapping.fuse_into_keyframe(arena, kf_id, cfg)
    arena = mapping.refresh_points(arena, kf_id, cfg)
    arena = cull_points(arena)
    if use_ba:
        prob = ba_mod.build_problem(arena, kf_id, cfg)
        arena, _ = ba_mod.run_local_ba(arena, prob, cfg, 5, 5)
        T_out = arena.kf_pose[kf_id]
    else:
        T_out = T_cw
    n_kf = kf_id + 1
    min_obs = 3 if n_kf > 2 else (2 if n_kf == 2 else 1)
    return arena, assoc, T_out, ref_tracked_points(arena, kf_id, min_obs)


def fuse_associate(arena: ma.MapArena, frame: Frame, T_cw: torch.Tensor,
                   assoc: torch.Tensor, cfg: SlamConfig):
    """Associate still-unmatched keypoints to existing map points with a
    wider window before creating new points (the role of SearchInNeighbors /
    ORBmatcher::Fuse, LocalMapping.cc:454-535), so duplicates are never
    created."""
    cam = cfg.camera
    sfs = extractor.scale_factors(cfg.orb, T_cw.device)
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, T_cw, _K(cfg), (cam.width, cam.height),
        sfs, pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal,
        base_radius=6.0)
    cap = min(LOCAL_POINT_CAP, arena.pmax)
    cand_ids = _top_ids(torch.where(vis, 1 + arena.pt_n_obs, 0), cap)
    cvalid = vis[cand_ids]
    kp_free = frame.valid & (assoc < 0)
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid, arena.pt_desc[cand_ids], level_p[cand_ids],
        torch.zeros(cap, device=T_cw.device), radius_p[cand_ids],
        frame.uv, kp_free, frame.desc, frame.level, frame.angle,
        th_hamming=matcher.TH_LOW, level_slack=1, use_rotation=False)
    new_match = res.point_idx >= 0
    return torch.where(new_match,
                       cand_ids[torch.where(new_match, res.point_idx, 0).long()]
                       .to(torch.int32), assoc)


def cull_points(arena: ma.MapArena):
    """MapPointCulling (LocalMapping.cc:170-206): drop points whose
    found/visible ratio < 0.25, or that are >= 3 keyframes old with fewer
    than 2 keyframe observations."""
    age = arena.n_kf - arena.pt_ref_kf
    ratio = arena.pt_found.float() / torch.clamp(arena.pt_visible, min=1).float()
    seen_enough = arena.pt_visible >= 8
    bad = (seen_enough & (ratio < 0.25)) | ((age >= 3) & (arena.pt_n_obs < 2))
    return arena._replace(pt_valid=arena.pt_valid & ~bad)


def ref_tracked_points(arena: ma.MapArena, kf_id: int, min_obs: int) -> torch.Tensor:
    """KeyFrame::TrackedMapPoints(minObs): #keypoints of kf_id whose map
    point has >= min_obs observations."""
    obs = arena.kf_obs[kf_id]
    has = obs >= 0
    rows = torch.where(has, obs, 0).long()
    return (has & arena.pt_valid[rows] & (arena.pt_n_obs[rows] >= min_obs)).sum()


def track_motion_model(last: FrameState, last_depthpts_w: torch.Tensor,
                       frame: Frame, T_pred: torch.Tensor, cfg: SlamConfig,
                       radius_px: float = 15.0, temporal_points: bool = False):
    """Frame-to-frame tracking (TrackWithMotionModel, Tracking.cc:1196-1257):
    dense projection search of the last frame's keypoints that have a map
    point, with radius radius_px*scale^level, then pose GN. With
    temporal_points the keypoints with valid depth are candidates too (the
    reference's temporal visual-odometry points, UpdateLastFrame
    Tracking.cc:1056-1125, created only in localization mode: in mapping mode
    their world positions inherit the last pose's error and it compounds)."""
    cam = cfg.camera
    sf = float(cfg.orb.scale_factor)
    lf = last.frame
    cand_valid = lf.valid & (last.assoc >= 0)
    if temporal_points:
        cand_valid = lf.valid & ((last.assoc >= 0) | (lf.depth > 0))
    uv_proj, zc = cam_ops.project(lie.se3_apply(T_pred, last_depthpts_w), cam)
    in_img = (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width) & \
             (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height) & (zc > 0)
    cand_valid = cand_valid & in_img
    radius = radius_px * sf ** lf.level.float()
    res = matcher.match_candidates(
        uv_proj, cand_valid, lf.desc, lf.level, lf.angle, radius,
        frame.uv, frame.valid, frame.desc, frame.level, frame.angle,
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=True)

    matched = res.point_idx >= 0
    cand_row = torch.where(matched, res.point_idx, 0).long()
    obs = optimizer.PoseObs(
        pw=torch.where(matched[:, None], last_depthpts_w[cand_row], 0.0),
        uv=frame.uv, ur=frame.ur, inv_sigma2=_inv_sigma2(frame.level, sf),
        valid=matched)
    T, inl, n_inl = optimizer.pose_optimization(T_pred, obs, _K(cfg), cam.bf)
    new_assoc = torch.where(inl & matched, last.assoc[cand_row], -1)
    return T, new_assoc, n_inl, res.n_matches


def track_local_map(arena: ma.MapArena, frame: Frame, T: torch.Tensor,
                    cfg: SlamConfig, assoc: torch.Tensor):
    """Refine pose against the local map (TrackLocalMap, Tracking.cc:
    1259-1303 + SearchLocalPoints 1472-1522): the top-LOCAL_POINT_CAP valid
    points passing the frustum test at pose T, searched with th=3 radii
    (base 12 px); already-matched keypoints keep their motion-model match."""
    cam = cfg.camera
    sf = float(cfg.orb.scale_factor)
    sfs = extractor.scale_factors(cfg.orb, T.device)
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, T, _K(cfg), (cam.width, cam.height), sfs,
        pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal,
        base_radius=12.0)
    cap = min(LOCAL_POINT_CAP, arena.pmax)
    cand_ids = _top_ids(torch.where(vis, 1 + arena.pt_n_obs, 0), cap)
    cvalid = vis[cand_ids]
    kp_free = frame.valid & (assoc < 0)
    # angles unknown for map points -> no rotation check here
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid, arena.pt_desc[cand_ids], level_p[cand_ids],
        torch.zeros(cap, device=T.device), radius_p[cand_ids],
        frame.uv, kp_free, frame.desc, frame.level, frame.angle,
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=False,
        nn_ratio=0.8)
    new_match = res.point_idx >= 0
    merged_assoc = torch.where(
        new_match, cand_ids[torch.where(new_match, res.point_idx, 0).long()]
        .to(torch.int32), assoc)
    matched = merged_assoc >= 0
    obs = optimizer.PoseObs(
        pw=torch.where(matched[:, None],
                       arena.pt_pos[torch.where(matched, merged_assoc, 0).long()], 0.0),
        uv=frame.uv, ur=frame.ur, inv_sigma2=_inv_sigma2(frame.level, sf),
        valid=matched)
    T_opt, inl, n_inl = optimizer.pose_optimization(T, obs, _K(cfg), cam.bf)
    final_assoc = torch.where(inl & matched, merged_assoc, -1)
    # visibility bookkeeping (MapPoint::IncreaseVisible/Found)
    fnd = final_assoc >= 0
    arena = arena._replace(
        pt_visible=arena.pt_visible + vis.to(torch.int32),
        pt_found=torch.index_add(
            arena.pt_found, 0, torch.where(fnd, final_assoc, arena.pmax - 1).long(),
            fnd.to(torch.int32)))
    return arena, T_opt, final_assoc, n_inl


def track_step(arena: ma.MapArena, last: FrameState, velocity: torch.Tensor,
               has_velocity: bool, gray: torch.Tensor, depth: torch.Tensor,
               mask: torch.Tensor, cfg: SlamConfig, ref_kf: int,
               temporal_points: bool = False, wide: bool = False):
    """The per-frame program: extraction -> frame build -> track_frame_core."""
    cam = cfg.camera
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    frame = build_frame(feats, depth, mask, cam)
    return track_frame_core(arena, last, velocity, has_velocity, frame, cfg, ref_kf,
                            temporal_points, wide)


def _world_points(arena: ma.MapArena, last: FrameState, cfg: SlamConfig) -> torch.Tensor:
    """[N, 3] world position per last-frame keypoint: its map point if
    associated, else its backprojected depth (temporal VO points)."""
    lf = last.frame
    pc = cam_ops.backproject(lf.uv, lf.depth, cfg.camera)
    pw_depth = lie.se3_apply(lie.se3_inverse(last.T_cw), pc)
    has_pt = last.assoc >= 0
    pt_rows = torch.where(has_pt, last.assoc, 0).long()
    return torch.where(has_pt[:, None], arena.pt_pos[pt_rows], pw_depth)


def _read(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Several small device tensors in one device-to-host copy (each read is
    a wait for the card), as arrays of their shapes: float32 for a float
    tensor, float64 for an integer one. Both pass through the float64
    carrier exactly (integers up to 2**53)."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        a = flat[i:i + t.numel()].reshape(tuple(t.shape))
        out.append(a.astype(np.float32) if t.dtype.is_floating_point else a)
        i += t.numel()
    return out


def track_frame_core(arena: ma.MapArena, last: FrameState, velocity: torch.Tensor,
                     has_velocity: bool, frame: Frame, cfg: SlamConfig,
                     ref_kf: int, temporal_points: bool = False, wide: bool = False):
    """Frame-level tracking core: motion-model match + pose GN, then
    local-map match + pose GN, the velocity and the keyframe statistics.

    Returns (arena, FrameState, velocity, T_cr, stats [n1, n2,
    close_tracked, close_untracked]); nothing is read on the host. The JAX
    package retries the motion model inside this program when it finds
    n1 < 10 inliers (lax.cond): from the last pose, with twice the radius.
    Here that retry is `wide=True`, and the caller takes it when the narrow
    call's n1 says so; the result is the JAX program's either way."""
    cam = cfg.camera
    pts_w = _world_points(arena, last, cfg)
    if wide:
        T1, assoc1, n1, _ = track_motion_model(last, pts_w, frame, last.T_cw, cfg,
                                               radius_px=30.0,
                                               temporal_points=temporal_points)
    else:
        T_pred = velocity @ last.T_cw if has_velocity else last.T_cw
        T1, assoc1, n1, _ = track_motion_model(last, pts_w, frame, T_pred, cfg,
                                               temporal_points=temporal_points)

    arena, T2, assoc2, n2 = track_local_map(arena, frame, T1, cfg, assoc1)

    # Re-project onto SE(3): the velocity cycle's transpose-inverse
    # amplifies any SO(3) deviation geometrically.
    T2 = lie.se3_orthonormalize(T2)
    velocity_new = T2 @ lie.se3_inverse(last.T_cw)
    th_depth_m = cam.bf * cam.th_depth / cam.fx
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_depth_m)
    close_tracked = (close & (assoc2 >= 0)).sum()
    close_untracked = (close & (assoc2 < 0)).sum()
    T_cr = T2 @ lie.se3_inverse(arena.kf_pose[ref_kf])
    stats = torch.stack([n1, n2, close_tracked, close_untracked])
    return arena, FrameState(frame=frame, T_cw=T2, assoc=assoc2), \
        velocity_new, T_cr, stats


# ----------------------------------------------------------------------------
# Host state machine
# ----------------------------------------------------------------------------

class Pending(NamedTuple):
    """A dispatched frame whose statistics have not been read yet."""

    stats: torch.Tensor      # [4] n1, n2, close_tracked, close_untracked
    ref_kf: int              # the reference keyframe at dispatch
    T_cr: torch.Tensor       # pose relative to that keyframe
    last: FrameState         # the frame's own state
    timestamp: float
    backup: tuple            # (arena, last, velocity) before its dispatch
    wide: bool               # dispatched with the wide motion-model search


class Tracking:
    """Host-side tracker mirroring the reference Tracking state machine.

    With `pipeline=True` a frame's device program is dispatched before the
    scalar results of the frames before it are read back: the host reads the
    statistics of `commit_every` frames in one copy and runs the state
    machine on them then. Keyframe decisions lag by up to that many frames,
    the analogue of the reference's asynchronous LocalMapping thread. Poses
    are exact in `camera_trajectory()` after `flush()`; `process` then
    returns the in-flight pose as a tensor on the device, since converting
    it would wait for the frame.

    The arena is never written in place (every program returns a new one),
    so the state kept for a rollback stays what it was.
    """

    def __init__(self, cfg: SlamConfig, kmax: int = 512, pmax: int = 65536,
                 pipeline: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.arena = ma.new_arena(kmax, pmax, cfg.orb.n_features, self.device)
        self.pipeline = pipeline
        self.commit_every = 3               # frames per host read (pipeline mode)
        self.frame_id: int = 0
        self.n_inliers: int = 0
        self.mapping_enabled: bool = True   # localization mode toggle
        self.use_local_ba: bool = True      # LocalMapping's BA stage
        self.use_triangulation: bool = True  # CreateNewMapPoints epipolar stage
        self.compact_min_gain = 8           # min slots a compaction must free
        # Sensor modality, set by the mono entry point: the keyframe cadence
        # rules differ (thRefRatio 0.9 against 0.75, dense mono insertion)
        self.sensor_mono = False
        self._eye4 = torch.eye(4, device=self.device)
        self._loop_closer: Optional[loop_closing.LoopCloser] = None
        self._clear()

    def _clear(self):
        self.state = TrackState.NO_IMAGES_YET
        self.last: Optional[FrameState] = None
        self.velocity: Optional[torch.Tensor] = None
        self.ref_kf: int = 0
        self.ref_kf_matches: int = 0
        self.frames_since_kf: int = 0
        # per-frame trajectory records: (timestamp, ref_kf, T_cr, lost)
        self.records: list = []
        self._pending: list[Pending] = []   # in-flight frames (pipeline mode)
        self._ref_m_dev = None              # deferred ref-match scalar (pipeline)
        # Keyframe timestamps live host-side (float32 cannot hold TUM epoch
        # seconds); list index == arena kf slot.
        self.kf_timestamps: list[float] = []
        self.arena_full_warned = False
        self.kf_arena_full_warned = False
        self._compact_requested = False
        # (pre, post) pose of the keyframe a loop correction moved, for a
        # caller holding a later in-flight pose; and the composed re-anchor
        # inv(pre) @ post of the corrections inside the current flush
        self._loop_delta = None
        self._flush_delta: Optional[torch.Tensor] = None
        self._mono_first = None            # (Frame, timestamp) awaiting its pair

    @property
    def loop_closer(self) -> Optional[loop_closing.LoopCloser]:
        """The loop closer run at every keyframe (None: no loop closing)."""
        return self._loop_closer

    @loop_closer.setter
    def loop_closer(self, value: Optional[loop_closing.LoopCloser]):
        if value is not None and not isinstance(value, loop_closing.LoopCloser):
            raise TypeError("loop_closer must be a backend.loop_closing.LoopCloser or None")
        self._loop_closer = value

    @property
    def n_kf_host(self) -> int:
        """Keyframe count without a device sync (kf_timestamps mirrors the
        arena's keyframe cursor)."""
        return len(self.kf_timestamps)

    def _do_keyframe(self, frame: Frame, T, assoc, timestamp: float):
        """The LocalMapping duties at keyframe insertion (LocalMapping::Run,
        LocalMapping.cc:47-112) as one program, then the host bookkeeping
        and loop closing. Returns (assoc, T_refined, T_refined on the host).
        Reads the host once (the reference-match count and the pose in one
        copy), or not at all when pipelined (the host pose is then None),
        besides the loop closer's reads."""
        self._loop_delta = None
        new_n_kf = self.n_kf_host + 1
        self.arena, assoc, T_out, ref_m = keyframe_program(
            self.arena, frame, T, assoc, timestamp, self.cfg,
            self.use_triangulation, self.use_local_ba and new_n_kf >= 3,
            kf_id=new_n_kf - 1)
        self._note_keyframe(timestamp)
        self.ref_kf = new_n_kf - 1
        T_host = None
        if self.pipeline:
            # Deferred: the scalar joins the next flush()'s one copy, so
            # ref_kf_matches stays stale for <= commit_every frames, the
            # staleness the reference's asynchronous LocalMapping has.
            self._ref_m_dev = ref_m
        else:
            ref_m, T_host = _read(ref_m, T_out)
            self.ref_kf_matches = int(ref_m)
        self.frames_since_kf = 0
        lc = self.loop_closer
        if lc is not None:
            pre_pose = self.arena.kf_pose[self.ref_kf]
            n_loops = len(lc.loops)
            self.arena = lc.process_keyframe(self.arena, self.ref_kf)
            if len(lc.loops) > n_loops:
                # A loop correction moved the map: the tracker goes on from
                # the corrected keyframe pose (the reference's Tracking after
                # CorrectLoop); a later in-flight pose follows through
                # _loop_delta, keeping its pose relative to this keyframe.
                # The seam fusion redirected map points, so the keyframe's
                # fused observations are the association, and the velocity,
                # estimated against the map before the correction, is dropped.
                post_pose = self.arena.kf_pose[self.ref_kf]
                self._loop_delta = (pre_pose, post_pose)
                T_out = post_pose
                assoc = self.arena.kf_obs[self.ref_kf]
                self.velocity = None
                if T_host is not None:
                    T_host = post_pose.cpu().numpy()
        return assoc, T_out, T_host

    def _note_keyframe(self, timestamp: float):
        """Record a keyframe's timestamp host-side and warn once when the
        map-point arena is full (new points are then no longer created)."""
        self.kf_timestamps.append(float(timestamp))
        if not self.arena_full_warned and self.n_kf_host % 16 == 0 and \
                int(self.arena.n_pt) >= self.arena.pmax:
            warnings.warn(
                "gdslam_tpu_torch: map-point arena is full (pmax="
                f"{self.arena.pmax}); new map points are no longer created. "
                "Construct Tracking with a larger pmax for long sequences.")
            self.arena_full_warned = True

    def _world_points_for_last(self) -> torch.Tensor:
        return _world_points(self.arena, self.last, self.cfg)

    def reset(self):
        """Tracking::Reset (Tracking.cc:1834-1880): wipe the map, trajectory
        records and state; the system re-initializes from the next frame.
        Triggered by System.reset or automatically on early loss."""
        self.arena = ma.new_arena(self.arena.kmax, self.arena.pmax,
                                  self.cfg.orb.n_features, self.device)
        self._clear()
        if self.loop_closer is not None:
            self.loop_closer.reset()

    def _on_lost(self, timestamp: float, T_last):
        """LOST handling incl. the early-loss auto-reset: LOST with <= 5
        keyframes wipes and restarts (Tracking.cc:618-626)."""
        self.state = TrackState.LOST
        self._record(timestamp, T_last, lost=True)
        if self.mapping_enabled and self.n_kf_host <= 5:
            self.reset()

    def light_track(self, frame: Frame):
        """Map-preserving pose pre-pass (LightTrack, Tracking.cc:654-760 /
        LightTrackWithMotionModel, Tracking.cc:1127-1195): motion-model
        matching + pose GN against the last frame's points. No tracker state
        is modified (the programs are pure). Refuses to run uninitialized
        (Tracking.cc:660-664). Returns (ok, T_cw)."""
        if self.state != TrackState.OK or self.last is None:
            return False, None
        pts_w = self._world_points_for_last()
        T_pred = self.velocity @ self.last.T_cw if self.velocity is not None \
            else self.last.T_cw
        # the depth-backprojected keypoints are candidates too, as in the
        # JAX package, whose track_motion_model has them on by default
        T, _, n_inl, _ = track_motion_model(self.last, pts_w, frame, T_pred, self.cfg,
                                            temporal_points=True)
        if int(n_inl) < 10:
            T, _, n_inl, _ = track_motion_model(self.last, pts_w, frame, self.last.T_cw,
                                                self.cfg, radius_px=30.0,
                                                temporal_points=True)
        return int(n_inl) >= 10, T

    def light_track_dispatched(self, frame: Frame):
        """light_track with nothing read on the host, for a frame dispatched
        in the pipeline: both the narrow search from the predicted pose and
        the wide retry from the last pose are computed, and the wide one is
        taken where the narrow one found fewer than 10 inliers (the JAX
        package's lax.cond, `_geometry_track_program`). The caller must have
        checked that the tracker is OK. Returns (T_cw, n_inliers) as tensors
        on the device."""
        pts_w = self._world_points_for_last()
        T_pred = self.velocity @ self.last.T_cw if self.velocity is not None \
            else self.last.T_cw
        T_n, _, n_n, _ = track_motion_model(self.last, pts_w, frame, T_pred, self.cfg,
                                            temporal_points=True)
        T_w, _, n_w, _ = track_motion_model(self.last, pts_w, frame, self.last.T_cw, self.cfg,
                                            radius_px=30.0, temporal_points=True)
        wide = n_n < 10
        return torch.where(wide, T_w, T_n), torch.where(wide, n_w, n_n)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def process(self, gray, depth, mask, timestamp: float):
        """Track one RGB-D frame (gray [H, W], depth [H, W] meters, mask
        [H, W] 1 = static). Returns the 4x4 T_cw estimate: a numpy array,
        or when pipelined the in-flight pose as a tensor on the device.

        The frame is built first and then takes the common body,
        `_process_built_frame` (the JAX package fuses extraction into its
        per-frame program, `track_step`; the results are the same)."""
        cfg, cam = self.cfg, self.cfg.camera
        feats = extractor.extract(self._tensor(gray), cfg.orb, cam.height, cam.width)
        frame = build_frame(feats, self._tensor(depth), self._tensor(mask), cam)
        return self._process_built_frame(frame, timestamp, min_depth_points=0)

    def process_stereo(self, gray_left, gray_right, mask, timestamp: float):
        """Rectified stereo tracking (GrabImageStereo, Tracking.cc:156):
        extract both views, match them for per-keypoint depth (the
        stereo_match kernel on the card), then the common frame body. mask
        [H, W] 1 = static, or None."""
        cfg, cam = self.cfg, self.cfg.camera
        gl, gr = self._tensor(gray_left), self._tensor(gray_right)
        mask = torch.ones_like(gl) if mask is None else self._tensor(mask)
        fl = extractor.extract(gl, cfg.orb, cam.height, cam.width)
        fr = extractor.extract(gr, cfg.orb, cam.height, cam.width)
        ur, depth = stereo_ops.stereo_match(
            *(t.contiguous() for t in (fl.uv, fl.level, fl.desc, fl.valid,
                                       fr.uv, fr.level, fr.desc, fr.valid)),
            cam.bf, cam.bf / cam.fx, gl.contiguous(), gr.contiguous(),
            float(cfg.orb.scale_factor))
        frame = build_frame_stereo(fl, ur, depth, mask, cam)
        return self._process_built_frame(frame, timestamp)

    def process_mono(self, gray, timestamp: float):
        """Monocular tracking (GrabImageMonocular, Tracking.cc:371): the
        two-view H/F bootstrap, then the common body with monocular
        observations; the map grows past the bootstrap pair through epipolar
        triangulation at keyframe insertion (mapping.create_new_map_points).
        A frame whose bootstrap fails becomes the next first frame; neither
        is recorded in the trajectory."""
        self.sensor_mono = True
        cfg, cam = self.cfg, self.cfg.camera
        g = self._tensor(gray)
        feats = extractor.extract(g, cfg.orb, cam.height, cam.width)
        frame = build_frame(feats, torch.zeros_like(g), torch.ones_like(g), cam)
        if self.state not in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            return self._process_built_frame(frame, timestamp)
        self.frame_id += 1
        if self._mono_first is None:
            self._mono_first = (frame, timestamp)
            self.state = TrackState.NOT_INITIALIZED
            return np.eye(4, dtype=np.float32)
        first, ts0 = self._mono_first
        good, idx = bootstrap_matches(first, frame, cfg.orb.n_levels)
        # the JAX package's draws: PRNGKey(0) at every attempt, replayed
        res = initializer.initialize(first.uv, frame.uv[idx.long()], good, _K(cfg), seed=0)
        if not bool(res.ok):
            self._mono_first = (frame, timestamp)
            return np.eye(4, dtype=np.float32)
        self._mono_bootstrap(first, ts0, frame, timestamp, idx, res)
        return res.T_21.cpu().numpy()

    def _mono_bootstrap(self, first: Frame, ts0, frame: Frame, ts1, idx, res):
        """Insert the two bootstrap keyframes and the triangulated points.
        The scale makes the median depth of the good points 2 m (the mono
        scale is free; the reference normalizes by the median depth)."""
        cfg, dev = self.cfg, self.device
        med = nanmedian(torch.where(res.is_good, res.points[:, 2], float("nan")))
        med = torch.where(torch.isfinite(med), med, 1.0)
        scale = torch.full((), 2.0, device=dev) / torch.clamp(med, min=1e-6)
        pts = res.points * scale
        T21 = lie.rt_to_mat(res.T_21[:3, :3], res.T_21[:3, 3] * scale)
        # the first frame's keypoints get the triangulated depth
        f1 = first._replace(depth=torch.where(res.is_good, pts[:, 2], 0.0),
                            ur=-torch.ones_like(first.ur))
        self.arena, assoc1 = stereo_initialize(self.arena, f1, self._eye4, cfg)
        self._note_keyframe(ts0)
        # the second keyframe observes the same points through the match index
        assoc2 = bootstrap_assoc(assoc1, res.is_good & (assoc1 >= 0), idx, frame.uv.shape[0])
        self.arena, assoc2 = _insert_keyframe(self.arena, frame, T21, assoc2, ts1, cfg,
                                              kf_id=1)
        self._note_keyframe(ts1)
        self.last = FrameState(frame=frame, T_cw=T21, assoc=assoc2)
        self.state = TrackState.OK
        self.ref_kf = 1
        self.ref_kf_matches = int(ref_tracked_points(self.arena, 1, 1))
        self.frames_since_kf = 0
        self.records.append((float(ts0), 0, self._eye4, False))
        self.records.append((float(ts1), 1, self._eye4, False))

    def _initialize(self, frame: Frame, timestamp: float, min_depth_points: int):
        """The first keyframe, if the frame has enough keypoints. Reference
        gate: > 500 keypoints of a 1500 budget (Tracking.cc:767), scaled to
        small rigs as a quarter of the budget; a pre-built frame (stereo,
        mono) also needs more than `min_depth_points` keypoints with depth."""
        cfg = self.cfg
        if int(frame.valid.sum()) >= min(cfg.tracking.min_init_features,
                                         cfg.orb.n_features // 4) and \
                (min_depth_points <= 0 or int((frame.depth > 0).sum()) > min_depth_points):
            T0 = self._eye4
            self.arena, assoc = stereo_initialize(self.arena, frame, T0, cfg)
            self._note_keyframe(timestamp)
            self.last = FrameState(frame=frame, T_cw=T0, assoc=assoc)
            self.state = TrackState.OK
            self.ref_kf = 0
            # with a single keyframe every point has one observation
            self.ref_kf_matches = int(ref_tracked_points(self.arena, 0, 1))
            self.frames_since_kf = 0
            self._record(timestamp, T0, lost=False)
        else:
            self.state = TrackState.NOT_INITIALIZED
            self._record(timestamp, self._eye4, lost=True)

    def _dispatch(self, frame: Frame, wide: bool = False):
        """track_frame_core on the current state (no host read)."""
        has_vel = self.velocity is not None
        return track_frame_core(
            self.arena, self.last, self.velocity if has_vel else self._eye4, has_vel,
            frame, self.cfg, self.ref_kf, temporal_points=not self.mapping_enabled,
            wide=wide)

    def _process_built_frame(self, frame: Frame, timestamp: float,
                             min_depth_points: int = 100):
        """Common tracking body for a pre-built Frame."""
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._initialize(frame, timestamp, min_depth_points)
            self.frame_id += 1
            return np.eye(4, dtype=np.float32)
        if self.pipeline:
            return self._process_built_pipelined(frame, timestamp)

        # one program, then one read: its four statistics and its pose
        arena2, new_last, vel_new, _, stats = self._dispatch(frame)
        stats_h, T_host = _read(stats, new_last.T_cw)
        if stats_h[0] < 10:   # the motion model's wide retry (see track_frame_core)
            arena2, new_last, vel_new, _, stats = self._dispatch(frame, wide=True)
            stats_h, T_host = _read(stats, new_last.T_cw)
        n1, n_inl, close_tracked, close_untracked = (int(x) for x in stats_h)
        if n1 >= 10 and n_inl >= 30:
            self.arena, self.last, self.velocity = arena2, new_last, vel_new
        else:
            ok, T, assoc, n_inl = self._relocalize(frame)
            if not ok:
                T_last = self.last.T_cw
                self._on_lost(timestamp, T_last)
                self.frame_id += 1
                return T_last.cpu().numpy()
            self.velocity = None
            self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
            T_host = T.cpu().numpy()
        self.state = TrackState.OK
        self.n_inliers = n_inl
        self.frames_since_kf += 1
        self._record(timestamp, self.last.T_cw, lost=False)
        if self.mapping_enabled and self._need_keyframe_stats(
                n_inl, close_tracked, close_untracked):
            assoc, T, T_host = self._do_keyframe(self.last.frame, self.last.T_cw,
                                                 self.last.assoc, timestamp)
            self.last = self.last._replace(assoc=assoc, T_cw=T)
        self.frame_id += 1
        return T_host

    # ---------------------------------------------------------- pipelining
    def _process_built_pipelined(self, frame: Frame, timestamp: float, wide: bool = False):
        """Dispatch the frame against the current (tentative) state, adopt
        its outputs, and commit later: the host does not wait for it. (The
        JAX package's `_process_pipelined` is this after the extraction,
        which `process` has done already.)"""
        return self.adopt_dispatched(self._dispatch(frame, wide), timestamp, wide)

    def adopt_dispatched(self, out, timestamp: float, wide: bool = False):
        """Adopt a just-dispatched track_frame_core output tuple: tentative
        state adoption, deferred commit. The caller must have dispatched
        against the current arena/last/velocity (the backup is taken here).
        Every pending entry carries its own pre-dispatch backup, so a lagged
        failure rolls back to the state before the failed frame, not before
        the most recent dispatch."""
        self._adopt(out, timestamp, wide)
        if len(self._pending) >= self.commit_every:
            self.flush()
        self.frame_id += 1
        if self.last is None:      # flush hit the early-loss auto-reset
            return self._eye4
        return self.last.T_cw

    def _adopt(self, out, timestamp: float, wide: bool):
        arena2, new_last, vel_new, T_cr, stats = out
        backup = (self.arena, self.last, self.velocity)
        self.arena, self.last, self.velocity = arena2, new_last, vel_new
        self._pending.append(Pending(stats, self.ref_kf, T_cr, new_last, timestamp, backup, wide))

    def _roll_back(self, pending: Pending, n_kf_before: int):
        """Back to the state before `pending` was dispatched. A keyframe
        inserted since (by a commit earlier in the same flush) lives only in
        the current arena, so the arena is then kept, with the dropped
        frames' visibility counts in it, and only the frame state goes back
        (the JAX package restores the backup's arena there and loses the
        keyframe; see ROADMAP.md section 3). If a loop correction moved the
        kept arena, the restored frame state is re-anchored in it as the
        live pose was, and its velocity dropped."""
        arena, self.last, self.velocity = pending.backup
        if self.n_kf_host == n_kf_before:
            self.arena = arena
        elif self._flush_delta is not None and self.last is not None:
            self.last = self.last._replace(T_cw=self.last.T_cw @ self._flush_delta)
            self.velocity = None

    def _commit(self, pending: Pending, stats_host, n_kf_before: int) -> bool:
        """Run the state machine on a lagged frame's (read) scalars."""
        n1, n_inl, close_tracked, close_untracked = stats_host
        if not (n1 >= 10 and n_inl >= 30):
            # the failed frame (and any in-flight successors) consumed a bad
            # state: roll back to the state before this frame's dispatch
            self._roll_back(pending, n_kf_before)
            frame = pending.last.frame
            ok, T, assoc, _ = self._relocalize(frame)
            if ok:
                self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
                self.velocity = None
                self.state = TrackState.OK
                self._record(pending.timestamp, T, lost=False)
            else:
                self.state = TrackState.LOST
                self._record(pending.timestamp, self.last.T_cw, lost=True)
                if self.mapping_enabled and self.n_kf_host <= 5:
                    self.reset()
            return False
        self.n_inliers = n_inl
        self.state = TrackState.OK
        self.frames_since_kf += 1
        # The pose is recorded against the keyframe it was computed against.
        # (The JAX package records the reference keyframe at commit time: a
        # frame committed after a keyframe insertion of the same flush is
        # then paired with the new keyframe and its trajectory pose is off by
        # the motion between the two keyframes; see ROADMAP.md section 3.)
        self.records.append((float(pending.timestamp), pending.ref_kf, pending.T_cr, False))
        if self.mapping_enabled and self._need_keyframe_stats(
                n_inl, close_tracked, close_untracked):
            done = pending.last
            self._do_keyframe(done.frame, done.T_cw, done.assoc, pending.timestamp)
            if self._loop_delta is not None:
                # a loop correction moved the map while later frames were in
                # flight: re-anchor the live pose, keeping its transform to
                # the corrected keyframe; a rollback later in this flush
                # re-anchors its restored state the same way (_roll_back)
                pre, post = self._loop_delta
                self._loop_delta = None
                D = lie.se3_inverse(pre) @ post
                self._flush_delta = D if self._flush_delta is None else self._flush_delta @ D
                if self.last is not None:
                    self.last = self.last._replace(T_cw=self.last.T_cw @ D)
            if self.n_kf_host % 8 == 0:
                self.arena = gba.keyframe_culling(self.arena)
        return True

    def flush(self):
        """Commit all in-flight frames (call before reading trajectories).
        All pending statistics, and the reference-match count deferred by
        the last keyframe, come to the host in one copy."""
        while self._pending:
            batch, self._pending = self._pending, []
            to_get = [p.stats for p in batch]
            if self._ref_m_dev is not None:
                to_get.append(self._ref_m_dev.expand(4))
            got = torch.stack(to_get).tolist()
            if self._ref_m_dev is not None:
                self.ref_kf_matches = got.pop()[0]
                self._ref_m_dev = None
            n_kf_before = self.n_kf_host
            self._flush_delta = None
            for k, (pend, st) in enumerate(zip(batch, got)):
                if st[0] < 10 and not pend.wide:
                    # The narrow motion-model search failed: this frame takes
                    # the wide retry from the state before its dispatch, and
                    # the frames after it, which consumed its result, follow.
                    self._roll_back(pend, n_kf_before)
                    for j, p in enumerate(batch[k:]):
                        self._adopt(self._dispatch(p.last.frame, wide=j == 0),
                                    p.timestamp, wide=j == 0)
                    break
                if not self._commit(pend, st, n_kf_before):
                    # later in-flight frames consumed the bad state: drop
                    # them, but keep their timestamps in the trajectory as
                    # lost records so every input frame appears in it. The
                    # early-loss auto-reset can wipe the tracker mid-flush
                    # (self.last is None): record identity then.
                    T_drop = self.last.T_cw if self.last is not None else self._eye4
                    for dropped in batch[k + 1:]:
                        self._record(dropped.timestamp, T_drop, lost=True)
                    break
        if self._compact_requested:
            self._maybe_compact()

    def _maybe_compact(self):
        """Recycle culled keyframe slots once the arena saturates (the
        counterpart of the reference freeing bad keyframes,
        KeyFrame::SetBadFlag KeyFrame.cc:533-580). Runs only at
        pipeline-quiescent points (no in-flight frames): the permutation
        invalidates slot indices held by pending rollback backups.

        Culls redundant keyframes first, then compacts survivors to the
        front (recency == slot order preserved) and remaps every host-side
        slot reference: timestamps, trajectory records, ref_kf, and the loop
        closer's BoW database and loops."""
        if not self._compact_requested:
            return
        self._compact_requested = False
        if self._pending:
            raise RuntimeError("compaction requires a quiescent pipeline")
        self.arena = gba.keyframe_culling(self.arena)
        valid = self.arena.kf_valid.cpu().numpy()   # one sync; rare event
        n_kf = self.n_kf_host
        keep = np.nonzero(valid[:n_kf])[0]
        if len(keep) > n_kf - max(1, self.compact_min_gain):
            # culling freed almost nothing: warn once, mapping stops growing
            if not self.kf_arena_full_warned:
                warnings.warn(
                    "gdslam_tpu_torch: keyframe arena is full (kmax="
                    f"{self.arena.kmax}) and culling frees too few slots; "
                    "no new keyframes will be created. Construct Tracking "
                    "with a larger kmax for long sequences.")
                self.kf_arena_full_warned = True
            return
        K = self.arena.kmax
        perm = np.concatenate([keep, np.setdiff1d(np.arange(K), keep)]).astype(np.int32)
        new_of_old = np.zeros(K, np.int32)
        new_of_old[perm] = np.arange(K, dtype=np.int32)
        last_kept = 0
        for old in range(n_kf):
            if valid[old]:
                last_kept = new_of_old[old]
            else:
                new_of_old[old] = last_kept
        self.arena = ma.compact_keyframes(
            self.arena, torch.from_numpy(perm).to(self.device),
            torch.from_numpy(new_of_old).to(self.device), len(keep))
        self.kf_timestamps = [self.kf_timestamps[i] for i in keep]
        self.records = [(ts, int(new_of_old[ref]), T_cr, lost)
                        for ts, ref, T_cr, lost in self.records]
        self.ref_kf = int(new_of_old[self.ref_kf])
        if self.loop_closer is not None:
            self.loop_closer.remap(perm, new_of_old, len(keep))

    def _relocalize(self, frame: Frame):
        """Relocalization (Tracking.cc:1670-1832): candidate keyframes from
        the BoW database with a loop closer, or else (or when it finds none)
        the most recent keyframes (short-term loss recovery near the last
        mapped region); descriptor matching (BoW-guided with a vocabulary,
        all pairs without), batched 2D-3D RANSAC (PnPsolver semantics,
        RANSAC(0.99,10,300) at Tracking.cc:1715; works for depthless
        keypoints), then pose optimization and a growth of the match set by
        projection, with a >= 50-inlier acceptance. Where the frame has
        depth, a 3D-3D rigid RANSAC is the fallback hypothesis. Returns (ok,
        T, assoc, n_inliers)."""
        cfg, cam, arena = self.cfg, self.cfg.camera, self.arena
        n_kf = self.n_kf_host
        if n_kf == 0:
            return False, None, None, 0
        lc = self.loop_closer
        words = None
        candidates: list[int] = []
        if lc is not None:
            words = lc.words_of(frame.desc, frame.valid)
            vec = voc.bow_vector(words, words >= 0, lc.vocab.n_leaves)
            ids, scores, ok_c = kdb.reloc_candidates(lc.db, arena, vec)
            ids, scores, ok_c = _read(ids, scores, ok_c)
            candidates = [int(ids[i]) for i in range(ids.shape[0]) if ok_c[i] and scores[i] > 0]
        if not candidates:
            candidates = list(range(n_kf - 1, max(-1, n_kf - 6), -1))

        # Match all candidates first, then read every match count in one copy.
        if words is not None:
            matches = [loop_closing._bow_guided_matches(
                frame.desc, frame.valid, words, arena.kf_desc[kf], arena.kf_kp_valid[kf],
                lc.db.words[kf]) for kf in candidates]
        else:
            matches = [_dense_ratio_matches(frame, arena.kf_uv[kf], arena.kf_desc[kf],
                                            arena.kf_level[kf], arena.kf_kp_valid[kf],
                                            cfg.orb.n_levels) for kf in candidates]
        n_ms = torch.stack([n for _, n in matches]).tolist()
        # Try candidates best-first (the reference iterates all candidates'
        # PnP solvers round-robin, Tracking.cc:1737; best-first reaches the
        # same accept with fewer RANSAC runs). The samples are drawn under
        # PRNGKey(frame_id), the JAX package's key.
        px = 5.991 ** 0.5
        for ci in sorted(range(len(matches)), key=lambda i: -n_ms[i]):
            if n_ms[ci] < 15:
                continue
            kf, m_idx = candidates[ci], matches[ci][0]
            pt = arena.kf_obs[kf][m_idx.clamp(min=0).long()]
            pt_rows = pt.clamp(min=0).long()
            has_pt = (m_idx >= 0) & (pt >= 0) & arena.pt_valid[pt_rows]
            pw = arena.pt_pos[pt_rows]
            # 2D-3D PnP RANSAC: no keypoint depth required.
            res = solvers.ransac_pnp(pw, frame.uv, has_pt, _K(cfg), n_iters=300,
                                     min_inliers=10, px_threshold=px,
                                     key=prng.prng_key(self.frame_id))
            if not bool(res.ok):
                # fallback hypothesis from 3D-3D where depth exists
                has_3d = has_pt & (frame.depth > 0)
                if int(has_3d.sum()) < 10:
                    continue
                q = cam_ops.backproject(frame.uv, frame.depth, cam)
                res = solvers.ransac_rigid(pw, q, has_3d, _K(cfg), frame.uv, n_iters=300,
                                           min_inliers=10, px_threshold=px * 2,
                                           key=prng.prng_key(self.frame_id))
                if not bool(res.ok):
                    continue
            matched = has_pt & res.inliers
            obs = optimizer.PoseObs(
                pw=torch.where(matched[:, None], pw, 0.0), uv=frame.uv, ur=frame.ur,
                inv_sigma2=_inv_sigma2(frame.level, float(cfg.orb.scale_factor)),
                valid=matched)
            T, inl, n_inl = optimizer.pose_optimization(res.T, obs, _K(cfg), cam.bf)
            if int(n_inl) < 10:
                continue
            # Grow the match set by projecting the whole map with the coarse
            # pose (SearchByProjection growth stage, Tracking.cc:1784-1818):
            # the candidate's own matches rarely reach the 50-inlier bar.
            # The returned arena (visibility bookkeeping) is adopted only on
            # acceptance: failed attempts would otherwise inflate pt_visible
            # at wrong poses and push good points below the culling ratio.
            arena2, T2, assoc2, n2 = track_local_map(
                self.arena, frame, T, cfg, torch.where(inl & matched, pt, -1))
            n2 = int(n2)
            if n2 >= 50:
                self.arena = arena2
                return True, T2, assoc2, n2
        return False, None, None, 0

    def _need_keyframe_stats(self, n_inl: int, close_tracked: int,
                             close_untracked: int) -> bool:
        """NeedNewKeyFrame rules (Tracking.cc:1306-1390)."""
        if self.n_kf_host >= self.arena.kmax - 1:
            # Saturated: request a compaction pass (it recycles culled slots,
            # as KeyFrame::SetBadFlag frees them in the reference) at the next
            # pipeline-quiescent point; until then, no new keyframes.
            self._compact_requested = True
            if not self.pipeline:
                self._maybe_compact()
            return False
        # enforce a small minimum gap unless tracking is nearly lost (the
        # reference's busy-LocalMapping backpressure has no counterpart)
        need_close = close_tracked < 100 and close_untracked > 70 and \
            (self.frames_since_kf >= 3 or n_inl < 40)
        c1a = self.frames_since_kf >= self.cfg.camera.fps   # mMaxFrames
        # thRefRatio: 0.75 for RGB-D and stereo, 0.9 for monocular
        # (Tracking.cc:1369-1374), from the sensor, not from a frame's depth
        mono = self.sensor_mono
        ratio = 0.9 if mono else 0.75
        # the mono analogue of c1b (Tracking.cc:1355, mMinFrames 0 and an idle
        # mapper): the reference inserts mono keyframes densely and culls the
        # redundant ones later; a fixed fps / 3 cadence replaces the busy flag
        if mono and self.frames_since_kf >= max(3, int(self.cfg.camera.fps) // 3) \
                and n_inl > 15:
            return True
        c2 = (n_inl < ratio * max(self.ref_kf_matches, 1) or need_close) \
            and n_inl > 15
        return c2 or (c1a and n_inl > 15)

    def _record(self, timestamp, T_cw, lost: bool):
        T_cr = T_cw @ lie.se3_inverse(self.arena.kf_pose[self.ref_kf])
        self.records.append((float(timestamp), self.ref_kf, T_cr, lost))

    # -- trajectory export ---------------------------------------------------
    def camera_trajectory(self) -> list[tuple[float, np.ndarray]]:
        """(timestamp, T_wc) per tracked frame, recomputed through reference
        keyframes (System::SaveTrajectoryTUM, System.cc:418-476). Call
        flush() first when pipelined."""
        kept = [r for r in self.records if not r[3]]
        if not kept:
            return []
        kf_pose = self.arena.kf_pose.cpu().numpy()
        T_cr = torch.stack([r[2] for r in kept]).cpu().numpy()
        return [(ts, np.linalg.inv(T_cr[i] @ kf_pose[ref]))
                for i, (ts, ref, _, _) in enumerate(kept)]

    def keyframe_trajectory(self) -> list[tuple[float, np.ndarray]]:
        n = int(self.arena.n_kf)
        poses = lie.se3_inverse(self.arena.kf_pose[:n]).cpu().numpy()
        valid = self.arena.kf_valid[:n].cpu().numpy()
        times = self.arena.kf_time[:n].cpu().numpy().astype(np.float64)
        for i in range(min(n, len(self.kf_timestamps))):
            times[i] = self.kf_timestamps[i]
        return [(float(times[i]), poses[i]) for i in range(n) if valid[i]]
