"""Tracking front-end: the per-frame state machine (port of
gdslam_tpu.system.tracking).

Re-design of the reference Tracking class (Tracking.cc:408-652 `Track`,
762-815 `StereoInitialization`, 1196-1257 `TrackWithMotionModel`,
1259-1303 `TrackLocalMap`, 1306-1470 keyframe decision/creation): a thin
host state machine drives tensor programs against the fixed-shape
MapArena. Host branching happens at frame granularity.

This slice runs the non-pipelined RGB-D tracker with the keyframe program
reduced to fuse -> insert -> refresh -> cull (no triangulation, no local
BA). The pipelined commit protocol, relocalization, loop closing and
keyframe-arena compaction raise NotImplementedError (see ROADMAP.md), so a
frame that loses tracking fails loudly instead of departing from the
reference.
"""

from __future__ import annotations

import enum
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend import mapping, optimizer
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import camera as cam_ops
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend import extractor, matcher
from gdslam_tpu_torch.frontend.frame import Frame, build_frame

LOCAL_POINT_CAP = 4096   # dense local-map candidate budget


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gdslam_tpu_torch yet; see ROADMAP.md")


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
                     max_depth: float | None = None):
    """Insert keyframe + create map points for unmatched close-depth
    keypoints, or any among the 100 nearest (CreateNewKeyFrame,
    Tracking.cc:1392-1470). Only created rows are written to the point
    arrays, apart from slot 0 (see below)."""
    cam = cfg.camera
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

    # The created rows are written, then slot 0 gets its old value back
    # unless the highest-index row with slot == 0 creates a point. That
    # reproduces the JAX package as its tests run it: its scatter
    # (gdslam_tpu/system/tracking.py:112, :124-126) sends every row that
    # creates nothing to slot 0 carrying slot 0's old value, and XLA on the
    # CPU applies duplicate indices in row order, so the first keyframe's
    # point in slot 0 is lost unless its keypoint is the last such row. A
    # scatter with duplicates has no order on the card, hence the explicit
    # rule (no host read).
    rows = torch.arange(slot.shape[0], device=slot.device)
    last0 = torch.where(slot == 0, rows, -1).amax()
    restore0 = (last0 >= 0) & ~create[last0.clamp(min=0)]

    def scatter(dst, src):
        out = ma.scatter_rows(dst, slot, src, create)
        out[0] = torch.where(restore0, dst[0], out[0])
        return out

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
                     use_triangulation: bool, use_ba: bool):
    """Keyframe insertion: proactive fuse -> insert -> descriptor/normal
    refresh -> point culling -> reference-match statistic.
    Returns (arena, assoc, T_refined, ref_matches)."""
    if use_triangulation:
        raise _not_ported("epipolar triangulation (use_triangulation=True)")
    if use_ba:
        raise _not_ported("local bundle adjustment (use_ba=True)")
    assoc = fuse_associate(arena, frame, T_cw, assoc, cfg)
    arena, assoc = _insert_keyframe(arena, frame, T_cw, assoc, timestamp, cfg)
    kf_id = int(arena.n_kf) - 1
    arena = mapping.refresh_points(arena, kf_id, cfg)
    arena = cull_points(arena)
    n_kf = kf_id + 1
    min_obs = 3 if n_kf > 2 else (2 if n_kf == 2 else 1)
    return arena, assoc, T_cw, ref_tracked_points(arena, kf_id, min_obs)


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
                       radius_px: float = 15.0):
    """Frame-to-frame tracking (TrackWithMotionModel, Tracking.cc:1196-1257):
    dense projection search of the last frame's keypoints that have a map
    point, with radius radius_px*scale^level, then pose GN. (The JAX
    package's temporal_points, depth-backprojection candidates for
    localization mode, come with that mode.)"""
    cam = cfg.camera
    sf = float(cfg.orb.scale_factor)
    lf = last.frame
    cand_valid = lf.valid & (last.assoc >= 0)
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
               mask: torch.Tensor, cfg: SlamConfig, ref_kf: int):
    """The per-frame program: extraction -> frame build -> track_frame_core."""
    cam = cfg.camera
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    frame = build_frame(feats, depth, mask, cam)
    return track_frame_core(arena, last, velocity, has_velocity, frame, cfg, ref_kf)


def track_frame_core(arena: ma.MapArena, last: FrameState, velocity: torch.Tensor,
                     has_velocity: bool, frame: Frame, cfg: SlamConfig,
                     ref_kf: int):
    """Frame-level tracking core: motion-model match + pose GN (with a
    wide-radius retry when it finds < 10 inliers), then local-map match +
    pose GN, the velocity and the keyframe statistics.

    Returns (arena, FrameState, velocity, T_cr, stats [n1, n2,
    close_tracked, close_untracked]). The retry decision reads n1 on the
    host (the JAX package decides on the device with lax.cond)."""
    cam = cfg.camera
    lf = last.frame
    pc = cam_ops.backproject(lf.uv, lf.depth, cam)
    pw_depth = lie.se3_apply(lie.se3_inverse(last.T_cw), pc)
    has_pt = last.assoc >= 0
    pt_rows = torch.where(has_pt, last.assoc, 0).long()
    pts_w = torch.where(has_pt[:, None], arena.pt_pos[pt_rows], pw_depth)

    T_pred = velocity @ last.T_cw if has_velocity else last.T_cw
    T1, assoc1, n1, _ = track_motion_model(last, pts_w, frame, T_pred, cfg)
    if int(n1) < 10:
        T1, assoc1, n1, _ = track_motion_model(last, pts_w, frame, last.T_cw, cfg,
                                               radius_px=30.0)

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

class Tracking:
    """Host-side tracker mirroring the reference Tracking state machine
    (non-pipelined: one scalar read-back per frame).

    `use_local_ba` and `use_triangulation` default to False here because
    those keyframe stages are not ported yet; setting either to True makes
    the keyframe program raise NotImplementedError.
    """

    def __init__(self, cfg: SlamConfig, kmax: int = 512, pmax: int = 65536,
                 pipeline: bool = False, device="cuda"):
        if pipeline:
            raise _not_ported("the pipelined commit protocol (pipeline=True)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.arena = ma.new_arena(kmax, pmax, cfg.orb.n_features, self.device)
        self.pipeline = False
        self.use_local_ba: bool = False     # LocalMapping's BA stage
        self.use_triangulation: bool = False  # CreateNewMapPoints stage
        self.arena_full_warned = False
        self._eye4 = torch.eye(4, device=self.device)
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
        # Keyframe timestamps live host-side (float32 cannot hold TUM epoch
        # seconds); list index == arena kf slot.
        self.kf_timestamps: list[float] = []

    @property
    def loop_closer(self):
        return None

    @loop_closer.setter
    def loop_closer(self, value):
        if value is not None:
            raise _not_ported("loop closing")

    @property
    def n_kf_host(self) -> int:
        """Keyframe count without a device sync."""
        return len(self.kf_timestamps)

    def _do_keyframe(self, frame: Frame, T, assoc, timestamp: float):
        """The LocalMapping duties at keyframe insertion in one program, then
        the host bookkeeping. Returns (assoc, T_refined)."""
        new_n_kf = self.n_kf_host + 1
        self.arena, assoc, T_out, ref_m = keyframe_program(
            self.arena, frame, T, assoc, timestamp, self.cfg,
            self.use_triangulation, self.use_local_ba and new_n_kf >= 3)
        self._note_keyframe(timestamp)
        self.ref_kf = new_n_kf - 1
        self.ref_kf_matches = int(ref_m)
        self.frames_since_kf = 0
        return assoc, T_out

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

    def reset(self):
        """Tracking::Reset (Tracking.cc:1834-1880): wipe the map, trajectory
        records and state; the system re-initializes from the next frame."""
        self.arena = ma.new_arena(self.arena.kmax, self.arena.pmax,
                                  self.cfg.orb.n_features, self.device)
        self.arena_full_warned = False
        self._clear()

    def _on_lost(self, timestamp: float, T_last):
        """LOST handling incl. the early-loss auto-reset: LOST with <= 5
        keyframes wipes and restarts (Tracking.cc:618-626)."""
        self.state = TrackState.LOST
        self._record(timestamp, T_last, lost=True)
        if self.n_kf_host <= 5:
            self.reset()

    def _relocalize(self, frame: Frame):
        raise _not_ported("relocalization (tracking was lost)")

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def process(self, gray, depth, mask, timestamp: float) -> np.ndarray:
        """Track one RGB-D frame (gray [H, W], depth [H, W] meters, mask
        [H, W] 1 = static). Returns the 4x4 T_cw estimate."""
        cfg = self.cfg
        cam = cfg.camera
        gray, depth, mask = self._tensor(gray), self._tensor(depth), self._tensor(mask)

        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
            frame = build_frame(feats, depth, mask, cam)
            # Reference gate: >500 keypoints of a 1500 budget (Tracking.cc:
            # 767), scaled to small rigs as a quarter of the budget.
            if int(frame.valid.sum()) >= min(cfg.tracking.min_init_features,
                                             cfg.orb.n_features // 4):
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
            return np.eye(4, dtype=np.float32)

        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else self._eye4
        arena2, new_last, vel_new, T_cr, stats = track_step(
            self.arena, self.last, vel, has_vel, gray, depth, mask, cfg,
            self.ref_kf)
        n1, n_inl, close_tracked, close_untracked = stats.tolist()
        frame = new_last.frame
        if n1 >= 10 and n_inl >= 30:
            self.arena = arena2
            T, assoc = new_last.T_cw, new_last.assoc
        else:
            ok, T, assoc, n_inl = self._relocalize(frame)
            if not ok:
                T_last = self.last.T_cw
                self._on_lost(timestamp, T_last)
                return T_last.cpu().numpy()
            vel_new = None
            T_cr = T @ lie.se3_inverse(self.arena.kf_pose[self.ref_kf])

        self.velocity = vel_new
        self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
        self.state = TrackState.OK
        self.frames_since_kf += 1
        self.records.append((float(timestamp), self.ref_kf, T_cr, False))

        if self._need_keyframe_stats(n_inl, close_tracked, close_untracked):
            assoc, T = self._do_keyframe(frame, T, assoc, timestamp)
            self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
        return T.cpu().numpy()

    def _need_keyframe_stats(self, n_inl: int, close_tracked: int,
                             close_untracked: int) -> bool:
        """NeedNewKeyFrame rules for RGB-D (Tracking.cc:1306-1390)."""
        if self.n_kf_host >= self.arena.kmax - 1:
            raise _not_ported("keyframe-arena compaction (the arena is full; "
                              "construct Tracking with a larger kmax)")
        # enforce a small minimum gap unless tracking is nearly lost (the
        # reference's busy-LocalMapping backpressure has no counterpart)
        need_close = close_tracked < 100 and close_untracked > 70 and \
            (self.frames_since_kf >= 3 or n_inl < 40)
        c1a = self.frames_since_kf >= self.cfg.camera.fps   # mMaxFrames
        ratio = 0.75                                        # thRefRatio (RGB-D)
        c2 = (n_inl < ratio * max(self.ref_kf_matches, 1) or need_close) \
            and n_inl > 15
        return c2 or (c1a and n_inl > 15)

    def _record(self, timestamp, T_cw, lost: bool):
        T_cr = T_cw @ lie.se3_inverse(self.arena.kf_pose[self.ref_kf])
        self.records.append((float(timestamp), self.ref_kf, T_cr, lost))

    # -- trajectory export ---------------------------------------------------
    def camera_trajectory(self) -> list[tuple[float, np.ndarray]]:
        """(timestamp, T_wc) per tracked frame, recomputed through reference
        keyframes (System::SaveTrajectoryTUM, System.cc:418-476)."""
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
