"""Loop detection, Sim3/SE3 computation and loop correction (port of
gdslam_tpu.backend.loop_closing).

Re-design of the reference LoopClosing thread (LoopClosing.cc): detect
candidates by BoW (DetectLoop :103-230), verify them geometrically with a
RANSAC similarity solver and guided matching (ComputeSim3 :231-400), then
correct: propagate the loop transform to the covisible group, fuse, and
optimise the essential graph and the whole map (CorrectLoop :402-585,
645-750). It runs synchronously at keyframe rate.

The host keeps the candidate-consistency state machine and reads a few
scalars per keyframe: the candidates of `detect` in one copy and the
covisibility entries of its streak check in another, as the JAX package
batches them, and the verification's gates. Every matching step runs the
hand kernel `match_top2`: the BoW-guided match (`_bow_guided_matches`, its
same-word mask written as a search window), both SearchBySim3 growths and
the loop-point projection of `_sim3_verify_program`.
"""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.backend import gba, mapping, pose_graph, solvers
from gdslam_tpu_torch.backend import keyframe_db as kdb
from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend import vocabulary as voc
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import camera as cam_ops
from gdslam_tpu_torch.core import lie, prng
from gdslam_tpu_torch.frontend import matcher
from gdslam_tpu_torch.frontend.extractor import top_k_stable
from gdslam_tpu_torch.ops.match_kernel import BIG, match_top2

MIN_KF_GAP = 10          # >= 10 keyframes since the last loop (LoopClosing.cc:110)
CONSISTENCY_TH = 3       # consecutive consistent detections (cc:43)
MIN_BOW_MATCHES = 20     # ComputeSim3 entry gate (cc:262)
MIN_ACCEPT_MATCHES = 40  # final acceptance (cc:395)


def _bow_guided_matches(desc_a, valid_a, words_a, desc_b, valid_b, words_b):
    """SearchByBoW-style matching (ORBmatcher.cc:522): per keypoint of a,
    the keypoint of b with the least Hamming distance among those of the
    same vocabulary word, a ratio test of 0.75 and an absolute gate of 50.
    Returns ([N_a] int32 index into b or -1, the number of matches).

    The JAX function masks a dense cost by word equality. Here the word is
    a coordinate: keypoints at (word, 0), a window of radius 0.5, one level
    with no slack. Distinct words are >= 1 apart and a word id is exact in
    float32, so the window holds exactly the same-word pairs, and
    `match_top2` returns the dense cost's best, second (counting equal
    costs) and lowest best row, with the same 1 << 20 sentinel."""
    def at_word(words):
        return torch.stack([words.float(), torch.zeros_like(words, dtype=torch.float32)], 1)

    zeros_b = torch.zeros_like(words_b, dtype=torch.int32)
    best, second, arg, _ = match_top2(
        at_word(words_b), desc_b.contiguous(), torch.full_like(words_b, 0.5, dtype=torch.float32),
        zeros_b, (valid_b & (words_b >= 0)).contiguous(),
        at_word(words_a), desc_a.contiguous(), torch.zeros_like(words_a, dtype=torch.int32),
        (valid_a & (words_a >= 0)).contiguous(), 0)
    good = (best < 50) & (best.float() < 0.75 * second.clamp(max=BIG).float())
    return torch.where(good, arg, -1), good.sum()


def _inv_sigma2(level: torch.Tensor, scale: float) -> torch.Tensor:
    return 1.0 / (scale ** (2.0 * level.float()))


def _kf_points_cam(arena: ma.MapArena, kf: int, cfg: SlamConfig):
    """Per-keypoint 3D in the keyframe's camera: its map point through the
    keyframe pose where it has one (the reference's vpMapPoints,
    ORBmatcher.cc:1110-1130), else the depth backprojection. Returns
    (X [N, 3], has3d [N])."""
    obs = arena.kf_obs[kf]
    rows = obs.clamp(min=0).long()
    has_pt = (obs >= 0) & arena.pt_valid[rows]
    X_map = lie.se3_apply(arena.kf_pose[kf], arena.pt_pos[rows])
    z = arena.kf_depth[kf]
    X = torch.where(has_pt[:, None], X_map, cam_ops.backproject(arena.kf_uv[kf], z, cfg.camera))
    return X, arena.kf_kp_valid[kf] & (has_pt | (z > 0))


def _project(Xc: torch.Tensor, cfg: SlamConfig):
    cam = cfg.camera
    z = Xc[..., 2].clamp(min=1e-6)
    uv = torch.stack([cam.fx * Xc[..., 0] / z + cam.cx, cam.fy * Xc[..., 1] / z + cam.cy], -1)
    return uv, Xc[..., 2] > 0


def _in_image(uv: torch.Tensor, zok: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    cam = cfg.camera
    return zok & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) & \
        (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)


def _search_by_sim3(X_other, has_other, desc_other, lvl_other, R, t, s, uv, has, desc, lvl,
                    angle, cfg: SlamConfig):
    """One direction of SearchBySim3 (ORBmatcher.cc:1102-1219): the other
    keyframe's 3D keypoints projected through (R, t, s) and searched among
    this keyframe's keypoints in a window of 7.5 x scale^level."""
    radius = 7.5 * float(cfg.orb.scale_factor) ** lvl_other.float()
    uv_p, zok = _project(lie.sim3_apply(R, t, s, X_other), cfg)
    return matcher.match_candidates(
        uv_p, has_other & _in_image(uv_p, zok, cfg), desc_other, lvl_other,
        torch.zeros_like(radius), radius, uv, has, desc, lvl, angle,
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=False)


def _search_loop_points(arena: ma.MapArena, kf_id: int, loop_pt_mask, Rcw, tcw, scw,
                        cfg: SlamConfig):
    """The loop map points projected into the current keyframe through the
    corrected pose and matched (LoopClosing.cc:355-400 SearchByProjection):
    the 4096 most observed points of the candidate's group, radius 10."""
    cap = min(4096, arena.pmax)
    score = torch.where(loop_pt_mask & arena.pt_valid, 1.0 + arena.pt_n_obs.float(), 0.0)
    cand_ids = top_k_stable(score, cap)[1]
    uv_p, zok = _project(lie.sim3_apply(Rcw, tcw, scw, arena.pt_pos[cand_ids]), cfg)
    pvalid = loop_pt_mask[cand_ids] & arena.pt_valid[cand_ids] & _in_image(uv_p, zok, cfg)
    dev = uv_p.device
    return matcher.match_candidates(
        uv_p, pvalid, arena.pt_desc[cand_ids], torch.zeros(cap, dtype=torch.int32, device=dev),
        torch.zeros(cap, device=dev), torch.full((cap,), 10.0, device=dev),
        arena.kf_uv[kf_id], arena.kf_kp_valid[kf_id], arena.kf_desc[kf_id],
        arena.kf_level[kf_id], arena.kf_angle[kf_id], th_hamming=matcher.TH_LOW,
        level_slack=8, use_rotation=False)


def _sim3_verify_program(arena: ma.MapArena, kf_id: int, cand: int, S12, bow_idx,
                         loop_pt_mask, cfg: SlamConfig, with_scale: bool = False):
    """The ComputeSim3 verification tail with no host read: SearchBySim3
    mutual match growth through the hypothesis (ORBmatcher.cc:1102-1219),
    OptimizeSim3 with Huber and chi2 inlier erasure (Optimizer.cc:1262-1391),
    then the loop-map-point projection count that the final >= 40
    acceptance is taken over (LoopClosing.cc:355-400, nTotalMatches).

    S12 = (R, t, s) maps candidate-camera coordinates into the current
    camera; bow_idx: per current keypoint the candidate keypoint of the BoW
    match (-1 none); loop_pt_mask: [pmax] the points of the candidate's
    covisible group. Returns (R, t, s, n_opt_inliers, n_total_matches)."""
    cam = cfg.camera
    sf = float(cfg.orb.scale_factor)
    R12, t12, s12 = S12
    X1, has1 = _kf_points_cam(arena, kf_id, cfg)
    X2, has2 = _kf_points_cam(arena, cand, cfg)
    uv1, uv2 = arena.kf_uv[kf_id], arena.kf_uv[cand]
    lvl1, lvl2 = arena.kf_level[kf_id], arena.kf_level[cand]
    d1, d2 = arena.kf_desc[kf_id], arena.kf_desc[cand]

    # SearchBySim3 growth in both directions, kept where they agree (cc:1207)
    mA = _search_by_sim3(X2, has2, d2, lvl2, R12, t12, s12, uv1, has1, d1, lvl1,
                         arena.kf_angle[kf_id], cfg)
    mB = _search_by_sim3(X1, has1, d1, lvl1, *lie.sim3_inverse(R12, t12, s12), uv2, has2, d2,
                         lvl2, arena.kf_angle[cand], cfg)
    j_of_i = mA.point_idx
    i_back = mB.point_idx[j_of_i.clamp(min=0).long()]
    mutual = (j_of_i >= 0) & (i_back == torch.arange(j_of_i.shape[0], device=j_of_i.device))
    # union with the BoW matches, which win where both exist (the growth only
    # adds matches in the reference, cc:1150)
    idx2 = torch.where(bow_idx >= 0, bow_idx, torch.where(mutual, j_of_i, -1))
    rows2 = idx2.clamp(min=0).long()
    valid = (idx2 >= 0) & has1 & has2[rows2]

    Rn, tn, sn, inl, n_opt = solvers.optimize_sim3(
        X1, X2[rows2], uv1, uv2[rows2], _inv_sigma2(lvl1, sf), _inv_sigma2(lvl2[rows2], sf),
        valid, (R12, t12, s12), (cam.fx, cam.fy, cam.cx, cam.cy), with_scale)
    if with_scale:
        # the scale is weakly observable in image space; the 3D-3D alignment
        # over the refined inliers constrains it strongly
        Rn, tn, sn = solvers.horn_alignment(X2[rows2], X1, (inl & valid).float(),
                                            with_scale=True)

    # the corrected current pose Scw = S12 o T_cand_w (LoopClosing.cc:341)
    Tc = arena.kf_pose[cand]
    Rcw, tcw, scw = lie.sim3_compose(Rn, tn, sn, Tc[:3, :3], Tc[:3, 3], 1.0)
    mP = _search_loop_points(arena, kf_id, loop_pt_mask, Rcw, tcw, scw, cfg)
    # nTotalMatches: keypoints matched by projection or already Sim3 inliers
    n_total = ((mP.point_idx >= 0) | (inl & valid)).sum()
    return Rn, tn, sn, n_opt, n_total


def _points_of(arena: ma.MapArena, kf_rows: torch.Tensor) -> torch.Tensor:
    """[pmax] bool: the points observed by the keyframes kf_rows [K] bool."""
    P = arena.pmax
    obs = arena.kf_obs
    hit = kf_rows[:, None] & (obs >= 0)
    ind = torch.zeros(P + 1, dtype=torch.bool, device=obs.device)
    ind[torch.where(hit, obs, P).reshape(-1).long()] = True
    return ind[:P]


class LoopCloser:
    """The loop-closing state for one map: the BoW keyframe database, the
    candidate-consistency streaks and the closed loops."""

    def __init__(self, cfg: SlamConfig, vocab: voc.Vocabulary, kmax: int, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab = vocab.to(self.device)
        self.db = kdb.new_db(kmax, cfg.orb.n_features, vocab.n_leaves, self.device)
        self.last_loop_kf = -MIN_KF_GAP
        self._consistent: dict[int, int] = {}   # candidate group -> streak
        self.loops: list = []                   # (cur, cand, T_meas [4, 4] on the device)
        # bFixScale (Sim3Solver.h:20): True for RGB-D and stereo, False for
        # monocular; System sets it from the sensor
        self.fix_scale = True
        self.last_sim3 = None   # (R, t, s) of the last accepted loop, on the device

    def reset(self):
        """Clear the keyframe database and the consistency state (the
        LoopClosing side of System::Reset -> KeyFrameDatabase::clear)."""
        self.db = kdb.new_db(self.db.words.shape[0], self.cfg.orb.n_features,
                             self.vocab.n_leaves, self.device)
        self.last_loop_kf = -MIN_KF_GAP
        self._consistent = {}
        self.loops = []

    def words_of(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        v = self.vocab
        return torch.where(valid, voc.transform(desc, v.centers, v.k, v.levels), -1)

    def add_keyframe(self, arena: ma.MapArena, kf_id: int):
        words = self.words_of(arena.kf_desc[kf_id], arena.kf_kp_valid[kf_id])
        vec = voc.bow_vector(words, words >= 0, self.vocab.n_leaves)
        self.db = kdb.db_add(self.db, kf_id, vec, words)

    def detect(self, arena: ma.MapArena, kf_id: int) -> list[int]:
        """DetectLoop's host logic with consistency streaks: every candidate
        whose streak reached CONSISTENCY_TH (mvpEnoughConsistentCandidates,
        LoopClosing.cc:150-230), in the order ComputeSim3 tries them. Two
        reads: the candidates and their scores in one copy, then the
        covisibility entries the streak check needs."""
        if kf_id - self.last_loop_kf < MIN_KF_GAP:
            return []
        ids, scores, min_score = kdb.loop_candidates(self.db, arena, kf_id)
        got = torch.cat([ids.double(), scores.double(), min_score.double()[None]]).tolist()
        n = ids.shape[0]
        ids, scores, min_score = got[:n], got[n:2 * n], got[2 * n]
        cand: list[int] = []
        for i, s in zip(ids, scores):
            if s > max(min_score, 1e-6) and i >= 0 and int(i) not in cand:
                cand.append(int(i))
        # a candidate (or its covisible neighbourhood) must recur for
        # CONSISTENCY_TH consecutive keyframes; group consistency follows the
        # covisibility graph (edges of weight >= 15)
        prev_ids = list(self._consistent.keys())
        covis_sub = None
        if cand and prev_ids:
            # the candidates' rows in one copy (indexing the card with a host
            # list would upload it, a second wait)
            rows = torch.stack([arena.covis[c] for c in cand]).cpu().numpy()
            covis_sub = rows[:, prev_ids]
        new_streaks: dict[int, int] = {}
        accepted: list[int] = []
        for ci, c in enumerate(cand):
            streak = 1
            for pi, (prev, s) in enumerate(self._consistent.items()):
                if prev == c or covis_sub[ci, pi] >= 15:
                    streak = max(streak, s + 1)
            new_streaks[c] = streak
            if streak >= CONSISTENCY_TH:
                accepted.append(c)
        self._consistent = new_streaks
        return accepted

    def compute_transform(self, arena: ma.MapArena, kf_id: int, cand: int):
        """ComputeSim3 (LoopClosing.cc:231-400): BoW matches -> Sim3 RANSAC
        -> SearchBySim3 growth -> OptimizeSim3 (>= 20 refined inliers,
        cc:371) -> loop-map-point projection with the final >= 40 acceptance
        (cc:395). Returns (ok, T_cur_cand [4, 4] or None, n_matches): T maps
        candidate-camera coordinates into the current camera (the scale
        folded into its rotation part; the raw (R, t, s) is kept in
        last_sim3). Three reads: the BoW match count, the RANSAC's verdict,
        the verification's counts."""
        cfg, cam = self.cfg, self.cfg.camera
        m_idx, n_m = _bow_guided_matches(
            arena.kf_desc[kf_id], arena.kf_kp_valid[kf_id], self.db.words[kf_id],
            arena.kf_desc[cand], arena.kf_kp_valid[cand], self.db.words[cand])
        if int(n_m) < MIN_BOW_MATCHES:
            return False, None, 0
        # 3D per matched keypoint in each camera: the observed map point
        # where there is one, else the depth (Sim3Solver.cc:40-60)
        rows = m_idx.clamp(min=0).long()
        Q_cur, has_a = _kf_points_cam(arena, kf_id, cfg)
        P_all, has_b = _kf_points_cam(arena, cand, cfg)
        ok = (m_idx >= 0) & has_a & has_b[rows]
        with_scale = not self.fix_scale
        px = 3.04 * float(cfg.orb.scale_factor) ** torch.maximum(
            arena.kf_level[kf_id], arena.kf_level[cand][rows]).float()
        R, t, s, _, n_inl, okflag = solvers.ransac_sim3(
            P_all[rows], Q_cur, ok, n_iters=300, min_inliers=MIN_BOW_MATCHES,
            err_threshold=0.10, with_scale=with_scale, uv_p=arena.kf_uv[cand][rows],
            uv_q=arena.kf_uv[kf_id], K=(cam.fx, cam.fy, cam.cx, cam.cy), px_threshold=px,
            key=prng.prng_key(kf_id))        # the JAX package's draw, PRNGKey(kf_id)
        okflag, n_inl = torch.stack([okflag.int(), n_inl.int()]).tolist()
        if not okflag:
            return False, None, n_inl
        Rn, tn, sn, n_opt, n_total = _sim3_verify_program(
            arena, kf_id, cand, (R, t, s), m_idx, self.loop_point_mask(arena, cand), cfg,
            with_scale)
        n_opt, n_total = torch.stack([n_opt.int(), n_total.int()]).tolist()
        if n_opt < MIN_BOW_MATCHES or n_total < MIN_ACCEPT_MATCHES:
            return False, None, n_total
        self.last_sim3 = (Rn, tn, sn)
        return True, lie.rt_to_mat(sn * Rn, tn), n_total

    @staticmethod
    def loop_point_mask(arena: ma.MapArena, cand: int) -> torch.Tensor:
        """[pmax] bool: the map points observed by the candidate's covisible
        group (mvpLoopMapPoints, LoopClosing.cc:305-320)."""
        ids = torch.arange(arena.kmax, device=arena.covis.device)
        return _points_of(arena, ((arena.covis[cand] > 0) | (ids == cand)) & arena.kf_valid)

    def _group(self, arena: ma.MapArena, kf_id: int) -> torch.Tensor:
        ids = torch.arange(arena.kmax, device=arena.covis.device)
        return ((arena.covis[kf_id] > 0) | (ids == kf_id)) & arena.kf_valid

    def _loop_edge(self, kf_id: int, cand: int):
        dev = self.device
        return (torch.full((1,), kf_id, dtype=torch.int64, device=dev),
                torch.full((1,), cand, dtype=torch.int64, device=dev),
                torch.ones(1, dtype=torch.bool, device=dev))

    def correct(self, arena: ma.MapArena, kf_id: int, cand: int,
                T_cur_cand: torch.Tensor) -> ma.MapArena:
        """CorrectLoop: the current keyframe's pose through the loop
        constraint, propagated to its covisible group and their points, then
        the essential graph (Optimizer.cc:997-1260), the seam fusion and
        global BA. With fix_scale False (monocular) it runs over Sim3
        (`_correct_sim3`)."""
        if not self.fix_scale and self.last_sim3 is not None:
            return self._correct_sim3(arena, kf_id, cand)
        # the essential graph's edges are measured on the poses before any
        # propagation (NonCorrectedSim3, LoopClosing.cc:438-470); the loop
        # edge alone carries the RANSAC measurement
        pose_pre = arena.kf_pose
        T_corr = T_cur_cand @ arena.kf_pose[cand]
        T_old = arena.kf_pose[kf_id]
        group = self._group(arena, kf_id)
        # each group pose keeps its transform to the current keyframe
        corrected = arena.kf_pose @ lie.se3_inverse(T_old) @ T_corr
        M = lie.se3_inverse(T_corr) @ T_old
        arena = arena._replace(
            kf_pose=torch.where(group[:, None, None], corrected, arena.kf_pose),
            pt_pos=torch.where(_points_of(arena, group)[:, None],
                               lie.se3_apply(M, arena.pt_pos), arena.pt_pos))

        loop_i, loop_j, loop_valid = self._loop_edge(kf_id, cand)
        loop_T = T_cur_cand[None]
        edges = pose_graph.build_edges(pose_pre, arena.kf_valid, arena.kf_parent, arena.covis,
                                       loop_i, loop_j, loop_T, loop_valid)
        new_kf_pose = pose_graph.optimize(arena.kf_pose, arena.kf_valid, edges)

        # each point moves with its reference keyframe's pose change
        ref = arena.pt_ref_kf.clamp(0, arena.kmax - 1).long()
        M_pt = lie.se3_inverse(new_kf_pose[ref]) @ arena.kf_pose[ref]
        arena = arena._replace(
            kf_pose=new_kf_pose,
            pt_pos=torch.where(arena.pt_valid[:, None], lie.se3_apply(M_pt, arena.pt_pos),
                               arena.pt_pos))
        return self._finish_correct(arena, kf_id, cand, T_cur_cand)

    def _correct_sim3(self, arena: ma.MapArena, kf_id: int, cand: int) -> ma.MapArena:
        """The monocular CorrectLoop: Sim3 propagation, the 7-dof essential
        graph and the scale-aware write-back of poses and points."""
        R12, t12, s12 = self.last_sim3
        pose_pre = arena.kf_pose
        K = arena.kmax
        Tc = arena.kf_pose[cand]
        Rcw, tcw, scw = lie.sim3_compose(R12, t12, s12, Tc[:3, :3], Tc[:3, 3], 1.0)
        T_old = arena.kf_pose[kf_id]
        # the group's vertices S_i = (T_i o T_old^-1) o S_corr (CorrectedSim3);
        # the others keep their SE3 pose at scale 1
        group = self._group(arena, kf_id)
        rel = arena.kf_pose @ lie.se3_inverse(T_old)
        Rg = rel[:, :3, :3] @ Rcw
        tg = (rel[:, :3, :3] @ tcw[:, None])[..., 0] + rel[:, :3, 3]
        R_p = torch.where(group[:, None, None], Rg, pose_pre[:, :3, :3])
        t_p = torch.where(group[:, None], tg, pose_pre[:, :3, 3])
        s_p = torch.where(group, scw, 1.0)
        # the group's points move with the one Sim3 M = S_corr^-1 o T_old
        Rm, tm, sm = lie.sim3_compose(*lie.sim3_inverse(Rcw, tcw, scw), T_old[:3, :3],
                                      T_old[:3, 3], 1.0)
        arena = arena._replace(pt_pos=torch.where(
            _points_of(arena, group)[:, None], lie.sim3_apply(Rm, tm, sm, arena.pt_pos),
            arena.pt_pos))
        # 7-dof essential graph, initialised at the propagated vertices
        loop_i, loop_j, loop_valid = self._loop_edge(kf_id, cand)
        edges = pose_graph.build_edges(pose_pre, arena.kf_valid, arena.kf_parent, arena.covis,
                                       loop_i, loop_j, lie.rt_to_mat(R12, t12)[None], loop_valid,
                                       loop_s=s12.reshape(1))
        R_n, t_n, s_n = pose_graph.optimize_sim3_graph(R_p, t_p, s_p, arena.kf_valid, edges,
                                                       fix_scale=False)
        # each point moves with its reference keyframe's Sim3 change,
        # x' = S_ref_new^-1(S_ref_prop(x)) (Optimizer.cc:1225-1250)
        ref = arena.pt_ref_kf.clamp(0, K - 1).long()
        Rpt, tpt, spt = lie.sim3_compose(*lie.sim3_inverse(R_n[ref], t_n[ref], s_n[ref]),
                                         R_p[ref], t_p[ref], s_p[ref])
        new_pts = lie.sim3_apply(Rpt, tpt, spt, arena.pt_pos)
        # SE3 write-back [R | t / s] (Optimizer.cc:1235)
        new_kf_pose = lie.rt_to_mat(R_n, t_n / s_n[:, None])
        arena = arena._replace(
            kf_pose=torch.where(arena.kf_valid[:, None, None], new_kf_pose, arena.kf_pose),
            pt_pos=torch.where(arena.pt_valid[:, None], new_pts, arena.pt_pos))
        return self._finish_correct(arena, kf_id, cand, lie.rt_to_mat(s12 * R12, t12))

    def _finish_correct(self, arena: ma.MapArena, kf_id: int, cand: int,
                        T_meas: torch.Tensor) -> ma.MapArena:
        # SearchAndFuse (LoopClosing.cc:525-560): with the poses corrected,
        # fuse the map into the current keyframe and its best covisible
        # neighbours, merging the duplicate landmarks across the seam
        w = arena.covis[kf_id].cpu().numpy()
        nbrs = [kf_id] + [int(k) for k in np.argsort(-w)[:4] if w[k] > 0]
        for k in nbrs:
            arena, _ = mapping.fuse_into_keyframe(arena, k, self.cfg)
        # global BA after the loop (RunGlobalBundleAdjustment,
        # LoopClosing.cc:645-750), synchronous here
        arena = gba.global_bundle_adjustment(arena, self.cfg, gate_outliers=True)
        self.last_loop_kf = kf_id
        self.loops.append((kf_id, cand, T_meas))
        self._consistent = {}
        return arena

    def process_keyframe(self, arena: ma.MapArena, kf_id: int) -> ma.MapArena:
        """The per-keyframe loop-closing step (the Run loop body): every
        consistent candidate is verified in turn, and the first to pass
        closes the loop (LoopClosing.cc:231-400 iterates the candidates)."""
        self.add_keyframe(arena, kf_id)
        for cand in self.detect(arena, kf_id):
            ok, T, _ = self.compute_transform(arena, kf_id, cand)
            if ok:
                return self.correct(arena, kf_id, cand, T)
        return arena

    def remap(self, perm: np.ndarray, new_of_old: np.ndarray, n_keep: int):
        """Follow a keyframe compaction (map_arena.compact_keyframes): the
        database rows move with their keyframes, the consistency anchors are
        dropped (they name old slots), the loops are renamed."""
        K = perm.shape[0]
        dev = self.device
        live = torch.arange(K, device=dev) < n_keep
        pj = torch.from_numpy(np.asarray(perm, np.int64)).to(dev)
        db = self.db
        self.db = kdb.BowDatabase(vectors=torch.where(live[:, None], db.vectors[pj], 0.0),
                                  words=torch.where(live[:, None], db.words[pj], -1),
                                  valid=live & db.valid[pj])
        if self.last_loop_kf >= 0:
            self.last_loop_kf = int(new_of_old[self.last_loop_kf])
        self._consistent = {}
        self.loops = [(int(new_of_old[a]), int(new_of_old[b]), T) for a, b, T in self.loops]
