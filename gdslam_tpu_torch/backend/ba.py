"""Local bundle adjustment: masked dense Levenberg-Marquardt with Schur
complement (port of gdslam_tpu.backend.ba).

Replaces Optimizer::LocalBundleAdjustment (reference Optimizer.cc:669-995):
optimize the covisible local keyframes + their map points, with keyframes
that observe those points but are outside the local set held fixed; two
passes with chi2-based outlier edge removal between and after (5.991 mono /
7.815 stereo), Huber robust kernel.

No sparse graph: the edge set is the dense [A, N] keyframe x keypoint
observation table (A = local + fixed keyframes, N = features per keyframe,
invalid entries masked); the point-block inverse is a closed-form batched
3x3; the reduced camera system (6L x 6L with L <= 16) is built with einsums
over a dense [L, P, 6, 3] coupling tensor and solved with Cholesky. Nothing
is read on the host: the step's acceptance is a device scalar.

The scatters whose indices repeat in the JAX functions (a dump slot that is
also a live keyframe or point) are written through `map_arena.last_writer`,
which gives the result of XLA's serial scatter on the CPU (ROADMAP.md
section 3). The point blocks are summed by `map_arena.add_rows`, in a fixed
order on the card too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend.optimizer import CHI2_MONO, CHI2_STEREO
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend.extractor import top_k_stable

L_OPT = 16      # optimized local keyframes (covisibility cap)
F_FIX = 16      # fixed observer keyframes
P_CAP = 8192    # local map points


class LocalBAProblem(NamedTuple):
    kf_ids: torch.Tensor     # [L+F] int32 arena keyframe ids (first L optimized)
    kf_mask: torch.Tensor    # [L+F] valid
    pt_ids: torch.Tensor     # [P] int32 arena point ids
    pt_mask: torch.Tensor    # [P] valid
    obs_slot: torch.Tensor   # [L+F, N] int32 local point slot per keypoint (-1)
    inv_idx: torch.Tensor    # [L+F, P] int32 keypoint index observing slot p (N=none)


def build_problem(arena: ma.MapArena, kf_id: int, cfg: SlamConfig) -> LocalBAProblem:
    dev = arena.kf_obs.device
    K, P, N = arena.kmax, arena.pmax, arena.n_features
    i32 = dict(dtype=torch.int32, device=dev)
    # Local keyframes: top covisible of kf_id (including itself).
    loc_ids, loc_ok = ma.local_keyframes(arena, kf_id, L_OPT)

    # Local points: union of observations of local keyframes. The rows
    # that are not local aim at keyframe 0 with the value False
    # (gdslam_tpu/backend/ba.py:53-54) and come last, so keyframe 0 counts as
    # local here only when all L_OPT rows are.
    tgt = torch.where(loc_ok, loc_ids, 0)
    is_local_kf = ma.scatter_rows(torch.zeros(K, dtype=torch.bool, device=dev), tgt, loc_ok,
                                  ma.last_writer(tgt, loc_ok, K))
    has_obs = arena.kf_obs >= 0
    obs_local = torch.where(is_local_kf[:, None] & has_obs, arena.kf_obs, P)
    pt_ind = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    pt_ind.index_fill_(0, obs_local.reshape(-1).long(), True)
    pt_ind = pt_ind[:P] & arena.pt_valid
    # the first P_CAP local points, ascending (jnp.nonzero with a size)
    rank = torch.cumsum(pt_ind.to(torch.int32), 0) - 1
    pt_ids = torch.full((P_CAP + 1,), -1, **i32)
    pt_ids[torch.where(pt_ind & (rank < P_CAP), rank, P_CAP).long()] = \
        torch.arange(P, **i32)
    pt_ids = pt_ids[:P_CAP].clone()    # the dump row P_CAP is dropped
    pt_mask = pt_ids >= 0
    slot_of = torch.full((P + 1,), -1, **i32)
    slot_of[torch.where(pt_mask, pt_ids, P).long()] = \
        torch.where(pt_mask, torch.arange(P_CAP, **i32), -1)

    # Fixed keyframes: observe local points, not local themselves.
    sees = (pt_ind[arena.kf_obs.clamp(min=0).long()] & has_obs).sum(dim=1)
    sees = torch.where(arena.kf_valid & ~is_local_kf, sees, 0)
    if K < F_FIX:   # tiny arenas: pad so the problem shape stays [L+F]
        sees = torch.nn.functional.pad(sees, (0, F_FIX - K))
    fix_w, fix_ids = top_k_stable(sees, F_FIX)
    fix_ids = fix_ids.clamp(max=K - 1).to(torch.int32)

    kf_ids = torch.cat([loc_ids, fix_ids])
    kf_mask = torch.cat([loc_ok, fix_w > 0])
    obs = arena.kf_obs[kf_ids.long()]                                 # [A, N]
    obs_slot = torch.where(kf_mask[:, None] & (obs >= 0),
                           slot_of[torch.where(obs >= 0, obs, P).long()], -1)
    # Uniqueness invariant: a keyframe observes a point through at most one
    # keypoint. Point merges (MapPoint::Replace) can leave duplicate rows;
    # keep only the first (a stable sort) so the inverse map is unique.
    A = obs_slot.shape[0]
    ssort, order = torch.sort(obs_slot, dim=1, stable=True)
    prev = torch.cat([torch.full((A, 1), -2, **i32), ssort[:, :-1]], dim=1)
    dup = torch.zeros_like(obs_slot, dtype=torch.bool).scatter(
        1, order, (ssort == prev) & (ssort >= 0))
    obs_slot = torch.where(dup, -1, obs_slot)
    # Inverse map [A, P]: which keypoint row observes point slot p in camera
    # a (N = none), so every LM iteration gathers the per-point blocks.
    slot_pos = torch.where(obs_slot >= 0, obs_slot, P_CAP).long()
    inv_idx = torch.full((A, P_CAP + 1), N, **i32).scatter(
        1, slot_pos, torch.arange(N, **i32).expand(A, N))[:, :P_CAP]
    return LocalBAProblem(kf_ids=kf_ids, kf_mask=kf_mask, pt_ids=pt_ids, pt_mask=pt_mask,
                          obs_slot=obs_slot, inv_idx=inv_idx.contiguous())


def _edge_terms(poses, pts, prob: LocalBAProblem, uv, ur, inv_sigma2, K, bf):
    """Residuals r [A,N,3], Jacobians Jc [A,N,3,6], Jp [A,N,3,3], weights."""
    fx, fy, cx, cy = K
    Xw = pts[prob.obs_slot.clamp(min=0).long()]                       # [A, N, 3]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Xc = torch.einsum("aij,anj->ani", R, Xw) + t[:, None]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_ok = z > 1e-6
    iz = 1.0 / torch.where(z_ok, z, 1.0)
    iz2 = iz * iz
    u_hat = fx * x * iz + cx
    v_hat = fy * y * iz + cy
    ur_hat = u_hat - bf * iz
    is_stereo = ur >= 0
    r = torch.stack([u_hat - uv[..., 0], v_hat - uv[..., 1],
                     torch.where(is_stereo, ur_hat - ur, 0.0)], dim=-1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    dur = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(is_stereo[..., None], dur, 0.0)], -2)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    dXc_pose = torch.cat([eye, -lie.hat(Xc)], dim=-1)                 # [A,N,3,6]
    Jc = dproj @ dXc_pose
    Jp = torch.einsum("anri,aik->anrk", dproj, R)
    valid = (prob.obs_slot >= 0) & z_ok
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    e2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w_huber = torch.where(e2 <= chi2_th, 1.0, torch.sqrt(chi2_th / e2.clamp(min=1e-12)))
    return r, Jc, Jp, valid, e2, w_huber * inv_sigma2


def _inv3x3(M):
    """Closed-form inverse of symmetric 3x3 blocks."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f, i = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    det = a * (e * i - f * f) - b * (b * i - f * c) + c * (b * f - e * c)
    det = torch.where(det.abs() > 1e-12, det, 1e-12)
    inv = torch.stack([
        torch.stack([e * i - f * f, c * f - b * i, b * f - c * e], -1),
        torch.stack([c * f - b * i, a * i - c * c, b * c - a * f], -1),
        torch.stack([b * f - c * e, b * c - a * f, a * e - b * b], -1),
    ], -2)
    return inv / det[..., None, None]


def run_local_ba(arena: ma.MapArena, prob: LocalBAProblem, cfg: SlamConfig,
                 iters1: int = 5, iters2: int = 10, damping: float = 1e-3,
                 cull: bool = True):
    """Execute local BA; returns (arena', n_outlier_obs)."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    bf = cam.bf
    sf = float(cfg.orb.scale_factor)
    dev = arena.kf_pose.device
    A, N = prob.obs_slot.shape
    L = L_OPT
    kf_rows = prob.kf_ids.long()

    poses0 = arena.kf_pose[kf_rows]                                   # [A,4,4]
    pts0 = arena.pt_pos[prob.pt_ids.clamp(min=0).long()]              # [P,3]
    uv = arena.kf_uv[kf_rows]
    ur = arena.kf_ur[kf_rows]
    inv_sigma2 = 1.0 / sf ** (2.0 * arena.kf_level[kf_rows].float())
    chi2_th = torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    has_slot = prob.obs_slot >= 0
    flat_slot = torch.where(has_slot, prob.obs_slot, P_CAP).reshape(-1).long()
    inv_idx = prob.inv_idx[:L, :, None].long().expand(L, P_CAP, 18)
    eye3 = torch.eye(3, device=dev)
    eye6L = torch.eye(6 * L, device=dev)
    diag = torch.arange(L, device=dev)
    free = (prob.kf_mask[:L] & (prob.kf_ids[:L] != 0))[:, None]

    def robust_cost(poses, pts, inlier):
        """Huber-robustified total chi2, the LM acceptance criterion. The
        edge set is frozen to the state-independent mask: an edge whose point
        leaves the camera frustum (z <= 0) at the evaluated state pays a
        saturated penalty instead of dropping out, so a step cannot be
        accepted because it pushed points behind the camera."""
        _, _, _, valid, e2, _ = _edge_terms(poses, pts, prob, uv, ur, inv_sigma2, K, bf)
        rho = torch.where(e2 <= chi2_th, e2,
                          2.0 * torch.sqrt(chi2_th * e2.clamp(min=0.0)) - chi2_th)
        rho_sat = 2.0 * torch.sqrt(chi2_th * 1e8) - chi2_th
        return torch.where(has_slot & inlier, torch.where(valid, rho, rho_sat), 0.0).sum()

    def lm_iter(state, inlier):
        # Levenberg-Marquardt control (the reference optimizes with g2o LM,
        # Optimizer.cc:751): compute the damped step, accept it only if the
        # robust cost decreases, adapt lambda.
        poses, pts, lam, cost = state
        r, Jc, Jp, valid, e2, w = _edge_terms(poses, pts, prob, uv, ur, inv_sigma2, K, bf)
        w = w * (valid & inlier)

        # Camera blocks (only the first L are optimized).
        Hcc = torch.einsum("anri,an,anrj->aij", Jc[:L], w[:L], Jc[:L])
        bc = torch.einsum("anri,an,anr->ai", Jc[:L], w[:L], r[:L])
        # Point blocks: one flat scatter-add over all [A*N] edges.
        JpwJp = torch.einsum("anri,an,anrj->anij", Jp, w, Jp).reshape(A, N, 9)
        Jpwr = torch.einsum("anri,an,anr->ani", Jp, w, r)
        pt_blocks = torch.cat([JpwJp, Jpwr], dim=-1)                  # [A,N,12]
        acc = ma.add_rows(flat_slot, pt_blocks.reshape(-1, 12), flat_slot < P_CAP, P_CAP)
        Hpp = acc[:, :9].reshape(P_CAP, 3, 3)
        # Marquardt damping: scale the diagonal (lam is relative) + a small
        # absolute floor to keep empty blocks invertible.
        Hpp = Hpp + lam * Hpp * eye3 + damping * eye3
        bp = acc[:, 9:12]
        # Camera-point coupling W for the L optimized cameras. A keyframe
        # observes each point through at most one keypoint (duplicates are
        # masked in build_problem), so [L,N] -> [L,P] is a gather through
        # the inverse index.
        JcwJp = torch.einsum("anri,an,anrj->anij", Jc[:L], w[:L], Jp[:L]).reshape(L, N, 18)
        JcwJp_ext = torch.cat([JcwJp, torch.zeros((L, 1, 18), device=dev)], dim=1)
        Wap = torch.gather(JcwJp_ext, 1, inv_idx).reshape(L, P_CAP, 6, 3)
        Hpp_inv = _inv3x3(Hpp)
        # Schur complement S = Hcc - W Hpp^-1 W^T (cross-camera coupling).
        WH = torch.einsum("apij,pjk->apik", Wap, Hpp_inv)
        S = -torch.einsum("apik,bplk->abil", WH, Wap)
        S[diag, diag] += Hcc
        bs = bc - torch.einsum("apik,pk->ai", WH, bp)
        S_m = S.permute(0, 2, 1, 3).reshape(6 * L, 6 * L)
        S_m = S_m + lam * S_m * eye6L + damping * eye6L
        # A failed factorisation zeroes the step (the reference's solve
        # yields NaN there, which it zeroes).
        chol, info = torch.linalg.cholesky_ex(S_m)
        dc = -torch.cholesky_solve(bs.reshape(-1, 1), chol).reshape(L, 6)
        dc = torch.where(torch.isfinite(dc) & (info == 0), dc, 0.0)
        # Unoptimized/padded cameras stay; keyframe 0 is always held fixed
        # (gauge anchor, the reference's setFixed(mnId==0)).
        dc = dc * free
        # Back-substitution: dp = -Hpp^-1 (bp + W^T dc).
        WTdc = torch.einsum("apij,ai->pj", Wap, dc)
        dp = -torch.einsum("pij,pj->pi", Hpp_inv, bp + WTdc)
        dp = torch.where(torch.isfinite(dp), dp, 0.0) * prob.pt_mask[:, None]

        cand_poses = torch.cat([lie.se3_exp(dc) @ poses[:L], poses[L:]], dim=0)
        cand_pts = pts + dp
        cand_cost = robust_cost(cand_poses, cand_pts, inlier)
        accept = cand_cost < cost
        return (torch.where(accept, cand_poses, poses), torch.where(accept, cand_pts, pts),
                torch.where(accept, lam * 0.33, lam * 8.0).clamp(1e-6, 1e3),
                torch.where(accept, cand_cost, cost))

    # Pass 1: all edges.
    inlier = torch.ones_like(has_slot)
    state = (poses0, pts0, torch.full((), 1e-4, device=dev), robust_cost(poses0, pts0, inlier))
    for _ in range(iters1):
        state = lm_iter(state, inlier)
    # Outlier classification (Optimizer.cc: chi2 gate between passes).
    _, _, _, valid, e2, _ = _edge_terms(state[0], state[1], prob, uv, ur, inv_sigma2, K, bf)
    inlier = valid & (e2 <= chi2_th)
    state = (state[0], state[1], state[2], robust_cost(state[0], state[1], inlier))
    for _ in range(iters2):
        state = lm_iter(state, inlier)
    # Keep poses on SE(3): repeated exp-compositions preserve (and float
    # rounding seeds) SO(3) deviation that the tracker's velocity cycle then
    # amplifies geometrically.
    poses, pts = lie.se3_orthonormalize(state[0]), state[1]
    _, _, _, valid, e2, _ = _edge_terms(poses, pts, prob, uv, ur, inv_sigma2, K, bf)
    outlier = valid & (e2 > chi2_th)

    # Write back poses and points. The padded rows aim at keyframe kmax - 1
    # and at point 0 with their old values (gdslam_tpu/backend/ba.py:301-311).
    kf_tgt = torch.where(prob.kf_mask[:L], prob.kf_ids[:L], arena.kmax - 1)
    pt_tgt = torch.where(prob.pt_mask, prob.pt_ids, 0)
    arena = arena._replace(
        kf_pose=ma.scatter_rows(arena.kf_pose, kf_tgt, poses[:L],
                                ma.last_writer(kf_tgt, prob.kf_mask[:L], arena.kmax)),
        pt_pos=ma.scatter_rows(arena.pt_pos, pt_tgt, pts,
                               ma.last_writer(pt_tgt, prob.pt_mask, arena.pmax)))
    if cull:
        # Erase outlier observations (Optimizer.cc:941-963). Every edge that
        # is no outlier aims at keyframe kmax - 1's row with its old value
        # (:314-321), so the serial rule decides that row.
        cols = torch.arange(N, device=dev).expand(A, N)
        tgt = (torch.where(outlier, kf_rows[:, None], arena.kmax - 1) * N + cols).reshape(-1)
        flat_out = outlier.reshape(-1)
        obs_removed = ma.scatter_rows(
            arena.kf_obs.reshape(-1), tgt, torch.full_like(tgt, -1, dtype=torch.int32),
            ma.last_writer(tgt, flat_out, arena.kmax * N)).reshape(arena.kmax, N)
        pt_rows = torch.where(outlier, arena.kf_obs[kf_rows], -1).reshape(-1)
        dec = torch.zeros(arena.pmax, dtype=torch.int32, device=dev).index_add(
            0, pt_rows.clamp(min=0).long(), (pt_rows >= 0).to(torch.int32))
        arena = arena._replace(kf_obs=obs_removed,
                               pt_n_obs=(arena.pt_n_obs - dec).clamp(min=0))
    return arena, outlier.sum()


def local_bundle_adjustment(arena: ma.MapArena, kf_id: int, cfg: SlamConfig,
                            iters1: int = 5, iters2: int = 5):
    """Build the problem of keyframe `kf_id` and run it."""
    return run_local_ba(arena, build_problem(arena, kf_id, cfg), cfg, iters1, iters2)
