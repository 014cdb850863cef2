"""Global bundle adjustment and keyframe culling (port of
gdslam_tpu.backend.gba).

- `global_bundle_adjustment` replaces Optimizer::GlobalBundleAdjustemnt
  [sic] / LoopClosing::RunGlobalBundleAdjustment (reference
  Optimizer.cc:41-237, LoopClosing.cc:645-750): refine every keyframe pose
  and map point after a loop closure. At arena scale (512 keyframes x 64k
  points) the joint normal equations are solved matrix-free: each
  Gauss-Newton step runs Jacobi-preconditioned conjugate gradient whose
  Hessian-vector product is two passes over the dense [K, N] observation
  table, and the step is accepted under Levenberg-Marquardt control. The
  sweeps and the CG iterations are loops of fixed count, acceptance a
  `torch.where`: nothing is read on the host. The per-point sums go through
  `map_arena.add_rows`, in a fixed order on the card.
- `keyframe_culling` replaces LocalMapping::KeyFrameCulling
  (LocalMapping.cc:632-): discard keyframes whose observations are >= 90%
  redundant.
"""

from __future__ import annotations

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend.optimizer import CHI2_MONO, CHI2_STEREO
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import lie

CG_ITERS = 20


def _all_edge_terms(arena: ma.MapArena, poses, pts, K, bf, sf, inlier=None):
    """Residuals and weights of every (keyframe, keypoint) observation."""
    fx, fy, cx, cy = K
    obs = arena.kf_obs                                   # [A, N]
    slot = obs.clamp(min=0).long()
    Xc = torch.einsum("aij,anj->ani", poses[:, :3, :3], pts[slot]) + poses[:, None, :3, 3]
    z = Xc[..., 2]
    z_ok = z > 1e-6
    iz = 1.0 / torch.where(z_ok, z, 1.0)
    u_hat = fx * Xc[..., 0] * iz + cx
    v_hat = fy * Xc[..., 1] * iz + cy
    ur_hat = u_hat - bf * iz
    uv, ur = arena.kf_uv, arena.kf_ur
    is_stereo = ur >= 0
    r = torch.stack([u_hat - uv[..., 0], v_hat - uv[..., 1],
                     torch.where(is_stereo, ur_hat - ur, 0.0)], dim=-1)
    inv_sigma2 = 1.0 / sf ** (2.0 * arena.kf_level.float())
    valid = (obs >= 0) & z_ok & arena.kf_valid[:, None] & arena.pt_valid[slot]
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    e2 = (r * r).sum(-1) * inv_sigma2
    w_huber = torch.where(e2 <= chi2_th, 1.0, torch.sqrt(chi2_th / e2.clamp(min=1e-12)))
    if inlier is not None:
        valid = valid & inlier
    w = torch.where(valid, w_huber * inv_sigma2, 0.0)
    return Xc, r, w, iz, is_stereo, slot, e2, chi2_th, valid


def _robust_cost(arena, poses, pts, K, bf, sf, inlier):
    """Total Huber-robustified chi2, the LM acceptance criterion, over an
    edge set frozen to the state-independent mask: an edge whose point falls
    behind the camera pays a saturated penalty instead of dropping out (else
    a step pushing points behind the camera would lower its own cost)."""
    _, _, _, _, _, _, e2, chi2_th, valid = _all_edge_terms(arena, poses, pts, K, bf, sf, inlier)
    obs = arena.kf_obs
    structural = (obs >= 0) & arena.kf_valid[:, None] & arena.pt_valid[obs.clamp(min=0).long()]
    if inlier is not None:
        structural = structural & inlier
    rho = torch.where(e2 <= chi2_th, e2,
                      2.0 * torch.sqrt(chi2_th * e2.clamp(min=0.0)) - chi2_th)
    rho_sat = 2.0 * torch.sqrt(chi2_th * 1e8) - chi2_th
    return torch.where(structural, torch.where(valid, rho, rho_sat), 0.0).sum()


def global_bundle_adjustment(arena: ma.MapArena, cfg: SlamConfig, sweeps: int = 4,
                             gate_outliers: bool = False) -> ma.MapArena:
    """Joint pose + point Gauss-Newton, each step solved matrix-free by
    Jacobi-preconditioned CG and accepted under LM control.

    gate_outliers: chi2-gate the edge set against the initial state before
    optimising (after the essential-graph correction the initialisation is
    trusted, and drift-inconsistent seam observations are outliers); leave
    it off for generic refinement of a globally perturbed map."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    sf = float(cfg.orb.scale_factor)
    A, P = arena.kmax, arena.pmax
    dev = arena.kf_pose.device
    free_c = (arena.kf_valid & (torch.arange(A, device=dev) != 0))[:, None]   # kf 0: the gauge
    free_p = arena.pt_valid[:, None]
    has_obs = (arena.kf_obs >= 0).reshape(-1)
    eye3 = torch.eye(3, device=dev)

    def per_point(slot, vals):
        return ma.add_rows(slot.reshape(-1), vals.reshape(-1, 3), has_obs, P)

    def gn_step(poses, pts, lam, cost, inlier):
        Xc, r, w, iz, is_stereo, slot, _, _, _ = _all_edge_terms(arena, poses, pts, K, bf, sf,
                                                                 inlier)
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        du = torch.stack([fx * iz, zero, -fx * Xc[..., 0] * iz2], -1)
        dv = torch.stack([zero, fy * iz, -fy * Xc[..., 1] * iz2], -1)
        dur = torch.stack([fx * iz, zero, -fx * Xc[..., 0] * iz2 + bf * iz2], -1)
        dproj = torch.stack([du, dv, torch.where(is_stereo[..., None], dur, 0.0)], -2)
        dXc = torch.cat([eye3.expand(Xc.shape + (3,)), -lie.hat(Xc)], -1)
        Jc = torch.einsum("anri,anik->anrk", dproj, dXc)                      # [A,N,3,6]
        Jp = torch.einsum("anri,aik->anrk", dproj, poses[:, :3, :3])         # [A,N,3,3]

        # gradient g = J^T W r and the Jacobi diagonal of H = J^T W J
        gc = torch.where(free_c, torch.einsum("anri,an,anr->ai", Jc, w, r), 0.0)
        gp = torch.where(free_p, per_point(slot, torch.einsum("anri,an,anr->ani", Jp, w, r)), 0.0)
        dc = torch.einsum("anri,an,anri->ai", Jc, w, Jc)
        dp = per_point(slot, torch.einsum("anri,an,anri->ani", Jp, w, Jp))
        # the LM-damped diagonal, also the Jacobi preconditioner
        Mc = torch.where(free_c, 1.0 / (dc * (1.0 + lam) + 1e-6), 0.0)
        Mp = torch.where(free_p, 1.0 / (dp * (1.0 + lam) + 1e-6), 0.0)

        def matvec(vc, vp):
            vc = torch.where(free_c, vc, 0.0)
            vp = torch.where(free_p, vp, 0.0)
            u = torch.einsum("anri,ai->anr", Jc, vc) + torch.einsum("anrk,ank->anr", Jp, vp[slot])
            u = u * w[..., None]
            oc = torch.where(free_c, torch.einsum("anri,anr->ai", Jc, u), 0.0) + lam * dc * vc
            op = torch.where(free_p, per_point(slot, torch.einsum("anrk,anr->ank", Jp, u)), 0.0) \
                + lam * dp * vp
            return oc, op

        def safe_div(a, b):
            q = a / torch.where(b.abs() > 1e-20, b, 1e-20)
            return torch.where(torch.isfinite(q), q, 0.0)

        # PCG on H dx = -g, a fixed number of iterations
        r_c, r_p = -gc, -gp
        x_c, x_p = torch.zeros_like(r_c), torch.zeros_like(r_p)
        p_c, p_p = Mc * r_c, Mp * r_p
        rz = (r_c * p_c).sum() + (r_p * p_p).sum()
        for _ in range(CG_ITERS):
            Ap_c, Ap_p = matvec(p_c, p_p)
            alpha = safe_div(rz, (p_c * Ap_c).sum() + (p_p * Ap_p).sum())
            x_c, x_p = x_c + alpha * p_c, x_p + alpha * p_p
            r_c, r_p = r_c - alpha * Ap_c, r_p - alpha * Ap_p
            z_c, z_p = Mc * r_c, Mp * r_p
            rz_new = (r_c * z_c).sum() + (r_p * z_p).sum()
            beta = safe_div(rz_new, rz)
            p_c, p_p = z_c + beta * p_c, z_p + beta * p_p
            rz = rz_new
        x_c = torch.where(torch.isfinite(x_c) & free_c, x_c, 0.0)
        x_p = torch.where(torch.isfinite(x_p) & free_p, x_p, 0.0)

        # LM acceptance: keep the step only if the robust cost decreases
        cand_poses = lie.se3_orthonormalize(lie.se3_exp(x_c) @ poses)
        cand_pts = pts + x_p
        cand_cost = _robust_cost(arena, cand_poses, cand_pts, K, bf, sf, inlier)
        accept = cand_cost < cost
        lam = torch.where(accept, lam * 0.33, lam * 8.0).clamp(1e-6, 1e3)
        return (torch.where(accept, cand_poses, poses), torch.where(accept, cand_pts, pts), lam,
                torch.where(accept, cand_cost, cost))

    def run(poses, pts, inlier, n):
        cost = _robust_cost(arena, poses, pts, K, bf, sf, inlier)
        lam = torch.full((), 1e-4, device=dev)
        for _ in range(n):
            poses, pts, lam, cost = gn_step(poses, pts, lam, cost, inlier)
        return poses, pts

    def gated_inlier(poses, pts, chi2_factor):
        _, _, _, _, _, _, e2, chi2_th, valid = _all_edge_terms(arena, poses, pts, K, bf, sf)
        return valid & (e2 <= chi2_factor * chi2_th)

    if gate_outliers:
        h1 = max(sweeps // 2, 1)
        poses, pts = run(arena.kf_pose, arena.pt_pos,
                         gated_inlier(arena.kf_pose, arena.pt_pos, 4.0), h1)
        # sweeps - h1 may be 0 (sweeps=1): the re-gate applies, no step runs
        poses, pts = run(poses, pts, gated_inlier(poses, pts, 1.0), sweeps - h1)
    else:
        poses, pts = run(arena.kf_pose, arena.pt_pos,
                         torch.ones(arena.kf_obs.shape, dtype=torch.bool, device=dev), sweeps)
    # re-project onto SE(3): exp-compositions accumulate SO(3) deviation
    return arena._replace(kf_pose=lie.se3_orthonormalize(poses), pt_pos=pts)


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
