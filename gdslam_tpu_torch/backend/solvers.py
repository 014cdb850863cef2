"""Closed-form alignment solvers + batched RANSAC (port of
gdslam_tpu.backend.solvers).

- `horn_alignment`: Horn's absolute-orientation closed form for SE3 (fixed
  scale) or Sim3, the math behind Sim3Solver::ComputeSim3 (reference
  Sim3Solver.h:55-58; scale fixed for RGB-D per Sim3Solver.h:20), with the
  rotation in Horn's quaternion form, which reads nothing on the host.
- `ransac_rigid`: RANSAC over 3D-3D correspondences with a closed-form
  minimal solver (the role of EPnP RANSAC where every keypoint has depth).
- `ransac_pnp`: 2D-3D pose RANSAC, the PnPsolver/EPnP role for observations
  without depth: a 6-point DLT with known K.

All hypotheses are solved and scored as one batch (n_iters fixed, no early
exit); consensus is scored by reprojection error in the target view.

Random numbers: each RANSAC draws its samples as the JAX function does,
`jax.random.categorical` under the caller's key (`ops/draw_kernel.py`, a
CUDA kernel on the card), or takes `sample_idx` when the caller supplies
the draw.

- `ransac_sim3` / `optimize_sim3`: the loop closer's Sim3 (SE3 for RGB-D)
  RANSAC and its Gauss-Newton refinement (Sim3Solver, OptimizeSim3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.ops import draw_kernel


def _rotation_from_cross_covariance(H: torch.Tensor, squarings: int = 16) -> torch.Tensor:
    """The rotation R maximising tr(R H) for H = sum w Pc Qc^T [..., 3, 3],
    so that R @ Pc ~ Qc: Horn's quaternion form. R is the quaternion of the
    largest eigenvalue of the symmetric traceless 4x4 matrix N(H), the same
    optimum over SO(3) as the SVD with the reflection fix. The eigenvector
    comes from repeated squaring of N / |N|_F + I (positive semi-definite,
    eigenvalues in [0, 2]), rescaled after each product: 2^16 powers, plain
    batched products with no solver call, so nothing waits for the card
    (torch.linalg's SVD and eigh read their convergence flags on the host).
    H = 0 gives the identity."""
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (H[..., i, :].unbind(-1) for i in range(3))
    N = torch.stack([
        torch.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], dim=-1),
        torch.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], dim=-1),
        torch.stack([zx - xz, xy + yx, yy - xx - zz, yz + zy], dim=-1),
        torch.stack([xy - yx, zx + xz, yz + zy, zz - xx - yy], dim=-1)], dim=-2)
    scale = torch.linalg.matrix_norm(N).clamp(min=1e-30)[..., None, None]
    M = N / scale + torch.eye(4, device=H.device)
    for _ in range(squarings):
        M = M @ M
        M = M / M.abs().amax(dim=(-1, -2), keepdim=True)
    # M is now ~ q q^T up to scale: its column of largest norm is along q
    col = torch.linalg.vector_norm(M, dim=-2).argmax(dim=-1)
    q = torch.gather(M, -1, col[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)],
        dim=-2)


def horn_alignment(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor,
                   with_scale: bool = False):
    """Weighted closed-form R, t, s with s*R @ P + t ~= Q.

    P, Q: [..., n, 3]; w: [..., n] non-negative weights (0 = ignore).
    Returns (R [..., 3, 3], t [..., 3], s [...]), batched on leading dims.
    The JAX package takes R from an SVD of the cross-covariance; here it is
    the quaternion form of the same optimum (_rotation_from_cross_covariance)."""
    wsum = w.sum(dim=-1, keepdim=True) + 1e-12
    cp = torch.einsum("...n,...ni->...i", w, P) / wsum
    cq = torch.einsum("...n,...ni->...i", w, Q) / wsum
    Pc = P - cp[..., None, :]
    Qc = Q - cq[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", w, Pc, Qc)
    R = _rotation_from_cross_covariance(H)
    if with_scale:
        RP = torch.einsum("...ij,...nj->...ni", R, Pc)
        num = torch.einsum("...n,...ni,...ni->...", w, Qc, RP)
        den = torch.einsum("...n,...ni,...ni->...", w, Pc, Pc) + 1e-12
        s = num / den
    else:
        s = torch.ones_like(wsum[..., 0])
    t = cq - s[..., None] * torch.einsum("...ij,...j->...i", R, cp)
    return R, t, s


class RansacResult(NamedTuple):
    T: torch.Tensor          # [4, 4] best rigid transform (Q <- P)
    inliers: torch.Tensor    # [n] bool consensus set
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor         # scalar bool (enough inliers found)


def _draw(valid: torch.Tensor, n_iters: int, size: int, key, sample_idx: Optional[torch.Tensor],
          fold: Optional[torch.Tensor] = None):
    """[n_iters, size] sample rows: `sample_idx` if given, else drawn with
    replacement, uniformly over the valid rows (over all rows when none is
    valid, as the reference's log(p + 1e-12) does), as the JAX package draws
    them under `key` (fold: draw_kernel.categorical_draw's)."""
    if sample_idx is not None:
        return sample_idx.reshape(n_iters, size).long()
    if key is None:
        raise ValueError("a RANSAC needs the draw's key or sample_idx")
    return draw_kernel.uniform_over(key, valid, n_iters * size, fold).reshape(n_iters, size)


def _score(T: torch.Tensor, pw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
           K: tuple, px_threshold: float):
    """Reprojection consensus of pose(s) T [..., 4, 4]: (count [...], mask [..., n])."""
    fx, fy, cx, cy = K
    Pq = torch.einsum("...ij,nj->...ni", T[..., :3, :3], pw) + T[..., None, :3, 3]
    z = Pq[..., 2].clamp(min=1e-6)
    u = fx * Pq[..., 0] / z + cx
    v = fy * Pq[..., 1] / z + cy
    err = torch.hypot(u - uv[:, 0], v - uv[:, 1])
    inl = valid & (err < px_threshold) & (Pq[..., 2] > 1e-6)
    return inl.sum(dim=-1), inl


def _argmax_row(scores: torch.Tensor) -> torch.Tensor:
    """[1] index of the best hypothesis, the first among equal scores. A
    one-element index tensor for index_select: indexing with a 0-d device
    tensor reads it on the host, which waits for the card."""
    return torch.argmax(scores).reshape(1)


def ransac_rigid(P: torch.Tensor, Q: torch.Tensor, valid: torch.Tensor, K: tuple,
                 uv_q: torch.Tensor, n_iters: int = 300, sample_size: int = 3,
                 min_inliers: int = 10, px_threshold: float = 4.0, *, key=None,
                 fold: Optional[torch.Tensor] = None,
                 sample_idx: Optional[torch.Tensor] = None) -> RansacResult:
    """RANSAC rigid 3D-3D with reprojection consensus.

    P [n,3] source points, Q [n,3] target-frame points, uv_q [n,2] observed
    pixels in the target view; K = (fx, fy, cx, cy). Samples are drawn with
    replacement under `key` (and `fold`), or given as sample_idx [n_iters *
    sample_size]; a degenerate (repeated-index) sample yields a poor
    hypothesis that loses the argmax."""
    idx = _draw(valid, n_iters, sample_size, key, sample_idx, fold)
    R, t, _ = horn_alignment(P[idx], Q[idx], torch.ones(idx.shape, device=P.device))
    Ts = lie.rt_to_mat(R, t)                                          # [iters, 4, 4]
    scores, inls = _score(Ts, P, uv_q, valid, K, px_threshold)
    best = _argmax_row(scores)
    inliers, score = inls.index_select(0, best)[0], scores.index_select(0, best)[0]

    # Refine on the full consensus set (closed form again).
    R, t, _ = horn_alignment(P, Q, inliers.float())
    T_ref = lie.rt_to_mat(R, t)
    n_ref, inliers_ref = _score(T_ref, P, uv_q, valid, K, px_threshold)
    use_ref = n_ref >= score
    n_best = torch.maximum(n_ref, score)
    return RansacResult(T=torch.where(use_ref, T_ref, Ts.index_select(0, best)[0]),
                        inliers=torch.where(use_ref, inliers_ref, inliers),
                        n_inliers=n_best, ok=n_best >= min_inliers)


def _P_to_T(Pm: torch.Tensor, Xh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matrix -> SE3 (batched), resolving the projective sign on
    the raw 3x4 matrix first (flipping an orthonormalized R negates it, which
    is not a rotation): the weighted projective depths of the support set
    must be positive. The DLT's null vector has no sign of its own, so this
    rule is what makes the result independent of the SVD's sign choice."""
    w_depth = torch.einsum("...nk,...k->...n", Xh, Pm[..., 2, :]) * w
    Pm = torch.where((w_depth.sum(dim=-1) < 0)[..., None, None], -Pm, Pm)
    U, S, Vt = torch.linalg.svd(Pm[..., :3])
    d = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    scale = S.sum(dim=-1) / 3.0
    return lie.rt_to_mat(U @ D @ Vt, Pm[..., 3] / scale.clamp(min=1e-12)[..., None])


def ransac_pnp(pw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: tuple,
               n_iters: int = 300, min_inliers: int = 10, px_threshold: float = 2.45, *,
               key=None, sample_idx: Optional[torch.Tensor] = None) -> RansacResult:
    """2D-3D pose RANSAC (reference PnPsolver.h:73, SetRansacParameters(0.99,
    10, 300, 4, 0.5, 5.991) at Tracking.cc:1715) for observations without
    depth. Minimal solver: 6-point DLT for the projection matrix with known
    K, R orthonormalized by SVD; consensus by reprojection (threshold ~
    sqrt(5.991) px). The draw is the JAX package's under `key` (relocalization
    gives PRNGKey(frame_id)), or sample_idx [n_iters * 6]."""
    fx, fy, cx, cy = K
    n = pw.shape[0]
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=1)
    idx = _draw(valid, n_iters, 6, key, sample_idx)

    Xh_all = torch.cat([pw, torch.ones((n, 1), device=pw.device)], dim=1)
    z4_all = torch.zeros((n, 4), device=pw.device)
    r1 = torch.cat([Xh_all, z4_all, -xn[:, 0:1] * Xh_all], dim=1)     # [n, 12]
    r2 = torch.cat([z4_all, Xh_all, -xn[:, 1:2] * Xh_all], dim=1)

    # per hypothesis the 12 x 12 DLT system, its rows interleaved u, v
    A = torch.stack([r1[idx], r2[idx]], dim=2).reshape(n_iters, 12, 12)
    Vt = torch.linalg.svd(A).Vh
    Ts = _P_to_T(Vt[:, -1].reshape(n_iters, 3, 4), Xh_all[idx],
                 torch.ones(idx.shape, device=pw.device))
    scores, inls = _score(Ts, pw, uv, valid, K, px_threshold)
    best = _argmax_row(scores)
    T_best, inl_best = Ts.index_select(0, best)[0], inls.index_select(0, best)[0]

    # Local optimization (the "refine" stage of PnPsolver::Refine,
    # PnPsolver.cc:437-471): refit a weighted DLT on the full consensus set
    # and rescore, twice. A minimal 6-point sample under pixel noise gives a
    # coarse pose that undercounts inliers; one refit typically grows the
    # consensus to the full inlier set.
    for _ in range(2):
        w = inl_best.float()
        enough = w.sum() >= 6      # keep the previous pose when the support is too thin
        A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
        Vt = torch.linalg.svd(A, full_matrices=False).Vh
        T_new = _P_to_T(Vt[-1].reshape(3, 4), Xh_all, w)
        n_new, inl_new = _score(T_new, pw, uv, valid, K, px_threshold)
        better = enough & (n_new >= inl_best.sum())
        T_best = torch.where(better, T_new, T_best)
        inl_best = torch.where(better, inl_new, inl_best)
    n_best = inl_best.sum()
    return RansacResult(T=T_best, inliers=inl_best, n_inliers=n_best,
                        ok=n_best >= min_inliers)


def _sim3_apply_batch(R, t, s, p):
    """(R [B,3,3], t [B,3], s [B]) applied to p [N,3] -> [B, N, 3]."""
    return s[:, None, None] * torch.einsum("bij,nj->bni", R, p) + t[:, None]


def _reproj(Xc: torch.Tensor, K: tuple):
    """Pixels of camera points (depth clamped at 1e-6) and their z > 0."""
    fx, fy, cx, cy = K
    z = Xc[..., 2].clamp(min=1e-6)
    return torch.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1), Xc[..., 2] > 0


def ransac_sim3(P: torch.Tensor, Q: torch.Tensor, valid: torch.Tensor, n_iters: int = 300,
                min_inliers: int = 20, err_threshold: float = 0.05, with_scale: bool = False,
                uv_p: Optional[torch.Tensor] = None, uv_q: Optional[torch.Tensor] = None,
                K: Optional[tuple] = None, px_threshold=3.04, *,
                key: Optional[tuple] = None, sample_idx: Optional[torch.Tensor] = None):
    """RANSAC Sim3/SE3 on 3D-3D correspondences with Sim3Solver::iterate
    semantics (RANSAC(0.99, 20, 300), LoopClosing.cc:279); the scale is 1
    unless with_scale. Consensus is metric (|S P - Q| < err_threshold), or,
    when uv_p / uv_q / K are given, bidirectional reprojection in pixels
    (Sim3Solver::CheckInliers, Sim3Solver.cc:180-209): S P projected into
    the current image against uv_q and S^-1 Q into the candidate's against
    uv_p, px_threshold a scalar or per point [N]. The draws are the JAX
    package's under `key` (the loop closer gives PRNGKey(kf_id), the JAX
    package's key), or `sample_idx` [n_iters * 3].

    Returns (R, t, s, inliers [N], n_inliers, ok), all on the device."""
    idx = _draw(valid, n_iters, 3, key, sample_idx)
    Rs, ts, ss = horn_alignment(P[idx], Q[idx], torch.ones(idx.shape, device=P.device),
                                with_scale=with_scale)

    def score(R, t, s):
        # batched over hypotheses: R [B, 3, 3], t [B, 3], s [B]
        if uv_p is not None:
            uq, zq = _reproj(_sim3_apply_batch(R, t, s, P), K)
            Ri, ti, si = lie.sim3_inverse(R, t, s)
            up, zp = _reproj(_sim3_apply_batch(Ri, ti, si, Q), K)
            eq = torch.hypot(uq[..., 0] - uv_q[:, 0], uq[..., 1] - uv_q[:, 1])
            ep = torch.hypot(up[..., 0] - uv_p[:, 0], up[..., 1] - uv_p[:, 1])
            inl = valid & zq & zp & (eq < px_threshold) & (ep < px_threshold)
        else:
            err = torch.linalg.vector_norm(_sim3_apply_batch(R, t, s, P) - Q, dim=-1)
            inl = valid & (err < err_threshold)
        return inl.sum(dim=-1), inl

    scores, inls = score(Rs, ts, ss)
    w = inls.index_select(0, _argmax_row(scores))[0].float()
    R, t, s = horn_alignment(P, Q, w, with_scale=with_scale)
    n_fin, inl_fin = score(R[None], t[None], s[None])
    n_fin, inl_fin = n_fin[0], inl_fin[0]
    return R, t, s, inl_fin, n_fin, n_fin >= min_inliers


def jacobian_fwd(fn, x: torch.Tensor) -> torch.Tensor:
    """d fn / d x for x [..., D] by forward mode, all D directions in one
    pass: fn is evaluated once on a leading axis of D copies of x, copy d
    carrying the tangent e_d, so fn must broadcast over that axis. Returns
    [*fn(x).shape, D]. (torch.func.jacfwd vmaps per-row scalars instead, and
    a 0-d dual plus a Python float comes out float64.)"""
    D = x.shape[-1]
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    shape = (D,) + tuple(x.shape)
    X = x[None].expand(shape).clone()
    tangent = eye.reshape((D,) + (1,) * (x.dim() - 1) + (D,)).expand(shape).clone()
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(X, tangent))
        return fwAD.unpack_dual(out).tangent.movedim(0, -1)


def optimize_sim3(X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, S12_init, K: tuple,
                  with_scale: bool = False, th2: float = 10.0):
    """Gauss-Newton Sim3 refinement on bidirectional reprojection residuals,
    Optimizer::OptimizeSim3 (Optimizer.cc:1262-1391) semantics: per match
    e12 = uv1 - proj(S12 X2) and e21 = uv2 - proj(S12^-1 X1), Huber, a chi2
    cull at th2 per direction after the first round of 5 iterations, a
    second round of 5 on the survivors, inliers = both directions under th2.
    S12_init = (R, t, s) maps camera-2 coordinates into camera 1. The scale
    column of the Jacobian is zero unless with_scale. The loops have fixed
    counts; nothing is read on the host.

    Returns (R, t, s, inliers [N] bool, n_inliers)."""
    delta = th2 ** 0.5
    R0, t0, s0 = S12_init
    sq1, sq2 = torch.sqrt(inv_sigma2_1)[:, None], torch.sqrt(inv_sigma2_2)[:, None]
    dev = X1.device
    eye7 = torch.eye(7, device=dev)
    scale_col = torch.ones(7, device=dev) if with_scale else (torch.arange(7, device=dev) < 6).float()

    def residuals(xi, R, t, s):
        # left-multiplicative tangent update S = exp(xi) o S; xi is [..., 1, 7]
        dR, dt, ds = lie.sim3_exp(xi)
        Rn, tn, sn = lie.sim3_compose(dR, dt, ds, R, t, s)
        Ri, ti, si = lie.sim3_inverse(Rn, tn, sn)
        r12 = (uv1 - _reproj(lie.sim3_apply(Rn, tn, sn, X2), K)[0]) * sq1
        r21 = (uv2 - _reproj(lie.sim3_apply(Ri, ti, si, X1), K)[0]) * sq2
        return r12, r21

    def chi2_pair(R, t, s):
        r12, r21 = residuals(torch.zeros((1, 7), device=dev), R, t, s)
        return (r12 * r12).sum(-1), (r21 * r21).sum(-1)

    def gn_round(R, t, s, active):
        w_act = torch.cat([active, active]).float()
        for _ in range(5):
            def flat(xi):
                return torch.cat(residuals(xi, R, t, s), dim=-2)     # [..., 2N, 2]

            zero = torch.zeros((1, 7), device=dev)
            r = flat(zero)
            J = jacobian_fwd(flat, zero) * scale_col                 # [2N, 2, 7]
            chi = (r * r).sum(-1)
            w = torch.where(chi <= th2, 1.0, delta / torch.sqrt(chi.clamp(min=1e-12))) * w_act
            JW = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", JW, J) + 1e-6 * eye7
            if not with_scale:
                H = torch.where(eye7 * (1 - scale_col) > 0, 1.0, H)
            g = torch.einsum("nri,nr->i", JW, r)
            xi = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
            dR, dt, ds = lie.sim3_exp(xi)
            R, t, s = lie.sim3_compose(dR, dt, ds, R, t, s)
        return R, t, s

    R1, t1, s1 = gn_round(R0, t0, s0, valid)
    c12, c21 = chi2_pair(R1, t1, s1)
    R2, t2, s2 = gn_round(R1, t1, s1, valid & (c12 <= th2) & (c21 <= th2))
    c12, c21 = chi2_pair(R2, t2, s2)
    inl = valid & (c12 <= th2) & (c21 <= th2)
    return R2, t2, s2, inl, inl.sum()
