"""Monocular two-view initialization: H vs F model selection + reconstruction
(port of gdslam_tpu.frontend.initializer).

Replaces the reference Initializer (include/Initializer.h:42-72,
src/Initializer.cc): 200 homography (4-point DLT) and 200 fundamental
(8-point, Hartley-normalized) hypotheses scored together, the model chosen
by the score ratio RH > 0.45, then the pose from E = K^T F K decomposed into
four (R, t) candidates and chosen by the cheirality vote of the triangulated
points, refined by three rounds of resection (a mono pose Gauss-Newton of
view 2) and intersection (DLT triangulation), and returned with a unit-norm
translation (the monocular scale is free).

The hypotheses are batches of small SVDs. Of the card's values only the
8-point systems are read on the host, whose null vectors are solved there
for a bootstrap on the card (`_null_vectors`: a degenerate sample's vector
is the solver's own choice, and the CPU's must win); cuSOLVER's SVDs and
inverses wait for the card on their own. The RANSAC draws are the JAX
package's own, `jax.random.categorical` under
`PRNGKey(seed)` and its fold_in 1, drawn bit for bit by
`ops/draw_kernel.py` (a CUDA kernel on the card; at
the bootstrap's narrow baselines the draw decides the map's scale: other
draws give median depths from 20 to 200 baselines on the same pair), or
`sample_idx` when the caller gives them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gdslam_tpu_torch.backend import optimizer as opt
from gdslam_tpu_torch.core import lie, prng
from gdslam_tpu_torch.ops import draw_kernel


def triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    """Batched two-view DLT triangulation (Initializer::Triangulate).

    P1, P2: [..., 3, 4] projection matrices; x1, x2: [..., N, 2] pixel
    coords. Returns [..., N, 3] points. The null vector's sign cancels."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    A = torch.stack([x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
                     x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
                     x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
                     x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)   # [..., N, 4, 4]
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)[..., None]


def _normalize(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with weights (for conditioning): the
    normalized points and the [3, 3] transform."""
    wsum = torch.sum(w) + 1e-9
    mean = torch.einsum("n,ni->i", w, pts) / wsum
    d = torch.einsum("n,n->", w, torch.linalg.norm(pts - mean, dim=1)) / wsum
    s = torch.full((), math.sqrt(2.0), dtype=pts.dtype, device=pts.device) / \
        torch.clamp(d, min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                     torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _null_vectors(A: torch.Tensor) -> torch.Tensor:
    """The last right singular vector of each [..., 8, 9] system; for a
    tensor on the card solved on the host, one explicit copy each way.

    A sample drawn with replacement can repeat a row (7 of the 200 on the
    mono cell's bootstrap); its system then has a 2-D null space, and the
    vector an SVD returns in it is set by the solver's own rounding. On the
    card cuSOLVER returned another vector than the CPU's LAPACK for one such
    sample, which then won the RANSAC: the card bootstrapped from another F
    and made 32 keyframes where the CPU made 11. Solved on the host, the
    card takes the CPU route's vectors. Mono only, once a bootstrap attempt
    (~58 KB)."""
    if A.device.type == "cpu":
        return torch.linalg.svd(A)[2][..., -1, :]
    return torch.linalg.svd(A.cpu())[2][..., -1, :].to(A.device)


def _fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point F from [..., 8, 2] correspondences (already conditioned),
    with rank 2 enforced."""
    one = torch.ones_like(x1[..., 0])
    A = torch.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
                     x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
                     x1[..., 0], x1[..., 1], one], dim=-1)
    F = _null_vectors(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 0])], dim=-1)
    return (U * S[..., None, :]) @ Vt


def _homography_4pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-point DLT homography from [..., 4, 2] correspondences."""
    one, zero = torch.ones_like(x1[..., :1]), torch.zeros_like(x1[..., :1])
    zero3 = torch.cat([zero, zero, zero], dim=-1)
    r1 = torch.cat([x1, one, zero3, -x2[..., 0:1] * x1, -x2[..., 0:1]], dim=-1)   # [..., 4, 9]
    r2 = torch.cat([zero3, x1, one, -x2[..., 1:2] * x1, -x2[..., 1:2]], dim=-1)
    A = torch.stack([r1, r2], dim=-2).flatten(-3, -2)           # rows of point 0, then 1, ...
    return torch.linalg.svd(A)[2][..., -1, :].reshape(A.shape[:-2] + (3, 3))


class InitResult(NamedTuple):
    ok: torch.Tensor              # [] bool
    T_21: torch.Tensor            # [4, 4] pose of view 2 w.r.t. view 1
    points: torch.Tensor          # [N, 3] triangulated (view-1 frame)
    is_good: torch.Tensor         # [N] bool triangulation validity
    used_homography: torch.Tensor  # [] bool


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


def _score_f(Fs: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor):
    """Symmetric epipolar distances chi2-capped (CheckFundamental): the
    scores [B] and inlier sets [B, N] of the hypotheses Fs [B, 3, 3]."""
    x1h, x2h = _hom(x1), _hom(x2)
    l2 = torch.einsum("bij,nj->bni", Fs, x1h)
    l1 = torch.einsum("bji,nj->bni", Fs, x2h)
    d2 = torch.einsum("ni,bni->bn", x2h, l2) ** 2 / \
        torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.einsum("ni,bni->bn", x1h, l1) ** 2 / \
        torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    th = 3.841
    sc = torch.where(valid & (d1 < th), 5.991 - d1, 0.0) + \
        torch.where(valid & (d2 < th), 5.991 - d2, 0.0)
    return sc.sum(dim=1), valid & (d1 < th) & (d2 < th)


def _score_h(Hs: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor):
    """Symmetric transfer errors chi2-capped (CheckHomography): scores [B]."""
    def transfer(M, x):
        p = torch.einsum("bij,nj->bni", M, _hom(x))
        return p[..., :2] / torch.where(torch.abs(p[..., 2:]) > 1e-9, p[..., 2:], 1e-9)

    d2 = torch.sum((transfer(Hs, x1) - x2) ** 2, dim=-1)
    d1 = torch.sum((transfer(torch.linalg.inv(Hs), x2) - x1) ** 2, dim=-1)
    th = 5.991
    sc = torch.where(valid & (d1 < th), th - d1, 0.0) + \
        torch.where(valid & (d2 < th), th - d2, 0.0)
    return sc.sum(dim=1)


def _cheirality(T21: torch.Tensor, P1: torch.Tensor, Km: torch.Tensor, x1, x2, inliers):
    """Triangulate under the poses T21 [B, 4, 4]: the points [B, N, 3] and
    the inliers in front of both views [B, N]."""
    X = triangulate(P1.expand(T21.shape[0], 3, 4), Km @ T21[:, :3], x1, x2)
    z1 = X[..., 2]
    z2 = (torch.einsum("bij,bnj->bni", T21[:, :3, :3], X) + T21[:, None, :3, 3])[..., 2]
    return X, inliers & (z1 > 0) & (z2 > 0) & (torch.abs(z1) < 1e4)


def fundamental_hypotheses(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                           idx_f: torch.Tensor, norm=None):
    """The fundamental RANSAC's hypotheses from the 8-point samples idx_f
    [B, 8] of x1 <-> x2 [N, 2] (`norm`: both views' Hartley normalisations,
    (x1n, T1, x2n, T2), made here if None): Fs [B, 3, 3], their scores [B]
    and inlier sets [B, N]. The winner is argmax(scores)."""
    if norm is None:
        w = valid.float()
        norm = (*_normalize(x1, w), *_normalize(x2, w))
    x1n, T1, x2n, T2 = norm
    Fs = T2.T @ _fundamental_8pt(x1n[idx_f], x2n[idx_f]) @ T1
    return (Fs, *_score_f(Fs, x1, x2, valid))


def initialize(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, K: tuple,
               n_iters: int = 200, *, seed: int = 0, sample_idx=None) -> InitResult:
    """Two-view bootstrap from matched pixel coords x1 <-> x2 [N, 2].

    The sample rows are drawn with replacement, uniformly over the valid
    rows, as the JAX package draws them under PRNGKey(seed) (its tracker
    passes PRNGKey(0)); or given as sample_idx = (idx_f [n_iters, 8], idx_h
    [n_iters, 4])."""
    dev = x1.device
    fx, fy, cx, cy = K
    Km = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], device=dev)
    n = x1.shape[0]
    if sample_idx is None:
        key = prng.prng_key(seed)
        idx_f = draw_kernel.uniform_over(key, valid, n_iters * 8).reshape(n_iters, 8)
        idx_h = draw_kernel.uniform_over(prng.fold_in(key, 1), valid,
                                         n_iters * 4).reshape(n_iters, 4)
    else:
        idx_f = torch.as_tensor(sample_idx[0], device=dev).reshape(n_iters, 8).long()
        idx_h = torch.as_tensor(sample_idx[1], device=dev).reshape(n_iters, 4).long()

    # fundamental RANSAC (8-point, Hartley-normalized)
    w = valid.float()
    x1n, T1 = _normalize(x1, w)
    x2n, T2 = _normalize(x2, w)
    Fs, sf, inl_f = fundamental_hypotheses(x1, x2, valid, idx_f, (x1n, T1, x2n, T2))
    best_f = torch.argmax(sf).reshape(1)
    F = Fs.index_select(0, best_f)[0]
    inliers = inl_f.index_select(0, best_f)[0]

    # homography RANSAC (4-point), for the model selection
    Hs = torch.linalg.inv(T2) @ _homography_4pt(x1n[idx_h], x2n[idx_h]) @ T1
    sh = _score_h(Hs, x1, x2, valid)
    # RH = SH / (SH + SF) > 0.45 selects the homography (Initializer.cc);
    # both routes recover the pose through E here
    rh = sh.max() / torch.clamp(sh.max() + sf.max(), min=1e-9)

    # the pose from E = K^T F K: four candidates, chosen by cheirality
    U, _, Vt = torch.linalg.svd(Km.T @ F @ Km)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=dev)
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    cands = lie.rt_to_mat(torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t]))
    P1 = Km @ torch.eye(4, device=dev)[:3]
    Xs, goods = _cheirality(cands, P1, Km, x1, x2, inliers)
    votes = goods.sum(dim=1)
    best = torch.argmax(votes).reshape(1)
    n_good = votes.index_select(0, best)[0]
    ok = (n_good > 50) & (n_good > 0.7 * inliers.sum())

    # resection-intersection refinement: the E-decomposed translation is
    # noisy at narrow baselines, so alternate a mono pose GN of view 2 with
    # triangulation (the role of ORB-SLAM's BA after the monocular map)
    T21 = cands.index_select(0, best)[0]
    good = goods.index_select(0, best)[0]
    X = Xs.index_select(0, best)[0]
    minus_one, one = -torch.ones(n, device=dev), torch.ones(n, device=dev)
    for _ in range(3):
        obs = opt.PoseObs(pw=torch.where(good[:, None], X, 0.0), uv=x2, ur=minus_one,
                          inv_sigma2=one, valid=good)
        T21, _, _ = opt.pose_optimization(T21, obs, K, 0.0, rounds=1, iters=8)
        X, good = _cheirality(T21[None], P1, Km, x1, x2, inliers)
        X, good = X[0], good[0]
    # unit-norm translation (the monocular scale is free)
    tnorm = torch.clamp(torch.linalg.norm(T21[:3, 3]), min=1e-9)
    T21 = lie.rt_to_mat(T21[:3, :3], T21[:3, 3] * (1.0 / tnorm))
    return InitResult(ok=ok, T_21=T21, points=X / tnorm, is_good=good,
                      used_homography=rh > 0.45)
