"""Pose-graph (essential graph) optimisation after a loop closure (port of
gdslam_tpu.backend.pose_graph).

Replaces Optimizer::OptimizeEssentialGraph (reference Optimizer.cc:997-1260):
the vertices are all keyframe poses; the edges are the spanning tree, the
loop edges and the strong covisibility edges (weight >= 100, minFeat
Optimizer.cc:1022), each measured as the relative pose when the graph is
built (a loop edge carries the loop solver's transform); 20 Gauss-Newton
iterations. RGB-D fixes the scale (Sim3Solver.h:20 bFixScale), so that
graph is over SE3; `optimize_sim3_graph` is the 7-dof graph of monocular
scale drift.

The per-edge Jacobian blocks come from forward-mode products of the
closed-form residual (`solvers.jacobian_fwd`, the JAX package's jacfwd),
and the dense [6K, 6K] normal matrix is assembled by `map_arena.add_rows`,
which sums in a fixed order on the card, then solved by Cholesky
(`cholesky_ex`, which reads no flag on the host). Nothing waits for the
card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend.solvers import jacobian_fwd
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend.extractor import top_k_stable


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor        # [E] int vertex ids
    j: torch.Tensor        # [E]
    T_meas: torch.Tensor   # [E, 4, 4] measured T_i @ inv(T_j)
    weight: torch.Tensor   # [E] float
    valid: torch.Tensor    # [E] bool
    s_meas: Optional[torch.Tensor] = None  # [E] measured relative scale (the
    #                        Sim3 graph: 1 on tree and covisibility edges, the
    #                        loop solver's scale on loop edges)


def build_edges(kf_pose: torch.Tensor, kf_valid: torch.Tensor, kf_parent: torch.Tensor,
                covis: torch.Tensor, loop_i: torch.Tensor, loop_j: torch.Tensor,
                loop_T: torch.Tensor, loop_valid: torch.Tensor, covis_min: int = 100,
                max_covis_edges: int = 2048,
                loop_s: Optional[torch.Tensor] = None) -> PoseGraphEdges:
    """Spanning-tree + covisibility (>= covis_min, the max_covis_edges
    strongest of the upper triangle, lower flat index first among ties) +
    loop edges. With loop_s the edges carry `s_meas` for the Sim3 graph."""
    K = kf_pose.shape[0]
    dev = kf_pose.device
    ids = torch.arange(K, device=dev)

    def rel(i, j):
        return kf_pose[i] @ lie.se3_inverse(kf_pose[j])

    tree_j = kf_parent.clamp(min=0).long()
    tree_valid = kf_valid & (kf_parent >= 0)
    upper = torch.ones((K, K), dtype=torch.bool, device=dev).triu(1)
    w = torch.where(upper & kf_valid[:, None] & kf_valid[None, :], covis, 0)
    top_w, top_idx = top_k_stable(w.reshape(-1), max_covis_edges)
    ci, cj = top_idx // K, top_idx % K
    s_meas = None
    if loop_s is not None:
        s_meas = torch.cat([torch.ones(K + max_covis_edges, device=dev), loop_s.float()])
    return PoseGraphEdges(
        i=torch.cat([ids, ci, loop_i.long()]),
        j=torch.cat([tree_j, cj, loop_j.long()]),
        T_meas=torch.cat([rel(ids, tree_j), rel(ci, cj), loop_T.float()], dim=0),
        weight=torch.cat([torch.ones(K + max_covis_edges, device=dev),
                          torch.full((loop_i.shape[0],), 5.0, device=dev)]),
        valid=torch.cat([tree_valid, top_w >= covis_min, loop_valid]),
        s_meas=s_meas)


def _normal_equations(edges: PoseGraphEdges, r, Ji, Jj, K: int, d: int):
    """H [dK, dK] and b [dK] of the weighted edges: the blocks (i,i), (j,j),
    (i,j), (j,i) and the gradients, summed per target in the JAX package's
    order of scatters."""
    w = edges.weight * edges.valid
    i, j = edges.i, edges.j

    def blk(Ja, Jb):
        return torch.einsum("eri,e,erj->eij", Ja, w, Jb).reshape(-1, d * d)

    tgt = torch.cat([i * K + i, j * K + j, i * K + j, j * K + i])
    blocks = torch.cat([blk(Ji, Ji), blk(Jj, Jj), blk(Ji, Jj), blk(Jj, Ji)])
    H = ma.add_rows(tgt, blocks, torch.ones_like(tgt, dtype=torch.bool), K * K)
    H = H.reshape(K, K, d, d).permute(0, 2, 1, 3).reshape(d * K, d * K)
    g = torch.cat([torch.einsum("eri,e,er->ei", Ji, w, r), torch.einsum("eri,e,er->ei", Jj, w, r)])
    b = ma.add_rows(torch.cat([i, j]), g, torch.ones(2 * i.shape[0], dtype=torch.bool,
                                                     device=g.device), K)
    return H, b.reshape(-1)


def _solve(H, b, mask, damping: float):
    """-H^-1 b on the free rows (identity rows elsewhere), 0 where the
    factorisation fails."""
    Hm = torch.where(mask[:, None] & mask[None, :], H, 0.0)
    Hm = Hm + torch.diag(torch.where(mask, damping, 1.0))
    bv = torch.where(mask, b, 0.0)
    L = torch.linalg.cholesky_ex(Hm)[0]
    dx = -torch.cholesky_solve(bv[:, None], L)[:, 0]
    return torch.where(torch.isfinite(dx), dx, 0.0)


def _edge_residual(xi_i, xi_j, T_i0, T_j0, T_meas):
    T_i = lie.se3_exp(xi_i) @ T_i0
    T_j = lie.se3_exp(xi_j) @ T_j0
    return lie.se3_log(lie.se3_inverse(T_meas) @ (T_i @ lie.se3_inverse(T_j)))


def optimize(kf_pose: torch.Tensor, kf_valid: torch.Tensor, edges: PoseGraphEdges,
             iters: int = 20, fixed_id: int = 0, damping: float = 1e-6) -> torch.Tensor:
    """Gauss-Newton on the SE3 pose graph; returns the updated [K, 4, 4] poses."""
    K = kf_pose.shape[0]
    dev = kf_pose.device
    zero6 = torch.zeros((edges.i.shape[0], 6), device=dev)
    free = kf_valid & (torch.arange(K, device=dev) != fixed_id)
    mask = free.repeat_interleave(6)
    poses = kf_pose
    for _ in range(iters):
        Ti0, Tj0 = poses[edges.i], poses[edges.j]
        r = _edge_residual(zero6, zero6, Ti0, Tj0, edges.T_meas)
        Ji = jacobian_fwd(lambda x: _edge_residual(x, zero6, Ti0, Tj0, edges.T_meas), zero6)
        Jj = jacobian_fwd(lambda x: _edge_residual(zero6, x, Ti0, Tj0, edges.T_meas), zero6)
        H, b = _normal_equations(edges, r, Ji, Jj, K, 6)
        dx = _solve(H, b, mask, damping).reshape(K, 6)
        poses = lie.se3_exp(dx) @ poses
    return lie.se3_orthonormalize(poses)


def _sim3_edge_residual(xi_i, xi_j, Ri0, ti0, si0, Rj0, tj0, sj0, Rm, tm, sm):
    """r = sim3_log(S_meas^-1 o S_i o S_j^-1) in R^7 with S_i and S_j
    perturbed on the left, the 7-dof twin of _edge_residual (g2o EdgeSim3)."""
    Ri, ti, si = lie.sim3_compose(*lie.sim3_exp(xi_i), Ri0, ti0, si0)
    Rj, tj, sj = lie.sim3_compose(*lie.sim3_exp(xi_j), Rj0, tj0, sj0)
    Rji, tji, sji = lie.sim3_compose(Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))
    Re, te, se = lie.sim3_compose(*lie.sim3_inverse(Rm, tm, sm), Rji, tji, sji)
    return lie.sim3_log(Re, te, se)


def optimize_sim3_graph(R0: torch.Tensor, t0: torch.Tensor, s0: torch.Tensor,
                        kf_valid: torch.Tensor, edges: PoseGraphEdges, fix_scale: bool = False,
                        iters: int = 20, fixed_id: int = 0, damping: float = 1e-6):
    """Essential-graph Gauss-Newton over Sim3 vertices S_iw = (R, t, s)
    (Optimizer.cc:997-1260, types_seven_dof_expmap): monocular scale drift
    spreads around the loop through the vertex scales. fix_scale freezes
    every sigma (bFixScale), and the graph reduces to the SE3 one.
    Returns (R [K, 3, 3], t [K, 3], s [K])."""
    K = R0.shape[0]
    dev = R0.device
    E = edges.i.shape[0]
    s_meas = edges.s_meas if edges.s_meas is not None else torch.ones(E, device=dev)
    zero7 = torch.zeros((E, 7), device=dev)
    free = kf_valid & (torch.arange(K, device=dev) != fixed_id)
    mask = free.repeat_interleave(7)
    col = torch.ones(7, device=dev)
    if fix_scale:
        col = (torch.arange(7, device=dev) < 6).float()
        mask = mask & (torch.arange(7, device=dev).repeat(K) != 6)
    R, t, s = R0, t0, s0
    for _ in range(iters):
        args = (R[edges.i], t[edges.i], s[edges.i], R[edges.j], t[edges.j], s[edges.j],
                edges.T_meas[:, :3, :3], edges.T_meas[:, :3, 3], s_meas)
        r = _sim3_edge_residual(zero7, zero7, *args)
        Ji = jacobian_fwd(lambda x: _sim3_edge_residual(x, zero7, *args), zero7) * col
        Jj = jacobian_fwd(lambda x: _sim3_edge_residual(zero7, x, *args), zero7) * col
        H, b = _normal_equations(edges, r, Ji, Jj, K, 7)
        dx = _solve(H, b, mask, damping).reshape(K, 7)
        R, t, s = lie.sim3_compose(*lie.sim3_exp(dx), R, t, s)
    return lie.so3_project(R), t, s
