"""Depth-map geometric edge detection via surface normals (port of
gdslam_tpu.ops.edges).

Behavioral equivalent of GeoMaskMaker::GetEdge (reference
GeoMaskMaker.cc:854-963): backproject the depth map, estimate per-pixel
normals from cross products of neighboring 3D points, then flag pixels where
neighbors exhibit either a depth-discontinuity/concavity signal (phi_d: the
projection of the neighbor offset on the neighbor normal) or a strong
normal change (phi_c), with the reference's combination rule
`max|phi_d| + 0.05 * max(phi_c) > 0.04`.

Planar: each vector component is an [H, W] plane, and every dot product,
cross product and norm is written out in the JAX package's term order.
Neighbors are `torch.roll`s, so they wrap around the image border as
`jnp.roll` does; the 2-px border band is suppressed afterwards, as there.
"""

from __future__ import annotations

import torch

from gdslam_tpu_torch.config import CameraConfig

EDGE_THRESHOLD = 0.04
PHI_C_WEIGHT = 0.05


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (-dy, -dx), dims=(0, 1))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def depth_edges(depth: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """[H, W] bool: True where the depth surface has a geometric edge."""
    H, W = depth.shape
    dev = depth.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    P = ((u - cam.cx) / cam.fx * depth, (v - cam.cy) / cam.fy * depth, depth)

    # Normals from central-difference cross products.
    dPdu = [0.5 * (_shift(c, 0, 1) - _shift(c, 0, -1)) for c in P]
    dPdv = [0.5 * (_shift(c, 1, 0) - _shift(c, -1, 0)) for c in P]
    n = (dPdu[1] * dPdv[2] - dPdu[2] * dPdv[1],
         dPdu[2] * dPdv[0] - dPdu[0] * dPdv[2],
         dPdu[0] * dPdv[1] - dPdu[1] * dPdv[0])
    n_len = torch.clamp(_norm(n), min=1e-9)
    n = tuple(c / n_len for c in n)

    neighbors = [(-1, 0), (1, 0), (0, -1), (0, 1),
                 (-1, -1), (-1, 1), (1, -1), (1, 1)]
    phi_d_max = torch.zeros((H, W), device=dev)
    phi_c_max = torch.zeros((H, W), device=dev)
    valid = depth > 0
    for dy, dx in neighbors:
        nn = tuple(_shift(c, dy, dx) for c in n)
        vn = _shift(valid, dy, dx)
        diff = tuple(_shift(c, dy, dx) - c for c in P)
        dist = torch.clamp(_norm(diff), min=1e-9)
        # phi_d: distance of the neighbor offset along a surface normal,
        # projected on both normals (at a discontinuity the central-
        # difference normal of one side is corrupted)
        proj = torch.maximum(torch.abs(_dot(diff, nn)), torch.abs(_dot(diff, n)))
        phi_d = proj / dist * torch.clamp(dist, max=1.0)
        phi_c = 1.0 - _dot(n, nn)
        both = valid & vn
        # a neighbor depth step beyond the local noise band is an edge outright
        dz = torch.abs(_shift(depth, dy, dx) - depth)
        jump = dz > (0.02 * depth + 0.02)
        phi_d = torch.maximum(phi_d, jump.float())
        phi_d_max = torch.maximum(phi_d_max, torch.where(both, phi_d, 0.0))
        phi_c_max = torch.maximum(phi_c_max, torch.where(both, phi_c, 0.0))
        # a missing-depth neighbor is itself an edge
        phi_d_max = torch.maximum(phi_d_max, (valid & ~vn).float())

    edge = (phi_d_max + PHI_C_WEIGHT * phi_c_max) > EDGE_THRESHOLD
    # rolled neighbors wrap at the image border; suppress the artifact band
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inner = (ys >= 2) & (ys < H - 2) & (xs >= 2) & (xs < W - 2)
    return edge & valid & inner
