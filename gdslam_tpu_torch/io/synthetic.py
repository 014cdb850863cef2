"""Synthetic RGB-D sequence generator with exact ground truth (port of
gdslam_tpu.io.synthetic).

A ray-cast textured box room (closed-form ray/plane and ray/sphere hits,
so RGB-D frames are perfectly multi-view consistent) seen along a smooth
TUM-walking-style camera trajectory, plus an optional moving sphere as the
dynamic object. Same scene, trajectory and texture as the JAX renderer;
the sin-hash texture amplifies float rounding differences, so gray values
agree closely but not bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gdslam_tpu_torch.config import CameraConfig
from gdslam_tpu_torch.core import lie


class RenderedFrame(NamedTuple):
    gray: torch.Tensor      # [H, W] float32 in [0, 255]
    depth: torch.Tensor     # [H, W] float32 meters (0 = invalid)
    rgb: torch.Tensor       # [H, W, 3] float32 in [0, 255]
    dyn_mask: torch.Tensor  # [H, W] bool, True where the dynamic object is
    T_wc: torch.Tensor      # [4, 4] ground-truth camera-to-world pose


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: float) -> torch.Tensor:
    """Deterministic lattice hash -> [0, 1)."""
    h = torch.sin(ix * 127.1 + iy * 311.7 + seed * 74.7) * 43758.5453
    return h - torch.floor(h)


def value_noise(x: torch.Tensor, y: torch.Tensor, seed: float = 0.0,
                octaves: int = 4) -> torch.Tensor:
    """Multi-octave value noise in [0, 1] — the wall/floor texture."""
    out = torch.zeros_like(x)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        xf, yf = x * freq, y * freq
        ix, iy = torch.floor(xf), torch.floor(yf)
        fx, fy = xf - ix, yf - iy
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        v00 = _hash2(ix, iy, seed + o)
        v10 = _hash2(ix + 1, iy, seed + o)
        v01 = _hash2(ix, iy + 1, seed + o)
        v11 = _hash2(ix + 1, iy + 1, seed + o)
        v = (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy
        out = out + amp * v
        norm += amp
        amp *= 0.55
        freq *= 2.3
    return out / norm


# Box room (normal, offset, texture seed); point p is on a plane when n.p = offset.
_N_BACK = (0.25, 0.15, 0.956)
_PLANES = (
    (_N_BACK, 2.8, 1.0),                # tilted back wall, ~2.9 m on axis
    ((0.0, 1.0, 0.0), 1.25, 2.0),       # floor
    ((0.0, 1.0, 0.0), -1.25, 3.0),      # ceiling
    ((1.0, 0.0, 0.0), 1.7, 4.0),        # right wall
    ((1.0, 0.0, 0.0), -1.7, 5.0),       # left wall
    ((0.12, -0.08, 0.989), -2.3, 6.0),  # tilted front wall behind the start pose
)

# Static clutter spheres (center, radius, seed) for depth diversity.
_STATIC_SPHERES = (
    ((-0.7, 0.45, 1.6), 0.28, 11.0),
    ((0.8, -0.35, 2.0), 0.33, 12.0),
    ((0.1, 0.7, 1.3), 0.22, 13.0),
    ((-0.9, -0.6, 2.3), 0.38, 14.0),
    ((0.55, 0.5, 2.45), 0.3, 15.0),
    ((-0.15, -0.2, 1.05), 0.16, 16.0),
    ((0.6, 0.4, -1.4), 0.3, 17.0),
    ((-0.75, -0.3, -1.8), 0.35, 18.0),
    ((0.05, 0.55, -0.9), 0.2, 19.0),
    ((-0.4, 0.1, -2.0), 0.28, 20.0),
    ((1.3, 0.2, 0.6), 0.24, 21.0),
    ((-1.25, -0.4, 0.9), 0.26, 22.0),
)

SPHERE_RADIUS = 0.35


def gt_pose(frame_idx, fps: float = 30.0, device="cpu") -> torch.Tensor:
    """Ground-truth T_wc: smooth sinusoidal translation + gentle rotation."""
    t = torch.tensor(frame_idx, dtype=torch.float32, device=device) / fps
    xi = torch.stack([
        0.35 * torch.sin(0.9 * t),
        0.15 * torch.sin(0.6 * t + 0.5),
        0.25 * torch.sin(0.45 * t + 1.1),
        0.04 * torch.sin(0.5 * t + 0.3),
        0.06 * torch.sin(0.4 * t),
        0.03 * torch.sin(0.7 * t + 0.9),
    ])
    return lie.se3_exp(xi)


def _pose_from(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, device=t.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]), torch.stack([-s, z, c])])


def gt_pose_loop(frame_idx, n_frames: int, device="cpu") -> torch.Tensor:
    """Closed-loop revisit trajectory T_wc for loop-closure runs: a full yaw
    circuit with a small orbit, back at the first view at frame n_frames
    (fr2_desk-style revisit)."""
    th = 2.0 * math.pi * torch.tensor(frame_idx, dtype=torch.float32, device=device) / n_frames
    trans = torch.stack([0.25 * torch.sin(th), 0.05 * torch.sin(2 * th),
                         0.15 * (1 - torch.cos(th))])
    ax = 0.03 * torch.sin(2 * th)
    cx, sx, z, o = torch.cos(ax), torch.sin(ax), torch.zeros_like(ax), torch.ones_like(ax)
    Rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, cx, -sx]), torch.stack([z, sx, cx])])
    return _pose_from(_rot_y(th) @ Rx, trans)


def gt_pose_loop_mono(frame_idx, n_frames: int, device="cpu") -> torch.Tensor:
    """Closed-loop revisit trajectory with parallax for monocular runs: a
    wide lateral oval (up to ~1.8 m) with a mild look-around yaw (+-0.35 rad)
    facing the textured back wall."""
    th = 2.0 * math.pi * torch.tensor(frame_idx, dtype=torch.float32, device=device) / n_frames
    c = torch.stack([0.9 * torch.sin(th), 0.06 * torch.sin(2.0 * th),
                     0.30 * (1.0 - torch.cos(th))])
    return _pose_from(_rot_y(0.35 * torch.sin(th)), c)


def sphere_center(frame_idx, fps: float = 30.0, device="cpu") -> torch.Tensor:
    """Dynamic object: sphere sweeping across the view."""
    t = torch.tensor(frame_idx, dtype=torch.float32, device=device) / fps
    return torch.stack([
        0.7 * torch.sin(1.7 * t),
        0.3 * torch.sin(1.3 * t + 0.7) + 0.2,
        1.9 + 0.3 * torch.sin(0.9 * t + 0.2),
    ])


def render(T_wc: torch.Tensor, cam: CameraConfig, with_dynamic: bool = True,
           fps: float = 30.0, frame_idx=0) -> RenderedFrame:
    """Ray-cast one RGB-D frame from pose T_wc (on T_wc's device)."""
    dev = T_wc.device
    H, W = cam.height, cam.width

    def vec(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    # Camera-frame ray dirs with z = 1 so camera depth == ray parameter s.
    d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                         torch.ones_like(u)], dim=-1)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d = torch.einsum("ij,hwj->hwi", R, d_cam)

    best_s = torch.full((H, W), 1e9, device=dev)
    best_tex = torch.zeros((H, W), device=dev)
    best_tint = torch.ones((H, W, 3), device=dev)
    for (n, off, seed) in _PLANES:
        n_arr = vec(n) / float(np.linalg.norm(n))
        denom = torch.einsum("hwi,i->hw", d, n_arr)
        s = (off - torch.dot(o, n_arr)) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        p = o[None, None] + s[..., None] * d
        # plane-local 2D texture coords: the two axes most orthogonal to n
        ax = int(np.argmax(np.abs(n)))
        a1, a2 = [i for i in range(3) if i != ax]
        tex = value_noise(p[..., a1] * 3.1, p[..., a2] * 3.1, seed)
        hit = (s > 0.05) & (s < best_s)
        best_tex = torch.where(hit, tex, best_tex)
        tint = vec([0.9 + 0.1 * seed / 5.0, 1.0 - 0.08 * seed / 5.0, 0.85])
        best_tint = torch.where(hit[..., None], tint[None, None], best_tint)
        best_s = torch.where(hit, s, best_s)

    def add_sphere(state, c, radius, seed, tint):
        best_s, best_tex, best_tint = state
        oc = o - c
        b = torch.einsum("hwi,i->hw", d, oc)
        dnorm2 = torch.sum(d * d, dim=-1)
        disc = b * b - dnorm2 * (torch.dot(oc, oc) - radius ** 2)
        s_sph = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / dnorm2
        hit = (disc > 0) & (s_sph > 0.05) & (s_sph < best_s)
        rel = o[None, None] + s_sph[..., None] * d - c
        tex_s = value_noise(rel[..., 0] * 14.0 + 9.0, rel[..., 1] * 14.0, seed)
        best_tex = torch.where(hit, tex_s, best_tex)
        best_tint = torch.where(hit[..., None], vec(tint)[None, None], best_tint)
        best_s = torch.where(hit, s_sph, best_s)
        return (best_s, best_tex, best_tint), hit

    state = (best_s, best_tex, best_tint)
    for (c, r, seed) in _STATIC_SPHERES:
        state, _ = add_sphere(state, vec(c), r, seed, (0.8, 0.9, 1.0))

    dyn_mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    if with_dynamic:
        state, dyn_mask = add_sphere(state, sphere_center(frame_idx, fps, dev),
                                     SPHERE_RADIUS, 7.0, (1.0, 0.75, 0.7))
    best_s, best_tex, best_tint = state

    shade = 40.0 + 190.0 * best_tex
    rgb = torch.clamp(shade[..., None] * best_tint, 0, 255)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    depth = torch.where(best_s < 1e8, best_s, 0.0)
    return RenderedFrame(gray=gray, depth=depth, rgb=rgb, dyn_mask=dyn_mask, T_wc=T_wc)


def render_frame(frame_idx: int, cam: CameraConfig, with_dynamic: bool = True,
                 fps: float = 30.0, device="cuda") -> RenderedFrame:
    return render(gt_pose(frame_idx, fps, device), cam, with_dynamic, fps,
                  frame_idx=frame_idx)
