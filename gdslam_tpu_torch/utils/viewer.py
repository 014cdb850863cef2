"""Headless visualization: frame and map renders to PNG (port of
gdslam_tpu.utils.viewer).

Replaces the Pangolin Viewer/FrameDrawer/MapDrawer stack (reference
Viewer.cc, FrameDrawer.cc:38-167, MapDrawer.cc:44-264) with a headless
renderer: the current frame annotated with its keypoints and an orthographic
top-down map view (points, keyframe positions, covisibility edges), written
as PNGs by the port's own encoder (`io/png.py`). Drawing is host work: the
frame and the arena are read from the card once per call.
"""

from __future__ import annotations

import numpy as np

from gdslam_tpu_torch.io import png


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def draw_frame(gray, frame, status: str = "") -> np.ndarray:
    """FrameDrawer::DrawFrame: gray image + keypoints (a green square at
    each valid keypoint, its centre darkened). Returns [H, W, 3] uint8."""
    img = _host(gray)
    out = np.stack([img] * 3, axis=-1).astype(np.uint8)
    uv = _host(frame.uv)
    valid = _host(frame.valid)
    H, W = img.shape
    for i in np.nonzero(valid)[0]:
        u, v = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if 2 <= u < W - 2 and 2 <= v < H - 2:
            out[v - 2:v + 3, u - 2:u + 3, 1] = 255
            out[v - 1:v + 2, u - 1:u + 2, :] = out[v - 1:v + 2, u - 1:u + 2, :] // 2
    return out


def draw_map(arena, size: int = 640, extent: float = 4.0) -> np.ndarray:
    """MapDrawer: top-down (x-z) orthographic view — map points (white),
    keyframe positions (green), covisibility edges of weight >= 100 (dim)."""
    img = np.zeros((size, size, 3), np.uint8)

    def to_px(x, z):
        u = int((x / extent * 0.5 + 0.5) * size)
        v = int((z / extent * 0.5 + 0.5) * size)
        return u, v

    pts = _host(arena.pt_pos)
    valid = _host(arena.pt_valid)
    for p in pts[valid][:20000]:
        u, v = to_px(p[0], p[2])
        if 0 <= u < size and 0 <= v < size:
            img[v, u] = (200, 200, 200)

    kf_pose = _host(arena.kf_pose)
    kf_valid = _host(arena.kf_valid)
    covis = _host(arena.covis)
    centers = []
    for k in np.nonzero(kf_valid)[0]:
        T = kf_pose[k]
        c = -T[:3, :3].T @ T[:3, 3]
        centers.append((k, c))
        u, v = to_px(c[0], c[2])
        if 1 <= u < size - 1 and 1 <= v < size - 1:
            img[v - 1:v + 2, u - 1:u + 2] = (0, 255, 0)
    idx = {k: c for k, c in centers}
    for k, c in centers:
        for j in np.nonzero(covis[k] >= 100)[0]:
            if j in idx and j > k:
                _draw_line(img, to_px(c[0], c[2]), to_px(idx[j][0], idx[j][2]), (0, 90, 0))
    return img


def _draw_line(img, a, b, color):
    n = max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)
    for t in range(n + 1):
        u = a[0] + (b[0] - a[0]) * t // n
        v = a[1] + (b[1] - a[1]) * t // n
        if 0 <= u < img.shape[1] and 0 <= v < img.shape[0]:
            img[v, u] = color


def save_png(img: np.ndarray, path: str) -> None:
    png.write(path, img)
