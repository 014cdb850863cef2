"""Inputs of the ORB front end's kernels (ops/orb_kernel.py): the frames the
card tests and chip_smoke.py hold each kernel to its plain twin on, and the
CPU tests' degenerate frames. Each is made from the port's renderer or a
numpy seed, so every caller makes the same input.

    rendered      the defaults' static scene at 480x640 (frame 0)
    gd_dynamic    the dynamic scene at 480x640 (frame 60) in the GD path's
                  uint8 values
    stereo        the stereo cell's left image (ORB-SLAM2's KITTI00-02.yaml:
                  1241 x 376, 2000 features), uint8 values
    rig           the 120x160 rig, 384 features on 4 levels: levels 1-3 have
                  fewer candidates than their quota (padded rows)
    flat          every pixel 128: no corner, every row invalid
    saturated     every pixel 255: the same
    noise         seeded integer noise: many equal strengths
    checker       8-px squares: every corner the same strength, ties inside
                  and across cells

and the quota's edges (QUOTA_CASES: candidate scores and uv made from a
numpy seed, fed to orb_quota_select alone):

    all_equal     the defaults' levels, every score 33: ties everywhere
    all_zero      the defaults' levels, every score +0: no row valid
    signed_ties   the defaults' levels, scores from {+0, -0, 7.5, 20.25, 33,
                  -1, 1e30} and 30% uniform: ties, both zeros, negatives
    rig_padded    the rig's levels (fewer candidates than the quota above
                  level 0: padded rows)
    stereo_level0 the stereo cell's levels: 3542 candidates at level 0
    one_level_32k one 2048 x 2048 level: 32768 candidates, quota 1000
    exact_quota   a level whose quota is its 32 candidates, then a level of
                  quota 0

the blur's edges (BLUR_CASES: canvases of seeded values inside each level,
+0 outside it as build_pyramid leaves them, fed to gaussian_blur7 alone):

    one_level     L = 1, 70 x 90
    h4            H = 4 (W = 100, 4 levels of 2-4 rows)
    w4            W = 4 (H = 100, 4 levels of 2-4 columns)
    untiled       77 x 93, 5 levels: neither side a multiple of the tile
    tile_sized    64 x 32, one tile, beside levels of 1 x 1, 3 x 2 and 5 x 31
    full_span     levels with h_l = H, with w_l = W and with both
    band_at_edge  levels whose 3-px band meets the canvas edge (h_l + 3 > H,
                  w_l + 3 > W)
    stereo        the stereo cell's canvas, 376 x 1241, 8 levels (rows not
                  16-byte multiples)
    rig           the 120x160 rig's canvas, 4 levels

and the descriptor's edges (DESCRIBE_CASES: keypoints on the pyramid of a
seeded noise frame and its blur, fed to orb_describe alone):

    edges         the defaults' canvas: on every level, discs and patches that
                  leave the canvas on each side and at each corner, centres up
                  to 3 px outside it, and patches that leave the level only
    edges_stereo  the same on the stereo cell's 376 x 1241 canvas
    odd_canvas    the same and 100 inside on a 77 x 93 canvas (no plane starts
                  on a 16-byte boundary but the first)
    levels        40 keypoints inside each of the 8 levels
    bins          600 keypoints on every level: all 30 rotation bins
    n0, n1, n3    0, 1 and 3 keypoints (a CTA part full)
    n_odd         1501 keypoints: not a multiple of a CTA's keypoints
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gdslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig

CASES = ("rendered", "gd_dynamic", "stereo", "rig", "flat", "saturated", "noise", "checker")
KITTI_CAMERA = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                            height=376, bf=386.1448, fps=10.0,
                            th_depth=35.0)
KITTI_ORB = OrbConfig(n_features=2000, scale_factor=1.2, n_levels=8, ini_th_fast=20,
                      min_th_fast=7)
RIG_CAMERA = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
RIG_ORB = OrbConfig(n_features=384, n_levels=4)


def pattern(name: str, height: int, width: int) -> np.ndarray:
    """[height, width] f32 frames of the degenerate cases (numpy only)."""
    if name == "flat":
        return np.full((height, width), 128.0, np.float32)
    if name == "saturated":
        return np.full((height, width), 255.0, np.float32)
    if name == "noise":
        return np.random.default_rng(5).integers(0, 256, (height, width)).astype(np.float32)
    if name == "checker":
        ys, xs = np.mgrid[0:height, 0:width]
        return (((ys // 8 + xs // 8) % 2) * 180 + 40).astype(np.float32)
    raise ValueError(f"no pattern {name}")


def orb_input(name: str, device, cfg: SlamConfig | None = None):
    """(gray [H, W] f32 on device, OrbConfig, CameraConfig) of case `name`;
    cfg: the defaults' configuration (SlamConfig() if None)."""
    from gdslam_tpu_torch.io import synthetic
    cfg = cfg or SlamConfig()
    cam, u8 = cfg.camera, (lambda g: torch.round(g).clamp(0, 255))
    if name == "rendered":
        return synthetic.render_frame(0, cam, with_dynamic=False, device=device).gray, cfg.orb, cam
    if name == "gd_dynamic":
        return u8(synthetic.render_frame(60, cam, with_dynamic=True, device=device).gray), \
            cfg.orb, cam
    if name == "stereo":
        T = synthetic.gt_pose(0, KITTI_CAMERA.fps, device)
        return u8(synthetic.render(T, KITTI_CAMERA, False, KITTI_CAMERA.fps, 0).gray), \
            KITTI_ORB, KITTI_CAMERA
    if name == "rig":
        return synthetic.render_frame(3, RIG_CAMERA, with_dynamic=False, device=device).gray, \
            RIG_ORB, RIG_CAMERA
    gray = torch.from_numpy(pattern(name, cam.height, cam.width)).to(device)
    return gray, cfg.orb, cam


def bin_edge_angles(rcp_bin: float, ulps: int = 4) -> np.ndarray:
    """[30, 2 ulps + 1] f32 angles around each edge of the 30 rotation bins:
    the f32 nearest (b + 0.5) / rcp_bin for b = -15 .. 14, and `ulps` f32
    steps either side of it."""
    out = []
    for b in range(-15, 15):
        e = np.float32((b + 0.5) / np.float32(rcp_bin))
        row, lo, hi = [e], e, e
        for _ in range(ulps):
            lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
            row = [lo, *row, hi]
        out.append(row)
    return np.asarray(out, np.float32)


def axis_moment_pairs(seed: int = 11, n: int = 1000) -> np.ndarray:
    """[k, 2] f32 (m10, m01) pairs on and near the axes: (0, 0) with every
    sign of zero, the axes, denormal and huge components, and n seeded pairs
    with one component 1e-6 of the other."""
    tiny, big = 1.4e-45, 3.0e38
    axes = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (1.0, 0.0), (-1.0, 0.0),
            (0.0, 1.0), (0.0, -1.0), (-1.0, -0.0), (1.0, tiny), (1.0, -tiny), (-1.0, tiny),
            (-1.0, -tiny), (tiny, 1.0), (-tiny, 1.0), (tiny, -1.0), (-tiny, -1.0),
            (big, 1.0), (-big, -1.0), (1.0, big), (3e-7, 2e5), (-2e5, 5e-7), (1e5, -1e5)]
    rng = np.random.default_rng(seed)
    near = rng.normal(0, 1, (n, 2)) * np.where(rng.uniform(size=(n, 1)) < 0.5,
                                               [1.0, 1e-6], [1e-6, 1.0])
    return np.concatenate([np.array(axes), near]).astype(np.float32)


QUOTA_CASES = ("all_equal", "all_zero", "signed_ties", "rig_padded", "stereo_level0",
               "one_level_32k", "exact_quota")


def quota_input(name: str):
    """(scores [C] f32, cand_uv [C, 2] f32 on the CPU, shapes, quotas, scale)
    of quota case `name` (numpy only but for the tensors)."""
    from gdslam_tpu_torch.ops import image, orb, orb_kernel
    cfg = SlamConfig()

    def levels(cam, o):
        shapes = image.pyramid_shapes(cam.height, cam.width, o.n_levels, o.scale_factor)
        return shapes, orb.feature_quotas(o.n_features, o.n_levels, o.scale_factor), \
            o.scale_factor

    shapes, quotas, scale = {
        "rig_padded": lambda: levels(RIG_CAMERA, RIG_ORB),
        "stereo_level0": lambda: levels(KITTI_CAMERA, KITTI_ORB),
        "one_level_32k": lambda: ([(2048, 2048)], [1000], 1.2),
        "exact_quota": lambda: ([(64, 64), (32, 32)], [32, 0], 1.2)}.get(
            name, lambda: levels(cfg.camera, cfg.orb))()
    C = sum(orb_kernel.n_candidates(shapes))
    r = np.random.default_rng(QUOTA_CASES.index(name) + 17)
    if name == "all_equal":
        s = np.full(C, 33.0, np.float32)
    elif name == "all_zero":
        s = np.zeros(C, np.float32)
    else:
        s = r.choice(np.float32([0.0, -0.0, 7.5, 20.25, 33.0, -1.0, 1e30]), C)
        free = r.uniform(size=C) < 0.3
        s[free] = r.uniform(0, 100, int(free.sum()))
    uv = r.uniform(0, 640, (C, 2)).astype(np.float32)
    return torch.from_numpy(s.astype(np.float32)), torch.from_numpy(uv), shapes, quotas, scale


BLUR_CASES = ("one_level", "h4", "w4", "untiled", "tile_sized", "full_span", "band_at_edge",
              "stereo", "rig")


def blur_input(name: str):
    """(canvas [L, H, W] f32 on the CPU, shapes) of blur case `name`: each
    level filled with seeded grey levels (integers, fractions, negatives and
    -0), +0 outside it (numpy only but for the tensor)."""
    from gdslam_tpu_torch.ops import image
    pyr = image.pyramid_shapes
    H, W, shapes = {
        "one_level": lambda: (70, 90, [(70, 90)]),
        "h4": lambda: (4, 100, pyr(4, 100, 4, 1.2)),
        "w4": lambda: (100, 4, pyr(100, 4, 4, 1.2)),
        "untiled": lambda: (77, 93, pyr(77, 93, 5, 1.2)),
        "tile_sized": lambda: (64, 32, [(64, 32), (1, 1), (3, 2), (5, 31)]),
        "full_span": lambda: (150, 200, [(150, 120), (90, 200), (150, 200), (40, 33)]),
        "band_at_edge": lambda: (130, 170, [(128, 169), (127, 167), (129, 100), (60, 168)]),
        "stereo": lambda: (KITTI_CAMERA.height, KITTI_CAMERA.width,
                           pyr(KITTI_CAMERA.height, KITTI_CAMERA.width, KITTI_ORB.n_levels,
                               KITTI_ORB.scale_factor)),
        "rig": lambda: (RIG_CAMERA.height, RIG_CAMERA.width,
                        pyr(RIG_CAMERA.height, RIG_CAMERA.width, RIG_ORB.n_levels,
                            RIG_ORB.scale_factor))}[name]()
    r = np.random.default_rng(BLUR_CASES.index(name) + 31)
    canvas = np.zeros((len(shapes), H, W), np.float32)
    for lv, (h, w) in enumerate(shapes):
        v = r.integers(0, 256, (h, w)).astype(np.float32)
        pick = r.uniform(size=(h, w))
        v[pick < 0.2] = r.uniform(-40, 300, int((pick < 0.2).sum()))
        v[pick > 0.97] = -0.0
        canvas[lv, :h, :w] = v
    return torch.from_numpy(canvas), [tuple(s) for s in shapes]


DESCRIBE_CASES = ("edges", "edges_stereo", "odd_canvas", "levels", "bins", "n0", "n1", "n3",
                  "n_odd")


@functools.lru_cache(maxsize=None)
def describe_canvas(height: int, width: int):
    """(canvas, blurred [8, height, width] f32 on the CPU, shapes): the
    8-level pyramid of a seeded integer noise frame (scale 1.2) and its blur
    (ops/image.gaussian_blur). Cached: read-only."""
    from gdslam_tpu_torch.ops import image
    gray = torch.from_numpy(np.random.default_rng(height + width).integers(
        0, 256, (height, width)).astype(np.float32))
    canvas, shapes = image.build_pyramid(gray, height, width, 8, 1.2)
    return canvas, image.gaussian_blur(canvas, 7, 2.0), shapes


def _edge_keypoints(shapes, H: int, W: int, r) -> np.ndarray:
    """[K, 3] (u, v, level) rows: on every level, centres 0-19 px inside each
    canvas side (the disc's 15 and the patch's 18 cross it), up to 3 px
    outside it, at the four corners, and next to the level's own right and
    bottom edges (the patch leaves the level, not the canvas)."""
    offs = np.float32([-3.0, -1.6, -0.4, 0.0, 1.0, 2.5, 3.49, 14.0, 15.0, 16.0, 17.5, 18.0,
                       19.0])
    rows = []
    for lv, (h, w) in enumerate(shapes):
        for d in offs:
            ui, vi = r.uniform(0, w), r.uniform(0, h)
            rows += [(d, vi, lv), (W - 1 - d, vi, lv), (ui, d, lv), (ui, H - 1 - d, lv),
                     (d, d, lv), (W - 1 - d, H - 1 - d, lv), (d, H - 1 - d, lv),
                     (W - 1 - d, d, lv)]
        rows += [(w - 1 - d, r.uniform(0, h), lv) for d in offs[3:]]
        rows += [(r.uniform(0, w), h - 1 - d, lv) for d in offs[3:]]
    return np.asarray(rows, np.float32)


def describe_input(name: str):
    """(canvas, blurred [L, H, W] f32, uv_lv [N, 2] f32, level [N] int32, all
    on the CPU) of descriptor case `name` (the keypoints from a numpy seed)."""
    H, W = {"edges_stereo": (KITTI_CAMERA.height, KITTI_CAMERA.width),
            "odd_canvas": (77, 93)}.get(name, (480, 640))
    canvas, blurred, shapes = describe_canvas(H, W)
    r = np.random.default_rng(DESCRIBE_CASES.index(name) + 53)

    def inside(n):
        lv = r.integers(0, len(shapes), n)
        hw = np.asarray(shapes, np.float64)[lv]
        return np.stack([r.uniform(0, 1, n) * (hw[:, 1] - 1), r.uniform(0, 1, n) * (hw[:, 0] - 1),
                         lv], 1).astype(np.float32)

    if name in ("edges", "edges_stereo"):
        kp = _edge_keypoints(shapes, H, W, r)
    elif name == "odd_canvas":
        kp = np.concatenate([_edge_keypoints(shapes, H, W, r), inside(100)])
    elif name == "levels":
        kp = np.concatenate([np.stack([r.uniform(0, w - 1, 40), r.uniform(0, h - 1, 40),
                                       np.full(40, lv)], 1) for lv, (h, w) in enumerate(shapes)])
    else:
        kp = inside({"bins": 600, "n0": 0, "n1": 1, "n3": 3, "n_odd": 1501}[name])
    kp = np.asarray(kp, np.float32).reshape(-1, 3)
    return (canvas, blurred, torch.from_numpy(np.ascontiguousarray(kp[:, :2])),
            torch.from_numpy(kp[:, 2].astype(np.int32)))
