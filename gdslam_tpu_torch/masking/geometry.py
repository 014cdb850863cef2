"""DynaSLAM Geometry module: multi-view dynamic detection + inpainting (port
of gdslam_tpu.masking.geometry).

Re-design of the reference Geometry class (include/Geometry.h,
src/Geometry.cc), the DynaSLAM side of the masking stack:

- a 20-slot keyframe ring DB (`GeometricModelUpdateDB`, Geometry.cc:48-53,
  985-1001) holding gray / depth / mask / colour / pose; `db_insert`
  returns a new DB and leaves the old one as it was;
- reference-frame selection: the 5 DB frames most distant from the current
  pose by 0.7 |dt| + 0.3 |d euler| (`GetRefFrames`, Geometry.cc:55-97);
- `ExtractDynPoints` (Geometry.cc:100-412) as a dense per-pixel test:
  every valid reference pixel is reprojected into the current view and
  flags the pixel it lands on where the predicted depth exceeds the
  window-minimum and the own observed depth by more than 0.6 m on a
  locally flat patch; a majority vote over the references and a 5 x 5
  density filter follow;
- `DepthRegionGrowing` (Geometry.cc:415-450): a bounded flood fill on
  depth from the seeds, then a dilation; `CombineMasks` (:454-468);
- `InpaintFrames` / `FillRGBD` (Geometry.cc:478-945): the DB frames'
  static pixels composited into the current view (a z-buffer, then an
  area-weighted accumulation within a depth band of the winner), filling
  the masked-out holes.

The five references of `extract_dynamic_seeds` and the twenty DB frames of
`inpaint` are processed as one batch (a leading dimension) where the JAX
package loops over them; the results are the same, and the scatters keep
the JAX package's order of updates (frame, then corner, then pixel), so
on the CPU, where a scatter is applied serially, they agree bit for bit.
On the card the float accumulation of `inpaint` is made by atomics, whose
order is not fixed. The programs read nothing on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.frontend.frame import _same_max_pool, dilate_mask
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops.image import fma


class GeometryDB(NamedTuple):
    gray: torch.Tensor    # [D, H, W]
    depth: torch.Tensor   # [D, H, W]
    mask: torch.Tensor    # [D, H, W] 1 = static
    rgb: torch.Tensor     # [D, H, W, 3]
    pose: torch.Tensor    # [D, 4, 4] T_cw
    valid: torch.Tensor   # [D] bool
    cursor: torch.Tensor  # [] int32, the number of inserts


def new_db(size: int, height: int, width: int, device="cuda") -> GeometryDB:
    f32 = dict(dtype=torch.float32, device=device)
    return GeometryDB(
        gray=torch.zeros((size, height, width), **f32),
        depth=torch.zeros((size, height, width), **f32),
        mask=torch.ones((size, height, width), **f32),
        rgb=torch.zeros((size, height, width, 3), **f32),
        pose=torch.eye(4, **f32).repeat(size, 1, 1),
        valid=torch.zeros(size, dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def db_insert(db: GeometryDB, gray, depth, mask, rgb, T_cw) -> GeometryDB:
    """Ring insertion (GeometricModelUpdateDB, Geometry.cc:985-1001) into
    slot cursor % D of a new DB. The slot is a one-element index on the
    device, so nothing is read on the host."""
    i = torch.remainder(db.cursor, db.valid.shape[0]).reshape(1).long()

    def put(t, value):
        return t.index_copy(0, i, value.to(t.dtype).reshape((1,) + t.shape[1:]))

    return GeometryDB(gray=put(db.gray, gray), depth=put(db.depth, depth),
                      mask=put(db.mask, mask), rgb=put(db.rgb, rgb),
                      pose=put(db.pose, T_cw), valid=db.valid.index_fill(0, i, True),
                      cursor=db.cursor + 1)


# The reprojections below round as the JAX package's compiled programs round
# on the CPU: XLA's dot is a chain of fused multiply-adds over the contracted
# index (4 x 4 pose products and the rotation of every point), it folds a
# division by the focal length into a product by its float32 reciprocal, and
# it contracts `x / z * f + c` into one fused multiply-add. The inpainting
# weights amplify a last-bit difference of a projected coordinate some 10^4
# times, and the seed and fill maps are gated on these coordinates.

def _mat4(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (batched) 4 x 4 poses."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, 4):
        acc = fma(A[..., :, k:k + 1], B[..., k:k + 1, :], acc)
    return acc


def _inverse(T: torch.Tensor) -> torch.Tensor:
    """se3_inverse of (batched) poses: (R^T, -R^T t)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    t_inv = torch.stack([fma(R[..., 2, i], t[..., 2],
                             fma(R[..., 1, i], t[..., 1], R[..., 0, i] * t[..., 0]))
                         for i in range(3)], -1)
    return lie.rt_to_mat(R.transpose(-1, -2), -t_inv)


def _backproject(z: torch.Tensor, cam) -> tuple:
    """The camera-frame points (x, y, z) of a depth map z [..., H, W] at
    every pixel."""
    uv = _pixel_grid(z.shape[-2], z.shape[-1], z.device)
    rfx = float(np.float32(1.0) / np.float32(cam.fx))
    rfy = float(np.float32(1.0) / np.float32(cam.fy))
    return (uv[..., 0] - cam.cx) * rfx * z, (uv[..., 1] - cam.cy) * rfy * z, z


def _apply(T: torch.Tensor, p: tuple) -> torch.Tensor:
    """Poses T [B, 4, 4] applied to points p (three [B, H, W] planes) ->
    [B, H, W, 3]."""
    R, t = T[:, None, None, :3, :3], T[:, None, None, :3, 3]
    return torch.stack([fma(R[..., k, 2], p[2], fma(R[..., k, 1], p[1], R[..., k, 0] * p[0]))
                        + t[..., k] for k in range(3)], -1)


def _project(X: torch.Tensor, cam) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points [..., 3] -> (u, v, z)."""
    z = X[..., 2]
    z_safe = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    return (fma(X[..., 0] / z_safe, cam.fx, cam.cx), fma(X[..., 1] / z_safe, cam.fy, cam.cy),
            z)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _pose_distance(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """0.7*|dt| + 0.3*|deuler| (GetRefFrames, Geometry.cc:55-97)."""
    dt = _norm(T_a[..., :3, 3] - T_b[..., :3, 3])
    de = _norm(lie.rotm_to_euler(T_a[..., :3, :3]) - lie.rotm_to_euler(T_b[..., :3, :3]))
    return 0.7 * dt + 0.3 * de


def _min_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """Min over a size x size window (odd, 'SAME'), ignoring zeros (invalid):
    zeros become +inf, which is also what lies outside the image; a window
    with no valid depth gives 0."""
    big = torch.where(x > 0, x, float("inf"))
    y = -_same_max_pool(-big, size)
    return torch.where(torch.isfinite(y), y, 0.0)


def _box_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over a size x size window with edge padding, summed in the JAX
    package's order: rows first, the weighted slices added one after the
    other. The variance gate compares E[z^2] - E[z]^2 with 0.001 at depths of
    metres, so a convolution or pooling call (another summation order) would
    move pixels across it."""
    w = float(np.float32(1.0) / np.float32(size))
    H, W = x.shape
    r = size // 2
    y = x.index_select(0, torch.arange(-r, H + r, device=x.device).clamp(0, H - 1))
    acc = y[0:H] * w
    for i in range(1, size):
        acc = acc + y[i:i + H] * w
    y = acc.index_select(1, torch.arange(-r, W + r, device=x.device).clamp(0, W - 1))
    acc = y[:, 0:W] * w
    for i in range(1, size):
        acc = acc + y[:, i:i + W] * w
    return acc


@functools.lru_cache(maxsize=None)
def _pixel_grid(H: int, W: int, device: torch.device) -> torch.Tensor:
    """[H, W, 2] float pixel coordinates (u, v), made once per device."""
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([u, v], -1)


@functools.lru_cache(maxsize=None)
def _cos_deg(deg: float) -> float:
    """cos(deg) rounded as the JAX package computes it, in float32."""
    return torch.cos(torch.deg2rad(torch.tensor(deg, dtype=torch.float32))).item()


def _window_sum(m: torch.Tensor, size: int) -> torch.Tensor:
    """Sum of a 0/1 map over an odd size x size window, zeros outside (exact
    for these integer counts)."""
    return F.avg_pool2d(m.float()[None, None], size, stride=1, padding=size // 2,
                        count_include_pad=True, divisor_override=1)[0, 0]


def extract_dynamic_seeds(db: GeometryDB, cur_depth: torch.Tensor, T_cw: torch.Tensor,
                          cfg: SlamConfig) -> torch.Tensor:
    """Dense ExtractDynPoints: [H, W] bool seed map in the current view."""
    cam, g = cfg.camera, cfg.geometry
    H, W = cam.height, cam.width
    dev = cur_depth.device

    # The max_ref_frames most distant valid DB frames (lower slot first
    # among ties, as lax.top_k gives them); empty slots score -1.
    score = torch.where(db.valid, _pose_distance(db.pose, T_cw[None]), -1.0)
    ref_score, ref_ids = extractor.top_k_stable(score, g.max_ref_frames)
    ref_ok = ref_score > 0

    # Window minimum of the current depth (the occluding-depth search,
    # (2*20+1)^2 at 640 px wide, Geometry.cc:1036) and the local flatness
    # (variance over the 41x41-equivalent patch); radii scale with width.
    scale = max(cam.width / 640.0, 1.0 / 8.0)
    radius = max(int(round(g.window_radius * scale)), 2)
    cur_min_depth = _min_pool(cur_depth, 2 * radius + 1)
    vwin = 2 * max(int(round(20 * scale)), 2) + 1
    mean = _box_mean(cur_depth, vwin)
    var = _box_mean(cur_depth * cur_depth, vwin) - mean * mean

    # every reference at once: [R, H, W]
    z_ref = db.depth.index_select(0, ref_ids)
    m_ref = db.mask.index_select(0, ref_ids)
    T_ref = db.pose.index_select(0, ref_ids)
    p_ref = _backproject(z_ref, cam)
    T_ref_inv = _inverse(T_ref)
    u_c, v_c, z_proj = _project(_apply(_mat4(T_cw, T_ref_inv), p_ref), cam)
    in_img = (u_c >= 0) & (u_c < W - 1) & (v_c >= 0) & (v_c < H - 1) & (z_proj > 0)
    # Parallax filter < 30 deg (Geometry.cc:158,176): the angle between the
    # rays from the reference and the current camera centres to the point.
    o_ref = T_ref_inv[:, :3, 3]
    o_cur = _inverse(T_cw)[:3, 3]
    X_w = _apply(T_ref_inv, p_ref)
    r1 = X_w - o_ref[:, None, None]
    r2 = X_w - o_cur
    cosang = torch.sum(r1 * r2, dim=-1) / torch.clamp(_norm(r1) * _norm(r2), min=1e-9)
    low_parallax = cosang > _cos_deg(g.parallax_deg)
    valid = ref_ok[:, None, None] & in_img & (z_ref > 0) & (z_ref < 6.0) & (m_ref > 0.5) & \
        low_parallax
    uv_c = torch.stack([u_c, v_c], -1)
    z_obs = image_ops.bilinear_sample(cur_min_depth, uv_c)
    var_at = image_ops.bilinear_sample(var, uv_c)
    dyn = valid & (z_proj - z_obs > g.depth_threshold) & (z_obs > 0) & \
        (var_at < g.var_threshold)
    # the projected pixel itself must be the occluder (not merely have an
    # occluder somewhere in its window)
    own_depth = image_ops.bilinear_sample(cur_depth, uv_c)
    dyn = dyn & (own_depth > 0) & (z_proj - own_depth > g.depth_threshold)

    # The evidence lands at the projected pixel: an OR per reference (the
    # JAX scatter-max of booleans), made as an integer count > 0, which has
    # no order on the card.
    R = ref_ids.shape[0]
    ui = torch.round(u_c).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(v_c).to(torch.int64).clamp(0, H - 1)
    flat = torch.arange(R, device=dev)[:, None, None] * (H * W) + vi * W + ui
    hits = torch.zeros(R * H * W, dtype=torch.int32, device=dev).index_add_(
        0, flat.reshape(-1), dyn.reshape(-1).to(torch.int32))
    votes = (hits.view(R, H, W) > 0).sum(0)
    # A moving object is inconsistent against every reference, static
    # parallax bands only against the wide-baseline ones: a majority vote.
    need = torch.clamp(ref_ok.sum(), min=1, max=3)
    seeds = votes >= need
    # Density filter: dynamic surfaces give clusters of seeds; isolated ones
    # are pose-error or boundary noise that would flood-fill a smooth band.
    return seeds & (_window_sum(seeds, 5) >= 5)


def depth_region_growing(seeds: torch.Tensor, depth: torch.Tensor, threshold: float = 0.20,
                         iters: int = 64, dilation: int = 15) -> torch.Tensor:
    """DepthRegionGrowing (Geometry.cc:415-450): bounded flood fill where a
    4-neighbour of the region has depth within `threshold`, then dilation.

    Each region pixel carries its seed's depth; growth also needs the new
    pixel within 1.5 * threshold of it (pure neighbour chaining drifts
    across smooth surfaces). Neighbours wrap around the border (jnp.roll),
    and the four directions update the region and the seed depths one
    after the other inside an iteration, as in the JAX package. The
    neighbour-depth test does not change between iterations and is made
    once per direction."""
    seed0 = seeds & (depth > 0)
    region = seed0
    sdepth = torch.where(seed0, depth, 0.0)
    dirs = []
    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        near = (depth > 0) & (torch.abs(depth - torch.roll(depth, shift, (0, 1))) < threshold)
        dirs.append((shift, near))
    for _ in range(iters):
        for shift, near in dirs:
            nb_seed = torch.roll(sdepth, shift, (0, 1))
            grow = torch.roll(region, shift, (0, 1)) & ~region & near & \
                (torch.abs(depth - nb_seed) < 1.5 * threshold)
            sdepth = torch.where(grow, nb_seed, sdepth)
            region = region | grow
    return dilate_mask(region, dilation)


def combine_masks(sem_mask: torch.Tensor, geo_dynamic: torch.Tensor) -> torch.Tensor:
    """CombineMasks (Geometry.cc:454-468): static = semantic AND not-geo."""
    return torch.minimum(sem_mask, 1.0 - geo_dynamic.float())


def correction_dynamic_mask(db: GeometryDB, cur_depth: torch.Tensor, T_cw: torch.Tensor,
                            cfg: SlamConfig) -> torch.Tensor:
    """ExtractDynPoints + DepthRegionGrowing as one unit: the [H, W] bool
    dynamic mask of GeometricModelCorrection (Geometry.cc:29-40).

    At 240 rows and above the stage runs on the half grid (intrinsics halved,
    depths subsampled [::2, ::2], never averaged across discontinuities; 40
    growth iterations) with the metric thresholds unchanged, and the grown
    mask is repeated 2 x 2 and cropped to the full grid."""
    cam, g = cfg.camera, cfg.geometry
    if cam.height < 240:
        seeds = extract_dynamic_seeds(db, cur_depth, T_cw, cfg)
        dil = max(int(round(g.dilation_px * cam.width / 640.0)), 2)
        return depth_region_growing(seeds, cur_depth, g.region_growing_threshold, 64, dil)
    Hf, Wf = cam.height, cam.width
    cam_h = dataclasses.replace(cam, fx=cam.fx / 2, fy=cam.fy / 2, cx=cam.cx / 2,
                                cy=cam.cy / 2, width=(Wf + 1) // 2, height=(Hf + 1) // 2)
    cfg_h = dataclasses.replace(cfg, camera=cam_h)
    # views: only the selected references are copied
    db_h = db._replace(gray=db.gray[:, ::2, ::2], depth=db.depth[:, ::2, ::2],
                       mask=db.mask[:, ::2, ::2], rgb=db.rgb[:, ::2, ::2])
    d_h = cur_depth[::2, ::2]
    seeds = extract_dynamic_seeds(db_h, d_h, T_cw, cfg_h)
    dil = max(int(round(g.dilation_px * cam.width / 640.0 / 2)), 2)
    grown = depth_region_growing(seeds, d_h, g.region_growing_threshold, 40, dil)
    return grown.repeat_interleave(2, 0).repeat_interleave(2, 1)[:Hf, :Wf]


def inpaint(db: GeometryDB, cur_rgb, cur_depth, cur_mask, T_cw, cfg: SlamConfig):
    """FillRGBD (Geometry.cc:478-945): composite the DB frames' static pixels
    into the current view with min-depth occlusion; fill only where
    cur_mask == 0 or the depth is missing. Returns (rgb_out, depth_out).

    Every source pixel lands at a non-integer position and goes to its 4
    bilinear corners with area weights (the reference's Area accumulators,
    Geometry.cc:587-601). Pass 1 is a z-buffer: per target pixel the least
    projected depth over every DB frame (scatter-min, exact in any order).
    Pass 2 accumulates (w, w * rgb, w * z) of the contributions within
    max(0.04 z, 0.05) m of that winner. Idle rows go to a dump slot HW of an
    HW + 1 buffer. All DB frames and corners form one batch, in the JAX
    package's order (frame, corner, pixel)."""
    cam, g = cfg.camera, cfg.geometry
    H, W = cam.height, cam.width
    HW = H * W
    D = db.valid.shape[0]
    u_f, v_f, z_proj = _project(_apply(_mat4(T_cw, _inverse(db.pose)),
                                       _backproject(db.depth, cam)), cam)
    src_ok = db.valid[:, None, None] & (db.depth > g.min_depth_threshold) & \
        (db.mask > 0.5) & (z_proj > g.min_depth_threshold) & \
        (u_f >= 0) & (u_f < W - 1) & (v_f >= 0) & (v_f < H - 1)
    u0, v0 = torch.floor(u_f), torch.floor(v_f)
    du, dv = u_f - u0, v_f - v0
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)
    # [D, 4, H, W]: the corners (u0, v0), (u0+1, v0), (u0, v0+1), (u0+1, v0+1)
    idx = torch.stack([v0 * W + u0, v0 * W + u0 + 1, (v0 + 1) * W + u0,
                       (v0 + 1) * W + u0 + 1], 1)
    w = torch.stack([(1 - du) * (1 - dv), du * (1 - dv), (1 - du) * dv, du * dv], 1)
    z4 = z_proj[:, None].expand(D, 4, H, W)
    ok4 = src_ok[:, None] & (w > 1e-6)

    # pass 1: the bilinear-corner z-buffer
    best_z = torch.full((HW + 1,), float("inf"), device=cur_depth.device).scatter_reduce_(
        0, torch.where(ok4, idx, HW).reshape(-1),
        torch.where(ok4, z4, float("inf")).reshape(-1), "amin", include_self=True)

    # pass 2: (w, w*rgb, w*z) within the depth band of the z-buffer winner,
    # which rejects contributions occluded by a nearer surface
    near = z4 <= best_z[idx.clamp(0, HW - 1)] + torch.clamp(0.04 * z4, min=0.05)
    keep = ok4 & near
    flat = torch.where(keep, idx, HW).reshape(-1)
    wk = torch.where(keep, w, 0.0)
    acc_w = torch.zeros(HW + 1, device=cur_depth.device).index_add_(0, flat, wk.reshape(-1))
    acc_z = torch.zeros(HW + 1, device=cur_depth.device).index_add_(
        0, flat, (wk * z4).reshape(-1))
    acc_rgb = torch.stack([torch.zeros(HW + 1, device=cur_depth.device).index_add_(
        0, flat, (wk * db.rgb[:, None, ..., c]).reshape(-1)) for c in range(3)], -1)
    acc_w = acc_w[:HW].view(H, W)
    wsum = torch.clamp(acc_w, min=1e-9)
    mean_rgb = acc_rgb[:HW].view(H, W, 3) / wsum[..., None]
    mean_z = acc_z[:HW].view(H, W) / wsum
    have = (acc_w > 1e-6) & torch.isfinite(best_z[:HW].view(H, W))
    fill = ((cur_mask < 0.5) | (cur_depth <= 0)) & have
    return torch.where(fill[..., None], mean_rgb, cur_rgb), torch.where(fill, mean_z, cur_depth)


class Geometry:
    """Host wrapper mirroring the reference Geometry object lifecycle. It
    keeps on the host the number of frames inserted, so that "the DB has an
    entry" needs no read of the card."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        cam = cfg.camera
        self.db = new_db(cfg.geometry.max_db_size, cam.height, cam.width, device)
        self.inserted = 0

    def geometric_model_correction(self, cur_depth, T_cw, sem_mask):
        """GeometricModelCorrection (Geometry.cc:29-40): the refined static
        mask for the current frame (the semantic mask while the DB is empty)."""
        if self.inserted == 0:
            return sem_mask
        return combine_masks(sem_mask, correction_dynamic_mask(self.db, cur_depth, T_cw,
                                                               self.cfg))

    def inpaint_frames(self, cur_rgb, cur_depth, cur_mask, T_cw):
        return inpaint(self.db, cur_rgb, cur_depth, cur_mask, T_cw, self.cfg)

    def insert(self, gray, depth, mask, rgb, T_cw):
        self.db = db_insert(self.db, gray, depth, mask, rgb, T_cw)
        self.inserted += 1

    def update_db(self, gray, depth, mask, rgb, T_cw, is_keyframe: bool):
        if is_keyframe:
            self.insert(gray, depth, mask, rgb, T_cw)
