"""GeoMaskMaker: dense-scene-flow dynamic-object masking, the GD novelty
(port of gdslam_tpu.masking.geomask).

Re-design of the reference GeoMaskMaker (include/GeoMaskMaker.h,
src/GeoMaskMaker.cc), after Alcantarilla et al. 2012 adapted to RGB-D: pair
frame t with frame t-5 (5-slot ring buffer, GeoMaskMaker.h:55,
cc:409-429), estimate their relative pose from feature matches (GetRt,
cc:77-156), compute dense optical flow (GetFlow, cc:158-166), and flag
pixels whose flow-warped 3D position disagrees with the rigid-motion
prediction by a large Mahalanobis distance (GetNoGMMmask, cc:167-326):

    d(p)      = X_cur(p + flow(p)) - (R * X_ref(p) + T)
    Sigma(p)  = J S J^T,  S = diag(sig_px^2 x4, depth_var(z_ref),
                                   depth_var(z_cur))
    depth_var = ((sigma/f) z^2)^2       (depth2std, cc:1386-1391, sigma=0.5)
    m(p)      = sqrt(d^T Sigma^-1 d)

then normalize m to [0, 255] between its minimum and the 99.5th
percentile of the valid pixels and threshold at 20 (and m >= 15). Depth
gates, depth-edge rejection and a photometric flow gate apply; frames
with < 20 pose inliers keep the semantic mask (cc:145-148), as do the first
5 frames (cc:171-175).

Everything is plain tensor code on the device; no value is read on the
host. The pose RANSAC draws as the JAX package does, under the caller's
key: fold_in(PRNGKey(7), frame_id) on the fast path (`fold`, the frame id on
the device), a split chain from PRNGKey(7) in GeoMaskMaker.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from gdslam_tpu_torch.backend import solvers
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import camera as cam_ops
from gdslam_tpu_torch.core import prng
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.frontend.extractor import Features
from gdslam_tpu_torch.frontend.frame import dilate_mask, erode_mask
from gdslam_tpu_torch.ops import edges as edge_ops
from gdslam_tpu_torch.ops import flow as flow_ops
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops.match_kernel import BIG, match_top2


def res_factor(cfg: SlamConfig) -> int:
    """Downsample factor of the Mahalanobis grid: 4 at >= 480 rows, 2 at
    >= 240, 1 on small rigs where blobs would starve."""
    h = cfg.camera.height
    return 4 if h >= 480 else (2 if h >= 240 else 1)


def use_half_res(cfg: SlamConfig) -> bool:
    """Whether the masker runs on a reduced grid."""
    return res_factor(cfg) > 1


def _pool(img: torch.Tensor, Hf: int, Wf: int, s: int) -> torch.Tensor:
    """s x s mean pool (antialiased reduced-res gray for the photometric
    gate), edge-padded back to the ceil shape."""
    He, We = Hf - (Hf % s), Wf - (Wf % s)
    g = img[:He, :We].reshape(He // s, s, We // s, s).mean(dim=(1, 3))
    H, W = -(-Hf // s), -(-Wf // s)
    if g.shape != (H, W):
        g = F.pad(g[None], (0, W - g.shape[1], 0, H - g.shape[0]), mode="replicate")[0]
    return g


def _otsu_threshold(dist: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked Otsu scan over a 256-bin histogram (the reference computes this
    at cc:283-314 then discards it; kept behind use_otsu)."""
    bins = torch.clamp(dist.to(torch.int32), 0, 255).reshape(-1).long()
    hist = torch.zeros(256, device=dist.device).index_add_(0, bins, valid.reshape(-1).float())
    total = torch.clamp(hist.sum(), min=1.0)
    p = hist / total
    omega = torch.cumsum(p, 0)
    mu = torch.cumsum(p * torch.arange(256, device=dist.device), 0)
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-9,
                          (mu[-1] * omega - mu) ** 2 / torch.clamp(denom, min=1e-9), 0.0)
    return torch.argmax(sigma_b).float()


def _quantile_995(m: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 99.5th percentile of m over the valid pixels by 12 bisection
    steps of counting from [lo, max], resolved to max / 4096, as the JAX
    package computes it (torch.quantile would normalize differently)."""
    target = 0.995 * valid.sum().float()
    hi = torch.where(valid, m, 0.0).amax()
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        below = ((m <= mid) & valid).sum().float() < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def mahalanobis_mask(ref_depth, cur_depth, flow, T_cur_ref, sem_mask, cfg: SlamConfig,
                     use_otsu: bool = False, ref_gray=None, cur_gray=None,
                     flow_factor: int = 1):
    """GetNoGMMmask core (GeoMaskMaker.cc:167-326), planar.

    The mask is indexed by the FIRST frame's pixel grid; `flow` maps
    first-frame pixels into the second frame and T_cur_ref maps first-frame
    camera coords into the second (the caller passes the current frame
    first, so the mask is aligned with the frame it culls). At >= 240 rows
    the program runs on a grid reduced by res_factor(cfg) and the mask is
    upsampled (nearest) at the end. flow_factor: the factor at which `flow`
    is expressed (s: [H/s, W/s, 2] in /s-pixel units; 1: full-res, which is
    subsampled here).

    Returns (mask [H, W] float 1 = static, dist_norm [H, W] in [0, 255])."""
    cam = cfg.camera
    gcfg = cfg.geomask
    Hf, Wf = cam.height, cam.width
    s = res_factor(cfg)
    if s > 1:
        # pixel (vh, uh) of the reduced grid covers full-res (s vh, s uh):
        # the intrinsics divide by s
        H, W = -(-Hf // s), -(-Wf // s)
        fx, fy, cx, cy = cam.fx / s, cam.fy / s, cam.cx / s, cam.cy / s
        cam_h = dataclasses.replace(cam, fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H)
        ref_depth = ref_depth[::s, ::s]   # nearest: never average true depths
        cur_depth = cur_depth[::s, ::s]   # across discontinuities
        if flow_factor == s:
            fl = flow
        else:
            assert flow_factor == 1, "flow must be full-res or at res_factor"
            fl = flow[::s, ::s] * (1.0 / s)
    else:
        H, W = Hf, Wf
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        cam_h = cam
        fl = flow
    dev = ref_depth.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    z_ref = ref_depth
    uc, vc = u + fl[..., 0], v + fl[..., 1]
    uv_cur = torch.stack([uc, vc], dim=-1)
    z_cur = image_ops.bilinear_sample(cur_depth, uv_cur)
    in_img = (uc >= 0) & (uc < W - 1) & (vc >= 0) & (vc < H - 1)

    # validity: depth gates (cc:229) + edge rejection on both frames
    # (cc:198-199, 224-228)
    ref_edges = edge_ops.depth_edges(ref_depth, cam_h)
    cur_edges = edge_ops.depth_edges(cur_depth, cam_h)
    cur_edge_at = image_ops.bilinear_sample(cur_edges.float(), uv_cur) > 0.1
    valid = (z_ref > 0) & (z_ref <= gcfg.max_depth) & \
            (z_cur > 0) & (z_cur <= gcfg.max_depth) & \
            in_img & ~ref_edges & ~cur_edge_at
    if ref_gray is not None and cur_gray is not None:
        # flow-quality gate: a photometrically inconsistent warp has
        # unreliable flow; on the reduced grid the grays are mean-pooled
        if s > 1:
            rg, cg = _pool(ref_gray, Hf, Wf, s), _pool(cur_gray, Hf, Wf, s)
        else:
            rg, cg = ref_gray, cur_gray
        warped = image_ops.bilinear_sample(cg, uv_cur)
        valid = valid & (torch.abs(warped - rg) < 30.0)

    # planar: one [H, W] plane per vector / matrix component; R and T are
    # 0-d device tensors
    R, T = T_cur_ref[:3, :3], T_cur_ref[:3, 3]
    xr = (u - cx) / fx * z_ref
    yr = (v - cy) / fy * z_ref
    xc = (uc - cx) / fx * z_cur
    yc = (vc - cy) / fy * z_cur
    dx = xc - (R[0, 0] * xr + R[0, 1] * yr + R[0, 2] * z_ref + T[0])
    dy = yc - (R[1, 0] * xr + R[1, 1] * yr + R[1, 2] * z_ref + T[1])
    dz = z_cur - (R[2, 0] * xr + R[2, 1] * yr + R[2, 2] * z_ref + T[2])

    sigma = gcfg.depth_sigma
    # depth2std is a sensor model: the physical focal length on any grid
    f_mean = 0.5 * (cam.fx + cam.fy)
    var_zc = ((sigma / f_mean) * z_cur * z_cur) ** 2      # depth2std^2 (cc:1386)
    var_zr = ((sigma / f_mean) * z_ref * z_ref) ** 2
    # 1 full-res pixel of keypoint / flow noise is 1/s grid pixels
    sig_px = 1.0 / (s * s)

    def backproj_cov(uu, vv, z, var_z):
        """J S J^T for J = d(backproject)/d(u, v, z), S = diag(s, s, var_z):
        the six unique components of the symmetric 3x3, as planes."""
        gx = (uu - cx) / fx
        gy = (vv - cy) / fy
        zfx = z / fx
        zfy = z / fy
        return (sig_px * zfx * zfx + var_z * gx * gx, var_z * gx * gy, var_z * gx,
                sig_px * zfy * zfy + var_z * gy * gy, var_z * gy, var_z)

    a, b_, c, e, f_, i = backproj_cov(uc, vc, z_cur, var_zc)
    n00, n01, n02, n11, n12, n22 = backproj_cov(u, v, z_ref, var_zr)

    # Sig += R N R^T with N symmetric: P = R N, then P R^T
    rows = ((R[0, 0], R[0, 1], R[0, 2]), (R[1, 0], R[1, 1], R[1, 2]),
            (R[2, 0], R[2, 1], R[2, 2]))
    P = [[rows[k][0] * n00 + rows[k][1] * n01 + rows[k][2] * n02,
          rows[k][0] * n01 + rows[k][1] * n11 + rows[k][2] * n12,
          rows[k][0] * n02 + rows[k][1] * n12 + rows[k][2] * n22] for k in range(3)]
    r00, r01, r02, r11, r12, r22 = (
        P[k][0] * rows[l][0] + P[k][1] * rows[l][1] + P[k][2] * rows[l][2]
        for k, l in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    a = a + r00 + 1e-9
    b_ = b_ + r01
    c = c + r02
    e = e + r11 + 1e-9
    f_ = f_ + r12
    i = i + r22 + 1e-9
    # closed-form inverse of the symmetric 3x3
    det = a * (e * i - f_ * f_) - b_ * (b_ * i - f_ * c) + c * (b_ * f_ - e * c)
    det = torch.where(torch.abs(det) > 1e-18, det, 1e-18)
    i00 = (e * i - f_ * f_) / det
    i01 = (c * f_ - b_ * i) / det
    i02 = (b_ * f_ - c * e) / det
    i11 = (a * i - c * c) / det
    i12 = (b_ * c - a * f_) / det
    i22 = (a * e - b_ * b_) / det
    m2 = (dx * (i00 * dx + i01 * dy + i02 * dz)
          + dy * (i01 * dx + i11 * dy + i12 * dz)
          + dz * (i02 * dx + i12 * dy + i22 * dz))
    m = torch.where(valid, torch.sqrt(torch.clamp(m2, min=0.0)), 0.0)

    # normalize over the valid pixels to [0, 255], from the minimum to the
    # 99.5th percentile (outlier-robust min-max, cc:276-277)
    m_min = torch.where(valid, m, float("inf")).amin()
    m_min = torch.where(torch.isfinite(m_min), m_min, 0.0)
    m_max = torch.maximum(_quantile_995(m, valid, m_min), m_min + 1e-6)
    dist = torch.clamp((m - m_min) / (m_max - m_min) * 255.0, 0.0, 255.0)
    dist = torch.where(valid, dist, 0.0)

    thr = _otsu_threshold(dist, valid) if use_otsu else gcfg.mahala_threshold
    # the normalized threshold (cc:278-326) and an absolute floor in sigma
    # units (normalization alone flags the top of the noise on a static scene)
    dynamic = valid & (dist >= thr) & (m >= 15.0)
    # morphological opening, windows scaled with the grid
    ke, kd = {1: (5, 7), 2: (3, 5), 4: (2, 5)}[s]
    dynamic = dilate_mask(erode_mask(dynamic, ke), kd)
    geo_static = 1.0 - dynamic.float()
    if s > 1:   # back to full resolution (nearest)
        geo_static = geo_static.repeat_interleave(s, 0).repeat_interleave(s, 1)[:Hf, :Wf]
        dist = dist.repeat_interleave(s, 0).repeat_interleave(s, 1)[:Hf, :Wf]
    return torch.minimum(geo_static, sem_mask), dist


def _kp_depth(depth: torch.Tensor, uv: torch.Tensor, cam) -> torch.Tensor:
    """Depth at the rounded keypoint pixel."""
    u = torch.round(uv[:, 0]).to(torch.int64).clamp(0, cam.width - 1)
    v = torch.round(uv[:, 1]).to(torch.int64).clamp(0, cam.height - 1)
    return depth[v, u]


def ratio_matches(feats: Features, ref_feats: Features, n_levels: int):
    """Per keypoint of `feats` its best keypoint of `ref_feats` by Hamming
    distance, and the ratio test `best < 64 & best < 0.8 * second`.

    A call of the matcher kernel on its all-pairs path: the reference
    keypoints are the candidate rows, with no window (an infinite radius
    and a level slack of n_levels), as relocalization calls it.

    The JAX package takes the all-pairs matrix of the +-1 descriptors, in
    which an invalid row scores 128 against every column, so its `best` and
    `second` count an invalid reference column at 128 where the kernel leaves
    it out (BIG). That cannot change `good`: where best < 64, the best is
    below 128, so it and its index (the first column reaching it) come from
    valid columns in both; and the second differs only when every other
    valid column is at >= 128, where the JAX second is 128 and the kernel's
    larger, and best < 64 < 0.8 * 128 holds against either. Invalid
    current keypoints are not `good` in either.

    Returns (good [N] bool, idx [N] int64 (0 where there is no candidate),
    best [N] int32)."""
    radius = torch.full((ref_feats.uv.shape[0],), float("inf"), device=feats.uv.device)
    best, second, arg, _ = match_top2(
        ref_feats.uv.contiguous(), ref_feats.desc.contiguous(), radius,
        ref_feats.level.to(torch.int32).contiguous(), ref_feats.valid.contiguous(),
        feats.uv.contiguous(), feats.desc.contiguous(),
        feats.level.to(torch.int32).contiguous(), feats.valid.contiguous(), n_levels)
    good = feats.valid & (best < 64) & \
        (best.float() < 0.8 * second.clamp(max=BIG).float())
    return good, arg.clamp(min=0).long(), best


def top_matches(good: torch.Tensor, best: torch.Tensor, k: int) -> torch.Tensor:
    """The `k` strongest of the good matches (cc:117: top-100 by distance).
    Distances tie often; the stable sort keeps the lower index among equal
    ones, as jnp.argsort does."""
    order = torch.argsort(torch.where(good, best, BIG), stable=True)
    return good & torch.zeros_like(good).index_fill_(0, order[:k], True)


def _match_pose(fa: Features, depth_a, fb: Features, depth_b, cfg: SlamConfig, key=None,
                fold: Optional[torch.Tensor] = None,
                sample_idx: Optional[torch.Tensor] = None) -> solvers.RansacResult:
    """The pose b <- a from feature matches (GetRt, cc:77-156): per keypoint
    of `fa` its ratio-test match in `fb`, both with depth at the rounded
    keypoint pixel, the strongest pnp_top_matches kept, then the 3D-3D
    RANSAC (300 hypotheses, 4 px, >= 20 inliers). The draws are the JAX
    package's under `key` (and `fold`), or `sample_idx` (the caller's draw,
    [300 * 3])."""
    cam = cfg.camera
    zA = _kp_depth(depth_a, fa.uv, cam)
    zB = _kp_depth(depth_b, fb.uv, cam)
    good, idx, best = ratio_matches(fa, fb, cfg.orb.n_levels)
    good = top_matches(good & (zA > 0) & (zB[idx] > 0), best, cfg.geomask.pnp_top_matches)
    P = cam_ops.backproject(fa.uv, zA, cam)
    uv_b = fb.uv[idx]
    Q = cam_ops.backproject(uv_b, zB[idx], cam)
    return solvers.ransac_rigid(P, Q, good, (cam.fx, cam.fy, cam.cx, cam.cy), uv_b,
                                n_iters=300, min_inliers=20, px_threshold=4.0,
                                key=key, fold=fold, sample_idx=sample_idx)


def relative_pose(ref_gray, ref_depth, cur_gray, cur_depth, cfg: SlamConfig, key=None,
                  sample_idx: Optional[torch.Tensor] = None):
    """GetRt (GeoMaskMaker.cc:77-156): ORB features on both frames, ratio
    matches, the robust relative pose, drawn under `key` (PRNGKey(0) when
    not given, as the JAX function's default). Returns (T_cur_ref [4, 4],
    n_inliers)."""
    cam = cfg.camera
    A = extractor.extract(ref_gray, cfg.orb, cam.height, cam.width)
    B = extractor.extract(cur_gray, cfg.orb, cam.height, cam.width)
    res = _match_pose(A, ref_depth, B, cur_depth, cfg,
                      prng.prng_key(0) if key is None else key, sample_idx=sample_idx)
    return res.T, res.n_inliers


def gd_step_core(feats: Features, cur_gray, cur_depth, sem_mask, ref_gray, ref_depth,
                 ref_feats: Features, cfg: SlamConfig, key=None,
                 fold: Optional[torch.Tensor] = None,
                 sample_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GD masking program on the current frame's features: relative pose
    cur -> ref from (current x cached reference features), dense flow, the
    Mahalanobis map; where the pose RANSAC finds fewer than min_matches
    inliers the semantic mask passes through (cc:145-148), decided on the
    device. The pose RANSAC draws under `key` (and `fold`), or takes
    sample_idx. Returns the refined static mask."""
    res = _match_pose(feats, cur_depth, ref_feats, ref_depth, cfg, key, fold, sample_idx)
    # flow stops at the Mahalanobis grid's level and is consumed there
    s = res_factor(cfg)
    flow = flow_ops.farneback_flow(cur_gray, ref_gray, levels=5,
                                   finest_level={1: 0, 2: 1, 4: 2}[s], upsample=s == 1)
    mask, _ = mahalanobis_mask(cur_depth, ref_depth, flow, res.T, sem_mask, cfg,
                               cfg.geomask.use_otsu, ref_gray=cur_gray, cur_gray=ref_gray,
                               flow_factor=s)
    return torch.where(res.n_inliers >= cfg.geomask.min_matches, mask, sem_mask)


def gd_step(cur_gray, cur_depth, sem_mask, ref_gray, ref_depth, ref_feats: Features,
            cfg: SlamConfig, key, fold: Optional[torch.Tensor] = None):
    """Extract the current frame's features once, then gd_step_core, its
    RANSAC drawn under `key` (and `fold`). Returns (cur_feats, refined_mask)."""
    cam = cfg.camera
    feats = extractor.extract(cur_gray, cfg.orb, cam.height, cam.width)
    return feats, gd_step_core(feats, cur_gray, cur_depth, sem_mask, ref_gray, ref_depth,
                               ref_feats, cfg, key, fold)


class GeoMaskMaker:
    """Host wrapper with the 5-frame ring buffer (GeoMaskMaker.cc:409-429).
    Ring entries carry their extracted features, so the relative-pose stage
    never re-extracts a past frame. Each call of get_mask that runs the
    masker splits the maker's key, which starts at PRNGKey(7), and draws
    under the second half, as the JAX GeoMaskMaker does."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.ring: list = []          # (gray, depth, feats) device tensors
        self.frame_count = 0
        self._key = prng.prng_key(7)
        self.last_feats: Optional[Features] = None

    def _extract(self, gray) -> Features:
        cam = self.cfg.camera
        return extractor.extract(gray, self.cfg.orb, cam.height, cam.width)

    def add_new_image(self, gray, depth, sem_mask=None, feats=None):
        self.ring.append((gray, depth, feats))
        if len(self.ring) > self.cfg.geomask.inter_frame_size + 1:
            self.ring.pop(0)
        self.frame_count += 1

    @property
    def warm(self) -> bool:
        """True once get_mask would run the real masker for the next frame."""
        return self.frame_count >= self.cfg.geomask.inter_frame_size

    def ref_for_next(self):
        """The ring entry that is ring[0] (the t-5 pairing) after the next
        push, resolved before the push; extracts its features if missing."""
        idx = 1 if len(self.ring) > self.cfg.geomask.inter_frame_size else 0
        gray, depth, feats = self.ring[idx]
        if feats is None:
            feats = self._extract(gray)
            self.ring[idx] = (gray, depth, feats)
        return gray, depth, feats

    def push(self, gray, depth, feats):
        """Ring bookkeeping for a frame whose mask the fused path computed."""
        self.add_new_image(gray, depth, feats=feats)
        self.last_feats = feats

    def get_mask(self, sem_mask):
        """Refined static mask [H, W] float (1 = static) of the newest ring
        frame."""
        cur_gray, cur_depth, _ = self.ring[-1]
        if self.frame_count <= self.cfg.geomask.inter_frame_size:
            # warm-up: all-pass (cc:171-175); still extract + cache features
            self.last_feats = self._extract(cur_gray)
            self.ring[-1] = (cur_gray, cur_depth, self.last_feats)
            return sem_mask
        ref_gray, ref_depth, ref_feats = self.ring[0]
        if ref_feats is None:
            ref_feats = self._extract(ref_gray)
            self.ring[0] = (ref_gray, ref_depth, ref_feats)
        self._key, key = prng.split(self._key)
        feats, refined = gd_step(cur_gray, cur_depth, sem_mask, ref_gray, ref_depth,
                                 ref_feats, self.cfg, key)
        self.last_feats = feats
        self.ring[-1] = (cur_gray, cur_depth, feats)
        return refined
