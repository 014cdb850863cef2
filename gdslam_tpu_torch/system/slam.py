"""Public SLAM system API — the counterpart of `ORB_SLAM2::System` (port of
gdslam_tpu.system.slam).

`track_rgbd` runs the RGB-D tracker with the JAX package's defaults
(triangulation and local BA on), pipelined or not, and `track_rgbd_gd` runs
it behind the GD masker (dense scene flow + Mahalanobis masking, the main
path); `reset`, the localization-mode toggles, `shutdown` and the TUM
trajectory writers are ported. Every other entry point of the JAX package's
System raises NotImplementedError until its slice is ported (see
ROADMAP.md).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from gdslam_tpu_torch.backend import solvers
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.frontend.frame import build_frame
from gdslam_tpu_torch.masking import geomask
from gdslam_tpu_torch.system import trajectory as traj
from gdslam_tpu_torch.system.tracking import Tracking, TrackState, _not_ported


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def pack_gd_frame(gray: np.ndarray, depth: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The GD frame's one upload buffer, uint8 [H*W + 2*H2*W2]: gray, then
    the low and the high bytes of the half-resolution depth
    (depth[::2, ::2], H2 = ceil(H / 2), W2 = ceil(W / 2)), written into `out`."""
    n = gray.size
    dh = depth[::2, ::2]
    m = dh.size
    out[:n] = gray.reshape(-1)
    out[n:n + m] = (dh & 0xFF).reshape(-1)
    out[n + m:n + 2 * m] = (dh >> 8).reshape(-1)
    return out


def unpack_gd_frame(packed: torch.Tensor, H: int, W: int, depth_scale: float):
    """pack_gd_frame's buffer on the device -> (gray [H, W] f32, depth
    [H, W] f32 metres: the half-resolution depth repeated 2 x 2 and scaled)."""
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    n, m = H * W, H2 * W2
    gray = packed[:n].view(H, W).float()
    lo = packed[n:n + m].view(H2, W2).to(torch.int32)
    hi = packed[n + m:n + 2 * m].view(H2, W2).to(torch.int32)
    dh = lo | (hi << 8)
    depth = dh.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]
    return gray, depth.float() * depth_scale


class PackedUpload:
    """Uploads GD frames without waiting for the card: each frame is packed
    into a pinned host buffer and copied with non_blocking=True. A buffer
    is reused only once the event recorded after its copy has completed, so
    a copy in flight is never overwritten; while every buffer is in flight
    the ring grows by one (it holds as many buffers as frames in flight)."""

    def __init__(self, H: int, W: int, device: torch.device):
        self.nbytes = H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2)
        self.device = device
        self.ring: list = []        # [pinned host buffer, event or None]

    def __call__(self, gray: np.ndarray, depth: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(pack_gd_frame(gray, depth, np.empty(self.nbytes, np.uint8)))
        slot = next((s for s in self.ring if s[1] is None or s[1].query()), None)
        if slot is None:
            slot = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True), None]
            self.ring.append(slot)
        pack_gd_frame(gray, depth, slot[0].numpy())
        dev = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(slot[0], non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev


class System:
    """SLAM system with the reference's System API surface (TrackRGBD
    System.cc:157-312, SaveTrajectoryTUM :418-476). Runs on `device`
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, settings: SlamConfig | str, sensor: Sensor = Sensor.RGBD,
                 use_viewer: bool = False, vocabulary: Optional[str] = None,
                 kmax: int = 512, pmax: int = 65536, pipeline: bool = False,
                 device="cuda"):
        if isinstance(settings, str):
            settings = SlamConfig.from_opencv_yaml(settings)
        if sensor != Sensor.RGBD:
            raise _not_ported(f"the {sensor.name} sensor")
        if vocabulary is not None:
            raise _not_ported("loop closing (vocabulary=...)")
        self.cfg = settings
        self.sensor = sensor
        self.device = torch.device(device)
        self.tracker = Tracking(settings, kmax=kmax, pmax=pmax, pipeline=pipeline,
                                device=self.device)
        self._geo: Optional[geomask.GeoMaskMaker] = None    # built at the first GD frame
        self._ones_mask: Optional[torch.Tensor] = None
        self._packed: Optional[PackedUpload] = None

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.array(x)
        if x.dtype == np.uint16:     # torch has no general uint16 arithmetic
            x = x.astype(np.int32)
        return torch.from_numpy(x).to(self.device)

    def _to_gray(self, im) -> torch.Tensor:
        im = self._upload(im).float()
        if im.ndim == 2:
            return im
        r, g, b = (0, 1, 2) if self.cfg.camera.rgb == 1 else (2, 1, 0)
        return 0.299 * im[..., r] + 0.587 * im[..., g] + 0.114 * im[..., b]

    def _to_depth(self, depth) -> torch.Tensor:
        """Depth in float meters; uint16 input is raw sensor units scaled
        by 1/DepthMapFactor (the reference's GrabImageRGBD contract)."""
        raw = depth.dtype == torch.uint16 if isinstance(depth, torch.Tensor) \
            else np.asarray(depth).dtype == np.uint16
        d = self._upload(depth).float()
        return d * (1.0 / self.cfg.camera.depth_map_factor) if raw else d

    def track_rgbd(self, rgb, depth, mask, timestamp: float,
                   use_geometry: bool = False):
        """TrackRGBD (System.cc:157-312): depth in meters (or raw uint16),
        mask 1 = static (None = all static). Returns T_cw 4x4 as a numpy
        array; a pipelined system returns the in-flight pose as a tensor on
        the device (exact poses come from the trajectory after shutdown)."""
        if use_geometry:
            raise _not_ported("the DynaSLAM geometry path (use_geometry=True)")
        gray = self._to_gray(rgb)
        depth = self._to_depth(depth)
        mask = torch.ones_like(gray) if mask is None else self._upload(mask).float()
        return self.tracker.process(gray, depth, mask, timestamp)

    def _all_static(self) -> torch.Tensor:
        if self._ones_mask is None:
            cam = self.cfg.camera
            self._ones_mask = torch.ones((cam.height, cam.width), device=self.device)
        return self._ones_mask

    def track_rgbd_gd(self, rgb, depth, mask, timestamp: float, inpaint: bool = False):
        """TrackRGBD_GD (System.cc:209-260): the dense-scene-flow GeoMaskMaker
        refines the semantic mask (1 = static, None = all static) before
        tracking (Tracking::GrabImageRGBD_GD, Tracking.cc:212-269). Returns
        (T_cw, refined_mask); the mask stays a tensor on the device, and the
        pose is as track_rgbd returns it.

        Once the tracker is pipelined, initialized, OK and the ring is warm,
        a frame takes the fast path: gd_step, build_frame with the refined
        mask and track_frame_core dispatched together with no host read, then
        adopted (its commit comes at the next flush). A uint8 gray image with
        uint16 raw depth (the CLI's contract) is uploaded as one packed buffer
        (gray + half-resolution depth) from pinned memory without waiting for
        the card. Every other frame takes the staged path: the ring's
        get_mask, then build_frame and the tracker's common body. The RANSAC
        draws of either path are seeded from the tracker's frame id."""
        if inpaint:
            raise NotImplementedError(
                "track_rgbd_gd(inpaint=True) needs background inpainting from the "
                "DynaSLAM geometry path, which is not ported to gdslam_tpu_torch yet; "
                "see ROADMAP.md section 1, item 10")
        if self._geo is None:
            self._geo = geomask.GeoMaskMaker(self.cfg)
        geo, tr, cam = self._geo, self.tracker, self.cfg.camera
        sem = self._all_static() if mask is None else self._upload(mask).float()
        if tr.pipeline and tr.last is not None and tr.state == TrackState.OK and geo.warm:
            ref_gray, ref_depth, ref_feats = geo.ref_for_next()
            if (isinstance(rgb, np.ndarray) and rgb.dtype == np.uint8 and rgb.ndim == 2
                    and isinstance(depth, np.ndarray) and depth.dtype == np.uint16):
                if self._packed is None:
                    self._packed = PackedUpload(cam.height, cam.width, self.device)
                gray, depth_m = unpack_gd_frame(self._packed(rgb, depth), cam.height,
                                                cam.width, 1.0 / cam.depth_map_factor)
            else:
                gray, depth_m = self._to_gray(rgb), self._to_depth(depth)
            feats, refined = geomask.gd_step(
                gray, depth_m, sem, ref_gray, ref_depth, ref_feats, self.cfg,
                solvers.frame_generator(tr.frame_id, self.device))
            out = tr._dispatch(build_frame(feats, depth_m, refined, cam))
            geo.push(gray, depth_m, feats)
            return tr.adopt_dispatched(out, timestamp), refined
        gray, depth_m = self._to_gray(rgb), self._to_depth(depth)
        geo.add_new_image(gray, depth_m, sem)
        refined = geo.get_mask(sem, tr.frame_id)
        # the GD stage's extraction is reused: the refined mask culls
        # keypoints at the Frame level (the reference re-extracts because
        # its masking is image-level, Tracking.cc:252)
        frame = build_frame(geo.last_feats, depth_m, refined, cam)
        return tr._process_built_frame(frame, timestamp), refined

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:366): stop map growth;
        tracking continues against the frozen map."""
        self.tracker.mapping_enabled = False

    def deactivate_localization_mode(self):
        self.tracker.mapping_enabled = True

    def reset(self):
        """System::Reset (System.cc:391): a fresh tracker with the same
        arena sizes, pipeline flag and commit interval."""
        old = self.tracker
        self.tracker = Tracking(self.cfg, kmax=old.arena.kmax, pmax=old.arena.pmax,
                                pipeline=old.pipeline, device=self.device)
        self.tracker.commit_every = old.commit_every
        self._geo = None

    def shutdown(self):
        """System::Shutdown (System.cc:397-416): drain the in-flight pipeline
        (the analogue of joining the worker threads)."""
        self.tracker.flush()

    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    @property
    def map_point_count(self) -> int:
        return int(self.tracker.arena.pt_valid.sum())

    @property
    def keyframe_count(self) -> int:
        return int(self.tracker.arena.kf_valid.sum())

    def save_trajectory_tum(self, path: str):
        traj.save_tum(path, self.tracker.camera_trajectory())

    def save_keyframe_trajectory_tum(self, path: str):
        traj.save_tum(path, self.tracker.keyframe_trajectory())


def _not_ported_method(name: str):
    def method(self, *args, **kwargs):
        raise _not_ported(f"System.{name}")
    method.__name__ = name
    return method


for _name in ("track_rgbd_geom", "track_stereo", "track_monocular",
              "save_map", "load_map", "save_trajectory_kitti"):
    setattr(System, _name, _not_ported_method(_name))
