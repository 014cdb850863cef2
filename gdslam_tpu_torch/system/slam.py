"""Public SLAM system API — the counterpart of `ORB_SLAM2::System` (port of
gdslam_tpu.system.slam).

`track_rgbd` runs the RGB-D tracker with the JAX package's defaults
(triangulation and local BA on), pipelined or not, and with
`use_geometry=True` behind the DynaSLAM geometric masker; `track_rgbd_geom`
adds background inpainting; `track_rgbd_gd` runs the tracker behind the GD
masker (dense scene flow + Mahalanobis masking, the main path), with
`inpaint=True` also inpainting; with a vocabulary every entry point also
closes loops and relocalizes through the BoW database. `reset`, the
localization-mode toggles, `shutdown` and the TUM trajectory writers are
ported. Every other entry point of the JAX package's System raises
NotImplementedError until its slice is ported (see ROADMAP.md).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from gdslam_tpu_torch.backend import solvers
from gdslam_tpu_torch.backend import vocabulary as voc_mod
from gdslam_tpu_torch.backend.loop_closing import LoopCloser
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.frontend.frame import build_frame
from gdslam_tpu_torch.masking import geomask, geometry
from gdslam_tpu_torch.ops import image as image_ops
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
    ("cuda" unless the caller asks for "cpu").

    vocabulary: None (no loop closing; relocalization from the recent
    keyframes), "default" (the shipped 10k-leaf vocabulary), the path of a
    vocabulary .npz (vocabulary.save), or a vocabulary.Vocabulary. With
    one, a LoopCloser runs at every keyframe."""

    def __init__(self, settings: SlamConfig | str, sensor: Sensor = Sensor.RGBD,
                 use_viewer: bool = False,
                 vocabulary: Optional[str | voc_mod.Vocabulary] = None,
                 kmax: int = 512, pmax: int = 65536, pipeline: bool = False,
                 device="cuda"):
        if isinstance(settings, str):
            settings = SlamConfig.from_opencv_yaml(settings)
        if sensor != Sensor.RGBD:
            raise _not_ported(f"the {sensor.name} sensor")
        self.cfg = settings
        self.sensor = sensor
        self.device = torch.device(device)
        self.tracker = Tracking(settings, kmax=kmax, pmax=pmax, pipeline=pipeline,
                                device=self.device)
        self._vocab = None
        if vocabulary is not None:
            self._vocab = load_vocabulary(vocabulary, self.device)
            self.tracker.loop_closer = LoopCloser(settings, self._vocab, kmax, self.device)
            # bFixScale (Sim3Solver.h:20): the scale is fixed with metric depth
            self.tracker.loop_closer.fix_scale = sensor != Sensor.MONOCULAR
        self._geo: Optional[geomask.GeoMaskMaker] = None    # built at the first GD frame
        self._ones_mask: Optional[torch.Tensor] = None
        self._packed: Optional[PackedUpload] = None
        self._clear_geometry()

    def _clear_geometry(self):
        """The DynaSLAM geometry state. With a pipelined tracker the keyframe
        decision lags the frame by up to commit_every frames, so candidate
        frames are cached (references to tensors on the device) and inserted
        into the ring DB when their keyframe shows up in the tracker's
        keyframe timestamps, with the arena's pose (GeometricModelUpdateDB,
        Geometry.cc:48-53)."""
        self._geometry: Optional[geometry.Geometry] = None  # built at the first use
        self._last_refined_mask: Optional[torch.Tensor] = None
        self._geo_kf_seen = 0         # keyframes already reconciled with the cache
        self._geo_frame_cache: dict = {}   # timestamp -> (gray, depth, mask, rgb)
        self._geo_pending_frame = None

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.array(x)
        if x.dtype == np.uint16:     # torch has no general uint16 arithmetic
            x = x.astype(np.int32)
        return torch.from_numpy(x).to(self.device)

    def _to_gray(self, im) -> torch.Tensor:
        """BT.601 luma, rounded as the JAX package's compiled conversion on
        the CPU: 0.114 b + (0.299 r + 0.587 g), both sums fused multiply-adds."""
        im = self._upload(im).float()
        if im.ndim == 2:
            return im
        r, g, b = (0, 1, 2) if self.cfg.camera.rgb == 1 else (2, 1, 0)
        return image_ops.fma(im[..., b], 0.114,
                             image_ops.fma(im[..., r], 0.299, 0.587 * im[..., g]))

    def _to_depth(self, depth) -> torch.Tensor:
        """Depth in float meters; uint16 input is raw sensor units scaled
        by 1/DepthMapFactor (the reference's GrabImageRGBD contract)."""
        raw = depth.dtype == torch.uint16 if isinstance(depth, torch.Tensor) \
            else np.asarray(depth).dtype == np.uint16
        d = self._upload(depth).float()
        return d * (1.0 / self.cfg.camera.depth_map_factor) if raw else d

    def _static_mask(self, mask, like: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(like) if mask is None else self._upload(mask).float()

    def _pose_tensor(self, T) -> torch.Tensor:
        """A pose as returned by the tracker, as a tensor on the device: the
        in-flight pose of a pipelined frame is one already (no read)."""
        if isinstance(T, torch.Tensor):
            return T
        return torch.from_numpy(np.asarray(T, np.float32)).to(self.device)

    def track_rgbd(self, rgb, depth, mask, timestamp: float,
                   use_geometry: bool = False):
        """TrackRGBD (System.cc:157-312): depth in meters (or raw uint16),
        mask 1 = static (None = all static). Returns T_cw 4x4 as a numpy
        array; a pipelined system returns the in-flight pose as a tensor on
        the device (exact poses come from the trajectory after shutdown).

        With use_geometry=True this is the DynaSLAM path (the reference's
        4-arg GrabImageRGBD, Tracking.cc:331-369): a LightTrack pose pre-pass,
        then Geometry::GeometricModelCorrection refines the semantic mask by
        multi-view geometry, the frame is rebuilt with the refined mask and
        tracked, and a keyframe enters the geometry ring DB. The refined mask
        is kept in `_last_refined_mask` (a tensor on the device)."""
        if not use_geometry:
            gray = self._to_gray(rgb)
            return self.tracker.process(gray, self._to_depth(depth),
                                        self._static_mask(mask, gray), timestamp)
        im = self._upload(rgb).float()
        gray = self._to_gray(im)
        T, _ = self._track_rgbd_geometry(gray, self._to_depth(depth),
                                         self._static_mask(mask, gray), timestamp)
        # the ring stores colour; a single-channel input stands in for all three
        self._geo_note_frame(im if im.ndim == 3 else im[..., None].expand(im.shape + (3,)))
        self._geo_sync_db()
        return T

    def track_rgbd_geom(self, rgb, depth, mask, timestamp: float):
        """The reference's 7-arg TrackRGBD (System.cc:157-207 -> GrabImageRGBD,
        Tracking.cc:271-329): geometric mask correction + background
        inpainting. Returns (T_cw, rgb_out, depth_out, mask_out), the
        imRGBOut / imDOut / maskOut output arguments, as tensors on the device
        (the pose as track_rgbd returns it)."""
        im = self._upload(rgb).float()
        gray = self._to_gray(im)
        depth = self._to_depth(depth)
        T, refined = self._track_rgbd_geometry(gray, depth, self._static_mask(mask, gray),
                                               timestamp)
        rgb_out, depth_out = self._geometry.inpaint_frames(im, depth, refined,
                                                           self._pose_tensor(T))
        self._geo_note_frame(im)
        self._geo_sync_db()
        return T, rgb_out, depth_out, refined

    def _track_rgbd_geometry(self, gray, depth, sem_mask, timestamp: float):
        """Shared body of the DynaSLAM entry points: LightTrack ->
        GeometricModelCorrection -> masked Frame -> Track (Tracking.cc:271-329).
        Returns (T_cw, refined_mask).

        A pipelined tracker in steady state takes the pipelined route: both
        LightTrack searches (the wide retry selected on the device), the
        correction gated by LightTrack's inliers, the frame build with the
        refined mask and track_frame_core are dispatched with no host read
        (the JAX package's `_geometry_track_program`), and the frame is
        adopted. Other frames take the staged route (LightTrack reads its
        inlier count). The correction runs only once the DB holds a frame,
        which the host knows, since it makes every insert."""
        if self._geometry is None:
            self._geometry = geometry.Geometry(self.cfg, self.device)
        geo, tr, cfg, cam = self._geometry, self.tracker, self.cfg, self.cfg.camera
        feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
        frame = build_frame(feats, depth, sem_mask, cam)
        refined = sem_mask
        if tr.pipeline and tr.last is not None and tr.state == TrackState.OK:
            if geo.inserted > 0:
                T_lt, n_lt = tr.light_track_dispatched(frame)
                refined = torch.where(n_lt >= 10, geometry.combine_masks(
                    sem_mask, geometry.correction_dynamic_mask(geo.db, depth, T_lt, cfg)),
                    sem_mask)
                frame = build_frame(feats, depth, refined, cam)
            T = tr.adopt_dispatched(tr._dispatch(frame), timestamp)
        else:
            ok, T_pred = tr.light_track(frame)
            if ok:
                refined = geo.geometric_model_correction(depth, T_pred, sem_mask)
                # keypoint-level culling over the same features (the reference
                # re-extracts only because its masking is image-level)
                frame = build_frame(feats, depth, refined, cam)
            T = tr._process_built_frame(frame, timestamp)
        self._last_refined_mask = refined
        self._geo_pending_frame = (float(timestamp), gray, depth, refined)
        return T, refined

    def _geo_note_frame(self, rgb: torch.Tensor):
        """Attach the colour plane to the frame recorded by
        _track_rgbd_geometry and move it into the keyframe-candidate cache
        (the 24 most recent frames)."""
        if self._geo_pending_frame is None:
            return
        ts, gray, depth, mask = self._geo_pending_frame
        self._geo_pending_frame = None
        self._geo_frame_cache[ts] = (gray, depth, mask, rgb)
        for k in list(self._geo_frame_cache)[:-24]:
            del self._geo_frame_cache[k]

    def _geo_sync_db(self):
        """Insert the cached frames whose keyframe has materialized (a few
        frames late under the pipelined commit protocol) into the ring DB,
        with the keyframe's arena pose."""
        if self._geometry is None:
            return
        tr = self.tracker
        kts = tr.kf_timestamps
        if len(kts) < self._geo_kf_seen:
            self._geo_kf_seen = 0       # a reset or a compaction shrank the list
        for slot in range(self._geo_kf_seen, len(kts)):
            entry = self._geo_frame_cache.pop(kts[slot], None)
            if entry is not None:
                self._geometry.insert(*entry, tr.arena.kf_pose[slot])
        self._geo_kf_seen = len(kts)

    def _update_geometry_db(self, gray, depth, mask, rgb):
        """GeometricModelUpdateDB (Tracking.cc:262, 326 -> Geometry.cc:48-53)
        on the GD + inpainting route: the frame enters the ring DB if the
        tracker says it is a keyframe, decided as the JAX package decides it,
        from `frames_since_kf == 0` with the current pose. A pipelined
        tracker updates that count only when it commits, so this inserts
        other frames than the keyframes (ROADMAP.md section 3)."""
        if self._geometry is None:
            self._geometry = geometry.Geometry(self.cfg, self.device)
        tr = self.tracker
        self._geometry.update_db(gray, depth, mask, rgb,
                                 tr.last.T_cw if tr.last is not None else tr._eye4,
                                 is_keyframe=tr.state == TrackState.OK
                                 and tr.frames_since_kf == 0)

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
        pose is as track_rgbd returns it. With inpaint=True (a 3-channel rgb
        is then needed) the background is inpainted from the geometry ring DB
        (Tracking.cc:259), the frame goes to the DB if it is a keyframe
        (:262), and (T_cw, refined_mask, rgb_out, depth_out) is returned, the
        reference's imRGBOut / imDOut output arguments, on the device.

        Once the tracker is pipelined, initialized, OK and the ring is warm,
        a frame without inpainting takes the fast path: gd_step, build_frame
        with the refined mask and track_frame_core dispatched together with
        no host read, then adopted (its commit comes at the next flush). A
        uint8 gray image with uint16 raw depth (the CLI's contract) is
        uploaded as one packed buffer (gray + half-resolution depth) from
        pinned memory without waiting for the card. Every other frame takes
        the staged path: the ring's get_mask, then build_frame and the
        tracker's common body. The RANSAC draws of either path are seeded
        from the tracker's frame id."""
        if inpaint and getattr(rgb, "ndim", 3) != 3:
            raise ValueError("inpaint=True needs a 3-channel rgb input "
                             "(the inpainted output is colour imagery)")
        if self._geo is None:
            self._geo = geomask.GeoMaskMaker(self.cfg)
        geo, tr, cam = self._geo, self.tracker, self.cfg.camera
        sem = self._all_static() if mask is None else self._upload(mask).float()
        if (not inpaint and tr.pipeline and tr.last is not None
                and tr.state == TrackState.OK and geo.warm):
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
        im = self._upload(rgb).float()
        gray, depth_m = self._to_gray(im), self._to_depth(depth)
        geo.add_new_image(gray, depth_m, sem)
        refined = geo.get_mask(sem, tr.frame_id)
        # the GD stage's extraction is reused: the refined mask culls
        # keypoints at the Frame level (the reference re-extracts because
        # its masking is image-level, Tracking.cc:252)
        frame = build_frame(geo.last_feats, depth_m, refined, cam)
        T = tr._process_built_frame(frame, timestamp)
        if not inpaint:
            return T, refined
        if self._geometry is None:
            self._geometry = geometry.Geometry(self.cfg, self.device)
        rgb_out, depth_out = self._geometry.inpaint_frames(im, depth_m, refined,
                                                           self._pose_tensor(T))
        self._update_geometry_db(gray, depth_m, refined, im)
        return T, refined, rgb_out, depth_out

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:366): stop map growth;
        tracking continues against the frozen map."""
        self.tracker.mapping_enabled = False

    def deactivate_localization_mode(self):
        self.tracker.mapping_enabled = True

    def reset(self):
        """System::Reset (System.cc:391): a fresh tracker with the same
        arena sizes, pipeline flag and commit interval; the loop closer is
        kept with its state cleared (the reference's Reset keeps the threads
        alive, System.cc:391-395)."""
        old = self.tracker
        self.tracker = Tracking(self.cfg, kmax=old.arena.kmax, pmax=old.arena.pmax,
                                pipeline=old.pipeline, device=self.device)
        self.tracker.commit_every = old.commit_every
        if old.loop_closer is not None:
            old.loop_closer.reset()
            self.tracker.loop_closer = old.loop_closer
        self._geo = None
        self._clear_geometry()

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


def load_vocabulary(vocabulary, device) -> voc_mod.Vocabulary:
    """A Vocabulary from System's `vocabulary` argument: "default", the
    path of an .npz of vocabulary.save, or a Vocabulary."""
    if isinstance(vocabulary, voc_mod.Vocabulary):
        return vocabulary.to(device)
    if vocabulary == "default":
        return voc_mod.default_vocabulary(device)
    return voc_mod.load(vocabulary, device)


def _not_ported_method(name: str):
    def method(self, *args, **kwargs):
        raise _not_ported(f"System.{name}")
    method.__name__ = name
    return method


for _name in ("track_stereo", "track_monocular",
              "save_map", "load_map", "save_trajectory_kitti"):
    setattr(System, _name, _not_ported_method(_name))
