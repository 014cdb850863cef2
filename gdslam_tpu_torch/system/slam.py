"""Public SLAM system API — the counterpart of `ORB_SLAM2::System` (port of
gdslam_tpu.system.slam).

`track_rgbd` runs the RGB-D tracker with the JAX package's defaults
(triangulation and local BA on), pipelined or not; `reset`, the
localization-mode toggles, `shutdown` and the TUM trajectory writers are
ported. Every other entry point of the JAX package's System raises
NotImplementedError until its slice is ported (see ROADMAP.md).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.system import trajectory as traj
from gdslam_tpu_torch.system.tracking import Tracking, TrackState, _not_ported


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


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


for _name in ("track_rgbd_geom", "track_rgbd_gd", "track_stereo", "track_monocular",
              "save_map", "load_map", "save_trajectory_kitti"):
    setattr(System, _name, _not_ported_method(_name))
