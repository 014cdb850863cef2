"""Typed configuration with loader for the reference's OpenCV-YAML settings.

The port's own copy of the camera / ORB / GD-mask / geometry / tracking settings (the JAX
package's `config.py` carries the same fields and defaults). Files start
with an OpenCV ``%YAML:1.0`` directive and use flat ``Section.key: value``
keys; this module reads that dialect without OpenCV.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + radial-tangential distortion (TUM3.yaml:8-31)."""

    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 40.0            # baseline * fx (stereo/RGB-D virtual baseline)
    rgb: int = 1                # 1: RGB order, 0: BGR
    th_depth: float = 40.0      # close/far point threshold, in units of baseline
    depth_map_factor: float = 5000.0  # raw depth / factor = meters

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (TUM3.yaml:36-56)."""

    n_features: int = 1500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclass(frozen=True)
class GeoMaskConfig:
    """GeoMaskMaker settings (reference GeoMaskMaker.h:40-60, GeoMaskMaker.cc)."""

    inter_frame_size: int = 5       # ring buffer pairing t-5 with t (GeoMaskMaker.h:55)
    max_depth: float = 3.5          # depth validity gate (GeoMaskMaker.cc:229)
    depth_sigma: float = 0.5        # depth2std sigma (GeoMaskMaker.cc:1386-1391)
    mahala_threshold: float = 20.0  # fixed threshold on normalized dist (cc:278-326)
    min_matches: int = 20           # degrade to the semantic mask below this (cc:145-148)
    pnp_features: int = 2000        # ORB feature budget for GetRt (cc:84)
    pnp_top_matches: int = 100      # top-K Hamming matches kept for the pose (cc:117)
    use_otsu: bool = False          # reference computes Otsu then discards it


@dataclass(frozen=True)
class GeometryConfig:
    """DynaSLAM Geometry module settings (reference include/Geometry.h:19-22)."""

    max_ref_frames: int = 5         # MAX_REF_FRAMES (Geometry.h:20)
    max_db_size: int = 20           # MAX_DB_SIZE ring DB (Geometry.h:19)
    depth_threshold: float = 0.6    # projDepth - z dynamic gate (Geometry.cc:373)
    var_threshold: float = 0.001    # 41x41 patch depth variance gate (Geometry.cc:377)
    min_depth_threshold: float = 0.2  # MIN_DEPTH_THRESHOLD (Geometry.h:22)
    parallax_deg: float = 30.0      # parallax filter (Geometry.cc:158,176)
    window_radius: int = 20         # (2*20+1)^2 search window (Geometry.cc:1036)
    region_growing_threshold: float = 0.20  # depth region grow (Geometry.cc:415-450)
    dilation_px: int = 15           # elliptical dilation after grow


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking/backend thresholds (reference Tracking.cc / LocalMapping.cc)."""

    max_keyframes: int = 512
    max_points: int = 32768
    local_kf_cap: int = 80
    min_init_features: int = 500
    covis_weight_th: int = 15
    ransac_iters: int = 300
    huber_mono: float = 5.991
    huber_stereo: float = 7.815
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    geomask: GeoMaskConfig = field(default_factory=GeoMaskConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)

    @staticmethod
    def from_opencv_yaml(path: str) -> "SlamConfig":
        kv = read_opencv_yaml(path)
        cam_map = {
            "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx",
            "Camera.cy": "cy", "Camera.k1": "k1", "Camera.k2": "k2",
            "Camera.p1": "p1", "Camera.p2": "p2", "Camera.k3": "k3",
            "Camera.width": "width", "Camera.height": "height",
            "Camera.fps": "fps", "Camera.bf": "bf", "Camera.RGB": "rgb",
            "ThDepth": "th_depth", "DepthMapFactor": "depth_map_factor",
        }
        orb_map = {
            "ORBextractor.nFeatures": "n_features",
            "ORBextractor.scaleFactor": "scale_factor",
            "ORBextractor.nLevels": "n_levels",
            "ORBextractor.iniThFAST": "ini_th_fast",
            "ORBextractor.minThFAST": "min_th_fast",
        }
        cam_kwargs, orb_kwargs = {}, {}
        cam_fields = {f.name: f.type for f in dataclasses.fields(CameraConfig)}
        for yk, name in cam_map.items():
            if yk in kv:
                cast = int if cam_fields[name] in (int, "int") else float
                cam_kwargs[name] = cast(kv[yk])
        for yk, name in orb_map.items():
            if yk in kv:
                cast = float if name == "scale_factor" else int
                orb_kwargs[name] = cast(kv[yk])
        return SlamConfig(camera=CameraConfig(**cam_kwargs), orb=OrbConfig(**orb_kwargs))


_KV_RE = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*(?:#.*)?$")


def read_opencv_yaml(path: str) -> dict:
    """Parse the flat `key: value` subset of OpenCV FileStorage YAML."""
    out = {}
    with open(path, "r") as f:
        for line in f:
            if line.lstrip().startswith(("%", "#", "---")):
                continue
            m = _KV_RE.match(line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = float(raw) if any(c in raw for c in ".eE") else int(raw)
            except ValueError:
                out[key] = raw
    return out
