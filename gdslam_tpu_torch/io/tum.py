"""TUM RGB-D dataset reading: association files + image loading (port of
gdslam_tpu.io.tum, on the port's own PNG reader).

Mirrors the reference's loader (Examples/RGB-D/rgbd_tum.cc:209-234):
an association file of `t_rgb rgb_path t_depth depth_path` rows relative to
a sequence directory; RGB 8-bit PNG, depth 16-bit PNG scaled by
DepthMapFactor (=5000 -> meters, TUM3.yaml:70, Tracking.cc:230-235).
Timestamps stay float64 on the host (TUM epoch seconds, ~1.3e9).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from gdslam_tpu_torch.io import png


@dataclass(frozen=True)
class Association:
    timestamp: float
    rgb_path: str
    depth_path: str


def load_associations(path: str) -> list[Association]:
    """Parse an associations file (rgbd_tum.cc:209-234 format)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            out.append(Association(timestamp=float(parts[0]),
                                   rgb_path=parts[1], depth_path=parts[3]))
    return out


class TumSequence:
    """Iterates (rgb [H,W,3] float32 0..255, depth [H,W] float32 meters,
    timestamp) over a TUM sequence directory + association file."""

    def __init__(self, sequence_dir: str, associations_path: str,
                 depth_map_factor: float = 5000.0):
        self.dir = sequence_dir
        self.assoc = load_associations(associations_path)
        self.scale = 1.0 / depth_map_factor

    def __len__(self) -> int:
        return len(self.assoc)

    def __getitem__(self, i: int):
        a = self.assoc[i]
        rgb = png.read(os.path.join(self.dir, a.rgb_path)).astype(np.float32)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        depth_raw = png.read(os.path.join(self.dir, a.depth_path))
        depth = depth_raw.astype(np.float32) * self.scale
        return rgb[..., :3], depth, a.timestamp
