"""KITTI odometry and TUM monocular sequence reading (port of
gdslam_tpu.io.kitti, on the port's own PNG reader).

Mirrors the reference drivers' loaders: stereo_kitti.cc LoadImages reads
`sequence/image_0/NNNNNN.png` + `image_1/...` paced by `times.txt`
(Examples/Stereo/stereo_kitti.cc); mono_kitti.cc uses image_0 only
(Examples/Monocular/mono_kitti.cc); mono_tum.cc reads `rgb.txt`. Images come
back as float32 0..255 gray; a colour image is converted with numpy float32
`0.299 r + 0.587 g + 0.114 b`, left to right without fused multiply-adds, as
the JAX package's loaders compute it.
"""

from __future__ import annotations

import os

import numpy as np

from gdslam_tpu_torch.io import png


def load_times(sequence_dir: str) -> list[float]:
    out = []
    with open(os.path.join(sequence_dir, "times.txt")) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(float(line))
    return out


def _gray(path: str) -> np.ndarray:
    im = png.read(path).astype(np.float32)
    if im.ndim == 3:
        im = 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
    return im


class KittiStereoSequence:
    """Iterates (left [H, W] float32 0..255, right [H, W], timestamp)."""

    def __init__(self, sequence_dir: str):
        self.dir = sequence_dir
        self.times = load_times(sequence_dir)

    def __len__(self) -> int:
        return len(self.times)

    def _img(self, sub: str, i: int) -> np.ndarray:
        return _gray(os.path.join(self.dir, sub, f"{i:06d}.png"))

    def __getitem__(self, i: int):
        return self._img("image_0", i), self._img("image_1", i), self.times[i]


class KittiMonoSequence:
    """Iterates (left [H, W] float32 0..255, timestamp)."""

    def __init__(self, sequence_dir: str):
        self._stereo = KittiStereoSequence(sequence_dir)

    def __len__(self) -> int:
        return len(self._stereo)

    def __getitem__(self, i: int):
        return self._stereo._img("image_0", i), self._stereo.times[i]


class TumMonoSequence:
    """mono_tum.cc LoadImages: `rgb.txt` rows of `timestamp path`; iterates
    (gray [H, W] float32 0..255, timestamp)."""

    def __init__(self, sequence_dir: str):
        self.dir = sequence_dir
        self.rows: list[tuple[float, str]] = []
        with open(os.path.join(sequence_dir, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    self.rows.append((float(parts[0]), parts[1]))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int):
        t, rel = self.rows[i]
        return _gray(os.path.join(self.dir, rel)), t
