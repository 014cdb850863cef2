"""Semantic segmentation bridge with the reference's mask-cache protocol
(port of gdslam_tpu.masking.masknet).

Plays the role of DynaSLAM::SegmentDynObject (reference include/MaskNet.h,
src/MaskNet.cc): a per-frame dynamic-object mask from an instance
segmenter, with a disk cache so precomputed masks bypass inference (if
`<dir>/<name>.png` exists it is read instead of running the net; new masks
are written back unless the directory is the `no_save` sentinel,
rgbd_tum.cc:99-109). The segmenter is any callable `fn(rgb) -> [H, W]`
with 1 = dynamic; the port's own is the live Mask R-CNN of
models/maskrcnn.py (`build_segmenter`, `TorchSegmenter`). Masks are read and
written with the port's PNG module.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np

from gdslam_tpu_torch.io import png

NO_SAVE = "no_save"   # sentinel: use the cache read-only (rgbd_tum.cc:99-109)


class SegmentDynObject:
    """mask = 1 where a dynamic-class object is present (the raw network
    convention; callers convert to static masks as `1 - mask`,
    rgbd_tum.cc:137-150)."""

    def __init__(self, segmenter: Optional[Callable] = None,
                 cache_dir: Optional[str] = None):
        self.segmenter = segmenter
        self.cache_dir = None
        self.read_only = False
        self._warned_miss = False
        if cache_dir and cache_dir != NO_SAVE:
            self.cache_dir = cache_dir
            os.makedirs(cache_dir, exist_ok=True)
        elif cache_dir == NO_SAVE:
            self.read_only = True
        if segmenter is not None:
            # warm-up on a zero image, mirroring MaskNet.cc:45-48
            hw = getattr(segmenter, "image_hw", (480, 640))
            segmenter(np.zeros(tuple(hw) + (3,), np.float32))

    def _cache_path(self, name: str) -> Optional[str]:
        if self.cache_dir is None:
            return None
        return os.path.join(self.cache_dir, name + ".png")

    def get_segmentation(self, rgb: np.ndarray, name: str = "",
                         cache_dir: Optional[str] = None) -> np.ndarray:
        """GetSegmentation (MaskNet.cc:58-83): a cache hit is read; else the
        segmenter runs and its mask is written back (unless read-only)."""
        path = None
        if cache_dir:
            path = os.path.join(cache_dir, name + ".png")
        elif name:
            path = self._cache_path(name)
        if path and os.path.exists(path):
            m = png.read(path).astype(np.float32)
            return (m > 127).astype(np.float32) if m.max() > 1 else m
        if self.segmenter is None:
            # The reference always has a net to fall back on (MaskNet.cc:
            # 86-93); this bridge may run cache-only, but a miss then means
            # "no dynamics", which must be loud.
            if not self._warned_miss:
                warnings.warn(
                    "SegmentDynObject: mask-cache miss with no live segmenter; "
                    "returning an all-static mask. Precompute masks into the cache "
                    "dir or construct with a segmenter.")
                self._warned_miss = True
            return np.zeros(rgb.shape[:2], np.float32)
        mask = np.asarray(self.segmenter(rgb), np.float32)
        if path and not self.read_only:
            png.write(path, (mask * 255).astype(np.uint8))
        return mask

    def get_segmentation_label(self, rgb: np.ndarray, name: str = ""):
        """GetSegmentation_label (MaskNet.cc:85-114): mask + per-instance
        label image (the segmenter's instances, or the connected components
        of the mask)."""
        mask = self.get_segmentation(rgb, name)
        if self.segmenter is not None and hasattr(self.segmenter, "instances"):
            labels = np.asarray(self.segmenter.instances(rgb), np.int32)
        else:
            from scipy import ndimage
            labels, _ = ndimage.label(mask > 0.5)
            labels = labels.astype(np.int32)
        return mask, labels
