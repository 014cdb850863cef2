"""Inputs that probe the edges of the detection kernels (ops/detect_kernels.py):
boxes around ROIAlign's level thresholds and detections around the paste's
tile borders. The CPU tests hold the plain mirrors to the JAX package on
them, the card tests and chip_smoke.py hold the kernels to their plain twins
on them; numpy only, so every caller makes the same inputs from a seed.
"""

from __future__ import annotations

import numpy as np

from gdslam_tpu_torch.ops.detect_kernels import ROI_LEVEL_AREA


def roi_boundary_boxes() -> np.ndarray:
    """[n, 4] f32 boxes (y1, x1, y2, x2) whose float32 area
    fl(max(h, 1) * max(w, 1)) lies a few ulps either side of each level
    threshold of the sqrt(hw) / 224 rule (and of 112^2, 224^2, 448^2
    themselves), at widths that make the product exact and inexact, from
    origins that make the side differences round."""
    out = []
    for area in (*ROI_LEVEL_AREA, 112.0 ** 2, 224.0 ** 2, 448.0 ** 2):
        for w, y1, x1 in ((64.0, 0.0, 0.0), (100.0, 3.3, 7.1), (37.5, 0.5, 1.25), (1.0, 2.0, 2.0)):
            h0 = np.float32(area / w)
            for k in range(-6, 7):
                h = np.float32(h0 + k * np.spacing(h0))
                out.append([y1, x1, np.float32(y1 + h), np.float32(x1 + w)])
    return np.asarray(out, np.float32)


def paste_adversarial_det(r: np.random.Generator, D: int, H: int, W: int) -> dict:
    """D detections (numpy: boxes, classes, masks, valid) whose boxes test
    the paste's tile lists on an H x W image: edges on, just off and between
    tile borders (multiples of 32, +-0.5, +-1 ulp), boxes that run past the
    image on every side, zero-area and inverted boxes, boxes inside one
    pixel, invalid detections and static classes; with D > 6, masks below
    the threshold everywhere, a hair under it and a single blob."""
    edges = (np.arange(0, max(H, W) + 33, 32, dtype=np.float32)[:, None]
             + np.float32([-1, -0.5, 0, 0.5])[None]).ravel()
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf)), [-40.0, -0.0]])
    y1, x1 = r.choice(edges, D).astype(np.float32), r.choice(edges, D).astype(np.float32)
    boxes = np.stack([y1, x1, y1 + r.choice([0, 0.25, 1, 31, 33, 64, 700], D),
                      x1 + r.choice([0, 0.25, 1, 31, 33, 64, 900], D)], 1).astype(np.float32)
    boxes[0] = [-50, -60, H + 50, W + 60]               # past the image on every side
    boxes[1] = [40, 40, 40, 90]                         # zero height
    boxes[2] = [70, 90, 60, 120]                        # inverted
    boxes[3] = [100.2, 100.2, 100.7, 100.7]             # inside one pixel, no pixel centre
    classes = r.integers(-3, 90, D).astype(np.int32)
    classes[:8] = 1
    valid = r.uniform(size=D) < 0.85
    valid[0] = True
    masks = r.uniform(0, 1, (D, 28, 28)).astype(np.float32)
    if D > 6:
        masks[4] *= np.float32(0.5)                     # below the threshold everywhere
        masks[5] = np.float32(0.5) - r.uniform(0, 1e-7, (28, 28)).astype(np.float32)
        masks[6] = 0.0                                  # one blob: live on few tiles
        masks[6, 10:13, 14:17] = 0.9
    return {"boxes": boxes, "classes": classes, "masks": masks, "valid": valid}
