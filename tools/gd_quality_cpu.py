"""GD mask quality of the PyTorch port against the JAX package, both on the
CPU, at the full 480x640 size of bench.py::bench_gd.

    python tools/gd_quality_cpu.py [--frames 130]

Renders the dynamic scene with the JAX renderer, feeds both packages' System
the CLI's uint8 gray + uint16 depth pipelined with commit_every 10 (so warm
frames take each package's packed fast path), and prints as JSON: the mask
recall and IoU against the renderer's dyn_mask per 10-frame window for each
package (bench.py::_mask_quality's rule), the IoU of the port's masks
against the JAX package's per frame, keyframe counts and ATE. Both draw the
RANSAC samples under the same jax.random keys (the port's
ops/draw_kernel.py), so the masks differ only where the flow's summation
order moves a pixel. Takes ~10 minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from gdslam_tpu.config import SlamConfig  # noqa: E402
from gdslam_tpu.io import synthetic  # noqa: E402
from gdslam_tpu.system.slam import System  # noqa: E402
from gdslam_tpu.utils import metrics  # noqa: E402
from gdslam_tpu_torch import convert  # noqa: E402
from gdslam_tpu_torch.system import slam as tslam  # noqa: E402


def quality(mask: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    dyn = mask < 0.5
    inter = float((dyn & gt).sum())
    return inter / max(gt.sum(), 1), inter / max((dyn | gt).sum(), 1)


def ate(traj, frames) -> float:
    est = np.stack([T[:3, 3] for _, T in traj])
    gt = np.stack([np.linalg.inv(np.asarray(frames[round(ts * 30)].T_wc))[:3, 3]
                   for ts, _ in traj])
    return metrics.ate_rmse(est, gt)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=130)
    n = ap.parse_args().frames
    cfg = SlamConfig()
    cam = cfg.camera
    frames = [synthetic.render_frame(i, cam, with_dynamic=True) for i in range(n)]
    w3 = np.array([0.299, 0.587, 0.114], np.float32)
    raw = [((np.asarray(f.rgb).astype(np.uint8).astype(np.float32) @ w3).astype(np.uint8),
            (np.asarray(f.depth) * cam.depth_map_factor).astype(np.uint16)) for f in frames]
    gts = [np.asarray(f.dyn_mask) for f in frames]
    runs = {}
    for name, system in (("jax", System(cfg, pipeline=True)),
                         ("port", tslam.System(convert.config_from_jax_dict(
                             dataclasses.asdict(cfg)), pipeline=True, device="cpu"))):
        system.tracker.commit_every = 10
        masks = [np.asarray(system.track_rgbd_gd(g, d, None, i / 30.0)[1])
                 for i, (g, d) in enumerate(raw)]
        system.shutdown()
        runs[name] = dict(masks=masks, keyframes=system.keyframe_count,
                          ate_m=ate(system.tracker.camera_trajectory(), frames))
    out = {}
    for name, r in runs.items():
        q = np.array([quality(m, gt) for m, gt in zip(r["masks"], gts)])
        out[name] = dict(keyframes=r["keyframes"], ate_bench_m=r["ate_m"],
                         recall_iou_by_window={f"{lo}-{lo + 9}": q[lo:lo + 10].mean(0).round(3)
                                               .tolist() for lo in range(10, n - 9, 10)})
    iou = np.array([quality(m, mj < 0.5)[1] for m, mj in
                    zip(runs["port"]["masks"], runs["jax"]["masks"])][5:])
    out["port_vs_jax_mask_iou"] = dict(mean=float(iou.mean()), min=float(iou.min()),
                                       below_0_9=int((iou < 0.9).sum()), frames=len(iou))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
