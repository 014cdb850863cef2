"""Geometry-path mask quality of the PyTorch port against the JAX package,
both on the CPU, at the full 480x640 size of bench.py::bench_geometry.

    python tools/geom_quality_cpu.py [--frames 135]

Renders the dynamic scene with the JAX renderer and feeds both packages'
System the frames' gray and depth through track_rgbd(use_geometry=True),
pipelined with commit_every 6 (bench_geometry's configuration). Prints as
JSON: the mask recall and IoU against the renderer's dyn_mask per 10-frame
window for each package (bench.py::_mask_quality's rule), the frame at which
each package reached 8 keyframes (where bench_geometry's warm-up ends), the
IoU of the port's masks against the JAX package's per frame, keyframe
counts, DB inserts and ATE. Takes ~15 minutes.
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


def run(system, frames) -> dict:
    masks, warm_end = [], None
    for i, fr in enumerate(frames):
        system.track_rgbd(np.asarray(fr.gray), np.asarray(fr.depth), None, i / 30.0,
                          use_geometry=True)
        m = system._last_refined_mask
        masks.append(np.asarray(m.cpu() if hasattr(m, "cpu") else m))
        if warm_end is None and system.keyframe_count >= 8:
            warm_end = i + 1
    system.shutdown()
    return dict(masks=masks, warm_end=warm_end, keyframes=system.keyframe_count,
                ate=ate(system.tracker.camera_trajectory(), frames))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=135)
    n = ap.parse_args().frames
    cfg = SlamConfig()
    frames = [synthetic.render_frame(i, cfg.camera, with_dynamic=True) for i in range(n)]
    gts = [np.asarray(f.dyn_mask) for f in frames]
    js = System(cfg, pipeline=True)
    js.tracker.commit_every = 6
    ts = tslam.System(convert.config_from_jax_dict(dataclasses.asdict(cfg)), pipeline=True,
                      device="cpu")
    ts.tracker.commit_every = 6
    out = {}
    for name, system in (("jax", js), ("port", ts)):
        r = run(system, frames)
        windows = {}
        for w0 in range(0, n - 9, 10):
            q = [quality(r["masks"][k], gts[k]) for k in range(w0, w0 + 10) if gts[k].any()]
            windows[f"{w0}-{w0 + 9}"] = [float(np.mean([a for a, _ in q])),
                                         float(np.mean([b for _, b in q]))]
        out[name] = dict(recall_iou_by_window=windows, warmup_end=r["warm_end"],
                         keyframes=r["keyframes"], ate_m=r["ate"])
        out[name]["_masks"] = r["masks"]
    agree = [float(((a < 0.5) & (b < 0.5)).sum() / ((a < 0.5) | (b < 0.5)).sum())
             if ((a < 0.5) | (b < 0.5)).any() else 1.0          # both empty: the same
             for a, b in zip(out["port"].pop("_masks"), out["jax"].pop("_masks"))]
    out["port_vs_jax_mask_iou"] = dict(mean=float(np.mean(agree)), min=float(np.min(agree)),
                                       below_0_9=[i for i, a in enumerate(agree) if a < 0.9])
    out["db_inserts"] = dict(jax=js._geo_db_count, port=ts._geometry.inserted)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
