"""Loop closing of the PyTorch port against the JAX package, both on the
CPU, on the revisit run of the JAX loop test (tests/test_loop_e2e.py): the
circuit io.synthetic.gt_pose_loop with period 120, 180 frames, a progressive
drift injected at frame 100, a vocabulary ('default') and a loop closer.

    python tools/loop_quality_cpu.py [--size full|small] [--package both|jax|port]

--size full: 480x640 with the SlamConfig() defaults (1500 features, 8
levels), kmax 512, pmax 65536, as chip_smoke.py's loop phase runs it;
small: the JAX test's 320x240 with 512 features and 4 levels, kmax 64,
pmax 32768. Both packages get the JAX renderer's frames and track them
without pipelining. Prints one JSON line per package: the loops fired as
(cur, cand), the keyframe ATE just before the first correction and at the
end, the keyframes, whether every frame was tracked, and the seconds taken.
The port's drift is chip_smoke.py's `inject_drift`, the JAX package's the
test's `_inject_drift`. Takes ~10 minutes at full size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import test_loop_e2e  # noqa: E402
from gdslam_tpu.backend import vocabulary as jvoc  # noqa: E402
from gdslam_tpu.backend.loop_closing import LoopCloser  # noqa: E402
from gdslam_tpu.config import OrbConfig, SlamConfig  # noqa: E402
from gdslam_tpu.io import synthetic  # noqa: E402
from gdslam_tpu.system.tracking import Tracking  # noqa: E402
from gdslam_tpu_torch import convert  # noqa: E402
from gdslam_tpu_torch.backend import loop_closing as tlc  # noqa: E402
from gdslam_tpu_torch.backend import vocabulary as tvoc  # noqa: E402
from gdslam_tpu_torch.core import lie as tlie  # noqa: E402
from gdslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from gdslam_tpu_torch.system import tracking as ttr  # noqa: E402
from gdslam_tpu_torch.utils import metrics as tmetrics  # noqa: E402


def configs(size: str):
    if size == "small":
        cfg = SlamConfig(camera=test_loop_e2e.SCAM, orb=OrbConfig(n_features=512, n_levels=4))
        return cfg, 64, 32768
    return SlamConfig(), 512, 65536


def run_jax(cfg, kmax, pmax, frames) -> dict:
    tr = Tracking(cfg, kmax=kmax, pmax=pmax)
    lc = LoopCloser(cfg, jvoc.default_vocabulary(), kmax)
    tr.loop_closer = lc
    ates_pre, real = [], LoopCloser.correct

    def hooked(self, arena, kf_id, cand, T):
        ates_pre.append(test_loop_e2e._kf_ate(arena, tr.kf_timestamps))
        return real(self, arena, kf_id, cand, T)

    LoopCloser.correct = hooked
    ones = jnp.ones((cfg.camera.height, cfg.camera.width))
    ok = True
    t0 = time.time()
    try:
        for i, fr in enumerate(frames):
            if i == chip_smoke.LOOP_DRIFT_AT:
                test_loop_e2e._inject_drift(tr, np.asarray(chip_smoke.LOOP_XI_DRIFT))
            tr.process(fr.gray, fr.depth, ones, i / 30.0)
            ok &= tr.state.name == "OK"
        tr.flush()
    finally:
        LoopCloser.correct = real
    return dict(package="jax", loops=[[int(a), int(b)] for a, b, _ in lc.loops],
                keyframe_ate_before_correction_m=ates_pre[0] if ates_pre else None,
                keyframe_ate_after_m=test_loop_e2e._kf_ate(tr.arena, tr.kf_timestamps),
                keyframes=tr.n_kf_host, all_ok=bool(ok), seconds=time.time() - t0)


def run_port(cfg, kmax, pmax, frames) -> dict:
    tcfg = convert.config_from_jax_dict(dataclasses.asdict(cfg))
    tr = ttr.Tracking(tcfg, kmax=kmax, pmax=pmax, device="cpu")
    lc = tlc.LoopCloser(tcfg, tvoc.default_vocabulary(), kmax, "cpu")
    tr.loop_closer = lc
    ates_pre, real = [], tlc.LoopCloser.correct

    def hooked(self, arena, kf_id, cand, T):
        ates_pre.append(chip_smoke.keyframe_ate(tmetrics, tsyn, arena.kf_pose.numpy(),
                                                tr.kf_timestamps))
        return real(self, arena, kf_id, cand, T)

    tlc.LoopCloser.correct = hooked
    ones = np.ones((cfg.camera.height, cfg.camera.width), np.float32)
    ok = True
    t0 = time.time()
    try:
        for i, fr in enumerate(frames):
            if i == chip_smoke.LOOP_DRIFT_AT:
                chip_smoke.inject_drift(torch, tlie, tr, chip_smoke.LOOP_XI_DRIFT)
            tr.process(np.asarray(fr.gray), np.asarray(fr.depth), ones, i / 30.0)
            ok &= tr.state.name == "OK"
        tr.flush()
    finally:
        tlc.LoopCloser.correct = real
    n = tr.n_kf_host
    return dict(package="port", loops=[[a, b] for a, b, _ in lc.loops],
                keyframe_ate_before_correction_m=ates_pre[0] if ates_pre else None,
                keyframe_ate_after_m=chip_smoke.keyframe_ate(
                    tmetrics, tsyn, tr.arena.kf_pose[:n].numpy(), tr.kf_timestamps),
                keyframes=n, all_ok=bool(ok), seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", choices=("full", "small"), default="full")
    ap.add_argument("--package", choices=("both", "jax", "port"), default="both")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg, kmax, pmax = configs(args.size)
    frames = [synthetic.render(synthetic.gt_pose_loop(i, chip_smoke.LOOP_PERIOD), cfg.camera,
                               False, 30.0, i) for i in range(chip_smoke.LOOP_FRAMES)]
    for pkg, fn in (("jax", run_jax), ("port", run_port)):
        if args.package in (pkg, "both"):
            print(json.dumps(dict(size=args.size, width=cfg.camera.width,
                                  height=cfg.camera.height, **fn(cfg, kmax, pmax, frames))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
