"""Stereo and monocular tracking of the PyTorch port against the JAX package,
both on the CPU, on the frames of chip_smoke.py's `stereo` and `mono` phases
at full width, from the same PNGs.

    python tools/stereo_mono_quality_cpu.py [--phase stereo|mono|both|bootstrap]
        [--package both|jax|port] [--frames N]

stereo: 60 rendered static pairs at ORB-SLAM2's KITTI00-02.yaml settings
(1241 x 376, 2000 features, 8 levels), written as a KITTI layout by
chip_smoke.write_kitti_sequence, through each package's stereo_kitti driver.
mono: every second frame of the static scene at the SlamConfig() defaults
(480 x 640, 1500 features), 60 frames, written as a TUM monocular layout by
chip_smoke.write_mono_sequence, through each package's mono_tum driver. The
port's renderer draws the frames on the CPU (the card draws its own; the
PNGs' sha1 is printed by both, to compare). Prints one JSON line per package
and phase: ATE against the renderer (stereo: every frame; mono: the
keyframes, Umeyama-aligned with scale), keyframes, map points, stereo points
per frame, the bootstrap's frame. These are the JAX numbers that
chip_smoke.py's relative gates cite (STEREO_JAX, MONO_JAX); the run gives no
device time. Takes ~15 minutes for both phases.

bootstrap: the monocular bootstrap of the JAX mono loop test's rig (320x240,
512 features, 4 levels; frames 1 and 2 of its circuit, the pair its tracker
bootstraps on) under the keys PRNGKey(0..11): for each, the JAX package's
initialize (jitted) and the port's, which replays the same draws: ok, good
points, the translation's cosine to the true one, the good points' median
depth in baselines. How much the draw decides at a narrow baseline.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gdslam_tpu.cli import mono_tum as jmono_tum  # noqa: E402
from gdslam_tpu.cli import stereo_kitti as jstereo_kitti  # noqa: E402
from gdslam_tpu.frontend import initializer as jinit  # noqa: E402
from gdslam_tpu.ops import stereo as jstereo  # noqa: E402
from gdslam_tpu.system import slam as jslam  # noqa: E402
from gdslam_tpu_torch import SlamConfig  # noqa: E402
from gdslam_tpu_torch.cli import mono_tum as tmono_tum  # noqa: E402
from gdslam_tpu_torch.cli import stereo_kitti as tstereo_kitti  # noqa: E402
from gdslam_tpu_torch.frontend import initializer as tinit  # noqa: E402
from gdslam_tpu_torch.io import png, synthetic  # noqa: E402
from gdslam_tpu_torch.ops import stereo as tstereo  # noqa: E402
from gdslam_tpu_torch.system import slam as tslam  # noqa: E402
from gdslam_tpu_torch.utils import metrics  # noqa: E402

PACKAGES = {"jax": dict(stereo=jstereo, init=jinit, slam=jslam, stereo_kitti=jstereo_kitti,
                        mono_tum=jmono_tum, extra=[]),
            "port": dict(stereo=tstereo, init=tinit, slam=tslam, stereo_kitti=tstereo_kitti,
                         mono_tum=tmono_tum, extra=["--device", "cpu"])}


def run_driver(pkg: dict, main, argv, cwd: Path):
    """main(argv) in cwd with the package's System and stereo matcher and
    initializer recorded: (rc, output, seconds, system, stereo depths,
    initialize results)."""
    systems, depths, inits = [], [], []
    with cs.spy(pkg["slam"].System, "shutdown", lambda a, k, o: systems.append(a[0])), \
            cs.spy(pkg["stereo"], "stereo_match",
                   lambda a, k, o: depths.append(np.asarray(o[1]))), \
            cs.spy(pkg["init"], "initialize", lambda a, k, o: inits.append(bool(o.ok))):
        rc, out, sec = cs.run_cli(main, argv + pkg["extra"], cwd)
    return rc, out, sec, systems[0], depths, inits


def stereo(packages, n: int) -> None:
    cfg = cs.kitti_config(SlamConfig())
    base = Path(tempfile.mkdtemp(prefix="stereo_quality_", dir=ROOT / "build"))
    gts, digest = cs.write_kitti_sequence(torch, cfg, n, base / "seq", png, synthetic, "cpu")
    for name in packages:
        pkg = PACKAGES[name]
        rc, out, sec, slam, depths, _ = run_driver(
            pkg, pkg["stereo_kitti"].main, ["none", str(base / "seq" / "settings.yaml"),
                                           str(base / "seq")], base / name)
        ate, rows = cs.kitti_rows_ate(base / name / "CameraTrajectory.txt", gts, metrics)
        print(json.dumps(dict(phase="stereo", package=name, rc=rc, frames=n, poses=rows,
                              ate_m=ate, keyframes=int(slam.keyframe_count),
                              map_points=int(slam.map_point_count),
                              stereo_points_per_frame=float(np.mean([(d > 0).sum()
                                                                     for d in depths])),
                              state=slam.tracking_state.name, png_sha1=digest,
                              seconds=sec)), flush=True)
    shutil.rmtree(base)


def mono(packages, n: int) -> None:
    cfg = SlamConfig()
    base = Path(tempfile.mkdtemp(prefix="mono_quality_", dir=ROOT / "build"))
    gts, digest = cs.write_mono_sequence(torch, cfg, n, base / "seq", png, synthetic, "cpu")
    for name in packages:
        pkg = PACKAGES[name]
        rc, out, sec, slam, _, inits = run_driver(
            pkg, pkg["mono_tum"].main, ["none", str(base / "seq" / "settings.yaml"),
                                       str(base / "seq")], base / name)
        ate, rows, frames = cs.keyframe_file_ate(base / name / "KeyFrameTrajectory.txt", gts,
                                                 metrics)
        arena = slam.tracker.arena
        valid, ref = np.asarray(arena.pt_valid), np.asarray(arena.pt_ref_kf)
        boot = inits.index(True) if True in inits else None
        print(json.dumps(dict(phase="mono", package=name, rc=rc, frames=n,
                              keyframe_ate_scale_aligned_m=ate, keyframes=rows,
                              keyframe_frames=frames,
                              bootstrap_frame=2 * (boot + 1) if boot is not None else None,
                              map_points=int(valid.sum()),
                              map_points_after_bootstrap_pair=int((valid & (ref >= 2)).sum()),
                              state=slam.tracking_state.name, png_sha1=digest,
                              seconds=sec)), flush=True)
    shutil.rmtree(base)


def bootstrap(keys: int) -> None:
    import dataclasses

    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "tests"))
    import test_loop_e2e as tl
    from gdslam_tpu.io import synthetic as jsyn
    from gdslam_tpu_torch import convert
    from gdslam_tpu_torch.frontend import extractor, frame
    from gdslam_tpu_torch.system import tracking
    cfg = convert.config_from_jax_dict(dataclasses.asdict(tl.SCFG))
    cam = cfg.camera

    def build(i):
        g = torch.from_numpy(np.array(jsyn.render(jsyn.gt_pose_loop_mono(i, 120), tl.SCAM,
                                                  False, 30.0, i).gray))
        f = extractor.extract(g, cfg.orb, cam.height, cam.width)
        return frame.build_frame(f, torch.zeros_like(g), torch.ones_like(g), cam)

    first, second = build(1), build(2)
    good, idx = tracking.bootstrap_matches(first, second, cfg.orb.n_levels)
    x1, x2 = first.uv, second.uv[idx.long()]
    T = np.linalg.inv(np.asarray(jsyn.gt_pose_loop_mono(2, 120))) @ \
        np.asarray(jsyn.gt_pose_loop_mono(1, 120))
    t_true = T[:3, 3] / np.linalg.norm(T[:3, 3])
    K = (cam.fx, cam.fy, cam.cx, cam.cy)

    def stats(T21, is_good, pts):
        t = np.asarray(T21)[:3, 3]
        g = np.asarray(is_good)
        return dict(good=int(g.sum()), cos_t=float(np.dot(t, t_true) / np.linalg.norm(t)),
                    median_depth_baselines=float(np.median(np.asarray(pts)[g, 2])))

    for k in range(keys):
        j = jinit.initialize(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()),
                             jnp.asarray(good.numpy()), jax.random.PRNGKey(k), K)
        p = tinit.initialize(x1, x2, good, K, seed=k)
        print(json.dumps(dict(phase="bootstrap", key=k, matches=int(good.sum()),
                              jax=dict(ok=bool(j.ok), **stats(j.T_21, j.is_good, j.points)),
                              port=dict(ok=bool(p.ok), **stats(p.T_21, p.is_good, p.points)))),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("stereo", "mono", "both", "bootstrap"),
                    default="both")
    ap.add_argument("--package", choices=("both", "jax", "port"), default="both")
    ap.add_argument("--frames", type=int, default=60)
    opts = ap.parse_args()
    torch.set_num_threads(4)
    packages = ("jax", "port") if opts.package == "both" else (opts.package,)
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    if opts.phase in ("stereo", "both"):
        stereo(packages, opts.frames)
    if opts.phase in ("mono", "both"):
        mono(packages, opts.frames)
    if opts.phase == "bootstrap":
        bootstrap(12)
    print(json.dumps(dict(total_s=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
