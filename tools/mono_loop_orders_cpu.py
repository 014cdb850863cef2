"""How chaotic is the monocular scale-drift gate? tests/test_loop_e2e.py::
test_mono_scale_drift_corrected's run (170 monocular frames of the loop
circuit at 320x240, 512 features, 4 levels, a free-scale loop closer) on
the CPU, once for each rounding order of the pose solve's sums, with
chip_smoke.py's gates (`mono_loop_gates`: on the JAX test's revisit pair
and on each of the last MONO_LOOP_PAIRS keyframes' pairs) on each run's
map:

    python tools/mono_loop_orders_cpu.py --package jax --orders 0 1 2 3
    python tools/mono_loop_orders_cpu.py --package port --widths 128 512

--package jax runs the JAX package with pose_optimization's observation
rows permuted by a seeded permutation (order 0: as they come), which
changes only the order in which XLA adds the rows' terms (the inlier mask
is permuted back). --package port runs the port on the CPU with its pose
solve's twin (ops/pose_kernel.pose_gn_plain) at each reduction width
(ops/pose_kernel.BLOCK), the order the kernel at that width computes.
Prints one JSON line a run: the keyframes, the revisit pairs and their
verdicts, the JAX test's verdict and chip_smoke.py's. ~2-3 minutes a run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

P = chip_smoke.MONO_LOOP_PERIOD


def summary(tr, gates: dict, **extra) -> dict:
    return dict(**extra, state=tr.state.name, keyframes=tr.n_kf_host,
                natural_pair_passed=gates["natural_pair_passed"],
                pairs_passed=gates["pairs_passed"], passed=gates["passed"],
                zone_ratio_natural=gates["zone_ratio_natural"],
                pairs=[{k: p[k] for k in ("pair", "natural_matches", "verified", "matches",
                                          "sim3_scale_error", "drift_removed_share", "passed")}
                       for p in gates["pairs"]])


def run_jax(orders) -> list:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from gdslam_tpu.backend import optimizer
    from gdslam_tpu.backend import vocabulary as voc
    from gdslam_tpu.backend.loop_closing import LoopCloser
    from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
    from gdslam_tpu.io import synthetic
    from gdslam_tpu.system.tracking import Tracking
    cam = CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
                       bf=320.0 * 0.08)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=512, n_levels=4))
    grays = [synthetic.render(synthetic.gt_pose_loop_mono(i, P), cam, False, 30.0, i).gray
             for i in range(chip_smoke.MONO_LOOP_FRAMES)]
    real = optimizer.pose_optimization

    def permuted(order: int):
        perms = {}

        def pose_optimization(T_init, obs, K, bf, rounds=4, iters=5):
            n = obs.pw.shape[0]
            if n not in perms:            # numpy indices: constants inside a trace
                p = np.random.default_rng(order).permutation(n)
                perms[n] = (p, np.argsort(p))
            p, inv = perms[n]
            T, inl, n_inl = real(T_init, type(obs)(*(a[p] for a in obs)), K, bf, rounds, iters)
            return T, inl[inv], n_inl
        return pose_optimization

    out = []
    for order in orders:
        optimizer.pose_optimization = permuted(order) if order else real
        jax.clear_caches()
        t0 = time.perf_counter()
        try:
            tr = Tracking(cfg, kmax=64, pmax=32768)
            lc = LoopCloser(cfg, voc.default_vocabulary(), 64)
            lc.fix_scale = False
            tr.loop_closer = lc
            for i, g in enumerate(grays):
                tr.process_mono(g, i / 30.0)
            tr.flush()
            gates = chip_smoke.mono_loop_gates(tr, lc, np.asarray, jnp.asarray,
                                               lambda i: synthetic.gt_pose_loop_mono(i, P))
            line = summary(tr, gates, package="jax", order=order)
        except Exception as e:     # a run that breaks is a result too
            line = dict(package="jax", order=order, error=repr(e))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        out.append(line)
    optimizer.pose_optimization = real
    return out


def run_port(widths) -> list:
    import torch
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.backend import loop_closing
    from gdslam_tpu_torch.backend import vocabulary as voc
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.ops import pose_kernel
    from gdslam_tpu_torch.system.tracking import Tracking
    base = SlamConfig()
    cfg = dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
        bf=320.0 * 0.08), orb=dataclasses.replace(base.orb, n_features=512, n_levels=4))
    grays = [synthetic.render(synthetic.gt_pose_loop_mono(i, P, "cpu"), cfg.camera, False,
                              30.0, i).gray for i in range(chip_smoke.MONO_LOOP_FRAMES)]
    block, out = pose_kernel.BLOCK, []
    for width in widths:
        pose_kernel.BLOCK = width
        t0 = time.perf_counter()
        tr = Tracking(cfg, kmax=64, pmax=32768, device="cpu")
        lc = loop_closing.LoopCloser(cfg, voc.default_vocabulary("cpu"), 64, "cpu")
        lc.fix_scale = False
        tr.loop_closer = lc
        for i, g in enumerate(grays):
            tr.process_mono(g, i / 30.0)
        tr.flush()
        gates = chip_smoke.mono_loop_gates(tr, lc, lambda t: t.numpy(), torch.from_numpy,
                                           lambda i: synthetic.gt_pose_loop_mono(i, P))
        line = summary(tr, gates, package="port", width=width,
                       seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        out.append(line)
    pose_kernel.BLOCK = block
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--orders", type=int, nargs="+", default=[0, 1, 2, 3],
                    help="jax: permutation seeds of the pose solve's rows (0: as they come)")
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 512],
                    help="port: the twin's reduction widths")
    ap.add_argument("--threads", type=int, default=4, help="torch's CPU threads (port)")
    opts = ap.parse_args()
    if opts.package == "jax":
        run_jax(opts.orders)
    else:
        import torch
        torch.set_num_threads(opts.threads)
        run_port(opts.widths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
