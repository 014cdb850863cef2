"""The stereo and monocular phases of chip_smoke.py alone, on one NVIDIA
card: the kernels' build, `stereo` (cli/stereo_kitti.py at KITTI00-02.yaml's
settings, the stereo_match kernel held against its plain twin and timed),
`mono` (cli/mono_tum.py at the SlamConfig() defaults, the bootstrap's
match_top2 call and initialize), `mono_loop` (the JAX mono scale-drift loop
test on the card) and their determinism pairs. For iterating on the slice
without the full run. With --ab-source DIR, the earlier versions of
stereo_match.cu and categorical_draw.cu that DIR holds (as of commit
6b10eba) built beside the current ones: the draw phase and the stereo
phase with the parent's kernels timed beside the new ones on the same calls
(device ms from CUDA graphs in the order old, new, new, old, each wrapper's
whole device work, ms through each wrapper, both exact; the stereo kernel
on the PNG and the float pair, the draw at 900 x 1500 and 1800 x 1500 on
the GD keys), then `ab_quality`: the stereo driver run and gd_slice on the
parent's kernels and on the new ones, in the order parent, new, new,
parent, which must give the same ATE, stereo points, keyframes, masks and
draws (their frame times side by side).

    python3 tools/stereo_smoke.py [--phases stereo mono mono_loop]

    mkdir -p build/old && for k in stereo_match categorical_draw; do
        git show 6b10eba:gdslam_tpu_torch/csrc/$k.cu > build/old/$k.cu; done
    python3 tools/stereo_smoke.py --ab-source build/old

Prints chip_smoke.py's JSON lines for those phases; exits non-zero when a
phase fails or there is no card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", nargs="+", choices=("stereo", "mono", "mono_loop"),
                    default=("stereo", "mono", "mono_loop"))
    ap.add_argument("--ab-source", metavar="DIR",
                    help="time the earlier stereo and draw kernels in DIR beside the current "
                         "ones and run the stereo driver and gd_slice on both")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("stereo_smoke: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.backend import loop_closing
    from gdslam_tpu_torch.backend import vocabulary as voc
    from gdslam_tpu_torch.cli import mono_tum, stereo_kitti
    from gdslam_tpu_torch.frontend import extractor, initializer, matcher
    from gdslam_tpu_torch.io import kitti, png, synthetic
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.ops import stereo
    from gdslam_tpu_torch.system import slam as slam_mod
    from gdslam_tpu_torch.system import tracking
    from gdslam_tpu_torch.utils import metrics
    cfg, dev = SlamConfig(), "cuda"
    (ROOT / "build").mkdir(exist_ok=True)
    cs.emit(cs.phase_build(mk))
    stereo_mods = (stereo, matcher, slam_mod, kitti, png, synthetic, metrics, extractor,
                   stereo_kitti)
    if opts.ab_source:
        from gdslam_tpu_torch.backend import solvers
        from gdslam_tpu_torch.masking import geomask
        from gdslam_tpu_torch.system.slam import System
        from gdslam_tpu_torch.system.tracking import TrackState
        old = cs.ParentKernels(torch, Path(opts.ab_source).resolve())
        cs.emit(dict(phase="ab_build", ptxas_old=old.ptxas, card=cs.nvidia_smi_line()))
        cs.phase_draw(torch, dev, old)
        cs.phase_stereo(torch, mk, cfg, dev, stereo_mods, old)
        dyn = [synthetic.render_frame(i, cfg.camera, with_dynamic=True, device=dev)
               for i in range(cs.GD_FRAMES + cs.GD_PROFILE_FRAMES + 1)]
        raw = cs.gd_inputs(dyn, cfg.camera)
        counters_args = (matcher, tracking, geomask, solvers, slam_mod)
        cs.phase_ab_quality(torch, mk, cfg, dev, stereo_mods, lambda: cs.phase_gd_slice(
            torch, mk, cfg, dyn, raw, System, TrackState, synthetic, metrics, dev,
            counters_args)[1], old)
        return 0
    det = {}
    if "stereo" in opts.phases:
        det["stereo"] = cs.phase_stereo(torch, mk, cfg, dev, stereo_mods)[1]
    if "mono" in opts.phases:
        det["mono"] = cs.phase_mono(torch, mk, cfg, dev, (
            tracking, initializer, slam_mod, png, synthetic, metrics, mono_tum))[1]
    if "mono_loop" in opts.phases:
        cs.phase_mono_loop(torch, mk, cfg, dev, (tracking.Tracking, loop_closing.LoopCloser,
                                                 voc, synthetic))
    same = all(v for d in det.values() for v in d.values())
    cs.emit(dict(phase="determinism", compared=det, bitwise_identical=same,
                 seconds=dict(cs.PHASE_SECONDS), total_s=time.perf_counter() - cs.T_START))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
