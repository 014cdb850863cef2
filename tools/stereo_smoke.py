"""The stereo and monocular phases of chip_smoke.py alone, on one NVIDIA
card: the kernels' build, `stereo` (cli/stereo_kitti.py at KITTI00-02.yaml's
settings, the stereo_match kernel held against its plain twin and timed),
`mono` (cli/mono_tum.py at the SlamConfig() defaults, the bootstrap's
match_top2 call and initialize), `mono_loop` (the JAX mono scale-drift loop
test on the card) and their determinism pairs. For iterating on the slice
without the full run.

    python3 tools/stereo_smoke.py [--phases stereo mono mono_loop]

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
    det = {}
    if "stereo" in opts.phases:
        det["stereo"] = cs.phase_stereo(torch, mk, cfg, dev, (
            stereo, matcher, slam_mod, kitti, png, synthetic, metrics, extractor,
            stereo_kitti))[1]
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
