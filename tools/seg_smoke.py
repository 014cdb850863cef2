"""The live segmenter's phases of chip_smoke.py alone, on one NVIDIA card:
the kernels' build, the port's seeded ResNet50 weights written under
build/seg/, the `seg` phase (the segmenter at full width through
SegmentDynObject and track_rgbd(use_geometry=True), its kernels held
against their plain versions and timed) and the determinism pair of
segmenters; with --cli also the whole `cli` phase (rgbd_tum --segmenter
among its runs). For iterating on the segmenter without the full run.

    python3 tools/seg_smoke.py [--cli]

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
    ap.add_argument("--cli", action="store_true", help="also run the cli phase")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("seg_smoke: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.system.slam import System
    from gdslam_tpu_torch.utils import metrics
    cfg, dev = SlamConfig(), "cuda"
    cs.emit(cs.phase_build(mk))
    dyn = [synthetic.render_frame(i, cfg.camera, with_dynamic=True, device=dev)
           for i in range(cs.CLI_FRAMES + 1)]
    weights = ROOT / "build" / "seg" / "maskrcnn_r50_seed0.npz"
    info = cs.write_seg_weights(weights)
    if opts.cli:
        cs.phase_cli(torch, mk, cfg, dyn, metrics, dev, weights)
    _, rgbs = cs.phase_seg(torch, mk, cfg, dyn, System, synthetic, metrics, dev, weights, info)
    same = cs.seg_determinism(torch, weights, dev, rgbs, cfg.camera)
    cs.emit(dict(phase="determinism", compared=dict(segmenter=same),
                 bitwise_identical=all(same.values()),
                 total_s=time.perf_counter() - cs.T_START))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
