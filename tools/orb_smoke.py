"""The orb phase of chip_smoke.py alone, on one NVIDIA card: the kernels'
build, then `orb` (csrc/orb_extract.cu's four kernels bitwise against their
plain twins on ops/orb_cases.py's frames; atan2 and the rotation bins on
given values; each kernel's ms through its wrapper, on the device, its
twin's and its bound; extract's ms, operators and kernels, the twins' route
beside it). For iterating on the front end's kernels without the full run.

    python3 tools/orb_smoke.py

With --frames ROOT, instead the end-to-end cells extract runs on, from the
chip_smoke.py and gdslam_tpu_torch/ of the checkout at ROOT: `slice` (60
static frames, not pipelined), `gd_slice` (the main path) and `stereo` (the
KITTI driver). Run it on an earlier checkout and on this one in turns to put
the frame times side by side:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 tools/orb_smoke.py --frames $r; done

Prints chip_smoke.py's JSON lines for those phases; exits non-zero when a
phase fails or there is no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def frames(torch, cs) -> None:
    """chip_smoke.py's slice, gd_slice and stereo phases, as its run() calls
    them, on the imported checkout."""
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.backend import ba, mapping, solvers
    from gdslam_tpu_torch.cli import stereo_kitti
    from gdslam_tpu_torch.frontend import extractor, matcher
    from gdslam_tpu_torch.io import kitti, png, synthetic
    from gdslam_tpu_torch.masking import geomask
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.ops import stereo
    from gdslam_tpu_torch.system import slam as slam_mod
    from gdslam_tpu_torch.system import tracking
    from gdslam_tpu_torch.system.slam import System
    from gdslam_tpu_torch.system.tracking import TrackState
    from gdslam_tpu_torch.utils import metrics
    cfg, dev = SlamConfig(), "cuda"
    cam = cfg.camera
    cs.emit(cs.phase_build(mk))
    static = [synthetic.render_frame(i, cam, with_dynamic=False, device=dev)
              for i in range(cs.N_FRAMES)]
    cs.phase_slice(torch, mk, cfg, static, System, TrackState, synthetic, metrics, dev, (3, 5),
                   modules=(mapping, ba))
    dyn = [synthetic.render_frame(i, cam, with_dynamic=True, device=dev)
           for i in range(cs.GD_FRAMES + cs.GD_PROFILE_FRAMES + 1)]
    cs.phase_gd_slice(torch, mk, cfg, dyn, cs.gd_inputs(dyn, cam), System, TrackState, synthetic,
                      metrics, dev, (matcher, tracking, geomask, solvers, slam_mod))
    cs.phase_stereo(torch, mk, cfg, dev, (stereo, matcher, slam_mod, kitti, png, synthetic,
                                          metrics, extractor, stereo_kitti))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", metavar="ROOT", type=Path,
                    help="run the slice, gd_slice and stereo phases of the checkout at ROOT")
    opts = ap.parse_args()
    root = (opts.frames or ROOT).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("orb_smoke: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    (root / "build").mkdir(exist_ok=True)
    if opts.frames:
        frames(torch, cs)
    else:
        from gdslam_tpu_torch import SlamConfig
        from gdslam_tpu_torch.ops import match_kernel as mk
        cs.emit(cs.phase_build(mk))
        cs.phase_orb(torch, SlamConfig(), "cuda")
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
