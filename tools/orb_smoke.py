"""The orb phase of chip_smoke.py alone, on one NVIDIA card: the kernels'
build, then `orb` (csrc/orb_extract.cu's four kernels bitwise against their
plain twins on ops/orb_cases.py's frames and edge cases; atan2 and the
rotation bins on given values; each kernel's ms through its wrapper, on
the device, its twin's and its bound; extract's ms, operators and kernels,
the twins' route beside it). For iterating on the front end's kernels without the full run.

    python3 tools/orb_smoke.py

With --frames ROOT, instead the end-to-end cells extract runs on, from the
chip_smoke.py and gdslam_tpu_torch/ of the checkout at ROOT: `slice` (60
static frames, not pipelined), `gd_slice` (the main path) and `stereo` (the
KITTI driver). Run it on an earlier checkout and on this one in turns to put
the frame times side by side:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do python3 tools/orb_smoke.py --frames $r; done

With --compare FILE..., no card: the --frames runs those files hold (each
run's lines from its build line on) side by side: per phase, every result
field that differs between runs (times, profiles, peak memory and the
file:line keys of host waits left out), and each run's frame time. Exits 1 if a result
differs:

    python3 tools/orb_smoke.py --compare parent.jsonl new.jsonl

With --ab-source DIR, the orb phase also builds the earlier
csrc/orb_extract.cu that DIR holds and times its gaussian_blur7 and
orb_describe, behind the current wrappers (an earlier blur that takes no
level shapes, as 4a0d7fd's, gets them dropped by chip_smoke._ParentOrb), beside the current ones on the
same calls: device ms from CUDA graphs in the order old, new, new, old,
each wrapper's whole device work, ms through each wrapper, both bitwise
their twins; ptxas's registers, spills and stack of both builds' blur and
descriptor kernels (`ptxas_ab`):

    mkdir -p build/old && git show 4a0d7fd:gdslam_tpu_torch/csrc/orb_extract.cu \
        > build/old/orb_extract.cu
    python3 tools/orb_smoke.py --ab-source build/old

Prints chip_smoke.py's JSON lines for those phases; exits non-zero when a
phase fails or there is no card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAME_PHASES = ("slice", "gd_slice", "stereo")
# fields that are times, profiles or memory, not results
TIMING = re.compile(r"(^|[._])(\w*_ms|ms|fps|run_s|write_s|wall\w*|profile\w*|"
                    r"host_sync_sites|card|peak_mem_mb)([._]|$)")
FRAME_TIME = {"slice": "frame_ms_median", "gd_slice": "frame_ms", "stereo": "frame_ms_median"}


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


def _flat(d, pre: str = "") -> dict:
    out = {}
    items = d.items() if isinstance(d, dict) else enumerate(d)
    for k, v in items:
        if isinstance(v, (dict, list)) and v and not isinstance(v, str):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def compare(paths) -> int:
    """The --frames runs in `paths` side by side (see the module's doc)."""
    runs = []
    for path in paths:
        for line in Path(path).read_text().splitlines():
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if d.get("phase") == "build" or not runs:
                runs.append({})
            if d.get("phase") in FRAME_PHASES:
                runs[-1][d["phase"]] = d
    differ = False
    for phase in FRAME_PHASES:
        fields = [_flat(r[phase]) for r in runs if phase in r]
        keys = sorted(set().union(*fields)) if fields else []
        diff = {k: [f.get(k) for f in fields] for k in keys if not TIMING.search(k) and
                len({json.dumps(f.get(k), sort_keys=True) for f in fields}) > 1}
        differ |= bool(diff)
        print(json.dumps(dict(phase=phase, runs=len(fields), results_differing=diff,
                              frame_ms=[f.get(FRAME_TIME[phase]) for f in fields])), flush=True)
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", metavar="ROOT", type=Path,
                    help="run the slice, gd_slice and stereo phases of the checkout at ROOT")
    ap.add_argument("--compare", metavar="FILE", nargs="+",
                    help="put the --frames runs in FILE... side by side (no card)")
    ap.add_argument("--ab-source", metavar="DIR", type=Path,
                    help="time the earlier blur and descriptor kernels in DIR beside the "
                         "current ones")
    opts = ap.parse_args()
    if opts.compare:
        return compare(opts.compare)
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
        old = cs.ParentKernels(torch, opts.ab_source.resolve()) if opts.ab_source else None
        cs.phase_orb(torch, SlamConfig(), "cuda", old)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
