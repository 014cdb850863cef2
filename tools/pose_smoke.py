"""The pose phase of chip_smoke.py alone, on one NVIDIA card: the kernels'
build (with ptxas's report of csrc/pose_gn.cu), then `pose` on
ops/pose_cases.py's cases only: pose_gn bitwise against its plain twin and
repeatable, its sinf / cosf / sqrtf against torch's, its ms through the
wrapper, on the device from a CUDA graph, the twin's, the bound and the
one-SM ceiling on the tracker's, the stereo cell's and the mono bootstrap's
case. The calls recorded at every path's call sites need the full run. For
iterating on the kernel without it.

    python3 tools/pose_smoke.py

With --mono-loop WIDTH..., instead chip_smoke.py's mono_loop phase once for
each WIDTH: `kernel` solves every pose with pose_gn, a number with the plain
twin on the card at that reduction width (ops/pose_kernel.BLOCK), one
rounding order of the same sums each. The phase's gate rests on one chaotic
monocular run, so this shows how it moves with the order alone:

    python3 tools/pose_smoke.py --mono-loop kernel 64 128 256 512

With --widths WIDTH..., instead csrc/pose_gn.cu built at each reduction
width (its BLOCK) into build/pose_widths/, each build held bitwise to the
twin at that width on the tracker's, the stereo cell's and the 6001-row
case, then timed through the wrapper and from a CUDA graph, the widths in
the order given and back, all in one process:

    python3 tools/pose_smoke.py --widths 512 256 128

Prints chip_smoke.py's JSON lines (each mono_loop line after a
{"width": ...} line, a failed gate as {"failed": ...}; one line a width and
pass for --widths); exits non-zero when a phase fails (the pose phase, a
width's build that differs from its twin) or there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def mono_loop(torch, cs, widths) -> None:
    """chip_smoke.py's mono_loop once for each width (see the module's doc)."""
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.backend import loop_closing
    from gdslam_tpu_torch.backend import vocabulary as voc
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.ops import pose_kernel
    from gdslam_tpu_torch.system import tracking
    kernel, block = pose_kernel.pose_gn, pose_kernel.BLOCK
    for width in widths:
        print(json.dumps(dict(width=width)), flush=True)
        if width == "kernel":
            pose_kernel.pose_gn, pose_kernel.BLOCK = kernel, block
        else:
            pose_kernel.pose_gn, pose_kernel.BLOCK = pose_kernel.pose_gn_plain, int(width)
        try:
            cs.phase_mono_loop(torch, mk, SlamConfig(), "cuda",
                               (tracking.Tracking, loop_closing.LoopCloser, voc, synthetic))
        except SystemExit as e:
            print(json.dumps(dict(failed=str(e))), flush=True)
    pose_kernel.pose_gn, pose_kernel.BLOCK = kernel, block


def widths(torch, cs, ws) -> bool:
    """csrc/pose_gn.cu at each width of ws (see the module's doc); False if
    a build differs from its twin."""
    import ctypes
    import subprocess
    from gdslam_tpu_torch.ops import cuda_build, pose_cases
    from gdslam_tpu_torch.ops import pose_kernel as pk
    src, line = cuda_build.source(pk.LIB).read_text(), f"constexpr int BLOCK = {pk.BLOCK};"
    if src.count(line) != 1:
        raise RuntimeError(f"{line!r} not found once in csrc/pose_gn.cu")
    out = ROOT / "build" / "pose_widths"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for w in ws:
        cu, so = out / f"pose_gn_{w}.cu", out / f"libpose_gn_{w}.so"
        cu.write_text(src.replace(line, f"constexpr int BLOCK = {w};"))
        subprocess.run([cuda_build.nvcc(pk.LIB), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True)
        libs[w] = ctypes.CDLL(str(so))
        pk._declare(libs[w])
    cases = {c: pose_cases.pose_args(c, "cuda") for c in ("tracker_1500", "stereo_2000",
                                                          "ragged_6001")}
    block, loaded, ok = pk.BLOCK, cuda_build._libs.get(pk.LIB), True
    try:
        for w in list(ws) + list(reversed(ws)):
            pk.BLOCK, cuda_build._libs[pk.LIB] = int(w), libs[w]
            line = dict(width=int(w))
            for c, args in cases.items():
                cmp = cs.pose_compare(torch, pk, args)
                fn, a, keep = cs.c_launch(torch, lambda: pk.pose_gn(*args))
                line[c] = dict(differing=cmp["differing"],
                               ms=cs.cuda_ms(torch, lambda: pk.pose_gn(*args), reps=200),
                               device_ms=cs.graph_ms(torch, fn, a))
                del keep
                ok = ok and cmp["differing"] == 0
            print(json.dumps(line), flush=True)
    finally:
        pk.BLOCK = block
        if loaded is None:
            cuda_build._libs.pop(pk.LIB, None)
        else:
            cuda_build._libs[pk.LIB] = loaded
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", nargs="+", type=int, metavar="WIDTH",
                    help="build and time the kernel at each reduction width instead")
    ap.add_argument("--mono-loop", nargs="+", metavar="WIDTH",
                    help="run chip_smoke.py's mono_loop with the kernel ('kernel') or the "
                         "plain twin at each reduction width instead")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("pose_smoke: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch.ops import match_kernel as mk
    (ROOT / "build").mkdir(exist_ok=True)
    cs.emit(cs.phase_build(mk))
    if opts.widths:
        if not widths(torch, cs, opts.widths):
            print(cs.nvidia_smi_line(), flush=True)
            return 1
    elif opts.mono_loop:
        mono_loop(torch, cs, opts.mono_loop)
    else:
        cs.phase_pose(torch, "cuda", paths=False)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
