"""Where orb_describe's time goes, on one NVIDIA card: the kernel of
csrc/orb_extract.cu built as it is and with its work cut off after each
phase, each timed from CUDA graphs on the defaults' rendered frame (1500
keypoints), in the order kept, cuts..., cuts reversed, kept:

    staged      both patches staged in shared memory, nothing computed
    moments     the raw square staged, the moments summed (the blurred
                patch left out: nothing reads it)
    bin         the same and the angle and its bin
    hot_patch   the whole kernel with every keypoint on one patch of level
                0 (its rows stay in L1: the kernel without device-memory
                and L2 traffic)

    python3 tools/orb_describe_phases.py

Prints one JSON line (us per call, each cut's ptxas registers, spills and
stack, the card) and exits non-zero without a card or when the kept build
differs from describe_plain.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGED = "    store_chunk<EXT>(sb, ab[it], it * 32 + lane, cb[it]);\n  __syncwarp();\n"
ANGLE = "  const float a = atan2f(m01, m10);\n"
TAPS = "  // lane l: taps 128 i"
CENTRE = ("  const int u = static_cast<int>(rintf(uv_lv[2 * n]));\n"
          "  const int v = static_cast<int>(rintf(uv_lv[2 * n + 1]));\n"
          "  const size_t plane = static_cast<size_t>(level[n]) * H * W;\n")


def cuts(src: str) -> dict:
    """{name: source}: the kernel as it is and cut after each phase."""
    for mark in (STAGED, ANGLE, TAPS, CENTRE):
        if mark not in src:
            raise SystemExit(f"orb_describe_phases: the source has no {mark.strip()[:40]!r}")
    return {
        "kept": src,
        "staged": src.replace(STAGED, STAGED + "  desc[static_cast<size_t>(n) * 32 + lane] = "
                              "static_cast<uint8_t>(sb[lane * EXT + 5] + sr[lane * RAW % 961]);\n"
                              "  return;\n"),
        "moments": src.replace(ANGLE, "  if (lane == 0) angle[n] = m10 + m01;\n  return;\n" + ANGLE),
        "bin": src.replace(TAPS, "  if (lane == 0) angle[n] = a + bin;\n  return;\n" + TAPS),
        "hot_patch": src.replace(CENTRE, "  const int u = 100 + (n & 1), v = 100;\n"
                                 "  const size_t plane = 0;\n")}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("orb_describe_phases: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch.ops import cuda_build, image, orb as orb_ops, orb_cases as oc
    from gdslam_tpu_torch.ops import orb_kernel as ok
    out_dir = ROOT / "build" / "orb_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in cuts(cuda_build.source("orb_extract").read_text()).items():
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc(name), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stderr=subprocess.PIPE, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            print(f"orb_describe_phases: {name} did not build:\n{err}", file=sys.stderr)
            return 1
        ptxas[name] = cs.ptxas_kernels(cs.ptxas_lines(err)).get("describe_kernel")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        ok._declare(libs[name])

    gray, orb, cam = oc.orb_input("rendered", "cuda")
    canvas, shapes = image.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                         orb.scale_factor)
    blurred = ok.gaussian_blur7(canvas, shapes)
    quotas = orb_ops.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor)
    sel = ok.orb_quota_select(*ok.orb_fast_cells(canvas, shapes, orb.ini_th_fast,
                                                 orb.min_th_fast), shapes, quotas,
                              orb.scale_factor)
    n, (H, W) = sel[0].shape[0], canvas.shape[1:]
    angle = torch.empty(n, device="cuda")
    desc = torch.empty(n, 32, dtype=torch.uint8, device="cuda")
    args = (canvas.data_ptr(), blurred.data_ptr(), H, W, sel[1].data_ptr(), sel[3].data_ptr(), n,
            ok._taps_i32_on(canvas.device).data_ptr(), ok.RCP_BIN, angle.data_ptr(),
            desc.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    libs["kept"].orb_describe_launch(*args, torch.cuda.current_device(), stream)
    want = ok.describe_plain(canvas, blurred, sel[1], sel[3])
    torch.cuda.synchronize()
    exact = cs.differing(torch, angle, want[0]) + cs.differing(torch, desc, want[1]) == 0
    names = list(libs)
    us = {}
    for name in names + names[::-1]:
        us.setdefault(name, []).append(
            cs.graph_ms(torch, libs[name].orb_describe_launch, args, calls=50) * 1e3)
    print(json.dumps(dict(keypoints=n, us=us, kept_exact=exact, ptxas=ptxas,
                          card=cs.nvidia_smi_line())), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
