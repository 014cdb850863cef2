"""The live segmenter's phases of chip_smoke.py alone, on one NVIDIA card:
the kernels' build, the port's seeded ResNet50 weights written under
build/seg/, the `seg` phase (the segmenter at full width through
SegmentDynObject and track_rgbd(use_geometry=True), its kernels held
against their plain versions and timed) and the determinism pair of
segmenters; with --cli also the whole `cli` phase (rgbd_tum --segmenter
among its runs). With --train, the training phases instead: `seg_train`
(the full-width fit, with the backward kernel held against its plain twin)
twice, as the determinism pair, and `seg_toy` (the toy fit run live by
rgbd_tum). With --lr-sweep LR..., the seg_train fit (20 steps, from the
same seeded and calibrated weights) at each learning rate, printing its
losses and positive ROIs per step: how chip_smoke.TRAIN_LR was chosen.
With --ab-source DIR, the `seg` and `seg_train` phases with earlier
versions of the detection kernels that DIR holds (nms_fixed.cu and
roi_align_backward.cu as of commit 4f0bef9; roi_align.cu and
paste_masks.cu as of commit 57509e6) built beside the current ones and
timed on the same recorded calls: device ms in the order old, new, new,
old, the device work of everything each wrapper launches, ms through each
wrapper, both exact, and what ptxas reports for the old ones. For
iterating on the segmenter without the full run.

    python3 tools/seg_smoke.py [--cli | --train | --lr-sweep 1e-3 3e-3 1e-2 2e-2]

    mkdir -p build/old && for k in roi_align paste_masks; do
        git show 57509e6:gdslam_tpu_torch/csrc/$k.cu > build/old/$k.cu; done
    python3 tools/seg_smoke.py --ab-source build/old

Prints chip_smoke.py's JSON lines for those phases; exits non-zero when a
phase fails or there is no card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cli", action="store_true", help="also run the cli phase")
    ap.add_argument("--train", action="store_true", help="run the training phases instead")
    ap.add_argument("--lr-sweep", nargs="+", type=float, metavar="LR",
                    help="fit seg_train at each learning rate instead")
    ap.add_argument("--ab-source", metavar="DIR",
                    help="time the earlier detection kernels in DIR beside the current "
                         "ones in seg and seg_train")
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
    if opts.ab_source:
        from gdslam_tpu_torch.ops import detect_kernels as dk
        old = cs.OldDetectKernels(torch, dk, Path(opts.ab_source).resolve())
        cs.emit(dict(phase="ab_build", ptxas_old=old.ptxas, card=cs.nvidia_smi_line()))
        render = lambda i: synthetic.render_frame(i, cfg.camera, with_dynamic=True, device=dev)
        weights = ROOT / "build" / "seg" / "maskrcnn_r50_seed0.npz"
        info = cs.write_seg_weights(weights)
        cs.phase_seg(torch, mk, cfg, [render(i) for i in range(cs.SEG_FRAMES)], System,
                     synthetic, metrics, dev, weights, info, old)
        cs.phase_seg_train(torch, dev, {i: render(i) for i in cs.TRAIN_FRAMES}, old)
        return 0
    if opts.lr_sweep:
        dyn = {i: synthetic.render_frame(i, cfg.camera, with_dynamic=True, device=dev)
               for i in cs.TRAIN_FRAMES}
        data = cs.train_data_full_width(torch, dyn)
        for lr in opts.lr_sweep:
            cs.TRAIN_LR = lr
            _, losses, comps, _, _ = cs.seg_train_run(torch, dev, data)
            n_pos = [c["n_pos_rois"] for c in comps]
            cs.emit(dict(phase="lr_sweep", lr=lr, steps=cs.TRAIN_STEPS, losses=losses,
                         n_pos_rois=n_pos, steps_with_positives=sum(v > 0 for v in n_pos),
                         head_mask=[c["head_mask"] for c in comps]))
        return 0
    if opts.train:
        dyn = {i: synthetic.render_frame(i, cfg.camera, with_dynamic=True, device=dev)
               for i in cs.TRAIN_FRAMES}
        _, trained, data = cs.phase_seg_train(torch, dev, dyn)
        again = cs.seg_train_run(torch, dev, data)[0]
        same = all(np.array_equal(trained[k], again[k]) for k in trained)
        cs.phase_seg_toy(torch, mk, cfg, dev, metrics)
        cs.emit(dict(phase="determinism", compared=dict(seg_train=dict(parameters=same)),
                     bitwise_identical=same, total_s=time.perf_counter() - cs.T_START))
        return 0 if same else 1
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
