#!/usr/bin/env python3
"""Smoke run of gdslam_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --ab-source old/match_top2.cu

Builds the port's CUDA kernels from gdslam_tpu_torch/csrc/ into build/kernels/,
then prints one JSON line per phase:

  device   the card (torch and nvidia-smi);
  build    the nvcc builds of every csrc/*.cu (match_top2, nms_fixed,
           roi_align, roi_align_backward, paste_masks, stereo_match,
           categorical_draw, orb_extract, pose_gn), one nvcc per source
           started together, timed,
           what ptxas reports for each, and the draw kernel's SASS opcodes;
  kernel   match_top2 (CUDA) against match_top2_plain (PyTorch) on the card,
           exactly, with the kernel choosing its path and with each path
           forced: seeded random and rendered-frame inputs at (M, N) =
           (1500, 1500) and (4096, 1500), and the inputs a cell walk can get
           wrong (clustered keypoints, cell and image borders, radii of 0,
           one cell, beyond the image, mixed per row, ties across cells,
           invalid and empty sides, non-finite values); the keypoint grid
           against kp_grid_plain; both versions' times;
  draw     categorical_draw (jax.random.categorical, the draw of every
           RANSAC) bitwise against its plain twin, indices and Gumbel noise,
           at 900 x 1500 and 1800 x 1500 on 64 keys of the GD fast path (the
           key folded on the card from a frame-id tensor, or given as host
           words), and against the numpy replay
           (core/prng.py, held to jax.random on the CPU); its ms through the
           wrapper, on the device, the plain twin's, torch.multinomial's (the
           call it replaced), the numpy replay's host ms and the bound;
  orb      the ORB front end's four kernels (csrc/orb_extract.cu:
           orb_fast_cells, orb_quota_select, gaussian_blur7, orb_describe)
           bitwise against their plain twins, each on the inputs the kernel
           before it made, and extract bitwise against the twins' whole
           route, on ops/orb_cases.py's frames (the defaults' static and GD
           dynamic frames, the stereo cell's left image at 2000 features,
           the 120x160 rig whose top levels pad, flat, saturated, integer
           noise, a checkerboard), orb_quota_select alone on its edges
           (ops/orb_cases.QUOTA_CASES), gaussian_blur7 and orb_describe
           alone on theirs (BLUR_CASES, DESCRIBE_CASES); orb_describe's
           atan2f and bins on the frame's moment pairs, pairs near the axes
           and angles next to every bin edge; each kernel's ms through its
           wrapper, from a CUDA graph, its twin's, its bound and (the blur)
           one F.conv2d's; extract's ms
           through the host, device ms, ATen operators and device kernels,
           the twins' route (the parent's) beside it, old, new, new, old;
           extract must not wait for the card and dispatch at most 40
           operators;
  slice    60 rendered 480x640 frames through System.track_rgbd at the
           SlamConfig() defaults (kmax=256, pmax=65536; epipolar
           triangulation and local BA on, as the tracker is constructed):
           every frame OK, ATE against the renderer's ground truth,
           keyframes, triangulated points, Replace merges, BA outlier
           observations, host synchronisations per frame, and the kernel's
           launches on this path;
  slice_pipelined
           the same frames with pipeline=True (commit_every=3) and a flush
           at the end, with the same guards, timed without a synchronise
           per frame (run a second time after the compact phase, so that
           the two modes alternate);
  reloc    a forced loss on the slice's final state (the last pose put 1 m
           off, no velocity): the next frame must relocalize to within
           2 cm and 1 degree of ground truth with >= 50 inliers; times
           _relocalize and ransac_pnp alone;
  compact  the slice with a keyframe arena one slot larger than its keyframes,
           which saturates: the tracker must warn and go on tracking; then
           a keyframe is invalidated by hand and _maybe_compact must recycle
           its slot and tracking must go on;
  gd_slice the main path: 80 frames of the dynamic scene (a moving sphere)
           through System.track_rgbd_gd, pipelined with commit_every 10 and
           fed uint8 gray + uint16 depth as bench.py::bench_gd feeds it, so
           warm frames take the packed fast path (GD mask, frame build and
           tracking dispatched together): every frame OK, ATE <= 0.1 m,
           mask recall >= 0.5 and IoU >= 0.35 against the renderer's
           dyn_mask on the 10 frames after the three timed windows of 20
           (frame time: their median), host synchronisations per frame,
           match_top2 launches by call site, the share of frames whose pose
           RANSAC found enough inliers; the JAX package's quality numbers
           printed beside as a reference;
  gd_staged
           20 frames the same way without pipelining: every frame takes the
           staged path (the ring's get_mask, then the tracker's body);
  geom_slice
           the DynaSLAM geometry path as bench.py::bench_geometry runs it:
           System.track_rgbd(use_geometry=True), pipelined with commit_every
           6, on the dynamic scene (gray + depth on the card, no semantic
           mask): warm-up until 8 keyframes, a timed 30-frame window, the 10
           quality frames bench scores, two more timed windows (frame time:
           the median of the three); every frame OK,
           ATE <= 0.1 m, mask recall >= 0.5, IoU >= 0.35 (the JAX package's
           numbers printed beside), host synchronisations per frame (the
           flush alone, 1/6), DB inserts against keyframes, match_top2
           launches by call site (LightTrack's two searches named apart);
  geom_staged
           20 frames of System.track_rgbd_geom, not pipelined (RGB in,
           inpainted RGB and depth and the refined mask out): the JAX test's
           hole rule on every frame with a hole and a DB view, and the
           inpainted share of the hole;
  gd_inpaint
           20 frames of System.track_rgbd_gd(inpaint=True) as the CLI's
           output-directory mode runs it (pipelined, host uint8 RGB + uint16
           depth), with the same hole guard;
  cli      both CLIs on a 40-frame TUM-layout sequence of the dynamic scene
           written with io/png.py under build/: rgbd_tum in its three modes
           and evaluate --mode gd and --mode geometry with --ref-masks, held
           to the JAX CLI tests' ATE gates; trajectory files, epoch
           timestamps, output PNGs that round-trip; which frame loader ran;
           and rgbd_tum with an empty mask directory and --segmenter
           flax:<file> (the port's seeded ResNet50 weights, written under
           build/seg/ by its save_variables): every frame cached, ATE under
           the JAX live-segmenter test's 0.30 m;
  seg      the live Mask R-CNN at full width (ResNet50-FPN, 81 classes,
           pre_nms 1024, post_nms 128, max_det 32; 480x640 molded to
           240x320) on 20 dynamic frames through SegmentDynObject and
           System.track_rgbd(use_geometry=True), pipelined, as rgbd_tum's
           argc==6 mode: every detection kernel launched, ATE < 0.30 m; the
           segmenter's ms through the host, device busy ms, device
           operations and idle share, the backbone's share, launches per
           frame; each detection kernel against its plain version on that
           run's intermediates at score_th 0.7 and 0 (NMS and ROIAlign
           exact, the paste by the 1e-6 margin rule), with its ms through the
           wrapper, replayed from a CUDA graph, the plain version's and its
           bound, at every call shape; ROIAlign on boxes a few ulps either
           side of each level threshold (the crop and the prologue it writes
           for the gradient bitwise), the paste on adversarial boxes
           (bitwise, and its tile-list mirror), each one launch a call;
  seg_train
           Mask R-CNN training at full width: MaskRCNN() at 240x320 (a
           480x640 frame molded as the segmenter molds it) on four dynamic
           frames, the sphere's dyn_mask as a person box and mask; seeded
           weights, calibrate_batch_stats (2 passes), 20 steps of
           train_sampled (batch 2, 64 ROIs at a positive ratio of 0.33,
           clipped SGD with momentum): every named loss finite, the last total
           below the first, ms per step, peak device memory, launches per
           step; the ROIAlign backward kernel bitwise against its plain twin
           and repeatable at both training shapes (the box head's [64, 7, 7,
           256], the mask head's [64, 14, 14, 256]), also on the prologue the
           forward kernel writes, timed through the wrapper, from a CUDA
           graph and against its bound;
  seg_toy  the JAX live-segmenter e2e test's toy fit on the card (train_toy,
           blocks (1, 1, 1, 1) at 120x160, 150 steps) run live by rgbd_tum
           --segmenter on its 14-frame sequence: mean recall of the sphere >
           0.3, ATE < 0.30 m (the test's rows gate printed, not held), the
           fit's seconds and final loss;
  stereo   the stereo tracker at ORB-SLAM2's KITTI00-02.yaml settings (1241 x
           376, fps 10, bf 386.1448, 2000 features, 8 levels): 60 rendered
           static pairs (the right view shifted by the baseline) written as a
           KITTI layout of 8-bit PNGs under build/, then cli/stereo_kitti.py
           in-process on the card: every frame tracked, ATE < 0.10 m and at
           most 1.5 x the JAX package's on the same PNGs + 5 mm, frame ms,
           stereo points per frame, keyframes; stereo_match once a frame,
           exact against its plain twin at 2000 x 2000 on a PNG pair and on
           the renderer's float pair, timed through the wrapper and from a
           CUDA graph against its bound; match_top2 exact at the path's call
           shapes, both paths forced; a profiled window of 5 frames;
  mono     the monocular tracker with the SlamConfig() defaults at 480 x 640
           on every second frame of the static scene (60 frames), written as
           a TUM monocular layout of RGB PNGs, through cli/mono_tum.py
           in-process: the bootstrap succeeds at the JAX package's frame 2
           (its used_homography), OK at the end, 11 +- 1 keyframes (the JAX
           package's), map points made after the bootstrap pair, the
           scale-aligned keyframe ATE at most 1.5 x the JAX package's + 1 cm;
           the bootstrap's all-pairs match_top2 call exact (both paths) and
           its JAX index rule as on the CPU; initialize's ms, repeat, the CPU
           route's result on the same inputs (the same model choice and good
           points), its waits for the card (the 8-point systems' copy out and
           back two of them) and the SVD batches' ms;
  mono_loop
           tests/test_loop_e2e.py::test_mono_scale_drift_corrected on the card
           at its 320x240 rig with the default vocabulary: 170 mono frames
           with a free-scale loop closer, a 1.2x similarity injected into the
           recent half of the map, compute_transform and correct held to the
           JAX test's gates (the Sim3 scale within 5% of 1.2 x the natural
           pair scale, >= 50% of the cross-zone drift removed) on each of the
           last five keyframes' revisit pairs, one of which must pass (the
           JAX test's own pair, the last keyframe's, reported beside);
  batch    many sequences on one card (parallel/batch_eval.py, BASELINE
           config 5) through batched_track_step at the SlamConfig() width
           (kmax 64, pmax 8192), slot b from frame 3b: B = 1 (8 slots each
           alone), 4 and 8 on 20 static frames (every slot initialized and
           never lost, each slot's ATE <= 0.1 m, every slot of B = 4 and 8
           bitwise its B = 1 run: the state, the stats and host mirrors of
           every step; seconds per step, sequences x frames per second, the
           host's waits per step, the card's idle share over a step); slot 0
           of B = 4 blacked out at frames 3-4 (lost at frame 4, relocalized
           within 0.1 m of the clean run, the other slots bitwise the clean
           run); B = 4 GD slots on 12 dynamic frames (the ring full, nothing
           lost, each slot bitwise its B = 1 run); match_top2 and the draw
           launched on the path and exact against their plain twins on its
           call shapes;
  pose     pose_gn (csrc/pose_gn.cu, the pose Gauss-Newton solve: one
           launch a solve) bitwise against its plain twin, and a second
           call bitwise the first, on ops/pose_cases.py's cases (the
           tracker's 1500 rows, the stereo cell's 2000, the mono
           bootstrap's refinement, no row valid, rows behind the camera, a
           NaN row, one point, N = 1, 513, 1501, 6001) and on the first call
           each path made at each call site (recorded while the phases above
           ran, record_pose_calls:
           the motion model, the local map, LightTrack's narrow and wide
           searches, relocalization, a batch slot's solves and its
           relocalization, the mono bootstrap, stereo at 2000 rows); its
           sinf, cosf and sqrtf bitwise torch's; its ms through the wrapper,
           on the device from a CUDA graph, the twin's, the bound and the
           one-SM ceiling at the tracker's, stereo's and mono's calls;
           ptxas's registers and spills; the launches on every path;
  stages   per-stage times on the slice's final state (extract, the
           tracking programs, the keyframe program and its parts, the
           RANSACs; extract, track_frame_core and keyframe_program must not
           wait for the card), and
           the kernel timed against its bounds and the launch floor on the
           inputs the tracker gives it at its four call sites and at
           relocalization's all-pairs call;
  gd_stages
           the GD program's parts on the GD slice's final state: gd_step,
           farneback_flow, mahalanobis_mask, depth_edges, the cur x ref
           match (also exact against match_top2_plain, timed against its
           bound) and ransac_rigid: ms through the host, device busy and
           device operations per call; gd_step must not wait for the card;
  geom_stages
           the geometry frame's parts on geom_slice's final state:
           extract_dynamic_seeds, depth_region_growing, correction_dynamic_mask,
           inpaint (the 20-frame DB), LightTrack (both searches) and the whole
           pipelined frame's device work, which must not wait for the card:
           ms through the host, device busy and device operations per call;
           a profiler window over 3 whole geometry frames;
  profile  torch.profiler windows over whole frames (pipelined and not, and
           GD frames), over one pose solve and over one local BA: device
           busy share, device operations, host operators;
  determinism
           pairs of runs bitwise identical: the default slice sync and
           pipelined, inpainting, the small loop runs, two segmenters
           built from the same weight file on the same 5 frames (the masks
           and every detection output, with cuDNN's algorithm choice), two
           seg_train fits (every trained parameter), the stereo run twice and
           the mono run twice (trajectory files and keyframe poses; mono's
           initialize too).

Then the seconds each phase took (phase_seconds), the card's name and power
limit as nvidia-smi gives them, the kernels line (each kernel's launches by
path: every path must launch match_top2 and the four front-end kernels, and
pose_gn every tracking path)
and, last, the ok line.
Every JSON line is also written whole to chiprun_out/chip_smoke.jsonl. Without
a card, or when any phase fails, it exits non-zero and prints no ok line.

--ab-source names an earlier version of the kernel's source (one
match_top2_launch with the first version's 17 arguments). It is built
beside the current one; the stages phase then times old, new, new, old at
each call site, and the first 20 frames are run with local BA and
triangulation off on the new and on the old kernel and must give the same
trajectory, keyframes and map points.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores. The INT32 rate is derived from the f32 one: an SM
# has 64 INT32 lanes beside its 128 FP32 lanes, and the f32 figure counts an
# FMA as two operations, so int32 = f32 / 4.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 4

N_FRAMES = 60
AB_FRAMES = 20         # the base of --ab-source: BA and triangulation off
WARMUP_FRAMES = 10
ATE_GUARD_M = 0.01
RELOC_GUARD = (0.02, 1.0, 50)   # metres, degrees, inliers

# The GD slice (the main path), as bench.py::bench_gd runs it: 185 frames,
# warm-up until 10 keyframes (at most to frame 145), three timed windows of
# 30 frames, then 10 quality frames
GD_FRAMES = 185
GD_COMMIT_EVERY = 10
GD_WARMUP_KEYFRAMES = 10
GD_WINDOW = 30
GD_TAIL = 10
GD_PROFILE_FRAMES = 10         # rendered beyond GD_FRAMES, with one for the stages
GD_STAGED_FRAMES = 20
GD_ATE_GUARD_M = 0.1
GD_MASK_GUARD = (0.5, 0.35)    # recall, IoU
# The JAX package's quality on this scene (BENCH_r05, run on a TPU v5e): a
# quality reference only, printed beside the port's
GD_JAX_QUALITY = dict(ate_m=0.017, mask_recall=0.781, mask_iou=0.502)

# The DynaSLAM geometry path, as bench.py::bench_geometry runs it (on the GD
# slice's dynamic frames): pipelined with commit_every 6, warm-up until 8
# keyframes, then timed windows and 10 quality frames; its guards are the GD
# slice's. The JAX package's quality there (BENCH_r05, a TPU v5e run), a
# quality reference only.
GEOM_COMMIT_EVERY = 6
GEOM_WARMUP_KEYFRAMES = 8
GEOM_WINDOW = 30
GEOM_TAIL = 10
GEOM_PROFILE_FRAMES = 10
PROFILED_FRAMES = 3            # whole plain, GD and geometry frames under one profiler window
                               # (5 until PR 13): its event processing is most of the profile
                               # phases' time
GEOM_STAGED_FRAMES = 20
GD_INPAINT_FRAMES = 20
GEOM_JAX_QUALITY = dict(ate_m=0.0423, mask_recall=1.0, mask_iou=0.715)
CLI_FRAMES = 40
CLI_EPOCH = 1305031790.0       # TUM epoch seconds: timestamps must stay float64


PHASE_SECONDS: dict = {}           # each phase line: seconds since the line before it
_LAST_LINE = [time.perf_counter()]
LINES_FILE = ROOT / "chiprun_out" / "chip_smoke.jsonl"   # every line, whole


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    LINES_FILE.parent.mkdir(exist_ok=True)
    with open(LINES_FILE, "a") as f:
        f.write(line + "\n")
    now = time.perf_counter()
    if "phase" in obj:
        PHASE_SECONDS[obj["phase"]] = now - _LAST_LINE[0]
    _LAST_LINE[0] = now


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, windows: int = 5) -> float:
    """Median over `windows` of CUDA-event time per call over `reps` calls."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def wall_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host time per call, each call ended by a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


# ----------------------------------------------------------------------------
# match_top2: inputs, exact comparison, timing, bound
# ----------------------------------------------------------------------------

def top2_args(torch, uv_c, desc_c, rad_c, lvl_c, val_c, uv_k, desc_k, lvl_k, val_k):
    """The wrapper's argument list, in its dtypes, contiguous."""
    f = lambda x: x.float().contiguous()                       # noqa: E731
    i = lambda x: x.to(torch.int32).contiguous()               # noqa: E731
    b = lambda x: x.bool().contiguous()                        # noqa: E731
    return (f(uv_c), desc_c.contiguous(), f(rad_c), i(lvl_c), b(val_c),
            f(uv_k), desc_k.contiguous(), i(lvl_k), b(val_k))


def random_args(torch, M, N, seed, dev):
    """Seeded random candidates and keypoints on a 640x480 image; 60% of the
    keypoints sit near a candidate with a few flipped bits, and rows 0..5
    are duplicates, so ties and real matches both occur."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    uv_c = torch.rand(M, 2, generator=g) * torch.tensor([640.0, 480.0])
    desc_c = torch.randint(0, 256, (M, 32), generator=g, dtype=torch.uint8)
    lvl_c = torch.randint(0, 8, (M,), generator=g)
    desc_c[1:6], uv_c[1:6], lvl_c[1:6] = desc_c[0], uv_c[0], lvl_c[0]
    val_c = torch.rand(M, generator=g) > 0.1
    src = torch.randint(0, M, (N,), generator=g)
    near = torch.rand(N, generator=g) < 0.6
    uv_k = torch.where(near[:, None], uv_c[src] + 3 * torch.randn(N, 2, generator=g),
                       torch.rand(N, 2, generator=g) * torch.tensor([640.0, 480.0]))
    flips = (torch.randint(0, 256, (N, 32), generator=g) < 8).to(torch.uint8) * \
        torch.randint(1, 256, (N, 32), generator=g, dtype=torch.uint8)
    desc_k = torch.where(near[:, None], desc_c[src] ^ flips,
                         torch.randint(0, 256, (N, 32), generator=g, dtype=torch.uint8))
    lvl_k = torch.where(near, lvl_c[src], torch.randint(0, 8, (N,), generator=g))
    val_k = torch.rand(N, generator=g) > 0.1
    rad_c = 15.0 * 1.2 ** lvl_c.float()
    return top2_args(torch, *(x.to(dev) for x in (uv_c, desc_c, rad_c, lvl_c, val_c,
                                                    uv_k, desc_k, lvl_k, val_k)))


def frame_args(torch, cand_frames, kp_frame, M, base_radius):
    """Rendered-frame inputs as the tracker builds them: candidates are the
    keypoints of `cand_frames` (depth-valid) at their own positions with the
    path's radii (base_radius * 1.2^level), keypoints are `kp_frame`'s."""
    uv = torch.cat([f.uv for f in cand_frames])[:M]
    desc = torch.cat([f.desc for f in cand_frames])[:M]
    lvl = torch.cat([f.level for f in cand_frames])[:M]
    val = torch.cat([f.valid & (f.depth > 0) for f in cand_frames])[:M]
    return top2_args(torch, uv, desc, base_radius * 1.2 ** lvl.float(), lvl, val,
                     kp_frame.uv, kp_frame.desc, kp_frame.level, kp_frame.valid)


def special_cases(torch, dev) -> dict:
    """Inputs that a walk over image cells can get wrong and an all-pairs
    walk cannot. A tenth element, where present, is the level slack."""
    W, H = 640.0, 480.0
    g = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape):
        return torch.rand(*shape, generator=g).to(dev)

    def base(M=1500, N=1500, seed=3):
        return list(random_args(torch, M, N, seed, dev))

    cases = {}
    a = base()                                  # every keypoint in one small patch
    a[5] = 300.0 + 2.0 * rnd(1500, 2)
    a[0][:800] = 300.0 + 2.0 * rnd(800, 2)
    cases["clustered_patch"] = a
    a = base()                                  # every keypoint on one point: one cell
    a[5] = torch.tensor([320.0, 240.0], device=dev).repeat(1500, 1)
    a[0][:800] = a[5][:800] + 20.0 * (rnd(800, 2) - 0.5)
    cases["clustered_point"] = a
    a = base()            # keypoints and rows on cell borders (32 x 24 cells of 20 px) and image borders
    xs, ys = torch.arange(0, 33, device=dev) * 20.0, torch.arange(0, 25, device=dev) * 20.0
    lattice = torch.cartesian_prod(xs, ys)                           # 825 points
    a[5][:825], a[0][:825] = lattice, lattice.flip(0)
    a[0][825:1200] = lattice[:375] + torch.tensor([20.0, 0.0], device=dev)
    a[2] = torch.tensor([0.0, 20.0, 20.000002, 19.999998, 28.284271], device=dev)[
        torch.arange(1500, device=dev) % 5]
    a[4][:1200], a[8][:825] = True, True
    cases["borders"] = a
    a = base()                                  # only coincident pairs pass
    a[2] = torch.zeros_like(a[2])
    a[0][:700], a[3][:700] = a[5][:700], a[7][:700]
    cases["radius_0"] = a
    a = base()
    a[2] = torch.full_like(a[2], 20.0)
    cases["radius_one_cell"] = a
    a = base()                                  # the all-pairs callers' shape
    a[2] = torch.full_like(a[2], 1000.0)
    cases["dense_1500x1500"] = a
    cases["dense_1500x1500_any_level"] = a + [7]
    for rad in (100.0, 150.0):                  # between the two regimes
        a = base()
        a[2] = torch.full_like(a[2], rad)
        cases[f"radius_{int(rad)}_1500x1500"] = a
    a = base(4096, 1500, 4)
    a[2] = torch.tensor([0.0, 1.0, 20.0, 90.0, 1e4, float("inf")], device=dev)[
        torch.randint(0, 6, (4096,), generator=g).to(dev)]
    cases["radius_mixed_4096x1500"] = a
    a = base()                                  # four descriptors in all: ties across cells
    four = torch.randint(0, 256, (4, 32), generator=g, dtype=torch.uint8).to(dev)
    a[1] = four[torch.randint(0, 4, (1500,), generator=g).to(dev)]
    a[6] = four[torch.randint(0, 4, (1500,), generator=g).to(dev)]
    a[2] = torch.full_like(a[2], 60.0)
    cases["ties_across_cells"] = a
    cases["level_slack_0"] = base() + [0]
    a = base()
    a[4] = torch.zeros_like(a[4])
    cases["cand_all_invalid"] = a
    a = base()
    a[8] = torch.zeros_like(a[8])
    cases["kp_all_invalid"] = a
    a = base()
    a[5][::7, 0], a[5][3::7, 1], a[5][5::7] = float("nan"), float("inf"), -float("inf")
    a[0][::6, 0], a[0][2::6, 1] = float("nan"), float("inf")
    a[2][4::6], a[2][5::12], a[2][1::6] = float("inf"), float("nan"), 1e30
    cases["non_finite"] = a
    a = base()                                  # off-image rows whose window reaches the image
    a[0][::4] = a[0][::4] * 1e4 - 2e6
    a[2][::4] = 3e6
    a[5][::5] = a[5][::5] * -1e3
    cases["far_away"] = a
    cases["N_1"] = base(1500, 1, 5)
    cases["M_1"] = base(1, 1500, 6)
    cases["N_750"] = base(4096, 750, 8)
    cases["M_0"] = [x[:0] for x in a[:5]] + a[5:]
    cases["N_0"] = a[:5] + [x[:0] for x in a[5:]]
    cases["M_33_N_100"] = base(33, 100, 9)
    return {k: tuple(top2_args(torch, *v[:9])) + tuple(v[9:]) for k, v in cases.items()}


def pairs_in_window(torch, args) -> int:
    uv_c, _, rad_c, lvl_c, val_c, uv_k, _, lvl_k, val_k = args[:9]
    slack = args[9] if len(args) > 9 else 1
    du = uv_c[:, None, 0] - uv_k[None, :, 0]
    dv = uv_c[:, None, 1] - uv_k[None, :, 1]
    ok = (du * du + dv * dv <= (rad_c * rad_c)[:, None]) & \
        ((lvl_c[:, None] - lvl_k[None, :]).abs() <= slack) & val_c[:, None] & val_k[None, :]
    return int(ok.sum())


def boxed_keypoints(torch, mk, args) -> int:
    """Keypoints in the cells of every row's box, summed over the rows: the
    pairs an ideal cell walk examines. From the plain versions of the grid
    and the boxes, on the card."""
    grid = mk.kp_grid_plain(args[5], *mk.GRID_CELLS)
    boxes, skip = mk.cand_boxes_plain(args[0], args[2], args[4], grid)
    counts = (grid.cell_start[1:] - grid.cell_start[:-1]).view(grid.gy, grid.gx).long()
    integ = torch.nn.functional.pad(counts.cumsum(0).cumsum(1), (1, 0, 1, 0))
    cx0, cx1, cy0, cy1 = boxes.long().unbind(1)
    n = integ[cy1 + 1, cx1 + 1] - integ[cy0, cx1 + 1] - integ[cy1 + 1, cx0] + integ[cy0, cx0]
    return int(torch.where(skip, 0, n).sum())


def top2_bound(torch, mk, args) -> dict:
    """Least time for the work these inputs need, two ways. `bound_ms`: a
    pair takes the window test (2 sub, 2 mul, 1 add, 1 compare in f32; sub,
    abs, compare, 2 and in int32) only if an ideal walk over the image cells
    examines it (its keypoint lies in a cell that the row's window box
    touches), and a pair inside the window the Hamming cost and the top-2
    update (8 xor + 8 popc + 7 add + 2 compare: int32).
    `bound_all_pairs_ms`: the same with the window test charged to every one
    of the M x N pairs. Bytes in both: each input read once (48 B per
    candidate row with 1 B validity, 45 B per keypoint), each output written
    once."""
    M, N = args[0].shape[0], args[5].shape[0]
    inside, boxed = pairs_in_window(torch, args), boxed_keypoints(torch, mk, args)
    nbytes = M * (8 + 32 + 4 + 4 + 1) + N * (8 + 32 + 4 + 1) + 3 * 4 * N + 4 * M
    t_bytes = nbytes / HBM_BYTES_PER_S

    def ops(tested):
        return max(6 * tested / F32_OPS_PER_S, (5 * tested + 25 * inside) / INT32_OPS_PER_S)

    return dict(pairs=M * N, pairs_in_window=inside, pairs_boxed=boxed, bytes=nbytes,
                int32_ops=5 * boxed + 25 * inside, f32_ops=6 * boxed,
                bound_ms=max(ops(boxed), t_bytes) * 1e3,
                bound_by="operations" if ops(boxed) >= t_bytes else "bytes",
                bound_all_pairs_ms=max(ops(M * N), t_bytes) * 1e3)


def compare_top2(torch, mk, args, paths=(None, "cells", "tiled")) -> tuple[int, dict]:
    """Kernel vs plain version on the same card inputs, with the kernel
    choosing its path and with each path forced; every output must be
    exactly equal (the costs are integers). Returns the max abs difference
    and what the choosing call did."""
    want = mk.match_top2_plain(*args)
    err, info = 0, None
    for path in paths:
        before = mk.match_top2.launches
        got = mk.match_top2(*args, path=path)
        torch.cuda.synchronize()
        if mk.match_top2.launches != before + 1:
            fail("match_top2 did not count its launch")
        call = mk.last_call()
        if path is None:
            info = call
            boxed = boxed_keypoints(torch, mk, args)
            if call["boxed_keypoints"] != boxed:
                fail(f"the kernel's boxes hold {call['boxed_keypoints']} keypoints, "
                     f"the plain version's {boxed}")
        elif call["path"] != path:
            fail(f"match_top2 took the {call['path']} path when {path} was forced")
        for name, g, w in zip(("best", "second", "arg", "best_cand"), got, want):
            if g.dtype != torch.int32 or g.shape != w.shape:
                fail(f"match_top2 {name}: {g.dtype} {tuple(g.shape)} vs {tuple(w.shape)}")
            d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            if d != 0:
                fail(f"match_top2 {name} ({path or 'chosen'} path) differs from the plain "
                     f"version by up to {d}")
            err = max(err, d)
    return err, info


def check_grid(torch, mk, kp_uv) -> None:
    """The grid kernel against kp_grid_plain: the same header and cell
    starts bit for bit, and the same keypoints in every cell (the kernel
    leaves the order inside a cell open)."""
    got, want = mk.kp_grid(kp_uv, *mk.GRID_CELLS), mk.kp_grid_plain(kp_uv, *mk.GRID_CELLS)
    torch.cuda.synchronize()
    N = kp_uv.shape[0]
    if not (torch.equal(got.hdr, want.hdr) and torch.equal(got.cell_start, want.cell_start)):
        fail(f"kp_grid header or cell starts differ: {got.hdr.tolist()} vs {want.hdr.tolist()}")
    cell = torch.searchsorted(got.cell_start[1:].long().contiguous(),
                              torch.arange(N, device=kp_uv.device), right=True)
    canon = got.kp_order.long()[torch.argsort(cell * max(N, 1) + got.kp_order.long())]
    if not torch.equal(canon, want.kp_order.long()):
        fail("kp_grid puts other keypoints into a cell than the plain version")
    if not torch.equal(got.sorted_uv.nan_to_num(), kp_uv[got.kp_order.long()].nan_to_num()):
        fail("kp_grid's sorted positions are not kp_uv[kp_order]")


def launch_call(torch, mk, args):
    """The C launch behind one wrapper call, to be repeated without the
    wrapper: (function, its arguments up to the device index, what to keep
    alive while it is repeated: the outputs and the keypoint grid)."""
    seen, real = [], mk._launch

    def spy(device, fn, *a):
        seen.append((fn, a))
        return real(device, fn, *a)

    mk._launch = spy
    try:
        keep = (mk.match_top2(*args), mk.match_top2.last, mk._grid_cache)
    finally:
        mk._launch = real
    fn, a = seen[-1]                             # a grid launch, if any, came first
    return fn, a, keep


def graph_ms(torch, fn, a, calls: int = 20) -> float:
    """Device time per call with no host in the way: `calls` launches
    captured into one CUDA graph and replayed."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(calls):
            if fn(*a, torch.cuda.current_device(), stream) != 0:
                fail("a launch failed under graph capture")
    return cuda_ms(torch, g.replay, reps=20) / calls


def time_top2(torch, mk, args, plain: bool = True) -> dict:
    """ms: through the wrapper, as a caller pays it, grid cached; first_call_ms:
    the same with the keypoint grid built anew every call; launch_ms: the C
    entry point alone (no wrapper); device_ms: the same replayed from a CUDA
    graph (no host); cells_ / tiled_device_ms: each path forced;
    no_match_device_ms: the two launches with the matching itself skipped
    (empty states, boxes, ticket, decode); grid_ms and
    grid_device_ms: the grid kernel alone, through its wrapper and from a
    graph."""
    def first_call():
        mk._grid_cache = None
        mk.match_top2(*args)

    lib, dev = mk._load_library(), torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    out = dict(ms=cuda_ms(torch, lambda: mk.match_top2(*args), reps=200),
               cuda_launches_per_call=mk.match_top2.last[1],
               first_call_ms=cuda_ms(torch, first_call, reps=200),
               cuda_launches_first_call=mk.match_top2.last[1],
               grid_ms=cuda_ms(torch, lambda: mk.kp_grid(args[5]), reps=200))
    fn, a, keep = launch_call(torch, mk, args)
    grid = keep[2][2]
    out.update(launch_ms=cuda_ms(torch, lambda: fn(*a, dev, stream), reps=200),
               device_ms=graph_ms(torch, fn, a),
               cells_device_ms=graph_ms(torch, fn, a[:-1] + (0,)),
               tiled_device_ms=graph_ms(torch, fn, a[:-1] + (1,)),
               no_match_device_ms=graph_ms(torch, fn, a[:-1] + (2,)),
               grid_device_ms=graph_ms(torch, lib.kp_grid_launch,
                                       (args[5].data_ptr(), args[5].shape[0], grid.gx, grid.gy,
                                        grid.hdr.data_ptr())))
    if plain:
        out["plain_ms"] = cuda_ms(torch, lambda: mk.match_top2_plain(*args), reps=10, windows=3)
    del keep
    return out


def launch_floor(torch, mk) -> dict:
    """An empty kernel through the same ctypes path, k per call: what k
    launches cost before any work, as the host issues them (launch_floor_ms)
    and replayed from a CUDA graph (launch_floor_device_ms)."""
    lib, dev = mk._load_library(), torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for k in (1, 2, 3):
        out[f"launch_floor_ms_{k}"] = cuda_ms(torch, lambda: lib.empty_launch(k, dev, stream),
                                              reps=200)
        out[f"launch_floor_device_ms_{k}"] = graph_ms(torch, lib.empty_launch, (k,))
    return out


class OldKernel:
    """An earlier version of the kernel, built from `source` (one entry point
    match_top2_launch taking the inputs, M, N, the slack, four outputs and the
    stream), behind the wrapper's signature."""

    def __init__(self, torch, mk, source: Path):
        self.torch = torch
        so = mk.BUILD_DIR / "libmatch_top2_ab.so"
        mk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([mk._nvcc(), *mk.NVCC_FLAGS, "-o", str(so), str(source)], check=True,
                       capture_output=True, text=True, timeout=600)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.fn = ctypes.CDLL(str(so)).match_top2_launch
        self.fn.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i, p, p, p, p, p]
        self.fn.restype = i

    def _launch_args(self, args):
        torch = self.torch
        ins, slack = args[:9], (args[9] if len(args) > 9 else 1)
        M, N, dev = ins[0].shape[0], ins[5].shape[0], ins[0].device
        outs = [torch.empty(n, dtype=torch.int32, device=dev) for n in (N, N, N, M)]
        return (*(t.data_ptr() for t in ins[:5]), M, *(t.data_ptr() for t in ins[5:]), N,
                int(slack), *(t.data_ptr() for t in outs)), tuple(outs)

    def __call__(self, *args, path=None):
        a, outs = self._launch_args(args)
        err = self.fn(*a, self.torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the old kernel's launch failed with CUDA error {err}")
        return outs

    def device_ms(self, args, calls: int = 20) -> float:
        """As graph_ms: the old kernel's launches replayed from a CUDA graph."""
        torch = self.torch
        a, outs = self._launch_args(args)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(calls):
                self.fn(*a, stream)
        ms = cuda_ms(torch, g.replay, reps=20) / calls
        del outs
        return ms


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

PTXAS: dict = {}               # source -> this build's ptxas lines (phase_build)


def ptxas_lines(report: str) -> list:
    """The lines of a `-Xptxas -v` report that name a kernel or give its
    registers, spills and stack."""
    return [ln.strip() for ln in report.splitlines()
            if "entry function" in ln or "Used" in ln or "spill" in ln]


def _demangled_last(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (_ZN<len><name>...:
    a kernel in an anonymous namespace), else the name as it is."""
    rest, last = mangled[3:] if mangled.startswith("_ZN") else "", mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        last, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    return last


def ptxas_kernels(lines) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack}} from
    ptxas_lines (each kernel's name as its source spells it)."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            name = _demangled_last(m.group(1))
            out[name] = {}
        elif name is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                m = re.search(pat, ln)
                if m:
                    out[name][key] = int(m.group(1))
    return out


def phase_build(mk) -> dict:
    """Every csrc/*.cu built by ops/cuda_build.py, one nvcc per source, all
    started together; then what ptxas reports for each (also in parallel)."""
    from gdslam_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    mk._load_library()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen([cuda_build.nvcc(n), *flags, "-Xptxas", "-v", "-cubin",
                                      "-o", os.path.join(tmp, f"{n}.cubin"),
                                      str(cuda_build.source(n))],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for n in cuda_build.SOURCES}
        ptxas = {}
        for n, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"build: ptxas report of {n} failed:\n{err}")
            ptxas[n] = ptxas_lines(err)
    PTXAS.update(ptxas)
    return dict(phase="build", library=str(libs["match_top2"].relative_to(ROOT)),
                libraries={n: str(v.relative_to(ROOT)) for n, v in libs.items()},
                seconds=build_s, nvcc_flags=list(cuda_build.NVCC_FLAGS),
                ptxas=ptxas,
                sass_mix=sass_mix(libs["categorical_draw"], "categorical_kernel"))


# ----------------------------------------------------------------------------
# categorical_draw: jax.random.categorical on the card
# ----------------------------------------------------------------------------

DRAW_SHAPES = ((900, 1500), (1800, 1500))   # rows x logits: the GD pose RANSAC's 300 x 3
DRAW_KEYS = 64                              # and relocalization's 300 x 6 over 1500 matches
DRAW_HOST_KEYS = 16                         # of them also held to the numpy replay
DRAW_REPLACES = "gdslam_tpu/backend/solvers.py:85"
DRAW_NO_LIBRARY = ("no PyTorch call computes it: torch.multinomial draws from torch's own "
                   "generator, not from jax.random's Threefry keys, so it computes another "
                   "function (timed beside as multinomial_ms, the call it replaces)")
# the function's own operations per element. Integer: the counter's 64-bit
# flat index (2), the key's first injection (2), 20 rounds of add, rotate
# and xor (60), five injections of two adds (10), the uniform's xor, shift
# and or (3): 77, on the INT32 lanes. The kernel's SASS (the build phase's
# sass_mix) holds more, none of it the function's: the key's fold once a
# thread, the loop's count and addresses, and the `noise` store that only
# the comparison asks for. Float: 244 float instructions
# of the SASS for five elements' two accurate logf each, 73 operations an
# element with an FFMA counted as two
DRAW_INT_OPS = 77
DRAW_F32_OPS = 73


def sass_mix(lib: Path, kernel: str) -> dict | None:
    """The opcodes of `kernel`'s SASS in the built library (cuobjdump),
    counted: {opcode: n}, the integer and float totals. None where the
    toolkit has no cuobjdump."""
    from gdslam_tpu_torch.ops import cuda_build
    exe = os.path.join(os.path.dirname(cuda_build.nvcc("sass")), "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    counts, inside = collections.Counter(), False
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and "/*" in ln and ";" in ln:
            op = ln.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = ln.split("*/", 1)[1].strip().split()[1]
            counts[op.split(".")[0]] += 1
    ints = sum(v for k, v in counts.items() if k in ("IADD3", "LOP3", "SHF", "IMAD", "ISETP",
                                                     "LEA", "SEL", "IMNMX", "PRMT", "IABS",
                                                     "VIADD"))
    floats = sum(v for k, v in counts.items() if k.startswith(("F", "MUFU")))
    return dict(opcodes=dict(counts.most_common(16)), integer=ints, float=floats,
                total=sum(counts.values()))


def draw_launch(torch, dkw, key, lg, rows, fold) -> tuple:
    """(C launch function, its arguments up to the device and stream, the
    tensors they point to) of one draw (the variant every call site runs,
    with no noise store), for a CUDA graph."""
    from gdslam_tpu_torch.ops import cuda_build
    lib = cuda_build.load("categorical_draw", dkw._declare)
    out = torch.empty(rows, dtype=torch.int64, device=lg.device)
    return lib.categorical_draw_launch, (lg.data_ptr(), lg.shape[0], rows,
                                         int(key[0]), int(key[1]), fold.data_ptr(),
                                         out.data_ptr(), None), (out,)


def draw_bound(rows: int, n: int) -> dict:
    """The least time the card could take for one draw of rows x n: the
    function's operations over the H100's INT32 and FP32 rates, or its
    bytes (the logits once, an index a row) over the memory's."""
    ops_int, ops_f32 = rows * n * DRAW_INT_OPS, rows * n * DRAW_F32_OPS
    t_ops = max(ops_int / INT32_OPS_PER_S, ops_f32 / F32_OPS_PER_S) * 1e3
    nbytes = n * 4 + rows * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                operations=dict(int32=ops_int, f32=ops_f32), bytes=nbytes)


def phase_draw(torch, dev, old=None) -> dict:
    """categorical_draw against its plain twin on the card, bitwise (the
    indices of both variants, and the Gumbel noise the writing variant and
    the twin write out), at DRAW_SHAPES on DRAW_KEYS keys of the GD fast
    path (fold_in(PRNGKey(7), k), folded on the card from a frame-id tensor,
    and the same key given as host words), over logits uniform on 0%, 7%,
    50% and 100% of the rows; the indices also against the numpy replay
    prng.categorical_rows (held to jax.random on the CPU) on DRAW_HOST_KEYS
    keys, each differing row reported with the replay's score margin (a
    near-tie under 1e-5 is an ulp of log, anything wider fails). At each
    shape: ms through the wrapper, on the device alone (the C launch from a
    CUDA graph), the plain twin's and the bound; at the GD shape
    torch.multinomial's (the call it replaces) through the host and from a
    graph and the numpy replay's host ms. With `old` (ParentKernels), the
    parent's kernel beside the new one at both shapes on the GD keys
    (ab_times)."""
    from gdslam_tpu_torch.core import prng
    from gdslam_tpu_torch.ops import draw_kernel as dkw
    from gdslam_tpu_torch.system.slam import GD_KEY
    shapes = []
    for rows, n in DRAW_SHAPES:
        idx_diff = noise_diff = 0
        near, far = [], []
        for k in range(DRAW_KEYS):
            g = torch.Generator().manual_seed(k)
            valid = (torch.rand(n, generator=g) < (0.0, 0.07, 0.5, 1.0)[k % 4]).to(dev)
            lg = dkw.uniform_logits(valid)
            fold = torch.full((1,), k, dtype=torch.int64, device=dev)
            key = prng.fold_in(GD_KEY, k)
            nk, npl = (torch.empty(rows, n, device=dev) for _ in range(2))
            a = dkw.categorical_draw(GD_KEY, lg, rows, fold, noise=nk)
            b = dkw.categorical_draw_plain(GD_KEY, lg, rows, fold, noise=npl)
            c = dkw.categorical_draw(key, lg, rows)
            torch.cuda.synchronize()
            idx_diff += int((a != b).sum() + (a != c).sum())
            noise_diff += int((nk.view(torch.int32) != npl.view(torch.int32)).sum())
            if k < DRAW_HOST_KEYS:
                h = prng.categorical_rows(key, lg, rows).to(dev)
                bad = torch.nonzero(a != h)[:, 0].tolist()
                if bad:
                    score = prng.gumbel(key, (rows, n)) + lg.cpu().numpy()[None]
                    for r in bad:
                        margin = float(score[r, int(h[r])] - score[r, int(a[r])])
                        (near if margin < 1e-5 else far).append(dict(key=k, row=r,
                                                                    margin=margin))
        shapes.append(dict(shape=[rows, n], keys=DRAW_KEYS, index_mismatches=idx_diff,
                           noise_bits_differing=noise_diff, host_keys=DRAW_HOST_KEYS,
                           host_near_ties=near, host_mismatches=far))
    fold = torch.full((1,), 7, dtype=torch.int64, device=dev)
    timings = []
    for rows, n in DRAW_SHAPES:
        lg = dkw.uniform_logits(torch.ones(n, dtype=torch.bool, device=dev))
        fn, cargs, keep = draw_launch(torch, dkw, GD_KEY, lg, rows, fold)
        t = dict(shape=[rows, n],
                 ms=cuda_ms(torch, lambda: dkw.categorical_draw(GD_KEY, lg, rows, fold),
                            reps=100),
                 device_ms=graph_ms(torch, fn, cargs),
                 plain_ms=cuda_ms(torch, lambda: dkw.categorical_draw_plain(GD_KEY, lg, rows,
                                                                            fold),
                                  reps=10, windows=3),
                 library_ms=None, library_note=DRAW_NO_LIBRARY, **draw_bound(rows, n),
                 launches_per_call=one_launch(torch, dkw.categorical_draw,
                                              lambda: dkw.categorical_draw(GD_KEY, lg, rows,
                                                                           fold)))
        del keep
        if old is not None:
            t["ab"] = draw_ab(torch, dkw, old, lg, rows, fold)
        timings.append(t)
    timing = timings[0]
    rows, n = DRAW_SHAPES[0]
    probs = torch.ones(n, device=dev)
    t0 = time.perf_counter()
    for _ in range(3):
        prng.gumbel(prng.fold_in(GD_KEY, 7), (rows, n))
    replay_ms = (time.perf_counter() - t0) * 1e3 / 3
    timing.update(
        multinomial_ms=cuda_ms(torch, lambda: torch.multinomial(probs, rows, replacement=True),
                               reps=100),
        multinomial_device_ms=graph_call_ms(
            torch, lambda: torch.multinomial(probs, rows, replacement=True)),
        numpy_replay_host_ms=replay_ms)
    res = dict(phase="draw", checks=shapes, timing=timing, timing_reloc=timings[1],
               card=nvidia_smi_line())
    emit(res)
    if any(c["index_mismatches"] or c["noise_bits_differing"] or c["host_mismatches"]
           for c in shapes) or not all(t["launches_per_call"]["ok"] for t in timings):
        fail(f"draw: categorical_draw differs from its plain twin or the replay, or a call "
             f"is not one launch: {shapes} {[t['launches_per_call'] for t in timings]}")
    return res


def draw_ab(torch, dkw, old, lg, rows, fold) -> dict:
    """The parent's draw kernel beside the new one on one call (ab_times),
    and the indices of both on DRAW_KEYS GD keys (folded from frame-id
    tensors) bitwise the plain twin's."""
    from gdslam_tpu_torch.system.slam import GD_KEY

    def old_launch():
        fn, a, keep = draw_launch(torch, dkw, GD_KEY, lg, rows, fold)
        return old.fns["categorical_draw"], old.old_args("categorical_draw", a), keep

    call = lambda: dkw.categorical_draw(GD_KEY, lg, rows, fold)
    res = ab_times(torch, old_launch, lambda: draw_launch(torch, dkw, GD_KEY, lg, rows, fold),
                   lambda: old.call(call), call,
                   dkw.categorical_draw_plain(GD_KEY, lg, rows, fold))
    diff = 0
    for k in range(DRAW_KEYS):
        fk = torch.full((1,), k, dtype=torch.int64, device=lg.device)
        want = dkw.categorical_draw_plain(GD_KEY, lg, rows, fk)
        got = (old.call(lambda: dkw.categorical_draw(GD_KEY, lg, rows, fk)),
               dkw.categorical_draw(GD_KEY, lg, rows, fk))
        diff += sum(int((g != want).sum()) for g in got)
    res["keys"], res["index_mismatches_old_and_new"] = DRAW_KEYS, diff
    if diff:
        fail(f"ab: a draw kernel differs from its plain twin on the GD keys: {diff}")
    return res


# ----------------------------------------------------------------------------
# the ORB front end: four kernels (csrc/orb_extract.cu) against their twins
# ----------------------------------------------------------------------------

TOP2_NO_LIBRARY = ("no single torch call: torch.cdist has no Hamming distance on packed "
                   "bytes (unpacked to 256 floats a descriptor it reads 32x the bytes and "
                   "rounds a float distance), and the best two with the lower index among "
                   "ties, their distances and the radius, level and validity gates are "
                   "torch.topk, gathers and masks on top")
ORB_KERNELS = ("orb_fast_cells", "orb_quota_select", "gaussian_blur7", "orb_describe")
ORB_REPLACES = {"orb_fast_cells": "gdslam_tpu/ops/fast.py:59",
                "orb_quota_select": "gdslam_tpu/frontend/extractor.py:118",
                "gaussian_blur7": "gdslam_tpu/ops/image.py:32",
                "orb_describe": "gdslam_tpu/ops/orb.py:100"}
ORB_REPLACES_NOTE = {
    "orb_fast_cells": "fast_strength and nms3x3 (fast.py:59, :98), the per-cell fallback and "
                      "_level_candidates (frontend/extractor.py:50, :97)",
    "orb_quota_select": "lax.top_k of each level and its zero padding (extractor.py:118-123)",
    "gaussian_blur7": "gaussian_blur(canvas, 7, 2.0) (extractor.py:91)",
    "orb_describe": "extract_patches x2, ic_angle_from_patches, the bins, brief_from_patches and "
                    "pack_bits (orb.py:63, :100, :140, :168)"}
ORB_NO_LIBRARY = {
    "orb_fast_cells": "no PyTorch call computes FAST-9/16 strength, a strict 3x3 NMS and a "
                      "per-cell top two",
    "orb_quota_select": "no single PyTorch call: torch.topk orders ties its own way, and the "
                        "stable sort, the padding and the gathers are calls of their own per "
                        "level",
    "orb_describe": "no PyTorch call computes an intensity-centroid angle or rBRIEF tests"}
# The functions' own operations, each one instruction on the FP32 pipes
# (F32_OPS_PER_S counts an FMA as two, so the instruction rate is half of it).
# FAST, per strength position (the cells and their 1-px halo, 3 px or more
# inside the level): the compass test (taps 0, 4, 8, 12: 4 differences, 6
# min / max, 2 comparisons) and the border select, 13; per cell pixel: two
# thresholds (4), two 3x3 NMS on shared row maxima (14), the fallback, the
# edge select and ~2 comparisons of the cell's top two, 22; and per sign
# that passes the compass test at a position (counted on this run's canvas;
# no other can exceed the thresholds): the 16 arcs' minima by doubling (64),
# their extreme (15), the centre's difference and the strength's select,
# 81. Without the compass test every level pixel takes both signs' arcs (the
# function-level count of the kernel's first design): 32 differences, 128 +
# 30 min / max, ~29 more: 219. The blur, per pixel it blurs (a level and
# its 3-px band; the rest is +0): 14 products and 12 sums. The descriptor,
# per keypoint: the 961 pixels of the disc's square weighted (x3: mask, x,
# y), 2 x 60 sums, the atan2 (~40) and 256 comparisons of 512 taps.
FAST_OPS_PER_POSITION = 13
FAST_OPS_PER_CELL_PIXEL = 22
FAST_ARC_OPS = 81
FAST_OPS_ALL_ARCS = 219
BLUR_OPS_PER_PIXEL = 26
DESC_OPS_PER_KEYPOINT = 3 * 961 + 120 + 40 + 256
F32_INSTR_PER_S = F32_OPS_PER_S / 2
ORB_ORDER = ("old", "new", "new", "old")
ORB_AB = ("gaussian_blur7", "orb_describe")     # timed beside the parent's (--ab-source)


def orb_launches() -> dict:
    from gdslam_tpu_torch.ops import orb_kernel
    return {w.__name__: w.launches for w in orb_kernel.WRAPPERS}


ORB_BY_PATH: dict = {}         # path -> {kernel: launches}, read where match_top2's are
POSE_BY_PATH: dict = {}        # path -> pose_gn's launches, the same way


def record_launches(label: str) -> dict:
    """The front end's and pose_gn's launches on path `label` (counted from
    its phase's reset_launch_counts); the front end's returned."""
    from gdslam_tpu_torch.ops import pose_kernel
    ORB_BY_PATH[label] = orb_launches()
    POSE_BY_PATH[label] = pose_kernel.pose_gn.launches
    return ORB_BY_PATH[label]


def c_launch(torch, fn) -> tuple:
    """The last C launch behind one wrapper call, to repeat without the
    wrapper: (function, its arguments up to the device, the call's result,
    kept alive while the launch is repeated)."""
    from gdslam_tpu_torch.ops import cuda_build
    seen, real = [], cuda_build.launch

    def spy(name, device, cfn, *a):
        seen.append((cfn, a))
        return real(name, device, cfn, *a)

    cuda_build.launch = spy
    try:
        keep = fn()
    finally:
        cuda_build.launch = real
    return seen[-1][0], seen[-1][1], keep


def aten_ops(torch, fn) -> int:
    """The non-view ATen operators one call of fn dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def extract_plain(torch, gray, orb, cam):
    """The parent's extract on any device: the pyramid, then the four plain
    twins (the parent's code but for the IC moments' order)."""
    from gdslam_tpu_torch.frontend.extractor import Features
    from gdslam_tpu_torch.ops import image, orb as orb_ops, orb_kernel as ok
    canvas, shapes = image.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                         orb.scale_factor)
    blurred = image.gaussian_blur(canvas, 7, 2.0)
    quotas = orb_ops.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor)
    cand = ok.fast_cells_plain(canvas, shapes, orb.ini_th_fast, orb.min_th_fast)
    resp, uv_lv, uv, level, valid = ok.quota_select_plain(*cand, shapes, quotas,
                                                          orb.scale_factor)
    angle, desc = ok.describe_plain(canvas, blurred, uv_lv, level)
    return Features(uv=uv, response=resp, angle=angle, level=level, desc=desc, valid=valid)


def differing(torch, got, want) -> int:
    """Elements of got not bitwise equal to want (floats compared as bits,
    so -0 against +0 and NaNs count)."""
    got, want = (torch.as_tensor(got), torch.as_tensor(want))
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return int((got != want).sum())


def orb_cases(torch, cfg, dev) -> list:
    """(label, gray [H, W] f32 on dev, OrbConfig, CameraConfig) of every
    case of ops/orb_cases.py: the defaults on a static and a GD dynamic
    frame, the stereo cell's left image, the 120x160 rig (padded rows) and
    the degenerate frames (flat, saturated, integer noise, a checkerboard)."""
    from gdslam_tpu_torch.ops import orb_cases as oc
    return [(name, *oc.orb_input(name, dev, cfg)) for name in oc.CASES]


def orb_compare(torch, gray, orb, cam) -> tuple[dict, dict]:
    """Each kernel against its twin on the same inputs (the kernels' chain:
    each twin gets what the kernel before it made), then extract against the
    twins' whole route; ({kernel: differing elements}, facts of the case)."""
    from gdslam_tpu_torch.frontend import extractor
    from gdslam_tpu_torch.ops import image, orb as orb_ops, orb_kernel as ok
    canvas, shapes = image.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                         orb.scale_factor)
    quotas = orb_ops.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor)
    blurred = ok.gaussian_blur7(canvas, shapes)
    cand = ok.orb_fast_cells(canvas, shapes, orb.ini_th_fast, orb.min_th_fast)
    sel = ok.orb_quota_select(*cand, shapes, quotas, orb.scale_factor)
    desc = ok.orb_describe(canvas, blurred, sel[1], sel[3])
    want = (image.gaussian_blur(canvas, 7, 2.0),
            ok.fast_cells_plain(canvas, shapes, orb.ini_th_fast, orb.min_th_fast),
            ok.quota_select_plain(*cand, shapes, quotas, orb.scale_factor),
            ok.describe_plain(canvas, blurred, sel[1], sel[3]))
    got = ((blurred,), cand, sel, desc)
    diffs = {name: sum(differing(torch, g, w) for g, w in
                       zip(gs, ws if isinstance(ws, tuple) else (ws,)))
             for name, gs, ws in zip(("gaussian_blur7", "orb_fast_cells", "orb_quota_select",
                                      "orb_describe"), got, want)}
    fk, fp = extractor.extract(gray, orb, cam.height, cam.width), extract_plain(torch, gray, orb,
                                                                              cam)
    diffs["extract"] = sum(differing(torch, getattr(fk, f), getattr(fp, f)) for f in fk._fields)
    torch.cuda.synchronize()
    n = ok.n_candidates(shapes)
    facts = dict(shape=[cam.height, cam.width], n_features=orb.n_features, levels=orb.n_levels,
                 candidates=sum(n), valid=int(fk.valid.sum()),
                 padded_rows=sum(max(k - c, 0) for k, c in zip(quotas, n)),
                 zero_response_rows=int((fk.response == 0).sum()))
    return diffs, facts


def angle_checks(torch, dev, gray, orb, cam) -> dict:
    """orb_describe's atan2f and bins on given values against torch.atan2 and
    angle_bins on the card (and the bins on the CPU): the frame's 1500
    moment pairs (its twin's), pairs on and near the axes, at (0, 0) with
    every sign of zero, and angles within 4 ulps of every bin edge."""
    from gdslam_tpu_torch.frontend import extractor
    from gdslam_tpu_torch.ops import image, orb as orb_ops, orb_cases as oc, orb_kernel as ok
    canvas, shapes = image.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                         orb.scale_factor)
    f = extractor.extract(gray, orb, cam.height, cam.width)
    quotas = orb_ops.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor)
    sel = ok.orb_quota_select(*ok.orb_fast_cells(canvas, shapes, orb.ini_th_fast,
                                                 orb.min_th_fast), shapes, quotas,
                              orb.scale_factor)
    m10, m01 = ok.ic_moments(orb_ops.extract_patches(canvas, sel[1], level=sel[3]))
    pairs = oc.axis_moment_pairs()
    a10 = torch.cat([m10, torch.from_numpy(pairs[:, 0]).to(dev)])
    a01 = torch.cat([m01, torch.from_numpy(pairs[:, 1]).to(dev)])
    edges = oc.bin_edge_angles(ok.RCP_BIN)
    ang_in = torch.from_numpy(np.resize(edges.reshape(-1), a10.shape[0])).to(dev)
    got_a, got_b = ok.angle_bins_on_card(a10, a01, ang_in)
    want_a, want_b = torch.atan2(a01, a10), ok.angle_bins(ang_in).to(torch.int32)
    cpu_b = ok.angle_bins(ang_in.cpu()).to(torch.int32)
    torch.cuda.synchronize()
    edge_bins = ok.angle_bins(torch.from_numpy(edges))
    return dict(frame_pairs=int(m10.shape[0]), extra_pairs=len(pairs),
                atan2_differing=differing(torch, got_a, want_a),
                frame_angles_differing=differing(torch, got_a[:m10.shape[0]], f.angle),
                edge_angles=edges.size,
                bins_differing=differing(torch, got_b, want_b),
                bins_differing_cpu=differing(torch, got_b.cpu(), cpu_b),
                edges_straddled=int((edge_bins[:, 0] != edge_bins[:, -1]).sum()))


def fast_compass_passes(torch, canvas, shapes, th: float) -> dict:
    """On each level, the strength positions a cell reads (its pixels and
    their 1-px halo, 3 px or more inside the level; fast_strength is 0
    nearer the edge), the cells' pixels, and the positions whose compass
    taps (0, 4, 8, 12 of the FAST circle) hold two neighbours both brighter
    than the centre by more than th (bright), or both darker (dark): the
    only signs whose strength can exceed th (every 9-arc holds two
    neighbouring compass taps). Summed over the levels."""
    n = dict(positions=0, cell_pixels=0, bright=0, dark=0)
    for lv, (h, w) in enumerate(shapes):
        ch, cw = h // 16 * 16, w // 16 * 16
        y1, x1 = min(ch + 1, h - 3), min(cw + 1, w - 3)
        n["cell_pixels"] += ch * cw
        if y1 <= 3 or x1 <= 3:
            continue
        img = canvas[lv, :h, :w]
        c = img[3:y1, 3:x1]
        taps = (img[0:y1 - 3, 3:x1], img[3:y1, 6:x1 + 3], img[6:y1 + 3, 3:x1],
                img[3:y1, 0:x1 - 3])
        b = [(t - c) > th for t in taps]
        d = [(c - t) > th for t in taps]
        n["positions"] += c.numel()
        n["bright"] += int(((b[0] | b[2]) & (b[1] | b[3])).sum())
        n["dark"] += int(((d[0] | d[2]) & (d[1] | d[3])).sum())
    return n


def orb_bound(torch, name, canvas, shapes, C, N, sel=None, desc_bins=None,
              th: float | None = None) -> dict:
    """The least time the card could take for one call: the larger of the
    function's bytes (each input read once, each output written once) over
    3.35 TB/s and its operations over the FP32 instruction rate. The
    descriptor reads the pixels its keypoints' discs and taps cover, counted
    from this call's keypoints; FAST takes a sign's arcs only where that
    sign's compass taps pass at th, counted on this call's canvas over the
    positions the cells read (beside it, the bound with both signs' arcs on
    every level pixel). The blur writes the whole canvas, reads each level's
    own pixels and blurs its live region, the level and its 3-px band (beside
    it, the bound with every plane read and blurred)."""
    from gdslam_tpu_torch.ops import orb as orb_ops, orb_kernel as ok
    L, H, W = canvas.shape
    area = sum(h * w for h, w in shapes)
    extra = {}
    if name == "orb_fast_cells":
        n = fast_compass_passes(torch, canvas, shapes, th)
        nbytes = 4 * area + 12 * C
        ops = FAST_OPS_PER_POSITION * n["positions"] + \
            FAST_OPS_PER_CELL_PIXEL * n["cell_pixels"] + FAST_ARC_OPS * (n["bright"] + n["dark"])
        extra = dict(compass=n, level_pixels=area,
                     bound_all_arcs_ms=max(nbytes / HBM_BYTES_PER_S,
                                           FAST_OPS_ALL_ARCS * area / F32_INSTR_PER_S) * 1e3)
    elif name == "orb_quota_select":
        counts = [c for c in ok.n_candidates(shapes) if c > 1]
        nbytes = 12 * C + N * (4 + 8 + 8 + 4 + 1)
        ops = sum(c * int(np.ceil(np.log2(c))) for c in counts)   # a comparison sort's
    elif name == "gaussian_blur7":
        # the whole output written and, each plane +0 past its level, only the
        # level's own pixels read (its 3-px band is +0 and needs no read) and
        # the live outputs (h + 3, w + 3) blurred; beside it, every plane read
        # and blurred (the count before the kernel took the shapes)
        live = sum(min(H, h + 3) * min(W, w + 3) for h, w in shapes)
        nbytes, ops = 4 * area + 4 * L * H * W, BLUR_OPS_PER_PIXEL * live
        extra = dict(level_pixels=area, live_pixels=live, canvas_pixels=L * H * W,
                     bound_all_planes_ms=max(8 * L * H * W / HBM_BYTES_PER_S,
                                             BLUR_OPS_PER_PIXEL * L * H * W / F32_INSTR_PER_S)
                     * 1e3)
    else:
        dev = canvas.device
        u = torch.round(sel[1][:, 0]).long()
        v = torch.round(sel[1][:, 1]).long()
        lv = sel[3].long()
        ys, xs = np.mgrid[-15:16, -15:16]
        disc = torch.from_numpy(np.stack([ys[ys ** 2 + xs ** 2 <= 225],
                                          xs[ys ** 2 + xs ** 2 <= 225]])).to(dev)
        taps = orb_ops._tables_on(dev)[3][desc_bins]                   # [N, 512]
        tap_dy, tap_dx = taps // 37 - 18, taps % 37 - 18

        def covered(dy, dx):
            r, c = v[:, None] + dy, u[:, None] + dx
            ok_ = (r >= 0) & (r < H) & (c >= 0) & (c < W)
            idx = (lv[:, None] * H + r.clamp(0, H - 1)) * W + c.clamp(0, W - 1)
            return int(torch.unique(idx[ok_]).numel())

        touched = covered(disc[0][None], disc[1][None]) + covered(tap_dy, tap_dx)
        nbytes, ops = 4 * touched + N * (12 + 4 + 32), DESC_OPS_PER_KEYPOINT * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_INSTR_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, operations=ops, **extra)


def host_us(torch, fn, reps: int = 200, windows: int = 5) -> float:
    """Median over `windows` of host microseconds per call over `reps`
    calls; nothing waits for the card inside a window."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def quota_wrapper_host(torch, scores, cand_uv, shapes, quotas, scale) -> dict:
    """Where orb_quota_select's host time goes: host us per call of the
    whole wrapper and of its parts replayed alone, as the wrapper runs them:
    the argument checks, the ctypes level tables (heights, widths, quotas,
    scales), the five output tensors, and the C launch with its arguments
    ready (ctypes' conversion of 14 arguments, the stream's lookup, the
    kernel's launch)."""
    from gdslam_tpu_torch.ops import cuda_build, orb_kernel as ok
    name, dev = "orb_quota_select", scores.device
    C, N = scores.shape[0], sum(quotas)
    fn, a, keep = c_launch(torch, lambda: ok.orb_quota_select(scores, cand_uv, shapes, quotas,
                                                              scale))

    def checks():
        counts = ok.n_candidates(shapes)
        for n, k in zip(counts, quotas):
            if k > 0 and n == 0:
                raise ValueError(name)
        ok._device(name, scores)
        cuda_build.check(name, "scores", scores, torch.float32, (sum(counts),), dev)
        cuda_build.check(name, "cand_uv", cand_uv, torch.float32, (C, 2), dev)
        if not 1 <= len(shapes) <= ok.MAX_LEVELS or len(quotas) != len(shapes) or \
                min(quotas) < 0:
            raise ValueError(name)
        cuda_build.load(ok.LIB, ok._declare)

    def tables():
        return (ok._ints([h for h, _ in shapes]), ok._ints([w for _, w in shapes]),
                ok._ints(list(quotas)), ok._floats(ok.level_scales(len(shapes), scale)))

    def outputs():
        return (torch.empty(N, dtype=torch.float32, device=dev),
                torch.empty(N, 2, dtype=torch.float32, device=dev),
                torch.empty(N, 2, dtype=torch.float32, device=dev),
                torch.empty(N, dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.bool, device=dev))

    out = dict(wrapper=host_us(torch, lambda: ok.orb_quota_select(scores, cand_uv, shapes,
                                                                  quotas, scale)),
               checks=host_us(torch, checks), tables=host_us(torch, tables),
               outputs=host_us(torch, outputs),
               launch=host_us(torch, lambda: cuda_build.launch(name, dev, fn, *a)))
    del keep
    out["rest"] = out["wrapper"] - sum(v for k, v in out.items() if k != "wrapper")
    return out


def orb_timing(torch, gray, orb, cam, old=None) -> tuple[dict, dict]:
    """Each kernel at the case's shapes: ms through its wrapper, on the
    device alone (its C launch replayed from a CUDA graph), its twin's ms, its
    bound, and for the blur one F.conv2d with the kernel's 7x7 outer product
    (not bitwise; TF32 off) as library_ms; the quota wrapper's host time by
    its parts (quota_wrapper_host). With `old` (ParentKernels
    holding an earlier orb_extract.cu), the parent's gaussian_blur7 and
    orb_describe (ORB_AB) beside the new ones on the same calls (ab_times). Then
    extract on the same frame, the twins' route (extract before the
    kernels) and the kernels' in the order old, new, new, old: ms through
    the host, device ms from a graph, ATen operators and device kernels per
    call."""
    from gdslam_tpu_torch.frontend import extractor
    from gdslam_tpu_torch.ops import image, orb as orb_ops, orb_kernel as ok
    F = torch.nn.functional
    canvas, shapes = image.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                         orb.scale_factor)
    quotas = orb_ops.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor)
    blurred = ok.gaussian_blur7(canvas, shapes)
    cand = ok.orb_fast_cells(canvas, shapes, orb.ini_th_fast, orb.min_th_fast)
    sel = ok.orb_quota_select(*cand, shapes, quotas, orb.scale_factor)
    angle = ok.orb_describe(canvas, blurred, sel[1], sel[3])[0]
    C, N = cand[0].shape[0], sel[0].shape[0]
    calls = {
        "gaussian_blur7": (lambda: ok.gaussian_blur7(canvas, shapes),
                           lambda: image.gaussian_blur(canvas, 7, 2.0)),
        "orb_fast_cells": (lambda: ok.orb_fast_cells(canvas, shapes, orb.ini_th_fast,
                                                     orb.min_th_fast),
                           lambda: ok.fast_cells_plain(canvas, shapes, orb.ini_th_fast,
                                                       orb.min_th_fast)),
        "orb_quota_select": (lambda: ok.orb_quota_select(*cand, shapes, quotas,
                                                         orb.scale_factor),
                             lambda: ok.quota_select_plain(*cand, shapes, quotas,
                                                           orb.scale_factor)),
        "orb_describe": (lambda: ok.orb_describe(canvas, blurred, sel[1], sel[3]),
                         lambda: ok.describe_plain(canvas, blurred, sel[1], sel[3]))}
    out = {}
    for name, (kern, plain) in calls.items():
        fn, a, keep = c_launch(torch, kern)
        t = dict(shape=list(canvas.shape), candidates=C, keypoints=N,
                 ms=cuda_ms(torch, kern, reps=100), device_ms=graph_ms(torch, fn, a),
                 plain_ms=cuda_ms(torch, plain, reps=5, windows=3),
                 launches_per_call=one_launch(torch, getattr(ok, name), kern),
                 **orb_bound(torch, name, canvas, shapes, C, N, sel,
                             ok.angle_bins(angle) if name == "orb_describe" else None,
                             th=min(orb.ini_th_fast, orb.min_th_fast)))
        del keep
        if old is not None and name in ORB_AB:
            t["ab"] = ab_times(torch, lambda: c_launch(torch, lambda: old.call(kern)),
                               lambda: c_launch(torch, kern), lambda: old.call(kern), kern,
                               plain())
        if name == "gaussian_blur7":
            k1 = torch.tensor(ok.BLUR_TAPS, device=canvas.device)
            k2 = (k1[:, None] * k1[None, :])[None, None]
            padded = F.pad(canvas[:, None], (3, 3, 3, 3), mode="reflect")
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                conv = lambda: F.conv2d(padded, k2)             # noqa: E731
                t["library_ms"] = cuda_ms(torch, conv, reps=50)
                t["library_device_ms"] = graph_call_ms(torch, conv)
                t["library_max_abs_err"] = float((conv()[:, 0] - blurred).abs().max())
            t["library_note"] = "one F.conv2d with the 7x7 outer product of the taps on the " \
                                "reflect-padded canvas (the pad not timed), TF32 off; not bitwise"
        else:
            t["library_ms"], t["library_note"] = None, ORB_NO_LIBRARY[name]
        if name == "orb_quota_select":
            t["host_us"] = quota_wrapper_host(torch, *cand, shapes, quotas, orb.scale_factor)
        out[name] = t
    routes = dict(old=lambda: extract_plain(torch, gray, orb, cam),
                  new=lambda: extractor.extract(gray, orb, cam.height, cam.width))
    ms = [cuda_ms(torch, routes[r], reps=10, windows=3) for r in ORB_ORDER]
    wall = [wall_ms(torch, routes[r]) for r in ORB_ORDER]
    ext = dict(order=list(ORB_ORDER), ms=ms, wall_ms=wall)
    for r, fn in routes.items():
        ext[f"{r}_device_ms"] = graph_call_ms(torch, fn)
        ext[f"{r}_aten_ops"] = aten_ops(torch, fn)
        try:
            ext[f"{r}_device_kernels"] = graph_kernels(torch, fn)
        except RuntimeError as e:            # a route that cannot be captured
            ext[f"{r}_device_kernels"] = f"not captured: {str(e)[:120]}"
    ext["new_sync_sites"] = sync_sites(torch, routes["new"])
    return out, ext


def quota_edges(torch, dev) -> dict:
    """orb_quota_select against its twin on the card on ops/orb_cases.py's
    quota edges (ties, zeros of both signs, padded rows, 3542 and 32768
    candidates a level, quotas of n and 0): differing elements a case."""
    from gdslam_tpu_torch.ops import orb_cases as oc, orb_kernel as ok
    out = {}
    for name in oc.QUOTA_CASES:
        scores, uv, shapes, quotas, scale = oc.quota_input(name)
        a = (scores.to(dev), uv.to(dev), shapes, quotas, scale)
        out[name] = sum(differing(torch, g, w) for g, w in
                        zip(ok.orb_quota_select(*a), ok.quota_select_plain(*a)))
    torch.cuda.synchronize()
    return out


def blur_describe_edges(torch, dev) -> dict:
    """gaussian_blur7 and orb_describe against their twins on the card on
    ops/orb_cases.py's edges (BLUR_CASES: one level, H or W = 4, untiled
    sides, 1 x 1 levels, levels spanning the canvas, bands at its edge, the
    stereo and rig canvases; DESCRIBE_CASES: patches leaving the canvas on
    each side, every level, every bin, 0, 1, 3 and 1501 keypoints):
    differing elements a case (the blur's also against the twin on the
    CPU)."""
    from gdslam_tpu_torch.ops import image, orb_cases as oc, orb_kernel as ok
    blur, desc = {}, {}
    for name in oc.BLUR_CASES:
        canvas, shapes = oc.blur_input(name)
        got = ok.gaussian_blur7(canvas.to(dev), shapes)
        blur[name] = differing(torch, got, image.gaussian_blur(canvas.to(dev), 7, 2.0)) + \
            differing(torch, got.cpu(), image.gaussian_blur(canvas, 7, 2.0))
    for name in oc.DESCRIBE_CASES:
        a = [t.to(dev) for t in oc.describe_input(name)]
        got = ok.orb_describe(*a)
        want = ok.describe_plain(*a) if a[2].shape[0] else (
            torch.empty(0, device=dev), torch.empty(0, 32, dtype=torch.uint8, device=dev))
        desc[name] = sum(differing(torch, g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    return dict(blur=blur, describe=desc)


def phase_orb(torch, cfg, dev, old=None) -> dict:
    """The ORB front end's four kernels bitwise against their plain twins on
    every case of orb_cases, the quota, the blur and the descriptor on their
    edge cases, extract against the twins' whole route, the atan2 and bin
    checks, then each kernel timed and bounded at the defaults (with `old`,
    ParentKernels, the parent's blur and descriptor kernels beside the new
    ones, and both builds' ptxas for them) and extract's ms, device ms,
    operators and kernels, the twins' route (extract before the kernels)
    beside the kernels'. Fails on any differing bit, a degenerate frame with
    a valid row, a call that is not one launch, more than 40 operators or a
    wait for the card in extract."""
    cases, bad = {}, []
    inputs = orb_cases(torch, cfg, dev)
    for label, gray, orb, cam in inputs:
        diffs, facts = orb_compare(torch, gray, orb, cam)
        cases[label] = dict(differing=diffs, **facts)
        if any(diffs.values()):
            bad.append(label)
    edges = quota_edges(torch, dev)
    bad += [f"quota:{k}" for k, v in edges.items() if v]
    bd_edges = blur_describe_edges(torch, dev)
    bad += [f"{kind}:{k}" for kind, d in bd_edges.items() for k, v in d.items() if v]
    angles = angle_checks(torch, dev, *inputs[0][1:])
    timing, ext = orb_timing(torch, *inputs[0][1:], old=old)
    res = dict(phase="orb", cases=cases, quota_edges=edges, blur_describe_edges=bd_edges,
               angles=angles, kernels=timing, extract=ext, card=nvidia_smi_line())
    if old is not None:
        mine = ptxas_kernels(PTXAS.get("orb_extract", []))
        theirs = ptxas_kernels(old.ptxas.get("orb_extract", []))
        res["ptxas_ab"] = {k: dict(old=theirs.get(k), new=mine.get(k))
                           for k in ("blur7_kernel", "describe_kernel")}
        res["ptxas_old"] = old.ptxas
    emit(res)
    if bad:
        fail(f"orb: a kernel differs from its plain twin on {bad}")
    if any(cases[c]["valid"] for c in ("flat", "saturated")) or \
            cases["rig"]["padded_rows"] < 1:
        fail("orb: a flat or saturated frame kept a keypoint, or the rig padded no row")
    if angles["atan2_differing"] or angles["bins_differing"] or \
            angles["bins_differing_cpu"] or angles["frame_angles_differing"] or \
            angles["edges_straddled"] != 30:
        fail(f"orb: atan2 or the bins differ: {angles}")
    if not all(t["launches_per_call"]["ok"] for t in timing.values()):
        fail("orb: a wrapper call is not one launch")
    if ext["new_aten_ops"] > 40 or ext["new_sync_sites"]:
        fail(f"orb: extract dispatches {ext['new_aten_ops']} operators or waits for the card "
             f"at {ext['new_sync_sites']}")
    return res


def phase_kernel(torch, mk, frames, dev, old=None) -> tuple[dict, int]:
    cases = {
        "random_1500x1500": random_args(torch, 1500, 1500, 1, dev),
        "random_4096x1500": random_args(torch, 4096, 1500, 2, dev),
        "frames_1500x1500": frame_args(torch, frames[:1], frames[1], 1500, 15.0),
        "frames_4096x1500": frame_args(torch, frames[::2], frames[1], 4096, 12.0),
        **special_cases(torch, dev),
    }
    timed = ("random_1500x1500", "random_4096x1500", "frames_1500x1500", "frames_4096x1500",
             "dense_1500x1500", "radius_100_1500x1500", "radius_150_1500x1500",
             "radius_mixed_4096x1500", "N_750")
    out, err = {}, 0
    for name, args in cases.items():
        check_grid(torch, mk, args[5])
        e, info = compare_top2(torch, mk, args)
        err = max(err, e)
        out[name] = dict(M=args[0].shape[0], N=args[5].shape[0], exact=True, path=info["path"],
                         pairs_boxed=info["boxed_keypoints"],
                         keypoints_with_candidate=int((mk.match_top2(*args)[2] >= 0).sum()))
        if name in timed:
            out[name].update(time_top2(torch, mk, args), **top2_bound(torch, mk, args))
            if old is not None:
                out[name].update(old_ms=cuda_ms(torch, lambda: old(*args), reps=200),
                                 old_device_ms=old.device_ms(args))
    bad = None
    try:
        mk.match_top2(*(x[:1].expand(mk.MAX_ROWS, *x.shape[1:]) if i < 5 else x
                        for i, x in enumerate(cases["N_1"])))
    except ValueError as e:
        bad = str(e)
    if bad is None or "rows" not in bad:
        fail("match_top2 took 2^20 candidate rows")
    return dict(phase="kernel", name="match_top2", max_abs_err=err, cases=out,
                **launch_floor(torch, mk)), err


def ate_pair(torch, synthetic, metrics, traj, frames_T_wc) -> dict:
    """ATE RMSE two ways: (a) estimated camera positions against the
    renderer's, both relative to frame 0 (tests/test_tracking_e2e.py), and
    (b) as bench.py's _plain_ate computes it, against the translation of
    the inverted ground-truth pose; (b) is the metric of the recorded
    reference number for this configuration."""
    est = np.stack([T for _, T in traj])[:, :3, 3]
    T0inv = np.linalg.inv(frames_T_wc[0])
    idx = [round(ts * 30.0) for ts, _ in traj]
    gt_a = np.stack([(T0inv @ frames_T_wc[i])[:3, 3] for i in idx])
    gt_b = np.stack([np.linalg.inv(synthetic.gt_pose(i, device="cpu").numpy())[:3, 3]
                     for i in idx])
    return dict(ate_m=metrics.ate_rmse(est, gt_a), ate_bench_m=metrics.ate_rmse(est, gt_b))


class MapCounters:
    """Counts what the keyframe program did while it is installed: points
    made by triangulation, Replace merges, BA outlier observations. The
    counts stay on the device until `read`."""

    def __init__(self, mapping, ba):
        self.mods = ((mapping, "create_new_map_points", self._triangulated),
                     (mapping, "replace_points", self._merged),
                     (ba, "run_local_ba", self._outliers))
        self.real, self.counts = {}, dict(triangulated=[], merged=[], ba_outliers=[])

    def _triangulated(self, real, arena, *a, **k):
        out = real(arena, *a, **k)
        self.counts["triangulated"].append(out.n_pt - arena.n_pt)
        return out

    def _merged(self, real, arena, src, dst, do):
        self.counts["merged"].append(do.sum())
        return real(arena, src, dst, do)

    def _outliers(self, real, *a, **k):
        out = real(*a, **k)
        self.counts["ba_outliers"].append(out[1])
        return out

    def __enter__(self):
        for mod, name, fn in self.mods:
            self.real[name] = getattr(mod, name)
            setattr(mod, name, lambda *a, _f=fn, _r=self.real[name], **k: _f(_r, *a, **k))
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.mods:
            setattr(mod, name, self.real[name])

    def read(self) -> dict:
        out = {k: int(sum(int(x) for x in v)) for k, v in self.counts.items()}
        out["local_ba_runs"] = len(self.counts["ba_outliers"])
        return out


def sync_sites(torch, fn, top: int | None = 12) -> dict:
    """Where fn waits for the card, by torch's sync debug mode: {file:line:
    count} of every implicit synchronisation (.tolist(), .cpu(), int() of a
    device scalar, an upload of a host value), the `top` most frequent
    (all of them for None)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message) and "prototype" not in str(w.message)).most_common(top))


def reset_launch_counts(mk) -> None:
    from gdslam_tpu_torch.ops import draw_kernel, orb_kernel, pose_kernel
    mk.match_top2.launches = mk.match_top2.cuda_launches = mk.kp_grid.launches = 0
    draw_kernel.categorical_draw.launches = 0
    orb_kernel.reset_launch_counts()
    pose_kernel.pose_gn.launches = 0


def draw_launches() -> int:
    from gdslam_tpu_torch.ops import draw_kernel
    return draw_kernel.categorical_draw.launches


def phase_slice(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev,
                keyframes, label="slice", pipeline=False, plain=False, kmax=256,
                modules=None, check_launches=True):
    """Every frame through the user's entry point, System.track_rgbd, with
    the kernel's launch counts set to 0 just before and read just after.
    plain: local BA and triangulation off (the configuration of the earlier
    slices, kept as the base of --ab-source). A pipelined run is timed as a
    whole, since a synchronise after every frame would undo it. Host
    synchronisations are the warnings of torch's sync debug mode (every
    implicit wait for the card: .tolist(), .cpu(), int() of a device scalar)."""
    n = len(frames)
    slam = System(cfg, kmax=kmax, pmax=65536, pipeline=pipeline, device=dev)
    tr = slam.tracker
    if not (tr.use_local_ba and tr.use_triangulation and tr.commit_every == 3):
        fail("the tracker's defaults are not local BA and triangulation on, commit_every 3")
    if plain:
        tr.use_local_ba = tr.use_triangulation = False
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(mk)
    times, states, poses = [], [], []
    counters = MapCounters(*modules) if modules else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if counters:
                counters.__enter__()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            for i, fr in enumerate(frames):
                if i == WARMUP_FRAMES:
                    torch.cuda.synchronize()
                    t_steady = time.perf_counter()
                t0 = time.perf_counter()
                poses.append(slam.track_rgbd(fr.gray, fr.depth, None, i / 30.0))
                if not pipeline:
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                states.append(slam.tracking_state)
            slam.shutdown()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            if counters:
                counters.__exit__()
    sync_sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message))
    syncs = sum(sync_sites.values())
    full_arena = [str(w.message) for w in caught if "arena is full" in str(w.message)]
    for i, T in enumerate(poses):
        T = np.asarray(T.cpu() if hasattr(T, "cpu") else T)
        if T.shape != (4, 4) or not np.isfinite(T).all():
            fail(f"frame {i}: pose is not a finite 4x4")
    launches, cuda_launches = mk.match_top2.launches, mk.match_top2.cuda_launches
    record_launches(label)
    grids = mk.kp_grid.launches
    traj = tr.camera_trajectory()
    ates = ate_pair(torch, synthetic, metrics, traj, [f.T_wc.cpu().numpy() for f in frames])
    steady = sorted(times[WARMUP_FRAMES:])
    res = dict(phase=label, frames=n, width=cfg.camera.width, height=cfg.camera.height,
               n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels, kmax=kmax, pmax=65536,
               pipeline=pipeline, local_ba=tr.use_local_ba, triangulation=tr.use_triangulation,
               all_ok=all(s == TrackState.OK for s in states),
               trajectory_len=len(traj), keyframes=slam.keyframe_count,
               keyframe_slots_used=tr.n_kf_host,
               keyframe_frames=[round(t * 30.0) for t in tr.kf_timestamps],
               map_points=slam.map_point_count, map_point_slots_used=int(tr.arena.n_pt),
               match_top2_launches=launches,
               match_top2_cuda_launches=cuda_launches, kp_grid_launches=grids,
               tracked_frames=n - 1, host_syncs=syncs, host_syncs_per_frame=syncs / n,
               host_sync_sites=dict(sync_sites.most_common(12)),
               frame_ms_mean=(t_end - t_steady) * 1e3 / (n - WARMUP_FRAMES),
               run_s=t_end - t_start, arena_full_warnings=full_arena,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, **ates)
    if not pipeline:      # per-frame times mean something only with a synchronise each
        res.update(frame_ms_median=statistics.median(steady),
                   frame_ms_p90=steady[int(0.9 * (len(steady) - 1))],
                   frame_ms_max=steady[-1], first_frame_ms=times[0], second_frame_ms=times[1])
    if counters:
        res.update(counters.read())
    emit(res)
    if not res["all_ok"]:
        fail(f"tracking states {[s.name for s in states]}")
    if len(traj) != n:
        fail(f"trajectory has {len(traj)} poses, expected {n}")
    if not (ates["ate_m"] <= ATE_GUARD_M and ates["ate_bench_m"] <= ATE_GUARD_M):
        fail(f"ATE {ates} above {ATE_GUARD_M} m")
    if not keyframes[0] <= res["keyframes"] <= keyframes[1]:
        fail(f"{res['keyframes']} keyframes, expected {keyframes[0]}-{keyframes[1]}")
    if not check_launches:        # an earlier kernel's wrapper counts nothing
        return slam, res
    if launches < 2 * (n - 1):
        fail(f"match_top2 launched {launches} times for {n - 1} tracked frames")
    # one grid per tracked frame, shared by its matcher calls; per keyframe
    # one more for its own keypoints, which fuse_into_keyframe searches, and,
    # when it is inserted frames later (pipelined), one for fuse_associate
    if not (n - 1 <= grids <= n - 1 + 2 * res["keyframe_slots_used"]
            and cuda_launches == 2 * launches + grids):
        fail(f"{grids} keypoint grids and {cuda_launches} CUDA launches for {launches} "
             f"calls on {n - 1} tracked frames")
    return slam, res


def phase_slice_ab(torch, mk, matcher, old, slice_args):
    """The configuration of the earlier slices (local BA and triangulation
    off), on the new kernel and on the old one: the outputs of both kernels
    are exact, so the trajectory, keyframes and map points must be equal."""
    cfg, frames, *rest = slice_args
    args = (cfg, frames[:AB_FRAMES], *rest[:-1], (1, 5))
    new_slam, new_res = phase_slice(torch, mk, *args, label="slice_plain", plain=True)
    real = matcher.match_top2
    matcher.match_top2 = old
    try:
        old_slam, old_res = phase_slice(torch, mk, *args, label="slice_plain_old_kernel",
                                        plain=True, check_launches=False)
    finally:
        matcher.match_top2 = real
    t_new = np.stack([T for _, T in new_slam.tracker.camera_trajectory()])
    t_old = np.stack([T for _, T in old_slam.tracker.camera_trajectory()])
    same = dict(trajectory=bool(np.array_equal(t_new, t_old)),
                keyframes=new_res["keyframes"] == old_res["keyframes"],
                map_points=new_res["map_points"] == old_res["map_points"])
    emit(dict(phase="slice_ab", same=same, old_frame_ms_median=old_res["frame_ms_median"],
              new_frame_ms_median=new_res["frame_ms_median"]))
    if not all(same.values()):
        fail(f"the slice differs between the old and the new kernel: {same}")


def pose_error(T_cw: np.ndarray, T_wc_gt: np.ndarray, T_wc_0: np.ndarray):
    """Translation (m) and rotation (degrees) between an estimated T_cw and
    the renderer's pose, both relative to frame 0."""
    gt = np.linalg.inv(T_wc_gt) @ T_wc_0
    cos = (np.trace(T_cw[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    return (float(np.linalg.norm(T_cw[:3, 3] - gt[:3, 3])),
            float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))


def fork_tracker(tr):
    """A tracker that goes on from `tr`'s state without touching it (the
    tensors are never written in place; the host lists are copied)."""
    t2 = copy.copy(tr)
    t2.records, t2.kf_timestamps, t2._pending = list(tr.records), list(tr.kf_timestamps), []
    return t2


def phase_reloc(torch, mk, slam, frames, n_done, cfg, TrackState, solvers, tracking):
    """A forced loss at full width: the last pose 1 m off and no velocity,
    so the next frame fails both motion-model searches and _relocalize must
    find the pose among the recent keyframes on that same frame."""
    tr = fork_tracker(slam.tracker)
    T_bad = tr.last.T_cw.clone()
    T_bad[0, 3] += 1.0
    tr.last = tr.last._replace(T_cw=T_bad)
    tr.velocity = None
    fr = frames[n_done]
    n_kf = tr.n_kf_host
    calls = []
    real = tr._relocalize
    tr._relocalize = lambda frame: calls.append(frame) or real(frame)
    reset_launch_counts(mk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T = tr.process(fr.gray, fr.depth, torch.ones_like(fr.gray), n_done / 30.0)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches, draws = mk.match_top2.launches, draw_launches()
    record_launches("reloc")
    err_m, err_deg = pose_error(np.asarray(T), fr.T_wc.cpu().numpy(),
                                frames[0].T_wc.cpu().numpy())
    res = dict(phase="reloc", relocalized=len(calls), state=tr.state.name,
               n_inliers=tr.n_inliers, err_m=err_m, err_deg=err_deg, frame_ms=frame_ms,
               keyframes=tr.n_kf_host, match_top2_launches=launches,
               categorical_draw_launches=draws)
    if not (len(calls) == 1 and tr.state == TrackState.OK and tr.n_kf_host >= n_kf):
        emit(res)
        fail("the forced loss did not end in a relocalization")

    # _relocalize alone on the same lost state, and ransac_pnp alone on its
    # best candidate's matches (the most recent keyframe)
    lost = fork_tracker(slam.tracker)
    lost.last, lost.velocity = lost.last._replace(T_cw=T_bad), None
    frame, arena = calls[0], lost.arena

    def reloc_once():
        lost.arena = arena
        return tracking.Tracking._relocalize(lost, frame)

    res["relocalize_ms"] = wall_ms(torch, reloc_once, reps=5, warmup=1)
    kf = lost.n_kf_host - 1
    m_idx, _ = tracking._dense_ratio_matches(frame, arena.kf_uv[kf], arena.kf_desc[kf],
                                             arena.kf_level[kf], arena.kf_kp_valid[kf],
                                             cfg.orb.n_levels)
    pt = arena.kf_obs[kf][m_idx.clamp(min=0).long()]
    has_pt = (m_idx >= 0) & (pt >= 0) & arena.pt_valid[pt.clamp(min=0).long()]
    pw = arena.pt_pos[pt.clamp(min=0).long()]
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    key = tracking.prng.prng_key(lost.frame_id)        # relocalization's key
    pnp = lambda: solvers.ransac_pnp(pw, frame.uv, has_pt, K, px_threshold=5.991 ** 0.5,  # noqa: E731
                                     key=key)
    q = tracking.cam_ops.backproject(frame.uv, frame.depth, cam)
    rigid = lambda: solvers.ransac_rigid(pw, q, has_pt & (frame.depth > 0), K, frame.uv,  # noqa: E731
                                         px_threshold=5.991 ** 0.5 * 2, key=key)
    res.update(ransac_pnp_ms=wall_ms(torch, pnp, reps=5, warmup=1),
               ransac_rigid_ms=wall_ms(torch, rigid, reps=5, warmup=1),
               matches=int(has_pt.sum()), pnp_inliers=int(pnp().n_inliers),
               rigid_inliers=int(rigid().n_inliers))
    svd12 = torch.randn(300, 12, 12, device=pw.device)
    res["svd_300x12x12_ms"] = wall_ms(torch, lambda: torch.linalg.svd(svd12), reps=5, warmup=1)
    emit(res)
    if not (err_m <= RELOC_GUARD[0] and err_deg <= RELOC_GUARD[1]
            and tr.n_inliers >= RELOC_GUARD[2]):
        fail(f"relocalized pose off by {err_m} m, {err_deg} degrees with {tr.n_inliers} inliers")
    if launches < 6 or draws < 1:
        fail(f"relocalization launched match_top2 {launches} times and drew {draws} times")
    return res, pnp, rigid


def phase_compact(torch, mk, slice_args, more_frames, kmax):
    """A keyframe arena of `kmax` slots, one more than the slice's keyframes,
    saturates on the slice (the last slot is never filled): the tracker must
    warn once that culling frees too little, create no further keyframe and
    go on tracking. Then keyframe 1 is invalidated by hand (a culled
    keyframe) and a requested compaction must recycle the slot, remap the
    host's references and leave a tracker that tracks `more_frames` on."""
    cfg, frames, System, TrackState, *_ = slice_args
    slam, res = phase_slice(torch, mk, *slice_args[:-1], (kmax - 1, kmax - 1),
                            label="compact_saturated", kmax=kmax)
    tr = slam.tracker
    if not (tr.kf_arena_full_warned and len(res["arena_full_warnings"]) == 1
            and tr.n_kf_host == kmax - 1):
        fail(f"a saturated keyframe arena did not warn once: {res['arena_full_warnings']}")
    n_before, ref_before = tr.n_kf_host, tr.ref_kf
    valid = tr.arena.kf_valid.clone()
    valid[1] = False
    tr.arena = tr.arena._replace(kf_valid=valid)
    tr.compact_min_gain, tr._compact_requested = 1, True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._maybe_compact()
    torch.cuda.synchronize()
    compact_ms = (time.perf_counter() - t0) * 1e3
    out = dict(phase="compact", kmax=kmax, keyframes_before=n_before,
               keyframes_after=tr.n_kf_host, arena_n_kf=int(tr.arena.n_kf),
               ref_kf_before=ref_before, ref_kf_after=tr.ref_kf, compact_ms=compact_ms,
               valid_after=tr.arena.kf_valid.tolist())
    ok = (tr.n_kf_host == n_before - 1 == int(tr.arena.n_kf) and tr.ref_kf == ref_before - 1
          and out["valid_after"] == [True] * (n_before - 1) + [False] * (kmax - n_before + 1)
          and max(r[1] for r in tr.records) < tr.n_kf_host)
    for i, fr in enumerate(more_frames):      # the freed slot may take a keyframe again
        slam.track_rgbd(fr.gray, fr.depth, None, (len(frames) + i) / 30.0)
    out.update(state=tr.state.name, keyframes_end=tr.n_kf_host)
    ok = ok and tr.state == TrackState.OK and tr.n_kf_host < kmax \
        and len(tr.camera_trajectory()) == len(frames) + len(more_frames)
    emit(out)
    if not ok:
        fail("compaction did not recycle the invalidated keyframe's slot")
    return slam


def gd_inputs(frames, cam) -> list:
    """The CLI's contract, as bench.py::bench_gd feeds it: host uint8 gray
    (the rendered colour through the BT.601 weights) and uint16 raw depth."""
    w3 = np.array([0.299, 0.587, 0.114], np.float32)
    dmf = cam.depth_map_factor
    return [((fr.rgb.cpu().numpy().astype(np.uint8).astype(np.float32) @ w3).astype(np.uint8),
             (fr.depth.cpu().numpy() * dmf).astype(np.uint16)) for fr in frames]


def mask_quality(masks, frames, idxs) -> tuple[float, float]:
    """(recall, IoU) of the flagged-dynamic region against the renderer's
    dyn_mask, averaged over the frames (bench.py::_mask_quality's rule)."""
    recalls, ious = [], []
    for m, k in zip(masks, idxs):
        dyn_est = m.cpu().numpy() < 0.5
        dyn_gt = frames[k].dyn_mask.cpu().numpy()
        if dyn_gt.sum() == 0:
            continue
        inter = float((dyn_est & dyn_gt).sum())
        union = float((dyn_est | dyn_gt).sum())
        recalls.append(inter / dyn_gt.sum())
        ious.append(inter / union if union else 1.0)
    return (float(np.mean(recalls)) if recalls else 0.0,
            float(np.mean(ious)) if ious else 0.0)


class GdCounters:
    """While installed: match_top2 calls by call site (the GD match, the
    relocalization match, and the matcher's callers by name), the GD frames
    that took the packed fast path, and the GD pose RANSAC's inlier counts
    (device scalars, read once at the end)."""

    def __init__(self, matcher, tracking, geomask, solvers, slam_mod, by_caller=False):
        self.by_caller = by_caller      # the motion model's calls named by their caller
        self.sites = collections.Counter()
        self.inliers, self.packed = [], 0
        self.mods = ((matcher, "match_top2", self._top2_matcher),
                     (tracking, "match_top2", self._top2_named("relocalization_dense")),
                     (geomask, "match_top2", self._top2_named("gd_cur_x_ref")),
                     (solvers, "ransac_rigid", self._ransac),
                     (slam_mod, "unpack_gd_frame", self._unpack))
        self.real = {}

    def _top2_matcher(self, real, *a, **k):
        site = sys._getframe(3).f_code.co_name                # match_candidates' caller
        if self.by_caller and site == "track_motion_model":
            site += "<" + sys._getframe(4).f_code.co_name
        self.sites[site] += 1
        return real(*a, **k)

    def _top2_named(self, site):
        def count(real, *a, **k):
            self.sites[site] += 1
            return real(*a, **k)
        return count

    def _ransac(self, real, *a, **k):
        res = real(*a, **k)
        if sys._getframe(2).f_code.co_name == "_match_pose":      # gd_step_core's pose
            self.inliers.append(res.n_inliers)
        return res

    def _unpack(self, real, *a, **k):
        self.packed += 1
        return real(*a, **k)

    def __enter__(self):
        for mod, name, fn in self.mods:
            self.real[(mod, name)] = getattr(mod, name)
            setattr(mod, name, lambda *a, _f=fn, _r=self.real[(mod, name)], **k: _f(_r, *a, **k))
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.mods:
            setattr(mod, name, self.real[(mod, name)])

    def pose_ok_share(self, torch, min_matches: int) -> float | None:
        """The share of GD frames whose pose RANSAC found min_matches
        inliers (the rest keep the semantic mask); one read."""
        if not self.inliers:
            return None
        return float(np.mean(np.asarray(torch.stack(self.inliers).tolist()) >= min_matches))


def gd_guards(res: dict, n: int, traj_len: int) -> None:
    """Every frame OK and in the trajectory; ATE and the mask guards."""
    if not res["all_ok"]:
        fail(f"{res['phase']}: a frame was not tracked OK")
    if traj_len != n:
        fail(f"{res['phase']}: trajectory has {traj_len} poses, expected {n}")
    if not (res["ate_m"] <= GD_ATE_GUARD_M and res["ate_bench_m"] <= GD_ATE_GUARD_M):
        fail(f"{res['phase']}: ATE {res['ate_m']}, {res['ate_bench_m']} above {GD_ATE_GUARD_M} m")
    if not (res["mask_recall"] >= GD_MASK_GUARD[0] and res["mask_iou"] >= GD_MASK_GUARD[1]):
        fail(f"{res['phase']}: mask recall {res['mask_recall']}, IoU {res['mask_iou']} below "
             f"{GD_MASK_GUARD}")


def phase_gd_slice(torch, mk, cfg, frames, raw, System, TrackState, synthetic, metrics, dev,
                   counters_args):
    """The main path, System.track_rgbd_gd, as bench.py::bench_gd runs it:
    pipelined with commit_every 10 on the dynamic scene, fed the CLI's uint8
    gray + uint16 depth, so warm frames take the packed fast path. Warm-up
    until 10 keyframes, three timed windows of GD_WINDOW frames each ended by
    a flush and a synchronise (the frame time is their median), then GD_TAIL
    frames whose masks are read for the quality guards. The kernel's counts
    are set to 0 just before the run and read just after; host
    synchronisations are counted over the timed windows."""
    slam = System(cfg, kmax=256, pmax=65536, pipeline=True, device=dev)
    tr = slam.tracker
    tr.commit_every = GD_COMMIT_EVERY
    states, windows, masks = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(mk)
    counters = GdCounters(*counters_args)

    def frame(k):
        out = slam.track_rgbd_gd(*raw[k], None, k / 30.0)
        states.append(slam.tracking_state)
        return out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with counters:
                k = 0
                while k < GD_FRAMES - 40 and slam.keyframe_count < GD_WARMUP_KEYFRAMES:
                    frame(k)
                    k += 1
                warm = k
                tr.flush()
                torch.cuda.synchronize()
                before = len(caught)
                for _ in range(3):
                    start, stop = k, min(k + GD_WINDOW, GD_FRAMES - GD_TAIL)
                    t0 = time.perf_counter()
                    for k in range(start, stop):
                        frame(k)
                    tr.flush()
                    torch.cuda.synchronize()
                    windows.append((time.perf_counter() - t0) * 1e3 / (stop - start))
                    k = stop
                timed = [w for w in caught[before:] if "synchroniz" in str(w.message)]
                tail = range(k, k + GD_TAIL)
                for k in tail:
                    masks.append(frame(k)[1])
                slam.shutdown()
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = tail[-1] + 1
    launches, grids, draws = mk.match_top2.launches, mk.kp_grid.launches, draw_launches()
    record_launches("gd_slice")
    traj = tr.camera_trajectory()
    recall, iou = mask_quality(masks, frames, tail)
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in timed)
    n_timed = n - GD_TAIL - warm
    res = dict(phase="gd_slice", frames=n, warmup_frames=warm, timed_frames=n_timed,
               quality_frames=[tail[0], tail[-1]], width=cfg.camera.width,
               height=cfg.camera.height, n_features=cfg.orb.n_features, kmax=256, pmax=65536,
               pipeline=True, commit_every=GD_COMMIT_EVERY, dynamic_scene=True,
               input="uint8 gray + uint16 depth",
               all_ok=all(s == TrackState.OK for s in states)
               and not any(r[3] for r in tr.records),
               frame_ms_windows=windows, frame_ms=statistics.median(windows),
               fps=1e3 / statistics.median(windows),
               host_syncs_timed=len(timed), host_syncs_per_frame=len(timed) / n_timed,
               host_sync_sites=dict(sites.most_common(12)),
               packed_fast_path_frames=counters.packed,
               pose_ransac_ok_share=counters.pose_ok_share(torch, cfg.geomask.min_matches),
               match_top2_launches=launches, match_top2_by_site=dict(counters.sites),
               kp_grid_launches=grids, categorical_draw_launches=draws,
               keyframes=slam.keyframe_count,
               keyframe_slots_used=tr.n_kf_host, map_points=slam.map_point_count,
               mask_recall=recall, mask_iou=iou,
               jax_tpu_quality_reference=GD_JAX_QUALITY,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    gd_guards(res, n, len(traj))
    if counters.packed != n - cfg.geomask.inter_frame_size:
        fail(f"gd_slice: {counters.packed} frames took the packed fast path, expected "
             f"{n - cfg.geomask.inter_frame_size}")
    if counters.sites["gd_cur_x_ref"] != counters.packed or launches < 3 * counters.packed:
        fail(f"gd_slice: match_top2 launches {launches}, by site {dict(counters.sites)}")
    if draws < counters.packed:
        fail(f"gd_slice: {draws} draws on the card for {counters.packed} fast-path frames")
    return slam, res, n


def phase_gd_staged(torch, mk, cfg, frames, raw, System, TrackState, synthetic, metrics, dev,
                    counters_args):
    """GD_STAGED_FRAMES frames through track_rgbd_gd without pipelining: every
    frame takes the staged path (the ring's get_mask, then the tracker's
    common body), timed one by one; the quality guards on the frames after
    the first ten."""
    n = GD_STAGED_FRAMES
    slam = System(cfg, kmax=256, pmax=65536, pipeline=False, device=dev)
    reset_launch_counts(mk)
    counters = GdCounters(*counters_args)
    times, states, masks = [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with counters:
                for k in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, m = slam.track_rgbd_gd(*raw[k], None, k / 30.0)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    states.append(slam.tracking_state)
                    masks.append(m)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    syncs = sum(sites.values())
    traj = slam.tracker.camera_trajectory()
    recall, iou = mask_quality(masks[10:], frames, range(10, n))
    steady = sorted(times[10:])
    record_launches("gd_staged")
    res = dict(phase="gd_staged", frames=n, pipeline=False, dynamic_scene=True,
               all_ok=all(s == TrackState.OK for s in states),
               frame_ms_median=statistics.median(steady), frame_ms_max=steady[-1],
               first_frame_ms=times[0], host_syncs=syncs, host_syncs_per_frame=syncs / n,
               host_sync_sites=dict(sites.most_common(12)),
               packed_fast_path_frames=counters.packed,
               pose_ransac_ok_share=counters.pose_ok_share(torch, cfg.geomask.min_matches),
               match_top2_launches=mk.match_top2.launches,
               match_top2_by_site=dict(counters.sites), categorical_draw_launches=draw_launches(),
               keyframes=slam.keyframe_count,
               mask_recall=recall, mask_iou=iou, quality_frames=n - 10,
               jax_tpu_quality_reference=GD_JAX_QUALITY, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    gd_guards(res, n, len(traj))
    if counters.packed != 0 or counters.sites["gd_cur_x_ref"] != n - cfg.geomask.inter_frame_size:
        fail(f"gd_staged: the staged path was not taken ({counters.packed} packed frames, "
             f"{dict(counters.sites)})")
    if res["categorical_draw_launches"] < n - cfg.geomask.inter_frame_size:
        fail(f"gd_staged: {res['categorical_draw_launches']} draws on the card for "
             f"{n - cfg.geomask.inter_frame_size} masked frames")
    return res


def stage_numbers(torch, fn, reps: int = 10) -> dict:
    """One stage: ms through the host (each call ended by a synchronise),
    device busy ms and device operations per call (torch.profiler)."""
    ms = wall_ms(torch, fn, reps=reps)
    prof = profile_window(torch, fn, 1)
    return dict(ms=ms, device_busy_ms=prof["device_busy_ms"], device_ops=prof["device_ops"],
                top_device_ms=prof["top_device_ms"])


def phase_gd_stages(torch, mk, slam, raw_next, cfg, modules) -> tuple[dict, dict]:
    """The GD program's parts on the GD slice's final ring and the next
    frame, uploaded as the fast path uploads it: gd_step whole (extraction
    included) and gd_step_core, farneback_flow, mahalanobis_mask,
    depth_edges (once; the mask program runs it on both frames), the
    cur x ref match and ransac_rigid as the path calls them (1500 rows, the
    top 100 matches valid). Also the cur x ref match as a call site of the
    kernel: exact against the plain version with each path forced, timed
    against its bound. gd_step must not wait for the card."""
    extractor, geomask, flow_ops, edge_ops, slam_mod, solvers, cam_ops = modules
    cam, dev = cfg.camera, slam.device
    geo = slam._geo
    ref_gray, ref_depth, ref_feats = geo.ref_for_next()
    packed = slam_mod.PackedUpload(cam.height, cam.width, dev)(*raw_next)
    gray, depth = slam_mod.unpack_gd_frame(packed, cam.height, cam.width,
                                           1.0 / cam.depth_map_factor)
    sem = torch.ones_like(gray)
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    s = geomask.res_factor(cfg)
    finest = {1: 0, 2: 1, 4: 2}[s]
    key = slam_mod.GD_KEY                   # the fast path's key, folded with a device frame id
    fold = torch.full((1,), slam.tracker.frame_id, dtype=torch.int64, device=dev)
    K = (cam.fx, cam.fy, cam.cx, cam.cy)

    # the pose RANSAC's inputs as gd_step_core builds them
    zA = geomask._kp_depth(depth, feats.uv, cam)
    zB = geomask._kp_depth(ref_depth, ref_feats.uv, cam)
    good, idx, best = geomask.ratio_matches(feats, ref_feats, cfg.orb.n_levels)
    good = geomask.top_matches(good & (zA > 0) & (zB[idx] > 0), best,
                               cfg.geomask.pnp_top_matches)
    P = cam_ops.backproject(feats.uv, zA, cam)
    Q = cam_ops.backproject(ref_feats.uv[idx], zB[idx], cam)
    uv_q = ref_feats.uv[idx]
    res = solvers.ransac_rigid(P, Q, good, K, uv_q, n_iters=300, min_inliers=20,
                               px_threshold=4.0, key=key, fold=fold)
    flow = flow_ops.farneback_flow(gray, ref_gray, levels=5, finest_level=finest,
                                   upsample=s == 1)
    cam_h = dataclasses.replace(cam, fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s,
                                cy=cam.cy / s, width=-(-cam.width // s),
                                height=-(-cam.height // s))

    def gd_step():
        return geomask.gd_step(gray, depth, sem, ref_gray, ref_depth, ref_feats, cfg, key, fold)

    sites = sync_sites(torch, gd_step)
    if sites:
        fail(f"gd_step synchronises with the card at {sites}")
    stages = {
        "gd_step": stage_numbers(torch, gd_step),
        "gd_step_core": stage_numbers(torch, lambda: geomask.gd_step_core(
            feats, gray, depth, sem, ref_gray, ref_depth, ref_feats, cfg, key, fold)),
        "farneback_flow": stage_numbers(torch, lambda: flow_ops.farneback_flow(
            gray, ref_gray, levels=5, finest_level=finest, upsample=s == 1)),
        "mahalanobis_mask": stage_numbers(torch, lambda: geomask.mahalanobis_mask(
            depth, ref_depth, flow, res.T, sem, cfg, False, ref_gray=gray, cur_gray=ref_gray,
            flow_factor=s)),
        "depth_edges": stage_numbers(torch, lambda: edge_ops.depth_edges(depth[::s, ::s], cam_h)),
        "cur_x_ref_match": stage_numbers(torch, lambda: geomask.ratio_matches(
            feats, ref_feats, cfg.orb.n_levels)),
        "ransac_rigid": stage_numbers(torch, lambda: solvers.ransac_rigid(
            P, Q, good, K, uv_q, n_iters=300, min_inliers=20, px_threshold=4.0, key=key,
            fold=fold)),
    }
    args = record_top2_calls(geomask, lambda: geomask.ratio_matches(
        feats, ref_feats, cfg.orb.n_levels))[0]
    err, info = compare_top2(torch, mk, args)
    call = dict(role="gd_cur_x_ref", M=args[0].shape[0], N=args[5].shape[0], max_abs_err=err,
                path=info["path"], **time_top2(torch, mk, args), **top2_bound(torch, mk, args))
    if call["path"] != "tiled":
        fail("the GD match did not take the kernel's tiled path")
    out = dict(phase="gd_stages", card=nvidia_smi_line(), grid=[cam_h.height, cam_h.width],
               ransac_rows=int(good.numel()), ransac_valid=int(good.sum()),
               ransac_inliers=int(res.n_inliers), ms={k: v["ms"] for k, v in stages.items()},
               stages=stages, match_top2_gd_call=call)
    return out, call


def record_top2_calls(module, fn) -> list:
    """The argument lists of `module`'s match_top2 calls while fn runs."""
    calls, real = [], module.match_top2

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    module.match_top2 = record
    try:
        fn()
    finally:
        module.match_top2 = real
    return calls


# ----------------------------------------------------------------------------
# the DynaSLAM geometry path, inpainting and the CLIs
# ----------------------------------------------------------------------------

def hole_fill(torch, depth_in, rgb_in, rgb_out, depth_out, mask_out) -> tuple:
    """(the JAX test's rule, the inpainted share) over the hole, the pixels
    the refined mask removed (tests/test_geometry_path.py: a hole pixel
    counts as filled where the input had no depth or the output has some);
    the inpainted share is the hole's pixels whose output came from the DB.
    None where the mask removed nothing."""
    hole = mask_out < 0.5
    if not bool(hole.any()):
        return None, None
    rule = ((depth_in[hole] == 0) | (depth_out[hole] > 0)).float().mean().item()
    changed = (depth_out != depth_in) | (rgb_out != rgb_in).any(-1)
    return rule, changed[hole].float().mean().item()


def phase_geom_slice(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev,
                     counters_args):
    """bench.py::bench_geometry's protocol on the port: System.track_rgbd(
    use_geometry=True), pipelined with commit_every 6, mask None, fed the
    dynamic scene's gray and depth on the card as bench feeds them. Warm-up
    until 8 keyframes, a timed window of GEOM_WINDOW frames ended by a flush
    and a synchronise, then GEOM_TAIL frames whose refined masks are scored
    (bench's frames: the masks' quality depends on where the sphere is, and
    the JAX package's numbers were taken on these), then two more timed
    windows; the frame time is the median of the three (bench times one).
    The kernel's counts are set to 0 just before the run and read just
    after; host synchronisations are counted over the timed windows."""
    slam = System(cfg, kmax=256, pmax=65536, pipeline=True, device=dev)
    tr = slam.tracker
    tr.commit_every = GEOM_COMMIT_EVERY
    states, windows, masks = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(mk)
    counters = GdCounters(*counters_args, by_caller=True)

    def frame(k):
        slam.track_rgbd(frames[k].gray, frames[k].depth, None, k / 30.0, use_geometry=True)
        states.append(slam.tracking_state)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with counters:
                k = 0
                last_warm = len(frames) - 3 * GEOM_WINDOW - GEOM_TAIL - GEOM_PROFILE_FRAMES - 1
                while k < last_warm and slam.keyframe_count < GEOM_WARMUP_KEYFRAMES:
                    frame(k)
                    k += 1
                warm = k
                tr.flush()
                torch.cuda.synchronize()
                timed = []
                for w in range(3):
                    start, stop = k, k + GEOM_WINDOW
                    before = len(caught)
                    t0 = time.perf_counter()
                    for k in range(start, stop):
                        frame(k)
                    tr.flush()
                    torch.cuda.synchronize()
                    windows.append((time.perf_counter() - t0) * 1e3 / (stop - start))
                    timed += [x for x in caught[before:] if "synchroniz" in str(x.message)]
                    k = stop
                    if w == 0:      # bench_geometry's quality frames follow its one window
                        tail = range(k, k + GEOM_TAIL)
                        for k in tail:
                            frame(k)
                            masks.append(slam._last_refined_mask)
                        tr.flush()
                        torch.cuda.synchronize()
                        k = tail[-1] + 1
                slam.shutdown()
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = k
    traj = tr.camera_trajectory()
    recall, iou = mask_quality(masks, frames, tail)
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in timed)
    n_timed = 3 * GEOM_WINDOW
    record_launches("geom_slice")
    res = dict(phase="geom_slice", frames=n, warmup_frames=warm, timed_frames=n_timed,
               quality_frames=[tail[0], tail[-1]], width=cfg.camera.width,
               height=cfg.camera.height, n_features=cfg.orb.n_features, kmax=256, pmax=65536,
               pipeline=True, commit_every=GEOM_COMMIT_EVERY, dynamic_scene=True,
               input="gray + depth on the card", semantic_mask=None,
               all_ok=all(s == TrackState.OK for s in states)
               and not any(r[3] for r in tr.records),
               frame_ms_windows=windows, frame_ms=statistics.median(windows),
               fps=1e3 / statistics.median(windows),
               host_syncs_timed=len(timed), host_syncs_per_frame=len(timed) / n_timed,
               host_sync_sites=dict(sites.most_common(12)),
               match_top2_launches=mk.match_top2.launches,
               match_top2_by_site=dict(counters.sites), kp_grid_launches=mk.kp_grid.launches,
               keyframes=slam.keyframe_count, keyframe_slots_used=tr.n_kf_host,
               db_inserts=slam._geometry.inserted, db_valid=int(slam._geometry.db.valid.sum()),
               map_points=slam.map_point_count, mask_recall=recall, mask_iou=iou,
               jax_tpu_quality_reference=GEOM_JAX_QUALITY,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    gd_guards(res, n, len(traj))
    if not 1 <= res["db_inserts"] <= res["keyframe_slots_used"]:
        fail(f"geom_slice: {res['db_inserts']} DB inserts for {res['keyframe_slots_used']} "
             "keyframes")
    if res["host_syncs_per_frame"] > 1.0 / GEOM_COMMIT_EVERY + 0.05:
        fail(f"geom_slice: {res['host_syncs_per_frame']} host synchronisations per frame at "
             f"{res['host_sync_sites']}; the flush alone is 1/{GEOM_COMMIT_EVERY}")
    if counters.sites["track_motion_model<light_track_dispatched"] < 2 * n_timed:
        fail(f"geom_slice: LightTrack did not run on every frame: {dict(counters.sites)}")
    return slam, res, n


def phase_geom_staged(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev):
    """GEOM_STAGED_FRAMES frames through System.track_rgbd_geom without
    pipelining (RGB in; inpainted RGB and depth and the refined mask out),
    each timed with a synchronise. Guard: on every frame where the mask
    removed pixels and the DB held a view, the JAX test's hole rule holds
    for more than half of the hole."""
    n = GEOM_STAGED_FRAMES
    slam = System(cfg, kmax=256, pmax=65536, pipeline=False, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(mk)
    times, states, rules, shares = [], [], [], []
    for k in range(n):
        fr = frames[k]
        had_view = slam._geometry is not None and slam._geometry.inserted > 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, rgb_o, d_o, m_o = slam.track_rgbd_geom(fr.rgb, fr.depth, None, k / 30.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(slam.tracking_state)
        rule, share = hole_fill(torch, fr.depth, fr.rgb, rgb_o, d_o, m_o)
        if had_view and rule is not None:
            rules.append(rule)
            shares.append(share)
    traj = slam.tracker.camera_trajectory()
    steady = sorted(times[5:])
    record_launches("geom_staged")
    res = dict(phase="geom_staged", frames=n, pipeline=False, dynamic_scene=True,
               input="rgb + depth on the card",
               all_ok=all(s == TrackState.OK for s in states),
               frame_ms_median=statistics.median(steady), frame_ms_max=steady[-1],
               first_frame_ms=times[0], match_top2_launches=mk.match_top2.launches,
               keyframes=slam.keyframe_count, db_inserts=slam._geometry.inserted,
               frames_with_hole_and_view=len(rules),
               hole_rule_min=min(rules) if rules else None,
               inpainted_share_of_hole_mean=float(np.mean(shares)) if shares else None,
               inpainted_share_of_hole_min=min(shares) if shares else None,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    if not res["all_ok"] or len(traj) != n:
        fail("geom_staged: a frame was not tracked OK")
    if not rules or min(rules) <= 0.5:
        fail(f"geom_staged: the hole rule {rules} (needs > 0.5 on every frame with a hole)")
    fr = frames[n - 1]
    res["inpaint_inputs"] = (slam._geometry, fr.rgb, fr.depth, m_o, slam._pose_tensor(T))
    return res


def phase_gd_inpaint(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev):
    """GD_INPAINT_FRAMES frames through System.track_rgbd_gd(inpaint=True) as
    the CLI's output-directory mode runs it: pipelined (commit_every 3), host
    uint8 RGB + uint16 depth, mask None; each frame's outputs read back (the
    CLI writes them). The same hole guard as geom_staged, and the DB inserts
    (the JAX package's rule, ROADMAP.md section 3) beside the keyframes."""
    n = GD_INPAINT_FRAMES
    dmf = cfg.camera.depth_map_factor
    raw = [(fr.rgb.cpu().numpy().astype(np.uint8),
            (fr.depth.cpu().numpy() * dmf).astype(np.uint16)) for fr in frames[:n]]
    slam = System(cfg, kmax=256, pmax=65536, pipeline=True, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(mk)
    times, rules, shares = [], [], []
    for k, (rgb, d16) in enumerate(raw):
        had_view = slam._geometry is not None and slam._geometry.inserted > 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m_o, rgb_o, d_o = slam.track_rgbd_gd(rgb, d16, None, k / 30.0, inpaint=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        depth_in = torch.from_numpy(d16.astype(np.int32)).to(dev).float() * (1.0 / dmf)
        rule, share = hole_fill(torch, depth_in, torch.from_numpy(rgb).to(dev).float(),
                                rgb_o, d_o, m_o)
        if had_view and rule is not None:
            rules.append(rule)
            shares.append(share)
    slam.shutdown()
    traj = slam.tracker.camera_trajectory()
    steady = sorted(times[5:])
    record_launches("gd_inpaint")
    res = dict(phase="gd_inpaint", frames=n, pipeline=True, commit_every=3,
               input="uint8 rgb + uint16 depth from the host", semantic_mask=None,
               all_ok=slam.tracking_state == TrackState.OK
               and not any(r[3] for r in slam.tracker.records),
               frame_ms_median=statistics.median(steady), frame_ms_max=steady[-1],
               first_frame_ms=times[0], match_top2_launches=mk.match_top2.launches,
               keyframes=slam.keyframe_count,
               keyframe_frames=[round(t * 30.0) for t in slam.tracker.kf_timestamps],
               db_inserts=slam._geometry.inserted, frames_with_hole_and_view=len(rules),
               hole_rule_min=min(rules) if rules else None,
               inpainted_share_of_hole_mean=float(np.mean(shares)) if shares else None,
               inpainted_share_of_hole_min=min(shares) if shares else None,
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    if not res["all_ok"] or len(traj) != n:
        fail("gd_inpaint: a frame was not tracked OK")
    if not rules or min(rules) <= 0.5:
        fail(f"gd_inpaint: the hole rule {rules} (needs > 0.5 on every frame with a hole)")
    return res


def phase_geom_stages(torch, slam, frame, more_frames, t_first, cfg, modules) -> dict:
    """The geometry frame's parts on the final state of geom_slice (its
    20-frame DB) and the next frame: extract_dynamic_seeds and
    depth_region_growing on the half grid as correction_dynamic_mask runs
    them, correction_dynamic_mask whole, inpaint over the DB, LightTrack
    (both searches) and the pipelined geometry frame's device work (its
    extraction, LightTrack, correction, frame build and track_frame_core,
    not adopted): ms through the host, device busy and device operations per
    call. The geometry frame must not wait for the card. Then a profiler
    window over whole frames through the entry point."""
    geometry, extractor, build_frame = modules
    tr, geo, cam = slam.tracker, slam._geometry, cfg.camera
    g = cfg.geometry
    gray, depth = frame.gray, frame.depth
    sem = torch.ones_like(gray)
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    frame0 = build_frame(feats, depth, sem, cam)
    T_lt, n_lt = tr.light_track_dispatched(frame0)
    cam_h = dataclasses.replace(cam, fx=cam.fx / 2, fy=cam.fy / 2, cx=cam.cx / 2,
                                cy=cam.cy / 2, width=(cam.width + 1) // 2,
                                height=(cam.height + 1) // 2)
    cfg_h = dataclasses.replace(cfg, camera=cam_h)
    db = geo.db
    db_h = db._replace(gray=db.gray[:, ::2, ::2], depth=db.depth[:, ::2, ::2],
                       mask=db.mask[:, ::2, ::2], rgb=db.rgb[:, ::2, ::2])
    d_h = depth[::2, ::2]
    dil = max(int(round(g.dilation_px * cam.width / 640.0 / 2)), 2)
    seeds = geometry.extract_dynamic_seeds(db_h, d_h, T_lt, cfg_h)
    grown = geometry.correction_dynamic_mask(db, depth, T_lt, cfg)
    refined = geometry.combine_masks(sem, grown)

    def geometry_frame():
        f = extractor.extract(gray, cfg.orb, cam.height, cam.width)
        fr0 = build_frame(f, depth, sem, cam)
        T, n_in = tr.light_track_dispatched(fr0)
        ref = torch.where(n_in >= 10, geometry.combine_masks(
            sem, geometry.correction_dynamic_mask(geo.db, depth, T, cfg)), sem)
        return tr._dispatch(build_frame(f, depth, ref, cam))

    sites = sync_sites(torch, geometry_frame)
    if sites:
        fail(f"the geometry frame synchronises with the card at {sites}")
    stages = {
        "extract_dynamic_seeds": stage_numbers(torch, lambda: geometry.extract_dynamic_seeds(
            db_h, d_h, T_lt, cfg_h)),
        "depth_region_growing": stage_numbers(torch, lambda: geometry.depth_region_growing(
            seeds, d_h, g.region_growing_threshold, 40, dil)),
        "correction_dynamic_mask": stage_numbers(
            torch, lambda: geometry.correction_dynamic_mask(db, depth, T_lt, cfg)),
        "inpaint": stage_numbers(torch, lambda: geometry.inpaint(db, frame.rgb, depth, refined,
                                                                 T_lt, cfg)),
        "light_track_narrow_and_wide": stage_numbers(
            torch, lambda: tr.light_track_dispatched(frame0)),
        "geometry_frame_dispatch": stage_numbers(torch, geometry_frame),
    }

    def whole_frames():
        for i, f in enumerate(more_frames):
            slam.track_rgbd(f.gray, f.depth, None, (t_first + i) / 30.0, use_geometry=True)
        slam.shutdown()

    return dict(phase="geom_stages", card=nvidia_smi_line(),
                half_grid=[cam_h.height, cam_h.width], db_frames=int(db.valid.sum()),
                seeds=int(seeds.sum()), grown_full_grid=int(grown.sum()),
                light_track_inliers=int(n_lt), ms={k: v["ms"] for k, v in stages.items()},
                stages=stages, frames_profiled=len(more_frames),
                per_geom_frame_pipelined=profile_window(torch, whole_frames, len(more_frames)))


CLI_SETTINGS = """%YAML:1.0
Camera.fx: {c.fx}
Camera.fy: {c.fy}
Camera.cx: {c.cx}
Camera.cy: {c.cy}
Camera.width: {c.width}
Camera.height: {c.height}
Camera.fps: {c.fps}
Camera.bf: {c.bf}
Camera.RGB: {c.rgb}
ThDepth: {c.th_depth}
DepthMapFactor: {c.depth_map_factor}
ORBextractor.nFeatures: {o.n_features}
ORBextractor.scaleFactor: {o.scale_factor}
ORBextractor.nLevels: {o.n_levels}
ORBextractor.iniThFAST: {o.ini_th_fast}
ORBextractor.minThFAST: {o.min_th_fast}
"""


def write_tum_sequence(cfg, frames, base: Path, png, traj_mod) -> list:
    """The frames as a TUM-layout directory (rgb/, depth/ in DepthMapFactor
    units, masks/ holding the renderer's dyn_mask as a mask cache,
    assoc.txt, groundtruth.txt, settings.yaml), named by TUM epoch
    timestamps. Returns the ground-truth poses."""
    for sub in ("rgb", "depth", "masks"):
        (base / sub).mkdir(parents=True)
    assoc, gts = [], []
    dmf = cfg.camera.depth_map_factor
    for i, fr in enumerate(frames):
        ts = CLI_EPOCH + i / 30.0
        name = f"{ts:.6f}.png"
        png.write(base / "rgb" / name, fr.rgb.cpu().numpy().astype(np.uint8))
        png.write(base / "depth" / name, (fr.depth.cpu().numpy() * dmf).astype(np.uint16))
        png.write(base / "masks" / name, (fr.dyn_mask.cpu().numpy() * 255).astype(np.uint8))
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        gts.append(fr.T_wc.cpu().numpy().astype(np.float64))
    (base / "assoc.txt").write_text("\n".join(assoc) + "\n")
    traj_mod.save_tum(str(base / "groundtruth.txt"),
                      [(CLI_EPOCH + i / 30.0, T) for i, T in enumerate(gts)])
    (base / "settings.yaml").write_text(CLI_SETTINGS.format(c=cfg.camera, o=cfg.orb))
    return gts


def run_cli(main, argv, cwd: Path) -> tuple[int, str, float]:
    """main(argv) of a CLI in directory cwd, its standard output kept."""
    import contextlib
    import io
    cwd.mkdir(parents=True, exist_ok=True)
    old, buf = os.getcwd(), io.StringIO()
    os.chdir(cwd)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, buf.getvalue(), time.perf_counter() - t0


def trajectory_file_ate(path: Path, gts, metrics) -> tuple[float, int]:
    rows = [r.split() for r in path.read_text().strip().splitlines()]
    if not rows or any(len(r) != 8 for r in rows):
        fail(f"cli: {path} does not parse as a TUM trajectory")
    T0inv = np.linalg.inv(gts[0])
    est = np.array([[float(x) for x in r[1:4]] for r in rows])
    gt = np.stack([(T0inv @ gts[round((float(r[0]) - CLI_EPOCH) * 30.0)])[:3, 3] for r in rows])
    return metrics.ate_rmse(est, gt), len(rows)


def phase_cli(torch, mk, cfg, frames, metrics, dev, seg_weights: Path) -> dict:
    """The CLIs as a user runs them, on a TUM-layout sequence of the
    dynamic scene (CLI_FRAMES frames at full size, written with io/png.py
    into a directory under build/): rgbd_tum in its three modes (plain; the
    mask cache, which runs the geometry path; an output directory, GD
    masking with inpainting), then evaluate --mode gd and --mode geometry
    with the mask cache and --ref-masks. Gates as the JAX CLI tests use
    them: plain ATE < 0.30 m, masked < 0.08 m, GD (evaluate and rgbd_tum's
    output mode) < 0.15 m; the trajectory files parse and the first
    keyframe keeps its epoch timestamp to within 2 s; the output PNGs read
    back and round-trip through io/png.py. Then rgbd_tum with an empty mask
    directory and --segmenter flax:<seg_weights> (the live Mask R-CNN on
    every frame, written back to the cache; the geometry path tracks): every
    frame gets a cached mask, ATE < 0.30 m (the JAX live-segmenter driver
    test's gate)."""
    from gdslam_tpu_torch.cli import evaluate, rgbd_tum
    from gdslam_tpu_torch.io import native_loader, png
    from gdslam_tpu_torch.system import trajectory as traj_mod
    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="cli_smoke_", dir=ROOT / "build"))
    seq = base / "seq"
    t0 = time.perf_counter()
    gts = write_tum_sequence(cfg, frames[:CLI_FRAMES], seq, png, traj_mod)
    write_s = time.perf_counter() - t0
    settings, assoc = str(seq / "settings.yaml"), str(seq / "assoc.txt")
    masks, gt_file = str(seq / "masks"), str(seq / "groundtruth.txt")
    from gdslam_tpu_torch.ops import detect_kernels as dk
    reset_launch_counts(mk)
    dk.reset_launch_counts()
    runs = {}
    seg_cache = base / "seg_cache"
    for mode, extra, gate in (("plain", [], 0.30), ("geometry", [masks], 0.08),
                              ("gd_inpaint", [masks, str(base / "out")], 0.15),
                              ("segmenter", [str(seg_cache), "--segmenter",
                                             f"flax:{seg_weights}"], SEG_ATE_GUARD_M)):
        rc, out, sec = run_cli(rgbd_tum.main, ["none", settings, str(seq), assoc, *extra,
                                                  "--device", dev], base / mode)
        if rc != 0:
            fail(f"cli: rgbd_tum {mode} returned {rc}: {out[-2000:]}")
        ate, n = trajectory_file_ate(base / mode / "CameraTrajectory.txt", gts, metrics)
        kf_rows = (base / mode / "KeyFrameTrajectory.txt").read_text().strip().splitlines()
        kf0 = float(kf_rows[0].split()[0]) if kf_rows else float("nan")
        runs[f"rgbd_tum_{mode}"] = dict(
            seconds=sec, ate_m=ate, poses=n, keyframes=len(kf_rows), first_keyframe_ts=kf0,
            loader="native" if "(native loader)" in out else "TumSequence",
            median_tracking_s=float(out.split("median tracking time:")[1].split()[0]))
        if not (n >= CLI_FRAMES - 3 and ate < gate and abs(kf0 - CLI_EPOCH) < 2.0):
            fail(f"cli: rgbd_tum {mode}: {runs[f'rgbd_tum_{mode}']} (ATE gate {gate} m)")
    cached = sorted(os.listdir(seg_cache))
    runs["rgbd_tum_segmenter"]["cached_masks"] = len(cached)
    if cached != sorted(os.listdir(seq / "rgb")):
        fail(f"cli: rgbd_tum --segmenter cached {len(cached)} masks for {CLI_FRAMES} frames")
    runs["rgbd_tum_segmenter"]["mask_cover_mean"] = float(np.mean(
        [png.read(seg_cache / n).mean() / 255.0 for n in cached]))
    out_dir = base / "out"
    names = sorted(os.listdir(out_dir / "rgb"))
    for sub, shape, dtype in (("rgb", (cfg.camera.height, cfg.camera.width, 3), np.uint8),
                              ("depth", (cfg.camera.height, cfg.camera.width), np.uint16),
                              ("mask", (cfg.camera.height, cfg.camera.width), np.uint8)):
        if sorted(os.listdir(out_dir / sub)) != names or len(names) != CLI_FRAMES:
            fail(f"cli: {sub}/ holds {len(os.listdir(out_dir / sub))} images")
        img = png.read(out_dir / sub / names[-1])
        png.write(base / "round_trip.png", img)
        if img.shape != shape or img.dtype != dtype or \
                not np.array_equal(png.read(base / "round_trip.png"), img):
            fail(f"cli: {sub}/{names[-1]} does not round-trip ({img.shape}, {img.dtype})")
    last_mask = png.read(out_dir / "mask" / names[-1])
    runs["rgbd_tum_gd_inpaint"]["last_mask_dynamic_px"] = int((last_mask < 128).sum())
    for mode, gate, vocab in (("gd", 0.15, "none"), ("geometry", 0.08, "none"),
                              ("gd", 0.15, "default")):
        name = f"evaluate_{mode}" + ("_vocab_default" if vocab != "none" else "")
        rc, out, sec = run_cli(evaluate.main, [
            str(seq), assoc, gt_file, "--mode", mode, "--settings", settings, "--masks", masks,
            "--ref-masks", masks, "--rpe-delta", "5", "--vocab", vocab, "--device", dev],
            base / name)
        rec = json.loads(out.strip().splitlines()[-1])
        runs[name] = dict(seconds=sec, **rec)
        if rc != 0 or not (rec["associated"] >= CLI_FRAMES - 4 and rec["ate_rmse_m"] < gate
                           and rec["rpe_rmse_m"] < 0.5 and "mask_iou" in rec):
            fail(f"cli: evaluate --mode {mode}: {rec} (ATE gate {gate} m)")
    record_launches("cli")
    res = dict(phase="cli", frames=CLI_FRAMES, width=cfg.camera.width,
               height=cfg.camera.height, write_s=write_s,
               native_loader=native_loader.available(),
               match_top2_launches=mk.match_top2.launches,
               detect_launches={n: getattr(dk, n).launches for n in SEG_DET_KERNELS},
               runs=runs, card=nvidia_smi_line())
    emit(res)
    shutil.rmtree(base)
    return res


def phase_stages(torch, mk, slam, frame, cfg, modules, ransacs, old=None):
    """Per-stage medians on the slice's final state and the next frame; the
    functions are pure (they return new state), so the state is reused."""
    extractor, build_frame, tracking, optimizer, matcher, mapping, ba = modules
    tr, cam = slam.tracker, cfg.camera
    ones = torch.ones_like(frame.gray)
    feats = extractor.extract(frame.gray, cfg.orb, cam.height, cam.width)
    fr = build_frame(feats, frame.depth, ones, cam)
    last, arena, vel = tr.last, tr.arena, tr.velocity
    pts_w = tracking._world_points(arena, last, cfg)
    T_pred = vel @ last.T_cw
    T1, assoc1, _, _ = tracking.track_motion_model(last, pts_w, fr, T_pred, cfg)
    _, T2, assoc2, _ = tracking.track_local_map(arena, fr, T1, cfg, assoc1)
    matched = assoc2 >= 0
    sf = float(cfg.orb.scale_factor)
    obs = optimizer.PoseObs(
        pw=torch.where(matched[:, None], arena.pt_pos[torch.where(matched, assoc2, 0).long()], 0.0),
        uv=fr.uv, ur=fr.ur, inv_sigma2=1.0 / sf ** (2.0 * fr.level.float()), valid=matched)
    K = (cam.fx, cam.fy, cam.cx, cam.cy)

    # The keyframe program's parts on the state each of them meets: the next
    # frame inserted as a keyframe, then triangulation, fusion and BA.
    kf_id = tr.n_kf_host
    assoc_f = tracking.fuse_associate(arena, fr, T2, assoc2, cfg)
    a_ins, _ = tracking._insert_keyframe(arena, fr, T2, assoc_f, 99.0, cfg, kf_id=kf_id)
    a_tri = mapping.create_new_map_points(a_ins, kf_id, cfg)
    a_fus, _ = mapping.fuse_into_keyframe(a_tri, kf_id, cfg)
    a_ref = tracking.cull_points(mapping.refresh_points(a_fus, kf_id, cfg))
    prob = ba.build_problem(a_ref, kf_id, cfg)
    kf = kf_id - 1

    # the kernel on the inputs the tracker gives it at each call site
    path_calls = []
    for role, module, fn in (
            ("motion_model", matcher,
             lambda: tracking.track_motion_model(last, pts_w, fr, T_pred, cfg)),
            ("local_map", matcher, lambda: tracking.track_local_map(arena, fr, T1, cfg, assoc1)),
            ("keyframe_fuse", matcher, lambda: tracking.fuse_associate(arena, fr, T2, assoc2, cfg)),
            ("fuse_into_keyframe", matcher,
             lambda: mapping.fuse_into_keyframe(a_tri, kf_id, cfg)),
            ("relocalization_dense", tracking, lambda: tracking._dense_ratio_matches(
                fr, arena.kf_uv[kf], arena.kf_desc[kf], arena.kf_level[kf],
                arena.kf_kp_valid[kf], cfg.orb.n_levels))):
        args = record_top2_calls(module, fn)[0]
        err, info = compare_top2(torch, mk, args)
        call = dict(role=role, M=args[0].shape[0], N=args[5].shape[0], max_abs_err=err,
                    path=info["path"],
                    **time_top2(torch, mk, args), **top2_bound(torch, mk, args))
        if old is not None:                      # old, new, new, old in one run
            for g, w in zip(old(*args), mk.match_top2_plain(*args)):
                if not torch.equal(g, w.to(torch.int32)):
                    fail("the old kernel differs from the plain version")
            t = [cuda_ms(torch, lambda f=f: f(*args), reps=200)
                 for f in (old, mk.match_top2, mk.match_top2, old)]
            call["ab_ms"] = dict(old=[t[0], t[3]], new=[t[1], t[2]])
            fn, a, keep = launch_call(torch, mk, args)
            d = [old.device_ms(args), graph_ms(torch, fn, a), graph_ms(torch, fn, a),
                 old.device_ms(args)]
            del keep
            call["ab_device_ms"] = dict(old=[d[0], d[3]], new=[d[1], d[2]])
        path_calls.append(call)
    if path_calls[4]["path"] != "tiled":
        fail("relocalization's all-pairs call did not take the kernel's tiled path")

    def full_keyframe(use_tri, use_ba):
        return lambda: tracking.keyframe_program(arena, fr, T2, assoc2, 99.0, cfg, use_tri,
                                                 use_ba, kf_id=kf_id)

    # extract, the tracking programs and the keyframe program wait for the card nowhere
    # (the keyframe program when it is given the cursor)
    for name, fn in (("extract", lambda: extractor.extract(frame.gray, cfg.orb, cam.height,
                                                          cam.width)),
                     ("track_frame_core", lambda: tracking.track_frame_core(
                         arena, last, vel, True, fr, cfg, tr.ref_kf)),
                     ("keyframe_program", full_keyframe(True, True))):
        sites = sync_sites(torch, fn)
        if sites:
            fail(f"{name} synchronises with the card at {sites}")

    pnp, rigid = ransacs
    stages = dict(
        extract=wall_ms(torch, lambda: extractor.extract(frame.gray, cfg.orb, cam.height,
                                                          cam.width)),
        build_frame=wall_ms(torch, lambda: build_frame(feats, frame.depth, ones, cam)),
        match_top2_motion_model=path_calls[0]["ms"],
        match_top2_local_map=path_calls[1]["ms"],
        pose_optimization=wall_ms(torch, lambda: optimizer.pose_optimization(
            T1, obs, K, cam.bf)),
        track_motion_model=wall_ms(torch, lambda: tracking.track_motion_model(
            last, pts_w, fr, T_pred, cfg)),
        track_local_map=wall_ms(torch, lambda: tracking.track_local_map(
            arena, fr, T1, cfg, assoc1)),
        track_frame_core=wall_ms(torch, lambda: tracking.track_frame_core(
            arena, last, vel, True, fr, cfg, tr.ref_kf)),
        keyframe_program_plain=wall_ms(torch, full_keyframe(False, False), reps=5),
        keyframe_program=wall_ms(torch, full_keyframe(True, True), reps=5),
        create_new_map_points=wall_ms(torch, lambda: mapping.create_new_map_points(
            a_ins, kf_id, cfg), reps=5),
        fuse_into_keyframe=wall_ms(torch, lambda: mapping.fuse_into_keyframe(
            a_tri, kf_id, cfg), reps=5),
        refresh_points=wall_ms(torch, lambda: mapping.refresh_points(a_fus, kf_id, cfg), reps=5),
        build_problem=wall_ms(torch, lambda: ba.build_problem(a_ref, kf_id, cfg), reps=5),
        run_local_ba=wall_ms(torch, lambda: ba.run_local_ba(a_ref, prob, cfg, 5, 5), reps=5),
        ransac_pnp=wall_ms(torch, pnp, reps=5),
        ransac_rigid=wall_ms(torch, rigid, reps=5),
    )
    sizes = dict(local_keyframes=int(prob.kf_mask[:ba.L_OPT].sum()),
                 fixed_keyframes=int(prob.kf_mask[ba.L_OPT:].sum()),
                 ba_points=int(prob.pt_mask.sum()), ba_edges=int((prob.obs_slot >= 0).sum()),
                 triangulated_here=int(a_tri.n_pt - a_ins.n_pt))
    gn_call = lambda: optimizer.pose_optimization(T1, obs, K, cam.bf)      # noqa: E731
    ba_call = lambda: ba.run_local_ba(a_ref, prob, cfg, 5, 5)              # noqa: E731
    return dict(phase="stages", ms=stages, keyframe_sizes=sizes, match_top2_on_path=path_calls,
                obs_matched=int(matched.sum()), **launch_floor(torch, mk)), path_calls, \
        gn_call, ba_call


def profile_window(torch, fn, n: int) -> dict:
    """fn() under torch.profiler: host time, the union of CUDA kernel and
    copy intervals (device busy), device operations and the host-side
    operators by self CPU time ([calls, ms]), all per unit of n; the device
    numbers None where the profiler lists no device event (it misses a lone
    kernel launched from a ctypes library). The profiler's own overhead
    lengthens the host time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    out = dict(wall_ms=wall_us / 1e3 / n, device_busy_ms=busy / 1e3 / n,
               device_idle_share=(1.0 - busy / wall_us) if busy > 0 else None,
               device_ops=len(dev) / n,
               top_device_ms={k[:80]: v / 1e3 / n for k, v in top},
               top_host_ops={e.key[:60]: [e.count / n, e.self_cpu_time_total / 1e3 / n]
                             for e in host})
    if not dev:                # nothing seen on the device is nothing measured there
        out.update(device_busy_ms=None, device_ops=None,
                   device_note="the profiler listed no device event in this window")
    return out


def phase_profile(torch, slam, slam_pipe, frames, t_first: int, gn_call, ba_call,
                  gd_slam, gd_raw, gd_first: int) -> dict:
    """Profiler windows over whole frames (System.track_rgbd, per frame), not
    pipelined and pipelined, over whole GD frames (System.track_rgbd_gd on
    its packed fast path, pipelined with commit_every 10, ended by a flush),
    over one pose_optimization solve and over one run_local_ba."""
    def frames_fn(system):
        def run():
            for i, fr in enumerate(frames):
                system.track_rgbd(fr.gray, fr.depth, None, (t_first + i) / 30.0)
            system.shutdown()
        return run

    def gd_frames():
        for i, (g, d) in enumerate(gd_raw):
            gd_slam.track_rgbd_gd(g, d, None, (gd_first + i) / 30.0)
        gd_slam.shutdown()

    gn_call()
    ba_call()
    return dict(phase="profile", frames=len(frames), card=nvidia_smi_line(),
                per_frame=profile_window(torch, frames_fn(slam), len(frames)),
                per_frame_pipelined=profile_window(torch, frames_fn(slam_pipe), len(frames)),
                gd_frames=len(gd_raw),
                per_gd_frame_pipelined=profile_window(torch, gd_frames, len(gd_raw)),
                per_pose_optimization=profile_window(torch, gn_call, 1),
                per_run_local_ba=profile_window(torch, ba_call, 1))


# ----------------------------------------------------------------------------
# pose_gn: the pose Gauss-Newton solve on the card
# ----------------------------------------------------------------------------

POSE_REPLACES = "gdslam_tpu/backend/optimizer.py:84"
POSE_REPLACES_NOTE = ("pose_optimization: gn_iter :99 in the fori_loop :114; XLA-fused in the "
                      "JAX package, no Pallas")
POSE_NO_LIBRARY = ("no PyTorch call computes it: torch.linalg.cholesky and cholesky_solve solve "
                   "one 6 x 6 system; the 20 reweighted steps' residuals, weights, Jacobians, "
                   "sums and se3_exp are calls of their own (~200 a step in the twin)")
# The bound's operations (csrc/pose_gn.cu's note): a row and iteration 262
# (arithmetic, compares and selects: the transform 18, the projection and
# residuals 17, chi2 and the Huber weight 17, the Jacobian 30, Jw 18, H's 21
# entries x 6 with their sums 126, b's 6 x 6 = 36), an iteration's solve 460
# (the diagonal 6, Cholesky 91, the two substitutions 72, dx and its test 18,
# se3_exp 161 and the 4 x 4 product 112), a row's inlier test 46. Bytes: a
# row's 29 read once and its inlier flag written, T in and out, the count.
POSE_OPS_PER_ROW = 262
POSE_SOLVE_OPS = 460
POSE_FINAL_OPS_PER_ROW = 46
POSE_BYTES_PER_ROW = 30
POSE_FIXED_BYTES = 2 * 64 + 8
POSE_SM_LANES = 128            # FP32 lanes of one SM: a one-CTA solve's ceiling
# the call sites each path must reach (record_pose_calls): (path, site), the
# site the function that called pose_optimization (the motion model's with
# its caller and search radius in px)
POSE_SITES = (("gd_slice", "track_motion_model<-track_frame_core r15"),
              ("gd_slice", "track_local_map"), ("slice", "track_local_map"),
              ("geom_slice", "track_motion_model<-light_track_dispatched r15"),
              ("geom_slice", "track_motion_model<-light_track_dispatched r30"),
              ("reloc", "_relocalize"), ("batch", "track_local_map"),
              ("batch", "device_relocalize"), ("mono", "initialize"),
              ("stereo", "track_local_map"))
POSE_PATHS = ("gd_slice", "slice", "geom_slice", "stereo", "mono", "batch", "reloc")
POSE_TIMED = (("gd_slice", "track_local_map"), ("stereo", "track_local_map"),
              ("mono", "initialize"))
POSE_CALLS: dict = {}          # (path, site) -> the first pose_optimization call's arguments


@contextlib.contextmanager
def record_pose_calls(path: str):
    """The first pose_optimization call at each site while the block runs,
    its arguments copied into POSE_CALLS[(path, site)]. The site is the
    function that called pose_optimization; the motion model's also names
    its own caller and the radius it was given. Once every site POSE_SITES
    expects of path is recorded, the originals are back in place."""
    from gdslam_tpu_torch.backend import optimizer
    from gdslam_tpu_torch.system import tracking
    real_solve, real_motion = optimizer.pose_optimization, tracking.track_motion_model
    bind_solve = inspect.signature(real_solve).bind
    bind_motion = inspect.signature(real_motion).bind
    want = {s for p, s in POSE_SITES if p == path}
    motion = []                # the motion model's calls under way, as sites

    def restore():
        optimizer.pose_optimization, tracking.track_motion_model = real_solve, real_motion

    def track_motion_model(*a, **k):
        args = bind_motion(*a, **k)
        args.apply_defaults()
        motion.append(f"track_motion_model<-{sys._getframe(1).f_code.co_name} "
                      f"r{args.arguments['radius_px']:g}")
        try:
            return real_motion(*a, **k)
        finally:
            motion.pop()

    def pose_optimization(*a, **k):
        site = sys._getframe(1).f_code.co_name
        if site == "track_motion_model" and motion:
            site = motion[-1]
        if (path, site) not in POSE_CALLS:
            args = bind_solve(*a, **k)
            args.apply_defaults()
            T, obs, *rest = args.arguments.values()
            POSE_CALLS[(path, site)] = (T.clone(), type(obs)(*(t.clone() for t in obs)), *rest)
            if want <= {s for p, s in POSE_CALLS if p == path}:
                restore()
        return real_solve(*a, **k)

    optimizer.pose_optimization, tracking.track_motion_model = pose_optimization, \
        track_motion_model
    try:
        yield
    finally:
        restore()


def pose_compare(torch, pk, args) -> dict:
    """pose_gn against its plain twin on one call, on the card: the outputs'
    differing elements (floats by their bits) and their largest absolute
    difference (T's entries, each inlier flag as 0 / 1, the count; 0 where
    both are NaN), and a second call's differing elements."""
    want = pk.pose_gn_plain(*args)
    got, again = pk.pose_gn(*args), pk.pose_gn(*args)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def differing(xs, ys):
        return sum(int((bits(x) != bits(y)).sum()) for x, y in zip(xs, ys))

    def abs_err(x, y):
        d = (x.double() - y.double()).abs()
        return float(torch.where(x.isnan() & y.isnan(), 0.0, d.nan_to_num(float("inf"))).max())

    return dict(rows=args[1].pw.shape[0], iterations=args[4] * args[5],
                valid=int(args[1].valid.sum()), n_inliers=int(got[2]),
                differing=differing(got, want), repeat_differing=differing(again, got),
                max_abs_err=max(abs_err(x, y) for x, y in zip(got, want)))


def pose_bound(n: int, iterations: int) -> dict:
    ops = iterations * (n * POSE_OPS_PER_ROW + POSE_SOLVE_OPS) + n * POSE_FINAL_OPS_PER_ROW
    bytes_ = n * POSE_BYTES_PER_ROW + POSE_FIXED_BYTES
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    return dict(operations=ops, bytes=bytes_, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def pose_timing(torch, pk, args, clock_mhz: float) -> dict:
    """pose_gn's ms through the wrapper, on the device from a CUDA graph
    (no host), the twin's on the card, the bound and the one-SM ceiling
    (the bound's operations over one SM's 128 lanes at clock_mhz), and the
    kernels one call launches."""
    fn, a, keep = c_launch(torch, lambda: pk.pose_gn(*args))
    n, iterations = args[1].pw.shape[0], args[4] * args[5]
    bound = pose_bound(n, iterations)
    out = dict(shape=[n, iterations], ms=cuda_ms(torch, lambda: pk.pose_gn(*args), reps=200),
               device_ms=graph_ms(torch, fn, a),
               plain_ms=cuda_ms(torch, lambda: pk.pose_gn_plain(*args), reps=3, windows=3),
               **bound, one_sm_ms=bound["operations"] / (POSE_SM_LANES * clock_mhz * 1e6) * 1e3,
               one_sm_clock_mhz=clock_mhz,
               launch=one_launch(torch, pk.pose_gn, lambda: pk.pose_gn(*args)))
    del keep
    return out


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    return float(out.stdout.split()[0])


def phase_pose(torch, dev, paths: bool = True) -> dict:
    """pose_gn against its plain twin on the card: its sinf, cosf and sqrtf
    on given values; ops/pose_cases.py's cases and (paths) the first call
    recorded at every path's call sites (POSE_CALLS), bitwise and
    repeatable; the kernel's ms through the wrapper, on the device from a
    CUDA graph, the twin's and the bound on the tracker's, the stereo cell's
    and the mono bootstrap's case and (paths) on the main path's local-map
    call, the stereo cell's (2000 rows) and the mono bootstrap's (8
    iterations)."""
    from gdslam_tpu_torch.ops import pose_cases
    from gdslam_tpu_torch.ops import pose_kernel as pk
    r = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([np.geomspace(1e-8, 1.0, 200_000),
                                         r.uniform(0, 0.3, 200_000), r.uniform(0, 1e4, 100_000),
                                         [0.0, 1e-16, 1e-8]]).astype(np.float32)).to(dev)
    math = {name: int((got.view(torch.int32) != want.view(torch.int32)).sum())
            for name, got, want in zip(("sin", "cos", "sqrt"), pk.math_on_card(x),
                                       (torch.sin(x), torch.cos(x), torch.sqrt(x)))}
    cases = {name: pose_compare(torch, pk, pose_cases.pose_args(name, dev))
             for name in pose_cases.CASES}
    calls = list(POSE_CALLS.items()) if paths else []
    sites = [dict(path=p, site=s, **pose_compare(torch, pk, a)) for (p, s), a in calls]
    missing = [k for k in POSE_SITES if k not in POSE_CALLS] if paths else []
    clock = sm_clock_mhz()
    timed = [(f"case:{c}", pose_cases.pose_args(c, dev))
             for c in ("tracker_1500", "stereo_2000", "mono_boot")]
    timed += [(f"{p}:{s}", POSE_CALLS[(p, s)]) for p, s in POSE_TIMED
              if paths and (p, s) in POSE_CALLS]
    timing = {k: pose_timing(torch, pk, a, clock) for k, a in timed}
    res = dict(phase="pose", math_differing=math, cases=cases, call_sites=sites,
               missing_sites=missing, timing=timing, launches_by_path=dict(POSE_BY_PATH),
               ptxas=ptxas_kernels(PTXAS.get("pose_gn", [])), card=nvidia_smi_line())
    emit(res)
    bad = [k for k, c in list(cases.items()) + [(f"{c['path']}:{c['site']}", c) for c in sites]
           if c["differing"] or c["repeat_differing"]]
    if bad or any(math.values()):
        fail(f"pose: the kernel differs from its twin on {bad}, math {math}")
    if missing:
        fail(f"pose: no pose_gn call recorded at {missing}")
    if not all(t["launch"]["ok"] for t in timing.values()):
        fail(f"pose: not one launch a call: {timing}")
    return res


# ----------------------------------------------------------------------------
# loop closing and BoW place recognition, and determinism
# ----------------------------------------------------------------------------

# The revisit run of the JAX package's loop test (tests/test_loop_e2e.py):
# the circuit io.synthetic.gt_pose_loop with period 120, 180 frames (1.5
# laps), and at frame 100 a progressive drift of the second half of the
# keyframes, so the revisit cannot rejoin the first lap's map by matching
# and must go through place recognition. At 480x640 with the SlamConfig()
# defaults the JAX package fires no loop on this sequence (on the CPU,
# tools/loop_quality_cpu.py: 15 keyframes, no loop), so the full-width run
# is held to tracking and its numbers, and the loop guard is held on the
# JAX test's own configuration (320x240, 512 features, 4 levels), where the
# JAX package fires one; LOOP_JAX_* are its numbers there and at full size.
LOOP_PERIOD = 120
LOOP_FRAMES = 180
LOOP_FULL_FRAMES = 140         # the 480x640 run, cut from 180 (LOOP_JAX_FULL's) for the time limit
LOOP_DRIFT_AT = 100
LOOP_XI_DRIFT = (0.20, 0.05, 0.0, 0.01, 0.08, 0.0)
LOOP_MIN_SPAN = 10             # cur - cand of a genuine revisit
LOOP_KMAX = 512
LOOP_JAX_FULL = dict(loops=[], keyframes=15, keyframe_ate_after_m=0.06839393672122954)
LOOP_JAX_SMALL = dict(loops=[[17, 3]], keyframes=21,
                      keyframe_ate_before_correction_m=0.13958463111446542,
                      keyframe_ate_after_m=0.14679970139941517)


def inject_drift(torch, lie, tr, xi) -> None:
    """The JAX loop test's `_inject_drift` on the port's tracker: keyframe k
    of the second half gets G_k = exp(alpha_k xi), alpha ramping to 1 over
    the recent keyframes, its points move with their keyframe's G, and the
    live pose gets the full G."""
    arena = tr.arena
    dev = arena.kf_pose.device
    n = tr.n_kf_host
    k0 = n // 2
    alphas = np.zeros(arena.kmax, np.float32)
    for k in range(k0, n):
        alphas[k] = (k - k0 + 1) / (n - k0)
    Gs = np.stack([lie.se3_exp(torch.from_numpy(a * np.asarray(xi, np.float32))).numpy()
                   for a in alphas])
    G_inv = torch.from_numpy(np.linalg.inv(Gs).astype(np.float32)).to(dev)
    Gs_d = torch.from_numpy(Gs).to(dev)
    ids = torch.arange(arena.kmax, device=dev)
    sel_kf = (ids >= k0) & arena.kf_valid
    ref = arena.pt_ref_kf.clamp(0, arena.kmax - 1).long()
    sel_pt = (arena.pt_ref_kf >= k0) & arena.pt_valid
    tr.arena = arena._replace(
        kf_pose=torch.where(sel_kf[:, None, None], arena.kf_pose @ G_inv, arena.kf_pose),
        pt_pos=torch.where(sel_pt[:, None], lie.se3_apply(Gs_d[ref], arena.pt_pos),
                           arena.pt_pos))
    tr.last = tr.last._replace(T_cw=tr.last.T_cw @ G_inv[n - 1])


def loop_frames(torch, synthetic, cfg, dev, n: int):
    return [synthetic.render(synthetic.gt_pose_loop(i, LOOP_PERIOD, device=dev), cfg.camera,
                             False, 30.0, i) for i in range(n)]


def synthetic_loop_T_wc(i: int) -> np.ndarray:
    from gdslam_tpu_torch.io import synthetic
    return synthetic.gt_pose_loop(i, LOOP_PERIOD).numpy().astype(np.float64)


def pose_error_to(T_cw: np.ndarray, want_cw: np.ndarray):
    """Translation (m) and rotation (degrees) between two T_cw."""
    cos = (np.trace(T_cw[:3, :3].T @ want_cw[:3, :3]) - 1.0) / 2.0
    return (float(np.linalg.norm(T_cw[:3, 3] - want_cw[:3, 3])),
            float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))


def keyframe_ate(metrics, synthetic, kf_pose, kf_timestamps) -> float:
    """The JAX loop test's keyframe ATE: keyframe camera centres against the
    circuit's, both relative to frame 0."""
    T0 = synthetic.gt_pose_loop(0, LOOP_PERIOD).numpy()
    est, gt = [], []
    for k, ts in enumerate(kf_timestamps):
        est.append(np.linalg.inv(kf_pose[k])[:3, 3])
        gt.append((np.linalg.inv(T0) @ synthetic.gt_pose_loop(round(ts * 30.0),
                                                             LOOP_PERIOD).numpy())[:3, 3])
    return metrics.ate_rmse(np.asarray(est), np.asarray(gt))


class LoopProbe:
    """While installed: the ms of the loop closer's steps (each call ended by
    a synchronise; the GBA and the pose graph inside `correct` too), host
    synchronisations inside process_keyframe, the keyframe's whole cost
    (Tracking._do_keyframe), match_top2 calls by call site, the keyframe
    ATE just before each correction, and the state at the first one."""

    def __init__(self, torch, modules, on_correct):
        lc_mod, pg_mod, gba_mod, matcher, tracking = modules
        self.torch, self.on_correct = torch, on_correct
        self.ms = collections.defaultdict(list)
        self.sites = collections.Counter()
        self.syncs, self.first = [], None
        self.patches = [(lc_mod.LoopCloser, "detect"), (lc_mod.LoopCloser, "compute_transform"),
                        (lc_mod.LoopCloser, "correct"), (pg_mod, "optimize"),
                        (gba_mod, "global_bundle_adjustment"),
                        (lc_mod.LoopCloser, "process_keyframe"),
                        (tracking.Tracking, "_do_keyframe")]
        self.top2 = [(matcher, "match_top2"), (lc_mod, "match_top2")]
        self.real = {}

    def _timed(self, name, real):
        torch = self.torch

        def call(*a, **k):
            if name == "correct" and self.first is None:
                self.first = a[1:5]                  # arena, kf_id, cand, T
            if name == "correct":
                self.on_correct(a[1])
            if name == "process_keyframe":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = real(*a, **k)
                        torch.cuda.synchronize()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                self.syncs.append(sum("synchroniz" in str(w.message) for w in caught))
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def _site(self, module_name, real):
        def call(*a, **k):
            site = "bow_guided_matches" if module_name == "loop_closing" else \
                sys._getframe(2).f_code.co_name
            self.sites[site] += 1
            return real(*a, **k)
        return call

    def __enter__(self):
        for owner, name in self.patches:
            self.real[(owner, name)] = getattr(owner, name)
            setattr(owner, name, self._timed(name, getattr(owner, name)))
        for owner, name in self.top2:
            self.real[(owner, name)] = getattr(owner, name)
            setattr(owner, name, self._site(owner.__name__.rsplit(".", 1)[-1],
                                            getattr(owner, name)))
        return self

    def __exit__(self, *exc):
        for (owner, name), real in self.real.items():
            setattr(owner, name, real)

    def medians(self) -> dict:
        return {k: dict(calls=len(v), median_ms=statistics.median(v), max_ms=max(v))
                for k, v in self.ms.items()}


def phase_loop(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev, modules,
               label: str, expect_loop: bool, kmax: int = LOOP_KMAX, pmax: int = 65536,
               reference: dict | None = None):
    """The revisit run through System(vocabulary="default"), not pipelined,
    the drift injected at LOOP_DRIFT_AT. Guards: every frame OK; with
    expect_loop at least one loop with cur - cand >= LOOP_MIN_SPAN and the
    verification's call sites launched; the BoW database queried."""
    from gdslam_tpu_torch.core import lie
    slam = System(cfg, vocabulary="default", kmax=kmax, pmax=pmax, device=dev)
    tr = slam.tracker
    ate_pre = []
    probe = LoopProbe(torch, modules, lambda arena: ate_pre.append(keyframe_ate(
        metrics, synthetic, arena.kf_pose.cpu().numpy(), tr.kf_timestamps)))
    reset_launch_counts(mk)
    states = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with probe:
        for i, fr in enumerate(frames):
            if i == LOOP_DRIFT_AT:
                inject_drift(torch, lie, tr, LOOP_XI_DRIFT)
            slam.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
            states.append(slam.tracking_state)
        slam.shutdown()
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    lc = tr.loop_closer
    traj = tr.camera_trajectory()
    n_kf = tr.n_kf_host
    kf_pose = tr.arena.kf_pose[:n_kf].cpu().numpy()
    ms = probe.medians()
    kf_ms, lc_ms = probe.ms["_do_keyframe"], probe.ms["process_keyframe"]
    record_launches(label)
    res = dict(phase=label, frames=len(frames), width=cfg.camera.width,
               height=cfg.camera.height, n_features=cfg.orb.n_features, kmax=kmax,
               pmax=pmax, vocabulary="default", drift_at=LOOP_DRIFT_AT, jax_cpu=reference,
               all_ok=all(s == TrackState.OK for s in states), run_s=run_s,
               loops=[[a, b] for a, b, _ in lc.loops], keyframes=n_kf,
               map_points=slam.map_point_count,
               keyframe_ate_before_correction_m=ate_pre[0] if ate_pre else None,
               keyframe_ate_after_m=keyframe_ate(metrics, synthetic, kf_pose, tr.kf_timestamps),
               ms=ms,
               keyframe_ms_median=statistics.median(kf_ms),
               keyframe_ms_without_loop_closer_median=statistics.median(
                   [a - b for a, b in zip(kf_ms, lc_ms)]),
               loop_closer_ms_median=statistics.median(lc_ms),
               host_syncs_per_keyframe=float(np.mean(probe.syncs)),
               host_syncs_per_keyframe_max=max(probe.syncs),
               match_top2_launches=mk.match_top2.launches,
               match_top2_by_site=dict(probe.sites), categorical_draw_launches=draw_launches(),
               card=nvidia_smi_line())
    emit(res)
    if not res["all_ok"] or len(traj) != len(frames):
        fail(f"{label}: a frame was not tracked OK ({len(traj)} poses)")
    genuine = [l for l in res["loops"] if l[0] - l[1] >= LOOP_MIN_SPAN]
    if expect_loop and not genuine:
        fail(f"{label}: no loop with cur - cand >= {LOOP_MIN_SPAN}: {res['loops']}")
    if probe.ms["detect"] == [] or (expect_loop and probe.sites["bow_guided_matches"] < 1):
        fail(f"{label}: the BoW database was not queried")
    if genuine and not (probe.sites["_search_by_sim3"] >= 2 and
                        probe.sites["_search_loop_points"] >= 1 and
                        res["categorical_draw_launches"] >= 1):
        fail(f"{label}: the verification's call sites did not launch: {dict(probe.sites)}")
    out = dict(traj=np.stack([T for _, T in traj]), kf_pose=kf_pose,
               map_points=res["map_points"], loops=res["loops"])
    return slam, res, out, probe.first


def phase_loop_reloc(torch, mk, slam, frame, idx: int, kdb, loop_closing, TrackState, label):
    """A forced loss on the loop run's final state: the last pose 1 m off
    and no velocity, so the next frame fails both motion-model searches and
    must relocalize through the BoW database (reloc_candidates) and the
    BoW-guided match, with RELOC_GUARD's inliers, and within RELOC_GUARD of
    the renderer's pose carried into the map region it relocalized in: the
    map holds the injected drift, so the pose the map can give is the
    renderer's pose relative to the keyframe that most of the frame's
    matched points come from, composed with that keyframe's pose in the
    map. The error against the renderer's pose alone is printed too."""
    tr = fork_tracker(slam.tracker)
    T_bad = tr.last.T_cw.clone()
    T_bad[0, 3] += 1.0
    tr.last, tr.velocity = tr.last._replace(T_cw=T_bad), None
    n_kf = tr.n_kf_host
    counts = collections.Counter()
    real_rc, real_bow = kdb.reloc_candidates, loop_closing._bow_guided_matches

    def rc(*a, **k):
        counts["reloc_candidates"] += 1
        return real_rc(*a, **k)

    def bow(*a, **k):
        counts["bow_guided_matches"] += 1
        return real_bow(*a, **k)

    kdb.reloc_candidates, loop_closing._bow_guided_matches = rc, bow
    reset_launch_counts(mk)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = tr.process(frame.gray, frame.depth, torch.ones_like(frame.gray), idx / 30.0)
        torch.cuda.synchronize()
    finally:
        kdb.reloc_candidates, loop_closing._bow_guided_matches = real_rc, real_bow
    frame_ms = (time.perf_counter() - t0) * 1e3
    T = np.asarray(T)

    def gt_cw(i):           # the renderer's T_cw, relative to frame 0 as the map is
        return np.linalg.inv(synthetic_loop_T_wc(i)) @ synthetic_loop_T_wc(0)

    assoc = tr.last.assoc
    refs = tr.arena.pt_ref_kf[assoc[assoc >= 0].long()].cpu().numpy()
    refs = refs[(refs >= 0) & (refs < n_kf)]       # not the frame's own keyframe, if it became one
    k = int(np.bincount(refs).argmax())
    kf_frame = round(tr.kf_timestamps[k] * 30.0)
    expected = gt_cw(idx) @ np.linalg.inv(gt_cw(kf_frame)) @ \
        tr.arena.kf_pose[k].cpu().numpy()
    err_m, err_deg = pose_error_to(T, expected)
    gt_m, gt_deg = pose_error_to(T, gt_cw(idx))
    record_launches(label)
    res = dict(phase=label, frame=idx, state=tr.state.name, n_inliers=tr.n_inliers,
               region_keyframe=k, region_keyframe_frame=kf_frame, err_m=err_m, err_deg=err_deg,
               err_to_renderer_m=gt_m, err_to_renderer_deg=gt_deg, frame_ms=frame_ms,
               calls=dict(counts), match_top2_launches=mk.match_top2.launches)
    emit(res)
    if tr.state != TrackState.OK or counts["reloc_candidates"] != 1 or \
            counts["bow_guided_matches"] < 1:
        fail(f"{label}: the forced loss did not relocalize through the BoW database")
    if not (err_m <= RELOC_GUARD[0] and err_deg <= RELOC_GUARD[1]
            and tr.n_inliers >= RELOC_GUARD[2]):
        fail(f"{label}: relocalized pose off by {err_m} m, {err_deg} degrees with "
             f"{tr.n_inliers} inliers")
    return res


def revisit_pair(tr) -> tuple[int, int]:
    """The last keyframe and the first-half keyframe nearest to it on the
    circuit (the pair a loop closer would verify)."""
    n = tr.n_kf_host
    at = [round(ts * 30.0) % LOOP_PERIOD for ts in tr.kf_timestamps]

    def dist(k):
        d = abs(at[k] - at[n - 1])
        return min(d, LOOP_PERIOD - d)
    return n - 1, min(range(n // 2), key=dist)


def phase_loop_stages(torch, mk, states, cfg, modules) -> tuple[dict, list]:
    """The kernel at the loop closer's four call sites (the BoW-guided match,
    both SearchBySim3 growths, the loop-point projection), on the full-width
    run's revisit pair where its verification gets that far, else on the
    state the small run's first correction met: exact against the plain
    version with each path forced, timed against its bound. Then the
    verification, the essential graph and the global BA timed alone on the
    full-width arena (512 keyframe slots x 1500 keypoints, 65536 points)."""
    lc_mod, pg_mod, gba_mod, matcher, _ = modules
    sites = {}
    for tag, arena, kf_id, cand, lc in states:
        lc = copy.copy(lc)
        db = lc.db
        bow = record_top2_calls(lc_mod, lambda: lc_mod._bow_guided_matches(
            arena.kf_desc[kf_id], arena.kf_kp_valid[kf_id], db.words[kf_id],
            arena.kf_desc[cand], arena.kf_kp_valid[cand], db.words[cand]))
        verify = record_top2_calls(matcher, lambda: lc.compute_transform(arena, kf_id, cand))
        for role, args in zip(("loop_bow_guided", "loop_sim3_growth_cur",
                               "loop_sim3_growth_cand", "loop_point_projection"),
                              bow[:1] + verify[:3]):
            sites.setdefault(role, (tag, args))
    if len(sites) != 4:
        fail(f"loop_stages: call sites recorded: {sorted(sites)}")
    calls = []
    for role, (tag, args) in sites.items():
        err, info = compare_top2(torch, mk, args)
        calls.append(dict(role=role, state=tag, M=args[0].shape[0], N=args[5].shape[0],
                          max_abs_err=err, path=info["path"], **time_top2(torch, mk, args),
                          **top2_bound(torch, mk, args)))
    tag, arena, kf_id, cand, lc = states[0]
    lc = copy.copy(lc)
    T = torch.eye(4, device=arena.kf_pose.device)
    loop_i, loop_j, loop_valid = lc._loop_edge(kf_id, cand)

    def graph():
        edges = pg_mod.build_edges(arena.kf_pose, arena.kf_valid, arena.kf_parent, arena.covis,
                                   loop_i, loop_j, T[None], loop_valid)
        return pg_mod.optimize(arena.kf_pose, arena.kf_valid, edges)

    def gba():
        return gba_mod.global_bundle_adjustment(arena, cfg, gate_outliers=True)

    ms = dict(compute_transform=wall_ms(torch, lambda: lc.compute_transform(arena, kf_id, cand),
                                        reps=3, warmup=1),
              pose_graph_optimize=wall_ms(torch, graph, reps=3, warmup=1),
              global_bundle_adjustment=wall_ms(torch, gba, reps=3, warmup=1))
    # the pose graph and the global BA wait for the card nowhere
    for name, fn in (("pose_graph.optimize", graph), ("global_bundle_adjustment", gba)):
        sites = sync_sites(torch, fn)
        if sites:
            fail(f"{name} synchronises with the card at {sites}")
    res = dict(phase="loop_stages", card=nvidia_smi_line(), state=tag, pair=[kf_id, cand],
               keyframes=int(arena.kf_valid.sum()), map_points=int(arena.pt_valid.sum()),
               gba_observations=int((arena.kf_obs >= 0).sum()), ms=ms, match_top2_calls=calls)
    emit(res)
    return res, calls


# ----------------------------------------------------------------------------
# the live segmenter (Mask R-CNN) and its detection kernels
# ----------------------------------------------------------------------------

SEG_FRAMES = 20
SEG_BLOCKS = (3, 4, 6, 3)      # ResNet50, MaskRCNN() defaults: FPN 256, 81 classes
SEG_SEED = 0
SEG_ATE_GUARD_M = 0.30         # the JAX live-segmenter driver test's gate
SEG_DET_KERNELS = ("nms_fixed", "roi_align", "paste_masks")
SEG_REPLACES = {"nms_fixed": "gdslam_tpu/models/maskrcnn.py:202",
                "roi_align": "gdslam_tpu/models/maskrcnn.py:222",
                "paste_masks": "gdslam_tpu/models/maskrcnn.py:744"}
SEG_NO_LIBRARY = ("no PyTorch call computes it: torchvision is not installed, and torch has "
                  "no fixed-budget NMS, per-box-level ROIAlign or mask paste")


def write_seg_weights(path: Path) -> dict:
    """The port's seeded ResNet50 weights (models/maskrcnn.init_variables,
    seed 0) written with its save_variables. Raw seeded heads give boxes
    pushed off the image and masks that cover up to 88% of a frame, on
    which no tracker holds; so, as the CPU tests edit theirs, the class
    head's kernel is scaled by 0.01 with bias[1] (person) raised by 6, the
    box head's deltas by 0.01 (boxes stay the proposals) and the person mask
    logit lowered by 6: 32 valid person detections a frame, masks over 0.5-
    2.5% of it (measured on the CPU on this scene)."""
    from gdslam_tpu_torch.models import maskrcnn
    t0 = time.perf_counter()
    flat = maskrcnn.init_variables(SEG_BLOCKS, SEG_SEED)
    flat["params/box_head/Dense_2/kernel"] *= np.float32(0.01)
    flat["params/box_head/Dense_2/bias"][1] += np.float32(6.0)
    flat["params/box_head/Dense_3/kernel"] *= np.float32(0.01)
    flat["params/mask_head/Conv_4/bias"][1] -= np.float32(6.0)
    path.parent.mkdir(parents=True, exist_ok=True)
    maskrcnn.save_variables(flat, str(path), meta={"blocks": list(SEG_BLOCKS),
                                                   "infer_hw": [240, 320]})
    return dict(leaves=len(flat), parameters=int(sum(a.size for a in flat.values())),
                file_mb=path.stat().st_size / 1e6, write_s=time.perf_counter() - t0)


def detect_calls(dk, fn) -> tuple[list, object]:
    """fn() with every detection wrapper recorded: [(name, args)] in call
    order, and fn's result."""
    calls, real = [], {n: getattr(dk, n) for n in SEG_DET_KERNELS}

    def rec(name):
        def call(*a, **k):
            calls.append((name, a, k))
            return real[name](*a, **k)
        call.launches = real[name].launches   # the wrapper counts on its module's name
        return call

    spies = {n: rec(n) for n in SEG_DET_KERNELS}
    for n, f in spies.items():
        setattr(dk, n, f)
    try:
        out = fn()
    finally:
        for n, f in real.items():
            f.launches = spies[n].launches
            setattr(dk, n, f)
    return calls, out


def detect_compare(torch, dk, name, a, k) -> dict:
    """The kernel against its plain version on one recorded call: exact
    indices (NMS), the largest difference (ROIAlign), the pixels that
    differ off and within the 1e-6 margin of the threshold (paste)."""
    got = getattr(dk, name)(*a, **k)
    want = getattr(dk, f"{name}_plain")(*a, **k)
    torch.cuda.synchronize()
    if name == "nms_fixed":
        return dict(shape=[a[0].shape[0], a[3]], exact=bool(torch.equal(got, want)),
                    max_abs_err=int((got != want).sum()), picked=int((got >= 0).sum()))
    if name == "roi_align":
        return dict(shape=[a[2].shape[0], a[3]], exact=bool(torch.equal(got, want)),
                    max_abs_err=float((got - want).abs().max()) if got.numel() else 0.0)
    det, hw = a[0], a[1]
    near = ((dk.paste_values(det, hw) - 0.5).abs() < 1e-6)[dk.paste_ok(det)].any(0)
    differ = got != want
    return dict(shape=[det["boxes"].shape[0], *hw], exact=bool(torch.equal(got, want)),
                max_abs_err=int((differ & ~near).sum()), within_margin=int((differ & near).sum()),
                pasting=int(dk.paste_ok(det).sum()), mask_px=int(got.sum()))


def detect_launch(torch, dk, name, a, k) -> tuple:
    """(C launch function, its arguments up to the device and stream, the
    tensors they point to) for one recorded call, built here with live
    tensors so that a CUDA graph can replay the launch."""
    lib = dk._library(name)
    if name == "nms_fixed":               # one C call issues both launches (mask, walk)
        boxes, scores, th, n_out = a
        out = torch.empty(n_out, dtype=torch.int32, device=boxes.device)
        scratch = torch.empty(dk.nms_scratch_words(boxes.shape[0]), dtype=torch.int32,
                              device=boxes.device)
        return lib.nms_fixed_launch, (boxes.data_ptr(), scores.data_ptr(), boxes.shape[0],
                                      float(np.float32(th)), n_out, out.data_ptr(),
                                      scratch.data_ptr()), (out, scratch)
    if name == "roi_align":
        flat, shapes, boxes, size = a
        boxes = boxes.contiguous()
        out = torch.empty((boxes.shape[0], size, size, flat.shape[1]), device=flat.device)
        return lib.roi_align_launch, (flat.data_ptr(), flat.shape[1], boxes.data_ptr(),
                                      boxes.shape[0], size, dk.roi_step(size),
                                      *(v for hw in shapes for v in hw),
                                      out.data_ptr(), *(None,) * 5), (out, boxes)
    det, (H, W) = a[0], a[1]
    out = torch.empty((H, W), dtype=torch.uint8, device=det["boxes"].device)
    return lib.paste_masks_launch, (det["boxes"].data_ptr(), det["classes"].data_ptr(),
                                    det["valid"].data_ptr(), det["masks"].data_ptr(),
                                    det["boxes"].shape[0], H, W, float(np.float32(0.5)),
                                    *dk.DYNAMIC_CLASS_WORDS, 1, out.data_ptr()), (out,)


def detect_bound(torch, dk, name, a, k) -> dict:
    """The least time the card could take for one call (H100 SXM peaks),
    counted from this call's data: bytes each input read once and each
    output written once (ROIAlign: the distinct feature rows its taps need),
    and float operations at the f32 rate outside the tensor cores."""
    if name == "nms_fixed":
        boxes, scores, th, n_out = a
        n = boxes.shape[0]
        steps = int((dk.nms_fixed_plain(boxes, scores, th, n_out) >= 0).sum()) + 1
        nbytes = n * 20 + n_out * 4
        ops = min(steps, n_out) * n * 16           # IoU ~12 flops, argmax ~4 per box and step
        extra = dict(dependent_steps=min(steps, n_out),
                     bound_note="latency: after the bitmask (N^2 IoUs in parallel), one "
                                "warp's walk of up to N / 32 dependent chunk decisions; "
                                "neither bytes nor operations")
    elif name == "roi_align":
        flat, shapes, boxes, size = a
        info, y0, x0, fy, fx = dk.roi_prologue(shapes, boxes, size)
        off, h, w = (info[:, i].long()[:, None, None] for i in range(3))
        rows = set()
        for dy in (0, 1):
            for dx in (0, 1):
                yi = torch.minimum((y0.long() + dy).clamp(min=0)[:, :, None], h - 1)
                xi = torch.minimum((x0.long() + dx).clamp(min=0)[:, None, :], w - 1)
                rows.update((off + yi * w + xi).flatten().tolist())
        C, R = flat.shape[1], boxes.shape[0]
        nbytes = len(rows) * C * 4 + R * 16 + R * size * size * C * 4
        ops = R * size * size * C * 11               # 8 multiplies, 3 adds per element
        extra = dict(distinct_tap_rows=len(rows))
    else:
        det, (H, W) = a[0], a[1]
        D = det["boxes"].shape[0]
        b = det["boxes"][:, :, None, None]
        ys = torch.arange(H, device=b.device, dtype=torch.float32)[None, :, None]
        xs = torch.arange(W, device=b.device, dtype=torch.float32)[None, None, :]
        inside = ((ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3]))
        pairs = int((inside & dk.paste_ok(det)[:, None, None]).sum())
        nbytes = D * (16 + 1 + 28 * 28 * 4) + H * W
        ops = H * W * D * 4 + pairs * 24              # box tests; two interp rows, 6 lerps
        extra = dict(pixel_box_pairs=pairs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                else "operations", bytes=nbytes, operations=ops, **extra)


def time_detect(torch, dk, name, a, k) -> dict:
    """ms through the wrapper, device ms (the C launch replayed from a CUDA
    graph), the plain version's ms and the bound, on one recorded call."""
    fn, cargs, keep = detect_launch(torch, dk, name, a, k)
    out = dict(ms=cuda_ms(torch, lambda: getattr(dk, name)(*a, **k), reps=100),
               device_ms=graph_ms(torch, fn, cargs),
               plain_ms=cuda_ms(torch, lambda: getattr(dk, f"{name}_plain")(*a, **k), reps=5,
                                windows=3),
               library_ms=None, **detect_bound(torch, dk, name, a, k))
    del keep
    return out


def graph_kernels(torch, fn) -> int:
    """The kernels one call of fn launches: the call captured into a CUDA
    graph (after a warm-up call), its kernel nodes counted through the
    driver. Exact, where a short torch.profiler window can miss a session's
    first kernels."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del g
    return sum(k == 0 for k in kinds)        # CU_GRAPH_NODE_TYPE_KERNEL


def one_launch(torch, wrapper, fn) -> dict:
    """One wrapper call: its launch count's step and the kernels it launches
    (graph_kernels: one kernel, no small PyTorch ops)."""
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    step = wrapper.launches - before
    kernels = graph_kernels(torch, fn)
    return dict(count_step=step, kernels=kernels, ok=step == 1 and kernels == 1)


def check_detect_edges(torch, dk, roi_calls, dev) -> dict:
    """roi_align and paste_masks beyond the recorded calls: ROIAlign on the
    recorded features at both call sizes on roi_boundary_boxes (with boxes
    off the image and degenerate) and on the recorded boxes, the crop and the prologue the kernel writes out for the
    gradient bitwise against roi_align_plain and roi_prologue; the paste on
    paste_adversarial_det (3 seeds, 32 detections, with and without the
    class test) bitwise against paste_masks_plain and the tile-list mirror;
    each wrapper one launch a call (its count, graph_kernels)."""
    from gdslam_tpu_torch.ops.detect_cases import paste_adversarial_det, roi_boundary_boxes
    out = dict(roi_align=[], paste_masks=[])
    flat, shapes = roi_calls[0][0], roi_calls[0][1]
    off_image = [[-80, -90, 20, 30], [230, 300, 260, 340], [5, 5, 5, 5], [50, 60, 40, 50],
                 [0.25, 0.25, 0.75, 0.75], [-1000, -1000, 2000, 2000]]
    boundary = torch.from_numpy(np.concatenate(
        [roi_boundary_boxes(), np.asarray(off_image, np.float32)])).to(dev)
    for (_, _, rec_boxes, size) in roi_calls:
        for label, boxes in (("recorded", rec_boxes), ("boundary", boundary)):
            got, pro = dk._roi_align(flat, shapes, boxes, size, with_prologue=True)
            want, want_pro = dk.roi_align_plain(flat, shapes, boxes, size), \
                dk.roi_prologue(shapes, boxes, size)
            torch.cuda.synchronize()
            levels = torch.unique(dk.roi_levels(boxes)).tolist()
            out["roi_align"].append(dict(
                boxes=label, out=size, n=int(boxes.shape[0]), levels=levels,
                exact=bool(torch.equal(got, want)),
                prologue_exact=all(bool(torch.equal(a, b)) for a, b in zip(pro, want_pro))))
    out["roi_align_launch"] = one_launch(torch, dk.roi_align, lambda: dk.roi_align(
        flat, shapes, roi_calls[0][2], roi_calls[0][3]))
    for seed in range(3):
        det = {k: torch.from_numpy(v).to(dev) for k, v in paste_adversarial_det(
            np.random.default_rng(seed), 32, 480, 640).items()}
        for dyn in (True, False):
            got = dk.paste_masks(det, (480, 640), dyn)
            want = dk.paste_masks_plain(det, (480, 640), dyn)
            tiled = dk.paste_masks_tiled_plain(det, (480, 640), dyn)
            torch.cuda.synchronize()
            out["paste_masks"].append(dict(seed=seed, dynamic_only=dyn, exact=bool(
                torch.equal(got, want)), tiled_mirror_exact=bool(torch.equal(tiled, want)),
                differing=int((got != want).sum()), mask_px=int(want.sum())))
    out["paste_masks_launch"] = one_launch(torch, dk.paste_masks,
                                           lambda: dk.paste_masks(det, (480, 640)))
    bad = [c for c in out["roi_align"] if not (c["exact"] and c["prologue_exact"])] + \
        [c for c in out["paste_masks"] if not (c["exact"] and c["tiled_mirror_exact"])]
    if bad or not (out["roi_align_launch"]["ok"] and out["paste_masks_launch"]["ok"]):
        fail(f"seg: roi_align / paste_masks differ from their plain twins or take more than "
             f"one launch: {bad}, {out['roi_align_launch']}, {out['paste_masks_launch']}")
    return out


def check_detect_kernels(torch, dk, seg, rgb_dev, old=None) -> dict:
    """Each detection kernel against its plain version, and timed, on the
    segmenter's real intermediates of one frame: at the main path's score
    threshold (0.7) and at 0, where the detection NMS, the 14 x 14 ROIAlign
    and the paste see 32 valid detections. With `old` (OldDetectKernels),
    the parent's NMS timed beside the new one (ab_times)."""
    out = {}
    for label, th in (("score_th_0.7", 0.7), ("score_th_0", 0.0)):
        calls, _ = detect_calls(dk, lambda: seg.segment(rgb_dev, th))
        if [c[0] for c in calls] != ["nms_fixed", "roi_align", "nms_fixed", "roi_align",
                                     "paste_masks"]:
            fail(f"seg: the segmenter's detection calls were {[c[0] for c in calls]}")
        sites = []
        for (name, a, k), role in zip(calls, ("proposals", "box_head", "detections",
                                              "mask_head", "paste")):
            rec = dict(name=name, role=role, **detect_compare(torch, dk, name, a, k))
            if rec["max_abs_err"] != 0:
                fail(f"seg: {name} ({role}, {label}) differs from its plain version: {rec}")
            rec.update(time_detect(torch, dk, name, a, k))
            if old is not None and old.has(name):
                rec["ab"] = ab_times(torch, lambda: old.launch(name, *a),
                                     lambda: detect_launch(torch, dk, name, a, k),
                                     lambda: old.call(name, *a),
                                     lambda: getattr(dk, name)(*a, **k),
                                     getattr(dk, f"{name}_plain")(*a, **k))
            sites.append(rec)
        out[label] = sites
    if out["score_th_0"][4]["pasting"] < 32:
        fail(f"seg: score_th 0 pasted {out['score_th_0'][4]['pasting']} detections, not 32")
    out["edges"] = check_detect_edges(torch, dk, [c[1] for c in calls if c[0] == "roi_align"],
                                      rgb_dev.device)
    return out


def seg_run(torch, seg, frames_rgb) -> list:
    """The segmenter's masks and detections on host frames."""
    outs = []
    for rgb in frames_rgb:
        t = torch.from_numpy(rgb).to(seg.device)
        outs.append(dict(mask=seg.segment(t).cpu().numpy(),
                         **{k: v.cpu().numpy() for k, v in seg.detect(t).items()}))
    return outs


def phase_seg(torch, mk, cfg, frames, System, synthetic, metrics, dev, weights: Path,
              weights_info: dict, old=None) -> tuple[dict, list]:
    """The live segmenter on the card at full width, as rgbd_tum's argc==6
    mode runs it: build_segmenter("flax:<file>") on the port's seeded
    ResNet50 weights (480 x 640 frames molded to 240 x 320; pre_nms 1024,
    post_nms 128, max_det 32), SEG_FRAMES dynamic frames through
    SegmentDynObject (no cache: every frame runs the net) and
    System.track_rgbd(use_geometry=True), pipelined as the driver runs it.
    Guards: every detection kernel launched on this run, the ATE gate of
    the JAX driver test, the tracked frames. Then the segmenter's time
    through the host and on the device (profiler), the backbone's share,
    and each detection kernel against its plain version and timed (with
    `old`, OldDetectKernels, the parent's NMS beside it)."""
    from gdslam_tpu_torch.masking.masknet import SegmentDynObject
    from gdslam_tpu_torch.models import maskrcnn
    from gdslam_tpu_torch.ops import detect_kernels as dk
    cam = cfg.camera
    t0 = time.perf_counter()
    seg = maskrcnn.build_segmenter(f"flax:{weights}", image_hw=(cam.height, cam.width),
                                   device=dev)
    bridge = SegmentDynObject(seg)                # its warm-up call: a zero frame
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rgbs = [fr.rgb.cpu().numpy().astype(np.uint8) for fr in frames[:SEG_FRAMES]]
    depths = [fr.depth.cpu().numpy() for fr in frames[:SEG_FRAMES]]
    slam = System(cfg, pipeline=True, device=dev)
    reset_launch_counts(mk)
    dk.reset_launch_counts()
    seg_ms, frame_ms, cover = [], [], []
    for i, (rgb, depth) in enumerate(zip(rgbs, depths)):
        t0 = time.perf_counter()
        dyn = bridge.get_segmentation(rgb)
        t1 = time.perf_counter()
        slam.track_rgbd(rgb, depth, 1.0 - dyn, i / 30.0, use_geometry=True)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        seg_ms.append((t1 - t0) * 1e3)
        cover.append(float(dyn.mean()))
    slam.shutdown()
    record_launches("seg")
    launches = dict(nms_fixed=dk.nms_fixed.launches, roi_align=dk.roi_align.launches,
                    paste_masks=dk.paste_masks.launches, match_top2=mk.match_top2.launches)
    if min(launches.values()) < 1:
        fail(f"seg: a kernel of the path was not launched: {launches}")
    traj = slam.tracker.camera_trajectory()
    T0inv = np.linalg.inv(frames[0].T_wc.cpu().numpy())
    est = np.stack([T[:3, 3] for _, T in traj])
    gt = np.stack([(T0inv @ frames[round(ts * 30.0)].T_wc.cpu().numpy())[:3, 3]
                   for ts, _ in traj])
    ate = metrics.ate_rmse(est, gt)
    if not (len(traj) >= SEG_FRAMES - 3 and ate < SEG_ATE_GUARD_M):
        fail(f"seg: {len(traj)} frames tracked, ATE {ate} m (gate {SEG_ATE_GUARD_M} m)")

    rgb_dev = torch.from_numpy(rgbs[-1]).to(dev)
    im = maskrcnn.mold(rgb_dev, seg.infer_hw).contiguous()
    whole = profile_window(torch, lambda: seg.segment(rgb_dev), 1)
    with torch.no_grad():
        backbone = profile_window(torch, lambda: seg.model.features(im), 1)
    res = dict(phase="seg", frames=SEG_FRAMES, width=cam.width, height=cam.height,
               infer_hw=list(seg.infer_hw), blocks=list(seg.model.blocks),
               pre_nms=seg.model.pre_nms, post_nms=seg.model.post_nms,
               max_det=seg.model.max_det, weights=weights_info, build_s=build_s,
               ate_m=ate, tracked=len(traj), keyframes=slam.keyframe_count,
               mask_cover_mean=float(np.mean(cover)), mask_cover_max=float(np.max(cover)),
               segmenter_ms_median=statistics.median(seg_ms[2:]),
               frame_ms_median=statistics.median(frame_ms[2:]),
               segment_ms_device_input=wall_ms(torch, lambda: seg.segment(rgb_dev), reps=10),
               segment_device_busy_ms=whole["device_busy_ms"],
               segment_device_ops=whole["device_ops"],
               segment_device_idle_share=whole["device_idle_share"],
               segment_top_device_ms=whole["top_device_ms"],
               backbone_device_busy_ms=backbone["device_busy_ms"],
               backbone_share_of_device=backbone["device_busy_ms"] / whole["device_busy_ms"],
               launches=launches,
               launches_per_frame={k: v / SEG_FRAMES for k, v in launches.items()})
    res["kernels"] = check_detect_kernels(torch, dk, seg, rgb_dev, old)
    res["card"] = nvidia_smi_line()
    emit(res)
    return res, rgbs[:5]


def seg_determinism(torch, weights: Path, dev, rgbs, cam) -> dict:
    """Two segmenters built from the same file on the same frames: masks and
    every detection output bitwise equal."""
    from gdslam_tpu_torch.models import maskrcnn
    runs = [seg_run(torch, maskrcnn.build_segmenter(f"flax:{weights}", (cam.height, cam.width),
                                                    dev), rgbs) for _ in range(2)]
    return {k: all(np.array_equal(a[k], b[k]) for a, b in zip(*runs)) for k in runs[0][0]}


# ----------------------------------------------------------------------------
# Mask R-CNN training: seg_train (full width) and seg_toy (the JAX e2e fit)
# ----------------------------------------------------------------------------

TRAIN_HW = (240, 320)          # default_infer_hw of a 480 x 640 frame
TRAIN_FRAMES = (100, 104, 108, 112)   # dynamic frames where the sphere is in view
TRAIN_STEPS = 20
TRAIN_BATCH = 2
TRAIN_LR = 1e-2                # tools/seg_smoke.py --lr-sweep: at 1e-3 3 of 20 steps have a
                               # positive ROI; 1e-2 and 2e-2 give the most (15), 1e-2 the calmer
TRAIN_ROIS = (64, 0.33)        # n_rois, pos_ratio: train_losses_sampled's defaults
TOY_HW = (120, 160)
TOY_FRAMES = 14
TOY_STEPS = 150
TOY_LR = 2e-3
TOY_GATES = dict(recall=0.3, ate_m=0.30)   # tests/test_live_segmenter_e2e.py's
TOY_ROWS_GUARD = 8             # the rows the card's (bitwise repeatable) toy fit gives
BACKWARD_REPLACES = "gdslam_tpu/models/maskrcnn.py:222"
PROBE_TIMED = 5                # steps past the fit timed one by one
PROBE_RECORD = 6               # steps past the fit searched for non-zero cotangents


def person_targets(rgbs, dyn_masks, min_px: int) -> dict:
    """The renderer's dynamic object as one 'person' (class 1) per image,
    its box the mask's extent (+1 on the far sides), as the JAX e2e test
    builds its fit data; images whose object covers fewer than min_px
    pixels are left out."""
    out = dict(images=[], boxes=[], classes=[], masks=[], valids=[])
    for rgb, dyn in zip(rgbs, dyn_masks):
        ys, xs = np.nonzero(dyn)
        if len(ys) < min_px:
            continue
        out["images"].append(rgb.astype(np.float32))
        out["boxes"].append([[float(ys.min()), float(xs.min()), float(ys.max() + 1),
                              float(xs.max() + 1)]])
        out["classes"].append([1])
        out["masks"].append(dyn.astype(np.float32))
        out["valids"].append([True])
    dtypes = dict(images=np.float32, boxes=np.float32, classes=np.int32, masks=np.float32,
                  valids=bool)
    return {k: np.asarray(v, dtypes[k]) for k, v in out.items()}


def train_data_full_width(torch, dyn_frames) -> dict:
    """TRAIN_FRAMES of the dynamic scene molded to 240 x 320 as the
    segmenter molds them (antialiased bilinear), their dyn_mask sampled at
    the same size (every second pixel)."""
    from gdslam_tpu_torch.models import maskrcnn
    rgbs, dyns = [], []
    for i in TRAIN_FRAMES:
        fr = dyn_frames[i]
        rgbs.append(maskrcnn.mold(fr.rgb, TRAIN_HW).clamp(0, 255).cpu().numpy())
        dyns.append(fr.dyn_mask[::2, ::2].cpu().numpy())
    return person_targets(rgbs, dyns, 100)


def seg_train_run(torch, dev, data) -> tuple:
    """One full-width fit: MaskRCNN() at 240 x 320 on the port's seeded
    init_variables, calibrate_batch_stats (2 passes), then train_sampled.
    Returns (trained variables, per-step losses, per-step named losses,
    the fit's wall seconds, the trained model)."""
    from gdslam_tpu_torch.models import maskrcnn
    model = maskrcnn.MaskRCNN(image_hw=TRAIN_HW).eval().to(
        device=dev, memory_format=torch.channels_last)
    maskrcnn.set_variables(model, maskrcnn.init_variables(SEG_BLOCKS, SEG_SEED))
    maskrcnn.calibrate_batch_stats(model, data["images"], passes=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, losses, comps = maskrcnn.train_sampled(
        model, maskrcnn.variables_to_numpy(model), data["images"], data["boxes"],
        data["classes"], data["masks"], data["valids"], steps=TRAIN_STEPS, lr=TRAIN_LR,
        batch=TRAIN_BATCH, with_components=True, calibrate=False)
    torch.cuda.synchronize()
    return trained, losses, comps, time.perf_counter() - t0, model


def roi_backward_nodes(loss) -> list:
    """The ROIAlign nodes (detect_kernels._RoiAlignGrad) of loss's
    autograd graph."""
    seen, todo, nodes = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_RoiAlignGradBackward":
            nodes.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return nodes


class TrainProbe:
    """More steps of train_sampled's kind on the trained model (the
    images of its minibatches in its order, SGD with momentum 0.9 on a
    fresh trace, under exact cuDNN), outside the fit: timed one by one,
    recording the ROIAlign backward's calls, or profiled."""

    def __init__(self, torch, model, data):
        from gdslam_tpu_torch.models import maskrcnn
        self.torch, self.model, self.mr = torch, model, maskrcnn
        self.params = maskrcnn._train_params(model)
        self.opt = maskrcnn._SgdMomentum(self.params, TRAIN_LR, 0.9)
        keys = ("images", "boxes", "classes", "masks", "valids")
        dev = model.anchors.device
        self.images = [tuple(torch.as_tensor(data[k][i], device=dev) for k in keys)
                       for i in range(data["images"].shape[0])]
        self.order = np.random.default_rng(0).permutation(len(self.images))
        self.k = TRAIN_STEPS

    def step(self, calls: list | None = None) -> float:
        """One step; with `calls`, each ROIAlign backward call of it is
        appended as (cotangent, level shapes, boxes) through a pre-hook on
        its autograd node. Returns n_pos_rois, the mean over the minibatch."""
        sel = self.order[np.arange(self.k * TRAIN_BATCH, (self.k + 1) * TRAIN_BATCH)
                         % len(self.images)]
        self.k += 1
        with self.mr.exact_cudnn():
            per = [self.model.train_losses_sampled(*self.images[i]) for i in sel]
            if calls is not None:
                for c in per:
                    for node in roi_backward_nodes(c["total"]):
                        node.register_prehook(lambda go, node=node: calls.append(
                            (go[0].detach().contiguous().clone(), node.shapes,
                             node.saved_tensors[0].clone())))
            total = self.torch.stack([c["total"] for c in per]).mean()
            self.mr._apply_step(self.model, self.params, self.opt, total)
        return float(sum(c["n_pos_rois"] for c in per)) / len(per)

    def timed(self, n: int) -> list:
        """n steps, each its synchronised wall ms."""
        out = []
        for _ in range(n):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.step()
            self.torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def recorded(self, max_steps: int) -> tuple[dict, list]:
        """Steps until one has recorded, at both call sizes (7 and 14), a
        call whose cotangent is not all zero (the mask head's is zero where
        the image has no positive ROI). Returns ({size: that call}, the
        steps' n_pos_rois)."""
        found, n_pos = {}, []
        for _ in range(max_steps):
            calls = []
            n_pos.append(self.step(calls))
            for grad, shapes, boxes in calls:
                if bool(grad.abs().amax() > 0):
                    found.setdefault(grad.shape[1], (grad, shapes, boxes))
            if sorted(found) == [7, 14]:
                break
        return found, n_pos


def backward_launch(torch, dk, grad, shapes, boxes) -> tuple:
    """(C launch function, its arguments up to the device and stream, the
    tensors they point to) of one backward call on the forward's prologue,
    for a CUDA graph."""
    lib = dk._library("roi_align_backward")
    R, o, _, C = grad.shape
    pro = dk.roi_prologue(shapes, boxes, o)
    out = torch.empty((sum(a * b for a, b in shapes), C), device=grad.device)
    return lib.roi_align_backward_launch, (grad.data_ptr(), C, R, o,
                                          *(t.data_ptr() for t in pro),
                                          *(v for hw in shapes for v in hw),
                                          out.data_ptr()), (out, *pro)


def build_parent_sources(src_dir: Path, sigs: dict) -> tuple[dict, dict]:
    """Build the earlier kernel sources `src_dir` holds, whichever of sigs'
    names ({name: its C entry point's argument kinds, p/i/f/u; or, for a
    library of several entry points, the function that declares them and
    may return a stand-in for the library}) it has, with the current flags,
    every nvcc started at once: (ptxas, fns), what ptxas reports for each
    and its `<name>_launch` entry point (or the whole library) loaded by
    ctypes."""
    from gdslam_tpu_torch.ops import cuda_build
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {}
    for n in sigs:
        if not (src_dir / f"{n}.cu").exists():
            continue
        src, nvcc = str(src_dir / f"{n}.cu"), cuda_build.nvcc(n)
        procs[n] = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
                    for cmd in ([nvcc, *cuda_build.NVCC_FLAGS, "-o",
                                 str(src_dir / f"lib{n}_old.so"), src],
                                [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
                                 str(src_dir / f"{n}_old.cubin"), src])]
    if not procs:
        fail(f"ab: none of {sorted(sigs)} has an earlier source in {src_dir}")
    kinds = dict(p=ctypes.c_void_p, i=ctypes.c_int, f=ctypes.c_float, u=ctypes.c_uint)
    ptxas, fns = {}, {}
    for n, (so, report) in procs.items():
        errs = [proc.communicate(timeout=600)[1] for proc in (so, report)]
        if so.returncode or report.returncode:
            fail(f"ab: the parent's {n} did not build:\n{errs[0]}{errs[1]}")
        ptxas[n] = ptxas_lines(errs[1])
        lib = ctypes.CDLL(str(src_dir / f"lib{n}_old.so"))
        if callable(sigs[n]):
            fns[n] = sigs[n](lib) or lib
            continue
        fn = getattr(lib, f"{n}_launch")
        fn.argtypes = [kinds[c] for c in sigs[n].replace(" ", "")]
        fn.restype = ctypes.c_int
        fns[n] = fn
    return ptxas, fns


class OldDetectKernels:
    """Earlier versions of the detection kernels, whichever of nms_fixed.cu,
    roi_align_backward.cu (as of commit 4f0bef9: one CTA of greedy steps;
    one warp per run of sorted targets), roi_align.cu and paste_masks.cu (as
    of commit 57509e6: the prologue in PyTorch; every mask staged by every
    tile, the class test in PyTorch) `src_dir` holds, built there with the
    same flags, behind their earlier wrappers (the NMS one without its
    checks; the backward one with its sorted lists, roi_backward_prologue,
    and a zero-filled output; ROIAlign's with roi_prologue's small ops; the
    paste's with paste_ok's isin and cast), to be timed beside the current
    kernels in one process. `ptxas` holds what ptxas reports for each."""

    SIGS = {"nms_fixed": "pp ifi p i p", "roi_align_backward": "pi pppp ii p i p",
            "roi_align": "pi ppppp ii p i p", "paste_masks": "ppp iii f p i p"}

    def __init__(self, torch, dk, src_dir: Path):
        self.torch, self.dk = torch, dk
        self.ptxas, self.fns = build_parent_sources(src_dir, self.SIGS)

    def has(self, name: str) -> bool:
        return name in self.fns

    def _run(self, fn, a) -> None:
        torch = self.torch
        err = fn(*a, torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"ab: a parent kernel's launch failed with CUDA error {err}")

    def launch(self, name, *a) -> tuple:
        """(C launch function, its arguments, the tensors they point to) of
        the earlier wrapper's call on these arguments."""
        torch, dk, fn = self.torch, self.dk, self.fns[name]
        if name == "nms_fixed":
            boxes, scores, th, n_out = a
            out = torch.empty(n_out, dtype=torch.int32, device=boxes.device)
            return fn, (boxes.data_ptr(), scores.data_ptr(), boxes.shape[0],
                        float(np.float32(th)), n_out, out.data_ptr()), (out,)
        if name == "roi_align_backward":
            grad, shapes, boxes, *prologue = a
            R, o, _, C = grad.shape
            target, order, fa, fb = dk.roi_backward_prologue(
                prologue[0] if prologue and prologue[0] is not None
                else dk.roi_prologue(shapes, boxes, o))
            out = torch.zeros((sum(x * y for x, y in shapes), C), device=grad.device)
            return fn, (grad.data_ptr(), C, target.data_ptr(), order.data_ptr(),
                        fa.data_ptr(), fb.data_ptr(), target.shape[0], R * o * o,
                        out.data_ptr()), (out, target, order, fa, fb)
        if name == "roi_align":
            flat, shapes, boxes, size = a
            pro = dk.roi_prologue(shapes, boxes, size)
            out = torch.empty((boxes.shape[0], size, size, flat.shape[1]), device=flat.device)
            return fn, (flat.data_ptr(), flat.shape[1], *(t.data_ptr() for t in pro),
                        boxes.shape[0], size, out.data_ptr()), (out, *pro)
        det, (H, W) = a[0], a[1]
        ok = dk.paste_ok(det).to(torch.uint8)
        out = torch.empty((H, W), dtype=torch.uint8, device=ok.device)
        return fn, (det["boxes"].data_ptr(), ok.data_ptr(), det["masks"].data_ptr(),
                    det["boxes"].shape[0], H, W, float(np.float32(0.5)), out.data_ptr()), \
            (out, ok)

    def call(self, name, *a):
        fn, args, keep = self.launch(name, *a)
        self._run(fn, args)
        return keep[0]


class _ParentOrb:
    """An earlier orb_extract library (4a0d7fd or f85edee) behind the current
    wrappers: its gaussian_blur7_launch takes no level shapes (the current
    call's arguments 5-7, n_levels, hs and ws, are dropped); its other entry
    points have the current signatures."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def gaussian_blur7_launch(self, *a):
        return self.lib.gaussian_blur7_launch(*a[:5], *a[8:])


def _declare_orb(lib):
    """Declare an earlier orb_extract library's entry points: as they are
    when its gaussian_blur7_launch takes the level shapes (its source, beside
    the library, names n_levels there), else behind _ParentOrb."""
    from gdslam_tpu_torch.ops import orb_kernel
    orb_kernel._declare(lib)
    src = (Path(lib._name).parent / "orb_extract.cu").read_text()
    if re.search(r"gaussian_blur7_launch\([^)]*n_levels", src):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gaussian_blur7_launch.argtypes = [p, p, i, i, i, p, i, p]
    return _ParentOrb(lib)


class ParentKernels:
    """Earlier versions of stereo_match.cu and categorical_draw.cu (as of
    commit 6b10eba: one warp per left keypoint striding over every right
    keypoint, lanes 0-10 summing the SADs from device memory; one warp a
    row, four rows a CTA) and of orb_extract.cu (as of commit 4a0d7fd: the
    blur a CTA per 32 x 16 tile of every plane, both passes from shared
    memory; the descriptor a warp per keypoint reading device memory),
    whichever `src_dir` holds, built there with the same flags, behind the
    current wrappers: inside `call`, cuda_build's cache holds them in place
    of the current libraries, each C entry point taking the arguments its
    earlier version took (old_args drops the new ones: stereo's bucket rows
    and scratch; _ParentOrb the blur's level shapes, the rest of
    orb_extract's signatures unchanged). So the wrappers, their counts and
    every caller run unchanged on the parents' kernels. `ptxas` holds what
    ptxas reports for each."""

    SIGS = {"stereo_match": "ppppippppipppiiffppip", "categorical_draw": "piiuupppip",
            "orb_extract": _declare_orb}
    NEW_ARGS = {"stereo_match": (17, 19)}

    def __init__(self, torch, src_dir: Path):
        self.ptxas, self.fns = build_parent_sources(src_dir, dict(self.SIGS))

    def old_args(self, name: str, a: tuple) -> tuple:
        """A current launch's arguments (device and stream included or not)
        as the earlier entry point takes them."""
        lo, hi = self.NEW_ARGS.get(name, (0, 0))
        return tuple(a[:lo]) + tuple(a[hi:])

    def call(self, fn):
        """fn() with the parents' kernels behind the wrappers."""
        from gdslam_tpu_torch.ops import cuda_build
        saved = {n: cuda_build._libs.get(n) for n in self.fns}
        for n, old in self.fns.items():
            cuda_build._libs[n] = old if not callable(old) else type(
                "ParentLibrary", (), {f"{n}_launch": staticmethod(
                    lambda *a, n=n, old=old: old(*self.old_args(n, a)))})
        try:
            return fn()
        finally:
            for n, lib in saved.items():
                if lib is None:
                    cuda_build._libs.pop(n, None)
                else:
                    cuda_build._libs[n] = lib


def graph_call_ms(torch, fn, calls: int = 10) -> float:
    """Device time per call of everything a Python call launches (its
    PyTorch work included), `calls` of them captured into one CUDA graph and
    replayed; None where the call cannot be captured."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    except RuntimeError:
        return None
    return cuda_ms(torch, g.replay, reps=20) / calls


def ab_times(torch, old_launch, new_launch, old_call, new_call, want) -> dict:
    """The parent's kernel beside the new one on one call: device ms of the
    C launch from CUDA graphs in the order parent, new, new, parent; device
    ms of everything each wrapper launches (its PyTorch work too: the
    parent's sort and zero-fill), from graphs, parent then new; ms through
    each wrapper; both outputs bitwise against the plain twin's `want`."""
    (fo, ao, ko), (fn, an, kn) = old_launch(), new_launch()
    dev = [graph_ms(torch, fo, ao), graph_ms(torch, fn, an), graph_ms(torch, fn, an),
           graph_ms(torch, fo, ao)]
    got_old, got_new = old_call(), new_call()
    torch.cuda.synchronize()
    tup = lambda x: x if isinstance(x, tuple) else (x,)           # noqa: E731
    same = lambda x: all(differing(torch, g, w) == 0              # noqa: E731
                         for g, w in zip(tup(x), tup(want)))
    out = dict(old_device_ms=[dev[0], dev[3]], new_device_ms=[dev[1], dev[2]],
               old_wrapper_device_ms=graph_call_ms(torch, old_call),
               new_wrapper_device_ms=graph_call_ms(torch, new_call),
               old_ms=cuda_ms(torch, old_call, reps=50), new_ms=cuda_ms(torch, new_call, reps=50),
               old_exact=same(got_old), new_exact=same(got_new))
    del ko, kn
    if not (out["old_exact"] and out["new_exact"]):
        fail(f"ab: a kernel differs from its plain twin: {out}")
    return out


def check_backward_kernel(torch, dk, calls, old=None) -> list:
    """The ROIAlign backward kernel at the training call shapes (the box
    head's [64, 7, 7, 256] and the mask head's [64, 14, 14, 256]), on
    cotangents the training graph gave it (none all zero) and on a seeded
    normal cotangent with the same boxes, which reaches every box's taps:
    bitwise equal to its plain twin, twice in a row equal, timed through
    the wrapper (given the forward's prologue, as autograd calls it, and
    from the boxes), on the device alone (the C launch replayed from a
    CUDA graph) and as the plain twin, against its bound: the cotangent and
    the forward's prologue read once, the whole gradient written once, over
    the card's memory rate. With `old` (OldDetectKernels), the parent's
    kernel timed beside it (ab_times)."""
    sites = []
    gen = torch.Generator(device="cuda").manual_seed(SEG_SEED)
    for grad, shapes, boxes in calls:
        noise = torch.randn(grad.shape, generator=gen, device=grad.device)
        a = dk.roi_align_backward(grad, shapes, boxes)
        b = dk.roi_align_backward(grad, shapes, boxes)
        want = dk.roi_align_backward_plain(grad, shapes, boxes)
        a_noise = dk.roi_align_backward(noise, shapes, boxes)
        want_noise = dk.roi_align_backward_plain(noise, shapes, boxes)
        torch.cuda.synchronize()
        R, o, _, C = grad.shape
        target = dk.roi_backward_prologue(dk.roi_prologue(shapes, boxes, o))[0]
        rows = int(torch.unique(target).numel())
        n = target.numel()
        S = sum(a * b for a, b in shapes)
        nbytes = grad.numel() * 4 + S * C * 4 + R * (12 + o * 16)
        ops = n * C * 3                                  # two products and a sum
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        pro = dk.roi_prologue(shapes, boxes, o)
        # what the forward kernel hands the backward under autograd
        kpro = dk._roi_align(torch.zeros((S, 4), device=grad.device), shapes, boxes, o,
                             with_prologue=True)[1]
        a_kpro = dk.roi_align_backward(grad, shapes, boxes, kpro)
        torch.cuda.synchronize()
        fn, cargs, keep = backward_launch(torch, dk, grad, shapes, boxes)
        rec = dict(shape=list(grad.shape),
                   cotangent_rows_nonzero=int((grad.reshape(R, -1).abs().amax(1) > 0).sum()),
                   gradient_rows_nonzero=int((a.abs().amax(1) > 0).sum()),
                   exact=bool(torch.equal(a, want)), repeatable=bool(torch.equal(a, b)),
                   exact_on_noise=bool(torch.equal(a_noise, want_noise)),
                   forward_prologue_exact=all(bool(torch.equal(x, y)) for x, y in zip(kpro, pro)),
                   exact_on_forward_prologue=bool(torch.equal(a_kpro, want)),
                   max_abs_err=max(float((a - want).abs().max()),
                                   float((a_noise - want_noise).abs().max())),
                   contributions=n, target_rows=rows,
                   longest_run=int(torch.unique_consecutive(target,
                                                            return_counts=True)[1].max()),
                   ms=cuda_ms(torch, lambda: dk.roi_align_backward(grad, shapes, boxes, pro),
                              reps=50),
                   ms_prologue_from_boxes=cuda_ms(
                       torch, lambda: dk.roi_align_backward(grad, shapes, boxes), reps=50),
                   device_ms=graph_ms(torch, fn, cargs),
                   plain_ms=cuda_ms(torch, lambda: dk.roi_align_backward_plain(grad, shapes,
                                                                                 boxes),
                                    reps=2, windows=3),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, operations=ops, library_ms=None)
        del keep
        if old is not None and old.has("roi_align_backward"):
            rec["ab"] = ab_times(
                torch, lambda: old.launch("roi_align_backward", grad, shapes, boxes, pro),
                lambda: backward_launch(torch, dk, grad, shapes, boxes),
                lambda: old.call("roi_align_backward", grad, shapes, boxes, pro),
                lambda: dk.roi_align_backward(grad, shapes, boxes, pro), want)
        if not (rec["cotangent_rows_nonzero"] and rec["gradient_rows_nonzero"]):
            fail(f"seg_train: roi_align_backward at {rec['shape']} was checked on a zero "
                 f"cotangent or gave a zero gradient: {rec}")
        if not (rec["exact"] and rec["repeatable"] and rec["exact_on_noise"]
                and rec["forward_prologue_exact"] and rec["exact_on_forward_prologue"]):
            fail(f"seg_train: roi_align_backward at {rec['shape']} differs from its plain twin "
                 f"or from itself: {rec}")
        sites.append(rec)
    return sites


def phase_seg_train(torch, dev, dyn_frames, old=None) -> tuple[dict, dict, dict]:
    """Mask R-CNN training at full width: MaskRCNN() (ResNet50-FPN, 81
    classes, pre/post NMS 1024/128, 32 detections) at 240 x 320 on the
    renderer's dynamic object as a person, seeded weights, calibrated
    BatchNorm statistics, TRAIN_STEPS steps of train_sampled (batch 2,
    64 ROIs at a positive ratio of 0.33, clipped SGD with momentum). Guards:
    every named loss finite at every step, the last total below the first,
    every kernel of the path launched (nms_fixed and roi_align forward,
    roi_align_backward); the backward kernel bitwise against its plain twin
    and repeatable at both call shapes, on cotangents recorded from steps
    past the fit. Prints the fit's ms per step, the median of
    PROBE_TIMED more steps timed one by one, the fit's peak device memory
    above what earlier phases hold, the losses and positive ROIs per step,
    and a profile of one more step. With `old` (OldDetectKernels), the
    parent's backward kernel timed beside the new one."""
    from gdslam_tpu_torch.ops import detect_kernels as dk
    data = train_data_full_width(torch, dyn_frames)
    if data["images"].shape[0] < TRAIN_BATCH:
        fail(f"seg_train: the sphere is in view on {data['images'].shape[0]} frames")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()         # earlier phases' tensors still alive
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    trained, losses, comps, train_s, model = seg_train_run(torch, dev, data)
    fit_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in dk.WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, c in enumerate(comps) for k, v in c.items() if not np.isfinite(v)]
    if bad or not losses[-1] < losses[0]:
        fail(f"seg_train: losses not finite ({bad[:4]}) or not falling: {losses}")
    if min(launches["nms_fixed"], launches["roi_align"], launches["roi_align_backward"]) < 1:
        fail(f"seg_train: a kernel of the path was not launched: {launches}")
    probe = TrainProbe(torch, model, data)
    step_ms = probe.timed(PROBE_TIMED)
    found, probe_pos = probe.recorded(PROBE_RECORD)
    if sorted(found) != [7, 14]:
        fail(f"seg_train: no step of {PROBE_RECORD} past the fit gave a non-zero cotangent at "
             f"both call sizes (found {sorted(found)}, positive ROIs {probe_pos})")
    sites = check_backward_kernel(torch, dk, [found[7], found[14]], old)
    prof = profile_window(torch, probe.step, 1)
    n_pos = [c["n_pos_rois"] for c in comps]
    res = dict(phase="seg_train", image_hw=list(TRAIN_HW), blocks=list(SEG_BLOCKS),
               pre_nms=1024, post_nms=128, max_det=32, images=int(data["images"].shape[0]),
               frames=list(TRAIN_FRAMES), steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=TRAIN_LR,
               n_rois=TRAIN_ROIS[0], pos_ratio=TRAIN_ROIS[1], fit_s=fit_s,
               train_sampled_s=train_s, step_ms_mean=train_s * 1e3 / TRAIN_STEPS,
               step_ms_median=statistics.median(step_ms), step_ms=step_ms,
               peak_memory_gb=(peak - held) / 1e9,
               peak_memory_with_earlier_phases_gb=peak / 1e9, losses=losses,
               components_first=comps[0], components_last=comps[-1], n_pos_rois=n_pos,
               steps_with_positives=sum(v > 0 for v in n_pos),
               probe_n_pos_rois=probe_pos, launches=launches,
               launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
               step_profile=prof, backward_kernel=sites, card=nvidia_smi_line())
    emit(res)
    return res, trained, data


def phase_seg_toy(torch, mk, cfg, dev, metrics) -> dict:
    """The first recall number of the semantic route on the card: the JAX
    live-segmenter e2e test's fit (train_toy, blocks (1, 1, 1, 1) at 120 x
    160, pre/post NMS 256/32, 8 detections, 150 Adam steps at lr 2e-3 on the
    dynamic frames of 14, the object as a person), written with
    save_variables and run live by rgbd_tum --segmenter flax:<file> on the
    14-frame TUM-layout sequence. Gates as that test's: mean recall of the
    sphere > 0.3 over the frames where it covers > 30 pixels, ATE < 0.30 m,
    every frame's mask cached. The test's third gate, at least 11
    trajectory rows, is not met on the card: the fit masks 64-87% of
    frames 0-5 and the driver initialises at frame 6, so 8 rows come out
    (the fit is chaotic: Adam's first steps raise the loss ~70-fold, and
    inputs that differ by rounding end in different models; ROADMAP
    section 3). It is printed beside TOY_ROWS_GUARD, the 8 rows of the
    card's repeatable fit, which is held as a regression guard; with 8
    rows the ATE gate reads 8 of 14 frames, and the recall gate is met
    trivially on the frames the masks cover."""
    from gdslam_tpu_torch.cli import rgbd_tum
    from gdslam_tpu_torch.io import png, synthetic
    from gdslam_tpu_torch.models import maskrcnn
    from gdslam_tpu_torch.ops import detect_kernels as dk
    from gdslam_tpu_torch.system import trajectory as traj_mod
    tcfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=TOY_HW[1], height=TOY_HW[0],
        bf=160.0 * 0.08), orb=dataclasses.replace(cfg.orb, n_features=384, n_levels=4))
    frames = [synthetic.render_frame(i, tcfg.camera, with_dynamic=True, device=dev)
              for i in range(TOY_FRAMES)]
    data = person_targets([f.rgb.cpu().numpy() for f in frames],
                          [f.dyn_mask.cpu().numpy() for f in frames], 30)
    model = maskrcnn.MaskRCNN(image_hw=TOY_HW, blocks=(1, 1, 1, 1), pre_nms=256, post_nms=32,
                              max_det=8).eval().to(device=dev, memory_format=torch.channels_last)
    torch.cuda.synchronize()
    reset_launch_counts(mk)
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    trained = maskrcnn.train_toy(model, maskrcnn.init_variables((1, 1, 1, 1), SEG_SEED),
                                 data["images"], data["boxes"], data["classes"], data["masks"],
                                 data["valids"], steps=TOY_STEPS, lr=TOY_LR)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    with torch.no_grad(), maskrcnn.exact_cudnn():
        final = [float(model.train_losses(*(torch.as_tensor(data[k][i], device=dev) for k in
                                            ("images", "boxes", "classes", "masks", "valids"))))
                 for i in range(data["images"].shape[0])]
    base = Path(tempfile.mkdtemp(prefix="seg_toy_", dir=ROOT / "build"))
    weights = base / "toy_segmenter.npz"
    maskrcnn.save_variables(trained, str(weights), meta={"blocks": [1, 1, 1, 1],
                                                         "infer_hw": list(TOY_HW)})
    gts = write_tum_sequence(tcfg, frames, base / "seq", png, traj_mod)
    seq, cache = base / "seq", base / "cache"
    rc, out, sec = run_cli(rgbd_tum.main, ["none", str(seq / "settings.yaml"), str(seq),
                                           str(seq / "assoc.txt"), str(cache), "--segmenter",
                                           f"flax:{weights}", "--device", dev], base / "run")
    if rc != 0:
        fail(f"seg_toy: rgbd_tum --segmenter returned {rc}: {out[-2000:]}")
    recalls, ious = [], []
    for i, fr in enumerate(frames):
        est = png.read(cache / f"{CLI_EPOCH + i / 30.0:.6f}.png") > 127
        gt = fr.dyn_mask.cpu().numpy()
        if gt.sum() > 30:
            recalls.append(float((est & gt).sum() / gt.sum()))
            ious.append(float((est & gt).sum() / (est | gt).sum()))
    ate, rows = trajectory_file_ate(base / "run" / "CameraTrajectory.txt", gts, metrics)
    record_launches("seg_toy")
    res = dict(phase="seg_toy", image_hw=list(TOY_HW), blocks=[1, 1, 1, 1], pre_nms=256,
               post_nms=32, max_det=8, fit_images=int(data["images"].shape[0]),
               steps=TOY_STEPS, lr=TOY_LR, fit_s=fit_s, final_loss_mean=float(np.mean(final)),
               final_losses=final, mask_recall_mean=float(np.mean(recalls)),
               mask_iou_mean=float(np.mean(ious)), recalls=recalls, ious=ious, ate_m=ate,
               trajectory_rows=rows, cached_masks=len(os.listdir(cache)), rgbd_tum_s=sec,
               launches={**{w.__name__: w.launches for w in dk.WRAPPERS},
                         "match_top2": mk.match_top2.launches},
               mask_cover=[float((png.read(cache / n) > 127).mean())
                           for n in sorted(os.listdir(cache))],
               rows_gate=dict(jax_test_needs=TOY_FRAMES - 3, met=rows >= TOY_FRAMES - 3,
                              held=False, regression_guard=TOY_ROWS_GUARD),
               gates=TOY_GATES, card=nvidia_smi_line())
    emit(res)
    shutil.rmtree(base)
    if not (res["mask_recall_mean"] > TOY_GATES["recall"] and ate < TOY_GATES["ate_m"]
            and res["cached_masks"] == TOY_FRAMES and rows >= TOY_ROWS_GUARD):
        fail(f"seg_toy: recall {res['mask_recall_mean']}, ATE {ate} m, {rows} rows (guard "
             f"{TOY_ROWS_GUARD}), {res['cached_masks']} cached masks (gates {TOY_GATES})")
    return res


# ----------------------------------------------------------------------------
# stereo and monocular tracking
# ----------------------------------------------------------------------------

# ORB-SLAM2's public settings for KITTI odometry sequences 00-02
# (Examples/Stereo/KITTI00-02.yaml): the rectified camera, no distortion, the
# baseline times fx, ThDepth, RGB order and the ORB extractor. The stereo
# phase writes them into its own YAML under build/.
KITTI_CAMERA = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, k1=0.0, k2=0.0, p1=0.0,
                    p2=0.0, k3=0.0, width=1241, height=376, fps=10.0, bf=386.1448,
                    th_depth=35.0, rgb=1)
KITTI_ORB = dict(n_features=2000, scale_factor=1.2, n_levels=8, ini_th_fast=20, min_th_fast=7)
STEREO_FRAMES = 60
STEREO_ATE_GUARD_M = 0.10          # tests/test_stereo_mono.py's gate
MONO_FRAMES = 60                   # every second frame of the static scene: 0, 2, ..., 118
# Relative gates against the JAX package on the same PNGs (its numbers from
# tools/stereo_mono_quality_cpu.py on the CPU): ATE at most a x JAX's + b m
STEREO_RELATIVE = (1.5, 0.005)
MONO_RELATIVE = (1.5, 0.01)
STEREO_JAX = dict(ate_m=0.008660424214251984, keyframes=8, stereo_points_per_frame=1599.6333)
MONO_JAX = dict(keyframe_ate_scale_aligned_m=0.29294787229439423, keyframes=11, bootstrap_frame=2)
MONO_INIT_WAITS = 20               # initialize's waits for the card: cuSOLVER's SVDs and
#                                    inverses and two uploads, 18, and the 8-point systems'
#                                    copy to the host and back (cuSOLVER's own solve of
#                                    them waited twice too)
MONO_KEYFRAME_SLACK = 1            # keyframes the card may differ by: the pyramid's products
#                                    sum in another order on the card (ROADMAP section 3)
# tests/test_loop_e2e.py::test_mono_scale_drift_corrected: its rig (320x240,
# 512 features, 4 levels), circuit period and run, the injected scale
MONO_LOOP_PERIOD = 120
MONO_LOOP_FRAMES = 170
MONO_LOOP_S_INJ = 1.2
MONO_LOOP_PAIRS = 5            # revisit pairs the mono_loop gates are taken on
STEREO_NO_LIBRARY = ("no PyTorch call computes it: a band-masked Hamming argmin with an 11 x 11 "
                     "SAD refinement has no library counterpart")


@contextlib.contextmanager
def spy(owner, name: str, record):
    """owner.name replaced while the block runs by a wrapper that calls
    record(args, kwargs, result) after each call. A kernel wrapper counts its
    launches on its module's name, so its count is carried over and back:
    for a wrapper, owner must be the module that defines it."""
    real = getattr(owner, name)

    def call(*a, **k):
        out = real(*a, **k)
        record(a, k, out)
        return out

    counted = hasattr(real, "launches")
    if counted:
        call.launches = real.launches
    setattr(owner, name, call)
    try:
        yield
    finally:
        if counted:
            real.launches = call.launches
        setattr(owner, name, real)


def kitti_config(cfg):
    """The SlamConfig of KITTI00-02.yaml (cfg's other settings kept)."""
    return dataclasses.replace(cfg, camera=type(cfg.camera)(**KITTI_CAMERA),
                               orb=type(cfg.orb)(**KITTI_ORB))


def gray_u8(torch, g) -> np.ndarray:
    return torch.round(g).clamp(0, 255).to(torch.uint8).cpu().numpy()


def write_kitti_sequence(torch, cfg, n: int, base: Path, png, synthetic, dev) -> tuple:
    """A KITTI odometry layout under base: image_0/ and image_1/ NNNNNN.png
    (8-bit gray, rounded), times.txt (i / fps) and settings.yaml. Pair i is
    the static scene from synthetic.gt_pose(i, fps), the right view shifted
    by bf / fx along x (tests/test_stereo_mono.py's pair). Returns the
    ground-truth T_wc and a sha1 of every PNG written, in order."""
    import hashlib
    cam = cfg.camera
    for sub in ("image_0", "image_1"):
        (base / sub).mkdir(parents=True)
    shift = torch.eye(4)
    shift[0, 3] = cam.bf / cam.fx
    shift = shift.to(dev)
    gts, digest = [], hashlib.sha1()
    for i in range(n):
        T = synthetic.gt_pose(i, cam.fps, dev)
        for sub, P in (("image_0", T), ("image_1", T @ shift)):
            path = base / sub / f"{i:06d}.png"
            png.write(path, gray_u8(torch, synthetic.render(P, cam, False, cam.fps, i).gray),
                      level=1)
            digest.update(path.read_bytes())
        gts.append(T.cpu().numpy().astype(np.float64))
    (base / "times.txt").write_text("".join(f"{i / cam.fps:.6f}\n" for i in range(n)))
    (base / "settings.yaml").write_text(CLI_SETTINGS.format(c=cam, o=cfg.orb))
    return gts, digest.hexdigest()


def write_mono_sequence(torch, cfg, n: int, base: Path, png, synthetic, dev) -> tuple:
    """A TUM monocular layout under base (rgb.txt, rgb/<timestamp>.png as
    8-bit RGB, settings.yaml): frames 0, 2, ..., 2 (n - 1) of the static
    scene, named by TUM epoch timestamps (CLI_EPOCH + frame / 30). Returns
    {frame: ground-truth T_wc} and a sha1 of every PNG written, in order."""
    import hashlib
    (base / "rgb").mkdir(parents=True)
    rows, gts, digest = [], {}, hashlib.sha1()
    for k in range(n):
        i = 2 * k
        fr = synthetic.render_frame(i, cfg.camera, with_dynamic=False, device=dev)
        name = f"rgb/{CLI_EPOCH + i / 30.0:.6f}.png"
        png.write(base / name, gray_u8(torch, fr.rgb), level=1)
        digest.update((base / name).read_bytes())
        rows.append(f"{CLI_EPOCH + i / 30.0:.6f} {name}")
        gts[i] = fr.T_wc.cpu().numpy().astype(np.float64)
    (base / "rgb.txt").write_text("# timestamp filename\n" + "\n".join(rows) + "\n")
    (base / "settings.yaml").write_text(CLI_SETTINGS.format(c=cfg.camera, o=cfg.orb))
    return gts, digest.hexdigest()


def kitti_rows_ate(path: Path, gts, metrics) -> tuple[float, int]:
    """ATE of a KITTI trajectory file (one 3x4 T_wc row per tracked frame,
    the untracked ones at the start) against the renderer's, relative to
    frame 0."""
    rows = [[float(x) for x in r.split()] for r in path.read_text().strip().splitlines()]
    if not rows or any(len(r) != 12 for r in rows):
        fail(f"stereo: {path} does not parse as a KITTI trajectory")
    T0inv = np.linalg.inv(gts[0])
    est = np.array([[r[3], r[7], r[11]] for r in rows])
    first = len(gts) - len(rows)
    gt = np.stack([(T0inv @ g)[:3, 3] for g in gts[first:]])
    return metrics.ate_rmse(est, gt), len(rows)


def keyframe_file_ate(path: Path, gts: dict, metrics) -> tuple[float, int, list]:
    """Scale-aligned ATE (Umeyama with scale) of a TUM keyframe trajectory
    against the renderer's poses relative to frame 0; its rows and frames."""
    rows = [[float(x) for x in r.split()] for r in path.read_text().strip().splitlines()]
    if not rows or any(len(r) != 8 for r in rows):
        fail(f"mono: {path} does not parse as a TUM trajectory")
    frames = [round((r[0] - CLI_EPOCH) * 30.0) for r in rows]
    T0inv = np.linalg.inv(gts[0])
    est = np.array([r[1:4] for r in rows])
    gt = np.stack([(T0inv @ gts[i])[:3, 3] for i in frames])
    R, t, s = metrics.align_umeyama(est, gt, with_scale=True)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), len(rows), frames


def stereo_bound(torch, stereo, args, H: int, W: int) -> dict:
    """The least time the card could take for one stereo_match call, from
    this call's data (H100 SXM peaks). Operations: a pair takes the gate
    tests (2 sub, abs, 3 compares in f32; sub, abs, compare on the levels in
    int32) only if it lies in the row band, which an ideal walk over row
    buckets visits alone; a pair inside every gate the Hamming cost and the
    argmin update (8 xor + 8 popc + 8 add + 2 compare, int32); a matched
    keypoint 11 x 121 x 3 f32 operations of SAD and ~20 of parabola.
    bound_all_pairs_ms charges the gate tests to all N x M pairs. Bytes:
    every keypoint input once, the 11 x 11 left patch and the 11 x 21 right
    strip of each matched keypoint once (at most the two images), the two
    outputs."""
    luv, llv, _, lval, ruv, rlv, _, rval = args[:8]
    bf, min_z, scale = args[8], args[9], args[12]
    N, M = luv.shape[0], ruv.shape[0]
    band = stereo.band_table(scale, luv.device)[llv.long().clamp(0, stereo.BAND_LEVELS - 1)]
    in_band = (luv[:, None, 1] - ruv[None, :, 1]).abs() <= band[:, None]
    disp = luv[:, None, 0] - ruv[None, :, 0]
    gated = in_band & (disp >= -1.0) & (disp <= bf / min_z) & \
        ((llv[:, None] - rlv[None, :]).abs() <= 1) & lval[:, None] & rval[None, :]
    n_band, n_gated = int(in_band.sum()), int(gated.sum())
    depth = stereo.stereo_match_plain(*args)[1]
    ur0 = stereo.stereo_match_plain(*args[:10], None, None, scale)[0]
    matched = int((ur0 >= 0).sum())                     # coarse matches refined by SAD
    nbytes = (N + M) * (8 + 4 + 32 + 1) + min(matched * (121 + 231), 2 * H * W) * 4 + 8 * N

    def t_ops(tested):
        return 6 * tested / F32_OPS_PER_S + matched * (11 * 121 * 3 + 20) / F32_OPS_PER_S + \
            (3 * tested + 26 * n_gated) / INT32_OPS_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(pairs=N * M, pairs_in_band=n_band, pairs_in_gates=n_gated,
                coarse_matches=matched, stereo_points=int((depth > 0).sum()), bytes=nbytes,
                bound_ms=max(t_ops(n_band), t_bytes) * 1e3,
                bound_by="operations" if t_ops(n_band) >= t_bytes else "bytes",
                bound_all_pairs_ms=max(t_ops(N * M), t_bytes) * 1e3)


def stereo_launch(torch, stereo, args) -> tuple:
    """(C launch function, its arguments up to the device and stream, the
    tensors they point to) of one stereo_match call, for a CUDA graph."""
    lib = stereo._library()
    luv, llv, ldesc, lval, ruv, rlv, rdesc, rval, bf, min_z, il, ir, scale = args
    band = stereo.band_table(scale, luv.device)
    out = torch.empty(2, luv.shape[0], device=luv.device)
    rows = stereo.bucket_rows(il.shape[0])
    scratch = stereo._scratch(ruv.shape[0], rows, luv.device)
    cargs = (luv.data_ptr(), llv.data_ptr(), ldesc.data_ptr(), lval.data_ptr(), luv.shape[0],
             ruv.data_ptr(), rlv.data_ptr(), rdesc.data_ptr(), rval.data_ptr(), ruv.shape[0],
             band.data_ptr(), il.data_ptr(), ir.data_ptr(), il.shape[0], il.shape[1],
             float(np.float32(bf)), float(np.float32(bf / min_z)), rows, scratch.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr())
    return lib.stereo_match_launch, cargs, (out, band, scratch)


def stereo_out(result):
    """stereo_match's (ur, depth) on the card as the one [2, N] tensor they
    are rows of (no copy, so a graph of the call holds only its launches)."""
    return result[0]._base


def check_stereo_kernel(torch, stereo, extractor, cfg, views: dict, old=None) -> list:
    """The kernel against its plain twin at the full shape on each pair of
    `views` ({label: (left, right) float gray on the card}): features
    extracted on the card, ur and depth bit for bit; on the first pair its
    ms through the wrapper, from a CUDA graph, the plain twin's, the
    launches a call (the wrapper's count and graph_kernels) and the bound.
    With `old` (ParentKernels), the parent's kernel beside the new one on
    each pair (ab_times)."""
    cam, out = cfg.camera, []
    for label, (gl, gr) in views.items():
        A, B = (extractor.extract(g, cfg.orb, cam.height, cam.width) for g in (gl, gr))
        args = (*(t.contiguous() for t in (A.uv, A.level, A.desc, A.valid,
                                           B.uv, B.level, B.desc, B.valid)),
                cam.bf, cam.bf / cam.fx, gl.contiguous(), gr.contiguous(),
                float(cfg.orb.scale_factor))
        got = stereo.stereo_match(*args)
        want = stereo.stereo_match_plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rec = dict(images=label, shape=[args[0].shape[0], args[4].shape[0]],
                   exact=all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
                   max_abs_err=err, stereo_points=int((got[1] > 0).sum()))
        if not rec["exact"]:
            fail(f"stereo: the kernel differs from its plain twin on the {label} pair: {rec}")
        if not out:
            fn, cargs, keep = stereo_launch(torch, stereo, args)
            before = stereo.stereo_match.launches
            stereo.stereo_match(*args)
            count = stereo.stereo_match.launches - before
            kernels = graph_kernels(torch, lambda: stereo.stereo_match(*args))
            rec.update(ms=cuda_ms(torch, lambda: stereo.stereo_match(*args), reps=100),
                       device_ms=graph_ms(torch, fn, cargs), count_per_call=count,
                       cuda_launches_per_call=kernels,
                       plain_ms=cuda_ms(torch, lambda: stereo.stereo_match_plain(*args), reps=5,
                                        windows=3),
                       library_ms=None, library_note=STEREO_NO_LIBRARY,
                       **stereo_bound(torch, stereo, args, cam.height, cam.width))
            del keep
            if count != 1 or not 1 <= kernels <= 2:
                fail(f"stereo: a call counted {count} and launched {kernels} kernels (1 or 2)")
        if old is not None:
            call = lambda: stereo_out(stereo.stereo_match(*args))

            def old_launch():
                fn, a, keep = stereo_launch(torch, stereo, args)
                return old.fns["stereo_match"], old.old_args("stereo_match", a), keep

            rec["ab"] = ab_times(torch, old_launch, lambda: stereo_launch(torch, stereo, args),
                                 lambda: old.call(call), call, torch.stack(want))
        out.append(rec)
    return out


def top2_call_sites(torch, mk, calls, role: str) -> list:
    """match_top2 on one recorded call of each (M, N) shape of a path: exact
    against the plain version with the kernel choosing its path and with each
    path forced, timed through the wrapper and from a graph, bounded."""
    by_shape = {}
    for a in calls:
        by_shape[(a[0].shape[0], a[5].shape[0])] = a
    sites = []
    for (M, N), a in sorted(by_shape.items()):
        err, info = compare_top2(torch, mk, a)
        t = time_top2(torch, mk, a)
        sites.append(dict(role=role, M=M, N=N, path=info["path"], max_abs_err=err,
                          calls=sum((c[0].shape[0], c[5].shape[0]) == (M, N) for c in calls),
                          **{k: t[k] for k in ("ms", "device_ms", "plain_ms")},
                          **{k: v for k, v in top2_bound(torch, mk, a).items()
                             if k in ("bound_ms", "bound_by", "bound_all_pairs_ms")}))
    return sites


def stereo_kitti_run(torch, mk, mods, argv, out_dir: Path) -> tuple:
    """cli/stereo_kitti.py in-process with `argv`, writing into out_dir, its
    stereo_match and match_top2 counts set to 0 just before: (depths a
    frame, the System, the recorded match_top2 calls, the driver's text,
    seconds)."""
    stereo, matcher, slam_mod, stereo_kitti = mods[0], mods[1], mods[2], mods[8]
    depths, systems, box = [], [], []
    reset_launch_counts(mk)
    stereo.stereo_match.launches = 0
    with spy(stereo, "stereo_match", lambda a, k, o: depths.append(o[1])), \
            spy(slam_mod.System, "shutdown", lambda a, k, o: systems.append(a[0])):
        calls = record_top2_calls(matcher, lambda: box.append(
            run_cli(stereo_kitti.main, argv, out_dir)))
    rc, text, sec = box[0]
    if rc != 0:
        fail(f"stereo: stereo_kitti returned {rc}: {text[-2000:]}")
    return depths, systems[0], calls, text, sec


def phase_stereo(torch, mk, cfg, dev, mods, old=None) -> tuple[dict, dict]:
    """The stereo tracker as a user runs it: 60 rendered pairs at KITTI's
    settings (KITTI00-02.yaml: 1241 x 376, 2000 features, 8 levels) written as
    a KITTI layout of 8-bit PNGs under build/, then cli/stereo_kitti.py
    in-process on the card, its stereo_match and match_top2 counts set to 0
    just before and read just after. Guards: every frame tracked, ATE < 0.10
    m and at most STEREO_RELATIVE against the JAX package's on the same PNGs;
    both kernels launched. Then the stereo kernel exact against its plain
    twin at 2000 x 2000 on a PNG pair and on the renderer's float pair, its
    times and bound; match_top2 exact at this path's call shapes, both paths
    forced; one profiled window of 5 frames (host / device split)."""
    stereo, matcher, slam_mod, kitti, png, synthetic, metrics, extractor, stereo_kitti = mods
    scfg = kitti_config(cfg)
    base = Path(tempfile.mkdtemp(prefix="stereo_smoke_", dir=ROOT / "build"))
    seq = base / "seq"
    t0 = time.perf_counter()
    gts, digest = write_kitti_sequence(torch, scfg, STEREO_FRAMES, seq, png, synthetic, dev)
    write_s = time.perf_counter() - t0
    argv = ["none", str(seq / "settings.yaml"), str(seq), "--device", dev]

    def run(label):
        return stereo_kitti_run(torch, mk, mods, argv, base / label)

    depths, slam, calls, text, run_s = run("run")
    record_launches("stereo")
    launches = dict(stereo_match=stereo.stereo_match.launches,
                    match_top2=mk.match_top2.launches)
    ate, n_rows = kitti_rows_ate(base / "run" / "CameraTrajectory.txt", gts, metrics)
    points = [int((d > 0).sum()) for d in depths]
    res = dict(phase="stereo", frames=STEREO_FRAMES, width=scfg.camera.width,
               height=scfg.camera.height, n_features=scfg.orb.n_features,
               n_levels=scfg.orb.n_levels, settings="ORB-SLAM2 Examples/Stereo/KITTI00-02.yaml",
               write_s=write_s, png_sha1=digest, run_s=run_s,
               frame_ms_median=1e3 * float(text.split("median tracking time:")[1].split()[0]),
               frame_ms_mean=1e3 * float(text.split("mean tracking time:")[1].split()[0]),
               poses=n_rows, ate_m=ate, keyframes=slam.keyframe_count,
               map_points=slam.map_point_count, state=slam.tracking_state.name,
               stereo_points_per_frame=float(np.mean(points)),
               stereo_points_min=min(points), launches=launches,
               launches_per_frame={k: v / STEREO_FRAMES for k, v in launches.items()},
               jax_cpu=STEREO_JAX)
    gate = STEREO_ATE_GUARD_M
    if STEREO_JAX["ate_m"] is not None:
        gate = min(gate, STEREO_RELATIVE[0] * STEREO_JAX["ate_m"] + STEREO_RELATIVE[1])
    res["ate_gate_m"] = gate
    if not (n_rows == STEREO_FRAMES and ate < gate and res["state"] == "OK"):
        emit(res)
        fail(f"stereo: poses {n_rows} of {STEREO_FRAMES}, ATE {ate} m (gate {gate} m)")
    if min(launches.values()) < 1 or launches["stereo_match"] != STEREO_FRAMES:
        emit(res)
        fail(f"stereo: the path's kernels were not launched once a frame: {launches}")

    # the kernel at the full shape, on a PNG pair and on the renderer's floats
    j = STEREO_FRAMES // 2
    left, right, _ = kitti.KittiStereoSequence(str(seq))[j]
    T = synthetic.gt_pose(j, scfg.camera.fps, dev)
    shift = torch.eye(4)
    shift[0, 3] = scfg.camera.bf / scfg.camera.fx
    floats = tuple(synthetic.render(P, scfg.camera, False, scfg.camera.fps, j).gray
                   for P in (T, T @ shift.to(dev)))
    res["kernel"] = check_stereo_kernel(
        torch, stereo, extractor, scfg,
        {"png": tuple(torch.from_numpy(x).to(dev) for x in (left, right)), "float": floats},
        old)
    res["kernel"][0].update(launch_floor(torch, mk))
    res["match_top2_call_sites"] = top2_call_sites(torch, mk, calls, "stereo_tracker")

    # one profiled window: 5 frames past 5 of warm-up, on a fresh system
    seqr = kitti.KittiStereoSequence(str(seq))
    prof_slam = slam_mod.System(scfg, slam_mod.Sensor.STEREO, device=dev)
    for i in range(5):
        prof_slam.track_stereo(*seqr[i])

    def five():
        for i in range(5, 10):
            prof_slam.track_stereo(*seqr[i])

    res["profile_per_frame"] = profile_window(torch, five, 5)
    res["card"] = nvidia_smi_line()
    emit(res)
    again = run("again")
    same = dict(trajectory=(base / "run" / "CameraTrajectory.txt").read_bytes() ==
                (base / "again" / "CameraTrajectory.txt").read_bytes(),
                keyframes=bool(np.array_equal(
                    slam.tracker.arena.kf_pose.cpu().numpy(),
                    again[1].tracker.arena.kf_pose.cpu().numpy())))
    shutil.rmtree(base)
    return res, same


def phase_ab_quality(torch, mk, cfg, dev, stereo_mods, gd_run, old) -> dict:
    """The parents' stereo_match and categorical_draw kernels (ParentKernels)
    and the new ones on the same end-to-end runs, in the order parent, new,
    new, parent: the stereo phase's driver run (stereo_kitti on
    STEREO_FRAMES PNG pairs: ATE, stereo points a frame, keyframes, the
    trajectory file; its frame times) and gd_slice (gd_run(): ATE, mask
    recall and IoU, keyframes, draws; its frame time). The card is
    bit-reproducible and both kernels equal their unchanged plain twins bit
    for bit, so every number but the times must be the same in all four
    runs; a difference fails. The times of both sides in one process say
    how far the host's load moves a frame."""
    stereo, png, synthetic, metrics = (stereo_mods[0], stereo_mods[4], stereo_mods[5],
                                       stereo_mods[6])
    scfg = kitti_config(cfg)
    base = Path(tempfile.mkdtemp(prefix="stereo_ab_", dir=ROOT / "build"))
    seq = base / "seq"
    gts, _ = write_kitti_sequence(torch, scfg, STEREO_FRAMES, seq, png, synthetic, dev)
    argv = ["none", str(seq / "settings.yaml"), str(seq), "--device", dev]
    order = [("parent", old.call), ("new", lambda f: f()), ("new", lambda f: f()),
             ("parent", old.call)]
    times = ("run_s", "frame_ms_median", "frame_ms_mean", "frame_ms")
    st, gd = {"parent": [], "new": []}, {"parent": [], "new": []}
    for k, (label, wrap) in enumerate(order):
        depths, slam, _, text, sec = wrap(lambda: stereo_kitti_run(
            torch, mk, stereo_mods, argv, base / f"{label}{k}"))
        traj = base / f"{label}{k}" / "CameraTrajectory.txt"
        ate, n_rows = kitti_rows_ate(traj, gts, metrics)
        st[label].append(dict(
            ate_m=ate, poses=n_rows, keyframes=slam.keyframe_count,
            stereo_points=[int((d > 0).sum()) for d in depths],
            stereo_match_calls=stereo.stereo_match.launches, run_s=sec,
            frame_ms_median=1e3 * float(text.split("median tracking time:")[1].split()[0]),
            frame_ms_mean=1e3 * float(text.split("mean tracking time:")[1].split()[0]),
            trajectory_sha1=hashlib.sha1(traj.read_bytes()).hexdigest()))
    for label, wrap in order:
        g = wrap(gd_run)
        gd[label].append({k: g[k] for k in ("ate_m", "ate_bench_m", "mask_recall", "mask_iou",
                                            "keyframes", "map_points",
                                            "categorical_draw_launches", "frame_ms")})
    shutil.rmtree(base)
    same = {}
    for name, runs in (("stereo", st), ("gd_slice", gd)):
        first = runs["parent"][0]
        same[name] = all(r[k] == first[k] for side in runs.values() for r in side
                         for k in first if k not in times)
    res = dict(phase="ab_quality", order=[label for label, _ in order],
               stereo={label: dict({k: v for k, v in runs[0].items() if k not in times
                                    and k != "stereo_points"},
                                   stereo_points_per_frame=float(np.mean(runs[0]["stereo_points"])),
                                   **{k: [r[k] for r in runs] for k in times if k in runs[0]})
                       for label, runs in st.items()},
               gd_slice={label: dict({k: v for k, v in runs[0].items() if k not in times},
                                     frame_ms=[r["frame_ms"] for r in runs])
                         for label, runs in gd.items()},
               stereo_equal=same["stereo"], gd_slice_equal=same["gd_slice"],
               card=nvidia_smi_line())
    emit(res)
    if not all(same.values()):
        fail("ab_quality: the parent's and the new kernels gave different results")
    return res


def phase_mono(torch, mk, cfg, dev, mods) -> tuple[dict, dict]:
    """The monocular tracker as a user runs it: the SlamConfig() defaults
    at 480 x 640 (TUM3 intrinsics, 1500 features, 8 levels), every second
    frame of the static scene (60 frames) written as a TUM monocular layout
    of 8-bit RGB PNGs under build/, then cli/mono_tum.py in-process on the
    card, the match_top2 count set to 0 just before and read just after.
    Guards: the bootstrap succeeds at the JAX package's frame (2), the state
    is OK at the end, the keyframes number the JAX package's 11 within
    MONO_KEYFRAME_SLACK, the map grows past the bootstrap pair (points made
    by keyframes after it; the JAX gate of tests/test_mapping.py), the
    scale-aligned keyframe ATE at most MONO_RELATIVE against the JAX
    package's on the same PNGs. Then the bootstrap's match_top2 call exact
    against the plain version (each path forced) and its index rule against
    the plain route on the CPU; initialize's ms on the card, twice bitwise,
    against the CPU route on the same inputs (the same model choice and
    good points), its waits for the card (MONO_INIT_WAITS, two of them the
    8-point systems' copy out and back), and torch.linalg.svd on its batch
    shapes."""
    tracking, initializer, slam_mod, png, synthetic, metrics, mono_tum = mods
    base = Path(tempfile.mkdtemp(prefix="mono_smoke_", dir=ROOT / "build"))
    seq = base / "seq"
    t0 = time.perf_counter()
    gts, digest = write_mono_sequence(torch, cfg, MONO_FRAMES, seq, png, synthetic, dev)
    write_s = time.perf_counter() - t0
    argv = ["none", str(seq / "settings.yaml"), str(seq), "--device", dev]

    def run(label):
        inits, boots, systems, out = [], [], [], []
        reset_launch_counts(mk)
        with spy(initializer, "initialize", lambda a, k, o: inits.append((a, k, o))), \
                spy(tracking, "bootstrap_matches", lambda a, k, o: boots.append((a, o))), \
                spy(slam_mod.System, "shutdown", lambda a, k, o: systems.append(a[0])):
            out.append(run_cli(mono_tum.main, argv, base / label))
        rc, text, sec = out.pop()
        if rc != 0:
            fail(f"mono: mono_tum returned {rc}: {text[-2000:]}")
        return inits, boots, systems[0], text, sec

    inits, boots, slam, text, run_s = run("run")
    launches = dict(match_top2=mk.match_top2.launches, categorical_draw=draw_launches())
    record_launches("mono")
    tr = slam.tracker
    ok_calls = [i for i, (_, _, o) in enumerate(inits) if bool(o.ok)]
    boot = ok_calls[0] if ok_calls else None
    ate, n_kf_rows, kf_frames = keyframe_file_ate(base / "run" / "KeyFrameTrajectory.txt", gts,
                                                  metrics)
    n = tr.n_kf_host
    pt_valid, pt_ref = tr.arena.pt_valid.cpu().numpy(), tr.arena.pt_ref_kf.cpu().numpy()
    res = dict(phase="mono", frames=MONO_FRAMES, frame_step=2, width=cfg.camera.width,
               height=cfg.camera.height, n_features=cfg.orb.n_features,
               n_levels=cfg.orb.n_levels, write_s=write_s, png_sha1=digest, run_s=run_s,
               frame_ms_median=1e3 * float(text.split("median tracking time:")[1].split()[0]),
               initialize_calls=len(inits),
               bootstrap_frame=2 * (boot + 1) if boot is not None else None,
               used_homography=bool(inits[boot][2].used_homography) if boot is not None else None,
               state=tr.state.name, keyframes=n, keyframe_rows=n_kf_rows,
               keyframe_frames=kf_frames, map_points=int(pt_valid.sum()),
               map_points_after_bootstrap_pair=int((pt_valid & (pt_ref >= 2)).sum()),
               keyframe_ate_scale_aligned_m=ate, launches=launches,
               launches_per_frame={k: v / MONO_FRAMES for k, v in launches.items()},
               jax_cpu=MONO_JAX)
    gate = None
    if MONO_JAX["keyframe_ate_scale_aligned_m"] is not None:
        gate = MONO_RELATIVE[0] * MONO_JAX["keyframe_ate_scale_aligned_m"] + MONO_RELATIVE[1]
    res["ate_gate_m"] = gate
    if boot is None or res["state"] != "OK" or n <= 2 or \
            res["map_points_after_bootstrap_pair"] < 1 or (gate is not None and ate > gate) or \
            res["bootstrap_frame"] != MONO_JAX["bootstrap_frame"] or \
            abs(n - MONO_JAX["keyframes"]) > MONO_KEYFRAME_SLACK:
        emit(res)
        fail(f"mono: bootstrap {res['bootstrap_frame']} (the JAX package's "
             f"{MONO_JAX['bootstrap_frame']}), state {res['state']}, {n} keyframes (the JAX "
             f"package's {MONO_JAX['keyframes']} +- {MONO_KEYFRAME_SLACK}), "
             f"{res['map_points_after_bootstrap_pair']} points after the pair, ATE {ate} m "
             f"(gate {gate} m)")
    if launches["match_top2"] < 1 or launches["categorical_draw"] < 2 * len(inits):
        emit(res)
        fail(f"mono: the path launched no kernel, or the bootstrap drew off the card: "
             f"{launches}")

    # the bootstrap's match: the kernel's call exact against the plain
    # version, each path forced; the index rule against the CPU's plain route
    (first, frame, n_levels), (good, idx) = boots[boot]
    calls = record_top2_calls(tracking, lambda: tracking.bootstrap_matches(first, frame,
                                                                           n_levels))
    site = top2_call_sites(torch, mk, calls, "mono_bootstrap_all_pairs")
    cpu = lambda f: f._replace(**{k: v.cpu() for k, v in f._asdict().items()})  # noqa: E731
    good_c, idx_c = tracking.bootstrap_matches(cpu(first), cpu(frame), n_levels)
    res["bootstrap_match"] = dict(
        call_sites=site, good=int(good.sum()), idx_rule_exact=bool(
            torch.equal(good.cpu(), good_c) and torch.equal(idx.cpu(), idx_c)),
        invalid_first_rows=int((~first.valid).sum()), invalid_frame_rows=int((~frame.valid).sum()))
    if not res["bootstrap_match"]["idx_rule_exact"]:
        emit(res)
        fail("mono: the bootstrap's good / idx on the card differ from the plain route")

    # initialize on the card: its time, twice bitwise, and cuSOLVER's SVDs
    a, k, o = inits[boot]

    def init():          # the tracker's call, the JAX package's draws replayed
        return initializer.initialize(*a, **k)

    again = [init() for _ in range(2)]
    torch.cuda.synchronize()
    waits = sync_sites(torch, init, top=None)
    src, first = inspect.getsourcelines(initializer._null_vectors)
    copy_site = f"initializer.py:{first + next(i for i, ln in enumerate(src) if '.cpu()' in ln)}"
    host = initializer.initialize(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in a),
                                  **k)
    cpu_route = dict(ok=bool(host.ok), used_homography_equal=bool(
        host.used_homography) == bool(o.used_homography),
        good_equal=bool(torch.equal(host.is_good, o.is_good.cpu())),
        T_21_max_abs_diff=float((host.T_21 - o.T_21.cpu()).abs().max()))
    res["initialize"] = dict(cpu_route=cpu_route, host_sync_sites=waits,
        host_syncs=sum(waits.values()),
        ms=wall_ms(torch, init, reps=5, warmup=1),
        repeat_bitwise=all(bool(torch.equal(getattr(again[0], f), getattr(x, f)))
                           for x in (again[1], o) for f in o._fields),
        svd_ms={f"{b}x{r}x{c}": wall_ms(torch, lambda s=(b, r, c): torch.linalg.svd(
            torch.randn(*s, device=dev)), reps=5, warmup=1)
            for b, r, c in ((200, 8, 9), (200, 3, 3), (4 * a[0].shape[0], 4, 4))})
    res["card"] = nvidia_smi_line()
    emit(res)
    if not (cpu_route["used_homography_equal"] and cpu_route["good_equal"]):
        fail(f"mono: the bootstrap's initialize on the card differs from the CPU route's: "
             f"{cpu_route}")
    if waits.get(copy_site) != 2 or sum(waits.values()) != MONO_INIT_WAITS:
        fail(f"mono: initialize waits for the card {sum(waits.values())} times, at {waits}; "
             f"{MONO_INIT_WAITS} expected, two of them the 8-point systems' copy out and "
             f"back at {copy_site}")
    second = run("again")
    same = dict(keyframe_trajectory=(base / "run" / "KeyFrameTrajectory.txt").read_bytes() ==
                (base / "again" / "KeyFrameTrajectory.txt").read_bytes(),
                keyframes=bool(np.array_equal(tr.arena.kf_pose[:n].cpu().numpy(),
                                              second[2].tracker.arena.kf_pose[:n].cpu().numpy())),
                initialize=res["initialize"]["repeat_bitwise"])
    shutil.rmtree(base)
    return res, same


def mono_loop_gates(tr, lc, to_np, to_dev, gt_pose) -> dict:
    """tests/test_loop_e2e.py::test_mono_scale_drift_corrected's gates on the
    map of tracker tr (either package: to_np makes an array numpy, to_dev
    puts one back, gt_pose(i) is frame i's true T_cw). The revisit pairs
    are each of the last MONO_LOOP_PAIRS keyframes with its circuit-closest
    early one, the first of them the JAX test's pair. The recent half of the
    map is replaced by a uniform 1.2x similarity of itself with the
    cross-scale observations, covisibility and parents cut; then, on a pair,
    compute_transform must verify with >= 40 matches, its Sim3 scale within
    5% of 1.2 x the pair's natural (pre-injection) scale, and correct must
    remove >= 50% of the cross-zone drift and leave under 10%. The run
    passes when the drift was injected (zone ratio up > 15%) and the gates
    hold on one of the pairs. The JAX test takes the last keyframe's pair
    alone; whether that pair keeps enough matches after the cut rests on
    where the last keyframe of one chaotic run falls, and in the JAX
    package's own run the gates hold on one of its five pairs (ROADMAP.md
    section 3). Its verdict is `natural_pair_passed`; every pair's is
    reported."""
    T0 = to_np(gt_pose(0))

    def seg_ratios(arena):
        cs, gs = [], []
        kf_pose = to_np(arena.kf_pose)
        for k, ts in enumerate(tr.kf_timestamps):
            cs.append(np.linalg.inv(kf_pose[k])[:3, 3])
            gs.append((np.linalg.inv(T0) @ to_np(gt_pose(int(round(ts * 30.0)))))[:3, 3])
        cs, gs = np.asarray(cs), np.asarray(gs)
        de = np.linalg.norm(np.diff(cs, axis=0), axis=1)
        dg = np.linalg.norm(np.diff(gs, axis=0), axis=1)
        keep = dg > 1e-3
        return de[keep] / dg[keep], keep

    def zone_ratio(arena):
        r, keep = seg_ratios(arena)
        is_new = np.arange(1, n)[keep] > k0
        return float(np.mean(r[is_new]) / np.mean(r[~is_new]))

    arena, n, P = tr.arena, tr.n_kf_host, MONO_LOOP_PERIOD
    k0 = n // 2
    zone_nat = zone_ratio(arena)
    frames = [int(round(ts * 30)) % P for ts in tr.kf_timestamps[:n]]
    pairs = []
    for cur in range(n - 1, max(k0, n - 1 - MONO_LOOP_PAIRS), -1):
        cand = min(range(k0), key=lambda k: min(abs(frames[k] - frames[cur]),
                                                P - abs(frames[k] - frames[cur])))
        ok_nat, _, n_nat = lc.compute_transform(arena, cur, cand)
        pairs.append(dict(pair=[cur, cand], natural_verified=bool(ok_nat),
                          natural_matches=int(n_nat),
                          natural_scale=float(lc.last_sim3[2]) if ok_nat else 1.0))

    # a uniform similarity of the recent segment about keyframe k0's centre,
    # with the cross-scale observations, covisibility and parents cut
    np_a = {f: to_np(getattr(arena, f)).copy() for f in arena._fields}
    c0 = np.linalg.inv(np_a["kf_pose"][k0])[:3, 3]
    for k in range(k0, n):
        Twc = np.linalg.inv(np_a["kf_pose"][k])
        Twc[:3, 3] = c0 + MONO_LOOP_S_INJ * (Twc[:3, 3] - c0)
        np_a["kf_pose"][k] = np.linalg.inv(Twc)
    sel = (np_a["pt_ref_kf"] >= k0) & np_a["pt_valid"]
    np_a["pt_pos"][sel] = c0 + MONO_LOOP_S_INJ * (np_a["pt_pos"][sel] - c0)
    obs, n_obs, pt_ref = np_a["kf_obs"], np_a["pt_n_obs"], np_a["pt_ref_kf"]
    for p in pairs:
        p["observations_before_cut"] = [int((obs[k] >= 0).sum()) for k in p["pair"]]
    for k in range(n):
        other = (pt_ref < k0) if k >= k0 else (pt_ref >= k0)
        cut = (obs[k] >= 0) & other[np.maximum(obs[k], 0)]
        n_obs[obs[k][cut]] -= 1
        obs[k][cut] = -1
    np_a["pt_n_obs"] = np.maximum(n_obs, 0)
    np_a["covis"][:k0, k0:n] = 0
    np_a["covis"][k0:n, :k0] = 0
    for k in range(k0, n):
        if np_a["kf_parent"][k] < k0:
            np_a["kf_parent"][k] = k - 1
    tr.arena = arena._replace(**{f: to_dev(np_a[f]) for f in
                                 ("kf_parent", "kf_pose", "pt_pos", "kf_obs", "pt_n_obs",
                                  "covis")})
    zone_pre = zone_ratio(tr.arena)
    t0 = time.perf_counter()
    for p in pairs:
        cur, cand = p["pair"]
        ok, T, n_m = lc.compute_transform(tr.arena, cur, cand)
        s = float(lc.last_sim3[2]) if ok else None
        zone_post = zone_ratio(lc.correct(tr.arena, cur, cand, T)) if ok else zone_pre
        s_expect = MONO_LOOP_S_INJ * p["natural_scale"]
        p.update(observations_after_cut=[int((obs[k] >= 0).sum()) for k in (cur, cand)],
                 verified=bool(ok), matches=int(n_m), sim3_scale=s,
                 sim3_scale_expected=s_expect,
                 sim3_scale_error=abs(s - s_expect) / s_expect if ok else None,
                 zone_ratio_corrected=zone_post,
                 drift_removed_share=1.0 - abs(zone_post - 1.0) / abs(zone_pre - 1.0))
        p["passed"] = bool(ok and n_m >= 40 and p["sim3_scale_error"] < 0.05 and
                           abs(zone_post - 1.0) < 0.5 * abs(zone_pre - 1.0) and
                           abs(zone_post - 1.0) < 0.10)
    injected = zone_pre / zone_nat > 1.15
    return dict(k0=k0, keyframe_frames=frames, zone_ratio_natural=zone_nat,
                zone_ratio_injected=zone_pre, drift_injected=bool(injected), pairs=pairs,
                pairs_passed=sum(p["passed"] for p in pairs),
                natural_pair_passed=bool(injected and pairs[0]["passed"]),
                passed=bool(injected and any(p["passed"] for p in pairs)),
                compute_and_correct_s=time.perf_counter() - t0)


def phase_mono_loop(torch, mk, cfg, dev, mods) -> dict:
    """tests/test_loop_e2e.py::test_mono_scale_drift_corrected on the card,
    at its own rig (320x240, 512 features, 4 levels) with the default
    vocabulary: 170 frames of the mono circuit tracked with a loop closer of
    free scale, then the test's gates on the last keyframes' revisit pairs
    (mono_loop_gates): they must hold on one of them."""
    Tracking, LoopCloser, voc, synthetic = mods
    mcfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
        bf=320.0 * 0.08), orb=dataclasses.replace(cfg.orb, n_features=512, n_levels=4))
    P = MONO_LOOP_PERIOD
    tr = Tracking(mcfg, kmax=64, pmax=32768, device=dev)
    lc = LoopCloser(mcfg, voc.default_vocabulary(dev), 64, dev)
    lc.fix_scale = False
    tr.loop_closer = lc
    reset_launch_counts(mk)
    t0 = time.perf_counter()
    for i in range(MONO_LOOP_FRAMES):
        fr = synthetic.render(synthetic.gt_pose_loop_mono(i, P, dev), mcfg.camera, False,
                              30.0, i)
        tr.process_mono(fr.gray, i / 30.0)
    tr.flush()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = mk.match_top2.launches
    record_launches("mono_loop")
    res = dict(phase="mono_loop", frames=MONO_LOOP_FRAMES, width=320, height=240,
               n_features=512, run_s=run_s, state=tr.state.name, keyframes=tr.n_kf_host,
               loops_fired=len(lc.loops), match_top2_launches=launches)
    if tr.state.name != "OK" or launches < 1:
        emit(res)
        fail(f"mono_loop: state {tr.state.name} after the run, {launches} launches")
    res.update(mono_loop_gates(tr, lc, lambda t: t.cpu().numpy(),
                               lambda a: torch.from_numpy(a).to(dev),
                               lambda i: synthetic.gt_pose_loop_mono(i, P)),
               card=nvidia_smi_line())
    emit(res)
    if not res["passed"]:
        fail("mono_loop: the JAX test's gates are not met on any revisit pair")
    return res


# ----------------------------------------------------------------------------
# batch: many sequences tracked at once (parallel/batch_eval.py)
# ----------------------------------------------------------------------------

BATCH_SIZES = (1, 4, 8)
BATCH_FRAMES = 20
BATCH_STRIDE = 3               # slot b tracks frames 3b, 3b + 1, ... (tests/test_multichip.py)
BATCH_BLACKOUT = (3, 4)        # slot 0 of the relocalization run sees zeros at these frames
BATCH_RELOC_SLOTS = 4
BATCH_GD_SLOTS = 4
BATCH_GD_FRAMES = 12           # 7 past the ring's warm-up of 5
BATCH_GUARD_M = 0.1            # each slot's ATE; the relocalized pose against the clean run


def batch_frames(torch, synthetic, cam, dev, n_slots: int, n_frames: int, dynamic: bool):
    """[B, T, H, W] grays and depths on the card, slot b from the renderer's
    frame BATCH_STRIDE * b, and each slot's [T] ground-truth T_wc (numpy)."""
    fr = [synthetic.render_frame(i, cam, with_dynamic=dynamic, device=dev)
          for i in range(BATCH_STRIDE * (n_slots - 1) + n_frames)]
    rows = [[BATCH_STRIDE * b + t for t in range(n_frames)] for b in range(n_slots)]
    grays = torch.stack([torch.stack([fr[i].gray for i in r]) for r in rows])
    depths = torch.stack([torch.stack([fr[i].depth for i in r]) for r in rows])
    return grays, depths, [np.stack([fr[i].T_wc.cpu().numpy() for i in r]) for r in rows]


def batch_run(torch, be, cfg, grays, depths, use_gd: bool = False) -> dict:
    """batched_track_step over [B, T] frames from init_states, as a user runs
    it (kmax 64, pmax 8192, the module's defaults), timed with one
    synchronise at the end: the final states and, per step, the poses, the
    host mirrors, the slots' stats [B, 4] and mean_inliers."""
    B, T, H, W = grays.shape
    step = be.batched_track_step(cfg, H, W, device=grays.device)
    st = be.init_states(B, cfg, use_gd=use_gd, device=grays.device)
    out = dict(poses=[], hosts=[], stats=[], means=[], step=step)
    with spy(be, "track_slots", lambda a, k, r: out["stats"].append(r[1])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            st, mean = step(st, grays[:, t], depths[:, t])
            out["poses"].append(st.last_T_cw)
            out["hosts"].append(st.host)
            out["means"].append(mean)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    out["state"] = st
    return out


def slot_diff(torch, a, b) -> list:
    """The fields where two slots' states differ, bit for bit (every tensor,
    the host mirror)."""
    diff = []

    def walk(x, y, path):
        if x is None or y is None:
            if x is not y:
                diff.append(path)
        elif isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)):
                diff.append(path)
        else:
            for f in x._fields:
                walk(getattr(x, f), getattr(y, f), f"{path}/{f}")

    walk(a._replace(host=None), b._replace(host=None), "")
    if a.host != b.host:
        diff.append("host")
    return diff


def run_vs_solo(torch, be, run: dict, b: int, solo: dict) -> list:
    """slot_diff of slot b of `run` against its own B = 1 run, plus the
    stats and host mirrors of every step."""
    diff = slot_diff(torch, be.unstack(run["state"])[b], be.unstack(solo["state"])[0])
    if not torch.equal(torch.stack(run["stats"])[:, b], torch.stack(solo["stats"])[:, 0]):
        diff.append("stats")
    if [h[b] for h in run["hosts"]] != [h[0] for h in solo["hosts"]]:
        diff.append("host mirrors")
    return diff


def slot_ates(torch, metrics, run: dict, T_wc: list) -> list:
    """Each slot's ATE RMSE (m) against the renderer, the poses taken
    relative to the slot's first frame (the tracker's world)."""
    poses = torch.stack(run["poses"]).cpu().numpy()          # [T, B, 4, 4] T_cw
    out = []
    for b in range(poses.shape[1]):
        est = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[:, b]])
        T0inv = np.linalg.inv(T_wc[b][0])
        gt = np.stack([(T0inv @ T)[:3, 3] for T in T_wc[b][:len(est)]])
        out.append(metrics.ate_rmse(est, gt))
    return out


def device_window(torch, fn) -> dict:
    """fn() under torch.profiler with the card's activity only: host ms, the
    union of kernel and copy intervals (device busy), the idle share and the
    device operations. Without the host operators a window of ~76k launches
    is parsed in seconds (profile_window's took ~45 s on a B = 8 step)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:           # no device events parsed without the host's: the full window
        full = profile_window(torch, fn, 1)
        return dict(step_wall_ms_profiled=full["wall_ms"], device_busy_ms=full["device_busy_ms"],
                    device_idle_share=full["device_idle_share"], device_ops=full["device_ops"],
                    window="host and device")
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    return dict(step_wall_ms_profiled=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / wall_us, device_ops=len(spans), window="device")


def waits_and_idle(torch, run: dict, grays, depths, profiled: bool) -> dict:
    """One more step on a run's final states (the frame after its last):
    the host's waits for the card (sync_sites) and, if `profiled`, in a
    second step the card's idle share (device_window)."""
    step, st = run["step"], run["state"]
    T = len(run["poses"])
    sites = sync_sites(torch, lambda: step(st, grays[:, T], depths[:, T]))
    out = dict(waits_per_step=sum(sites.values()), wait_sites=sites)
    if profiled:
        out.update(device_window(torch, lambda: step(st, grays[:, T], depths[:, T])))
    return out


def check_batch_draws(torch, dkw, calls: dict) -> list:
    """categorical_draw on one recorded call of each (rows, logits) shape of
    the batch path, bitwise against its plain twin (indices and noise), its
    ms through the wrapper and its bound."""
    out = []
    for (rows, n), (key, lg, fold, count) in sorted(calls.items()):
        nk, npl = (torch.empty(rows, n, device=lg.device) for _ in range(2))
        a = dkw.categorical_draw(key, lg, rows, fold, noise=nk)
        b = dkw.categorical_draw_plain(key, lg, rows, fold, noise=npl)
        torch.cuda.synchronize()
        out.append(dict(shape=[rows, n], calls=count, index_mismatches=int((a != b).sum()),
                        noise_bits_differing=int((nk.view(torch.int32) !=
                                                  npl.view(torch.int32)).sum()),
                        ms=cuda_ms(torch, lambda: dkw.categorical_draw(key, lg, rows, fold),
                                   reps=100),
                        plain_ms=cuda_ms(torch, lambda: dkw.categorical_draw_plain(
                            key, lg, rows, fold), reps=10, windows=3),
                        **draw_bound(rows, n)))
    return out


def phase_batch(torch, mk, cfg, dev, mods) -> dict:
    """Many sequences on one card (parallel/batch_eval.py, BASELINE config
    5): `batched_track_step` at SlamConfig()'s width (480 x 640, 1500
    features, 8 levels; kmax 64, pmax 8192), slot b from frame 3b.
    Static: B = 1 (each of 8 slots alone), 4 and 8, 20 frames: every slot
    initialized and never lost, ATE <= 0.1 m, each slot of B = 4 and 8
    bitwise its B = 1 run (the state, the stats and host mirrors of every
    step); seconds per step, sequences x frames per second, the host's waits
    per step and the card's idle share. Relocalization: the B = 4 run with
    slot 0 blacked out at frames 3-4: lost at frame 4, recovered by the end
    within 0.1 m of the clean run, the other slots bitwise the clean run.
    GD: B = 4 on the dynamic scene, 12 frames: the ring full, nothing lost,
    each slot bitwise its B = 1 run. The launch counts are set to 0 before
    these runs and read after them; then the path's match_top2 calls (the
    local-map searches of one more B = 8 step, relocalization's all-pairs
    calls, the GD ratio match) and its draws (relocalization's PnP, the GD
    pose RANSAC) are held exactly against their plain twins."""
    be, synthetic, metrics, tracking, geomask, matcher, dkw = mods
    cam, T = cfg.camera, BATCH_FRAMES
    t0 = time.perf_counter()
    grays, depths, T_wc = batch_frames(torch, synthetic, cam, dev, max(BATCH_SIZES), T + 1,
                                       False)
    dg, dd, _ = batch_frames(torch, synthetic, cam, dev, BATCH_GD_SLOTS, BATCH_GD_FRAMES, True)
    pg, pd = grays[:BATCH_RELOC_SLOTS, :T].clone(), depths[:BATCH_RELOC_SLOTS, :T].clone()
    pg[0, BATCH_BLACKOUT[0]:BATCH_BLACKOUT[1] + 1] = 0.0
    pd[0, BATCH_BLACKOUT[0]:BATCH_BLACKOUT[1] + 1] = 0.0
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0

    draw_calls = {}

    def record_draw(a, k, out):
        key, lg, rows = a[:3]
        fold = a[3] if len(a) > 3 else k.get("fold")
        shape = (rows, lg.shape[0])
        first = draw_calls.get(shape, (key, lg, fold, 0))
        draw_calls[shape] = first[:3] + (first[3] + 1,)

    t_runs = time.perf_counter()
    reset_launch_counts(mk)
    solo = [batch_run(torch, be, cfg, grays[b:b + 1, :T], depths[b:b + 1, :T])
            for b in range(max(BATCH_SIZES))]
    runs = {1: solo[0]}
    for B in BATCH_SIZES[1:]:
        runs[B] = batch_run(torch, be, cfg, grays[:B, :T], depths[:B, :T])
    static_launches = dict(match_top2=mk.match_top2.launches, categorical_draw=draw_launches())
    with spy(dkw, "categorical_draw", record_draw):
        reloc, reloc_sites = None, {}

        def run_reloc():
            nonlocal reloc
            reloc = batch_run(torch, be, cfg, pg, pd)

        # the relocalization run under the sync debug mode: its waits by site
        reloc_top2 = record_top2_calls(
            tracking, lambda: reloc_sites.update(sync_sites(torch, run_reloc)))
        gd_solo = [batch_run(torch, be, cfg, dg[b:b + 1], dd[b:b + 1], use_gd=True)
                   for b in range(BATCH_GD_SLOTS)]
        gd = None

        def run_gd():
            nonlocal gd
            gd = batch_run(torch, be, cfg, dg, dd, use_gd=True)

        gd_top2 = record_top2_calls(geomask, run_gd)
    launches = dict(match_top2=mk.match_top2.launches, categorical_draw=draw_launches())
    record_launches("batch")
    seconds = dict(render=render_s, runs=time.perf_counter() - t_runs)
    t_checks = time.perf_counter()

    res = dict(phase="batch", frames=T, sizes=list(BATCH_SIZES), kmax=64, pmax=8192,
               seconds=seconds, launches=launches, launches_static=static_launches)
    b1_fps = None
    for B, run in runs.items():
        secs = (statistics.median(r["seconds"] for r in solo) if B == 1 else run["seconds"])
        fps = B * T / secs
        b1_fps = b1_fps or fps
        res[f"B{B}"] = dict(
            seconds_per_step=secs / T, seq_frames_per_s=fps, against_b1=fps / b1_fps,
            ate_m=slot_ates(torch, metrics, run, T_wc),
            keyframes=[h.n_kf for h in run["hosts"][-1]],
            map_points=run["state"].arena.n_pt.tolist(),
            mean_inliers_last=float(run["means"][-1]),
            all_initialized=all(h.initialized for h in run["hosts"][-1]),
            ever_lost=any(h.lost for hs in run["hosts"] for h in hs),
            bitwise_vs_b1={b: run_vs_solo(torch, be, run, b, solo[b]) for b in range(B)}
            if B > 1 else None,
            **waits_and_idle(torch, run, grays[:B], depths[:B], B == max(BATCH_SIZES)))
    res["B1"]["seconds_per_step_each_slot"] = [r["seconds"] / T for r in solo]
    lost0 = [h[0].lost for h in reloc["hosts"]]
    clean = runs[BATCH_RELOC_SLOTS]
    T_r, T_c = (r["state"].last_T_cw[0].cpu().numpy() for r in (reloc, clean))
    res["reloc"] = dict(
        slot0_lost_by_frame=lost0, err_vs_clean_m=float(np.linalg.norm(T_r[:3, 3] - T_c[:3, 3])),
        neighbours_vs_clean={b: slot_diff(torch, be.unstack(reloc["state"])[b],
                                          be.unstack(clean["state"])[b])
                             for b in range(1, BATCH_RELOC_SLOTS)},
        waits_per_step=sum(reloc_sites.values()) / T, wait_sites=reloc_sites,
        seconds_per_step_sync_debug=reloc["seconds"] / T, reloc_top2_calls=len(reloc_top2))
    res["gd"] = dict(
        frames=BATCH_GD_FRAMES, ring_counts=[h.gd_count for h in gd["hosts"][-1]],
        ring_count_tensors=gd["state"].gd.count.tolist(),
        ever_lost=any(h.lost for hs in gd["hosts"] for h in hs),
        all_initialized=all(h.initialized for h in gd["hosts"][-1]),
        keyframes=[h.n_kf for h in gd["hosts"][-1]],
        seconds_per_step=gd["seconds"] / BATCH_GD_FRAMES,
        bitwise_vs_b1={b: run_vs_solo(torch, be, gd, b, gd_solo[b])
                       for b in range(BATCH_GD_SLOTS)})

    # the kernels on the path's call shapes, after the counted runs
    seconds["checks_waits_idle"] = time.perf_counter() - t_checks
    t_kernels = time.perf_counter()
    big = runs[max(BATCH_SIZES)]
    track_top2 = record_top2_calls(
        matcher, lambda: big["step"](big["state"], grays[:, T], depths[:, T]))
    sites = (top2_call_sites(torch, mk, track_top2, "batch_track") +
             top2_call_sites(torch, mk, reloc_top2, "batch_reloc_all_pairs") +
             top2_call_sites(torch, mk, gd_top2, "batch_gd_ratio"))
    res["match_top2_call_sites"] = sites
    res["draws"] = check_batch_draws(torch, dkw, draw_calls)
    seconds["kernels"] = time.perf_counter() - t_kernels
    res["card"] = nvidia_smi_line()
    emit(res)

    bad = []
    for B, run in runs.items():
        r = res[f"B{B}"]
        if not r["all_initialized"] or r["ever_lost"] or max(r["ate_m"]) > BATCH_GUARD_M:
            bad.append(f"B={B}: initialized {r['all_initialized']}, lost {r['ever_lost']}, "
                       f"ATE {r['ate_m']}")
        if B > 1 and any(r["bitwise_vs_b1"].values()):
            bad.append(f"B={B}: slots differ from their B = 1 runs: {r['bitwise_vs_b1']}")
    rr = res["reloc"]
    if not (lost0[BATCH_BLACKOUT[1]] and not lost0[-1] and
            rr["err_vs_clean_m"] < BATCH_GUARD_M) or any(rr["neighbours_vs_clean"].values()):
        bad.append(f"reloc: {rr}")
    g = res["gd"]
    if g["ring_counts"] != [BATCH_GD_FRAMES] * BATCH_GD_SLOTS or \
            g["ring_count_tensors"] != g["ring_counts"] or g["ever_lost"] or \
            not g["all_initialized"] or any(g["bitwise_vs_b1"].values()):
        bad.append(f"gd: {g}")
    if min(launches.values()) < 1 or not (reloc_top2 and gd_top2 and track_top2):
        bad.append(f"a kernel of the path was not launched: {launches}")
    if any(c["max_abs_err"] for c in sites) or \
            any(d["index_mismatches"] or d["noise_bits_differing"] for d in res["draws"]):
        bad.append("a kernel differs from its plain twin on the batch path's calls")
    if bad:
        fail("batch: " + "; ".join(bad))
    return res


def same_arrays(a: dict, b: dict) -> dict:
    """{key: bitwise equal} over two dicts of arrays and numbers."""
    return {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))) for k in a}


def run_summary(slam) -> dict:
    tr = slam.tracker
    n = tr.n_kf_host
    return dict(traj=np.stack([T for _, T in tr.camera_trajectory()]),
                kf_pose=tr.arena.kf_pose[:n].cpu().numpy(), map_points=slam.map_point_count)


def deterministic_mode_warnings(torch, fn) -> list:
    """The first line of every warning torch's deterministic mode (warn
    only) raises while fn runs: the ops on the path that have no ordered
    implementation. The mode is switched off again after."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:160] for w in caught
                   if "deterministic" in str(w.message)})


def run(torch, dev, cfg, n_frames: int = N_FRAMES, keyframes=(3, 5),
        keyframes_pipelined=(4, 7), ab_source=None) -> int:
    """All phases on device `dev` at configuration `cfg`. keyframes,
    keyframes_pipelined: the ranges the slices must land in, around what the
    JAX package with its defaults gives on these 60 frames (4, and 5
    pipelined; run on the CPU on the same scene from its own renderer). The
    pipelined range is wider on the upper side: a keyframe decided by the
    reference-match ratio is followed by another on each later frame of the
    same flush, because the new keyframe's match count is read only at the
    next flush (in both packages), so the count moves by one or two with the
    place of a trigger inside its flush; `keyframe_frames` shows the pairs."""
    from gdslam_tpu_torch.backend import ba, gba, mapping, optimizer, pose_graph, solvers
    from gdslam_tpu_torch.backend import keyframe_db as kdb
    from gdslam_tpu_torch.backend import loop_closing
    from gdslam_tpu_torch.core import camera as cam_ops
    from gdslam_tpu_torch.frontend import extractor, matcher
    from gdslam_tpu_torch.frontend.frame import build_frame
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.masking import geomask, geometry
    from gdslam_tpu_torch.ops import edges as edge_ops
    from gdslam_tpu_torch.ops import flow as flow_ops
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.system import slam as slam_mod
    from gdslam_tpu_torch.system import tracking
    from gdslam_tpu_torch.system.slam import System
    from gdslam_tpu_torch.system.tracking import TrackState
    from gdslam_tpu_torch.utils import metrics

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))
    emit(phase_build(mk))
    old = OldKernel(torch, mk, Path(ab_source)) if ab_source else None

    cam = cfg.camera
    t0 = time.perf_counter()
    frames = [synthetic.render_frame(i, cam, with_dynamic=False, device=dev)
              for i in range(n_frames + 6)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    ones = torch.ones_like(frames[0].gray)
    kframes = [build_frame(extractor.extract(f.gray, cfg.orb, cam.height, cam.width),
                           f.depth, ones, cam) for f in frames[:6]]
    kres, err = phase_kernel(torch, mk, kframes, dev, old)
    emit(kres)
    drawres = phase_draw(torch, dev)
    orbres = phase_orb(torch, cfg, dev)

    slice_args = (cfg, frames[:n_frames], System, TrackState, synthetic, metrics, dev, keyframes)
    with record_pose_calls("slice"):
        slam, sres = phase_slice(torch, mk, *slice_args, modules=(mapping, ba))
    if not (sres["local_ba_runs"] >= 1 and sres["triangulated"] >= 0):
        fail("the default slice ran no local BA")
    slam_pipe, pres = phase_slice(torch, mk, *slice_args[:-1], keyframes_pipelined,
                                  label="slice_pipelined", pipeline=True,
                                  modules=(mapping, ba))
    if old is not None:
        phase_slice_ab(torch, mk, matcher, old, slice_args)
    with record_pose_calls("reloc"):
        rres, pnp, rigid = phase_reloc(torch, mk, slam, frames, n_frames, cfg, TrackState,
                                       solvers, tracking)
    phase_compact(torch, mk, slice_args, frames[n_frames:n_frames + 3],
                  sres["keyframe_slots_used"] + 1)
    # The compact phase's saturated run is the slice's work once more, not
    # pipelined; with a second pipelined run after it the two modes have
    # alternated (not, pipelined, not, pipelined) inside one process.
    slam_pipe2, pres2 = phase_slice(torch, mk, *slice_args[:-1], keyframes_pipelined,
                                    label="slice_pipelined_again", pipeline=True)
    # determinism: the default slice once more not pipelined, to hold against
    # the first run as the two pipelined runs are held against each other
    slam_again, _ = phase_slice(torch, mk, *slice_args, label="slice_again")

    def short_slices():
        for pipeline in (False, True):
            s = System(cfg, kmax=256, pmax=65536, pipeline=pipeline, device=dev)
            for i, fr in enumerate(frames[:20]):
                s.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
            s.shutdown()

    nondet_ops = deterministic_mode_warnings(torch, short_slices)

    # the main path: GD masking on the dynamic scene
    t0 = time.perf_counter()
    dyn = [synthetic.render_frame(i, cam, with_dynamic=True, device=dev)
           for i in range(GD_FRAMES + GD_PROFILE_FRAMES + 1)]
    raw = gd_inputs(dyn, cam)
    gd_render_s = time.perf_counter() - t0
    counters_args = (matcher, tracking, geomask, solvers, slam_mod)
    with record_pose_calls("gd_slice"):
        gd_slam, gres, n_gd = phase_gd_slice(torch, mk, cfg, dyn, raw, System, TrackState,
                                             synthetic, metrics, dev, counters_args)
    sgres = phase_gd_staged(torch, mk, cfg, dyn, raw, System, TrackState, synthetic, metrics,
                            dev, counters_args)

    # the DynaSLAM geometry path, inpainting and the CLIs, on the same scene
    with record_pose_calls("geom_slice"):
        geom_slam, geores, n_geom = phase_geom_slice(torch, mk, cfg, dyn, System, TrackState,
                                                     synthetic, metrics, dev, counters_args)
    geostres = phase_geom_staged(torch, mk, cfg, dyn, System, TrackState, synthetic, metrics,
                                 dev)
    gdires = phase_gd_inpaint(torch, mk, cfg, dyn, System, TrackState, synthetic, metrics, dev)

    # the live segmenter: the port's seeded ResNet50 weights, written once,
    # run by rgbd_tum --segmenter (cli) and on the argc==6 route (seg)
    seg_weights = ROOT / "build" / "seg" / "maskrcnn_r50_seed0.npz"
    seg_winfo = write_seg_weights(seg_weights)
    clires = phase_cli(torch, mk, cfg, dyn, metrics, dev, seg_weights)
    segres, seg_rgbs = phase_seg(torch, mk, cfg, dyn, System, synthetic, metrics, dev,
                                 seg_weights, seg_winfo)

    # Mask R-CNN training: the full-width fit (its second run is the
    # determinism pair's other half), then the JAX e2e test's toy fit run
    # live by rgbd_tum
    trainres, trained, train_data = phase_seg_train(torch, dev, dyn)
    trained_again = seg_train_run(torch, dev, train_data)[0]
    toyres = phase_seg_toy(torch, mk, cfg, dev, metrics)

    # loop closing and BoW place recognition: the revisit run at full width,
    # a forced loss relocalized on its map, then twice at the JAX test's
    # size, where the reference closes a loop
    t0 = time.perf_counter()
    lframes = loop_frames(torch, synthetic, cfg, dev, LOOP_FULL_FRAMES + 1)
    scfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
        bf=320.0 * 0.08), orb=dataclasses.replace(cfg.orb, n_features=512, n_levels=4))
    sframes = loop_frames(torch, synthetic, scfg, dev, LOOP_FRAMES)
    loop_render_s = time.perf_counter() - t0
    loop_mods = (loop_closing, pose_graph, gba, matcher, tracking)
    loop_slam, lres, _, _ = phase_loop(torch, mk, cfg, lframes[:LOOP_FULL_FRAMES], System,
                                       TrackState, synthetic, metrics, dev, loop_mods, "loop",
                                       expect_loop=False,
                                       reference=dict(LOOP_JAX_FULL, frames=LOOP_FRAMES))
    lres_reloc = phase_loop_reloc(torch, mk, loop_slam, lframes[LOOP_FULL_FRAMES],
                                  LOOP_FULL_FRAMES, kdb, loop_closing,
                                  TrackState, "loop_reloc")
    small = [phase_loop(torch, mk, scfg, sframes, System, TrackState, synthetic, metrics, dev,
                        loop_mods, label, expect_loop=True, kmax=64, pmax=32768,
                        reference=LOOP_JAX_SMALL) for label in ("loop_small", "loop_small_again")]
    first = small[0][3]
    if first is None:
        fail("loop_small: no correction to measure the loop closer's call sites on")
    ltr = loop_slam.tracker
    cur, cand = revisit_pair(ltr)
    loop_st, loop_calls = phase_loop_stages(
        torch, mk, [("full_width_revisit_pair", ltr.arena, cur, cand, ltr.loop_closer),
                    ("small_first_correction", *first[:3], small[0][0].tracker.loop_closer)],
        cfg, loop_mods)

    # stereo and monocular tracking through their drivers (KITTI00-02 stereo,
    # mono TUM), and the free-scale loop closing that only the monocular
    # sensor reaches
    from gdslam_tpu_torch.backend import vocabulary as voc
    from gdslam_tpu_torch.cli import mono_tum, stereo_kitti
    from gdslam_tpu_torch.frontend import initializer
    from gdslam_tpu_torch.io import kitti, png
    from gdslam_tpu_torch.ops import stereo
    with record_pose_calls("stereo"):
        stres, stereo_same = phase_stereo(torch, mk, cfg, dev, (
            stereo, matcher, slam_mod, kitti, png, synthetic, metrics, extractor, stereo_kitti))
    with record_pose_calls("mono"):
        mores, mono_same = phase_mono(torch, mk, cfg, dev, (
            tracking, initializer, slam_mod, png, synthetic, metrics, mono_tum))
    mlres = phase_mono_loop(torch, mk, cfg, dev, (tracking.Tracking, loop_closing.LoopCloser, voc,
                                                  synthetic))

    # many sequences at once on the card (parallel/batch_eval.py)
    from gdslam_tpu_torch.ops import draw_kernel
    from gdslam_tpu_torch.parallel import batch_eval
    with record_pose_calls("batch"):
        bres = phase_batch(torch, mk, cfg, dev, (batch_eval, synthetic, metrics, tracking,
                                                 geomask, matcher, draw_kernel))

    # the pose solve's kernel against its twin on its cases and on the calls
    # recorded at every path's call sites above
    poseres = phase_pose(torch, dev)

    # determinism: every pair of runs bitwise identical
    geo_db, im, depth_i, mask_i, T_i = geostres.pop("inpaint_inputs")
    inp = [geo_db.inpaint_frames(im, depth_i, mask_i, T_i) for _ in range(2)]
    torch.cuda.synchronize()
    det = dict(slice_sync=same_arrays(run_summary(slam), run_summary(slam_again)),
               slice_pipelined=same_arrays(run_summary(slam_pipe), run_summary(slam_pipe2)),
               loop_small=same_arrays(small[0][2], small[1][2]),
               inpaint=dict(rgb=bool(torch.equal(inp[0][0], inp[1][0])),
                            depth=bool(torch.equal(inp[0][1], inp[1][1]))),
               segmenter=seg_determinism(torch, seg_weights, dev, seg_rgbs, cam),
               seg_train=dict(parameters=all(np.array_equal(trained[k], trained_again[k])
                                             for k in trained)),
               stereo=stereo_same, mono=mono_same)
    all_same = all(v for d in det.values() for v in d.values())
    emit(dict(phase="determinism", bitwise_identical=all_same, compared=det,
              deterministic_mode_warnings=nondet_ops, loop_render_s=loop_render_s))
    if not all_same:
        fail(f"determinism: two runs differ: {det}")
    stages, path_calls, gn_call, ba_call = phase_stages(
        torch, mk, slam, frames[n_frames], cfg,
        (extractor, build_frame, tracking, optimizer, matcher, mapping, ba), (pnp, rigid), old)
    stages["ms"]["whole_frame"] = sres["frame_ms_median"]
    stages["ms"]["whole_frame_mean"] = sres["frame_ms_mean"]
    stages["ms"]["whole_frame_mean_pipelined"] = [pres["frame_ms_mean"], pres2["frame_ms_mean"]]
    stages["ms"]["relocalize"] = rres["relocalize_ms"]
    stages["render_s"] = render_s
    emit(stages)
    gstages, gd_call = phase_gd_stages(torch, mk, gd_slam, raw[n_gd], cfg,
                                       (extractor, geomask, flow_ops, edge_ops, slam_mod,
                                        solvers, cam_ops))
    gstages["ms"]["whole_gd_frame_pipelined"] = gres["frame_ms"]
    gstages["ms"]["whole_gd_frame_staged"] = sgres["frame_ms_median"]
    gstages["render_s"] = gd_render_s
    emit(gstages)
    path_calls.append(gd_call)
    geo_st = phase_geom_stages(torch, geom_slam, dyn[n_geom],
                               dyn[n_geom + 1:n_geom + 1 + PROFILED_FRAMES], n_geom + 1, cfg,
                               (geometry, extractor, build_frame))
    geo_st["ms"]["whole_geom_frame_pipelined"] = geores["frame_ms"]
    geo_st["ms"]["whole_geom_frame_staged_with_inpaint"] = geostres["frame_ms_median"]
    geo_st["ms"]["whole_gd_inpaint_frame"] = gdires["frame_ms_median"]
    emit(geo_st)
    emit(phase_profile(torch, slam, slam_pipe, frames[n_frames + 1:n_frames + 1 + PROFILED_FRAMES],
                       n_frames + 1, gn_call,
                       ba_call, gd_slam, raw[n_gd:n_gd + PROFILED_FRAMES], n_gd))

    local_map = path_calls[1]
    by_path = dict(gd_slice=gres["match_top2_launches"],
                   gd_staged=sgres["match_top2_launches"],
                   slice=sres["match_top2_launches"],
                   slice_pipelined=pres["match_top2_launches"],
                   reloc=rres["match_top2_launches"],
                   geom_slice=geores["match_top2_launches"],
                   geom_staged=geostres["match_top2_launches"],
                   gd_inpaint=gdires["match_top2_launches"],
                   cli=clires["match_top2_launches"],
                   loop=lres["match_top2_launches"],
                   loop_small=small[0][1]["match_top2_launches"],
                   loop_reloc=lres_reloc["match_top2_launches"],
                   seg=segres["launches"]["match_top2"],
                   stereo=stres["launches"]["match_top2"],
                   mono=mores["launches"]["match_top2"],
                   mono_loop=mlres["match_top2_launches"],
                   batch=bres["launches"]["match_top2"])
    if min(by_path.values()) < 1:
        fail(f"a path launched no kernel: {by_path}")
    seg_sites = segres["kernels"]["score_th_0.7"]
    detect_lines = []
    for name in SEG_DET_KERNELS:
        sites = [c for c in seg_sites if c["name"] == name]
        zero = [c for c in segres["kernels"]["score_th_0"] if c["name"] == name]
        detect_lines.append({
            "name": name, "route": "cuda", "source": f"gdslam_tpu_torch/csrc/{name}.cu",
            "replaces": SEG_REPLACES[name],
            "launches": segres["launches"][name],
            "launches_per_frame": segres["launches_per_frame"][name],
            "launches_by_path": dict(seg=segres["launches"][name],
                                     seg_train=trainres["launches"][name],
                                     seg_toy=toyres["launches"][name],
                                     cli=clires["detect_launches"][name]),
            "max_abs_err": max(c["max_abs_err"] for c in sites + zero),
            "ms": sites[0]["ms"], "plain_ms": sites[0]["plain_ms"],
            "bound_ms": sites[0]["bound_ms"], "bound_by": sites[0]["bound_by"],
            "library_ms": None, "library_note": SEG_NO_LIBRARY,
            "device_ms": sites[0]["device_ms"], "role": sites[0]["role"],
            "shape": sites[0]["shape"],
            "call_sites": [{k: c.get(k) for k in ("role", "shape", "ms", "device_ms", "plain_ms",
                                                  "bound_ms", "bound_by", "max_abs_err",
                                                  "bound_note")}
                           for c in sites]})
    bwd = trainres["backward_kernel"]
    detect_lines.append({
        "name": "roi_align_backward", "route": "cuda",
        "source": "gdslam_tpu_torch/csrc/roi_align_backward.cu",
        "replaces": BACKWARD_REPLACES + " (its transpose under jax.grad)",
        "launches": trainres["launches"]["roi_align_backward"],
        "launches_per_step": trainres["launches_per_step"]["roi_align_backward"],
        "launches_by_path": dict(seg_train=trainres["launches"]["roi_align_backward"],
                                 seg_toy=toyres["launches"]["roi_align_backward"]),
        "max_abs_err": max(c["max_abs_err"] for c in bwd),
        "ms": bwd[0]["ms"], "plain_ms": bwd[0]["plain_ms"], "bound_ms": bwd[0]["bound_ms"],
        "bound_by": bwd[0]["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call computes it: index_add_ would need the gather and the "
                        "two products first, and sums by atomics in a changing order",
        "device_ms": bwd[0]["device_ms"], "shape": bwd[0]["shape"],
        "call_sites": [{k: c[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                          "bound_by", "max_abs_err", "longest_run")}
                       for c in bwd]})
    sk = stres["kernel"][0]
    detect_lines.append({
        "name": "stereo_match", "route": "cuda", "source": "gdslam_tpu_torch/csrc/stereo_match.cu",
        "replaces": "gdslam_tpu/ops/stereo.py:28",
        "replaces_note": "XLA-fused in the JAX package, no Pallas",
        "launches": stres["launches"]["stereo_match"],
        "launches_per_frame": stres["launches_per_frame"]["stereo_match"],
        "launches_by_path": dict(stereo=stres["launches"]["stereo_match"]),
        "max_abs_err": max(k["max_abs_err"] for k in stres["kernel"]),
        "ms": sk["ms"], "plain_ms": sk["plain_ms"], "bound_ms": sk["bound_ms"],
        "bound_by": sk["bound_by"], "library_ms": None, "library_note": STEREO_NO_LIBRARY,
        "device_ms": sk["device_ms"], "bound_all_pairs_ms": sk["bound_all_pairs_ms"],
        "cuda_launches_per_call": sk["cuda_launches_per_call"],
        "launch_floor_device_ms": [sk["launch_floor_device_ms_1"],
                                   sk["launch_floor_device_ms_2"]],
        "redesigned": "row buckets (a counting sort by row), the band walk, the SAD on "
                      "all 32 lanes",
        "shape": sk["shape"], "exact_on": [k["images"] for k in stres["kernel"]]})
    dt = drawres["timing"]
    detect_lines.append({
        "name": "categorical_draw", "route": "cuda",
        "source": "gdslam_tpu_torch/csrc/categorical_draw.cu", "replaces": DRAW_REPLACES,
        "replaces_note": "jax.random.categorical, XLA-fused in the JAX package, no Pallas",
        "launches": gres["categorical_draw_launches"],
        "launches_by_path": dict(gd_slice=gres["categorical_draw_launches"],
                                 gd_staged=sgres["categorical_draw_launches"],
                                 reloc=rres["categorical_draw_launches"],
                                 mono=mores["launches"]["categorical_draw"],
                                 loop_small=small[0][1]["categorical_draw_launches"],
                                 batch=bres["launches"]["categorical_draw"]),
        "max_abs_err": max(c["index_mismatches"] + c["noise_bits_differing"]
                           for c in drawres["checks"] + bres["draws"]),
        "batch_shapes": [{k: c[k] for k in ("shape", "calls", "ms", "plain_ms", "bound_ms",
                                            "bound_by")} for c in bres["draws"]],
        "ms": dt["ms"], "plain_ms": dt["plain_ms"], "bound_ms": dt["bound_ms"],
        "bound_by": dt["bound_by"], "library_ms": None, "library_note": DRAW_NO_LIBRARY,
        "device_ms": dt["device_ms"], "multinomial_ms": dt["multinomial_ms"],
        "multinomial_device_ms": dt["multinomial_device_ms"],
        "numpy_replay_host_ms": dt["numpy_replay_host_ms"], "shape": dt["shape"],
        "reloc_shape": {k: drawres["timing_reloc"][k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms")},
        "redesigned": "a CTA a row over 4 warps, two hash chains a thread, the "
                      "noise store in its own variant"})
    orb_lines = []
    for name in ORB_KERNELS:
        t = orbres["kernels"][name]
        by = {path: counts[name] for path, counts in ORB_BY_PATH.items()}
        orb_lines.append({
            "name": name, "route": "cuda", "source": "gdslam_tpu_torch/csrc/orb_extract.cu",
            "replaces": ORB_REPLACES[name],
            "replaces_note": ORB_REPLACES_NOTE[name] + "; XLA-fused in the JAX package's "
                             "extract, no Pallas",
            "launches": by["gd_slice"], "launches_by_path": by,
            "max_abs_err": float(max(c["differing"][name] for c in orbres["cases"].values())),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_note": t["library_note"], "device_ms": t["device_ms"],
            **{k: t[k] for k in ("bound_all_planes_ms", "bound_all_arcs_ms") if k in t},
            "shape": t["shape"], "exact_on": list(orbres["cases"])})
    if min(n for line in orb_lines for n in line["launches_by_path"].values()) < 1:
        fail(f"a path launched no front-end kernel: {ORB_BY_PATH}")
    if min(POSE_BY_PATH.get(p, 0) for p in POSE_PATHS) < 1:
        fail(f"a path launched no pose_gn: {POSE_BY_PATH}")
    pt = poseres["timing"]["gd_slice:track_local_map"]
    pose_line = {
        "name": "pose_gn", "route": "cuda", "source": "gdslam_tpu_torch/csrc/pose_gn.cu",
        "replaces": POSE_REPLACES, "replaces_note": POSE_REPLACES_NOTE,
        "launches": POSE_BY_PATH["gd_slice"], "launches_by_path": dict(POSE_BY_PATH),
        "max_abs_err": max(c["max_abs_err"] for c in
                           list(poseres["cases"].values()) + poseres["call_sites"]),
        "differing": sum(c["differing"] for c in
                         list(poseres["cases"].values()) + poseres["call_sites"]),
        "ms": pt["ms"], "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
        "bound_by": pt["bound_by"], "library_ms": None, "library_note": POSE_NO_LIBRARY,
        "device_ms": pt["device_ms"], "one_sm_ms": pt["one_sm_ms"], "shape": pt["shape"],
        "exact_on": list(poseres["cases"]) + [f"{c['path']}:{c['site']}"
                                              for c in poseres["call_sites"]],
        "call_sites": {k: {f: v[f] for f in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                             "bound_by", "one_sm_ms")}
                       for k, v in poseres["timing"].items()}}
    top2_sites = path_calls + loop_calls + stres["match_top2_call_sites"] + \
        mores["bootstrap_match"]["call_sites"] + bres["match_top2_call_sites"]
    emit(dict(phase="phase_seconds", seconds=dict(PHASE_SECONDS),
              total_s=time.perf_counter() - T_START))
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [{
        "name": "match_top2", "route": "cuda",
        "source": "gdslam_tpu_torch/csrc/match_top2.cu",
        "replaces": "gdslam_tpu/ops/pallas_match.py:98",
        "launches": by_path["gd_slice"], "launches_by_path": by_path,
        "launches_by_site_gd_slice": gres["match_top2_by_site"],
        "launches_by_site_geom_slice": geores["match_top2_by_site"],
        "launches_by_site_loop": lres["match_top2_by_site"],
        "launches_by_site_loop_small": small[0][1]["match_top2_by_site"],
        "max_abs_err": max([err] + [c["max_abs_err"] for c in top2_sites]),
        "ms": local_map["ms"], "plain_ms": local_map["plain_ms"],
        "bound_ms": local_map["bound_ms"], "bound_by": local_map["bound_by"],
        "library_ms": None, "library_note": TOP2_NO_LIBRARY,
        "bound_all_pairs_ms": local_map["bound_all_pairs_ms"],
        "launch_floor_ms": stages["launch_floor_ms_2"],
        "cuda_launches_per_call": local_map["cuda_launches_per_call"],
        "path": local_map["path"], "device_ms": local_map["device_ms"],
        "first_call_ms": local_map["first_call_ms"], "grid_ms": local_map["grid_ms"],
        "shape": [local_map["M"], local_map["N"]], "role": local_map["role"],
        "call_sites": [{k: c[k] for k in ("role", "M", "N", "path", "ms", "device_ms",
                                          "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                       for c in top2_sites]}, *detect_lines, *orb_lines, pose_line]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab-source", help="an earlier version of the kernel's source to time "
                    "and to run the slice against")
    opts = ap.parse_args()
    if not (ROOT / "gdslam_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: gdslam_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    LINES_FILE.unlink(missing_ok=True)

    from gdslam_tpu_torch import SlamConfig
    return run(torch, "cuda", SlamConfig(), ab_source=opts.ab_source)


if __name__ == "__main__":
    sys.exit(main())
