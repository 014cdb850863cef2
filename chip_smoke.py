#!/usr/bin/env python3
"""Smoke run of gdslam_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --ab-source old/match_top2.cu

Builds the port's CUDA kernels from gdslam_tpu_torch/csrc/ into build/kernels/,
then prints one JSON line per phase:

  device   the card (torch and nvidia-smi);
  build    the nvcc build, timed, and what ptxas reports for the kernels;
  kernel   match_top2 (CUDA) against match_top2_plain (PyTorch) on the card,
           exactly, with the kernel choosing its path and with each path
           forced: seeded random and rendered-frame inputs at (M, N) =
           (1500, 1500) and (4096, 1500), and the inputs a cell walk can get
           wrong (clustered keypoints, cell and image borders, radii of 0,
           one cell, beyond the image, mixed per row, ties across cells,
           invalid and empty sides, non-finite values); the keypoint grid
           against kp_grid_plain; both versions' times;
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
  stages   per-stage times on the slice's final state (the tracking
           programs, the keyframe program and its parts, the RANSACs), and
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
           a profiler window over 10 whole geometry frames;
  profile  torch.profiler windows over whole frames (pipelined and not, and
           GD frames), over one pose solve and over one local BA: device
           busy share, device operations, host operators.

Then the seconds each phase took (phase_seconds), the card's name and power
limit as nvidia-smi gives them, the kernels line and, last, the ok line. Without a card, or when any phase fails, it
exits non-zero and prints no ok line.

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
import copy
import ctypes
import dataclasses
import json
import os
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
GEOM_STAGED_FRAMES = 20
GD_INPAINT_FRAMES = 20
GEOM_JAX_QUALITY = dict(ate_m=0.0423, mask_recall=1.0, mask_iou=0.715)
CLI_FRAMES = 40
CLI_EPOCH = 1305031790.0       # TUM epoch seconds: timestamps must stay float64


PHASE_SECONDS: dict = {}           # each phase line: seconds since the line before it
_LAST_LINE = [time.perf_counter()]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
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

def phase_build(mk) -> dict:
    t0 = time.perf_counter()
    so = mk.build_library()
    build_s = time.perf_counter() - t0
    mk._load_library()
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in mk.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        out = subprocess.run([mk._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
                              os.path.join(tmp, "k.cubin"), str(mk._SRC)],
                             capture_output=True, text=True, timeout=300, check=True)
    ptxas = [ln.strip() for ln in out.stderr.splitlines() if "Used" in ln or "spill" in ln]
    return dict(phase="build", library=str(so.relative_to(ROOT)), seconds=build_s,
                nvcc_flags=list(mk.NVCC_FLAGS), ptxas=ptxas)


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


def sync_sites(torch, fn) -> dict:
    """Where fn waits for the card, by torch's sync debug mode: {file:line:
    count} of every implicit synchronisation (.tolist(), .cpu(), int() of a
    device scalar, an upload of a host value)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)).most_common(12))


def reset_launch_counts(mk) -> None:
    mk.match_top2.launches = mk.match_top2.cuda_launches = mk.kp_grid.launches = 0


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
    launches = mk.match_top2.launches
    err_m, err_deg = pose_error(np.asarray(T), fr.T_wc.cpu().numpy(),
                                frames[0].T_wc.cpu().numpy())
    res = dict(phase="reloc", relocalized=len(calls), state=tr.state.name,
               n_inliers=tr.n_inliers, err_m=err_m, err_deg=err_deg, frame_ms=frame_ms,
               keyframes=tr.n_kf_host, match_top2_launches=launches)
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
    gen = torch.Generator(device=pw.device)
    pnp = lambda: solvers.ransac_pnp(pw, frame.uv, has_pt, K, px_threshold=5.991 ** 0.5,  # noqa: E731
                                     generator=gen.manual_seed(1))
    q = tracking.cam_ops.backproject(frame.uv, frame.depth, cam)
    rigid = lambda: solvers.ransac_rigid(pw, q, has_pt & (frame.depth > 0), K, frame.uv,  # noqa: E731
                                         px_threshold=5.991 ** 0.5 * 2,
                                         generator=gen.manual_seed(1))
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
    if launches < 6:
        fail(f"relocalization launched match_top2 {launches} times")
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
    launches, grids = mk.match_top2.launches, mk.kp_grid.launches
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
               kp_grid_launches=grids, keyframes=slam.keyframe_count,
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
    res = dict(phase="gd_staged", frames=n, pipeline=False, dynamic_scene=True,
               all_ok=all(s == TrackState.OK for s in states),
               frame_ms_median=statistics.median(steady), frame_ms_max=steady[-1],
               first_frame_ms=times[0], host_syncs=syncs, host_syncs_per_frame=syncs / n,
               host_sync_sites=dict(sites.most_common(12)),
               packed_fast_path_frames=counters.packed,
               pose_ransac_ok_share=counters.pose_ok_share(torch, cfg.geomask.min_matches),
               match_top2_launches=mk.match_top2.launches,
               match_top2_by_site=dict(counters.sites), keyframes=slam.keyframe_count,
               mask_recall=recall, mask_iou=iou, quality_frames=n - 10,
               jax_tpu_quality_reference=GD_JAX_QUALITY, card=nvidia_smi_line(),
               **ate_pair(torch, synthetic, metrics, traj,
                          [f.T_wc.cpu().numpy() for f in frames[:n]]))
    emit(res)
    gd_guards(res, n, len(traj))
    if counters.packed != 0 or counters.sites["gd_cur_x_ref"] != n - cfg.geomask.inter_frame_size:
        fail(f"gd_staged: the staged path was not taken ({counters.packed} packed frames, "
             f"{dict(counters.sites)})")
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
    gen = lambda: solvers.frame_generator(0, dev)                           # noqa: E731
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
                               px_threshold=4.0, generator=gen())
    flow = flow_ops.farneback_flow(gray, ref_gray, levels=5, finest_level=finest,
                                   upsample=s == 1)
    cam_h = dataclasses.replace(cam, fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s,
                                cy=cam.cy / s, width=-(-cam.width // s),
                                height=-(-cam.height // s))

    def gd_step():
        return geomask.gd_step(gray, depth, sem, ref_gray, ref_depth, ref_feats, cfg, gen())

    sites = sync_sites(torch, gd_step)
    if sites:
        fail(f"gd_step synchronises with the card at {sites}")
    stages = {
        "gd_step": stage_numbers(torch, gd_step),
        "gd_step_core": stage_numbers(torch, lambda: geomask.gd_step_core(
            feats, gray, depth, sem, ref_gray, ref_depth, ref_feats, cfg, gen())),
        "farneback_flow": stage_numbers(torch, lambda: flow_ops.farneback_flow(
            gray, ref_gray, levels=5, finest_level=finest, upsample=s == 1)),
        "mahalanobis_mask": stage_numbers(torch, lambda: geomask.mahalanobis_mask(
            depth, ref_depth, flow, res.T, sem, cfg, False, ref_gray=gray, cur_gray=ref_gray,
            flow_factor=s)),
        "depth_edges": stage_numbers(torch, lambda: edge_ops.depth_edges(depth[::s, ::s], cam_h)),
        "cur_x_ref_match": stage_numbers(torch, lambda: geomask.ratio_matches(
            feats, ref_feats, cfg.orb.n_levels)),
        "ransac_rigid": stage_numbers(torch, lambda: solvers.ransac_rigid(
            P, Q, good, K, uv_q, n_iters=300, min_inliers=20, px_threshold=4.0,
            generator=gen())),
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


def phase_cli(torch, mk, cfg, frames, metrics, dev) -> dict:
    """The CLIs as a user runs them, on a TUM-layout sequence of the
    dynamic scene (CLI_FRAMES frames at full size, written with io/png.py
    into a directory under build/): rgbd_tum in its three modes (plain; the
    mask cache, which runs the geometry path; an output directory, GD
    masking with inpainting), then evaluate --mode gd and --mode geometry
    with the mask cache and --ref-masks. Gates as the JAX CLI tests use
    them: plain ATE < 0.30 m, masked < 0.08 m, GD (evaluate and rgbd_tum's
    output mode) < 0.15 m; the trajectory files parse and the first
    keyframe keeps its epoch timestamp to within 2 s; the output PNGs read
    back and round-trip through io/png.py."""
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
    reset_launch_counts(mk)
    runs = {}
    for mode, extra, gate in (("plain", [], 0.30), ("geometry", [masks], 0.08),
                              ("gd_inpaint", [masks, str(base / "out")], 0.15)):
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
    res = dict(phase="cli", frames=CLI_FRAMES, width=cfg.camera.width,
               height=cfg.camera.height, write_s=write_s,
               native_loader=native_loader.available(),
               match_top2_launches=mk.match_top2.launches, runs=runs, card=nvidia_smi_line())
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

    # the tracking programs and the keyframe program wait for the card nowhere
    # (the keyframe program when it is given the cursor)
    for name, fn in (("track_frame_core", lambda: tracking.track_frame_core(
            arena, last, vel, True, fr, cfg, tr.ref_kf)), ("keyframe_program",
                                                           full_keyframe(True, True))):
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
    operators by self CPU time ([calls, ms]), all per unit of n. The
    profiler's own overhead lengthens the host time."""
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
    return dict(wall_ms=wall_us / 1e3 / n, device_busy_ms=busy / 1e3 / n,
                device_idle_share=(1.0 - busy / wall_us) if busy > 0 else None,
                device_ops=len(dev) / n,
                top_device_ms={k[:80]: v / 1e3 / n for k, v in top},
                top_host_ops={e.key[:60]: [e.count / n, e.self_cpu_time_total / 1e3 / n]
                              for e in host})


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
               match_top2_by_site=dict(probe.sites), card=nvidia_smi_line())
    emit(res)
    if not res["all_ok"] or len(traj) != len(frames):
        fail(f"{label}: a frame was not tracked OK ({len(traj)} poses)")
    genuine = [l for l in res["loops"] if l[0] - l[1] >= LOOP_MIN_SPAN]
    if expect_loop and not genuine:
        fail(f"{label}: no loop with cur - cand >= {LOOP_MIN_SPAN}: {res['loops']}")
    if probe.ms["detect"] == [] or (expect_loop and probe.sites["bow_guided_matches"] < 1):
        fail(f"{label}: the BoW database was not queried")
    if genuine and not (probe.sites["_search_by_sim3"] >= 2 and
                        probe.sites["_search_loop_points"] >= 1):
        fail(f"{label}: the verification's call sites did not launch: {dict(probe.sites)}")
    out = dict(traj=np.stack([T for _, T in traj]), kf_pose=kf_pose,
               map_points=res["map_points"], loops=res["loops"])
    return slam, res, out, probe.first


def phase_loop_reloc(torch, mk, slam, frame, kdb, loop_closing, TrackState, label):
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
        T = tr.process(frame.gray, frame.depth, torch.ones_like(frame.gray), LOOP_FRAMES / 30.0)
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
    expected = gt_cw(LOOP_FRAMES) @ np.linalg.inv(gt_cw(kf_frame)) @ \
        tr.arena.kf_pose[k].cpu().numpy()
    err_m, err_deg = pose_error_to(T, expected)
    gt_m, gt_deg = pose_error_to(T, gt_cw(LOOP_FRAMES))
    res = dict(phase=label, frame=LOOP_FRAMES, state=tr.state.name, n_inliers=tr.n_inliers,
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

    slice_args = (cfg, frames[:n_frames], System, TrackState, synthetic, metrics, dev, keyframes)
    slam, sres = phase_slice(torch, mk, *slice_args, modules=(mapping, ba))
    if not (sres["local_ba_runs"] >= 1 and sres["triangulated"] >= 0):
        fail("the default slice ran no local BA")
    slam_pipe, pres = phase_slice(torch, mk, *slice_args[:-1], keyframes_pipelined,
                                  label="slice_pipelined", pipeline=True,
                                  modules=(mapping, ba))
    if old is not None:
        phase_slice_ab(torch, mk, matcher, old, slice_args)
    rres, pnp, rigid = phase_reloc(torch, mk, slam, frames, n_frames, cfg, TrackState, solvers,
                                   tracking)
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
    gd_slam, gres, n_gd = phase_gd_slice(torch, mk, cfg, dyn, raw, System, TrackState,
                                         synthetic, metrics, dev, counters_args)
    sgres = phase_gd_staged(torch, mk, cfg, dyn, raw, System, TrackState, synthetic, metrics,
                            dev, counters_args)

    # the DynaSLAM geometry path, inpainting and the CLIs, on the same scene
    geom_slam, geores, n_geom = phase_geom_slice(torch, mk, cfg, dyn, System, TrackState,
                                                 synthetic, metrics, dev, counters_args)
    geostres = phase_geom_staged(torch, mk, cfg, dyn, System, TrackState, synthetic, metrics,
                                 dev)
    gdires = phase_gd_inpaint(torch, mk, cfg, dyn, System, TrackState, synthetic, metrics, dev)
    clires = phase_cli(torch, mk, cfg, dyn, metrics, dev)

    # loop closing and BoW place recognition: the revisit run at full width,
    # a forced loss relocalized on its map, then twice at the JAX test's
    # size, where the reference closes a loop
    t0 = time.perf_counter()
    lframes = loop_frames(torch, synthetic, cfg, dev, LOOP_FRAMES + 1)
    scfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
        bf=320.0 * 0.08), orb=dataclasses.replace(cfg.orb, n_features=512, n_levels=4))
    sframes = loop_frames(torch, synthetic, scfg, dev, LOOP_FRAMES)
    loop_render_s = time.perf_counter() - t0
    loop_mods = (loop_closing, pose_graph, gba, matcher, tracking)
    loop_slam, lres, _, _ = phase_loop(torch, mk, cfg, lframes[:LOOP_FRAMES], System,
                                       TrackState, synthetic, metrics, dev, loop_mods, "loop",
                                       expect_loop=False, reference=LOOP_JAX_FULL)
    lres_reloc = phase_loop_reloc(torch, mk, loop_slam, lframes[LOOP_FRAMES], kdb, loop_closing,
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

    # determinism: every pair of runs bitwise identical
    geo_db, im, depth_i, mask_i, T_i = geostres.pop("inpaint_inputs")
    inp = [geo_db.inpaint_frames(im, depth_i, mask_i, T_i) for _ in range(2)]
    torch.cuda.synchronize()
    det = dict(slice_sync=same_arrays(run_summary(slam), run_summary(slam_again)),
               slice_pipelined=same_arrays(run_summary(slam_pipe), run_summary(slam_pipe2)),
               loop_small=same_arrays(small[0][2], small[1][2]),
               inpaint=dict(rgb=bool(torch.equal(inp[0][0], inp[1][0])),
                            depth=bool(torch.equal(inp[0][1], inp[1][1]))))
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
                               dyn[n_geom + 1:n_geom + 1 + GEOM_PROFILE_FRAMES], n_geom + 1, cfg,
                               (geometry, extractor, build_frame))
    geo_st["ms"]["whole_geom_frame_pipelined"] = geores["frame_ms"]
    geo_st["ms"]["whole_geom_frame_staged_with_inpaint"] = geostres["frame_ms_median"]
    geo_st["ms"]["whole_gd_inpaint_frame"] = gdires["frame_ms_median"]
    emit(geo_st)
    emit(phase_profile(torch, slam, slam_pipe, frames[n_frames + 1:], n_frames + 1, gn_call,
                       ba_call, gd_slam, raw[n_gd:n_gd + GD_PROFILE_FRAMES], n_gd))

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
                   loop_reloc=lres_reloc["match_top2_launches"])
    if min(by_path.values()) < 1:
        fail(f"a path launched no kernel: {by_path}")
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
        "max_abs_err": max([err] + [c["max_abs_err"] for c in path_calls + loop_calls]),
        "ms": local_map["ms"], "plain_ms": local_map["plain_ms"],
        "bound_ms": local_map["bound_ms"], "bound_by": local_map["bound_by"],
        "library_ms": None,
        "bound_all_pairs_ms": local_map["bound_all_pairs_ms"],
        "launch_floor_ms": stages["launch_floor_ms_2"],
        "cuda_launches_per_call": local_map["cuda_launches_per_call"],
        "path": local_map["path"], "device_ms": local_map["device_ms"],
        "first_call_ms": local_map["first_call_ms"], "grid_ms": local_map["grid_ms"],
        "shape": [local_map["M"], local_map["N"]], "role": local_map["role"],
        "call_sites": [{k: c[k] for k in ("role", "M", "N", "path", "ms", "device_ms",
                                          "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                       for c in path_calls + loop_calls]}]})
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

    from gdslam_tpu_torch import SlamConfig
    return run(torch, "cuda", SlamConfig(), ab_source=opts.ab_source)


if __name__ == "__main__":
    sys.exit(main())
