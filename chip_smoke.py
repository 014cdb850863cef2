#!/usr/bin/env python3
"""Smoke run of gdslam_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from gdslam_tpu_torch/csrc/ into build/kernels/,
then prints one JSON line per phase:

  device   the card (torch and nvidia-smi);
  build    the nvcc build, timed, and what ptxas reports for the kernel;
  kernel   match_top2 (CUDA) against match_top2_plain (PyTorch) on the card,
           exactly, at (M, N) = (1500, 1500) and (4096, 1500), on seeded
           random and on rendered-frame inputs, with both versions' times;
  slice    60 rendered 480x640 frames through System.track_rgbd at the
           SlamConfig() defaults (kmax=256, pmax=65536, no local BA, no
           triangulation): every frame OK, ATE against the renderer's ground
           truth, keyframes, and the kernel's launches on this path;
  stages   per-stage times on the slice's final state, and the kernel timed
           against its bound on the inputs the tracker gives it;
  profile  torch.profiler windows over whole frames and over one pose
           solve: device busy share, device operations, host operators.

Then the card's name and power limit as nvidia-smi gives them, the kernels
line and, last, the ok line. Without a card, or when any phase fails, it
exits non-zero and prints no ok line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores. The INT32 rate is derived from the f32 one: an SM
# has 64 INT32 lanes beside its 128 FP32 lanes, and the f32 figure counts an
# FMA as two operations, so int32 = f32 / 4.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 4

N_FRAMES = 60
WARMUP_FRAMES = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def pairs_in_window(torch, args) -> int:
    uv_c, _, rad_c, lvl_c, val_c, uv_k, _, lvl_k, val_k = args[:9]
    slack = args[9] if len(args) > 9 else 1
    du = uv_c[:, None, 0] - uv_k[None, :, 0]
    dv = uv_c[:, None, 1] - uv_k[None, :, 1]
    ok = (du * du + dv * dv <= (rad_c * rad_c)[:, None]) & \
        ((lvl_c[:, None] - lvl_k[None, :]).abs() <= slack) & val_c[:, None] & val_k[None, :]
    return int(ok.sum())


def top2_bound(torch, args) -> dict:
    """Least time for the work these inputs need: every (m, n) pair takes the
    radius test (2 sub, 2 mul, 1 add, 1 compare in f32) and the level and
    validity tests (sub, abs, compare, 2 and: int32); only pairs inside the
    window need the Hamming cost and the top-2 update (8 xor + 8 popc + 7
    add + 2 compare: int32). Bytes: each input read once (48 B per candidate
    row with 1 B validity, 45 B per keypoint), each output written once."""
    M, N = args[0].shape[0], args[5].shape[0]
    inside = pairs_in_window(torch, args)
    f32_ops = 6 * M * N
    int_ops = 5 * M * N + 25 * inside
    nbytes = M * (8 + 32 + 4 + 4 + 1) + N * (8 + 32 + 4 + 1) + 3 * 4 * N + 4 * M
    t_ops = max(f32_ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(pairs=M * N, pairs_in_window=inside, f32_ops=f32_ops, int32_ops=int_ops,
                bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def compare_top2(torch, mk, args) -> int:
    """Kernel vs plain version on the same card inputs; every output must be
    exactly equal (the costs are integers). Returns the max abs difference."""
    before = mk.match_top2.launches
    got = mk.match_top2(*args)
    torch.cuda.synchronize()
    if mk.match_top2.launches != before + 1:
        fail("match_top2 did not count its launch")
    want = mk.match_top2_plain(*args)
    err = 0
    for name, g, w in zip(("best", "second", "arg", "best_cand"), got, want):
        if g.dtype != torch.int32 or g.shape != w.shape:
            fail(f"match_top2 {name}: {g.dtype} {tuple(g.shape)} vs {tuple(w.shape)}")
        d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        if d != 0:
            fail(f"match_top2 {name} differs from the plain version by up to {d}")
        err = max(err, d)
    return err


def time_top2(torch, mk, args) -> dict:
    ms = cuda_ms(torch, lambda: mk.match_top2(*args), reps=200)
    plain_ms = cuda_ms(torch, lambda: mk.match_top2_plain(*args), reps=10, windows=3)
    return dict(ms=ms, plain_ms=plain_ms)


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


def phase_kernel(torch, mk, frames, dev) -> tuple[dict, int]:
    cases = {
        "random_1500x1500": random_args(torch, 1500, 1500, 1, dev),
        "random_4096x1500": random_args(torch, 4096, 1500, 2, dev),
        "frames_1500x1500": frame_args(torch, frames[:1], frames[1], 1500, 15.0),
        "frames_4096x1500": frame_args(torch, frames[::2], frames[1], 4096, 12.0),
    }
    out, err = {}, 0
    for name, args in cases.items():
        err = max(err, compare_top2(torch, mk, args))
        out[name] = dict(M=args[0].shape[0], N=args[5].shape[0], exact=True,
                         keypoints_with_candidate=int((mk.match_top2(*args)[2] >= 0).sum()),
                         **time_top2(torch, mk, args))
    return dict(phase="kernel", name="match_top2", max_abs_err=err, cases=out), err


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


def phase_slice(torch, mk, cfg, frames, System, TrackState, synthetic, metrics, dev,
                keyframes):
    """Every frame through the user's entry point, System.track_rgbd, with
    the kernel's launch count set to 0 just before and read just after."""
    n = len(frames)
    slam = System(cfg, kmax=256, pmax=65536, device=dev)
    tr = slam.tracker
    if tr.use_local_ba or tr.use_triangulation or tr.pipeline:
        fail("the slice runs without local BA, triangulation or pipelining")
    torch.cuda.reset_peak_memory_stats()
    mk.match_top2.launches = 0
    times, states = [], []
    for i, fr in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = slam.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(slam.tracking_state)
        if T.shape != (4, 4) or not np.isfinite(T).all():
            fail(f"frame {i}: pose is not a finite 4x4")
    launches = mk.match_top2.launches
    traj = tr.camera_trajectory()
    ates = ate_pair(torch, synthetic, metrics, traj, [f.T_wc.cpu().numpy() for f in frames])
    steady = sorted(times[WARMUP_FRAMES:])
    res = dict(phase="slice", frames=n, width=cfg.camera.width, height=cfg.camera.height,
               n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels, kmax=256, pmax=65536,
               all_ok=all(s == TrackState.OK for s in states),
               trajectory_len=len(traj), keyframes=slam.keyframe_count,
               map_points=slam.map_point_count, match_top2_launches=launches,
               tracked_frames=n - 1, frame_ms_median=statistics.median(steady),
               frame_ms_p90=steady[int(0.9 * (len(steady) - 1))],
               first_frame_ms=times[0], second_frame_ms=times[1],
               peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20, **ates)
    emit(res)
    if not res["all_ok"]:
        fail(f"tracking states {[s.name for s in states]}")
    if len(traj) != n:
        fail(f"trajectory has {len(traj)} poses, expected {n}")
    if not (ates["ate_m"] <= 0.01 and ates["ate_bench_m"] <= 0.01):
        fail(f"ATE {ates} above 0.01 m")
    if not keyframes[0] <= res["keyframes"] <= keyframes[1]:
        fail(f"{res['keyframes']} keyframes, expected {keyframes[0]}-{keyframes[1]}")
    if launches < 2 * (n - 1):
        fail(f"match_top2 launched {launches} times for {n - 1} tracked frames")
    return slam, res


def record_top2_calls(matcher, fn) -> list:
    """The argument lists of the matcher's match_top2 calls while fn runs."""
    calls, real = [], matcher.match_top2

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    matcher.match_top2 = record
    try:
        fn()
    finally:
        matcher.match_top2 = real
    return calls


def phase_stages(torch, mk, slam, frame, cfg, modules) -> tuple[dict, dict]:
    """Per-stage medians on the slice's final state and the next frame; the
    functions are pure (they return new state), so the state is reused."""
    extractor, build_frame, tracking, optimizer, matcher = modules
    tr, cam = slam.tracker, cfg.camera
    ones = torch.ones_like(frame.gray)
    feats = extractor.extract(frame.gray, cfg.orb, cam.height, cam.width)
    fr = build_frame(feats, frame.depth, ones, cam)
    last, arena, vel = tr.last, tr.arena, tr.velocity
    pc = tracking.cam_ops.backproject(last.frame.uv, last.frame.depth, cam)
    pw_depth = tracking.lie.se3_apply(tracking.lie.se3_inverse(last.T_cw), pc)
    has_pt = last.assoc >= 0
    pts_w = torch.where(has_pt[:, None], arena.pt_pos[torch.where(has_pt, last.assoc, 0).long()],
                        pw_depth)
    T_pred = vel @ last.T_cw
    T1, assoc1, _, _ = tracking.track_motion_model(last, pts_w, fr, T_pred, cfg)
    _, T2, assoc2, _ = tracking.track_local_map(arena, fr, T1, cfg, assoc1)
    matched = assoc2 >= 0
    sf = float(cfg.orb.scale_factor)
    obs = optimizer.PoseObs(
        pw=torch.where(matched[:, None], arena.pt_pos[torch.where(matched, assoc2, 0).long()], 0.0),
        uv=fr.uv, ur=fr.ur, inv_sigma2=1.0 / sf ** (2.0 * fr.level.float()), valid=matched)
    K = (cam.fx, cam.fy, cam.cx, cam.cy)

    # the kernel on the inputs the tracker gives it at each call site
    path_calls = []
    for role, fn in (
            ("motion_model", lambda: tracking.track_motion_model(last, pts_w, fr, T_pred, cfg)),
            ("local_map", lambda: tracking.track_local_map(arena, fr, T1, cfg, assoc1)),
            ("keyframe_fuse", lambda: tracking.fuse_associate(arena, fr, T2, assoc2, cfg))):
        args = record_top2_calls(matcher, fn)[0]
        err = compare_top2(torch, mk, args)
        path_calls.append(dict(role=role, M=args[0].shape[0], N=args[5].shape[0],
                               max_abs_err=err, **time_top2(torch, mk, args),
                               **top2_bound(torch, args)))

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
        keyframe_program=wall_ms(torch, lambda: tracking.keyframe_program(
            arena, fr, T2, assoc2, 99.0, cfg, False, False), reps=5),
    )
    gn_call = lambda: optimizer.pose_optimization(T1, obs, K, cam.bf)      # noqa: E731
    return dict(phase="stages", ms=stages, match_top2_on_path=path_calls,
                obs_matched=int(matched.sum())), path_calls[1], gn_call


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


def phase_profile(torch, slam, frames, t_first: int, gn_call) -> dict:
    """Profiler windows over whole frames (System.track_rgbd, per frame) and
    over one pose_optimization solve."""
    def frames_fn():
        for i, fr in enumerate(frames):
            slam.track_rgbd(fr.gray, fr.depth, None, (t_first + i) / 30.0)

    gn_call()
    return dict(phase="profile", per_frame=profile_window(torch, frames_fn, len(frames)),
                frames=len(frames), per_pose_optimization=profile_window(torch, gn_call, 1))


def run(torch, dev, cfg, n_frames: int = N_FRAMES, keyframes=(3, 5)) -> int:
    """All phases on device `dev` at configuration `cfg`."""
    from gdslam_tpu_torch.backend import optimizer
    from gdslam_tpu_torch.frontend import extractor, matcher
    from gdslam_tpu_torch.frontend.frame import build_frame
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.ops import match_kernel as mk
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

    cam = cfg.camera
    t0 = time.perf_counter()
    frames = [synthetic.render_frame(i, cam, with_dynamic=False, device=dev)
              for i in range(n_frames + 6)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    ones = torch.ones_like(frames[0].gray)
    kframes = [build_frame(extractor.extract(f.gray, cfg.orb, cam.height, cam.width),
                           f.depth, ones, cam) for f in frames[:6]]
    kres, err = phase_kernel(torch, mk, kframes, dev)
    emit(kres)

    slam, sres = phase_slice(torch, mk, cfg, frames[:n_frames], System, TrackState, synthetic,
                             metrics, dev, keyframes)
    launches = sres["match_top2_launches"]
    stages, local_map, gn_call = phase_stages(torch, mk, slam, frames[n_frames], cfg,
                                     (extractor, build_frame, tracking, optimizer, matcher))
    stages["ms"]["whole_frame"] = sres["frame_ms_median"]
    stages["render_s"] = render_s
    emit(stages)
    emit(phase_profile(torch, slam, frames[n_frames + 1:], n_frames + 1, gn_call))

    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [{
        "name": "match_top2", "route": "cuda",
        "source": "gdslam_tpu_torch/csrc/match_top2.cu",
        "replaces": "gdslam_tpu/ops/pallas_match.py:98",
        "launches": launches, "max_abs_err": err,
        "ms": local_map["ms"], "plain_ms": local_map["plain_ms"],
        "bound_ms": local_map["bound_ms"], "bound_by": local_map["bound_by"],
        "library_ms": None,
        "shape": [local_map["M"], local_map["N"]], "role": local_map["role"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0



def main() -> int:
    if not (ROOT / "gdslam_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: gdslam_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from gdslam_tpu_torch import SlamConfig
    return run(torch, "cuda", SlamConfig())


if __name__ == "__main__":
    sys.exit(main())
