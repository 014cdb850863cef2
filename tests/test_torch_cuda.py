"""Tests of the port that need an NVIDIA card: the CUDA kernels against their
plain PyTorch versions, and the slice on the card against the slice on the
CPU. They skip without a card. This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import collections
import inspect
import os
import warnings

import numpy as np
import pytest
import torch

from gdslam_tpu_torch import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu_torch.backend import gba, loop_closing, mapping, pose_graph, solvers
from gdslam_tpu_torch.backend import vocabulary
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend import matcher
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.frontend.frame import build_frame
from gdslam_tpu_torch.io import synthetic
from gdslam_tpu_torch.masking import geomask, geometry
from gdslam_tpu_torch.models import maskrcnn
from gdslam_tpu_torch.ops import detect_cases, detect_kernels, match_kernel
from gdslam_tpu_torch.ops import draw_kernel, stereo_cases
from gdslam_tpu_torch.ops import image as image_ops
from gdslam_tpu_torch.ops import orb as orb_ops
from gdslam_tpu_torch.ops import orb_cases, orb_kernel, pose_cases, pose_kernel
from gdslam_tpu_torch.ops.stereo_cases import stereo_inputs
from gdslam_tpu_torch.system import slam as slam_mod
from gdslam_tpu_torch.system import tracking
from gdslam_tpu_torch.system.slam import System
from gdslam_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

KEYS = ("cand_uv", "cand_desc", "cand_radius", "cand_level", "cand_valid",
        "kp_uv", "kp_desc", "kp_level", "kp_valid")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, M, N, dup_rows=5):
    """Seeded candidates/keypoints on a 640x480 image; most keypoints lie
    near a candidate with a few flipped bits; rows 0..dup_rows duplicate."""
    r = np.random.default_rng(seed)
    d = dict(cand_uv=r.uniform(0, 640, (M, 2)).astype(np.float32),
             cand_desc=r.integers(0, 256, (M, 32)).astype(np.uint8),
             cand_level=r.integers(0, 8, M).astype(np.int32),
             cand_valid=r.uniform(size=M) > 0.1,
             kp_uv=r.uniform(0, 640, (N, 2)).astype(np.float32),
             kp_desc=r.integers(0, 256, (N, 32)).astype(np.uint8),
             kp_level=r.integers(0, 8, N).astype(np.int32),
             kp_valid=r.uniform(size=N) > 0.1,
             cand_angle=r.uniform(-np.pi, np.pi, M).astype(np.float32),
             kp_angle=r.uniform(-np.pi, np.pi, N).astype(np.float32))
    src = r.integers(0, M, N)
    near = r.uniform(size=N) < 0.6
    d["kp_uv"][near] = d["cand_uv"][src[near]] + r.normal(0, 3, (near.sum(), 2))
    flip = (r.integers(0, 256, (N, 32)) < 8) * r.integers(1, 256, (N, 32))
    d["kp_desc"][near] = (d["cand_desc"][src] ^ flip.astype(np.uint8))[near]
    d["kp_level"][near] = d["cand_level"][src[near]]
    for k in ("cand_desc", "cand_uv", "cand_level"):
        d[k][1:dup_rows + 1] = d[k][0]
    d["cand_radius"] = (15.0 * 1.2 ** d["cand_level"]).astype(np.float32)
    # a pair exactly on the radius (3-4-5): d2 == r^2 counts as inside
    d["cand_uv"][9], d["kp_uv"][7], d["cand_radius"][9] = (100.0, 200.0), (103.0, 204.0), 5.0
    d["kp_level"][7], d["cand_valid"][9], d["kp_valid"][7] = d["cand_level"][9], True, True
    return d


def _case(name):
    """Inputs a walk over image cells can get wrong, after _inputs: the
    dictionary and, where the case has one, the level slack."""
    r = np.random.default_rng(17)
    sizes = {"local_map": (4096, 1500), "small": (100, 33), "tiny": (12, 8), "N_1": (1500, 1),
             "M_1": (1, 1500), "N_750": (4096, 750), "mixed_radii": (4096, 1500)}
    M, N = sizes.get(name, (1500, 1500))
    d = _inputs(3, max(M, 16), max(N, 16))
    d = {k: np.ascontiguousarray(v[:M] if k.startswith("cand") else v[:N]) for k, v in d.items()}
    slack = 1
    if name == "clustered_patch":               # every keypoint in one small patch
        d["kp_uv"] = (300 + 2 * r.uniform(size=(N, 2))).astype(np.float32)
        d["cand_uv"][:800] = (300 + 2 * r.uniform(size=(800, 2))).astype(np.float32)
    elif name == "clustered_point":             # every keypoint on one point: one cell
        d["kp_uv"][:] = (320.0, 240.0)
        d["cand_uv"][:800] = d["kp_uv"][:800] + r.uniform(-10, 10, (800, 2)).astype(np.float32)
    elif name == "borders":                     # cell borders (32 x 24 cells of 20 px), image borders
        lattice = np.stack(np.meshgrid(np.arange(33) * 20.0, np.arange(25) * 20.0), -1).reshape(-1, 2)
        d["kp_uv"][:825], d["cand_uv"][:825] = lattice, lattice[::-1]
        d["cand_uv"][825:1200] = lattice[:375] + (20.0, 0.0)
        d["cand_radius"] = np.array([0.0, 20.0, 20.000002, 19.999998, 28.284271],
                                    np.float32)[np.arange(M) % 5]
        d["cand_valid"][:1200], d["kp_valid"][:825] = True, True
    elif name == "radius_0":                    # only coincident pairs pass
        d["cand_radius"][:] = 0.0
        d["cand_uv"][:700], d["cand_level"][:700] = d["kp_uv"][:700], d["kp_level"][:700]
    elif name == "radius_one_cell":
        d["cand_radius"][:] = 20.0
    elif name in ("dense", "dense_any_level"):  # beyond the image: every pair inside
        d["cand_radius"][:] = 1000.0
        slack = 7 if name == "dense_any_level" else 1
    elif name == "mixed_radii":
        d["cand_radius"] = r.choice(np.array([0, 1, 20, 90, 1e4, np.inf], np.float32), M)
    elif name == "ties_across_cells":           # four descriptors in all
        four = r.integers(0, 256, (4, 32)).astype(np.uint8)
        d["cand_desc"], d["kp_desc"] = four[r.integers(0, 4, M)], four[r.integers(0, 4, N)]
        d["cand_radius"][:] = 60.0
    elif name == "level_slack_0":
        slack = 0
    elif name == "cand_all_invalid":
        d["cand_valid"][:] = False
    elif name == "kp_all_invalid":
        d["kp_valid"][:] = False
    elif name == "non_finite":
        d["kp_uv"][::7, 0], d["kp_uv"][3::7, 1], d["kp_uv"][5::7] = np.nan, np.inf, -np.inf
        d["cand_uv"][::6, 0], d["cand_uv"][2::6, 1] = np.nan, np.inf
        d["cand_radius"][4::6], d["cand_radius"][5::12], d["cand_radius"][1::6] = np.inf, np.nan, 1e30
    elif name == "far_away":                    # off-image rows whose window reaches the image
        d["cand_uv"][::4] = d["cand_uv"][::4] * 1e4 - 2e6
        d["cand_radius"][::4] = 3e6
        d["kp_uv"][::5] *= -1e3
    elif name in ("M_0", "N_0"):
        side = "cand" if name == "M_0" else "kp"
        d = {k: (v[:0] if k.startswith(side) else v) for k, v in d.items()}
    return d, slack


CASES = ["motion_model", "local_map", "small", "tiny", "clustered_patch", "clustered_point",
         "borders", "radius_0", "radius_one_cell", "dense", "dense_any_level", "mixed_radii",
         "ties_across_cells", "level_slack_0", "cand_all_invalid", "kp_all_invalid", "non_finite",
         "far_away", "N_1", "M_1", "N_750", "M_0", "N_0"]


@pytest.mark.parametrize("path", [None, "cells", "tiled"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain(card, case, path):
    """Exactly equal outputs (integer costs) with the kernel choosing its
    path and with each path forced; one counted call of two CUDA launches,
    three when it builds the keypoint grid."""
    d, slack = _case(case)
    args = [torch.from_numpy(d[k]).to(card) for k in KEYS]
    before, before_cuda = match_kernel.match_top2.launches, match_kernel.match_top2.cuda_launches
    got = match_kernel.match_top2(*args, slack, path=path)
    torch.cuda.synchronize()
    assert match_kernel.match_top2.launches == before + 1
    assert match_kernel.match_top2.cuda_launches == before_cuda + 3     # a new keypoint tensor
    assert match_kernel.last_call()["path"] == (path or match_kernel.last_call()["path"])
    want = match_kernel.match_top2_plain(*args, slack)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w.cpu().to(torch.int32))
    again = match_kernel.match_top2(*args, slack, path=path)            # the grid is reused
    assert match_kernel.match_top2.cuda_launches == before_cuda + 5
    for g, w in zip(again, got):
        assert torch.equal(g, w)
    args[5].add_(0.0)                           # an in-place write: the grid is built anew
    match_kernel.match_top2(*args, slack, path=path)
    assert match_kernel.match_top2.cuda_launches == before_cuda + 8


def test_kernel_chooses_cells_for_narrow_and_tiled_for_wide_windows(card):
    for case, path in (("motion_model", "cells"), ("local_map", "cells"), ("dense", "tiled")):
        d, slack = _case(case)
        match_kernel.match_top2(*(torch.from_numpy(d[k]).to(card) for k in KEYS), slack)
        assert match_kernel.last_call()["path"] == path, case


@pytest.mark.parametrize("cells", [(32, 24), (1, 1), (64, 48), (256, 16)])
@pytest.mark.parametrize("case", ["motion_model", "clustered_patch", "clustered_point", "borders",
                                  "non_finite", "far_away", "N_1", "N_0"])
def test_grid_kernel_equals_plain(card, case, cells):
    """The same header and cell starts bit for bit and the same keypoints in
    every cell; the kernel leaves the order inside a cell open."""
    kp_uv = torch.from_numpy(_case(case)[0]["kp_uv"]).to(card)
    N = kp_uv.shape[0]
    before = match_kernel.kp_grid.launches
    got, want = match_kernel.kp_grid(kp_uv, *cells), match_kernel.kp_grid_plain(kp_uv, *cells)
    torch.cuda.synchronize()
    assert match_kernel.kp_grid.launches == before + 1
    assert torch.equal(got.hdr, want.hdr) and torch.equal(got.cell_start, want.cell_start)
    cell = torch.searchsorted(got.cell_start[1:].long().contiguous(),
                              torch.arange(N, device=card), right=True)
    order = got.kp_order.long()
    assert torch.equal(order[torch.argsort(cell * max(N, 1) + order)], want.kp_order.long())
    assert torch.equal(got.sorted_uv.nan_to_num(), kp_uv[order].nan_to_num())


def test_wrapper_rejects_2_to_the_20_rows(card):
    d, _ = _case("N_1")
    args = [torch.from_numpy(d[k]).to(card) for k in KEYS]
    big = [t[:1].expand(match_kernel.MAX_ROWS, *t.shape[1:]).contiguous() for t in args[:5]]
    with pytest.raises(ValueError, match="rows"):
        match_kernel.match_top2(*big, *args[5:])
    with pytest.raises(ValueError, match="grid"):
        match_kernel.kp_grid(args[5], 512, 8)


@pytest.mark.parametrize("kw", [dict(th_hamming=100, use_rotation=True),
                                dict(th_hamming=100, use_rotation=False, nn_ratio=0.8),
                                dict(th_hamming=50, use_rotation=False)])
def test_match_candidates_card_equals_cpu(card, kw):
    d = _inputs(4, 4096, 1500)
    keys = ("cand_uv", "cand_valid", "cand_desc", "cand_level", "cand_angle", "cand_radius",
            "kp_uv", "kp_valid", "kp_desc", "kp_level", "kp_angle")
    cpu = matcher.match_candidates(*(torch.from_numpy(d[k]) for k in keys), **kw)
    gpu = matcher.match_candidates(*(torch.from_numpy(d[k]).to(card) for k in keys), **kw)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())


def _record_top2(fn):
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


def test_fuse_into_keyframe_call_site_equals_plain(card):
    """The matcher's fourth call site (mapping.fuse_into_keyframe: the map
    projected into the new keyframe with base radius 3, TH_LOW, no rotation
    check) and relocalization's all-pairs call, on the arena of a short
    default run on the card: the kernel equals match_top2_plain exactly on the
    inputs each site gives it, and fuse_into_keyframe on the card equals
    fuse_into_keyframe on the CPU."""
    from gdslam_tpu_torch import convert
    from gdslam_tpu_torch.system import tracking
    cam = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=384, n_levels=4))
    s = System(cfg, kmax=32, pmax=16384, device=card)
    for i in range(12):
        fr = synthetic.render_frame(i, cam, with_dynamic=False, device=card)
        s.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
    tr = s.tracker
    kf = tr.n_kf_host - 1
    assert kf >= 1
    launches = match_kernel.match_top2.launches
    calls = _record_top2(lambda: mapping.fuse_into_keyframe(tr.arena, kf, cfg))
    dense = []
    real = tracking.match_top2
    tracking.match_top2 = lambda *a, **k: dense.append(a) or real(*a, **k)
    try:
        tracking._dense_ratio_matches(tr.last.frame, tr.arena.kf_uv[kf], tr.arena.kf_desc[kf],
                                      tr.arena.kf_level[kf], tr.arena.kf_kp_valid[kf],
                                      cfg.orb.n_levels)
    finally:
        tracking.match_top2 = real
    assert len(calls) == 1 and len(dense) == 1
    assert match_kernel.match_top2.launches == launches + 2
    for args in (calls[0], dense[0]):
        for g, w in zip(match_kernel.match_top2(*args), match_kernel.match_top2_plain(*args)):
            assert g.dtype == torch.int32 and torch.equal(g, w.to(torch.int32))
    got, row = mapping.fuse_into_keyframe(tr.arena, kf, cfg)
    cpu = convert.arena_from_numpy(convert.arena_to_numpy(tr.arena), "cpu")
    want, row_c = mapping.fuse_into_keyframe(cpu, kf, cfg)
    assert torch.equal(row.cpu(), row_c)
    for k in ("kf_obs", "pt_valid", "pt_n_obs", "pt_found", "pt_visible"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k


def test_wrapper_rejects_bad_inputs(card):
    d = _inputs(5, 64, 32)
    args = [torch.from_numpy(d[k]).to(card) for k in KEYS]
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()           # non-contiguous uv
    with pytest.raises(ValueError, match="contiguous"):
        match_kernel.match_top2(*bad)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="kp_uv"):
        match_kernel.match_top2(*bad)


def test_slice_on_card_tracks_like_cpu(card):
    """The small rig's first 12 frames through System.track_rgbd on the card
    and on the CPU: both OK, keyframe counts within one, ATEs within 5 mm.
    The card's pyramid resize (a matrix product) sums in another order, so
    a few FAST scores and descriptor bits move; that changes some matches,
    and a keyframe decision near its threshold can fall the other way (an
    H100 run gave 2 keyframes against the CPU's 3)."""
    cam = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=384, n_levels=4))
    runs = {}
    for dev in ("cpu", card):
        s = System(cfg, kmax=32, pmax=16384, device=dev)
        gt = []
        for i in range(12):
            fr = synthetic.render_frame(i, cam, with_dynamic=False, device=dev)
            s.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
            gt.append(fr.T_wc.cpu().numpy())
        assert s.tracking_state.name == "OK"
        est = np.stack([T[:3, 3] for _, T in s.tracker.camera_trajectory()])
        gtp = np.stack([(np.linalg.inv(gt[0]) @ T)[:3, 3] for T in gt])
        runs[str(dev)] = (s.keyframe_count, metrics.ate_rmse(est, gtp))
    (kc, ac), (kg, ag) = runs.values()
    assert abs(kc - kg) <= 1 and abs(ac - ag) < 0.005 and max(ac, ag) < 0.01, runs


GD_CAM = CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240, bf=25.6)
GD_CFG = SlamConfig(camera=GD_CAM, orb=OrbConfig(n_features=1000, n_levels=4))


def _gd_raw(n, dev="cpu"):
    """Frames of the dynamic scene at 240x320 as the CLI feeds them (uint8
    gray, uint16 depth), with the renderer's frames."""
    frames = [synthetic.render_frame(i, GD_CAM, with_dynamic=True, device=dev) for i in range(n)]
    raw = [(f.gray.cpu().numpy().astype(np.uint8),
            (f.depth.cpu().numpy() * GD_CAM.depth_map_factor).astype(np.uint16)) for f in frames]
    return frames, raw


@pytest.mark.parametrize("pipeline", [True, False], ids=["fast", "staged"])
def test_gd_slice_on_card_tracks_like_cpu(card, pipeline, monkeypatch):
    """12 frames of the dynamic scene through System.track_rgbd_gd on the card
    and on the CPU, pipelined (the packed fast path once the ring is warm)
    and not (the staged path): both OK, the masks stay on their device and
    agree to a mean IoU > 0.9 (the RANSAC draws of the two generators
    differ), ATEs under 1 cm and within 5 mm, keyframes within two."""
    frames, raw = _gd_raw(12)
    packed = []
    real = slam_mod.unpack_gd_frame
    monkeypatch.setattr(slam_mod, "unpack_gd_frame", lambda *a: packed.append(1) or real(*a))
    runs = {}
    for dev in ("cpu", card):
        s = System(GD_CFG, kmax=32, pmax=16384, pipeline=pipeline, device=dev)
        masks = []
        for i, (g, d) in enumerate(raw):
            _, m = s.track_rgbd_gd(g, d, None, i / 30.0)
            assert m.device.type == torch.device(dev).type
            masks.append(m.cpu().numpy() < 0.5)
        s.shutdown()
        assert s.tracking_state.name == "OK"
        traj = s.tracker.camera_trajectory()
        est = np.stack([T[:3, 3] for _, T in traj])
        gt0 = np.linalg.inv(frames[0].T_wc.numpy())
        gtp = np.stack([(gt0 @ f.T_wc.numpy())[:3, 3] for f in frames])
        runs[str(dev)] = (s.keyframe_count, metrics.ate_rmse(est, gtp), masks)
    assert len(packed) == (2 * (12 - 5) if pipeline else 0)
    (kc, ac, mc), (kg, ag, mg) = runs.values()
    ious = [(a & b).sum() / max((a | b).sum(), 1) for a, b in zip(mc[5:], mg[5:])]
    assert np.mean(ious) > 0.9, ious
    assert abs(kc - kg) <= 2 and abs(ac - ag) < 0.005 and max(ac, ag) < 0.01, runs


def test_gd_step_waits_for_nothing(card):
    """gd_step on the card under torch's sync debug mode "error": no upload,
    no read, no solver that checks its result on the host (the Horn
    rotation is the quaternion form, not an SVD), and the RANSAC's draw made
    on the card from a frame-id tensor (the fast path's key)."""
    frames, raw = _gd_raw(6, card)
    gray = frames[5].gray
    depth = frames[5].depth
    ref = frames[0]
    feats = extractor.extract(ref.gray, GD_CFG.orb, 240, 320)
    sem = torch.ones_like(gray)
    fold = torch.full((1,), 5, dtype=torch.int64, device=card)
    args = (gray, depth, sem, ref.gray, ref.depth, feats, GD_CFG, slam_mod.GD_KEY, fold)
    geomask.gd_step(*args)                                    # warm caches
    torch.cuda.synchronize()
    before = draw_kernel.categorical_draw.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, refined = geomask.gd_step(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert refined.shape == (240, 320) and bool((refined < 0.5).any())
    assert draw_kernel.categorical_draw.launches == before + 1


def test_gd_fast_path_draws_on_the_card_without_waiting(card):
    """Pipelined GD frames on the packed fast path, between flushes, under
    torch's sync debug mode "error": the frame id rides in the packed
    upload, the key is folded on the card and the draw is one kernel launch
    a frame; nothing waits for the card."""
    frames, raw = _gd_raw(10)
    s = System(GD_CFG, kmax=32, pmax=16384, pipeline=True, device=card)
    s.tracker.use_local_ba = s.tracker.use_triangulation = False
    s.tracker.commit_every = 100                  # no flush inside the checked frames
    for i in range(7):
        s.track_rgbd_gd(*raw[i], None, i / 30.0)
    s.tracker.flush()
    torch.cuda.synchronize()
    before = draw_kernel.categorical_draw.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(7, 10):
            s.track_rgbd_gd(*raw[i], None, i / 30.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert draw_kernel.categorical_draw.launches == before + 3
    s.shutdown()
    assert s.tracking_state.name == "OK"


def test_packed_upload_round_trip(card):
    """Frames uploaded back to back through the pinned ring unpack to the
    host's gray and half-resolution depth exactly; the ring holds no more
    buffers than frames were in flight."""
    _, raw = _gd_raw(3)
    up = slam_mod.PackedUpload(240, 320, card)
    outs = [up(g, d) for g, d in raw * 4]
    for (g, d), packed in zip(raw * 4, outs):
        gray, depth = slam_mod.unpack_gd_frame(packed, 240, 320, 1.0)
        assert torch.equal(gray.cpu(), torch.from_numpy(g).float())
        half = np.repeat(np.repeat(d[::2, ::2], 2, 0), 2, 1).astype(np.float32)
        assert torch.equal(depth.cpu(), torch.from_numpy(half))
    assert 1 <= len(up.ring) <= 12


def test_gd_match_call_site_equals_plain(card):
    """The cur x ref match of gd_step_core (1000 x 1000, no window, level
    slack n_levels) on the kernel equals match_top2_plain exactly, with the
    kernel choosing its path (tiled) and with each path forced."""
    frames, _ = _gd_raw(6, card)
    fa, fb = (extractor.extract(f.gray, GD_CFG.orb, 240, 320) for f in (frames[5], frames[0]))
    calls = []
    real = geomask.match_top2
    geomask.match_top2 = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        geomask.ratio_matches(fa, fb, GD_CFG.orb.n_levels)
    finally:
        geomask.match_top2 = real
    args = calls[0]
    want = match_kernel.match_top2_plain(*args)
    for path in (None, "cells", "tiled"):
        got = match_kernel.match_top2(*args, path=path)
        if path is None:
            assert match_kernel.last_call()["path"] == "tiled"
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _geometry_rig(dev):
    """A geometry ring DB of 8 frames of the dynamic scene at 240x320 (every
    4th, ground-truth poses, the sphere masked out) and frame 38, rendered
    on the CPU and moved to `dev` (the renderer's texture differs by device)."""
    frames = [synthetic.render_frame(i, GD_CAM, with_dynamic=True, device="cpu")
              for i in (0, 4, 8, 12, 16, 20, 24, 28, 38)]
    T0 = frames[0].T_wc

    def T_cw(fr):
        return torch.linalg.inv(torch.linalg.inv(T0) @ fr.T_wc).float().to(dev)

    g = geometry.Geometry(GD_CFG, device=dev)
    for fr in frames[:-1]:
        g.insert(fr.gray.to(dev), fr.depth.to(dev), (1.0 - fr.dyn_mask.float()).to(dev),
                 fr.rgb.to(dev), T_cw(fr))
    cur = frames[-1]
    return g, cur._replace(**{k: getattr(cur, k).to(dev) for k in cur._fields}), T_cw(cur)


def test_geometry_on_card_equals_cpu(card):
    """correction_dynamic_mask (the half grid at 240 rows) and inpaint on the
    card against the CPU on the same DB: the reprojections round the same way
    on both (float64 carriers, IEEE division), so the dynamic maps and the
    filled pixels are the same; the inpainted colours and depths differ only
    by the order of the card's sums (the card sorts the targets and sums
    each target's rows in order, map_arena.add_rows)."""
    out = {}
    for dev in ("cpu", card):
        g, cur, T = _geometry_rig(dev)
        grown = geometry.correction_dynamic_mask(g.db, cur.depth, T, GD_CFG)
        rgb, depth = g.inpaint_frames(cur.rgb, cur.depth, 1.0 - cur.dyn_mask.float(), T)
        out[str(dev)] = (grown.cpu().numpy(), rgb.cpu().numpy(), depth.cpu().numpy(),
                         cur.rgb.cpu().numpy(), cur.depth.cpu().numpy())
    (gc, rc, dc, rin, din), (gg, rg, dg, _, _) = out.values()
    assert gc.sum() > 100
    np.testing.assert_array_equal(gg, gc)
    fill_c = (dc != din) | (rc != rin).any(-1)
    fill_g = (dg != din) | (rg != rin).any(-1)
    np.testing.assert_array_equal(fill_g, fill_c)
    np.testing.assert_allclose(rg, rc, atol=1e-2, rtol=0)
    np.testing.assert_allclose(dg, dc, atol=1e-4, rtol=0)


def test_geometry_frame_waits_for_nothing(card):
    """A pipelined geometry frame (LightTrack's two searches, the correction,
    the frame build, track_frame_core, the ring bookkeeping) under torch's
    sync debug mode "error", once the DB holds frames; the flush that follows
    is the only read."""
    s = System(GD_CFG, kmax=32, pmax=16384, pipeline=True, device=card)
    frames = [synthetic.render_frame(i, GD_CAM, with_dynamic=True, device=card)
              for i in range(14)]
    for i, fr in enumerate(frames[:13]):
        s.track_rgbd(fr.gray, fr.depth, None, i / 30.0, use_geometry=True)
    s.tracker.flush()
    assert s._geometry.inserted >= 1 and s.tracking_state.name == "OK"
    s.tracker.commit_every = 100
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.track_rgbd(frames[13].gray, frames[13].depth, None, 13 / 30.0, use_geometry=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s.shutdown()
    assert s.tracking_state.name == "OK" and s._last_refined_mask.device.type == "cuda"


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "staged"])
def test_geometry_slice_on_card_tracks_like_cpu(card, pipeline):
    """16 frames of the dynamic scene at 240x320 through track_rgbd(
    use_geometry=True) on the card and on the CPU: both OK, the refined masks
    agree (mean IoU of the dynamic region > 0.8 once the DB holds frames),
    ATEs under 2 cm and within 1 cm, keyframes within two."""
    runs = {}
    for dev in ("cpu", card):
        s = System(GD_CFG, kmax=32, pmax=16384, pipeline=pipeline, device=dev)
        frames = [synthetic.render_frame(i, GD_CAM, with_dynamic=True, device=dev)
                  for i in range(16)]
        masks = []
        for i, fr in enumerate(frames):
            s.track_rgbd(fr.gray, fr.depth, None, i / 30.0, use_geometry=True)
            masks.append(s._last_refined_mask.cpu().numpy() < 0.5)
        s.shutdown()
        assert s.tracking_state.name == "OK" and s._geometry.inserted >= 1
        est = np.stack([T[:3, 3] for _, T in s.tracker.camera_trajectory()])
        gt0 = np.linalg.inv(frames[0].T_wc.cpu().numpy())
        gtp = np.stack([(gt0 @ f.T_wc.cpu().numpy())[:3, 3] for f in frames])
        runs[str(dev)] = (s.keyframe_count, metrics.ate_rmse(est, gtp), masks)
    (kc, ac, mc), (kg, ag, mg) = runs.values()
    ious = [(a & b).sum() / max((a | b).sum(), 1) for a, b in zip(mc[4:], mg[4:])
            if (a | b).any()]
    assert ious and np.mean(ious) > 0.8, ious
    assert abs(kc - kg) <= 2 and abs(ac - ag) < 0.01 and max(ac, ag) < 0.02, \
        {k: v[:2] for k, v in runs.items()}


# --------------------------------------------------------------------------
# bit-reproducibility and loop closing on the card
# --------------------------------------------------------------------------

DET_CAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
DET_CFG = SlamConfig(camera=DET_CAM, orb=OrbConfig(n_features=384, n_levels=4))


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_tracker_is_bitwise_reproducible_on_card(card, pipeline):
    """The port's twin of tests/test_determinism.py: two in-process runs of
    24 dynamic frames through the tracker on the card give bitwise-identical
    trajectories, keyframe poses and map points (no unordered float sum)."""
    frames = [synthetic.render_frame(i, DET_CAM, with_dynamic=True, device=card)
              for i in range(24)]
    runs = []
    for _ in range(2):
        tr = tracking.Tracking(DET_CFG, kmax=32, pmax=16384, pipeline=pipeline, device=card)
        ones = torch.ones_like(frames[0].gray)
        for i, fr in enumerate(frames):
            tr.process(fr.gray, fr.depth, ones, i / 30.0)
        tr.flush()
        runs.append((np.stack([T for _, T in tr.camera_trajectory()]),
                     tr.arena.kf_pose.cpu().numpy(), tr.arena.pt_pos.cpu().numpy(),
                     int(tr.arena.pt_valid.sum())))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_inpaint_is_bitwise_reproducible_on_card(card):
    g, cur, T = _geometry_rig(card)
    mask = 1.0 - cur.dyn_mask.float()
    (r1, d1), (r2, d2) = (g.inpaint_frames(cur.rgb, cur.depth, mask, T) for _ in range(2))
    assert torch.equal(r1, r2) and torch.equal(d1, d2)
    assert not torch.equal(r1, cur.rgb)


def test_add_rows_is_ordered_on_card(card):
    """map_arena.add_rows: bitwise the same on every call on the card (where
    index_add_'s float atomics are not), and equal to the CPU's serial sum
    to rounding."""
    from gdslam_tpu_torch.backend import map_arena
    g = torch.Generator(device=card).manual_seed(0)
    idx = torch.randint(0, 1000, (1_000_000,), device=card, generator=g)
    src = torch.randn(1_000_000, 5, device=card, generator=g)
    mask = torch.rand(1_000_000, device=card, generator=g) < 0.7
    outs = [map_arena.add_rows(idx, src, mask, 1000) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    cpu = map_arena.add_rows(idx.cpu(), src.cpu(), mask.cpu(), 1000)
    np.testing.assert_allclose(outs[0].cpu().numpy(), cpu.numpy(), atol=1e-3)


LOOP_CAM = CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240, bf=25.6)
LOOP_CFG = SlamConfig(camera=LOOP_CAM, orb=OrbConfig(n_features=512, n_levels=4))


def _revisit(dev):
    """tests/test_torch_loop.py's revisit state built by the port on the
    CPU (keyframes of the loop circuit at ground truth, two of the second
    lap drifted), moved to `dev`, with a loop closer holding every keyframe."""
    from gdslam_tpu_torch.backend import map_arena
    from gdslam_tpu_torch.frontend.frame import build_frame
    G = lie.se3_exp(torch.tensor([0.10, 0.03, 0.0, 0.0, 0.05, 0.0]))
    arena = map_arena.new_arena(48, 16384, 512, "cpu")
    ids = tuple(range(0, 120, 10)) + (116, 121)
    for i, idx in enumerate(ids):
        fr = synthetic.render(synthetic.gt_pose_loop(idx, 120), LOOP_CAM, False, 30.0, idx)
        f = build_frame(extractor.extract(fr.gray, LOOP_CFG.orb, 240, 320), fr.depth,
                        torch.ones_like(fr.gray), LOOP_CAM)
        T_cw = lie.se3_inverse(fr.T_wc)
        if idx >= 116:
            T_cw = T_cw @ lie.se3_inverse(G)
        if i == 0:
            arena, _ = tracking.stereo_initialize(arena, f, T_cw, LOOP_CFG)
            continue
        assoc = -torch.ones(512, dtype=torch.int32)
        if idx != 116:
            assoc = tracking.fuse_associate(arena, f, T_cw, assoc, LOOP_CFG)
        arena, _ = tracking._insert_keyframe(arena, f, T_cw, assoc, idx / 30.0, LOOP_CFG, kf_id=i)
    arena = map_arena.MapArena(*(x.to(dev) for x in arena))
    lc = loop_closing.LoopCloser(LOOP_CFG, vocabulary.default_vocabulary(), 48, dev)
    for k in range(len(ids)):
        lc.add_keyframe(arena, k)
    return arena, lc, len(ids) - 1, 0


def _draw(lc, arena, cur, cand):
    """A RANSAC draw made on the CPU, for both devices."""
    m_idx, _ = loop_closing._bow_guided_matches(
        arena.kf_desc[cur], arena.kf_kp_valid[cur], lc.db.words[cur], arena.kf_desc[cand],
        arena.kf_kp_valid[cand], lc.db.words[cand])
    ok = (m_idx >= 0).cpu().float() + 1e-12
    return torch.multinomial(ok, 900, replacement=True,
                             generator=torch.Generator().manual_seed(cur))


def test_loop_call_sites_equal_plain(card):
    """The loop closer's four call sites of match_top2 (the BoW-guided match,
    both SearchBySim3 growths, the loop-point projection) on the revisit
    state: the kernel exactly equal to match_top2_plain with the path chosen
    by the kernel and with each path forced."""
    arena, lc, cur, cand = _revisit(card)
    calls = []
    real_m, real_l = matcher.match_top2, loop_closing.match_top2

    def rec(real):
        return lambda *a, **k: calls.append(a) or real(*a, **k)

    matcher.match_top2, loop_closing.match_top2 = rec(real_m), rec(real_l)
    try:
        ok, T, n = lc.compute_transform(arena, cur, cand)
    finally:
        matcher.match_top2, loop_closing.match_top2 = real_m, real_l
    assert ok and len(calls) == 4, (ok, n, len(calls))
    for args in calls:
        want = match_kernel.match_top2_plain(*args)
        for path in (None, "cells", "tiled"):
            for g, w in zip(match_kernel.match_top2(*args, path=path), want):
                assert torch.equal(g, w.to(torch.int32)), path


def test_loop_correction_on_card_equals_cpu(card, monkeypatch):
    """compute_transform and correct on the revisit state, the same draw on
    both devices: the same verdict, n_total within 2, T to 1e-4, corrected
    keyframe poses to 1e-3 m."""
    out = {}
    real = solvers.ransac_sim3
    for dev in ("cpu", card):
        arena, lc, cur, cand = _revisit(dev)
        draw = _draw(lc, arena, cur, cand).to(dev)
        monkeypatch.setattr(solvers, "ransac_sim3", lambda *a, _r=real, _d=draw, **k: _r(
            *a, **{**k, "sample_idx": _d}))
        ok, T, n = lc.compute_transform(arena, cur, cand)
        assert ok
        post = lc.correct(arena, cur, cand, T)
        out[str(dev)] = (n, T.cpu().numpy(), post.kf_pose[:cur + 1].cpu().numpy())
    (nc, Tc, Pc), (ng, Tg, Pg) = out.values()
    assert abs(nc - ng) <= 2
    np.testing.assert_allclose(Tg, Tc, atol=1e-4)
    np.testing.assert_allclose(Pg, Pc, atol=1e-3)


def test_pose_graph_and_gba_wait_for_nothing(card):
    """The essential graph and the global BA on the revisit state under
    torch's sync debug mode "error": no read of the card inside."""
    arena, lc, cur, cand = _revisit(card)
    T = torch.eye(4, device=card)
    li, lj, lv = lc._loop_edge(cur, cand)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        edges = pose_graph.build_edges(arena.kf_pose, arena.kf_valid, arena.kf_parent,
                                       arena.covis, li, lj, T[None], lv)
        poses = pose_graph.optimize(arena.kf_pose, arena.kf_valid, edges)
        out = gba.global_bundle_adjustment(arena._replace(kf_pose=poses), LOOP_CFG,
                                           gate_outliers=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out.kf_pose).all()) and bool(torch.isfinite(out.pt_pos).all())


# ----------------------------------------------------------------------------
# The segmenter's detection kernels (ops/detect_kernels.py)
# ----------------------------------------------------------------------------

def _boxes(r, n, H, W, min_side=2.0):
    y1, x1 = r.uniform(0, H - min_side, n), r.uniform(0, W - min_side, n)
    h = min_side + r.uniform(0, 1, n) ** 2 * (H - y1 - min_side)
    w = min_side + r.uniform(0, 1, n) ** 2 * (W - x1 - min_side)
    return np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "all_inf"])
@pytest.mark.parametrize("n, n_out, th", [(1024, 128, 0.7), (128, 32, 0.3), (1, 4, 0.5)],
                         ids=["proposals", "detections", "one_box"])
def test_nms_kernel_equals_plain(card, kind, n, n_out, th):
    """Indices exact at both call shapes: clustered boxes, tied scores, none
    alive; one launch per call."""
    r = np.random.default_rng(n)
    centres = _boxes(r, max(24, n // 8), 240, 320, 20.0)
    boxes = np.clip(centres[r.integers(0, len(centres), n)] + r.normal(0, 4, (n, 4)), 0,
                    [240, 320, 240, 320]).astype(np.float32)
    scores = r.normal(0, 3, n).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores).astype(np.float32)
        scores[r.uniform(size=n) < 0.3] = -np.inf
    elif kind == "all_inf":
        scores[:] = -np.inf
    b, s = torch.from_numpy(boxes).to(card), torch.from_numpy(scores).to(card)
    before = detect_kernels.nms_fixed.launches
    got = detect_kernels.nms_fixed(b, s, th, n_out)
    assert detect_kernels.nms_fixed.launches == before + 1
    assert torch.equal(got, detect_kernels.nms_fixed_plain(b, s, th, n_out))


@pytest.mark.parametrize("case", ["all_tied", "n_1000", "n_77", "n_out_0", "chain"])
def test_nms_kernel_edge_cases_equal_plain(card, case):
    """The bitmask and the one-warp walk where they could go wrong: every
    score tied (the order is the index order), n not a multiple of 32 (a
    ragged last word and chunk), n_out = 0 (no launch), and a chain of 1024
    boxes each suppressing its neighbour, one chunk's decisions carried into
    the next (the greedy keeps every second box). Indices exact."""
    r = np.random.default_rng(11)
    n, n_out, th = {"all_tied": (1024, 128, 0.7), "n_1000": (1000, 128, 0.7),
                    "n_77": (77, 40, 0.3), "n_out_0": (128, 0, 0.3),
                    "chain": (1024, 600, 0.5)}[case]
    if case == "chain":              # IoU 8/12 with the next box, 6/14 with the one after
        x = 2.0 * np.arange(n)
        boxes = np.stack([np.zeros(n), x, np.full(n, 10.0), x + 10], -1).astype(np.float32)
        scores = -np.arange(n, dtype=np.float32)
    else:
        boxes = np.clip(_boxes(r, 48, 240, 320, 20.0)[r.integers(0, 48, n)]
                        + r.normal(0, 4, (n, 4)), 0, [240, 320, 240, 320]).astype(np.float32)
        scores = (np.ones(n) if case == "all_tied" else r.normal(0, 3, n)).astype(np.float32)
    b, s = torch.from_numpy(boxes).to(card), torch.from_numpy(scores).to(card)
    before = detect_kernels.nms_fixed.launches
    got = detect_kernels.nms_fixed(b, s, th, n_out)
    assert detect_kernels.nms_fixed.launches == before + (1 if n_out else 0)
    want = detect_kernels.nms_fixed_plain(b, s, th, n_out)
    assert got.shape == (n_out,) and torch.equal(got, want)
    if case == "chain":
        assert torch.equal(got[:512].cpu(), torch.arange(0, 1024, 2, dtype=torch.int32))
        assert (got[512:] == -1).all()


@pytest.mark.parametrize("R, out_size", [(128, 7), (32, 14), (1, 7)])
def test_roi_align_kernel_equals_plain(card, R, out_size):
    """The crops at the box head's and the mask head's shapes, boxes on all
    four levels and beyond the image: bit for bit."""
    r = np.random.default_rng(R)
    shapes = ((60, 80), (30, 40), (15, 20), (8, 10))
    flat = torch.from_numpy(r.normal(0, 50, (sum(a * b for a, b in shapes), 256))
                            .astype(np.float32)).to(card)
    sides = np.exp(r.uniform(np.log(10), np.log(1000), R))
    ys, xs = r.uniform(-20, 240, R), r.uniform(-20, 320, R)
    boxes = torch.from_numpy(np.stack([ys, xs, ys + sides, xs + sides * r.uniform(0.5, 2, R)],
                                      -1).astype(np.float32)).to(card)
    got = detect_kernels.roi_align(flat, shapes, boxes, out_size)
    assert got.shape == (R, out_size, out_size, 256)
    assert torch.equal(got, detect_kernels.roi_align_plain(flat, shapes, boxes, out_size))


@pytest.mark.parametrize("R, out_size", [(64, 7), (64, 14), (1, 7)])
def test_roi_align_backward_kernel_equals_plain(card, R, out_size):
    """The ROIAlign gradient at the training shapes (the box head's and the
    mask head's) on the levels of a 240 x 320 image, boxes on all four
    levels, beyond the image and repeated (long runs of one row): bit for
    bit against the plain twin, the same bits on a second call, one launch
    per call."""
    r = np.random.default_rng(R + out_size)
    shapes = ((60, 80), (30, 40), (15, 20), (8, 10))
    sides = np.exp(r.uniform(np.log(4), np.log(1000), R))
    ys, xs = r.uniform(-20, 240, R), r.uniform(-20, 320, R)
    boxes = np.stack([ys, xs, ys + sides, xs + sides * r.uniform(0.5, 2, R)], -1)
    boxes[R // 2:] = boxes[0] + r.normal(0, 0.2, (R - R // 2, 4))
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(card)
    grad = torch.from_numpy(r.normal(0, 1, (R, out_size, out_size, 256))
                            .astype(np.float32)).to(card)
    before = detect_kernels.roi_align_backward.launches
    got = detect_kernels.roi_align_backward(grad, shapes, boxes)
    again = detect_kernels.roi_align_backward(grad, shapes, boxes)
    assert detect_kernels.roi_align_backward.launches == before + 2
    assert got.shape == (sum(a * b for a, b in shapes), 256)
    assert torch.equal(got, again)
    assert torch.equal(got, detect_kernels.roi_align_backward_plain(grad, shapes, boxes))


@pytest.mark.parametrize("case", ["no_boxes", "one_row", "off_the_levels", "c4", "many_boxes"])
def test_roi_align_backward_kernel_edge_cases_equal_plain(card, case):
    """The ordered gather where it could go wrong: no boxes (every row still
    written, as zeros), 64 boxes of half a pixel whose 4 x 64 x 196 bins all
    land on four rows (runs of 12544 contributions), boxes entirely off the
    image (every tap clamped to a level's border), C = 4 (one float4 a row,
    most lanes idle) and 1024 boxes (the most the kernel takes: its
    candidate list beyond 48 KB of shared memory). Bitwise against the plain
    twin, and repeatable."""
    r = np.random.default_rng(5)
    shapes = ((60, 80), (30, 40), (15, 20), (8, 10))
    R, o, C = {"no_boxes": (0, 7, 256), "one_row": (64, 14, 256),
               "off_the_levels": (16, 7, 256), "c4": (64, 14, 4),
               "many_boxes": (1024, 7, 16)}[case]
    if case == "one_row":
        boxes = np.tile([[100.0, 100.0, 100.5, 100.5]], (R, 1))
    elif case == "off_the_levels":
        ys = np.where(np.arange(R) % 2, r.uniform(-900, -400, R), r.uniform(400, 900, R))
        xs = r.uniform(-900, 900, R)
        sides = np.exp(r.uniform(np.log(4), np.log(300), R))
        boxes = np.stack([ys, xs, ys + sides, xs + sides], -1)
    else:
        sides = np.exp(r.uniform(np.log(4), np.log(1000), R))
        ys, xs = r.uniform(-20, 240, R), r.uniform(-20, 320, R)
        boxes = np.stack([ys, xs, ys + sides, xs + sides * r.uniform(0.5, 2, R)], -1)
    boxes = torch.from_numpy(boxes.reshape(R, 4).astype(np.float32)).to(card)
    grad = torch.from_numpy(r.normal(0, 1, (R, o, o, C)).astype(np.float32)).to(card)
    got = detect_kernels.roi_align_backward(grad, shapes, boxes)
    again = detect_kernels.roi_align_backward(grad, shapes, boxes)
    want = detect_kernels.roi_align_backward_plain(grad, shapes, boxes)
    assert got.shape == (sum(a * b for a, b in shapes), C)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert bool((got != 0).any()) == (R > 0)


def test_roi_align_gradient_flows_through_the_kernels(card):
    """roi_align on levels that require a gradient: the forward and the
    backward kernel each launch once, and the levels' gradient is the plain
    twin's on the same cotangent."""
    r = np.random.default_rng(3)
    shapes = ((60, 80), (30, 40), (15, 20), (8, 10))
    flat = torch.from_numpy(r.normal(0, 1, (sum(a * b for a, b in shapes), 256))
                            .astype(np.float32)).to(card).requires_grad_()
    boxes = torch.tensor([[10.0, 20.0, 90.0, 150.0], [-5.0, -5.0, 250.0, 330.0]], device=card)
    before = (detect_kernels.roi_align.launches, detect_kernels.roi_align_backward.launches)
    crop = detect_kernels.roi_align(flat, shapes, boxes, 14)
    g = torch.ones_like(crop)
    crop.backward(g)
    assert (detect_kernels.roi_align.launches, detect_kernels.roi_align_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(flat.grad, detect_kernels.roi_align_backward_plain(g, shapes, boxes))


@pytest.mark.parametrize("D, hw", [(32, (480, 640)), (8, (120, 160)), (0, (48, 64))])
def test_paste_kernel_equals_plain(card, D, hw):
    """The union of the pasted masks: equal on every pixel but those within
    1e-6 of the threshold (none are expected: both round alike)."""
    r = np.random.default_rng(D)
    det = {"boxes": torch.from_numpy(_boxes(r, D, *hw, 4.0)).to(card),
           "classes": torch.from_numpy(r.integers(0, 81, D).astype(np.int32)).to(card),
           "masks": torch.from_numpy(r.uniform(0, 1, (D, 28, 28)).astype(np.float32)).to(card),
           "valid": torch.from_numpy(r.uniform(size=D) < 0.8).to(card)}
    got = detect_kernels.paste_masks(det, hw)
    want = detect_kernels.paste_masks_plain(det, hw)
    assert got.dtype == torch.uint8 and got.shape == hw
    near = ((detect_kernels.paste_values(det, hw) - 0.5).abs() < 1e-6)[
        detect_kernels.paste_ok(det)].any(0)
    assert not ((got != want) & ~near).any()


@pytest.mark.parametrize("name", ["nms_fixed", "roi_align", "roi_align_backward", "paste_masks"])
def test_detect_wrappers_raise_without_the_library(card, monkeypatch, name):
    """On real CUDA tensors: with the library loader failing each wrapper
    raises, counts no launch and never takes its plain version."""
    def missing(lib_name):
        raise RuntimeError(f"{lib_name}: library missing")

    monkeypatch.setattr(detect_kernels, "_library", missing)
    monkeypatch.setattr(detect_kernels, f"{name}_plain",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    f = dict(dtype=torch.float32, device=card)
    det = dict(boxes=torch.zeros(8, 4, **f), classes=torch.ones(8, dtype=torch.int32,
                                                                 device=card),
               masks=torch.zeros(8, 28, 28, **f), valid=torch.ones(8, dtype=torch.bool,
                                                                   device=card))
    call = {"nms_fixed": lambda: detect_kernels.nms_fixed(torch.zeros(16, 4, **f),
                                                          torch.zeros(16, **f), 0.5, 4),
            "roi_align": lambda: detect_kernels.roi_align(torch.zeros(24, 8, **f),
                                                          ((4, 4), (2, 2), (1, 2), (1, 2)),
                                                          torch.zeros(3, 4, **f), 7),
            "roi_align_backward": lambda: detect_kernels.roi_align_backward(
                torch.zeros(3, 7, 7, 8, **f), ((4, 4), (2, 2), (1, 2), (1, 2)),
                torch.zeros(3, 4, **f)),
            "paste_masks": lambda: detect_kernels.paste_masks(det, (32, 32))}[name]
    wrapper = getattr(detect_kernels, name)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="library missing"):
        call()
    assert wrapper.launches == before


def _seg_weights():
    """Seeded blocks (1, 1, 1, 1) weights whose class head scores most
    proposals as a person (as tests/test_torch_segmenter.py edits them)."""
    flat = maskrcnn.init_variables((1, 1, 1, 1), seed=0)
    flat["params/box_head/Dense_2/kernel"] = flat["params/box_head/Dense_2/kernel"] * 0.01
    flat["params/box_head/Dense_2/bias"][1] += 6.0
    return flat


def test_segmenter_on_card_equals_cpu_and_repeats(card):
    """The live segmenter at 120 x 160 on the card: every detection stage
    launches its kernel, two runs are bitwise equal, and the masks are the
    CPU's (IoU >= 0.95: cuDNN and the CPU sum the convolutions in other
    orders)."""
    flat = _seg_weights()
    gpu = maskrcnn.TorchSegmenter(flat, image_hw=(120, 160), blocks=(1, 1, 1, 1), device=card)
    cpu = maskrcnn.TorchSegmenter(flat, image_hw=(120, 160), blocks=(1, 1, 1, 1), device="cpu")
    cam = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
    detect_kernels.reset_launch_counts()
    for i in (0, 5, 9):
        rgb = synthetic.render_frame(i, cam, with_dynamic=True, device="cpu").rgb.numpy()
        rgb = rgb.astype(np.uint8)
        a, b, c = gpu(rgb), gpu(rgb), cpu(rgb)
        assert np.array_equal(a, b)
        union = ((a > 0) | (c > 0)).sum()
        assert union == 0 or ((a > 0) & (c > 0)).sum() / union >= 0.95
    assert (detect_kernels.nms_fixed.launches, detect_kernels.roi_align.launches,
            detect_kernels.paste_masks.launches) == (12, 12, 6)


def test_train_sampled_step_on_card_equals_cpu(card):
    """One train_sampled step (calibration, the sampled losses, the backward
    with the ROIAlign kernel, the clipped SGD step) of a blocks (1, 1, 1, 1)
    model at 96 x 128 on the card against the same step on the CPU: the
    loss to 1e-3 relative and the parameter update to 2% of its global
    norm (cuDNN and the CPU sum the convolutions in other orders); twice on
    the card with the same bits."""
    r = np.random.default_rng(0)
    hw = (96, 128)
    images = r.uniform(0, 60, (2,) + hw + (3,)).astype(np.float32)
    masks = np.zeros((2,) + hw, np.float32)
    masks[0, 22:58, 32:68] = masks[1, 40:70, 65:95] = 1
    images[masks > 0] = (220.0, 40.0, 40.0)
    boxes = np.asarray([[[22, 32, 58, 68], [6, 4, 90, 124]], [[40, 65, 70, 95], [5, 5, 30, 40]]],
                       np.float32)
    classes = np.asarray([[1, 3], [1, 3]], np.int32)
    valids = np.asarray([[True, True], [True, False]])
    start = maskrcnn.init_variables((1, 1, 1, 1), seed=0)
    kw = dict(pre_nms=64, post_nms=16, max_det=8)
    runs = {}
    for dev in ("cpu", card, card):
        model = maskrcnn.maskrcnn_from_numpy(start, hw, (1, 1, 1, 1), dev, **kw)
        before = detect_kernels.roi_align_backward.launches
        out, losses = maskrcnn.train_sampled(model, start, images, boxes, classes, masks, valids,
                                             steps=1, lr=1e-3)
        if dev != "cpu":
            assert detect_kernels.roi_align_backward.launches >= before + 4
        runs.setdefault(str(dev), []).append((out, losses))
    (cpu, cpu_l), = runs["cpu"]
    (gpu, gpu_l), (gpu2, gpu2_l) = runs[str(card)]
    assert gpu_l == gpu2_l and all(np.array_equal(gpu[k], gpu2[k]) for k in gpu)
    assert abs(gpu_l[0] - cpu_l[0]) <= 1e-3 * abs(cpu_l[0])
    keys = [k for k in cpu if k.startswith("params")]
    du = np.concatenate([(gpu[k] - cpu[k]).ravel() for k in keys])
    u = np.concatenate([(cpu[k] - start[k]).ravel() for k in keys])
    assert np.linalg.norm(du) <= 0.02 * np.linalg.norm(u)


# ----------------------------------------------------------------------------
# The stereo matcher kernel (ops/stereo.py) and the mono bootstrap's match
# ----------------------------------------------------------------------------

STEREO_ARGS = ("left_uv", "left_level", "left_desc", "left_valid",
               "right_uv", "right_level", "right_desc", "right_valid")


def _stereo_call(fn, d, dev, images=True):
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in d.items()}
    imgs = (t["img_left"], t["img_right"]) if images else (None, None)
    return fn(*(t[k] for k in STEREO_ARGS), 386.1448, 386.1448 / 718.856, *imgs, 1.2)


@pytest.mark.parametrize("case", ["integer", "float", "no_images", "all_invalid_right",
                                  "empty_right", *stereo_cases.CASES])
def test_stereo_kernel_equals_plain(card, case):
    """At KITTI's 2000 x 2000 (1241 x 376 images): ur and depth bit for bit
    against the plain twin on the CPU and on the card, one count a call; on
    seeded keypoints and on the bucket edges of stereo_cases (a hot bucket,
    the band's edge at each level, rows at and past the borders, Hamming
    ties across buckets, 1997 left keypoints, 3000 right keypoints past the
    one-pass build), the buckets built in every CTA, and past a block's
    shared memory (6000 right keypoints, and the first four edges again at
    6000: the `_wide` cases), where a first launch builds them."""
    from gdslam_tpu_torch.ops import stereo
    if case in stereo_cases.CASES:
        d = stereo_cases.stereo_edge_inputs(case)
    else:
        d = stereo_inputs(7, 2000, 0 if case == "empty_right" else 2000,
                          integer=case != "float")
    if case == "all_invalid_right":
        d["right_valid"][:] = False
    images = case != "no_images"
    before = stereo.stereo_match.launches
    got = _stereo_call(stereo.stereo_match, d, card, images)
    torch.cuda.synchronize()
    assert stereo.stereo_match.launches == before + 1
    for dev in ("cpu", card):
        want = _stereo_call(stereo.stereo_match_plain, d, dev, images)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), dev
    n_ok = int((got[1] > 0).sum())
    assert n_ok == 0 if case in ("all_invalid_right", "empty_right") else n_ok > 500


@pytest.mark.parametrize("case", ["random", *stereo_cases.CASES])
def test_stereo_row_buckets_equal_plain(card, case):
    """The kernel's bucket launch (the first of the two that stereo_match
    makes past a block's shared memory) against row_buckets_plain: the same offsets, and the same right keypoints in
    each bucket as sets (the order inside a bucket follows the atomics), at
    the image's 376 rows and at the 4096 rows taken with no images."""
    from gdslam_tpu_torch.ops import stereo
    d = (stereo_inputs(7, 2000, 2000) if case == "random"
         else stereo_cases.stereo_edge_inputs(case))
    uv, lv, desc, val = (torch.from_numpy(np.array(d[k])) for k in (
        "right_uv", "right_level", "right_desc", "right_valid"))
    for rows in (stereo.bucket_rows(stereo_cases.H), stereo.bucket_rows(0)):
        want_order, want_off = stereo.row_buckets_plain(uv, val, rows)
        before = stereo.row_buckets.launches
        order, off = stereo.row_buckets(uv.to(card), lv.to(card), desc.to(card), val.to(card),
                                        rows)
        assert stereo.row_buckets.launches == before + 1
        assert torch.equal(off.cpu(), want_off)
        order = order.cpu()
        for b in torch.nonzero(want_off[1:] > want_off[:-1])[:, 0].tolist():
            a, e = int(want_off[b]), int(want_off[b + 1])
            assert torch.equal(torch.sort(order[a:e]).values, torch.sort(want_order[a:e]).values)


def test_stereo_kernel_on_a_rendered_pair(card):
    """Extraction on the card and the kernel at the full settings (2000
    features, 8 levels) on a rendered 1241 x 376 pair, integer and float:
    bit for bit against the plain twin on the same features."""
    from gdslam_tpu_torch.ops import stereo
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                       height=376, bf=386.1448, fps=10.0, th_depth=35.0)
    orb = OrbConfig(n_features=2000)
    T = synthetic.gt_pose(4, 10.0, card)
    S = torch.eye(4, device=card)
    S[0, 3] = cam.bf / cam.fx
    views = [synthetic.render(P, cam, False, 10.0, 4).gray for P in (T, T @ S)]
    for images in (views, [torch.round(v) for v in views]):
        A, B = (extractor.extract(v, orb, cam.height, cam.width) for v in images)
        args = [t.contiguous() for t in (A.uv, A.level, A.desc, A.valid,
                                         B.uv, B.level, B.desc, B.valid)]
        got = stereo.stereo_match(*args, cam.bf, cam.bf / cam.fx, *images, 1.2)
        want = stereo.stereo_match_plain(*args, cam.bf, cam.bf / cam.fx, *images, 1.2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int((got[1] > 0).sum()) > 300


def test_stereo_wrapper_raises_without_the_library(card, monkeypatch):
    """On real CUDA tensors: with the library loader failing the wrapper
    raises, counts no launch and never takes its plain version."""
    from gdslam_tpu_torch.ops import stereo

    def missing():
        raise RuntimeError("stereo_match: library missing")

    monkeypatch.setattr(stereo, "_library", missing)
    monkeypatch.setattr(stereo, "stereo_match_plain",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = stereo.stereo_match.launches
    with pytest.raises(RuntimeError, match="library missing"):
        _stereo_call(stereo.stereo_match, stereo_inputs(1, 64, 64, 40, 60), card)
    assert stereo.stereo_match.launches == before


@pytest.mark.parametrize("path", [None, "cells", "tiled"])
def test_bootstrap_match_call_site_equals_plain(card, path, monkeypatch):
    """The mono bootstrap's all-pairs match_top2 call (the frame's keypoints
    as candidate rows, an infinite radius) at 1500 x 1500 with invalid rows
    on both sides and distances of exactly 128: good and the JAX index rule
    on every row as on the CPU (the plain twin), each kernel path forced."""
    r = np.random.default_rng(11)
    n = 1500

    def frame(desc, valid, uv, level):
        z = torch.zeros(n)
        f = tracking.Frame(uv=torch.from_numpy(uv), uv_raw=torch.from_numpy(uv), ur=-z - 1,
                           depth=z, level=torch.from_numpy(level), angle=z, response=z,
                           desc=torch.from_numpy(desc), valid=torch.from_numpy(valid))
        return f

    d1 = r.integers(0, 256, (n, 32)).astype(np.uint8)
    d2 = (r.integers(0, 256, (n, 32)) | r.integers(0, 256, (n, 32))).astype(np.uint8)
    d2[:300] = d1[:300] ^ ((1 << r.integers(0, 8, (300, 32)))
                           * (r.uniform(size=(300, 32)) < 0.05)).astype(np.uint8)
    d1[400:410] = 0
    d2[500] = 0
    d2[500, :16] = 255                       # exactly 128 from rows 400-409
    v1, v2 = r.uniform(size=n) > 0.1, r.uniform(size=n) > 0.1
    uv1 = r.uniform(0, 640, (n, 2)).astype(np.float32)
    uv2 = r.uniform(0, 640, (n, 2)).astype(np.float32)
    lv1, lv2 = r.integers(0, 8, n).astype(np.int32), r.integers(0, 8, n).astype(np.int32)
    first, fr = frame(d1, v1, uv1, lv1), frame(d2, v2, uv2, lv2)
    want = tracking.bootstrap_matches(first, fr, 8)
    if path is not None:
        orig = tracking.match_top2
        monkeypatch.setattr(tracking, "match_top2", lambda *a: orig(*a, path=path))
    before = match_kernel.match_top2.launches
    got = tracking.bootstrap_matches(first._replace(**{k: v.to(card) for k, v in
                                                       first._asdict().items()}),
                                     fr._replace(**{k: v.to(card) for k, v in
                                                    fr._asdict().items()}), 8)
    assert match_kernel.match_top2.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert int(want[0].sum()) > 200


def test_bootstrap_helpers_on_card_equal_cpu(card):
    """The mono bootstrap's scale and draws on the card: nanmedian (NaNs
    sort last, an even count's two middles) and the replayed JAX draws
    (core.prng) bit for bit as on the CPU."""
    from gdslam_tpu_torch.core import prng
    r = np.random.default_rng(12)
    x = r.normal(size=300).astype(np.float32)
    x[r.uniform(size=300) < 0.3] = np.nan
    for v in (x, x[:-1], np.full(4, np.nan, np.float32)):
        t = torch.from_numpy(v)
        torch.testing.assert_close(tracking.nanmedian(t.to(card)).cpu(), tracking.nanmedian(t),
                                   rtol=0, atol=0, equal_nan=True)
    valid = torch.from_numpy(r.uniform(size=1500) < 0.4)
    for seed in (0, 31):
        key = prng.prng_key(seed)
        assert torch.equal(draw_kernel.uniform_over(key, valid.to(card), 1600).cpu(),
                           draw_kernel.uniform_over(key, valid, 1600))
        assert torch.equal(draw_kernel.uniform_over(key, valid.to(card), 1600).cpu(),
                           prng.categorical_rows(key, draw_kernel.uniform_logits(valid), 1600))


@pytest.mark.parametrize("rows, n", [
    (900, 1500), (1800, 1500), (800, 37), (3, 20000), (1, 1), (900, 129), (900, 257),
    (40, 12000), (40, 12001)])
def test_categorical_draw_kernel_equals_plain(card, rows, n):
    """The draw kernel against its plain twin on the card, bitwise: the
    Gumbel noise the writing variant and the twin write out, and the indices
    of both variants (with and without the noise store), over logits
    uniform on none, some and all rows, with -inf entries and all -inf
    (index 0, as jnp.argmax), the key as host words and folded from a
    frame-id tensor; the indices also the numpy replay's (held to jax.random
    on the CPU). Shapes: the GD and relocalization shapes, a short tail,
    one column, one more than the CTA's 128 threads and than its two-column
    step, at and past the staged logits' limit (12000)."""
    from gdslam_tpu_torch.core import prng
    r = np.random.default_rng(rows + n)
    for k, share in enumerate((0.0, 0.07, 1.0, 1.0)):
        valid = torch.from_numpy(r.uniform(size=n) < share).to(card)
        lg = draw_kernel.uniform_logits(valid)
        if k == 1:
            lg[: n // 3] = -float("inf")
        if k == 3:
            lg[:] = -float("inf")
        fold = torch.full((1,), 1000 + k, dtype=torch.int64, device=card)
        key = prng.fold_in(prng.prng_key(7), 1000 + k)
        nk, npl = torch.empty(rows, n, device=card), torch.empty(rows, n, device=card)
        got = draw_kernel.categorical_draw(prng.prng_key(7), lg, rows, fold, noise=nk)
        want = draw_kernel.categorical_draw_plain(prng.prng_key(7), lg, rows, fold, noise=npl)
        assert torch.equal(nk.view(torch.int32), npl.view(torch.int32))
        assert torch.equal(got, want)
        assert torch.equal(draw_kernel.categorical_draw(key, lg, rows), want)
        assert torch.equal(draw_kernel.categorical_draw(prng.prng_key(7), lg, rows, fold), want)
        assert torch.equal(got.cpu(), prng.categorical_rows(key, lg, rows).cpu())
        if k == 3:
            assert not want.any()


def test_roi_align_prologue_in_the_kernel(card):
    """ROIAlign's prologue computed in the kernel: on boxes a few ulps either
    side of each level threshold (the areas of ROI_LEVEL_AREA) the crop and
    the prologue written out for the gradient equal roi_align_plain and
    roi_prologue bitwise, and a call is one launch."""
    r = np.random.default_rng(9)
    shapes = ((120, 160), (60, 80), (30, 40), (15, 20))
    flat = torch.from_numpy(r.normal(0, 1, (sum(a * b for a, b in shapes), 64))
                            .astype(np.float32)).to(card)
    boxes = torch.from_numpy(detect_cases.roi_boundary_boxes()).to(card)
    assert set(detect_kernels.roi_levels(boxes).tolist()) == {0, 1, 2, 3}
    for size in (7, 14, 1):
        before = detect_kernels.roi_align.launches
        got, pro = detect_kernels._roi_align(flat, shapes, boxes, size, with_prologue=True)
        assert detect_kernels.roi_align.launches == before + 1
        assert torch.equal(got, detect_kernels.roi_align_plain(flat, shapes, boxes, size))
        for a, b in zip(pro, detect_kernels.roi_prologue(shapes, boxes, size)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_paste_kernel_tile_lists_on_adversarial_boxes(card, seed):
    """The paste kernel's per-tile lists on boxes at, just off and between
    tile borders, past the image, degenerate, invalid and of static
    classes, with masks below the threshold, a hair under it and a blob:
    bitwise the plain twin, with and without the class test."""
    H, W, D = 480, 640, 32
    det = {k: torch.from_numpy(v).to(card) for k, v in detect_cases.paste_adversarial_det(
        np.random.default_rng(seed), D, H, W).items()}
    for dyn in (True, False):
        before = detect_kernels.paste_masks.launches
        got = detect_kernels.paste_masks(det, (H, W), dyn)
        assert detect_kernels.paste_masks.launches == before + 1
        assert torch.equal(got, detect_kernels.paste_masks_plain(det, (H, W), dyn))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want) -> bool:
    """Bitwise equal (floats as their bits: -0 against +0 and NaNs count)."""
    return got.shape == want.shape and got.dtype == want.dtype and \
        torch.equal(_bits(got), _bits(want))


def _orb_levels(gray, orb, cam):
    canvas, shapes = image_ops.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                             orb.scale_factor)
    return canvas, shapes, orb_ops.feature_quotas(orb.n_features, orb.n_levels,
                                                  orb.scale_factor)


@pytest.mark.parametrize("case", orb_cases.CASES)
def test_orb_kernels_equal_plain(card, case):
    """The front end's four kernels bitwise their plain twins on the card,
    each on the inputs the kernel before it made: the defaults' static and
    GD dynamic frames, the stereo cell's left image (2000 features, 3542
    candidates at level 0), the 120x160 rig (levels 1-3 padded: candidate
    0's uv, response 0), flat and saturated frames (every row invalid),
    integer noise and a checkerboard (tied strengths); then extract bitwise
    the twins' whole route, one launch of each kernel a call."""
    gray, orb, cam = orb_cases.orb_input(case, card)
    canvas, shapes, quotas = _orb_levels(gray, orb, cam)
    blurred = orb_kernel.gaussian_blur7(canvas, shapes)
    assert _same(blurred, image_ops.gaussian_blur(canvas, 7, 2.0))
    cand = orb_kernel.orb_fast_cells(canvas, shapes, orb.ini_th_fast, orb.min_th_fast)
    for g, w in zip(cand, orb_kernel.fast_cells_plain(canvas, shapes, orb.ini_th_fast,
                                                      orb.min_th_fast)):
        assert _same(g, w)
    sel = orb_kernel.orb_quota_select(*cand, shapes, quotas, orb.scale_factor)
    for g, w in zip(sel, orb_kernel.quota_select_plain(*cand, shapes, quotas, orb.scale_factor)):
        assert _same(g, w)
    for g, w in zip(orb_kernel.orb_describe(canvas, blurred, sel[1], sel[3]),
                    orb_kernel.describe_plain(canvas, blurred, sel[1], sel[3])):
        assert _same(g, w)
    before = [w.launches for w in orb_kernel.WRAPPERS]
    f = extractor.extract(gray, orb, cam.height, cam.width)
    assert [w.launches - b for w, b in zip(orb_kernel.WRAPPERS, before)] == [1, 1, 1, 1]
    pad = sum(max(k - c, 0) for k, c in zip(quotas, orb_kernel.n_candidates(shapes)))
    resp, uv_lv, uv, level, valid = orb_kernel.quota_select_plain(
        *orb_kernel.fast_cells_plain(canvas, shapes, orb.ini_th_fast, orb.min_th_fast),
        shapes, quotas, orb.scale_factor)
    angle, desc = orb_kernel.describe_plain(canvas, image_ops.gaussian_blur(canvas, 7, 2.0),
                                            uv_lv, level)
    for name, want in zip(f._fields, (uv, resp, angle, level, desc, valid)):
        assert _same(getattr(f, name), want), name
    if case in ("flat", "saturated"):
        assert not f.valid.any() and not f.response.any()
    if case == "rig":
        assert pad > 0 and int((f.response == 0).sum()) >= pad
    else:
        assert pad == 0


@pytest.mark.parametrize("case", orb_cases.QUOTA_CASES)
def test_orb_quota_select_edges_equal_plain(card, case):
    """orb_quota_select bitwise its plain twin, on the card and on the CPU,
    at the quota's edges (ops/orb_cases.py): every score equal, every score
    +0, ties with both zeros and negatives, levels with fewer candidates
    than their quota (padded rows), the stereo cell's 3542-candidate level
    0, one level of 32768 candidates, a quota equal to its level's
    candidates beside a quota of 0; one launch a call."""
    scores, uv, shapes, quotas, scale = orb_cases.quota_input(case)
    want = orb_kernel.quota_select_plain(scores, uv, shapes, quotas, scale)
    before = orb_kernel.orb_quota_select.launches
    got = orb_kernel.orb_quota_select(scores.to(card), uv.to(card), shapes, quotas, scale)
    assert orb_kernel.orb_quota_select.launches == before + 1
    on_card = orb_kernel.quota_select_plain(scores.to(card), uv.to(card), shapes, quotas, scale)
    for g, w, c in zip(got, want, on_card):
        assert _same(g, c) and _same(g.cpu(), w)


@pytest.mark.parametrize("case", orb_cases.BLUR_CASES)
def test_gaussian_blur7_edges_equal_plain(card, case):
    """gaussian_blur7 bitwise its plain twin, on the card and on the CPU, at
    the blur's edges (ops/orb_cases.BLUR_CASES; each plane +0 outside its
    level): one level, H or W = 4, sides no multiple of the tile, a one-tile
    canvas beside 1 x 1 levels, levels spanning the canvas, 3-px bands that
    meet its edge, the stereo canvas (rows not 16-byte multiples), the rig;
    one launch a call."""
    canvas, shapes = orb_cases.blur_input(case)
    want = image_ops.gaussian_blur(canvas, 7, 2.0)
    before = orb_kernel.gaussian_blur7.launches
    got = orb_kernel.gaussian_blur7(canvas.to(card), shapes)
    assert orb_kernel.gaussian_blur7.launches == before + 1
    assert _same(got, image_ops.gaussian_blur(canvas.to(card), 7, 2.0))
    assert _same(got.cpu(), want)


@pytest.mark.parametrize("case", orb_cases.DESCRIBE_CASES)
def test_orb_describe_edges_equal_plain(card, case):
    """orb_describe bitwise its plain twin on the card at the descriptor's
    edges (ops/orb_cases.DESCRIBE_CASES): discs and patches that leave the
    canvas on each side (the defaults' and the stereo cell's), every level,
    all 30 bins, 1 and 3 keypoints, 1501 (not a multiple of a CTA's four);
    one launch a call. No keypoint: empty outputs and no launch."""
    canvas, blurred, uv, level = (t.to(card) for t in orb_cases.describe_input(case))
    before = orb_kernel.orb_describe.launches
    got = orb_kernel.orb_describe(canvas, blurred, uv, level)
    n = uv.shape[0]
    assert orb_kernel.orb_describe.launches == before + (n > 0)
    if n == 0:
        assert got[0].shape == (0,) and got[1].shape == (0, 32)
        return
    for g, w in zip(got, orb_kernel.describe_plain(canvas, blurred, uv, level)):
        assert _same(g, w)


def test_mono_bootstrap_on_card_takes_the_cpu_f(card):
    """chip_smoke.py's mono cell's bootstrap (the SlamConfig() defaults,
    frames 0 and 2 of the static scene rendered on the card as 8-bit RGB,
    extracted and matched on the CPU) through initialize on the card and on
    the CPU from the same matches: the same F hypothesis (the fundamental
    RANSAC's winner under the JAX draws, and its inlier set), the same model
    choice, the same good points and the pose to 1e-4. Some of the 200
    8-point samples repeat a row; their null vectors are solved on the host
    (initializer._null_vectors), where cuSOLVER's pick had won. That solve
    waits for the card twice (the copy out and the copy back), and
    initialize waits no more than that over its waits with cuSOLVER's own
    solve."""
    from gdslam_tpu_torch.core import prng
    from gdslam_tpu_torch.frontend import initializer
    from gdslam_tpu_torch.frontend.frame import build_frame
    from gdslam_tpu_torch.system.slam import Sensor
    cfg = SlamConfig()
    cam = cfg.camera
    s = System(cfg, Sensor.MONOCULAR, device="cpu")
    frames = []
    for i in (0, 2):
        rgb = synthetic.render_frame(i, cam, with_dynamic=False, device=card).rgb
        g = s._to_gray(torch.round(rgb).clamp(0, 255).to(torch.uint8).cpu().numpy())
        frames.append(build_frame(extractor.extract(g, cfg.orb, cam.height, cam.width),
                                  torch.zeros_like(g), torch.ones_like(g), cam))
    good, idx = tracking.bootstrap_matches(*frames, cfg.orb.n_levels)
    x1, x2, K = frames[0].uv, frames[1].uv[idx.long()], (cam.fx, cam.fy, cam.cx, cam.cy)
    idx_f = draw_kernel.uniform_over(prng.prng_key(0), good, 200 * 8).reshape(200, 8)
    assert sum(len(set(r)) < 8 for r in idx_f.tolist()) >= 1
    on = lambda t: t.to(card)                                     # noqa: E731
    _, sf_c, inl_c = initializer.fundamental_hypotheses(x1, x2, good, idx_f)
    _, sf_g, inl_g = initializer.fundamental_hypotheses(on(x1), on(x2), on(good), on(idx_f))
    best = int(torch.argmax(sf_c))
    assert int(torch.argmax(sf_g)) == best
    assert torch.equal(inl_g[best].cpu(), inl_c[best])
    want = initializer.initialize(x1, x2, good, K, seed=0)
    args = (on(x1), on(x2), on(good), K)

    def waits(run):
        """{file:line: count} of run()'s waits for the card."""
        run()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message) and "prototype" not in str(w.message))

    got, sites = waits(lambda: initializer.initialize(*args, seed=0))
    src, first = inspect.getsourcelines(initializer._null_vectors)
    copy_site = f"initializer.py:{first + next(i for i, ln in enumerate(src) if '.cpu()' in ln)}"
    real = initializer._null_vectors
    initializer._null_vectors = lambda A: torch.linalg.svd(A)[2][..., -1, :]  # noqa: E731
    try:
        _, card_sites = waits(lambda: initializer.initialize(*args, seed=0))
    finally:
        initializer._null_vectors = real
    print("initialize's waits:", dict(sites), "with cuSOLVER's own solve:", dict(card_sites))
    assert sites[copy_site] == 2
    assert sum(sites.values()) <= sum(card_sites.values()) + 2
    assert bool(want.ok) and bool(got.ok)
    assert bool(got.used_homography) == bool(want.used_homography)
    assert torch.equal(got.is_good.cpu(), want.is_good)
    torch.testing.assert_close(got.T_21.cpu(), want.T_21, atol=1e-4, rtol=0)


def test_orb_atan2_and_bins_on_card(card):
    """orb_describe's own atan2f and rotation bins (one device function with
    the kernel's) against torch.atan2 and angle_bins on the card and the
    bins on the CPU: the rendered frame's 1500 moment pairs, pairs on and
    near the axes and at (0, 0) with every sign of zero, and angles within
    4 ulps of each of the 30 bin edges (each edge straddled)."""
    gray, orb, cam = orb_cases.orb_input("rendered", card)
    canvas, shapes, quotas = _orb_levels(gray, orb, cam)
    sel = orb_kernel.orb_quota_select(
        *orb_kernel.orb_fast_cells(canvas, shapes, orb.ini_th_fast, orb.min_th_fast),
        shapes, quotas, orb.scale_factor)
    m10, m01 = orb_kernel.ic_moments(orb_ops.extract_patches(canvas, sel[1], level=sel[3]))
    pairs = torch.from_numpy(orb_cases.axis_moment_pairs()).to(card)
    a10, a01 = torch.cat([m10, pairs[:, 0]]), torch.cat([m01, pairs[:, 1]])
    edges = orb_cases.bin_edge_angles(orb_kernel.RCP_BIN)
    ang = torch.from_numpy(np.resize(edges.reshape(-1), a10.shape[0])).to(card)
    got_a, got_b = orb_kernel.angle_bins_on_card(a10, a01, ang)
    assert _same(got_a, torch.atan2(a01, a10))
    assert torch.equal(got_b, orb_kernel.angle_bins(ang).int())
    assert torch.equal(got_b.cpu(), orb_kernel.angle_bins(ang.cpu()).int())
    edge_bins = orb_kernel.angle_bins(torch.from_numpy(edges))
    assert bool((edge_bins[:, 0] != edge_bins[:, -1]).all())
    f = extractor.extract(gray, orb, cam.height, cam.width)
    assert _same(f.angle, got_a[:m10.shape[0]])


def test_extract_waits_for_nothing(card):
    """extract on the card under torch's sync debug mode "error" (after a
    first call has uploaded its tables): no read, no upload; and at most 40
    ATen operators a call (the pyramid's and the kernels' outputs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    gray, orb, cam = orb_cases.orb_input("rendered", card)
    extractor.extract(gray, orb, cam.height, cam.width)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f = extractor.extract(gray, orb, cam.height, cam.width)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += not getattr(func, "is_view", False)
            return func(*args, **(kwargs or {}))

    with Count():
        extractor.extract(gray, orb, cam.height, cam.width)
    assert Count.n <= 40, Count.n
    assert int(f.valid.sum()) == orb.n_features


@pytest.mark.parametrize("name", ["gaussian_blur7", "orb_fast_cells", "orb_quota_select",
                                  "orb_describe"])
def test_orb_wrappers_raise_without_the_library(card, monkeypatch, name):
    """On real CUDA tensors: with the library loader failing each front-end
    wrapper raises, counts no launch and never takes its plain version."""
    from gdslam_tpu_torch.ops import cuda_build

    def missing(lib_name, declare):
        raise RuntimeError(f"{lib_name}: library missing")

    gray, orb, cam = orb_cases.orb_input("rig", card)
    canvas, shapes, quotas = _orb_levels(gray, orb, cam)
    cand = orb_kernel.orb_fast_cells(canvas, shapes, orb.ini_th_fast, orb.min_th_fast)
    sel = orb_kernel.orb_quota_select(*cand, shapes, quotas, orb.scale_factor)
    monkeypatch.setattr(cuda_build, "load", missing)
    for plain in ("fast_cells_plain", "quota_select_plain", "describe_plain"):
        monkeypatch.setattr(orb_kernel, plain,
                            lambda *a, **k: pytest.fail("fell back to the plain version"))
    monkeypatch.setattr(image_ops, "gaussian_blur",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    call = {"gaussian_blur7": lambda: orb_kernel.gaussian_blur7(canvas, shapes),
            "orb_fast_cells": lambda: orb_kernel.orb_fast_cells(canvas, shapes, 20, 7),
            "orb_quota_select": lambda: orb_kernel.orb_quota_select(*cand, shapes, quotas, 1.2),
            "orb_describe": lambda: orb_kernel.orb_describe(canvas, canvas, sel[1], sel[3])}[name]
    wrapper = getattr(orb_kernel, name)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="library missing"):
        call()
    assert wrapper.launches == before


def test_stereo_slice_on_card_tracks_like_cpu(card):
    """8 pairs of the static scene at the 120x160 rig (the right view
    shifted by the baseline) through System.track_stereo on the card and on
    the CPU: both OK, ATEs within 5 mm of each other and under 5 cm (the
    CPU gives 1.03 cm at this size; the JAX stereo test's gate is 10 cm),
    keyframes within two (the pyramid's products sum in another order on
    the card, which moves a few descriptor bits and so some matches)."""
    cam = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=384, n_levels=4))
    shift = torch.eye(4)
    shift[0, 3] = cam.bf / cam.fx
    runs = {}
    for dev in ("cpu", card):
        s = System(cfg, kmax=32, pmax=16384, device=dev)
        gt = []
        for i in range(8):
            T = synthetic.gt_pose(i, 30.0, dev)
            left = synthetic.render(T, cam, False, 30.0, i).gray
            right = synthetic.render(T @ shift.to(dev), cam, False, 30.0, i).gray
            s.track_stereo(left, right, i / 30.0)
            gt.append(T.cpu().numpy())
        assert s.tracking_state.name == "OK"
        est = np.stack([T[:3, 3] for _, T in s.tracker.camera_trajectory()])
        gtp = np.stack([(np.linalg.inv(gt[0]) @ T)[:3, 3] for T in gt])
        runs[str(dev)] = (s.keyframe_count, metrics.ate_rmse(est, gtp))
    (kc, ac), (kg, ag) = runs.values()
    assert abs(kc - kg) <= 2 and abs(ac - ag) < 0.005 and max(ac, ag) < 0.05, runs


@pytest.mark.parametrize("case", pose_cases.CASES)
def test_pose_gn_kernel_equals_plain(card, case):
    """pose_gn bitwise its plain twin on the card (T, the inlier mask and its
    count) on every case of ops/pose_cases.py: the tracker's 1500 rows, the
    stereo cell's 2000, the mono bootstrap's refinement, no row valid, rows
    behind the camera, a NaN row (every step skipped), one point (pivots at
    rounding level), N = 1, 513, 1501 and 6001 (past the rows the kernel
    keeps in shared memory); one launch a call, and a second
    call bitwise the first. Against the twin on the CPU (whose sqrt, sin and
    cos round otherwise) T to 1e-5 and the same inliers, rank_deficient
    aside."""
    args = pose_cases.pose_args(case, card)
    want = pose_kernel.pose_gn_plain(*args)
    before = pose_kernel.pose_gn.launches
    got = pose_kernel.pose_gn(*args)
    again = pose_kernel.pose_gn(*args)
    assert pose_kernel.pose_gn.launches == before + 2
    for g, w, a in zip(got, want, again):
        assert _same(g, w) and _same(a, g)
    if case in pose_cases.CARD_ONLY:
        return
    cpu = pose_kernel.pose_gn_plain(*pose_cases.pose_args(case))
    torch.testing.assert_close(got[0].cpu(), cpu[0], atol=1e-5, rtol=0)
    assert torch.equal(got[1].cpu(), cpu[1]) and int(got[2]) == int(cpu[2])


def test_pose_gn_math_equals_torch(card):
    """The kernel's own sinf, cosf and sqrtf (one device function with it)
    bitwise torch.sin, torch.cos and torch.sqrt on the card, on the angles
    a step takes (1e-8 to 1 rad, log-spaced, and seeded ones) and on the
    square roots' arguments (weights, pivots, theta^2 + 1e-16)."""
    r = np.random.default_rng(0)
    x = np.concatenate([np.geomspace(1e-8, 1.0, 200_000), r.uniform(0, 0.3, 200_000),
                        r.uniform(0, 1e4, 100_000), [0.0, 1e-16, 1e-8]]).astype(np.float32)
    t = torch.from_numpy(x).to(card)
    s, c, q = pose_kernel.math_on_card(t)
    assert _same(s, torch.sin(t)) and _same(c, torch.cos(t)) and _same(q, torch.sqrt(t))


def test_pose_gn_waits_for_nothing(card):
    """pose_optimization on the card under torch's sync debug mode "error"
    (after a first call has built and loaded the library): no read, no
    upload, one launch."""
    args = pose_cases.pose_args("tracker_1500", card)
    from gdslam_tpu_torch.backend import optimizer
    optimizer.pose_optimization(*args[:4])
    torch.cuda.synchronize()
    before = pose_kernel.pose_gn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = optimizer.pose_optimization(*args[:4])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pose_kernel.pose_gn.launches == before + 1
    assert _same(out[0], pose_kernel.pose_gn_plain(*args)[0])


def _to(x, dev):
    """A tensor, or a NamedTuple of them (nested), on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    return x


def test_track_frame_core_on_card_equals_cpu(card):
    """track_frame_core (the motion model and the local map, each solving
    its pose through pose_gn: two launches) on the card against the CPU
    route on the same state and frame: the small rig tracked 8 frames on the
    CPU, the 9th frame built there, both moved to the card. The matches are
    exact (match_top2), the solves round sqrt, sin and cos otherwise on the
    CPU: T within 1e-4, the inlier counts within 2, the associations of 99%
    of the keypoints equal (the file's slice test holds ATE to 5 mm)."""
    cam = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=384, n_levels=4))
    s = System(cfg, kmax=32, pmax=16384, device="cpu")
    for i in range(8):
        fr = synthetic.render_frame(i, cam, with_dynamic=False, device="cpu")
        s.track_rgbd(fr.gray, fr.depth, None, i / 30.0)
    tr = s.tracker
    nxt = synthetic.render_frame(8, cam, with_dynamic=False, device="cpu")
    frame = build_frame(extractor.extract(nxt.gray, cfg.orb, cam.height, cam.width), nxt.depth,
                        torch.ones_like(nxt.gray), cam)
    state = (tr.arena, tr.last, tr.velocity, True, frame, cfg, tr.ref_kf)
    want = tracking.track_frame_core(*state)
    before = pose_kernel.pose_gn.launches
    got = tracking.track_frame_core(*(_to(v, card) for v in state))
    assert pose_kernel.pose_gn.launches == before + 2
    torch.testing.assert_close(got[1].T_cw.cpu(), want[1].T_cw, atol=1e-4, rtol=0)
    n_got, n_want = got[4].cpu(), want[4]
    assert (n_got[:2] - n_want[:2]).abs().max() <= 2, (n_got, n_want)
    assert (got[1].assoc.cpu() == want[1].assoc).float().mean() >= 0.99
