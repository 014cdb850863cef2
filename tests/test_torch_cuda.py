"""Tests of the port that need an NVIDIA card: the CUDA kernels against their
plain PyTorch versions, and the slice on the card against the slice on the
CPU. They skip without a card. This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gdslam_tpu_torch import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu_torch.backend import gba, loop_closing, mapping, pose_graph, solvers
from gdslam_tpu_torch.backend import vocabulary
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.frontend import matcher
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.io import synthetic
from gdslam_tpu_torch.masking import geomask, geometry
from gdslam_tpu_torch.ops import match_kernel
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
    rotation is the quaternion form, not an SVD)."""
    frames, raw = _gd_raw(6, card)
    gray = frames[5].gray
    depth = frames[5].depth
    ref = frames[0]
    feats = extractor.extract(ref.gray, GD_CFG.orb, 240, 320)
    sem = torch.ones_like(gray)
    gen = solvers.frame_generator(5, card)
    geomask.gd_step(gray, depth, sem, ref.gray, ref.depth, feats, GD_CFG, gen)   # warm caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, refined = geomask.gd_step(gray, depth, sem, ref.gray, ref.depth, feats, GD_CFG, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert refined.shape == (240, 320) and bool((refined < 0.5).any())


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
