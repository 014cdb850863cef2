"""Tests of the port that need an NVIDIA card: the CUDA kernel against its
plain PyTorch version, and the slice on the card against the slice on the
CPU. They skip without a card. This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gdslam_tpu_torch import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu_torch.frontend import matcher
from gdslam_tpu_torch.io import synthetic
from gdslam_tpu_torch.ops import match_kernel
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


@pytest.mark.parametrize("M,N", [(1500, 1500), (4096, 1500), (100, 33), (12, 8)])
def test_kernel_equals_plain(card, M, N):
    """Exactly equal outputs (integer costs); one counted launch."""
    d = _inputs(3, M, N, dup_rows=min(5, M - 1))
    args = [torch.from_numpy(d[k]).to(card) for k in KEYS]
    before = match_kernel.match_top2.launches
    got = match_kernel.match_top2(*args)
    torch.cuda.synchronize()
    assert match_kernel.match_top2.launches == before + 1
    want = match_kernel.match_top2_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w.cpu().to(torch.int32))


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
