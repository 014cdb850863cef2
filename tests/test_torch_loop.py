"""Parity of the port's loop closing (gdslam_tpu_torch.backend.{loop_closing,
gba, solvers}) with the JAX package on the CPU (the Lie group and the pose
graphs are in tests/test_torch_pose_graph.py).

The revisit state is built by the JAX package without tracking: keyframes
of the loop circuit (io.synthetic.gt_pose_loop) inserted at their
ground-truth poses, then two keyframes of the second lap inserted unfused at
drifted poses, so the last of them and keyframe 0 see the same place
through different map points, the state a loop closer meets. It carries
across with convert.arena_from_numpy; the RANSAC gets the JAX draw."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import gba as jgba
from gdslam_tpu.backend import loop_closing as jlc
from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.backend import solvers as jsol
from gdslam_tpu.backend import vocabulary as jvoc
from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.core import lie as jlie
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.system import tracking as jtr
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import gba as tgba
from gdslam_tpu_torch.backend import loop_closing as tlc
from gdslam_tpu_torch.backend import solvers as tsol
from gdslam_tpu_torch.core import lie as tlie

torch.set_num_threads(1)

# the JAX loop test's configuration (tests/test_loop_e2e.py)
LCAM = CameraConfig(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240,
                    bf=320.0 * 0.08)
LCFG = SlamConfig(camera=LCAM, orb=OrbConfig(n_features=512, n_levels=4))
TLCFG = convert.config_from_jax_dict(dataclasses.asdict(LCFG))
KMAX, PMAX, N = 48, 16384, 512   # K * K >= the 2048 covisibility edges
PERIOD = 120
LAP = tuple(range(0, 120, 10))           # first-lap keyframes at ground truth
REVISIT = (116, 121)                     # second lap, drifted, unfused
XI_DRIFT = np.asarray([0.10, 0.03, 0.0, 0.0, 0.05, 0.0], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _jax_frame(idx):
    fr = jsyn.render(jsyn.gt_pose_loop(idx, PERIOD), LCAM, False, 30.0, idx)
    f = jframe.build_frame(jext.extract(fr.gray, LCFG.orb, LCAM.height, LCAM.width), fr.depth,
                           jnp.ones((LCAM.height, LCAM.width)), LCAM)
    return f, np.asarray(fr.T_wc)


@pytest.fixture(scope="module")
def revisit():
    """(JAX arena as numpy, JAX LoopCloser with every keyframe in its DB,
    the current keyframe id, the candidate id, the ground-truth T_wc per kf)."""
    arena = jma.new_arena(KMAX, PMAX, N)
    G = np.asarray(jlie.se3_exp(jnp.asarray(XI_DRIFT)))
    gts = []
    for i, idx in enumerate(LAP + REVISIT):
        f, T_wc = _jax_frame(idx)
        T_cw = np.linalg.inv(T_wc).astype(np.float32)
        if idx in REVISIT:
            T_cw = (T_cw @ np.linalg.inv(G)).astype(np.float32)   # drifted estimate
        T_cw = jnp.asarray(T_cw)
        if i == 0:
            arena, _ = jtr.stereo_initialize(arena, f, T_cw, LCFG)
        else:
            assoc = -jnp.ones(N, jnp.int32)
            if idx not in REVISIT or idx != REVISIT[0]:
                assoc = jtr.fuse_associate(arena, f, T_cw, assoc, LCFG)
            arena, _ = jtr.insert_keyframe(arena, f, T_cw, assoc, jnp.asarray(idx / 30.0), LCFG)
        gts.append(T_wc)
    lc = jlc.LoopCloser(LCFG, jvoc.default_vocabulary(), KMAX)
    n_kf = len(LAP + REVISIT)
    for k in range(n_kf):
        lc.add_keyframe(arena, k)
    return {k: np.asarray(getattr(arena, k)) for k in arena._fields}, lc, n_kf - 1, 0, gts


def _port_closer(lc_j) -> tlc.LoopCloser:
    lc = tlc.LoopCloser(TLCFG, convert.vocabulary_from_numpy(
        np.asarray(lc_j.vocab.centers), lc_j.vocab.k, lc_j.vocab.levels, "cpu"), KMAX, "cpu")
    lc.db = convert.bow_db_from_numpy({k: np.asarray(getattr(lc_j.db, k))
                                       for k in lc_j.db._fields}, "cpu")
    return lc


def _jax_arena(d):
    return jma.MapArena(**{k: jnp.asarray(v) for k, v in d.items()})


def _feed_draw(monkeypatch, draw: np.ndarray):
    """The port's ransac_sim3 given `draw` as its sample_idx."""
    real = tsol.ransac_sim3
    monkeypatch.setattr(tsol, "ransac_sim3",
                        lambda *a, **k: real(*a, **{**k, "sample_idx": t(draw)}))


def _jax_draw(valid: np.ndarray, kf_id: int, n_iters: int = 300) -> np.ndarray:
    """The categorical draw of the JAX package's ransac_sim3 for kf_id."""
    probs = valid.astype(np.float32) / max(valid.sum(), 1)
    idx = jax.random.categorical(jax.random.PRNGKey(kf_id),
                                 jnp.log(jnp.asarray(probs) + 1e-12)[None, :]
                                 .repeat(n_iters * 3, 0))
    return np.asarray(idx)


# --------------------------------------------------------------------------
# the loop closer's pieces and the whole verify + correct on a revisit
# --------------------------------------------------------------------------

def test_bow_guided_matches_match_jax(revisit):
    a, lc_j, cur, cand, _ = revisit
    lc = _port_closer(lc_j)
    for kf_a, kf_b in ((cur, cand), (cur, cur - 1), (1, 0)):
        mj, nj = jlc._bow_guided_matches(
            jnp.asarray(a["kf_desc"][kf_a]), jnp.asarray(a["kf_kp_valid"][kf_a]),
            lc_j.db.words[kf_a], jnp.asarray(a["kf_desc"][kf_b]),
            jnp.asarray(a["kf_kp_valid"][kf_b]), lc_j.db.words[kf_b])
        mt, nt = tlc._bow_guided_matches(
            t(a["kf_desc"][kf_a]), t(a["kf_kp_valid"][kf_a]), lc.db.words[kf_a],
            t(a["kf_desc"][kf_b]), t(a["kf_kp_valid"][kf_b]), lc.db.words[kf_b])
        np.testing.assert_array_equal(n(mt), np.asarray(mj))
        assert int(nt) == int(nj) >= tlc.MIN_BOW_MATCHES


def test_ransac_and_optimize_sim3_match_jax(revisit):
    """ransac_sim3 fed the JAX draw (T to 1e-4), then optimize_sim3 from the
    same hypothesis (1e-3), on the revisit pair's BoW matches."""
    a, lc_j, cur, cand, _ = revisit
    ja = _jax_arena(a)
    m_idx, _ = jlc._bow_guided_matches(ja.kf_desc[cur], ja.kf_kp_valid[cur], lc_j.db.words[cur],
                                       ja.kf_desc[cand], ja.kf_kp_valid[cand],
                                       lc_j.db.words[cand])
    rows = jnp.maximum(m_idx, 0)
    Q, has_a = jlc._kf_points_cam(ja, jnp.asarray(cur), LCFG)
    P_all, has_b = jlc._kf_points_cam(ja, jnp.asarray(cand), LCFG)
    ok = (m_idx >= 0) & has_a & has_b[rows]
    K = (LCAM.fx, LCAM.fy, LCAM.cx, LCAM.cy)
    px = 3.04 * 1.2 ** jnp.maximum(ja.kf_level[cur], ja.kf_level[cand][rows]).astype(jnp.float32)
    args = dict(n_iters=300, min_inliers=20, err_threshold=0.10, with_scale=False)
    Rj, tj, sj, inl_j, n_j, ok_j = jsol.ransac_sim3(
        P_all[rows], Q, ok, jax.random.PRNGKey(cur), uv_p=ja.kf_uv[cand][rows],
        uv_q=ja.kf_uv[cur], K=K, px_threshold=px, **args)
    Rt, tt, st, inl_t, n_t, ok_t = tsol.ransac_sim3(
        t(P_all[rows]), t(Q), t(ok), uv_p=t(ja.kf_uv[cand][rows]), uv_q=t(ja.kf_uv[cur]), K=K,
        px_threshold=t(px), sample_idx=t(_jax_draw(np.asarray(ok), cur)), **args)
    assert bool(ok_t) == bool(ok_j) and bool(ok_t)
    np.testing.assert_allclose(n(tlie.rt_to_mat(Rt, tt)), np.asarray(jlie.rt_to_mat(Rj, tj)),
                               atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 1
    # OptimizeSim3 from the JAX hypothesis over the same matches
    X1, X2 = np.asarray(Q), np.asarray(P_all[rows])
    uv1, uv2 = np.asarray(ja.kf_uv[cur]), np.asarray(ja.kf_uv[cand][rows])
    is1 = 1.0 / 1.44 ** np.asarray(ja.kf_level[cur], np.float32)
    is2 = 1.0 / 1.44 ** np.asarray(ja.kf_level[cand][rows], np.float32)
    oj = jsol.optimize_sim3(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(uv1), jnp.asarray(uv2),
                            jnp.asarray(is1), jnp.asarray(is2), ok, (Rj, tj, sj), K, False)
    ot = tsol.optimize_sim3(t(X1), t(X2), t(uv1), t(uv2), t(is1), t(is2), t(ok),
                            (t(np.asarray(Rj)), t(np.asarray(tj)), t(np.asarray(sj))), K, False)
    for a_, b_ in zip(oj[:3], ot[:3]):
        np.testing.assert_allclose(n(b_), np.asarray(a_), atol=1e-3)
    assert abs(int(ot[4]) - int(oj[4])) <= 1


@pytest.mark.parametrize("fix_scale", [True, False], ids=["se3", "sim3"])
def test_compute_transform_and_correct_match_jax(revisit, fix_scale, monkeypatch):
    """The whole ComputeSim3 + CorrectLoop (propagation, essential graph,
    seam fusion, global BA) on the revisit pair: the same verdict, n_total
    exact, T to 1e-4, corrected keyframe poses to 1e-3 m (points: 99.9% to
    1e-3 m, all to 5e-3 m); with
    the scale fixed (RGB-D) and free (the monocular Sim3 correction,
    `_correct_sim3`)."""
    a, lc_j, cur, cand, _ = revisit
    ja = _jax_arena(a)
    lc_j.fix_scale = fix_scale
    lc_j.loops, lc_j.last_loop_kf, lc_j.last_sim3 = [], -jlc.MIN_KF_GAP, None
    ok_j, T_j, n_j = lc_j.compute_transform(ja, cur, cand)
    lc = _port_closer(lc_j)
    lc.fix_scale = fix_scale
    m_idx, _ = jlc._bow_guided_matches(ja.kf_desc[cur], ja.kf_kp_valid[cur], lc_j.db.words[cur],
                                       ja.kf_desc[cand], ja.kf_kp_valid[cand],
                                       lc_j.db.words[cand])
    rows = jnp.maximum(m_idx, 0)
    ok = (m_idx >= 0) & jlc._kf_points_cam(ja, jnp.asarray(cur), LCFG)[1] & \
        jlc._kf_points_cam(ja, jnp.asarray(cand), LCFG)[1][rows]
    ta = convert.arena_from_numpy(a, "cpu")
    _feed_draw(monkeypatch, _jax_draw(np.asarray(ok), cur))
    ok_t, T_t, n_t = lc.compute_transform(ta, cur, cand)
    assert ok_t == ok_j and ok_t
    assert n_t == n_j
    np.testing.assert_allclose(n(T_t), np.asarray(T_j), atol=1e-4)

    # correct from the same measurement: global BA's accept decisions turn
    # a 1e-5 difference of T into centimetres on a few points
    if not fix_scale:
        lc.last_sim3 = tuple(t(np.asarray(x, np.float32)) for x in lc_j.last_sim3)
    out_j = lc_j.correct(ja, cur, cand, T_j)
    out_t = lc.correct(ta, cur, cand, t(np.asarray(T_j)))
    nk = cur + 1
    np.testing.assert_allclose(n(out_t.kf_pose[:nk]), np.asarray(out_j.kf_pose[:nk]), atol=1e-3)
    assert lc.loops[0][:2] == lc_j.loops[0][:2] == (cur, cand)
    assert lc.last_loop_kf == cur and lc._consistent == {}
    # the points: global BA's conditioning (ROADMAP section 3) leaves a few
    # weakly constrained points millimetres apart
    d = np.abs(n(out_t.pt_pos) - np.asarray(out_j.pt_pos))[a["pt_valid"]]
    assert (d <= 1e-3).mean() >= 0.999 and d.max() < 5e-3, (d.max(), (d > 1e-3).sum())


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.002])
def test_global_bundle_adjustment_matches_jax(revisit, noise, gate):
    """GBA on the revisit map as it stands (drifted revisit keyframes whose
    points disagree with the lap's) and with its lap poses and points
    perturbed by `noise` (m, rad): poses and points to 1e-3 m (the BA
    conditioning of ROADMAP section 3), with and without the chi2 gate."""
    a, _, _, _, _ = revisit
    a = dict(a)
    if noise:
        rng = np.random.default_rng(2)
        a["kf_pose"] = a["kf_pose"].copy()
        for k in range(1, len(LAP)):
            d = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=6) * noise, jnp.float32)))
            a["kf_pose"][k] = (d @ a["kf_pose"][k]).astype(np.float32)
        a["pt_pos"] = (a["pt_pos"] + rng.normal(size=a["pt_pos"].shape) * noise).astype(np.float32)
    oj = jgba.global_bundle_adjustment(_jax_arena(a), LCFG, 4, gate)
    ot = tgba.global_bundle_adjustment(convert.arena_from_numpy(a, "cpu"), TLCFG, 4, gate)
    np.testing.assert_allclose(n(ot.kf_pose), np.asarray(oj.kf_pose), atol=1e-3)
    live = a["pt_valid"]
    np.testing.assert_allclose(n(ot.pt_pos)[live], np.asarray(oj.pt_pos)[live], atol=1e-3)
    assert np.abs(n(ot.pt_pos)[live] - a["pt_pos"][live]).max() > 1e-4   # it moved the map


def test_detect_and_process_keyframe_match_jax(revisit):
    """detect's streaks over three consecutive queries and the loop
    candidates' ids, as the JAX LoopCloser gives them."""
    a, lc_j, cur, _, _ = revisit
    ja = _jax_arena(a)
    lc = _port_closer(lc_j)
    ta = convert.arena_from_numpy(a, "cpu")
    lc.last_loop_kf = lc_j.last_loop_kf = -100
    for _ in range(3):
        assert lc.detect(ta, cur) == lc_j.detect(ja, cur)
        assert lc._consistent == lc_j._consistent
