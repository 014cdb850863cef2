"""Parity of the port's tracker (gdslam_tpu_torch.system.{tracking,slam})
with the JAX package's, on the small 120x160 / 384-feature / 4-level rig
with local BA and triangulation off (the configuration the port runs).

State crosses between the packages as numpy through gdslam_tpu_torch.convert.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.system import tracking as jtr
from gdslam_tpu.utils import metrics
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import map_arena as tma
from gdslam_tpu_torch.frontend import frame as tframe
from gdslam_tpu_torch.system import slam as tslam
from gdslam_tpu_torch.system import tracking as ttr

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
SCFG = SlamConfig(camera=SCAM, orb=OrbConfig(n_features=384, n_levels=4))
TCFG = convert.config_from_jax_dict(dataclasses.asdict(SCFG))
KMAX, PMAX = 32, 16384
N_FRAMES, SNAP = 10, 5
ONES = np.ones((120, 160), np.float32)


def _np_tree(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def _jax_frame(fr):
    feats = jext.extract(fr.gray, SCFG.orb, SCAM.height, SCAM.width)
    return jframe.build_frame(feats, fr.depth, jnp.asarray(ONES), SCAM)


def _torch_frame(jf) -> tframe.Frame:
    return tframe.Frame(**{k: torch.from_numpy(v.copy()) for k, v in _np_tree(jf).items()})


def _ate(traj, seq) -> float:
    T0 = np.asarray(seq[0].T_wc)
    est = np.array([T[:3, 3] for _, T in traj])
    gt = np.array([(np.linalg.inv(T0) @ np.asarray(seq[round(ts * 30)].T_wc))[:3, 3]
                   for ts, _ in traj])
    return metrics.ate_rmse(est, gt)


@pytest.fixture(scope="module")
def seq():
    return [jsyn.render_frame(i, SCAM, with_dynamic=False) for i in range(N_FRAMES + 1)]


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX tracker over N_FRAMES, with its state after SNAP frames."""
    tr = jtr.Tracking(SCFG, kmax=KMAX, pmax=PMAX)
    tr.use_local_ba = False
    tr.use_triangulation = False
    snap = None
    for i, fr in enumerate(seq[:N_FRAMES]):
        if i == SNAP:
            snap = dict(arena=tr.arena, last=tr.last, velocity=tr.velocity, ref_kf=tr.ref_kf)
        tr.process(fr.gray, fr.depth, ONES, i / 30.0)
    return tr, snap


def test_track_frame_core_one_step_matches_jax(seq, jax_run):
    """The JAX tracker's arena and FrameState after SNAP frames go through
    convert.py; one track_frame_core on the same next frame. Stats, assoc
    and every arena field are identical; T agrees to 1e-4 (the GN solves
    sum in another order; observed ~1e-8)."""
    _, snap = jax_run
    jf = _jax_frame(seq[SNAP])
    vel = snap["velocity"]
    a_j, fs_j, _, _, st_j = jtr.track_frame_core(
        snap["arena"], snap["last"], vel, jnp.asarray(True), jf, SCFG,
        jnp.asarray(snap["ref_kf"]))

    arena_t = convert.arena_from_numpy(_np_tree(snap["arena"]), "cpu")
    last_d = _np_tree(snap["last"].frame)
    last_d.update(T_cw=np.asarray(snap["last"].T_cw), assoc=np.asarray(snap["last"].assoc))
    last_t = convert.frame_state_from_numpy(last_d, "cpu")
    a_t, fs_t, _, _, st_t = ttr.track_frame_core(
        arena_t, last_t, torch.from_numpy(np.array(vel)), True, _torch_frame(jf), TCFG,
        snap["ref_kf"])

    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert int(st_t[1]) >= 30                              # a real tracking step
    np.testing.assert_allclose(fs_t.T_cw.numpy(), np.asarray(fs_j.T_cw), atol=1e-4)
    np.testing.assert_array_equal(fs_t.assoc.numpy(), np.asarray(fs_j.assoc))
    got = convert.arena_to_numpy(a_t)
    for k, want in _np_tree(a_j).items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[k], want, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    # round trip of the carried state
    back = convert.frame_state_to_numpy(last_t)
    for k, v in last_d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _assert_arena_equal(got: dict, want: dict):
    for k, w in want.items():
        if w.dtype.kind == "f":      # backprojection: products summed in another order
            np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_stereo_initialize_matches_jax(seq):
    """The first keyframe from the same frame: every arena row identical,
    map-point slot 0 included. The JAX scatter (tracking.py:124-126) writes
    every keypoint row, sending rows that create no point to slot 0 with
    slot 0's old value; on the CPU the last duplicate wins, so the point
    created in slot 0 is overwritten and lost. The port reproduces that.
    Floats agree to 1e-6, integers and booleans exactly."""
    jf = _jax_frame(seq[0])
    a_j, assoc_j = jtr.stereo_initialize(jtr.ma.new_arena(KMAX, PMAX, 384), jf,
                                         jnp.eye(4), SCFG)
    a_t, assoc_t = ttr.stereo_initialize(tma.new_arena(KMAX, PMAX, 384, "cpu"),
                                         _torch_frame(jf), torch.eye(4), TCFG)
    np.testing.assert_array_equal(assoc_t.numpy(), np.asarray(assoc_j))
    got, want = convert.arena_to_numpy(a_t), _np_tree(a_j)
    assert int(got["n_pt"]) == int(want["n_pt"]) > 100
    _assert_arena_equal(got, want)
    # this frame's last keypoint creates no point, so slot 0 is lost in both
    assert not got["pt_valid"][0] and got["pt_ref_kf"][0] == -1
    assert (np.asarray(assoc_j) == 0).sum() == 1


@pytest.mark.parametrize("last_row_creates", [True, False])
def test_insert_keyframe_slot_0_rule(seq, last_row_creates):
    """Slot 0 keeps its new point exactly when the highest-index row that
    targets slot 0 creates it: with every keypoint after the first creating
    one made depth-valid and unassociated, no later row carries slot 0's old
    value. Same arena rows as the JAX package either way."""
    jf = _jax_frame(seq[0])
    d = {k: v.copy() for k, v in _np_tree(jf).items()}
    if last_row_creates:
        d["valid"][:] = True
        d["depth"][:] = np.where(d["depth"] > 0, d["depth"], 1.5)
    jf2 = type(jf)(**{k: jnp.asarray(v) for k, v in d.items()})
    a_j, assoc_j = jtr.stereo_initialize(jtr.ma.new_arena(KMAX, PMAX, 384), jf2,
                                         jnp.eye(4), SCFG)
    a_t, assoc_t = ttr.stereo_initialize(tma.new_arena(KMAX, PMAX, 384, "cpu"),
                                         _torch_frame(jf2), torch.eye(4), TCFG)
    np.testing.assert_array_equal(assoc_t.numpy(), np.asarray(assoc_j))
    got = convert.arena_to_numpy(a_t)
    _assert_arena_equal(got, _np_tree(a_j))
    assert bool(got["pt_valid"][0]) == last_row_creates


def test_slice_matches_jax(seq, jax_run):
    """The whole slice through the port's entry point (System.track_rgbd)
    against the JAX tracker on the same 10 JAX-rendered frames: both OK,
    equal keyframe and map-point counts, and the two ATEs within 0.1 mm of
    each other. What remains between the runs is summation order: the IC
    angle's 31x31 moments (angles agree to ~1e-5 rad) and the GN solves,
    which move poses by ~1e-7 m here (observed ATE difference 7e-9 m); the
    tolerance leaves room for a descriptor bin edge falling the other way."""
    tr_j, _ = jax_run
    sys_t = tslam.System(TCFG, kmax=KMAX, pmax=PMAX, device="cpu")
    for i, fr in enumerate(seq[:N_FRAMES]):
        T = sys_t.track_rgbd(np.asarray(fr.gray), np.asarray(fr.depth), None, i / 30.0)
        assert T.shape == (4, 4) and np.isfinite(T).all()
    assert tr_j.state.name == "OK" and sys_t.tracking_state.name == "OK"
    assert sys_t.keyframe_count == int(tr_j.arena.kf_valid.sum()) >= 2
    assert sys_t.map_point_count == int(tr_j.arena.pt_valid.sum())
    ate_j = _ate(tr_j.camera_trajectory(), seq)
    ate_t = _ate(sys_t.tracker.camera_trajectory(), seq)
    assert len(sys_t.tracker.camera_trajectory()) == N_FRAMES
    assert abs(ate_t - ate_j) <= 1e-4, (ate_t, ate_j)
    assert ate_t < 0.03
