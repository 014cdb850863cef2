"""The port's host state machine against the JAX package's on the small rig
of tests/test_torch_tracking.py, from a shared state after six tracked
frames (pipelined and not): the forced loss and its relocalization, the
motion model's wide retry, the pose pre-pass, localization mode and reset.
Each test works on a fork of the shared trackers (their tensors are never
written in place; the host lists are copied)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.system import tracking as jtr
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.system import slam as tslam
from gdslam_tpu_torch.system import tracking as ttr
from test_torch_tracking import (KMAX, N_FRAMES, ONES, PMAX, SCAM, TCFG, _ate, _jax_frame,
                                 _jax_tracker, _torch_frame)

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

N_SHARED = 6


@pytest.fixture(scope="module")
def seq():
    return [jsyn.render_frame(i, SCAM, with_dynamic=False) for i in range(N_FRAMES + 1)]


@pytest.fixture(scope="module")
def shared(seq):
    """{pipeline: (JAX tracker, port tracker)} after N_SHARED frames, flushed."""
    out = {}
    for pipeline in (False, True):
        tr_j, _ = _jax_tracker(seq, N_SHARED, pipeline=pipeline)
        tr_t = ttr.Tracking(TCFG, kmax=KMAX, pmax=PMAX, pipeline=pipeline, device="cpu")
        for i, fr in enumerate(seq[:N_SHARED]):
            tr_t.process(np.asarray(fr.gray), np.asarray(fr.depth), ONES, i / 30.0)
        tr_t.flush()
        out[pipeline] = (tr_j, tr_t)
    return out


def _fork(tr):
    t2 = copy.copy(tr)
    t2.records, t2.kf_timestamps, t2._pending = list(tr.records), list(tr.kf_timestamps), []
    return t2


def _step(mod, tr, fr, i):
    """One frame through either package's tracker, flushed."""
    if mod is jtr:
        tr.process(fr.gray, fr.depth, ONES, i / 30.0)
    else:
        tr.process(np.asarray(fr.gray), np.asarray(fr.depth), ONES, i / 30.0)
    tr.flush()


def _teleported(mod, tr, dx: float = 0.0, yaw: float = 0.0):
    """The tracker with its last pose moved `dx` metres sideways or turned
    `yaw` radians about the vertical axis, and no velocity: the motion model
    then searches in the wrong place."""
    T = np.array(tr.last.T_cw)
    T[0, 3] += dx
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32) @ T
    T = jnp.asarray(T) if mod is jtr else torch.from_numpy(T)
    tr.last = tr.last._replace(T_cw=T)
    tr.velocity = None
    return tr


@pytest.mark.parametrize("pipeline", [False, True])
def test_forced_loss_relocalizes_in_both(seq, shared, pipeline):
    """After six tracked frames the last pose is put 1 m off and the velocity
    dropped, so track_frame_core fails on the next frame (n1 < 10 with both
    search radii) and _relocalize must recover the pose from the recent
    keyframes on that same frame. Both packages stay OK, keep their map
    (the early-loss reset is not taken) and land on the same pose to 2 cm
    and 1 degree: their RANSAC samples differ, the refined result does not
    depend on them."""
    n = N_SHARED
    tr_j, tr_t = (_fork(t) for t in shared[pipeline])
    good = []
    for mod, tr in ((jtr, tr_j), (ttr, tr_t)):
        n_kf = tr.n_kf_host
        _teleported(mod, tr, 1.0)
        _step(mod, tr, seq[n], n)
        assert tr.state.name == "OK" and tr.n_kf_host >= n_kf and tr.velocity is None
        assert len(tr.camera_trajectory()) == n + 1
        good.append(np.asarray(tr.last.T_cw))
    T_gt = np.linalg.inv(np.asarray(seq[n].T_wc)) @ np.asarray(seq[0].T_wc)
    for T in good:
        assert np.abs(T[:3, 3] - T_gt[:3, 3]).max() < 0.02
        cos = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
    np.testing.assert_allclose(good[1], good[0], atol=5e-3)


@pytest.mark.parametrize("pipeline", [False, True])
def test_wide_retry_matches_jax(seq, shared, pipeline):
    """The last pose turned 0.169 rad (about 27 px in the image) with no
    velocity: the motion model's 15 px search (26 px at the coarsest level)
    finds too little and the wide retry (30 px from the last pose), which the
    JAX package takes inside its program and the port takes on a second
    dispatch, recovers the frame. Same statistics,
    pose to 1e-4 and association in both, without relocalizing."""
    n = N_SHARED
    tr_j, tr_t = (_fork(t) for t in shared[pipeline])
    _teleported(jtr, tr_j, yaw=0.169)
    _teleported(ttr, tr_t, yaw=0.169)
    narrow = ttr.track_frame_core(tr_t.arena, tr_t.last, torch.eye(4), False,
                                  _torch_frame(_jax_frame(seq[n])), TCFG, tr_t.ref_kf)
    assert int(narrow[4][0]) < 10                         # the narrow search does fail
    called = []
    tr_t._relocalize = lambda frame: called.append(1) or (False, None, None, 0)
    _step(jtr, tr_j, seq[n], n)
    _step(ttr, tr_t, seq[n], n)
    assert not called and tr_t.state.name == tr_j.state.name == "OK"
    assert tr_t.n_inliers == tr_j.n_inliers >= 30
    np.testing.assert_allclose(tr_t.last.T_cw.numpy(), np.asarray(tr_j.last.T_cw), atol=1e-4)
    np.testing.assert_array_equal(tr_t.last.assoc.numpy(), np.asarray(tr_j.last.assoc))
    assert len(tr_t.camera_trajectory()) == len(tr_j.camera_trajectory()) == n + 1


def test_pipelined_record_keeps_the_dispatch_keyframe(seq, shared):
    """Three pipelined frames of which the first is made a keyframe when it
    is committed: the two after it were dispatched against the old reference
    keyframe and are committed after the new one exists. The port records
    them against the old keyframe, so their trajectory poses stay on the
    ground truth; the JAX package records the keyframe current at commit
    time and its poses for those two frames are off by the motion between
    the keyframes (ROADMAP.md section 3). The relative poses themselves are
    equal in both."""
    tr_j, tr_t = (_fork(t) for t in shared[True])
    old_ref = tr_t.ref_kf
    assert tr_j.ref_kf == old_ref and tr_t.commit_every == 3
    for tr in (tr_j, tr_t):
        calls = []
        tr._need_keyframe_stats = lambda *a, _c=calls: (_c.append(1), len(_c) == 1)[1]
    n = N_SHARED
    for i in range(n, n + 3):
        tr_j.process(seq[i].gray, seq[i].depth, ONES, i / 30.0)
        tr_t.process(np.asarray(seq[i].gray), np.asarray(seq[i].depth), ONES, i / 30.0)
    assert not tr_t._pending and not tr_j._pending
    new_ref = tr_t.ref_kf
    assert new_ref == tr_j.ref_kf == tr_t.n_kf_host - 1 > old_ref
    assert [r[1] for r in tr_t.records[n:]] == [old_ref] * 3
    assert [r[1] for r in tr_j.records[n:]] == [old_ref, new_ref, new_ref]
    np.testing.assert_allclose(torch.stack([r[2] for r in tr_t.records[n:]]).numpy(),
                               np.stack([np.asarray(r[2]) for r in tr_j.records[n:]]), atol=1e-4)
    T0 = np.asarray(seq[0].T_wc)

    def errors(traj):
        return [np.linalg.norm(T[:3, 3] - (np.linalg.inv(T0) @ np.asarray(seq[i].T_wc))[:3, 3])
                for i, (_, T) in zip(range(n, n + 3), traj[n:])]

    err_t, err_j = errors(tr_t.camera_trajectory()), errors(tr_j.camera_trajectory())
    assert max(err_t) < 0.02, err_t
    assert abs(err_t[0] - err_j[0]) < 1e-4 and min(err_j[1:]) > max(err_t) + 0.02, (err_t, err_j)


def test_light_track_changes_no_state(seq, shared):
    """The pose pre-pass returns the JAX package's pose (1e-4) and leaves the
    arena, the last frame, the velocity and the records as they were; it
    refuses before initialization."""
    n = N_SHARED
    assert ttr.Tracking(TCFG, kmax=KMAX, pmax=PMAX, device="cpu").light_track(None) == \
        (False, None)
    tr_j, tr_t = (_fork(t) for t in shared[False])
    jf = _jax_frame(seq[n])
    before = (convert.arena_to_numpy(tr_t.arena), convert.frame_state_to_numpy(tr_t.last),
              tr_t.velocity.clone(), len(tr_t.records), tr_t.frame_id)
    ok_j, T_j = tr_j.light_track(jf)
    ok_t, T_t = tr_t.light_track(_torch_frame(jf))
    assert ok_t and ok_j
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    after = (convert.arena_to_numpy(tr_t.arena), convert.frame_state_to_numpy(tr_t.last),
             tr_t.velocity, len(tr_t.records), tr_t.frame_id)
    for b, a in zip(before[:2], after[:2]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch.equal(after[2], before[2]) and after[3:] == before[3:]


def test_localization_mode_and_reset(seq, shared):
    """Localization mode stops map growth (no keyframe, no new point) while
    tracking goes on against the frozen map, with the temporal points of the
    motion model, as in the JAX package; reset gives a fresh tracker that
    keeps the sizes, the pipeline flag and the commit interval."""
    tr_j, tr_t = (_fork(t) for t in shared[True])
    sys_t = tslam.System(TCFG, kmax=KMAX, pmax=PMAX, pipeline=True, device="cpu")
    sys_t.tracker = tr_t
    tr_t.commit_every = 2
    sys_t.activate_localization_mode()
    tr_j.mapping_enabled = False
    n_kf, n_pt = sys_t.keyframe_count, int(tr_t.arena.n_pt)
    for i, fr in enumerate(seq[N_SHARED:N_FRAMES], start=N_SHARED):
        sys_t.track_rgbd(np.asarray(fr.gray), np.asarray(fr.depth), None, i / 30.0)
        tr_j.process(fr.gray, fr.depth, ONES, i / 30.0)
    sys_t.shutdown()
    tr_j.flush()
    assert sys_t.tracking_state.name == tr_j.state.name == "OK"
    assert sys_t.keyframe_count == n_kf == int(tr_j.arena.kf_valid.sum())
    assert int(tr_t.arena.n_pt) == n_pt
    assert tr_t.n_inliers == tr_j.n_inliers
    traj_t, traj_j = tr_t.camera_trajectory(), tr_j.camera_trajectory()
    assert len(traj_t) == len(traj_j) == N_FRAMES
    # the poses of the localization-mode frames (the shared pipelined frames
    # before them carry the JAX package's record fault, ROADMAP.md section 3)
    np.testing.assert_allclose(np.stack([T for _, T in traj_t[N_SHARED:]]),
                               np.stack([T for _, T in traj_j[N_SHARED:]]), atol=1e-4)
    assert _ate(traj_t, seq) < 0.03
    sys_t.deactivate_localization_mode()
    assert tr_t.mapping_enabled
    sys_t.reset()
    tr = sys_t.tracker
    assert tr.state.name == "NO_IMAGES_YET" and tr.pipeline and tr.commit_every == 2
    assert (tr.arena.kmax, tr.arena.pmax, int(tr.arena.n_kf)) == (KMAX, PMAX, 0)
    assert tr.device.type == "cpu" and not tr.records
