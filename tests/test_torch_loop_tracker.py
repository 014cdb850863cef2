"""The port's tracker around loop closing and its pipelined commits, on the
CPU at the small rig of tests/test_torch_tracking.py (the port alone: these
are the port's own repairs, which the JAX package does not have):

- the rollback of a failed frame after a keyframe committed earlier in the
  same flush keeps the keyframe (Tracking._roll_back);
- a loop correction committed inside a flush re-anchors the live pose, the
  state a later rollback restores, and, not pipelined, the keyframe's pose;
- a keyframe compaction remaps the loop closer's database and loops.

The loop corrections are a LoopCloser whose process_keyframe moves every
keyframe by a known rigid transform, so the re-anchoring is exact."""

import numpy as np
import pytest
import torch

from gdslam_tpu_torch.backend import loop_closing as tlc
from gdslam_tpu_torch.backend import vocabulary as tvoc
from gdslam_tpu_torch.core import lie
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.system import tracking as ttr
from test_torch_tracking import KMAX, ONES, PMAX, TCFG

torch.set_num_threads(1)

N_WARM = 8
G = lie.se3_exp(torch.tensor([0.03, -0.02, 0.01, 0.01, 0.02, -0.01]))


@pytest.fixture(scope="module")
def frames():
    return [tsyn.render_frame(i, TCFG.camera, with_dynamic=False, device="cpu")
            for i in range(N_WARM + 4)]


def tiny_vocabulary() -> tvoc.Vocabulary:
    rng = np.random.default_rng(0)
    return tvoc.train(rng.integers(0, 256, (400, 32)).astype(np.uint8), k=4, levels=2, iters=3)


class ShiftingCloser(tlc.LoopCloser):
    """Closes a 'loop' at every keyframe by moving every keyframe pose by G
    (T -> T G), as a correction moves the map."""

    def process_keyframe(self, arena, kf_id):
        self.add_keyframe(arena, kf_id)
        self.loops.append((kf_id, 0, torch.eye(4)))
        return arena._replace(kf_pose=arena.kf_pose @ G)


def _tracker(frames, closer=None, pipeline=True):
    tr = ttr.Tracking(TCFG, kmax=KMAX, pmax=PMAX, pipeline=pipeline, device="cpu")
    for i in range(N_WARM):
        tr.process(frames[i].gray, frames[i].depth, ONES, i / 30.0)
    tr.flush()
    tr.loop_closer = closer
    return tr


def _queue(tr, frames, ids):
    """Dispatch frames without committing them (one flush later)."""
    tr.commit_every = 100
    for i in ids:
        tr.process(frames[i].gray, frames[i].depth, ONES, i / 30.0)
    return list(tr._pending)


def _force(tr, k, stats):
    tr._pending[k] = tr._pending[k]._replace(stats=torch.tensor(stats))


def _keyframe_then(tr, stats):
    """The first queued frame asks for a keyframe (few close points
    tracked: NeedNewKeyFrame's close-depth rule), the second has `stats`
    (with a reference-match count that asks for none)."""
    tr.ref_kf_matches = 100
    _force(tr, 0, [200, 35, 0, 80])
    _force(tr, 1, stats)


def _relocalize_as_dispatched(tr, seen):
    """_relocalize replaced: note the tracker's restored pose and accept the
    frame at the pose it was dispatched with."""
    pend = {id(p.last.frame): p for p in tr._pending}

    def reloc(frame):
        seen.append(tr.last.T_cw.clone())
        p = pend[id(frame)]
        return True, p.last.T_cw, p.last.assoc, 60
    return reloc


def test_rollback_after_a_keyframe_of_the_same_flush_keeps_it(frames):
    tr = _tracker(frames)
    n_kf = tr.n_kf_host
    pend = _queue(tr, frames, (N_WARM, N_WARM + 1, N_WARM + 2))
    _keyframe_then(tr, [200, 5, 0, 0])    # then the next frame fails
    seen = []
    tr._relocalize = _relocalize_as_dispatched(tr, seen)
    tr.flush()
    ts_kf = N_WARM / 30.0
    assert tr.n_kf_host == n_kf + 1 and tr.kf_timestamps[-1] == ts_kf
    assert int(tr.arena.n_kf) == n_kf + 1 and bool(tr.arena.kf_valid[n_kf])
    assert abs(float(tr.arena.kf_time[n_kf]) - ts_kf) < 1e-6
    # the restored frame state is the failed frame's backup
    assert len(seen) == 1 and torch.equal(seen[0], pend[1].backup[1].T_cw)
    traj = dict(tr.camera_trajectory())
    assert ts_kf in traj and (N_WARM + 1) / 30.0 in traj
    assert (N_WARM + 2) / 30.0 not in traj          # dropped: recorded lost
    assert [r for r in tr.records if r[0] == (N_WARM + 2) / 30.0][0][3]
    # the keyframe's frame sits where its keyframe does (local BA moved both
    # by millimetres since)
    kf_T_wc = np.linalg.inv(tr.arena.kf_pose[n_kf].numpy())
    np.testing.assert_allclose(traj[ts_kf], kf_T_wc, atol=1e-2)


def test_loop_correction_in_a_flush_reanchors_the_live_pose(frames):
    tr = _tracker(frames, ShiftingCloser(TCFG, tiny_vocabulary(), KMAX, "cpu"))
    pend = _queue(tr, frames, (N_WARM, N_WARM + 1))
    _keyframe_then(tr, [200, 200, 200, 0])
    tr.flush()
    assert len(tr.loop_closer.loops) == 1
    torch.testing.assert_close(tr.last.T_cw, pend[1].last.T_cw @ G, atol=1e-6, rtol=0)
    assert tr._loop_delta is None


def test_loop_correction_then_a_failed_frame_reanchors_the_restored_state(frames):
    tr = _tracker(frames, ShiftingCloser(TCFG, tiny_vocabulary(), KMAX, "cpu"))
    pend = _queue(tr, frames, (N_WARM, N_WARM + 1, N_WARM + 2))
    # a keyframe whose loop correction moves the map, then a failure
    _keyframe_then(tr, [200, 5, 0, 0])
    seen = []
    tr._relocalize = _relocalize_as_dispatched(tr, seen)
    n_kf = tr.n_kf_host
    tr.flush()
    assert tr.n_kf_host == n_kf + 1 and len(tr.loop_closer.loops) == 1
    # the restored state (the frame before the failed one, in the map before
    # the correction) is re-anchored in the corrected map, as the live pose
    assert len(seen) == 1
    torch.testing.assert_close(seen[0], pend[1].backup[1].T_cw @ G, atol=1e-6, rtol=0)


def test_loop_correction_not_pipelined_continues_from_the_corrected_keyframe(frames):
    tr = _tracker(frames, ShiftingCloser(TCFG, tiny_vocabulary(), KMAX, "cpu"), pipeline=False)
    tr.ref_kf_matches = 10_000       # the next tracked frame becomes a keyframe
    tr.process(frames[N_WARM].gray, frames[N_WARM].depth, ONES, N_WARM / 30.0)
    k = tr.n_kf_host - 1
    assert tr.kf_timestamps[-1] == N_WARM / 30.0 and len(tr.loop_closer.loops) == 1
    torch.testing.assert_close(tr.last.T_cw, tr.arena.kf_pose[k], atol=0, rtol=0)
    assert tr.velocity is None
    assert torch.equal(tr.last.assoc, tr.arena.kf_obs[k])


def test_compaction_remaps_the_loop_closers_database_and_loops(frames):
    lc = tlc.LoopCloser(TCFG, tiny_vocabulary(), KMAX, "cpu")
    tr = _tracker(frames, None)
    tr.loop_closer = lc
    n_kf = tr.n_kf_host
    assert n_kf >= 3
    for k in range(n_kf):
        lc.add_keyframe(tr.arena, k)
    words_before = lc.db.words.clone()
    vecs_before = lc.db.vectors.clone()
    lc.loops = [(n_kf - 1, 0, torch.eye(4))]
    lc.last_loop_kf = n_kf - 1
    lc._consistent = {0: 2}
    # keyframe 1 culled by hand; compaction must recycle its slot
    tr.arena = tr.arena._replace(kf_valid=tr.arena.kf_valid.clone().index_fill_(
        0, torch.tensor([1]), False))
    tr.compact_min_gain = 1
    tr._compact_requested = True
    tr._maybe_compact()
    keep = [k for k in range(n_kf) if k != 1 and bool(vecs_before[k].any())]
    n_keep = tr.n_kf_host
    assert n_keep <= n_kf - 1
    valid_after = tr.arena.kf_valid[:n_keep]
    for new, old in enumerate([k for k in range(n_kf) if k != 1][:n_keep]):
        if bool(valid_after[new]):
            assert torch.equal(lc.db.words[new], words_before[old]), (new, old)
            assert torch.equal(lc.db.vectors[new], vecs_before[old])
    assert not bool(lc.db.valid[n_keep:].any()) and bool((lc.db.words[n_keep:] == -1).all())
    assert lc.loops[0][:2] == (n_keep - 1, 0) and lc.last_loop_kf == n_keep - 1
    assert lc._consistent == {} and keep
