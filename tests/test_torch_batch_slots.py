"""The port's own batching (gdslam_tpu_torch.parallel.batch_eval) on
tests/test_multichip.py's 160x120 rig (256 features, 4 levels, kmax 16,
pmax 8192), as that file holds the JAX module's: B slots stacked are bitwise
their B = 1 runs, a blacked-out slot relocalizes while its neighbour stays
bitwise the clean run, GD slots stack too, mean_inliers is the JAX formula,
and a step reads the host once. No JAX here: the frames come from the
port's renderer; tests/test_torch_batch.py holds the step to the JAX one.
"""

import functools

import numpy as np
import pytest
import torch

from gdslam_tpu_torch import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.io import synthetic
from gdslam_tpu_torch.parallel import batch_eval as tbe
from gdslam_tpu_torch.system import tracking as ttr

torch.set_num_threads(1)

CAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, fps=30.0,
                   bf=6.4, th_depth=40.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=256, n_levels=4))
H, W = CAM.height, CAM.width
KMAX, PMAX = 16, 8192


@functools.lru_cache(maxsize=None)
def _render(idx: int, dynamic: bool):
    fr = synthetic.render_frame(idx, CAM, with_dynamic=dynamic, device="cpu")
    return fr.gray.numpy().astype(np.float32), fr.depth.numpy().astype(np.float32)


def _slot_frames(n_seq: int, n: int, stride: int, dynamic: bool = False, blackout_slot0=None):
    """[B, n, H, W] grays and depths, slot b from frame stride * b; slot 0
    black (zeros) at the blackout frames (inclusive)."""
    fr = [[_render(stride * b + t, dynamic) for t in range(n)] for b in range(n_seq)]
    g = np.stack([[f[0] for f in row] for row in fr])
    d = np.stack([[f[1] for f in row] for row in fr])
    if blackout_slot0 is not None:
        g[0, blackout_slot0[0]:blackout_slot0[1] + 1] = 0.0
        d[0, blackout_slot0[0]:blackout_slot0[1] + 1] = 0.0
    return g, d


def _run(grays, depths, use_gd=False):
    """The batched step over [B, T] frames from the empty state: the final
    states and, per step, (host mirrors, mean_inliers, the slots' stats)."""
    B, T = grays.shape[:2]
    step = tbe.batched_track_step(CFG, H, W, kmax=KMAX, pmax=PMAX, device="cpu")
    st = tbe.init_states(B, CFG, kmax=KMAX, pmax=PMAX, use_gd=use_gd, device="cpu")
    real, stats, trace = tbe.track_slots, [], []

    def record(*a, **k):
        out = real(*a, **k)
        stats.append(out[1])
        return out

    tbe.track_slots = record
    try:
        for t in range(T):
            st, mean = step(st, grays[:, t], depths[:, t])
            trace.append((st.host, mean, stats[-1]))
    finally:
        tbe.track_slots = real
    return st, trace


def _assert_slot_bitwise(stacked, b: int, solo, where: str):
    got = convert.seq_state_to_numpy(tbe.unstack(stacked)[b])
    want = convert.seq_state_to_numpy(tbe.unstack(solo)[0])

    def walk(a, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(a[k], w[k], f"{path}/{k}")
        elif w is not None:
            assert np.array_equal(a, w), f"{where}: {path} differs"

    walk(got, want, "")
    assert tbe.unstack(stacked)[b].host == tbe.unstack(solo)[0].host


@pytest.fixture(scope="module")
def static():
    """B = 4 slots (slot b from frame 3b), 6 frames, and each slot alone."""
    grays, depths = _slot_frames(4, 6, 3)
    return grays, depths, _run(grays, depths), [_run(grays[b:b + 1], depths[b:b + 1])
                                                 for b in range(4)]


def test_stacked_slots_are_bitwise_their_solo_runs(static):
    """Each of B = 4 slots is bitwise its own B = 1 run: every tensor of the
    state, the host mirror, the stats of every step; every slot
    initialized, tracking, with points."""
    _, _, (st, trace), solo = static
    for b, (s1, tr1) in enumerate(solo):
        _assert_slot_bitwise(st, b, s1, f"slot {b}")
        for (_, _, stats), (_, _, stats1) in zip(trace, tr1):
            assert torch.equal(stats[b], stats1[0])
    assert all(h.initialized and not h.lost for h in st.host)
    assert int(st.arena.n_pt.min()) > 50 and float(trace[-1][1]) > 20


def test_mean_inliers_is_the_jax_formula(static):
    """mean_inliers is the JAX step's psum over B: the slots' n_inl summed,
    over B, a float32 (the slots' n_inl from their own B = 1 runs)."""
    _, _, (_, trace), solo = static
    for t, (_, mean, _) in enumerate(trace):
        inl = [int(tr1[t][2][0, 1]) for _, tr1 in solo]
        assert mean.dtype == torch.float32 and mean.shape == ()
        assert float(mean) == float(np.float32(sum(inl)) / np.float32(4))


def test_blackout_slot_relocalizes_neighbours_bitwise():
    """tests/test_multichip.py's blackout on the port: slot 0 sees zeros at
    frames 3-4, is lost at frame 4, relocalizes by the end within 0.1 m of
    its clean run; its neighbour is bitwise the clean run."""
    clean_g, clean_d = _slot_frames(2, 8, 2)
    pert_g, pert_d = _slot_frames(2, 8, 2, blackout_slot0=(3, 4))
    clean, _ = _run(clean_g, clean_d)
    pert, trace = _run(pert_g, pert_d)
    lost = [h[0].lost for h, _, _ in trace]
    assert lost[4] and not lost[-1], lost
    T_reloc, T_clean = pert.last_T_cw[0].numpy(), clean.last_T_cw[0].numpy()
    assert np.linalg.norm(T_reloc[:3, 3] - T_clean[:3, 3]) < 0.1
    _assert_slot_bitwise(pert, 1, tbe.stack([tbe.unstack(clean)[1]]), "slot 1")


def test_gd_stacked_slots_are_bitwise_their_solo_runs():
    """Two GD slots on the dynamic scene, 7 frames (2 past warm-up): the
    ring full in both, nothing lost, each slot bitwise its B = 1 run."""
    grays, depths = _slot_frames(2, 7, 2, dynamic=True)
    st, _ = _run(grays, depths, use_gd=True)
    assert [h.gd_count for h in st.host] == [7, 7]
    assert all(h.initialized and not h.lost for h in st.host)
    for b in range(2):
        _assert_slot_bitwise(st, b, _run(grays[b:b + 1], depths[b:b + 1], use_gd=True)[0],
                             f"GD slot {b}")


def test_one_copy_per_batched_step(monkeypatch, static):
    """The predicates of all slots come to the host in one copy per step
    (two when a slot takes the wide retry): count the reads of B = 4 slots
    over 4 frames, and force the retry in one slot."""
    grays, depths, _, _ = static
    reads = []
    real = ttr._read
    monkeypatch.setattr(ttr, "_read", lambda *t: reads.append(len(t)) or real(*t))
    step = tbe.batched_track_step(CFG, H, W, kmax=KMAX, pmax=PMAX, device="cpu")
    st = tbe.init_states(4, CFG, kmax=KMAX, pmax=PMAX, device="cpu")
    per_step = []
    for t in range(4):
        n0 = len(reads)
        st, _ = step(st, grays[:, t], depths[:, t])
        per_step.append(reads[n0:])
    # frame 0: four init gates; then four slots' 4 stats + reference matches
    assert per_step == [[4]] + [[8]] * 3
    # slot 2's last pose 1 m off and its velocity dropped: its narrow search
    # finds nothing, and only it is dispatched again
    slots = tbe.unstack(st)
    T = slots[2].last_T_cw.clone()
    T[0, 3] += 1.0
    slots[2] = slots[2]._replace(last_T_cw=T, has_velocity=torch.tensor(False),
                                 host=slots[2].host._replace(has_velocity=False))
    n0 = len(reads)
    step(tbe.stack(slots), grays[:, 4], depths[:, 4])
    assert reads[n0:] == [8, 1]
