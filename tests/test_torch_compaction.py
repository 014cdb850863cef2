"""Parity of the port's keyframe culling and arena compaction
(gdslam_tpu_torch.backend.{gba,map_arena}) with the JAX package's, exactly,
on the rig of tests/test_torch_rig.py widened to twelve keyframes, and of the
host side of Tracking._maybe_compact on the same arena."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import gba as jgba
from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.system import tracking as jtr
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import gba as tgba
from gdslam_tpu_torch.backend import map_arena as tma
from gdslam_tpu_torch.system import tracking as ttr
from test_torch_rig import KMAX, PMAX, SCFG, TCFG, assert_arena_equal, build, jax_arena, np_tree

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)


N_KF = 12


@pytest.fixture(scope="module")
def arena():
    """Twelve keyframes: the rig's three, each four times, so that every
    point has >= 4 observations and the copies are redundant; keyframes 4
    and 7 (copies of keyframe 1) get fresh points of their own for half of
    their keypoints, so they stay, and so do keyframes 1 and 10, whose
    points are then seen only twice."""
    a, _, _ = build()
    a = {k: v.copy() for k, v in np_tree(a).items()}
    for slot in range(3, N_KF):
        for k in ("kf_pose", "kf_valid", "kf_uv", "kf_ur", "kf_depth", "kf_level",
                  "kf_angle", "kf_desc", "kf_kp_valid", "kf_obs"):
            a[k][slot] = a[k][slot % 3]
        a["kf_time"][slot] = slot
        a["kf_parent"][slot] = slot - 1
    n = int(a["n_pt"])
    for slot in (4, 7):
        own = np.flatnonzero(a["kf_obs"][slot] >= 0)[::2]
        a["kf_obs"][slot, own] = n + np.arange(len(own))
        a["pt_valid"][n:n + len(own)] = True
        a["pt_ref_kf"][n:n + len(own)] = slot
        n += len(own)
    a["n_kf"], a["n_pt"] = np.int32(N_KF), np.int32(n)
    a["pt_n_obs"][:n] = np.bincount(a["kf_obs"][a["kf_obs"] >= 0], minlength=n)[:n]
    r = np.random.default_rng(0)
    cov = np.triu(r.integers(0, 60, (N_KF, N_KF)).astype(np.int32), 1)
    a["covis"][:N_KF, :N_KF] = cov + cov.T
    a["covis"][2, 5] = a["covis"][2, 6] = a["covis"][5, 2] = a["covis"][6, 2] = 33   # a tie
    return a


@pytest.mark.parametrize("protect_last", [2, 0])
def test_keyframe_culling_matches_jax(arena, protect_last):
    want = np_tree(jgba.keyframe_culling(jax_arena(arena), protect_last))
    got = convert.arena_to_numpy(tgba.keyframe_culling(
        convert.arena_from_numpy(arena, "cpu"), protect_last))
    assert_arena_equal(got, want, atol=0)
    kept = set(np.flatnonzero(got["kf_valid"]))
    assert kept == ({0, 1, 4, 7, 10, 11} if protect_last == 2 else {0, 1, 4, 7, 10})


@pytest.mark.parametrize("kf_id,cap", [(2, 80), (2, 16), (0, 4), (8, 12)])
def test_local_keyframes_matches_jax(arena, kf_id, cap):
    """Ids and validity exactly, equal weights in ascending id order; cap
    above kmax pads."""
    ids_j, ok_j = jma.local_keyframes(jax_arena(arena), kf_id, cap)
    ids_t, ok_t = tma.local_keyframes(convert.arena_from_numpy(arena, "cpu"), kf_id, cap)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ids_t.dtype == torch.int32 and ids_t.shape == (cap,)
    assert int(ids_t[0]) == kf_id and bool(ok_t[0])


def _compaction_plan(valid: np.ndarray, n_kf: int, K: int):
    """perm / new_of_old as Tracking._maybe_compact builds them."""
    keep = np.nonzero(valid[:n_kf])[0]
    perm = np.concatenate([keep, np.setdiff1d(np.arange(K), keep)]).astype(np.int32)
    new_of_old = np.zeros(K, np.int32)
    new_of_old[perm] = np.arange(K, dtype=np.int32)
    last_kept = 0
    for old in range(n_kf):
        if valid[old]:
            last_kept = new_of_old[old]
        else:
            new_of_old[old] = last_kept
    return keep, perm, new_of_old


def test_compact_keyframes_matches_jax(arena):
    culled = np_tree(jgba.keyframe_culling(jax_arena(arena), 2))
    keep, perm, new_of_old = _compaction_plan(culled["kf_valid"], N_KF, KMAX)
    want = np_tree(jma.compact_keyframes(jax_arena(culled), jnp.asarray(perm),
                                         jnp.asarray(new_of_old),
                                         jnp.asarray(len(keep), jnp.int32)))
    got = convert.arena_to_numpy(tma.compact_keyframes(
        convert.arena_from_numpy(culled, "cpu"), torch.from_numpy(perm),
        torch.from_numpy(new_of_old), len(keep)))
    assert_arena_equal(got, want, atol=0)
    assert int(got["n_kf"]) == len(keep) == 6 and got["kf_valid"][:len(keep)].all()
    assert not got["kf_valid"][len(keep):].any() and (got["kf_obs"][len(keep):] == -1).all()


def _saturated_trackers(arena: dict, kmax: int):
    """Both packages' Tracking on the twelve-keyframe arena cut to `kmax`
    keyframe slots, with host state that refers to keyframe slots."""
    a = {k: (v[:kmax] if k.startswith("kf_") else v) for k, v in arena.items()}
    a["covis"] = arena["covis"][:kmax, :kmax]
    out = []
    for mod, cfg, load, kw in (
            (jtr, SCFG, jax_arena, {}),
            (ttr, TCFG, lambda d: convert.arena_from_numpy(d, "cpu"), dict(device="cpu"))):
        tr = mod.Tracking(cfg, kmax=kmax, pmax=PMAX, **kw)
        tr.arena = load(a)
        tr.kf_timestamps = [float(i) for i in range(N_KF)]
        eye = jnp.eye(4) if mod is jtr else torch.eye(4)
        tr.records = [(float(i), i % N_KF, eye, False) for i in range(20)]
        tr.ref_kf = N_KF - 1
        tr.state = mod.TrackState.OK
        out.append(tr)
    return out


def test_maybe_compact_matches_jax(arena):
    """A saturated arena (kmax = 13, twelve keyframes): _need_keyframe_stats
    refuses the keyframe and compacts; the arena, the timestamps, the
    trajectory records' keyframe references and ref_kf are remapped as in the
    JAX package."""
    tr_j, tr_t = _saturated_trackers(arena, N_KF + 1)
    for tr in (tr_j, tr_t):
        tr.compact_min_gain = 2
        assert tr._need_keyframe_stats(200, 50, 100) is False
    assert_arena_equal(convert.arena_to_numpy(tr_t.arena), np_tree(tr_j.arena), atol=0)
    assert tr_t.n_kf_host == tr_j.n_kf_host == 6
    assert tr_t.kf_timestamps == tr_j.kf_timestamps
    assert [r[1] for r in tr_t.records] == [r[1] for r in tr_j.records]
    assert tr_t.ref_kf == tr_j.ref_kf == tr_t.n_kf_host - 1
    assert tr_t._need_keyframe_stats(20, 50, 100) is True      # headroom again


def test_maybe_compact_warns_when_culling_frees_too_little(arena):
    """With the default compact_min_gain (8 slots) the six culled
    keyframes are too few: both packages warn once, leave the arena as culled and
    create no keyframe."""
    tr_j, tr_t = _saturated_trackers(arena, N_KF + 1)
    for tr, name in ((tr_j, "gdslam_tpu"), (tr_t, "gdslam_tpu_torch")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert tr._need_keyframe_stats(200, 50, 100) is False
            assert tr._need_keyframe_stats(200, 50, 100) is False
        msgs = [str(w.message) for w in caught if "keyframe arena is full" in str(w.message)]
        assert len(msgs) == 1 and msgs[0].startswith(name + ":")
        assert tr.kf_arena_full_warned and tr.n_kf_host == N_KF
    assert_arena_equal(convert.arena_to_numpy(tr_t.arena), np_tree(tr_j.arena), atol=0)
