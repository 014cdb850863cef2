"""Parity of the port's batched multi-sequence tracker
(gdslam_tpu_torch.parallel.batch_eval) with the JAX package's
(gdslam_tpu.parallel.batch_eval), on tests/test_multichip.py's 160x120 rig
(256 features, 4 levels, kmax 16), with the JAX module's pmax of 8192.

At pmax 4096 (test_multichip.py's) the local-map candidate budget (4096)
equals the arena, and XLA's CPU approx_max_k then returns equal scores in an
order of its own instead of lower index first (a full sort; with k < n it is
the stable order the port's top_k_stable gives): a keypoint between two
tied map points then takes the other one at keyframe fusion. With pmax 8192
every step below is exact.

JAX side: one jitted device_track_step, compiled once for the plain state
and once for the GD one (no shard_map, no mesh). The port gets the JAX
state of every frame through convert.seq_state_from_numpy, so each branch
(init, track, keyframe with local BA, loss, relocalization, the GD masker)
is held on equal inputs; then free runs from the empty state. The port's
own batching (B slots stacked bitwise their B = 1 runs, the blackout, the
reads a step) is in tests/test_torch_batch_slots.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.io import synthetic
from gdslam_tpu.parallel import batch_eval as jbe
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.parallel import batch_eval as tbe
from test_torch_rig import assert_arena_equal

torch.set_num_threads(1)

CAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, fps=30.0,
                   bf=6.4, th_depth=40.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=256, n_levels=4))
TCFG = convert.config_from_jax_dict(dataclasses.asdict(CFG))
H, W = CAM.height, CAM.width
KMAX, PMAX = 16, 8192
RUNS = dict(plain=(6, 0, False, None), blackout=(8, 0, False, (3, 4)), gd=(9, 0, True, None))
ONES = torch.ones(H, W)


def _np(t):
    """A JAX NamedTuple state as nested dicts of numpy arrays."""
    if t is None:
        return None
    if hasattr(t, "_fields"):
        return {f: _np(getattr(t, f)) for f in t._fields}
    return np.asarray(t)


@functools.lru_cache(maxsize=None)
def _render(idx: int, dynamic: bool):
    fr = synthetic.render_frame(idx, CAM, with_dynamic=dynamic)
    return np.asarray(fr.gray, np.float32), np.asarray(fr.depth, np.float32)


def _frames(n: int, offset: int, dynamic: bool, blackout=None):
    """[n, H, W] float32 grays and depths of the JAX renderer from frame
    `offset`, zeros at the blackout frames (inclusive)."""
    fr = [_render(offset + t, dynamic) for t in range(n)]
    g = np.stack([f[0] for f in fr])
    d = np.stack([f[1] for f in fr])
    if blackout is not None:
        g[blackout[0]:blackout[1] + 1] = 0.0
        d[blackout[0]:blackout[1] + 1] = 0.0
    return g, d


@pytest.fixture(scope="module")
def jax_runs():
    """{run: (grays, depths, [state_0 .. state_n] as numpy, [stats_t])}."""
    ones = jnp.ones((H, W))
    step = jax.jit(lambda s, g, d: jbe.device_track_step(s, g, d, ones, CFG))
    out = {}
    for name, (n, offset, dynamic, blackout) in RUNS.items():
        g, d = _frames(n, offset, dynamic, blackout)
        st = jbe.init_seq_state(CFG, kmax=KMAX, pmax=PMAX, use_gd=dynamic)
        states, stats = [_np(st)], []
        for t in range(n):
            st, s = step(st, jnp.asarray(g[t]), jnp.asarray(d[t]))
            states.append(_np(st))
            stats.append(np.asarray(s))
        out[name] = (g, d, states, stats)
    return out


def _port_step(state, g, d):
    return tbe.device_track_step(state, torch.from_numpy(g), torch.from_numpy(d), ONES, TCFG)


def _assert_state_matches(got: dict, want: dict, where: str):
    for k in ("initialized", "lost", "has_velocity", "ref_kf", "ref_kf_matches",
              "frames_since_kf", "frame_idx", "last_assoc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}: {k}")
    for k in ("last_T_cw", "velocity"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=f"{where}: {k}")
    assert_arena_equal(got["arena"], want["arena"], atol=1e-3)
    # the IC angle is a float sum in another order (test_torch_frontend: 1e-4)
    assert_arena_equal(got["last_frame"], want["last_frame"], atol=1e-4)
    if want["gd"] is not None:
        for k in ("gray", "depth", "count"):
            np.testing.assert_array_equal(got["gd"][k], want["gd"][k], err_msg=f"{where}: {k}")
        assert_arena_equal(got["gd"]["feats"], want["gd"]["feats"], atol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_step_matches_jax_frame_by_frame(jax_runs, run):
    """Every frame from the JAX state before it: the stats, flags, counters,
    associations exactly, poses to 1e-4, the arena to 1e-3 (BA-adjusted
    points), the GD ring's images exactly."""
    g, d, states, stats = jax_runs[run]
    kinds = set()
    for t in range(len(stats)):
        state = convert.seq_state_from_numpy(states[t], "cpu")
        h = state.host
        kinds.add("init" if not h.initialized else "reloc" if h.lost else "track")
        new, got_stats = _port_step(state, g[t], d[t])
        np.testing.assert_array_equal(got_stats.numpy(), stats[t], err_msg=f"{run} frame {t}")
        _assert_state_matches(convert.seq_state_to_numpy(new), states[t + 1], f"{run} frame {t}")
        assert new.host == tbe.read_host(new)
    want_kinds = {"init", "track", "reloc"} if run == "blackout" else {"init", "track"}
    assert kinds == want_kinds
    if run == "blackout":
        lost = [bool(s["lost"]) for s in states]
        assert lost[4] and lost[5] and not lost[-1]          # lost in the blackout, recovered
    if run == "gd":
        assert int(states[-1]["gd"]["count"]) == 9          # four frames past warm-up


@pytest.mark.parametrize("run", ["plain", "gd"])
def test_free_run_matches_jax(jax_runs, run):
    """The port's own B = 1 run from the empty state: at the end n_kf and
    n_pt exactly and the pose within 5e-3 (tests/test_multichip.py's)."""
    g, d, states, _ = jax_runs[run]
    step = tbe.batched_track_step(TCFG, H, W, kmax=KMAX, pmax=PMAX, device="cpu")
    st = tbe.init_states(1, TCFG, kmax=KMAX, pmax=PMAX, use_gd=run == "gd", device="cpu")
    for t in range(len(g)):
        st, _ = step(st, g[t][None], d[t][None])
    want = states[-1]
    assert int(st.arena.n_kf[0]) == int(want["arena"]["n_kf"])
    assert int(st.arena.n_pt[0]) == int(want["arena"]["n_pt"])
    np.testing.assert_allclose(st.last_T_cw[0].numpy(), want["last_T_cw"], atol=5e-3, rtol=0)


def test_init_states_match_jax_fields():
    """init_states has the JAX init_states' fields, shapes and dtypes, with
    and without the GD ring, and its host mirror is what its tensors say."""
    for use_gd in (False, True):
        want = _np(jbe.init_states(3, CFG, kmax=KMAX, pmax=PMAX, use_gd=use_gd))
        got = convert.seq_state_to_numpy(
            tbe.init_states(3, TCFG, kmax=KMAX, pmax=PMAX, use_gd=use_gd, device="cpu"))

        def walk(a, b, path):
            if isinstance(b, dict):
                assert set(a) == set(b), path
                for k in b:
                    walk(a[k], b[k], f"{path}/{k}")
            elif b is None:
                assert a is None, path
            else:
                assert (a.shape, a.dtype) == (b.shape, b.dtype), path
                np.testing.assert_array_equal(a, b, err_msg=path)

        walk(got, want, "states")
    st = tbe.init_states(3, TCFG, kmax=KMAX, pmax=PMAX, use_gd=True, device="cpu")
    assert st.host == tbe.read_host(st) == (tbe.HostMirror(False, False, False, 0, 0, 0, 0, 0),) * 3


def test_seq_state_round_trip(jax_runs):
    """A JAX state (stacked or one slot, with its ring) through the port and
    back is unchanged, and the host mirror is read from the arrays."""
    want = jax_runs["gd"][2][4]
    st = convert.seq_state_from_numpy(want, "cpu")
    assert st.host == tbe.read_host(st)
    assert st.host.gd_count == 4 and st.host.initialized and st.host.n_kf >= 1

    def walk(a, b):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    walk(convert.seq_state_to_numpy(st), want)
    stacked = {k: v for k, v in want.items()}
    stacked = jax.tree.map(lambda x: np.stack([x, x]), stacked)
    st2 = convert.seq_state_from_numpy(stacked, "cpu")
    assert st2.host == (st.host, st.host)
