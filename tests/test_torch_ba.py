"""Parity of the port's local bundle adjustment (gdslam_tpu_torch.backend.ba)
with the JAX package's, on the three-keyframe rig of tests/test_torch_rig.py
after triangulation and fusion. `build_problem` is compared exactly;
`run_local_ba` takes the JAX problem through convert.py, so the LM iterations
start from identical edges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import ba as jba
from gdslam_tpu.backend import mapping as jmapping
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import ba as tba
from test_torch_rig import SCFG, TCFG, assert_arena_equal, build, jax_arena, np_tree

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def arena():
    """The rig after the JAX triangulation and fusion, as numpy."""
    a, _, _ = build()
    a = jmapping.create_new_map_points(a, 2, SCFG)
    a, _ = jmapping.fuse_into_keyframe(a, 2, SCFG)
    return np_tree(a)


def _sixteen_local(a: dict) -> dict:
    """The rig's keyframes 1 and 2 copied into slots 3..15 and made covisible
    with keyframe 2, so that all 16 rows of local_keyframes are valid."""
    a = {k: v.copy() for k, v in a.items()}
    for slot in range(3, 16):
        for k in ("kf_pose", "kf_valid", "kf_uv", "kf_ur", "kf_depth", "kf_level", "kf_angle",
                  "kf_desc", "kf_kp_valid", "kf_obs"):
            a[k][slot] = a[k][1 + slot % 2]
        a["covis"][2, slot] = a["covis"][slot, 2] = 20 + slot
    a["n_kf"] = np.int32(16)
    return a


def _problems(a: dict, kf_id: int):
    want = np_tree(jba.build_problem(jax_arena(a), jnp.asarray(kf_id), SCFG))
    got = convert.ba_problem_to_numpy(tba.build_problem(
        convert.arena_from_numpy(a, "cpu"), kf_id, TCFG))
    return got, want


@pytest.mark.parametrize("all_local", [False, True])
def test_build_problem_matches_jax(arena, all_local):
    """Every field of the problem exactly, dtypes included. With fewer than
    16 local keyframes the padded rows of gdslam_tpu/backend/ba.py:53-54
    write False to keyframe 0 after it was set, so keyframe 0 is not "local":
    its own points stay out of the problem and it comes a second time among
    the fixed keyframes. With all 16 local it is local like the others."""
    a = _sixteen_local(arena) if all_local else arena
    got, want = _problems(a, 2)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k
    assert got["pt_mask"].sum() > 100
    zero_rows = np.flatnonzero((got["kf_ids"] == 0) & got["kf_mask"])
    only_kf0 = np.setdiff1d(a["kf_obs"][0][a["kf_obs"][0] >= 0],
                            a["kf_obs"][1:16][a["kf_obs"][1:16] >= 0])
    only_kf0 = only_kf0[a["pt_valid"][only_kf0]]
    assert len(only_kf0) > 10
    if all_local:
        assert got["kf_mask"][:16].all() and list(zero_rows) == [int(zero_rows[0])] \
            and zero_rows[0] < 16
        assert np.isin(only_kf0, got["pt_ids"]).all()
    else:
        assert len(zero_rows) == 2 and zero_rows[0] < 16 <= zero_rows[1]
        assert not np.isin(only_kf0, got["pt_ids"]).any()


def test_build_problem_masks_duplicate_observations(arena):
    """A keyframe that observes one point through two keypoints (a Replace
    leaves such rows) keeps the first: obs_slot and inv_idx equal the JAX
    package's, whose stable argsort the port matches with a stable sort."""
    a = {k: v.copy() for k, v in arena.items()}
    obs = a["kf_obs"][1]
    seen = np.flatnonzero(obs >= 0)
    a["kf_obs"][1, seen[40]] = obs[seen[3]]
    a["kf_obs"][1, seen[41]] = obs[seen[3]]
    got, want = _problems(a, 2)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    row = int(np.flatnonzero(got["kf_ids"] == 1)[0])
    assert got["obs_slot"][row, seen[3]] >= 0
    assert got["obs_slot"][row, seen[40]] == -1 and got["obs_slot"][row, seen[41]] == -1


@pytest.fixture(scope="module")
def jax_problem(arena):
    return jba.build_problem(jax_arena(arena), jnp.asarray(2), SCFG)


@pytest.mark.parametrize("case", ["clean", "perturbed"])
def test_run_local_ba_matches_jax(arena, jax_problem, case):
    """5 + 5 LM iterations from the same problem: keyframe poses to 1e-4
    (observed 1e-5), the same outlier observations erased (kf_obs and
    pt_n_obs exactly), points to 1e-3 m. The points' tolerance is set by the
    map, not by the port: the rig's depthless keypoints leave some points
    with mono observations a few degrees apart, whose depth the normal
    equations barely hold, so f32 rounding (the sums run in another order in
    the two packages) moves them: against a float64 run of the same
    iterations the JAX result is off by up to 8e-5 m and the port's by up to
    3.5e-4 m, and 99.98% of the coordinates agree to 1e-4. "perturbed"
    moves the two free keyframes by up to 3 cm and 1.5 degrees and the
    points by 2 cm, so the first steps are large and LM has steps to
    reject, and shifts every 12th observation of keyframe 1 by 12 px, which
    BA must classify as outliers and erase."""
    a = {k: v.copy() for k, v in arena.items()}
    if case == "perturbed":
        from gdslam_tpu.core import lie as jlie
        r = np.random.default_rng(11)
        for kf in (1, 2):
            xi = np.concatenate([r.uniform(-0.03, 0.03, 3), r.uniform(-0.025, 0.025, 3)])
            a["kf_pose"][kf] = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32))) @ a["kf_pose"][kf]
        n = int(a["n_pt"])
        a["pt_pos"][:n] += r.normal(0, 0.02, (n, 3)).astype(np.float32)
        wrong = np.flatnonzero(a["kf_obs"][1] >= 0)[::12]              # gross mismatches
        a["kf_uv"][1, wrong] += 12.0
    want, n_out_j = jba.run_local_ba(jax_arena(a), jax_problem, SCFG, 5, 5)
    prob_t = convert.ba_problem_from_numpy(np_tree(jax_problem), "cpu")
    got, n_out_t = tba.run_local_ba(convert.arena_from_numpy(a, "cpu"), prob_t, TCFG, 5, 5)
    want, got = np_tree(want), convert.arena_to_numpy(got)
    assert int(n_out_t) == int(n_out_j)
    pts_j, pts_t = want.pop("pt_pos"), got.pop("pt_pos")
    assert_arena_equal(got, want, atol=1e-4)
    np.testing.assert_allclose(pts_t, pts_j, atol=1e-3, rtol=0)
    assert (np.abs(pts_t - pts_j) <= 1e-4).mean() > 0.999
    # BA did move the map, and on the perturbed arena it pulled it back
    assert np.abs(got["kf_pose"][2] - a["kf_pose"][2]).max() > 1e-5
    if case == "perturbed":
        assert int(n_out_t) >= 5
        assert (got["kf_obs"][1] >= 0).sum() < (a["kf_obs"][1] >= 0).sum()
        assert np.abs(got["kf_pose"][2] - arena["kf_pose"][2]).max() < \
            0.5 * np.abs(a["kf_pose"][2] - arena["kf_pose"][2]).max()


def test_run_local_ba_write_back_dump_slots(arena, jax_problem):
    """The write-back's padded rows aim at keyframe kmax - 1 and at point 0
    with their old values (gdslam_tpu/backend/ba.py:301-311): point 0, if it
    is a local point, keeps its old position because a padded row follows
    it. The port's point 0 equals the JAX package's either way."""
    a = {k: v.copy() for k, v in arena.items()}
    a["pt_valid"][0] = True
    a["pt_pos"][0] = a["pt_pos"][a["kf_obs"][2][a["kf_obs"][2] >= 0][0]] + 0.01
    a["kf_obs"][2, np.flatnonzero(a["kf_obs"][2] < 0)[0]] = 0
    a["kf_obs"][1, np.flatnonzero(a["kf_obs"][1] < 0)[0]] = 0
    prob_j = jba.build_problem(jax_arena(a), jnp.asarray(2), SCFG)
    assert int(prob_j.pt_ids[0]) == 0 and not bool(prob_j.pt_mask[-1])
    want, _ = jba.run_local_ba(jax_arena(a), prob_j, SCFG, 5, 5)
    got, _ = tba.run_local_ba(convert.arena_from_numpy(a, "cpu"),
                              convert.ba_problem_from_numpy(np_tree(prob_j), "cpu"), TCFG, 5, 5)
    np.testing.assert_array_equal(got.pt_pos[0].numpy(), a["pt_pos"][0])
    assert_arena_equal(convert.arena_to_numpy(got), np_tree(want), atol=1e-3)
