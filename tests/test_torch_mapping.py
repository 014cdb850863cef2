"""Parity of the port's point upkeep (gdslam_tpu_torch.backend.mapping)
with the JAX package's, on a seeded numpy arena.

The arenas are built to reach the one place where the JAX function's
result depends on the order of a scatter with duplicate indices: its
inverse map sends every unobserved keypoint to point id 0, so an
observation of point 0 survives only when no unobserved keypoint follows
it in its keyframe's row. The port reproduces that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.backend import mapping as jmapping
from gdslam_tpu.config import OrbConfig, SlamConfig
from gdslam_tpu_torch import OrbConfig as TOrbConfig
from gdslam_tpu_torch import SlamConfig as TSlamConfig
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import mapping as tmapping

K, P, N, N_KF = 8, 64, 16, 6
JCFG = SlamConfig(orb=OrbConfig(n_features=N, n_levels=4))
TCFG = TSlamConfig(orb=TOrbConfig(n_features=N, n_levels=4))


def _arena(case: str, seed: int = 0) -> dict:
    """Six keyframes of 16 keypoints over points 0..23. Point 0 sits at
    keypoint 3 of every keyframe. "followed": keypoint 10 is unobserved
    in every keyframe, so the JAX inverse map loses point 0 everywhere;
    "not_followed": only keypoints before 3 are unobserved; "mixed":
    followed in odd keyframes only; "duplicate_ids": as "mixed", and point
    7 is observed by two keypoints of each keyframe."""
    r = np.random.default_rng(seed)
    a = {k: np.array(v) for k, v in jma.new_arena(K, P, N)._asdict().items()}
    n_pts = 24
    a["pt_pos"][:n_pts] = r.uniform(-1, 1, (n_pts, 3)) + np.array([0, 0, 3.0])
    a["pt_valid"][:n_pts] = True
    a["pt_desc"][:n_pts] = r.integers(0, 256, (n_pts, 32))
    a["pt_ref_kf"][:n_pts] = r.integers(-1, N_KF, n_pts)
    a["pt_ref_kf"][0] = 0
    a["n_pt"], a["n_kf"] = np.int32(n_pts), np.int32(N_KF)
    for kf in range(N_KF):
        a["kf_valid"][kf] = True
        a["kf_pose"][kf, :3, 3] = r.uniform(-0.3, 0.3, 3)
        a["kf_desc"][kf] = r.integers(0, 256, (N, 32))
        a["kf_level"][kf] = r.integers(0, 4, N)
        a["kf_kp_valid"][kf] = True
        pool = np.setdiff1d(np.arange(1, n_pts), [7] if case == "duplicate_ids" else [])
        obs = r.permutation(pool)[:N].astype(np.int32)
        obs[3] = 0
        obs[:2] = -1                               # unobserved, before point 0's keypoint
        followed = case == "followed" or (case in ("mixed", "duplicate_ids") and kf % 2 == 1)
        if followed:
            obs[10] = -1
        if case == "duplicate_ids":
            obs[5], obs[12] = 7, 7
        a["kf_obs"][kf] = obs
    return a


@pytest.mark.parametrize("kf_id,window", [(5, 8), (5, 3), (2, 8)])
@pytest.mark.parametrize("case", ["followed", "not_followed", "mixed", "duplicate_ids"])
def test_refresh_points_matches_jax(case, kf_id, window):
    """Every arena field equal to gdslam_tpu.backend.mapping.refresh_points:
    descriptors and integers exactly; normals and depth ranges to 1e-6 (unit
    rays summed and normalised in another order)."""
    a = _arena(case)
    want = jmapping.refresh_points(
        jma.MapArena(**{k: jnp.asarray(v) for k, v in a.items()}), kf_id, JCFG, window)
    got = convert.arena_to_numpy(tmapping.refresh_points(
        convert.arena_from_numpy(a, "cpu"), kf_id, TCFG, window))
    for k, w in want._asdict().items():
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the arenas do reach the order-dependent column: point 0 is refreshed
    # only where an observation of it survives in two keyframes
    refreshed0 = np.linalg.norm(got["pt_normal"][0]) > 0.5
    assert refreshed0 == (case != "followed")
    assert (np.linalg.norm(got["pt_normal"][:24], axis=1) > 0.5).sum() >= 5   # a real refresh


def test_refresh_points_inverse_map_column_0():
    """The rule itself on one keyframe row: the keypoint of point 0 is kept
    when nothing unobserved follows it, and lost when something does."""
    a = _arena("not_followed")
    kept = tmapping.refresh_points(convert.arena_from_numpy(a, "cpu"), 5, TCFG)
    a["kf_obs"][:, 15] = -1
    lost = tmapping.refresh_points(convert.arena_from_numpy(a, "cpu"), 5, TCFG)
    assert torch.linalg.norm(kept.pt_normal[0]) > 0.5
    assert torch.linalg.norm(lost.pt_normal[0]) == 0.0
    assert torch.equal(lost.pt_desc[0], torch.from_numpy(a["pt_desc"][0]))
