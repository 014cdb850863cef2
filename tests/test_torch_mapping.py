"""Parity of the port's map growth and point upkeep
(gdslam_tpu_torch.backend.mapping) with the JAX package's.

`refresh_points` runs on seeded numpy arenas built to reach the one place
where the JAX function's result depends on the order of a scatter with
duplicate indices: its inverse map sends every unobserved keypoint to
point id 0, so an observation of point 0 survives only when no unobserved
keypoint follows it in its keyframe's row. `create_new_map_points`,
`fuse_into_keyframe` and `replace_points` run on the three-keyframe arena
of tests/test_torch_rig.py and on seeded id lists; their duplicate-index
scatters (the neighbour's keypoint 0, a point named twice, the dump slots)
are pinned against the JAX package on the CPU. The port reproduces all of
them.
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
from gdslam_tpu_torch.backend import map_arena as tma
from gdslam_tpu_torch.backend import mapping as tmapping
from test_torch_rig import SCFG, assert_arena_equal, build, jax_arena, np_tree
from test_torch_rig import TCFG as RIG_TCFG

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

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


# ----------------------------------------------------------------------------
# triangulation, fusion, replacement: the three-keyframe rig
# ----------------------------------------------------------------------------

# A triangulated point is the midpoint of two rays 2-6 degrees apart: the
# f32 rounding of the rays (3e-8, another summation order) is divided by the
# squared sine of the parallax, so new points agree to 1e-3 m, not 1e-5
# (observed 1.8e-4 m); every other float agrees to 1e-5.
TRIANGULATED = ("pt_pos", "pt_min_dist", "pt_max_dist")


def _assert_grown_arena_equal(got: dict, want: dict, n_pt0: int):
    assert_arena_equal({k: v for k, v in got.items() if k not in TRIANGULATED},
                       {k: v for k, v in want.items() if k not in TRIANGULATED})
    for k in TRIANGULATED:
        np.testing.assert_allclose(got[k][:n_pt0], want[k][:n_pt0], atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k][n_pt0:], want[k][n_pt0:], atol=1e-3, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def rig():
    arena, _, _ = build()
    return np_tree(arena)


@pytest.fixture(scope="module")
def grown(rig):
    """The rig after the JAX create_new_map_points on its last keyframe."""
    return np_tree(jmapping.create_new_map_points(jax_arena(rig), 2, SCFG))


def test_create_new_map_points_matches_jax(rig, grown):
    """Row for row on an arena of three keyframes: integers and booleans
    exactly (which keypoints pair up, which slots they get, both keyframes'
    observation rows, covisibility), floats as TRIANGULATED says."""
    got = convert.arena_to_numpy(tmapping.create_new_map_points(
        convert.arena_from_numpy(rig, "cpu"), 2, RIG_TCFG))
    n0 = int(rig["n_pt"])
    assert int(grown["n_pt"]) - n0 >= 10                       # it does triangulate
    assert (grown["kf_obs"][:2] >= n0).sum() == int(grown["n_pt"]) - n0
    _assert_grown_arena_equal(got, grown, n0)


def test_create_new_map_points_neighbour_keypoint_0(rig, grown):
    """The neighbour's observation row is written at the matched keypoint,
    which is keypoint 0 for every unmatched row, carrying the old value
    (gdslam_tpu/backend/mapping.py:216-217): a pair made on the neighbour's
    keypoint 0 is overwritten by any later unmatched row. With a matched
    keypoint of the neighbour moved to index 0, the point is still created
    but the neighbour does not observe it, in both packages."""
    n0 = int(rig["n_pt"])
    nb, j = np.argwhere(grown["kf_obs"][:2] >= n0)[0]
    a = {k: v.copy() for k, v in rig.items()}
    for k in ("kf_uv", "kf_ur", "kf_depth", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid",
              "kf_obs"):
        a[k][nb, [0, j]] = a[k][nb, [j, 0]]
    want = np_tree(jmapping.create_new_map_points(jax_arena(a), 2, SCFG))
    got = convert.arena_to_numpy(tmapping.create_new_map_points(
        convert.arena_from_numpy(a, "cpu"), 2, RIG_TCFG))
    _assert_grown_arena_equal(got, want, n0)
    assert int(got["n_pt"]) == int(grown["n_pt"])              # the same pairs
    assert got["kf_obs"][nb, 0] == -1                          # the observation is lost
    assert (got["kf_obs"][:2] >= n0).sum() == int(got["n_pt"]) - n0 - 1


def test_fuse_into_keyframe_matches_jax():
    """On the rig with its last keyframe inserted unassociated (so it made
    duplicates of the points it sees), and the duplicates' descriptors
    scrambled so that the older point is the better match: free keypoints
    gain observations, claimed ones trigger Replace; every arena row and the
    returned observation row equal the JAX package's (integers exactly,
    floats 1e-5)."""
    arena, _, _ = build(fuse_last=False)
    a = np_tree(arena)
    a = {k: v.copy() for k, v in a.items()}
    own = a["pt_ref_kf"] == 2
    a["pt_desc"][own] = np.random.default_rng(5).integers(0, 256, (own.sum(), 32))
    want, row_j = jmapping.fuse_into_keyframe(jax_arena(a), 2, SCFG)
    got, row_t = tmapping.fuse_into_keyframe(convert.arena_from_numpy(a, "cpu"), 2, RIG_TCFG)
    want = np_tree(want)
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    assert_arena_equal(convert.arena_to_numpy(got), want)
    assert (a["kf_obs"][2] < 0).sum() - (want["kf_obs"][2] < 0).sum() >= 5      # gains
    assert a["pt_valid"].sum() - want["pt_valid"].sum() >= 20                  # merges


@pytest.mark.parametrize("case", ["unique", "duplicate_src", "dump_slot"])
def test_replace_points_matches_jax(rig, case):
    """Seeded src/dst/do lists on the rig's arena. "duplicate_src": rows
    name one src with different dst, the later row's dst stands;
    "dump_slot": point P - 1 is a real src and rows outside `do`, which aim
    at P - 1 with its old values, follow it, so its redirect and validity are
    restored. Equal to the JAX package row for row."""
    r = np.random.default_rng(3)
    P, n0, M = rig["pt_pos"].shape[0], int(rig["n_pt"]), 64
    a = {k: v.copy() for k, v in rig.items()}
    src = r.choice(n0, M, replace=False).astype(np.int32)
    dst = r.integers(0, n0, M).astype(np.int32)
    do = r.random(M) < 0.5
    if case == "duplicate_src":
        src[10:20] = src[:10]
        do[:20] = True
    if case == "dump_slot":
        a["pt_valid"][P - 1], a["pt_n_obs"][P - 1] = True, 3
        a["kf_obs"][1, 5] = P - 1
        src[7], do[7], do[8:] = P - 1, True, r.random(M - 8) < 0.5
        do[-1] = False
    want = np_tree(jmapping.replace_points(jax_arena(a), jnp.asarray(src), jnp.asarray(dst),
                                           jnp.asarray(do)))
    got = convert.arena_to_numpy(tmapping.replace_points(
        convert.arena_from_numpy(a, "cpu"), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(do)))
    assert_arena_equal(got, want)
    assert a["pt_valid"].sum() - got["pt_valid"].sum() >= 10
    if case == "dump_slot":
        assert got["pt_valid"][P - 1] and got["kf_obs"][1, 5] == P - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_last_writer_equals_the_serial_scatter(seed):
    """`scatter_rows(dst, tgt, src, last_writer(tgt, mask, size))` is
    `dst.at[tgt].set(where(mask, src, dst[tgt]))` as XLA applies it on the
    CPU (duplicates in row order), on random targets with many duplicates."""
    r = np.random.default_rng(seed)
    size, rows = 16, 64
    dst = r.integers(100, 200, size).astype(np.int32)
    tgt = r.integers(0, size, rows).astype(np.int32)
    src = np.arange(rows, dtype=np.int32)
    mask = r.random(rows) < 0.5
    jd, jt = jnp.asarray(dst), jnp.asarray(tgt)
    want = np.asarray(jd.at[jt].set(jnp.where(jnp.asarray(mask), jnp.asarray(src), jd[jt])))
    td, tt, tm = torch.from_numpy(dst), torch.from_numpy(tgt), torch.from_numpy(mask)
    got = tma.scatter_rows(td, tt, torch.from_numpy(src), tma.last_writer(tt, tm, size))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != dst).any() and (want == dst).any()
