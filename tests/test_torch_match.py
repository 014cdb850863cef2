"""Parity of the port's matcher (gdslam_tpu_torch.ops.match_kernel and
frontend.matcher) with the JAX package's Pallas kernel and dense matcher.

Costs are integers, so every comparison is exact. On the CPU the wrapper
runs the plain PyTorch version; the CUDA kernel is held against it on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.frontend import matcher as jmatcher
from gdslam_tpu.ops import orb as jorb
from gdslam_tpu.ops import pallas_match
from gdslam_tpu_torch.frontend import matcher as tmatcher
from gdslam_tpu_torch.ops import match_kernel


def _inputs(seed, M, N, extent=160.0, n_levels=8, dup_rows=0):
    r = np.random.default_rng(seed)
    d = dict(
        cand_uv=r.uniform(0, extent, (M, 2)).astype(np.float32),
        cand_desc=r.integers(0, 256, (M, 32)).astype(np.uint8),
        cand_level=r.integers(0, n_levels, M).astype(np.int32),
        cand_valid=r.uniform(size=M) > 0.1,
        cand_angle=r.uniform(-np.pi, np.pi, M).astype(np.float32),
        kp_uv=r.uniform(0, extent, (N, 2)).astype(np.float32),
        kp_desc=r.integers(0, 256, (N, 32)).astype(np.uint8),
        kp_level=r.integers(0, n_levels, N).astype(np.int32),
        kp_valid=r.uniform(size=N) > 0.1,
        kp_angle=r.uniform(-np.pi, np.pi, N).astype(np.float32),
    )
    # radii as the path uses them: 15 px * 1.2^level
    d["cand_radius"] = (15.0 * 1.2 ** d["cand_level"]).astype(np.float32)
    # keypoints near candidates with a few flipped bits, so real matches exist
    src = r.integers(0, M, N)
    near = r.uniform(size=N) < 0.6
    d["kp_uv"][near] = d["cand_uv"][src[near]] + r.normal(0, 3, (near.sum(), 2))
    flip = r.integers(0, 256, (N, 32)) < 8
    noisy = d["cand_desc"][src] ^ (flip * r.integers(1, 256, (N, 32))).astype(np.uint8)
    d["kp_desc"][near] = noisy[near]
    d["kp_level"][near] = d["cand_level"][src[near]]
    if dup_rows:
        # duplicated descriptors + positions: equal costs in several rows
        d["cand_desc"][1:dup_rows + 1] = d["cand_desc"][0]
        d["cand_uv"][1:dup_rows + 1] = d["cand_uv"][0]
        d["cand_level"][1:dup_rows + 1] = d["cand_level"][0]
        d["cand_radius"][1:dup_rows + 1] = d["cand_radius"][0]
        d["cand_valid"][:dup_rows + 1] = True
        d["kp_desc"][:4] = d["cand_desc"][0]
        d["kp_uv"][:4] = d["cand_uv"][0]
        d["kp_level"][:4] = d["cand_level"][0]
        d["kp_valid"][:4] = True
    return d


def _top2_args(d, lib):
    keys = ("cand_uv", "cand_desc", "cand_radius", "cand_level", "cand_valid",
            "kp_uv", "kp_desc", "kp_level", "kp_valid")
    return [lib(d[k]) for k in keys]


def _torch_top2(d, device="cpu"):
    return match_kernel.match_top2(*_top2_args(d, lambda x: torch.from_numpy(x).to(device)))


def _jax_pallas_top2(d):
    return pallas_match.match_top2(
        jnp.asarray(d["cand_uv"]), jorb.descriptors_pm1(jnp.asarray(d["cand_desc"]),
                                                        jnp.asarray(d["cand_valid"])),
        jnp.asarray(d["cand_radius"]), jnp.asarray(d["cand_level"]),
        jnp.asarray(d["cand_valid"]), jnp.asarray(d["kp_uv"]),
        jorb.descriptors_pm1(jnp.asarray(d["kp_desc"]), jnp.asarray(d["kp_valid"])),
        jnp.asarray(d["kp_level"]), jnp.asarray(d["kp_valid"]))


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid"])
def test_match_top2_plain_matches_pallas_kernel(case):
    """best / second / arg exactly equal to the Pallas kernel (interpret
    mode) at (M, N) = (1024, 512); the port reports arg -1 for a keypoint
    with no candidate, as the Pallas kernel does."""
    d = _inputs(1, 1024, 512, dup_rows=5 if case == "ties" else 0)
    if case == "all_invalid":
        d["cand_valid"][:] = False
    best, second, arg, best_cand = _torch_top2(d)
    jb, js, ja = (np.asarray(x) for x in _jax_pallas_top2(d))
    np.testing.assert_array_equal(best.numpy(), jb.astype(np.int64))
    np.testing.assert_array_equal(second.numpy(), js.astype(np.int64))
    np.testing.assert_array_equal(arg.numpy(), ja)
    if case == "all_invalid":
        assert (arg.numpy() == -1).all()
        assert (best_cand.numpy() == match_kernel.BIG).all()
    if case == "ties":
        # duplicated rows 0..5: the lowest row wins, the second best is the tie
        assert (arg.numpy()[:4] == 0).all() and (best.numpy()[:4] == 0).all()
        assert (second.numpy()[:4] == 0).all()
    else:
        assert (best.numpy() < match_kernel.BIG).sum() > (100 if case == "random" else -1)


# the three call shapes on the path: motion model (TH_HIGH + rotation),
# local map (TH_HIGH + ratio 0.8), keyframe fuse (TH_LOW, no rotation)
CALLS = {
    "motion_model": dict(th_hamming=100, use_rotation=True, nn_ratio=1.0),
    "local_map": dict(th_hamming=100, use_rotation=False, nn_ratio=0.8),
    "fuse": dict(th_hamming=50, use_rotation=False, nn_ratio=1.0),
}


@pytest.mark.parametrize("dup", [0, 5])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_match_candidates_matches_jax(call, dup):
    d = _inputs(2, 1024, 512, dup_rows=dup)
    kw = CALLS[call]
    j = jmatcher.match_candidates(
        jnp.asarray(d["cand_uv"]), jnp.asarray(d["cand_valid"]),
        jorb.descriptors_pm1(jnp.asarray(d["cand_desc"]), jnp.asarray(d["cand_valid"])),
        jnp.asarray(d["cand_level"]), jnp.asarray(d["cand_angle"]),
        jnp.asarray(d["cand_radius"]), jnp.asarray(d["kp_uv"]),
        jnp.asarray(d["kp_valid"]),
        jorb.descriptors_pm1(jnp.asarray(d["kp_desc"]), jnp.asarray(d["kp_valid"])),
        jnp.asarray(d["kp_level"]), jnp.asarray(d["kp_angle"]), level_slack=1, **kw)
    t = tmatcher.match_candidates(
        *(torch.from_numpy(d[k]) for k in (
            "cand_uv", "cand_valid", "cand_desc", "cand_level", "cand_angle",
            "cand_radius", "kp_uv", "kp_valid", "kp_desc", "kp_level", "kp_angle")),
        level_slack=1, **kw)
    np.testing.assert_array_equal(t.point_idx.numpy(), np.asarray(j.point_idx))
    np.testing.assert_array_equal(t.distance.numpy(), np.asarray(j.distance))
    assert int(t.n_matches) == int(j.n_matches) > 20


@pytest.mark.parametrize("dtype,dim", [(np.int32, 0), (np.int32, -1), (np.float32, 1)])
def test_hamming_helpers_match_jax(dtype, dim):
    """best_two (lowest index among ties, second best counting duplicates)
    and hamming_packed, exactly as the JAX functions."""
    from gdslam_tpu.ops import hamming as jham
    from gdslam_tpu_torch.ops import hamming as tham
    r = np.random.default_rng(7)
    d = r.integers(0, 6, (40, 30)).astype(dtype)           # small range: many ties
    got = tham.best_two(torch.from_numpy(d), dim=dim)
    want = jham.best_two(jnp.asarray(d), axis=dim)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a = r.integers(0, 256, (50, 32)).astype(np.uint8)
    b = r.integers(0, 256, (50, 32)).astype(np.uint8)
    np.testing.assert_array_equal(tham.hamming_packed(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jham.hamming_packed(jnp.asarray(a), jnp.asarray(b))))
