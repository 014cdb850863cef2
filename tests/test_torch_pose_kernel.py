"""The pose Gauss-Newton kernel's plain twin (gdslam_tpu_torch/ops/
pose_kernel.py, the CPU side of csrc/pose_gn.cu) against the JAX package's
pose_optimization on the CPU, on the seeded cases of ops/pose_cases.py; the
kernel's order (rows a thread, then a fixed tree) against a numpy mirror of
its threads; padded rows that change no bit; pose_optimization on CPU
tensors is the twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import optimizer as jopt
from gdslam_tpu_torch.backend import optimizer as topt
from gdslam_tpu_torch.ops import pose_cases
from gdslam_tpu_torch.ops import pose_kernel as pk

# One torch thread per test process: xdist's six workers share the cores.
torch.set_num_threads(1)

JAX_CASES = [c for c in pose_cases.CASES if c not in pose_cases.CARD_ONLY]
UNCHANGED = ("none_valid", "nan_row", "ragged_1")      # every step skipped or zero


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


@pytest.mark.parametrize("case", JAX_CASES)
def test_twin_matches_jax(case):
    """pose_gn_plain against the jitted JAX pose_optimization on the same
    numpy inputs: T to 1e-5, the inlier masks and counts identical; T
    bitwise the start where no row is valid or a valid row is NaN."""
    d = pose_cases.pose_input(case)
    obs = jopt.PoseObs(*(jnp.asarray(d[k]) for k in ("pw", "uv", "ur", "inv_sigma2", "valid")))
    Tj, inl_j, n_j = jopt.pose_optimization(jnp.asarray(d["T"]), obs, d["K"], d["bf"],
                                            d["rounds"], d["iters"])
    Tt, inl_t, n_t = pk.pose_gn_plain(*pose_cases.pose_args(case))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert n_t.dtype == torch.int64 and n_t.shape == () and int(n_t) == int(n_j)
    if case in UNCHANGED:
        np.testing.assert_array_equal(_bits(Tt), d["T"].view(np.int32))
    if case == "nan_row":
        assert not inl_t[np.flatnonzero(np.isnan(d["pw"][:, 0]))].any()
    if case == "behind":
        assert int(n_t) > 100


@pytest.mark.parametrize("case", ["mixed", "tracker_1500", "mono_boot", "rank_deficient"])
def test_pose_optimization_on_cpu_is_the_twin(case):
    """backend/optimizer.pose_optimization on CPU tensors equals
    pose_gn_plain bit for bit (the wrapper takes the twin on the CPU)."""
    args = pose_cases.pose_args(case)
    before = pk.pose_gn.launches
    for g, w in zip(topt.pose_optimization(*args), pk.pose_gn_plain(*args)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert pk.pose_gn.launches == before


@pytest.mark.parametrize("n", [1, 300, 512, 1501, 2000])
def test_block_sum_is_the_kernels_thread_order(n):
    """_block_sum against a numpy mirror of the kernel: thread t adds rows t,
    t + BLOCK, ... in order from +0 in float32, then a[t] += a[t + s] for s =
    BLOCK / 2, ..., 1; bitwise, on values of mixed sign and magnitude with
    zeros of both signs."""
    r = np.random.default_rng(n)
    q = (r.standard_normal((3, n)) * 10.0 ** r.integers(-3, 4, (3, n))).astype(np.float32)
    q[:, ::7] = np.float32(-0.0)
    acc = np.zeros((3, pk.BLOCK), np.float32)
    for t in range(pk.BLOCK):
        for i in range(t, n, pk.BLOCK):
            acc[:, t] = acc[:, t] + q[:, i]
    s = pk.BLOCK // 2
    while s:
        acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    np.testing.assert_array_equal(pk._block_sum(torch.from_numpy(q)).numpy().view(np.int32),
                                  acc[:, 0].view(np.int32))


def test_padded_and_zero_weight_rows_change_no_bit():
    """Rows the tracker pads (pw = 0, invalid) and valid rows behind the
    camera appended to a case change no bit of T, the inliers of the rows
    before them or their count: their products are zeros, and a sum that
    starts at +0 keeps its bits when a zero of either sign is added."""
    T, obs, K, bf, rounds, iters = pose_cases.pose_args("tracker_1500")
    want = pk.pose_gn_plain(T, obs, K, bf, rounds, iters)
    n = 700
    r = np.random.default_rng(5)
    behind = torch.from_numpy(np.stack([r.uniform(-1, 1, n), r.uniform(-1, 1, n),
                                        r.uniform(-3, -0.1, n)], 1).astype(np.float32))
    pad = topt.PoseObs(torch.cat([obs.pw, torch.zeros(n, 3), behind]),
                       torch.cat([obs.uv, torch.full((2 * n, 2), 300.0)]),
                       torch.cat([obs.ur, torch.full((2 * n,), -1.0)]),
                       torch.cat([obs.inv_sigma2, torch.ones(2 * n)]),
                       torch.cat([obs.valid, torch.zeros(n, dtype=torch.bool),
                                  torch.ones(n, dtype=torch.bool)]))
    got = pk.pose_gn_plain(T, pad, K, bf, rounds, iters)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1][:obs.pw.shape[0]], want[1]) and not got[1][obs.pw.shape[0]:].any()
    assert int(got[2]) == int(want[2])


def test_cases_reach_their_edges():
    """The cases are what pose_cases says: the sizes, the padding, the mono
    and stereo rows, rows behind the start pose, the NaN row, one point."""
    sizes = {c: pose_cases.pose_input(c)["pw"].shape[0] for c in pose_cases.CASES}
    assert sizes["tracker_1500"] == 1500 and sizes["stereo_2000"] == 2000
    assert all(sizes[f"ragged_{n}"] % pk.BLOCK for n in (1, 513, 1501, 6001))
    assert sizes["ragged_6001"] > pk.STAGED_ROWS
    t = pose_cases.pose_input("tracker_1500")
    assert 0.35 < 1 - t["valid"].mean() < 0.45 and not t["pw"][~t["valid"]].any()
    m = pose_cases.pose_input("mono_boot")
    assert m["bf"] == 0.0 and (m["ur"] == -1).all() and (m["inv_sigma2"] == 1).all()
    assert (m["rounds"], m["iters"]) == (1, 8)
    s = pose_cases.pose_input("stereo_2000")
    assert 0.2 < (s["ur"] >= 0).mean() < 0.9 and s["bf"] == pose_cases.KITTI["bf"]
    assert not pose_cases.pose_input("none_valid")["valid"].any()
    b = pose_cases.pose_input("behind")
    zc = b["pw"] @ b["T"][2, :3] + b["T"][2, 3]
    assert (b["valid"] & (zc <= pk.Z_MIN)).sum() > 30
    nan = pose_cases.pose_input("nan_row")
    assert np.isnan(nan["pw"]).any(axis=1).sum() == 1
    rd = pose_cases.pose_input("rank_deficient")
    assert len(np.unique(rd["pw"][rd["valid"]], axis=0)) == 1
    for c in pose_cases.CASES:
        T = pose_cases.pose_input(c)["T"]
        assert T[:3].all() and (T[3] == [0, 0, 0, 1]).all(), c
