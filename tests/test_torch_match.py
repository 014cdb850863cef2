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

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)


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


# ---------------------------------------------------------------------------
# The keypoint grid and the candidate rows' cell boxes (plain versions)
# ---------------------------------------------------------------------------

def _grid_case(name, seed=11, M=96, N=160):
    """(cand_uv, cand_radius, cand_valid, kp_uv) float32 / bool numpy arrays
    that stress the cell walk."""
    r = np.random.default_rng(seed)
    W, H = 640.0, 480.0
    kp = r.uniform(0, 1, (N, 2)) * [W, H]
    cand = r.uniform(0, 1, (M, 2)) * [W, H]
    rad = 15.0 * 1.2 ** r.integers(0, 8, M)
    valid = r.uniform(size=M) > 0.1
    if name == "clustered":                     # every keypoint in one cell
        kp = 300.0 + r.uniform(0, 2, (N, 2))
    elif name == "borders":                     # keypoints and rows on cell and image borders
        xs, ys = np.linspace(0, W, 33), np.linspace(0, H, 25)
        kp[:33, 0], kp[33:58, 1] = xs, ys
        kp[58:62] = [[0, 0], [W, 0], [0, H], [W, H]]
        cand[:33, 0], cand[33:58, 1] = xs, ys
        cand[58:62] = kp[58:62]
        rad[:62:2] = 20.0                       # one cell wide
    elif name == "radius_0":                    # only coincident pairs pass
        rad[:] = 0.0
        cand[:40] = kp[:40]
    elif name == "radius_inf":
        rad[:] = np.inf
        rad[::3] = 1e30                         # r * r overflows to inf
    elif name == "radius_mixed":
        rad = r.choice([0.0, 1.0, 20.0, 90.0, 1e4], M)
    elif name == "far_away":                    # rows and keypoints far off the image
        cand[::4] = cand[::4] * 1e4 - 2e6
        rad[::4] = 3e6
        kp[::5] = kp[::5] * -1e5
    elif name == "non_finite":
        kp[::7, 0], kp[3::7, 1], kp[5::7] = np.nan, np.inf, -np.inf
        cand[::6, 0], cand[2::6, 1] = np.nan, np.inf
        rad[4::6], rad[5::12] = np.inf, np.nan
    elif name == "one_keypoint":
        kp = kp[:1]
    elif name == "no_keypoint":
        kp = kp[:0]
    elif name == "tiny":                        # squares that underflow to zero
        kp = r.uniform(-1e-22, 1e-22, (N, 2))
        cand = r.uniform(-1e-22, 1e-22, (M, 2))
        rad[:] = 1e-30
    f = lambda x: np.ascontiguousarray(x, np.float32)       # noqa: E731
    return f(cand), f(rad), valid, f(kp)


GRID_CASES = ["uniform", "clustered", "borders", "radius_0", "radius_inf", "radius_mixed",
              "far_away", "non_finite", "one_keypoint", "no_keypoint", "tiny"]


@pytest.mark.parametrize("cells", [(32, 24), (1, 1), (64, 48), (256, 16)])
@pytest.mark.parametrize("case", GRID_CASES)
def test_kp_grid_plain_is_a_sort_by_cell(case, cells):
    """kp_order is a permutation, cell_start is monotone from 0 to N, and
    every keypoint sits in the cell its coordinates give."""
    _, _, _, kp = _grid_case(case)
    kp_t = torch.from_numpy(kp)
    g = match_kernel.kp_grid(kp_t, *cells)
    N, n_cells = kp.shape[0], cells[0] * cells[1]
    assert g.hdr.shape == (4,) and g.hdr.dtype == torch.float32 and bool(torch.isfinite(g.hdr).all())
    assert sorted(g.kp_order.tolist()) == list(range(N))
    cs = g.cell_start.tolist()
    assert len(cs) == n_cells + 1 and cs[0] == 0 and cs[-1] == N
    assert all(a <= b for a, b in zip(cs, cs[1:]))
    assert torch.equal(g.sorted_uv.nan_to_num(), kp_t[g.kp_order.long()].nan_to_num())
    u0, v0, iu, iv = g.hdr
    cell = match_kernel._cell_coord(kp_t[:, 1], v0, iv, cells[1], 0) * cells[0] + \
        match_kernel._cell_coord(kp_t[:, 0], u0, iu, cells[0], 0)
    sorted_cell = cell[g.kp_order.long()]
    assert (sorted_cell[1:] >= sorted_cell[:-1]).all()
    for c in set(sorted_cell.tolist()):
        assert (sorted_cell[cs[c]:cs[c + 1]] == c).all()
    if case == "clustered" and cells != (1, 1):
        assert len(set(sorted_cell.tolist())) > 1          # the box is the cluster's own


@pytest.mark.parametrize("cells", [(32, 24), (1, 1), (64, 48)])
@pytest.mark.parametrize("case", GRID_CASES)
def test_cell_boxes_hold_every_pair_in_the_window(case, cells):
    """Every pair that match_top2_plain's window test accepts (f32, rounded
    as there) is reachable through the cells of its row's box, so the cell
    walk can drop nothing."""
    cand, rad, valid, kp = (torch.from_numpy(x) for x in _grid_case(case))
    g = match_kernel.kp_grid_plain(kp, *cells)
    boxes, skip = match_kernel.cand_boxes_plain(cand, rad, valid, g)
    du = cand[:, None, 0] - kp[None, :, 0]
    dv = cand[:, None, 1] - kp[None, :, 1]
    accepted = ((du * du + dv * dv) <= (rad * rad)[:, None]) & valid[:, None]
    cell_sorted = torch.searchsorted(g.cell_start[1:].long().contiguous(),
                                     torch.arange(kp.shape[0]), right=True)
    cell = torch.empty_like(cell_sorted)
    cell[g.kp_order.long()] = cell_sorted
    cx, cy = cell % cells[0], cell // cells[0]
    reach = (boxes[:, None, 0] <= cx) & (cx <= boxes[:, None, 1]) & \
        (boxes[:, None, 2] <= cy) & (cy <= boxes[:, None, 3]) & ~skip[:, None]
    assert not (accepted & ~reach).any()
    assert (boxes >= 0).all() and (boxes[:, 1] < cells[0]).all() and (boxes[:, 3] < cells[1]).all()
    if case in ("uniform", "borders", "radius_mixed", "radius_inf"):
        assert accepted.sum() > 20                          # the window is not empty
    if case == "uniform" and cells == (32, 24):
        assert reach.float().mean() < 0.2                   # and the boxes do prune


def test_cell_box_margin_covers_f32_rounding():
    """Hundreds of thousands of random pairs placed within a few ulps of
    their row's radius: whichever way the window test rounds, an accepted
    pair lies inside [uv - R, uv + R]."""
    r = np.random.default_rng(5)
    n = 400_000
    c = torch.from_numpy((r.uniform(-2000, 2000, n)).astype(np.float32))
    rad = torch.from_numpy((10 ** r.uniform(-3, 3.5, n)).astype(np.float32))
    k = c + rad * torch.from_numpy(r.choice([-1.0, 1.0], n).astype(np.float32))
    n_accepted = 0
    for _ in range(3):                                      # walk outward by ulps
        accepted = ((c - k) * (c - k) + 0.0) <= rad * rad
        R = (rad.abs() * 1.00001 + c.abs() * 1e-6) + 1e-3
        assert ((c - R <= k) & (k <= c + R))[accepted].all()
        n_accepted += int(accepted.sum())
        k = torch.nextafter(k, torch.where(k > c, 1.0, -1.0) * float("inf"))
    assert n_accepted > 20_000                              # both roundings occurred


@pytest.mark.parametrize("M,N", [(0, 8), (8, 0), (0, 0), (1, 1)])
def test_match_top2_plain_takes_empty_sides(M, N):
    d = _inputs(3, max(M, 1), max(N, 1))
    args = [torch.from_numpy(d[k][:M] if k.startswith("cand") else d[k][:N])
            for k in ("cand_uv", "cand_desc", "cand_radius", "cand_level", "cand_valid",
                      "kp_uv", "kp_desc", "kp_level", "kp_valid")]
    best, second, arg, best_cand = match_kernel.match_top2(*args)
    assert best.shape == second.shape == arg.shape == (N,) and best_cand.shape == (M,)
    assert {t.dtype for t in (best, second, arg, best_cand)} == {torch.int32}
    if 0 in (M, N):
        assert (best == match_kernel.BIG).all() and (arg == -1).all()
        assert (best_cand == match_kernel.BIG).all()


@pytest.mark.parametrize("case", ["frames", "duplicates", "one_valid", "none_valid"])
def test_dense_ratio_matches_equal_jax(case):
    """Relocalization's all-pairs ratio matcher routed through match_top2
    (the keyframe's keypoints as candidate rows, infinite radius, level slack
    of n_levels) against the JAX package's _dense_ratio_matches on the same
    descriptors: the same index per keypoint and the same count. "frames":
    near-copies with flipped bits, most pass the ratio test; "duplicates":
    every keyframe descriptor occurs twice, so second == best and nothing
    passes (the second best counts duplicates), and the arg is the lower row;
    "one_valid": a single valid keyframe keypoint, so second is the 1 << 20
    sentinel on both sides; "none_valid": no match."""
    from gdslam_tpu.system import tracking as jtr
    from gdslam_tpu_torch.frontend.frame import Frame
    from gdslam_tpu_torch.system import tracking as ttr
    r = np.random.default_rng(21)
    Na, Nb = 96, 80
    desc_b = r.integers(0, 256, (Nb, 32)).astype(np.uint8)
    src = r.integers(0, Nb, Na)
    flip = ((r.integers(0, 256, (Na, 32)) < 6) * r.integers(1, 256, (Na, 32))).astype(np.uint8)
    desc_a = desc_b[src] ^ flip
    desc_a[::7] = r.integers(0, 256, (len(desc_a[::7]), 32))           # no counterpart
    valid_a, valid_b = r.random(Na) > 0.1, r.random(Nb) > 0.1
    if case == "duplicates":
        desc_b[Nb // 2:] = desc_b[:Nb // 2]
        valid_b[:] = True
    if case == "one_valid":
        valid_b[:] = False
        valid_b[src[1]] = True
        valid_a[1] = True
    if case == "none_valid":
        valid_b[:] = False
    idx_j, n_j = jtr._dense_ratio_matches(jnp.asarray(desc_a), jnp.asarray(valid_a),
                                          jnp.asarray(desc_b), jnp.asarray(valid_b))
    t = torch.from_numpy
    zeros = torch.zeros(Na)
    fields = dict(uv=t(r.uniform(0, 160, (Na, 2)).astype(np.float32)),
                  level=t(r.integers(0, 4, Na).astype(np.int32)), desc=t(desc_a),
                  valid=t(valid_a))
    frame = Frame(**{k: fields.get(k, zeros) for k in Frame._fields})
    idx_t, n_t = ttr._dense_ratio_matches(
        frame, t(r.uniform(0, 160, (Nb, 2)).astype(np.float32)), t(desc_b),
        t(r.integers(0, 4, Nb).astype(np.int32)), t(valid_b), 4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(n_t) == int(n_j)
    expect = {"frames": int(n_t) > 40, "duplicates": int(n_t) == 0,
              "one_valid": int(n_t) >= 1, "none_valid": int(n_t) == 0}
    assert expect[case]
