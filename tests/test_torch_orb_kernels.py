"""The ORB front end's plain twins (gdslam_tpu_torch/ops/orb_kernel.py, the
CPU side of csrc/orb_extract.cu's four kernels) against the JAX package on
the CPU, on seeded numpy frames at 120x160 (384 features) and 240x320 (1000
features), 4 levels each: the FAST cells and the quota exactly, the
row-ordered IC moments against a float64 sum, the bins and descriptors
against the jitted JAX extract; degenerate frames; the wrappers' no-fallback
rule on fake CUDA tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import OrbConfig
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.ops import fast as jfast
from gdslam_tpu.ops import image as jimg
from gdslam_tpu.ops import orb as jorb
from gdslam_tpu_torch import config as tconfig
from gdslam_tpu_torch.frontend import extractor as text
from gdslam_tpu_torch.ops import cuda_build, orb_cases
from gdslam_tpu_torch.ops import image as timg
from gdslam_tpu_torch.ops import orb as torb
from gdslam_tpu_torch.ops import orb_kernel as ok

# One torch thread per test process: xdist's six workers share the cores.
torch.set_num_threads(1)

SIZES = {(120, 160): OrbConfig(n_features=384, n_levels=4),
         (240, 320): OrbConfig(n_features=1000, n_levels=4)}
BIN_W = 2 * np.pi / torb.N_ANGLE_BINS


def _frame(seed: int, H: int, W: int) -> np.ndarray:
    """Seeded rectangles of random grey on a grey background, plus noise."""
    r = np.random.default_rng(seed)
    img = np.full((H, W), 90.0)
    for _ in range(60):
        y, x = r.integers(0, H), r.integers(0, W)
        img[y:y + r.integers(4, H // 3), x:x + r.integers(4, W // 3)] = r.uniform(0, 255)
    img += r.normal(0, 4, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture(scope="module", params=list(SIZES), ids=lambda s: f"{s[0]}x{s[1]}")
def rig(request):
    """One seeded frame a size, its JAX pyramid, the JAX composition's
    candidates of every level and the jitted JAX extract."""
    H, W = request.param
    orb = SIZES[request.param]
    gray = _frame(H, H, W)
    canvas, _ = jimg.build_pyramid(jnp.asarray(gray), H, W, orb.n_levels, orb.scale_factor)
    fj = jext.extract(jnp.asarray(gray), orb, H, W)
    shapes = [tuple(s) for s in jimg.pyramid_shapes(H, W, orb.n_levels, orb.scale_factor)]
    canvas = np.array(canvas)
    return dict(H=H, W=W, orb=orb, torb=tconfig.OrbConfig(**vars(orb)), gray=gray,
                canvas=canvas, fj={k: np.asarray(v) for k, v in fj._asdict().items()},
                shapes=shapes, cand=_jax_candidates(canvas, shapes, orb),
                quotas=jorb.feature_quotas(orb.n_features, orb.n_levels, orb.scale_factor))


def _jax_level(img_lv, h, w, th_hi, th_lo):
    """The JAX extract's composition on one level (its level_score, then
    _level_candidates: gdslam_tpu/frontend/extractor.py:97-116, :50)."""
    C = jext.CELL
    strength = jfast.fast_strength(img_lv)
    s_hi = jfast.nms3x3(jnp.where(strength > float(th_hi), strength, 0.0))
    s_lo = jfast.nms3x3(jnp.where(strength > float(th_lo), strength, 0.0))
    Hc, Wc = h // C, w // C
    hi_cells = s_hi[:Hc * C, :Wc * C].reshape(Hc, C, Wc, C).max(axis=(1, 3))
    has_hi = jnp.repeat(jnp.repeat(hi_cells > 0, C, 0), C, 1)
    has_hi = jnp.pad(has_hi, ((0, h - Hc * C), (0, w - Wc * C)))
    return jext._level_candidates(jnp.where(has_hi, s_hi, s_lo), h, w)


def _jax_candidates(canvas, shapes, orb):
    """[(scores, uv)] of every level by the JAX composition, in one jitted
    program."""
    @jax.jit
    def levels(c):
        return [_jax_level(c[lv, :h, :w], h, w, orb.ini_th_fast, orb.min_th_fast)
                for lv, (h, w) in enumerate(shapes)]

    return [tuple(np.asarray(x) for x in out) for out in levels(jnp.asarray(canvas))]


def test_fast_cells_plain_equals_the_jax_composition(rig):
    """fast_cells_plain at every level exactly the JAX package's fast_strength
    -> nms3x3 x2 -> per-cell fallback -> _level_candidates on the same
    canvas (torch.roll wraps as jnp.roll; the scores and the in-cell tie
    order are exact)."""
    want = rig["cand"]
    s, uv = ok.fast_cells_plain(torch.from_numpy(rig["canvas"]), rig["shapes"],
                                rig["orb"].ini_th_fast, rig["orb"].min_th_fast)
    start = 0
    for (vals, cuv), n in zip(want, ok.n_candidates(rig["shapes"])):
        np.testing.assert_array_equal(s[start:start + n].numpy(), vals)
        np.testing.assert_array_equal(uv[start:start + n].numpy(), cuv)
        start += n
    assert start == s.shape[0] and (s > 0).sum() > 100


def test_quota_select_plain_equals_lax_top_k(rig):
    """quota_select_plain on the JAX candidates exactly lax.top_k of each
    level plus the zero padding (rows past a level's candidates: score 0,
    candidate 0's uv), the level-0 uv and the levels; and the port's extract
    gives the jitted JAX extract's uv, response, level and valid."""
    cand = rig["cand"]
    resp, uv_lv, uv, level, valid = ok.quota_select_plain(
        torch.from_numpy(np.concatenate([c[0] for c in cand])),
        torch.from_numpy(np.concatenate([c[1] for c in cand])), rig["shapes"], rig["quotas"],
        rig["orb"].scale_factor)
    row, padded = 0, 0
    for lv, ((vals, cuv), k) in enumerate(zip(cand, rig["quotas"])):
        k_eff = min(k, vals.shape[0])
        top_s, top_i = jax.lax.top_k(jnp.asarray(vals), k_eff)
        top_s, top_i = jnp.pad(top_s, (0, k - k_eff)), jnp.pad(top_i, (0, k - k_eff))
        want_uv = jnp.asarray(cuv)[top_i]
        np.testing.assert_array_equal(resp[row:row + k].numpy(), np.asarray(top_s))
        np.testing.assert_array_equal(uv_lv[row:row + k].numpy(), np.asarray(want_uv))
        np.testing.assert_array_equal(uv[row:row + k].numpy(),
                                      np.asarray(want_uv * (float(rig["orb"].scale_factor) ** lv)))
        assert (level[row:row + k] == lv).all()
        row, padded = row + k, padded + k - k_eff
    np.testing.assert_array_equal(valid.numpy(), resp.numpy() > 0)
    ft = text.extract(torch.from_numpy(rig["gray"]), rig["torb"], rig["H"], rig["W"])
    for name in ("uv", "response", "level", "valid"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(), rig["fj"][name], err_msg=name)
    assert padded > 0 or rig["H"] != 120         # the 120x160 rig pads levels 1-3


def test_ic_moments_row_order_against_float64(rig):
    """The row-ordered moments (each row's 31 columns in order, then the 31
    rows in order) within 1e-5 of the sum of the terms' magnitudes of a
    float64 sum of the same products (the rounding of a sum of 961 terms),
    and their angle within 1e-5 rad of the float64 angle wherever the
    moments are not a small fraction (5%) of that sum (a nearly flat patch,
    whose angle is ill-conditioned)."""
    s, uv = ok.fast_cells_plain(torch.from_numpy(rig["canvas"]), rig["shapes"], 20, 7)
    sel = ok.quota_select_plain(s, uv, rig["shapes"], rig["quotas"], 1.2)
    patches = torb.extract_patches(torch.from_numpy(rig["canvas"]), sel[1], level=sel[3])
    m10, m01 = ok.ic_moments(patches)
    w = (patches[:, 3:34, 3:34] * torch.from_numpy(torb._IC_MASK)).double().numpy()
    t10, t01 = w * torb._IC_X.astype(np.float64), w * torb._IC_Y.astype(np.float64)
    M10, M01 = t10.sum((1, 2)), t01.sum((1, 2))
    mag = np.abs(t10).sum((1, 2)) + np.abs(t01).sum((1, 2))
    err = np.maximum(np.abs(m10.numpy() - M10), np.abs(m01.numpy() - M01))
    assert (err <= 1e-5 * mag).all()
    a32 = torch.atan2(m01, m10).numpy().astype(np.float64)
    da = np.abs(np.angle(np.exp(1j * (a32 - np.arctan2(M01, M10)))))
    ok_rows = np.hypot(M10, M01) >= 0.05 * mag
    assert ok_rows.mean() > 0.5 and da[ok_rows].max() <= 1e-5


def test_bins_and_descriptors_match_jax(rig):
    """The port's extract against the jitted JAX extract: angles to 1e-4
    rad on >= 98% of the keypoints and to 1e-3 on all (the moments' order
    differs from XLA's; a nearly uniform patch, of which this frame's flat
    rectangles make many, has small moments and an ill-conditioned angle);
    the bins, round_half_even(angle * RCP_BIN) mod 30 (the product XLA makes
    of the JAX division), equal wherever the JAX angle lies more than 1e-4
    rad from a bin edge; the descriptors exactly wherever the bins agree."""
    ft = text.extract(torch.from_numpy(rig["gray"]), rig["torb"], rig["H"], rig["W"])
    aj = rig["fj"]["angle"]
    d = np.abs(ft.angle.numpy() - aj)
    assert (d <= 1e-4).mean() >= 0.98 and d.max() <= 1e-3
    bins_j = np.mod(np.round(aj * np.float32(ok.RCP_BIN)).astype(np.int64), torb.N_ANGLE_BINS)
    bins_t = ok.angle_bins(ft.angle).numpy()
    q = aj.astype(np.float64) / BIN_W
    far = np.abs(q - np.floor(q) - 0.5) * BIN_W > 1e-4
    np.testing.assert_array_equal(bins_t[far], bins_j[far])
    same = bins_t == bins_j
    assert same.mean() > 0.99
    np.testing.assert_array_equal(ft.desc.numpy()[same], rig["fj"]["desc"][same])


@pytest.mark.parametrize("name", ["flat", "saturated"])
def test_flat_and_saturated_frames_keep_no_keypoint(name):
    """No corner anywhere: every row invalid with response 0, in the shapes
    of a full feature set, as the JAX extract gives."""
    orb = SIZES[(120, 160)]
    gray = orb_cases.pattern(name, 120, 160)
    ft = text.extract(torch.from_numpy(gray), tconfig.OrbConfig(**vars(orb)), 120, 160)
    fj = jext.extract(jnp.asarray(gray), orb, 120, 160)
    N = orb.n_features
    assert [tuple(getattr(ft, f).shape) for f in ft._fields] == \
        [(N, 2), (N,), (N,), (N,), (N, 32), (N,)]
    assert not ft.valid.any() and not ft.response.any()
    np.testing.assert_array_equal(ft.uv.numpy(), np.asarray(fj.uv))
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))


def _sort_key(s: np.ndarray, i: np.ndarray) -> np.ndarray:
    """csrc/orb_extract.cu's sort_key in numpy: the score's bits in an
    order-preserving transform (-0 as +0) over the index's complement."""
    u = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - i.astype(np.uint64))


def _rows_by_counting(keys: np.ndarray, k: int, warps: int = 16, buf: int = 256) -> np.ndarray:
    """The quota kernel's rule, step by step: 32 candidates a CTA (a lane
    each); its `warps` warps split the level's keys in parts and stream each
    part `buf` keys at a time, counting the keys above each lane's own, a
    warp leaving once every lane's count has reached k; the sums are the
    ranks, and a candidate of rank < k takes row rank. Returns the
    candidate in each of the min(k, n) rows (-1 where none wrote)."""
    n = keys.shape[0]
    part = -(-n // warps)
    rank = np.zeros(n, np.int64)
    for c0 in range(0, n, 32):
        live = np.arange(c0, c0 + 32) < n
        mine = np.where(live, np.resize(keys[c0:c0 + 32], 32), np.uint64(2 ** 64 - 1))
        total = np.zeros(32, np.int64)
        for w in range(warps):
            j0 = min(n, w * part)
            j1 = min(n, j0 + part)
            cnt = np.where(live, 0, k)
            for base in range(j0, j1, buf):
                if (cnt >= k).all():
                    break
                cnt = cnt + (keys[None, base:min(base + buf, j1)] > mine[:, None]).sum(1)
            total += cnt
        rank[c0:c0 + 32] = total[:min(32, n - c0)]
    rows = np.full(min(k, n), -1, np.int64)
    kept = np.nonzero(rank < k)[0]
    rows[rank[kept]] = kept
    return rows


@pytest.mark.parametrize("n", [2, 336, 2400, 3542])
def test_quota_sort_keys_give_the_stable_order(n):
    """The quota kernel's keys and counting rule, mirrored in numpy
    (`_rows_by_counting`), give torch.sort(descending, stable)'s order
    (lax.top_k's) in the first min(k, n) rows, every row written once:
    scores with many ties, +0 and -0, negatives; quotas of 1 and 7 (where
    warps leave early), the defaults' level-0 quota, n and past it. n: two
    candidates, the rig's, the defaults' and the stereo cell's level 0."""
    r = np.random.default_rng(n)
    s = r.choice(np.float32([0.0, -0.0, 7.5, 20.25, 33.0, -1.0, 1e30]), n)
    free = r.uniform(size=n) < 0.3
    s[free] = r.uniform(0, 100, free.sum())
    s = s.astype(np.float32)
    keys = _sort_key(s, np.arange(n))
    assert np.unique(keys).shape[0] == n
    want = torch.sort(torch.from_numpy(s), descending=True, stable=True)[1].numpy()
    for k in (1, 7, 326, n, n + 10):
        np.testing.assert_array_equal(_rows_by_counting(keys, k), want[:min(k, n)])


def _is_pos_zero(t: torch.Tensor) -> bool:
    return bool((t.view(torch.int32) == 0).all())


BAND_CASES = [("frame", n) for n in ("rendered", "stereo", "rig")] + \
    [("blur_case", n) for n in orb_cases.BLUR_CASES]


@pytest.mark.parametrize("kind,case", BAND_CASES, ids=[f"{k}-{n}" for k, n in BAND_CASES])
def test_blur_is_pos_zero_past_each_level_band(kind, case):
    """The fact gaussian_blur7's kernel rests on. build_pyramid's canvas (the
    defaults', the stereo cell's, the rig's) and every BLUR_CASES canvas is
    +0 outside each level; then gaussian_blur of it is +0, bit for bit, at y
    >= h + 3 or x >= w + 3 of each level, and the band is no narrower: row
    h + 2 and column w + 2, where the canvas has them, hold a non-zero."""
    if kind == "blur_case":
        canvas, shapes = orb_cases.blur_input(case)
    else:
        gray, orb, cam = orb_cases.orb_input(case, "cpu")
        canvas, shapes = timg.build_pyramid(gray, cam.height, cam.width, orb.n_levels,
                                            orb.scale_factor)
    blurred = timg.gaussian_blur(canvas, 7, 2.0)
    H, W = canvas.shape[1:]
    for lv, (h, w) in enumerate(shapes):
        assert _is_pos_zero(canvas[lv, h:]) and _is_pos_zero(canvas[lv, :, w:])
        assert _is_pos_zero(blurred[lv, h + 3:]) and _is_pos_zero(blurred[lv, :, w + 3:])
        if h + 2 < H:
            assert bool(blurred[lv, h + 2, :w].ne(0).any())
        if w + 2 < W:
            assert bool(blurred[lv, :h, w + 2].ne(0).any())


def test_describe_cases_reach_their_edges():
    """ops/orb_cases.DESCRIBE_CASES reach what they are named for: on every
    level of the three canvases a disc (15 px) and a patch (18 px) past
    each canvas side and a centre outside it, and a patch past the level
    alone; planes that do not start on a 16-byte boundary;
    every level; all 30 rotation bins (the twin's); 0, 1, 3 and 1501
    keypoints."""
    for name in ("edges", "edges_stereo", "odd_canvas"):
        canvas, _, uv, level = orb_cases.describe_input(name)
        H, W = canvas.shape[1:]
        u, v = torch.round(uv[:, 0]).long(), torch.round(uv[:, 1]).long()
        shapes = orb_cases.describe_canvas(H, W)[2]
        for lv, (h, w) in enumerate(shapes):
            on = level == lv
            for r in (15, 18):
                for past in (u[on] - r < 0, u[on] + r >= W, v[on] - r < 0, v[on] + r >= H):
                    assert bool(past.any())
            assert bool(((u[on] < 0) | (u[on] >= W) | (v[on] < 0) | (v[on] >= H)).any())
            if w + 18 < W:
                assert bool(((u[on] + 18 >= w) & (u[on] + 18 < W)).any())
    assert 77 * 93 % 4 != 0                   # odd_canvas's planes are not 16-byte aligned
    for name in ("levels", "bins", "n_odd"):
        assert set(orb_cases.describe_input(name)[3].tolist()) == set(range(8))
    angle, _ = ok.describe_plain(*orb_cases.describe_input("bins"))
    assert set(ok.angle_bins(angle).tolist()) == set(range(torb.N_ANGLE_BINS))
    counts = {n: orb_cases.describe_input(n)[2].shape[0] for n in ("n0", "n1", "n3", "n_odd")}
    assert counts == {"n0": 0, "n1": 1, "n3": 3, "n_odd": 1501}


def test_orb_wrappers_raise_on_cuda_tensors_without_the_library(monkeypatch):
    """For CUDA tensors each front-end wrapper launches or raises: with no
    library it raises and counts no launch (a level of 32768 candidates
    too: the quota has no cap a level), a wrong dtype, a level past the
    kernels' limits or the canvas, level shapes that are not one a plane
    (the blur), a negative threshold or quota is refused, and no wrapper
    takes its plain twin; no keypoint gives empty descriptors without a
    launch. Fake CUDA tensors stand in for a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def missing(name, declare):
        raise RuntimeError(f"{name}: library missing")

    monkeypatch.setattr(cuda_build, "load", missing)
    for plain in ("fast_cells_plain", "quota_select_plain", "describe_plain"):
        monkeypatch.setattr(ok, plain, lambda *a, **k: pytest.fail("fell back to the plain twin"))
    monkeypatch.setattr(ok.image_ops, "gaussian_blur",
                        lambda *a, **k: pytest.fail("fell back to the plain twin"))
    shapes, quotas = [(120, 160), (100, 133)], [100, 60]
    before = [w.launches for w in ok.WRAPPERS]
    with FakeTensorMode():
        f = dict(dtype=torch.float32, device="cuda")
        canvas = torch.empty(2, 120, 160, **f)
        C, N = sum(ok.n_candidates(shapes)), sum(quotas)
        s, uv = torch.empty(C, **f), torch.empty(C, 2, **f)
        uv_n, level = torch.empty(N, 2, **f), torch.empty(N, dtype=torch.int32, device="cuda")
        for call in (lambda: ok.gaussian_blur7(canvas, shapes),
                     lambda: ok.orb_fast_cells(canvas, shapes, 20, 7),
                     lambda: ok.orb_quota_select(s, uv, shapes, quotas, 1.2),
                     lambda: ok.orb_describe(canvas, canvas, uv_n, level)):
            with pytest.raises(RuntimeError, match="orb_extract: library missing"):
                call()
        with pytest.raises(ValueError, match="canvas"):
            ok.gaussian_blur7(canvas.double(), shapes)
        with pytest.raises(ValueError, match="level shapes"):
            ok.gaussian_blur7(canvas, shapes[:1])
        with pytest.raises(ValueError, match="does not fit"):
            ok.gaussian_blur7(canvas, [(121, 160), (100, 133)])
        angle, desc = ok.orb_describe(canvas, canvas, torch.empty(0, 2, **f),
                                      torch.empty(0, dtype=torch.int32, device="cuda"))
        assert angle.shape == (0,) and desc.shape == (0, 32)
        with pytest.raises(ValueError, match="level"):
            ok.orb_describe(canvas, canvas, uv_n, level.long())
        with pytest.raises(ValueError, match="levels"):
            ok.orb_fast_cells(canvas, [(120, 160)] * 17, 20, 7)
        with pytest.raises(ValueError, match="thresholds"):
            ok.orb_fast_cells(canvas, shapes, 20, -1)
        big = [(2048, 2048)]                  # 32768 candidates: no cap a level
        with pytest.raises(RuntimeError, match="orb_extract: library missing"):
            ok.orb_quota_select(torch.empty(32768, **f), torch.empty(32768, 2, **f), big, [1],
                                1.2)
        with pytest.raises(ValueError, match="quotas"):
            ok.orb_quota_select(s, uv, shapes, [100, -1], 1.2)
    assert [w.launches for w in ok.WRAPPERS] == before
