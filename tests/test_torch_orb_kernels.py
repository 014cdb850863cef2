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


def _bitonic_descending(keys: np.ndarray) -> np.ndarray:
    """The kernel's network, stage by stage: pairs (i, i + j) with bit j of
    i clear, descending where bit `size` of i is clear."""
    s = keys.copy()
    P = s.shape[0]
    t = np.arange(P // 2)
    size = 2
    while size <= P:
        j = size >> 1
        while j > 0:
            i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            a, c = s[i], s[i + j]
            swap = np.where((i & size) == 0, a < c, a > c)
            s[i[swap]], s[i[swap] + j] = c[swap], a[swap]
            j >>= 1
        size <<= 1
    return s


@pytest.mark.parametrize("n", [2, 336, 2400, 3542])
def test_quota_sort_keys_give_the_stable_order(n):
    """The quota kernel's keys and sorting network, mirrored in numpy, give
    torch.sort(descending, stable)'s order (lax.top_k's): scores with many
    ties, +0 and -0, negatives; padding (key 0) last. n: two candidates,
    the rig's, the defaults' and the stereo cell's level 0."""
    r = np.random.default_rng(n)
    s = r.choice(np.float32([0.0, -0.0, 7.5, 20.25, 33.0, -1.0, 1e30]), n)
    free = r.uniform(size=n) < 0.3
    s[free] = r.uniform(0, 100, free.sum())
    s = s.astype(np.float32)
    P = 1 << int(np.ceil(np.log2(n)))
    keys = np.zeros(P, np.uint64)
    keys[:n] = _sort_key(s, np.arange(n))
    got = _bitonic_descending(keys)[:n]
    idx = (np.uint64(0xFFFFFFFF) - (got & np.uint64(0xFFFFFFFF))).astype(np.int64)
    want = torch.sort(torch.from_numpy(s), descending=True, stable=True)[1].numpy()
    np.testing.assert_array_equal(idx, want)


def test_orb_wrappers_raise_on_cuda_tensors_without_the_library(monkeypatch):
    """For CUDA tensors each front-end wrapper launches or raises: with no
    library it raises and counts no launch, a wrong dtype or a level past
    the kernels' limits is refused, and no wrapper takes its plain twin.
    Fake CUDA tensors stand in for a card."""
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
        for call in (lambda: ok.gaussian_blur7(canvas),
                     lambda: ok.orb_fast_cells(canvas, shapes, 20, 7),
                     lambda: ok.orb_quota_select(s, uv, shapes, quotas, 1.2),
                     lambda: ok.orb_describe(canvas, canvas, uv_n, level)):
            with pytest.raises(RuntimeError, match="orb_extract: library missing"):
                call()
        with pytest.raises(ValueError, match="canvas"):
            ok.gaussian_blur7(canvas.double())
        with pytest.raises(ValueError, match="level"):
            ok.orb_describe(canvas, canvas, uv_n, level.long())
        with pytest.raises(ValueError, match="levels"):
            ok.orb_fast_cells(canvas, [(120, 160)] * 17, 20, 7)
        big = [(2048, 2048)]
        with pytest.raises(ValueError, match="at most 16384"):
            ok.orb_quota_select(torch.empty(32768, **f), torch.empty(32768, 2, **f), big, [1],
                                1.2)
    assert [w.launches for w in ok.WRAPPERS] == before
