"""Parity of the port's GD masking units (gdslam_tpu_torch.ops.{image,edges,
flow}, frontend.frame's morphology, masking.geomask) with the JAX package's
on the same inputs: seeded numpy arrays and frames of the dynamic scene
(from the port's renderer, which tests/test_torch_package.py holds to the
JAX renderer; both packages get the same arrays). The whole GD slice is in
tests/test_torch_gd.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.masking import geomask as jgeo
from gdslam_tpu.ops import edges as jedges
from gdslam_tpu.ops import flow as jflow
from gdslam_tpu.ops import hamming as jham
from gdslam_tpu.ops import image as jimage
from gdslam_tpu.ops import orb as jorb
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.core import prng
from gdslam_tpu_torch.frontend import frame as tframe
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.masking import geomask as tgeo
from gdslam_tpu_torch.ops import edges as tedges
from gdslam_tpu_torch.ops import flow as tflow
from gdslam_tpu_torch.ops import image as timage
from test_torch_solvers import _jax_draw

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
SCFG = SlamConfig(camera=SCAM, orb=OrbConfig(n_features=384, n_levels=4))
TCFG = convert.config_from_jax_dict(dataclasses.asdict(SCFG))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 1.0


def _render(i: int, cam: CameraConfig):
    """Frame i of the dynamic scene as numpy arrays (gray, depth, dyn_mask,
    T_wc), rendered by the port on the CPU."""
    tcam = convert.config_from_jax_dict(dataclasses.asdict(SlamConfig(camera=cam))).camera
    fr = tsyn.render_frame(i, tcam, with_dynamic=True, device="cpu")
    return fr._replace(**{k: getattr(fr, k).numpy() for k in fr._fields})


@pytest.fixture(scope="module")
def dyn():
    """Frames 0..7 of the dynamic scene on the small rig."""
    return [_render(i, SCAM) for i in range(8)]


def test_bilinear_sample_matches_jax():
    """Exact, on coordinates inside, on the border, exactly on integers, on
    footprints that are partly outside (u0 = -1, v0 = -1, u0 = W - 1) and
    far outside; with fill 0 and another fill value."""
    r = np.random.default_rng(0)
    img = r.uniform(0, 255, (23, 31)).astype(np.float32)
    uv = np.stack([r.uniform(-3, 34, 2000), r.uniform(-3, 26, 2000)], -1)
    uv[:200] = np.round(uv[:200])
    uv[200:300, 0] = r.uniform(-1, 0, 100)          # u0 = -1
    uv[300:400, 1] = r.uniform(-1, 0, 100)          # v0 = -1
    uv[400:500, 0] = r.uniform(30, 31, 100)         # u0 = W - 1
    uv[500:510] = [[-1e4, 5.0]] * 10
    uv = uv.astype(np.float32).reshape(40, 50, 2)
    for fill in (0.0, 7.5):
        want = np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(uv), fill))
        got = timage.bilinear_sample(_t(img), _t(uv), fill).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 3, 5, 7])
def test_erode_dilate_match_jax(k):
    """Exact and [H, W] for even and odd windows: XLA's 'SAME' pads an even
    window by k // 2 - 1 before and k // 2 after."""
    r = np.random.default_rng(k)
    m = r.random((23, 31)) > 0.3
    m[5:12, 8:20] = True
    for jf, tf in ((jframe.erode_mask, tframe.erode_mask),
                   (jframe.dilate_mask, tframe.dilate_mask)):
        want = np.asarray(jf(jnp.asarray(m), k))
        got = tf(_t(m), k).numpy()
        assert got.shape == (23, 31) and got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", ["sphere", "step"])
def test_depth_edges_matches_jax(dyn, scene):
    """Exact on the dynamic sphere scene (depth holes, the sphere's rim) and
    on a depth step; the rolled border band is suppressed in both."""
    if scene == "sphere":
        depth, cam = np.asarray(dyn[3].depth), SCAM
    else:
        depth = np.full((60, 80), 2.0, np.float32)
        depth[:, 40:] = 1.0
        depth[10:15, 5:9] = 0.0
        cam = CameraConfig(width=80, height=60)
    want = np.asarray(jedges.depth_edges(jnp.asarray(depth), cam))
    got = tedges.depth_edges(_t(depth), convert.config_from_jax_dict(
        dataclasses.asdict(SlamConfig(camera=cam))).camera).numpy()
    assert want.sum() > 20
    np.testing.assert_array_equal(got, want)


def test_poly_expansion_and_flow_match_jax(dyn):
    """poly_expansion to 1e-3 (a conv2d sums the 25 taps in another order
    than XLA's convolution; values are up to ~300); farneback_flow between
    two dynamic frames at full resolution and stopped at level 1 without
    upsampling, to 0.02 px at the 99th percentile and 0.2 px at most (3
    levels x 3 warps amplify the summation-order differences where the
    normal equations are ill-conditioned)."""
    g1, g2 = np.asarray(dyn[7].gray), np.asarray(dyn[2].gray)
    A_j, b_j = jflow.poly_expansion(jnp.asarray(g1))
    A_t, b_t = tflow.poly_expansion(_t(g1))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=1e-3)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-3)
    for finest, up in ((0, True), (1, False)):
        want = np.asarray(jflow.farneback_flow(jnp.asarray(g1), jnp.asarray(g2), 5, 15, 3,
                                               finest, up))
        got = tflow.farneback_flow(_t(g1), _t(g2), levels=5, finest_level=finest,
                                   upsample=up).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want)
        assert np.quantile(err, 0.99) < 0.02 and err.max() < 0.2, (finest, err.max())
        assert np.abs(want).max() > 1.0                   # real motion


@pytest.mark.parametrize("hw", [(120, 160), (240, 320), (480, 640)],
                         ids=["s1", "s2", "s4"])
def test_mahalanobis_mask_matches_jax(hw):
    """On each grid (full, half, quarter resolution), fed the same flow and
    T: dynamic frames 6 and 1 of the renderer at that size, the flow at the
    grid's level (the port's, handed to both), the ground-truth relative
    pose. The masks agree to IoU > 0.99 and the normalized distance to 0.05
    on 99% of the pixels (the bisection's percentile moves with the last
    bits of the distances)."""
    H, W = hw
    f = W / 640 * 535.4
    cam = CameraConfig(fx=f, fy=f * 539.2 / 535.4, cx=(W - 1) / 2, cy=(H - 1) / 2,
                       width=W, height=H)
    cfg = SlamConfig(camera=cam)
    s = jgeo.res_factor(cfg)
    assert s == {120: 1, 240: 2, 480: 4}[H]
    a, b = (_render(i, cam) for i in (6, 1))
    flow = tflow.farneback_flow(_t(a.gray), _t(b.gray), levels=5,
                                finest_level={1: 0, 2: 1, 4: 2}[s], upsample=s == 1).numpy()
    T = (np.linalg.inv(b.T_wc) @ a.T_wc).astype(np.float32)
    sem = np.ones((H, W), np.float32)
    m_j, d_j = jgeo.mahalanobis_mask(jnp.asarray(a.depth), jnp.asarray(b.depth),
                                     jnp.asarray(flow), jnp.asarray(T), jnp.asarray(sem), cfg,
                                     False, ref_gray=jnp.asarray(a.gray),
                                     cur_gray=jnp.asarray(b.gray), flow_factor=s)
    m_t, d_t = tgeo.mahalanobis_mask(_t(a.depth), _t(b.depth), _t(flow), _t(T), _t(sem),
                                     convert.config_from_jax_dict(dataclasses.asdict(cfg)),
                                     False, ref_gray=_t(a.gray), cur_gray=_t(b.gray),
                                     flow_factor=s)
    m_j, d_j = np.asarray(m_j), np.asarray(d_j)
    assert m_t.shape == (H, W) and d_t.shape == (H, W)
    dyn_j = m_j < 0.5
    assert dyn_j.sum() > 50                                   # the sphere is flagged
    assert _iou(m_t.numpy() < 0.5, dyn_j) > 0.99
    assert np.quantile(np.abs(d_t.numpy() - d_j), 0.99) < 0.05


def test_otsu_threshold_matches_jax():
    r = np.random.default_rng(3)
    dist = np.concatenate([r.normal(40, 10, 3000), r.normal(180, 20, 1000)])
    dist = np.clip(dist, 0, 255).astype(np.float32).reshape(40, 100)
    valid = r.random((40, 100)) > 0.1
    want = float(jgeo._otsu_threshold(jnp.asarray(dist), jnp.asarray(valid)))
    assert float(tgeo._otsu_threshold(_t(dist), _t(valid))) == want


def test_top_matches_keeps_the_lower_index_among_ties():
    """The top-100 selection of gd_step_core on distances with heavy ties:
    the same rows as the JAX package's argsort + scatter."""
    r = np.random.default_rng(4)
    best = r.integers(10, 20, 1500).astype(np.int32)
    good = r.random(1500) > 0.5
    order = jnp.argsort(jnp.where(jnp.asarray(good), jnp.asarray(best), 1 << 20))
    want = good & np.asarray(jnp.zeros(1500, bool).at[order[:100]].set(True))
    got = tgeo.top_matches(_t(good), _t(best), 100).numpy()
    assert got.sum() == 100
    np.testing.assert_array_equal(got, want)


def _jax_ratio(fa, fb):
    D = jham.hamming_matrix(jorb.descriptors_pm1(fa.desc, fa.valid),
                            jorb.descriptors_pm1(fb.desc, fb.valid))
    best, second, idx = jham.best_two(D, axis=1)
    good = fa.valid & (best < 64) & \
        (best.astype(jnp.float32) < 0.8 * second.astype(jnp.float32))
    return np.asarray(good), np.asarray(idx), np.asarray(best)


@pytest.mark.parametrize("case", ["frames", "few_valid_columns"])
def test_ratio_matches_equal_hamming_best_two(dyn, case):
    """The cur x ref match on the matcher kernel's all-pairs path gives the
    JAX package's `good` exactly and the same reference index wherever the
    best is below 64, with invalid rows on both sides (the JAX matrix
    scores an invalid column at 128; see ratio_matches). "few_valid_columns"
    leaves 3 valid reference keypoints, so the second best is often an
    invalid column's 128 in the JAX package."""
    fa = jext.extract(dyn[7].gray, SCFG.orb, SCAM.height, SCAM.width)
    fb = jext.extract(dyn[2].gray, SCFG.orb, SCAM.height, SCAM.width)
    vb = np.asarray(fb.valid).copy()
    if case == "few_valid_columns":
        keep = np.nonzero(vb)[0][[5, 40, 90]]
        vb[:] = False
        vb[keep] = True
        # three current keypoints made exact copies of the three columns
        desc_a = np.asarray(fa.desc).copy()
        desc_a[:3] = np.asarray(fb.desc)[keep]
        fa = fa._replace(desc=jnp.asarray(desc_a))
    va = np.asarray(fa.valid).copy()
    va[::7] = False
    fa, fb = fa._replace(valid=jnp.asarray(va)), fb._replace(valid=jnp.asarray(vb))
    assert (~vb).sum() > 0 and (~va).sum() > 0
    good_j, idx_j, best_j = _jax_ratio(fa, fb)
    tf = [convert.features_from_numpy({k: np.asarray(getattr(f, k)) for k in f._fields}, "cpu")
          for f in (fa, fb)]
    good_t, idx_t, best_t = tgeo.ratio_matches(tf[0], tf[1], SCFG.orb.n_levels)
    np.testing.assert_array_equal(good_t.numpy(), good_j)
    assert good_j.sum() >= (3 if case == "few_valid_columns" else 30)
    low = best_j < 64
    np.testing.assert_array_equal(idx_t.numpy()[low], idx_j[low])
    np.testing.assert_array_equal(best_t.numpy()[low & va], best_j[low & va])


def test_gd_step_core_matches_jax(dyn):
    """gd_step_core on frame 7 against ring frame 2 (the t-5 pairing), the
    JAX RANSAC draw passed to the port as sample_idx: the refined masks
    agree to IoU > 0.99 (the flow's summation order moves a few boundary
    pixels) and flag part of the moving sphere (the JAX package's own bound
    at this size, tests/test_masking.py); the port's own draw under the
    fast path's key, fold_in(PRNGKey(7), 7) folded from a frame-id tensor,
    gives the same mask; the features cross through
    convert.features_from_numpy / features_to_numpy unchanged."""
    cur, ref = dyn[7], dyn[2]
    fa = jext.extract(cur.gray, SCFG.orb, SCAM.height, SCAM.width)
    fb = jext.extract(ref.gray, SCFG.orb, SCAM.height, SCAM.width)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 7)
    sem = jnp.ones((120, 160))
    core = jax.jit(jgeo.gd_step_core, static_argnums=(8,))   # one compile, not one per op
    want = np.asarray(core(fa, *map(jnp.asarray, (cur.gray, cur.depth)), sem,
                           *map(jnp.asarray, (ref.gray, ref.depth)), fb, key, SCFG))

    # the JAX draw: the `good` that gd_step_core hands ransac_rigid
    def kp_depth(depth, uv):
        u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, 159)
        v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, 119)
        return jnp.asarray(depth)[v, u]
    good, idx, best = _jax_ratio(fa, fb)
    good = good & (np.asarray(kp_depth(cur.depth, fa.uv)) > 0) & \
        (np.asarray(kp_depth(ref.depth, fb.uv))[idx] > 0)
    order = jnp.argsort(jnp.where(jnp.asarray(good), jnp.asarray(best), 1 << 20))
    good = good & np.asarray(jnp.zeros(384, bool).at[order[:100]].set(True))
    draw = _jax_draw(key, good, 300, 3)

    tf = [convert.features_from_numpy({k: np.asarray(getattr(f, k)) for k in f._fields}, "cpu")
          for f in (fa, fb)]
    back = convert.features_to_numpy(tf[0])
    for k in fa._fields:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(fa, k)), err_msg=k)
    got = tgeo.gd_step_core(tf[0], _t(cur.gray), _t(cur.depth), torch.ones(120, 160),
                            _t(ref.gray), _t(ref.depth), tf[1], TCFG,
                            sample_idx=_t(draw)).numpy()
    drawn = tgeo.gd_step_core(tf[0], _t(cur.gray), _t(cur.depth), torch.ones(120, 160),
                              _t(ref.gray), _t(ref.depth), tf[1], TCFG, prng.prng_key(7),
                              fold=torch.tensor([7])).numpy()
    np.testing.assert_array_equal(drawn, got)
    dyn_j, dyn_t = want < 0.5, got < 0.5
    assert good.sum() >= 20 and dyn_j.sum() > 30
    assert _iou(dyn_t, dyn_j) > 0.99
    sphere = np.asarray(cur.dyn_mask)
    assert (dyn_t & sphere).sum() / sphere.sum() > 0.08


def test_relative_pose_matches_jax(dyn):
    """relative_pose (GetRt: both frames extracted, ref x cur matches, the
    rigid RANSAC) with the JAX draw passed in: the same inlier count and
    T_cur_ref to 1e-4."""
    ref, cur = dyn[1], dyn[6]
    key = jax.random.PRNGKey(3)
    T_j, n_j = jgeo.relative_pose(ref.gray, ref.depth, cur.gray, cur.depth, SCFG, key)
    fa = jext.extract(ref.gray, SCFG.orb, SCAM.height, SCAM.width)
    fb = jext.extract(cur.gray, SCFG.orb, SCAM.height, SCAM.width)

    def kp_depth(depth, uv):
        u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, 159)
        v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, 119)
        return np.asarray(jnp.asarray(depth)[v, u])
    good, idx, best = _jax_ratio(fa, fb)
    good = good & (kp_depth(ref.depth, fa.uv) > 0) & (kp_depth(cur.depth, fb.uv)[idx] > 0)
    order = jnp.argsort(jnp.where(jnp.asarray(good), jnp.asarray(best), 1 << 20))
    good = good & np.asarray(jnp.zeros(384, bool).at[order[:100]].set(True))
    T_t, n_t = tgeo.relative_pose(_t(ref.gray), _t(ref.depth), _t(cur.gray), _t(cur.depth),
                                  TCFG, sample_idx=_t(_jax_draw(key, good, 300, 3)))
    assert int(n_t) == int(n_j) >= 20
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)


def test_geomask_maker_ring(dyn):
    """The ring's bookkeeping: warm-up passes the semantic mask through for
    the first inter_frame_size frames (extracting and caching features),
    warm turns on at the fifth, ref_for_next is the entry that becomes
    ring[0] after the next push, and the ring keeps six entries."""
    gm = tgeo.GeoMaskMaker(TCFG)
    sem = torch.ones(120, 160)
    for fr in dyn[:5]:
        assert not gm.warm
        gm.add_new_image(_t(fr.gray), _t(fr.depth), sem)
        assert gm.get_mask(sem) is sem and gm.ring[-1][2] is gm.last_feats
    assert gm.warm and gm.frame_count == 5
    ref = gm.ref_for_next()
    assert ref[0] is gm.ring[0][0]
    gm.push(_t(dyn[5].gray), _t(dyn[5].depth), gm.last_feats)
    ref = gm.ref_for_next()
    assert len(gm.ring) == 6 and ref[0] is gm.ring[1][0]
    gm.add_new_image(_t(dyn[6].gray), _t(dyn[6].depth), sem)
    assert len(gm.ring) == 6 and gm.ring[0][0] is ref[0]
