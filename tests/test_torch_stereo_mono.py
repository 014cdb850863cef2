"""Parity of the units of the port's stereo and monocular slice
(gdslam_tpu_torch ops/stereo, frontend/initializer, frame.build_frame_stereo,
the camera leftovers, core/prng, the bootstrap's match and scatter) with the
JAX package on the same inputs: the JAX stereo test's 160x120 rig
(tests/test_stereo_mono.py), a quarter-KITTI rig of odd size, and seeded
numpy arrays. The port's bootstrap replays the JAX package's RANSAC draws
(core.prng, held here to jax.random). The trackers and the drivers are in
tests/test_torch_drivers.py; the stereo kernel against its plain twin on the
card in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.core import camera as jcam
from gdslam_tpu.core import lie as jlie
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.frontend import initializer as jinit
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.ops import hamming as jham
from gdslam_tpu.ops import orb as jorb
from gdslam_tpu.ops import stereo as jstereo
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.core import camera as tcam
from gdslam_tpu_torch.frontend import extractor as text
from gdslam_tpu_torch.frontend import frame as tframe
from gdslam_tpu_torch.frontend import initializer as tinit
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.ops import stereo as tstereo
from gdslam_tpu_torch.ops import stereo_cases
from gdslam_tpu_torch.system import tracking as ttracking
from test_torch_solvers import _jax_draw

# One torch thread per test process: xdist's six workers share the cores.
torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)   # 8 cm baseline (the JAX stereo test's rig)
SCFG = SlamConfig(camera=SCAM, orb=OrbConfig(n_features=384, n_levels=4))
TCFG = convert.config_from_jax_dict(dataclasses.asdict(SCFG))
# A quarter of KITTI00-02.yaml (1241 x 376, fx 718.856, bf 386.1448): odd
# sizes, neither a multiple of the extractor's 16-pixel cell
QCAM = CameraConfig(fx=718.856 / 4, fy=718.856 / 4, cx=607.1928 / 4, cy=185.2157 / 4,
                    width=311, height=94, bf=386.1448 / 4, fps=10.0, th_depth=35.0)
QCFG = SlamConfig(camera=QCAM, orb=OrbConfig(n_features=384, n_levels=4))
TQCFG = convert.config_from_jax_dict(dataclasses.asdict(QCFG))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _stereo_pair(i: int, cam: CameraConfig):
    """The JAX stereo test's pair i: left and right gray (numpy), the right
    view shifted by the baseline along x."""
    T_l = jsyn.gt_pose(i)
    T_r = T_l @ jnp.eye(4).at[0, 3].set(cam.bf / cam.fx)
    return (np.asarray(jsyn.render(T_l, cam, False, 30.0, i).gray),
            np.asarray(jsyn.render(T_r, cam, False, 30.0, i).gray), np.asarray(T_l))


def _jax_stereo(A, B, gl, gr, cam, scale=1.2):
    ur, depth = jstereo.stereo_match(A.uv, A.level, A.desc, A.valid, B.uv, B.level, B.desc,
                                     B.valid, cam.bf, cam.bf / cam.fx, jnp.asarray(gl),
                                     jnp.asarray(gr), scale)
    return np.asarray(ur), np.asarray(depth)


def _port_stereo(A, B, gl, gr, cam, scale=1.2):
    a, b = convert.features_from_numpy(_np(A), "cpu"), convert.features_from_numpy(_np(B), "cpu")
    ur, depth = tstereo.stereo_match(a.uv, a.level, a.desc, a.valid, b.uv, b.level, b.desc,
                                     b.valid, cam.bf, cam.bf / cam.fx, _t(gl), _t(gr), scale)
    return ur.numpy(), depth.numpy()


def test_camera_leftovers_match_jax():
    """intrinsic_matrix, dist_coeffs, distort_normalized and undistort_lut
    equal the JAX functions to 1e-6 (the table in normalized coordinates)."""
    cam = dataclasses.replace(SCAM, k1=0.12, k2=-0.05, p1=0.001, p2=-0.002, k3=0.01)
    tc = TCFG.camera.__class__(**dataclasses.asdict(cam))
    np.testing.assert_array_equal(tcam.intrinsic_matrix(tc).numpy(),
                                  np.asarray(jcam.intrinsic_matrix(cam)))
    d_t, d_j = tcam.dist_coeffs(tc), jcam.dist_coeffs(cam)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    xy = np.random.default_rng(0).uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.distort_normalized(_t(xy), d_t).numpy(),
                               np.asarray(jcam.distort_normalized(jnp.asarray(xy), d_j)),
                               atol=1e-6)
    lut_t, lut_j = tcam.undistort_lut(tc).numpy(), np.asarray(jcam.undistort_lut(cam))
    assert lut_t.shape == lut_j.shape == (120, 160, 2)
    # in normalized coordinates (the pixels are f = 160 times them; XLA fuses
    # the jitted table's products into FMAs)
    f, c = np.array([cam.fx, cam.fy]), np.array([cam.cx, cam.cy])
    np.testing.assert_allclose((lut_t - c) / f, (lut_j - c) / f, atol=1e-6, rtol=0)
    # no distortion: the identity table
    np.testing.assert_array_equal(tcam.undistort_lut(TCFG.camera).numpy(),
                                  np.asarray(jcam.undistort_lut(SCAM)))


def test_band_table_is_the_jax_power():
    """The row band 2 * scale^level of the table equals the JAX package's
    jitted `2.0 * scale ** level` on every level and scale used."""
    f = jax.jit(lambda lv, sf: 2.0 * sf ** lv.astype(jnp.float32))
    lv = jnp.arange(tstereo.BAND_LEVELS, dtype=jnp.int32)
    for sf in (1.2, 1.1, 1.25, 1.3, 2.0):
        np.testing.assert_array_equal(tstereo.band_table(sf, "cpu").numpy(),
                                      np.asarray(f(lv, sf)), err_msg=str(sf))


@pytest.mark.parametrize("images", ["integer", "float"])
def test_stereo_match_plain_matches_jax(images):
    """On the JAX test's 160x120 pair (JAX features fed to both): with the
    images rounded to integers (the KITTI PNG route) ur and depth are exact;
    on the float renders the matched set is the same and ur agrees to 1e-3
    px (the SADs are float sums in another order)."""
    gl, gr, _ = _stereo_pair(0, SCAM)
    if images == "integer":
        gl, gr = np.round(gl), np.round(gr)
    A = jext.extract(jnp.asarray(gl), SCFG.orb, 120, 160)
    B = jext.extract(jnp.asarray(gr), SCFG.orb, 120, 160)
    ur_j, d_j = _jax_stereo(A, B, gl, gr, SCAM)
    ur_t, d_t = _port_stereo(A, B, gl, gr, SCAM)
    assert (d_j > 0).sum() > 100
    np.testing.assert_array_equal(d_t > 0, d_j > 0)
    if images == "integer":
        np.testing.assert_array_equal(ur_t, ur_j)
        np.testing.assert_array_equal(d_t, d_j)
    else:
        np.testing.assert_allclose(ur_t, ur_j, atol=1e-3, rtol=0)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
    # no refinement without the images; an all-invalid right frame matches nothing
    ur0_j, _ = jstereo.stereo_match(A.uv, A.level, A.desc, A.valid, B.uv, B.level, B.desc,
                                    B.valid, SCAM.bf, SCAM.bf / SCAM.fx, None, None, 1.2)
    a, b = convert.features_from_numpy(_np(A), "cpu"), convert.features_from_numpy(_np(B), "cpu")
    ur0_t, _ = tstereo.stereo_match(a.uv, a.level, a.desc, a.valid, b.uv, b.level, b.desc,
                                    b.valid, SCAM.bf, SCAM.bf / SCAM.fx)
    np.testing.assert_array_equal(ur0_t.numpy(), np.asarray(ur0_j))
    none_t = tstereo.stereo_match(a.uv, a.level, a.desc, a.valid, b.uv, b.level, b.desc,
                                  torch.zeros_like(b.valid), SCAM.bf, SCAM.bf / SCAM.fx,
                                  _t(gl), _t(gr))
    assert (none_t[0] == -1).all() and (none_t[1] == 0).all()


def test_extraction_and_stereo_match_at_an_odd_size():
    """A quarter of KITTI's rig (311 x 94, 4 levels, 384 features) on
    integer images: the port's extraction gives the JAX package's keypoints,
    levels, validity and descriptors on both views, and ur and depth from
    each package's own features are equal. The IC angle sums in another
    order (1e-4 rad, as tests/test_torch_frontend.py holds it), and the FAST
    response of one or two keypoints a view is one ulp apart: the pyramid's
    resize products are summed in another order at this width."""
    fl, fr = [tsyn.render(T, convert.config_from_jax_dict(dataclasses.asdict(QCFG)).camera,
                          False, 10.0, 3)
              for T in (tsyn.gt_pose(3, 10.0), tsyn.gt_pose(3, 10.0) @ torch.tensor(
                  [[1, 0, 0, QCAM.bf / QCAM.fx], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))]
    gl, gr = np.round(fl.gray.numpy()), np.round(fr.gray.numpy())
    feats = {}
    for name, g in (("left", gl), ("right", gr)):
        J = jext.extract(jnp.asarray(g), QCFG.orb, 94, 311)
        T = text.extract(_t(g), TQCFG.orb, 94, 311)
        for k in ("uv", "level", "valid", "desc"):
            np.testing.assert_array_equal(getattr(T, k).numpy(), np.asarray(getattr(J, k)),
                                          err_msg=f"{name} {k}")
        np.testing.assert_allclose(T.angle.numpy(), np.asarray(J.angle), atol=1e-4)
        np.testing.assert_allclose(T.response.numpy(), np.asarray(J.response), rtol=1e-6)
        feats[name] = (J, T)
    assert int(feats["left"][0].valid.sum()) > 200
    ur_j, d_j = _jax_stereo(feats["left"][0], feats["right"][0], gl, gr, QCAM)
    ur_t, d_t = _port_stereo(feats["left"][1], feats["right"][1], gl, gr, QCAM)
    assert (d_j > 0).sum() > 100
    np.testing.assert_array_equal(ur_t, ur_j)
    np.testing.assert_array_equal(d_t, d_j)


def _gated_pairs(t: dict, scale: float = 1.2) -> torch.Tensor:
    """[N, M] bool: the pairs that stereo_match_plain's gates accept (the
    row band, the disparity range, the level gap, both valid), in its ops."""
    band = tstereo.band_table(scale, "cpu")[t["left_level"].long().clamp(
        0, tstereo.BAND_LEVELS - 1)]
    row_ok = torch.abs(t["left_uv"][:, None, 1] - t["right_uv"][None, :, 1]) <= band[:, None]
    disp = t["left_uv"][:, None, 0] - t["right_uv"][None, :, 0]
    b_over = torch.full((), stereo_cases.BF / stereo_cases.MIN_Z, dtype=torch.float32)
    lvl_ok = torch.abs(t["left_level"][:, None] - t["right_level"][None, :]) <= 1
    return (row_ok & (disp >= -1.0) & (disp <= b_over) & lvl_ok & t["left_valid"][:, None]
            & t["right_valid"][None, :])


@pytest.mark.parametrize("case", ["random", "random_no_images", *stereo_cases.CASES])
def test_band_walk_covers_every_gated_pair(case):
    """The stereo kernel's row buckets and band walk, by their plain twins:
    every valid right keypoint sits in the bucket of its own row (clamped),
    and for every pair that stereo_match_plain's gates accept, the right
    keypoint lies in the run of records the kernel walks for the left one,
    order[offsets[lo]:offsets[hi + 1]]. So the walk, which re-applies the
    exact gates, skips only pairs that fail them. On KITTI-sized seeded
    keypoints (the table at the image's 376 rows, and at the 4096 rows the
    kernel takes with no images) and on each edge case."""
    d = (stereo_cases.stereo_inputs(7, 2000, 2000) if case.startswith("random")
         else stereo_cases.stereo_edge_inputs(case))
    t = {k: _t(v) for k, v in d.items()}
    rows = tstereo.bucket_rows(0 if case == "random_no_images" else stereo_cases.H)
    order, off = tstereo.row_buckets_plain(t["right_uv"], t["right_valid"], rows)
    K = int(off[-1])
    assert K == int(t["right_valid"].sum()) and (order[K:] == -1).all()
    assert (off[1:] >= off[:-1]).all() and int(off[0]) == 0
    b = torch.floor(t["right_uv"][:, 1]).nan_to_num(0.0).clamp(0, rows - 1).long()
    bucket_of_pos = torch.repeat_interleave(torch.arange(rows), off[1:] - off[:-1])
    assert torch.equal(b[order[:K]], bucket_of_pos)
    pos = torch.full((t["right_uv"].shape[0],), -1, dtype=torch.int64)
    pos[order[:K]] = torch.arange(K)
    lo, hi = tstereo.band_segments_plain(t["left_uv"], t["left_level"], rows)
    gated = _gated_pairs(t)
    i, j = torch.nonzero(gated, as_tuple=True)
    assert len(i) > 300, case
    assert (pos[j] >= off[lo[i]]).all() and (pos[j] < off[hi[i] + 1]).all(), case
    walked = (off[hi + 1] - off[lo]).sum() / gated.numel()
    if case == "random":
        assert walked < 0.05                    # the band's buckets, not all M
    if case.startswith("band_edge"):
        # left keypoint i's twin (right 2i) on its band's farthest row
        # passes; the decoy a step past it (right 2i + 1) fails
        N, M = t["left_uv"].shape[0], t["right_uv"].shape[0]
        lefts = torch.arange(min(N - 1, (M - 2) // 2))
        twins = 2 * lefts
        assert gated[lefts, twins].all() and not gated[lefts, twins + 1].any()


def test_build_frame_stereo_matches_jax():
    gl, gr, _ = _stereo_pair(1, SCAM)
    A = jext.extract(jnp.asarray(gl), SCFG.orb, 120, 160)
    B = jext.extract(jnp.asarray(gr), SCFG.orb, 120, 160)
    ur, depth = _jax_stereo(A, B, gl, gr, SCAM)
    mask = np.ones((120, 160), np.float32)
    mask[40:80, 60:100] = 0.0
    want = jframe.build_frame_stereo(A, jnp.asarray(ur), jnp.asarray(depth),
                                     jnp.asarray(mask), SCAM)
    got = tframe.build_frame_stereo(convert.features_from_numpy(_np(A), "cpu"), _t(ur),
                                    _t(depth), _t(mask), TCFG.camera)
    for k in want._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert 0 < int(got.valid.sum()) < int(A.valid.sum())


def test_triangulate_matches_jax():
    r = np.random.default_rng(1)
    Km = np.array([[160, 0, 80], [0, 160, 60], [0, 0, 1.0]], np.float32)
    X = r.uniform([-1, -1, 2], [1, 1, 5], (200, 3)).astype(np.float32)
    T21 = np.asarray(jlie.se3_exp(jnp.asarray([0.3, 0, 0.05, 0.02, 0.05, 0], jnp.float32)))
    x1 = X @ Km.T
    x1 = x1[:, :2] / x1[:, 2:]
    x2 = (X @ T21[:3, :3].T + T21[:3, 3]) @ Km.T
    x2 = (x2[:, :2] / x2[:, 2:] + r.normal(0, 0.3, (200, 2))).astype(np.float32)
    P1, P2 = Km @ np.eye(4, dtype=np.float32)[:3], Km @ T21[:3]
    want = np.asarray(jinit.triangulate(*(jnp.asarray(a) for a in (P1, P2, x1, x2))))
    got = tinit.triangulate(*(_t(a) for a in (P1, P2, x1, x2))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _jax_bootstrap_inputs(i0: int, i1: int):
    """The JAX tracker's bootstrap inputs on frames i0 and i1 of the static
    scene: the two feature sets, best_two's good and idx."""
    A = jext.extract(jsyn.render_frame(i0, SCAM, with_dynamic=False).gray, SCFG.orb, 120, 160)
    B = jext.extract(jsyn.render_frame(i1, SCAM, with_dynamic=False).gray, SCFG.orb, 120, 160)
    D = jham.hamming_matrix(jorb.descriptors_pm1(A.desc, A.valid),
                            jorb.descriptors_pm1(B.desc, B.valid))
    best, second, idx = jham.best_two(D, axis=1)
    good = (best < 50) & (best.astype(jnp.float32) < 0.9 * second.astype(jnp.float32)) & A.valid
    return A, B, np.asarray(good), np.asarray(idx)


def _jax_init_draws(valid) -> tuple:
    """initialize's two categorical draws under PRNGKey(0), the key the JAX
    tracker gives it (initializer.py:109, :140)."""
    key = jax.random.PRNGKey(0)
    return (np.array(_jax_draw(key, valid, 200, 8)),
            np.array(_jax_draw(jax.random.fold_in(key, 1), valid, 200, 4)))


def test_initialize_matches_jax_fed_its_draws():
    """The JAX bootstrap test's pair (frames 0 and 24), fed the JAX draws:
    against the JAX function run op by op, ok and used_homography are
    equal, T_21 agrees to 1e-3 and is_good on at least 99% of the rows;
    against the jitted one ok and used_homography are equal. The jitted
    pose differs: about a quarter of the 8-point samples draw a row twice
    (with replacement), their F is whichever null vector of a rank-deficient
    system the SVD returns, and under jit one of them (hypothesis 170, row
    313 twice) outscores the best well-posed one (ROADMAP.md section 3)."""
    A, B, good, idx = _jax_bootstrap_inputs(0, 24)
    x1, x2 = np.asarray(A.uv), np.asarray(B.uv)[idx]
    K = (SCAM.fx, SCAM.fy, SCAM.cx, SCAM.cy)
    args = (jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(good), jax.random.PRNGKey(0), K)
    jitted = jinit.initialize(*args)
    want = jinit.initialize.__wrapped__(*args)       # op by op, without the outer jit
    got = tinit.initialize(_t(x1), _t(x2), _t(good), K, sample_idx=_jax_init_draws(good))
    assert bool(want.ok) and bool(got.ok) and bool(jitted.ok)
    assert bool(got.used_homography) == bool(want.used_homography) == \
        bool(jitted.used_homography)
    np.testing.assert_allclose(got.T_21.numpy(), np.asarray(want.T_21), atol=1e-3)
    assert (got.is_good.numpy() == np.asarray(want.is_good)).mean() >= 0.99
    # its own draws are the JAX package's, replayed: the same result
    own = tinit.initialize(_t(x1), _t(x2), _t(good), K)
    assert all(torch.equal(getattr(own, f), getattr(got, f)) for f in got._fields)
    assert abs(float(own.T_21[:3, 3].norm()) - 1.0) < 1e-5


def test_prng_replays_jax_random():
    """core.prng gives jax.random's keys, fold_in and bits exactly, its
    Gumbel noise to a few float32 ulps (two logs rounded by another
    library) and the categorical
    draws of the bootstrap exactly, on seeded masks of several sizes."""
    from gdslam_tpu_torch.core import prng
    key = jax.random.PRNGKey(7)
    assert tuple(int(x) for x in np.asarray(key)) == tuple(int(x) for x in prng.prng_key(7))
    k1 = prng.fold_in(prng.prng_key(7), 1)
    np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, 1)), np.asarray(k1))
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (37, 53))),
                                  prng.random_bits(prng.prng_key(7), (37, 53)))
    g = prng.gumbel(prng.prng_key(7), (200, 300))
    want = np.asarray(jax.random.gumbel(key, (200, 300)))
    np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
    r = np.random.default_rng(8)
    for seed, n, share in ((0, 384, 0.3), (3, 1500, 0.2), (11, 97, 0.9), (5, 40, 0.0)):
        valid = r.uniform(size=n) < share
        logp = torch.log(_t(valid).float() / max(int(valid.sum()), 1) + 1e-12)
        kf = jax.random.PRNGKey(seed)
        for kk, rows, key_t in ((kf, 1600, prng.prng_key(seed)),
                                (jax.random.fold_in(kf, 1), 800,
                                 prng.fold_in(prng.prng_key(seed), 1))):
            want = _jax_draw(kk, valid, rows, 1)[:, 0]
            np.testing.assert_array_equal(prng.categorical_rows(key_t, logp, rows).numpy(), want)


def test_sim3_ransac_replays_the_loop_closers_draws():
    """The loop closer's Sim3 RANSAC draws under PRNGKey(kf_id) as the JAX
    package does (loop_closing.compute_transform): with key= it equals the
    same RANSAC fed the JAX draw, on seeded correspondences with a 1.2
    scale and a quarter of outliers."""
    from gdslam_tpu_torch.backend import solvers as tsol
    from gdslam_tpu_torch.core import lie as tlie
    from gdslam_tpu_torch.core import prng
    r = np.random.default_rng(9)
    n = 120
    P = r.uniform([-1, -1, 2], [1, 1, 5], (n, 3)).astype(np.float32)
    T = tlie.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.05])).numpy()
    Q = (1.2 * P @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    Q[: n // 4] += r.normal(0, 0.5, (n // 4, 3)).astype(np.float32)
    valid = r.uniform(size=n) < 0.8
    for kf in (3, 31):
        want = tsol.ransac_sim3(_t(P), _t(Q), _t(valid), err_threshold=0.05, with_scale=True,
                                sample_idx=_t(_jax_draw(jax.random.PRNGKey(kf), valid, 300, 3)))
        got = tsol.ransac_sim3(_t(P), _t(Q), _t(valid), err_threshold=0.05, with_scale=True,
                               key=prng.prng_key(kf))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool(got[5]) and abs(float(got[2]) - 1.2) < 1e-3


def test_nanmedian_is_the_jax_midpoint():
    """Even counts take the mean of the two middle values, as jnp.nanmedian
    does (torch.nanmedian takes the lower one); odd counts, NaNs, one value
    and all NaN as well."""
    r = np.random.default_rng(2)
    cases = [r.normal(size=10), r.normal(size=11), np.array([3.0, 1.0]), np.array([2.5]),
             np.array([np.nan, np.nan]), np.r_[r.normal(size=7), [np.nan] * 5],
             np.r_[[np.nan] * 3, r.normal(size=6)]]
    for x in cases:
        x = x.astype(np.float32)
        got = ttracking.nanmedian(_t(x)).numpy()
        want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want, err_msg=str(x))
    assert ttracking.nanmedian(_t(np.array([1.0, 2.0, 7.0, 9.0], np.float32))).item() == 4.5


def _hand_matches():
    """Keypoint sets built to hit every case of the bootstrap's index rule:
    invalid first rows, invalid frame rows before and after the best,
    distances exactly 128 (ties with the invalid rows' 128), all above 128,
    and a first frame whose every candidate is invalid."""
    r = np.random.default_rng(3)
    N1, N2 = 64, 48

    def dense(n):        # bits set with probability 3/4: popcounts near 192
        return (r.integers(0, 256, (n, 32)) | r.integers(0, 256, (n, 32))).astype(np.uint8)

    d1 = r.integers(0, 256, (N1, 32)).astype(np.uint8)     # ~128 from dense rows
    d1[10:20] = dense(10)
    d2 = dense(N2)
    flips = (1 << r.integers(0, 8, (10, 32))) * (r.uniform(size=(10, 32)) < 0.05)
    d2[5:15] = d1[10:20] ^ flips.astype(np.uint8)           # good matches
    d2[21] = 0
    d2[21, :16] = 255                                        # popcount 128
    d2[22] = d2[21]                                          # a second 128
    d1[31] = 0                                               # 128 from 21, 22: a tie
    d1[30] = 0
    d1[30, 31] = 255                                         # 136 and more: above 128
    v1 = np.ones(N1, bool)
    v1[[0, 7, 40]] = False
    v2 = np.ones(N2, bool)
    v2[[3, 30, 47]] = False
    return d1, v1, d2, v2


@pytest.mark.parametrize("case", ["hand", "frames"])
def test_bootstrap_matches_and_associations_match_jax(case):
    """good and idx of every first-frame row equal the JAX package's
    best_two over descriptors_pm1 (invalid rows at distance 128), and the
    second keyframe's associations equal its `.at[idx].set(...)` with the
    last write winning."""
    if case == "hand":
        d1, v1, d2, v2 = _hand_matches()
        r = np.random.default_rng(4)
        uv1 = r.uniform(0, 160, (len(d1), 2)).astype(np.float32)
        uv2 = r.uniform(0, 160, (len(d2), 2)).astype(np.float32)
        lv1, lv2 = r.integers(0, 4, len(d1)), r.integers(0, 4, len(d2))
        # the frame's first invalid row before the tie's arg, after it, none,
        # and every candidate invalid
        late, none = np.ones_like(v2), np.ones_like(v2)
        late[[30, 47]] = False
        variants = [v2, late, none, np.zeros_like(v2)]
    else:
        A, B, _, _ = _jax_bootstrap_inputs(0, 24)
        d1, v1, uv1, lv1 = (np.asarray(x) for x in (A.desc, A.valid, A.uv, A.level))
        d2, v2, uv2, lv2 = (np.asarray(x) for x in (B.desc, B.valid, B.uv, B.level))
        variants = [v2]
    seen = set()
    for vv2 in variants:
        D = jham.hamming_matrix(jorb.descriptors_pm1(jnp.asarray(d1), jnp.asarray(v1)),
                                jorb.descriptors_pm1(jnp.asarray(d2), jnp.asarray(vv2)))
        best, second, idx_j = jham.best_two(D, axis=1)
        good_j = (best < 50) & (best.astype(jnp.float32) < 0.9 * second.astype(jnp.float32)) \
            & jnp.asarray(v1)
        good_j, idx_j, b = np.asarray(good_j), np.asarray(idx_j), np.asarray(best)
        seen |= {"tie" if x == 128 else "above" if x > 128 else "below" for x in b[v1]}
        good_t, idx_t = ttracking.bootstrap_matches(_frame(uv1, lv1, d1, v1),
                                                    _frame(uv2, lv2, d2, vv2), 4)
        np.testing.assert_array_equal(good_t.numpy(), good_j)
        np.testing.assert_array_equal(idx_t.numpy(), idx_j)
        if vv2 is v2:
            good_j0, idx_j0 = good_j, idx_j
    good_j, idx_j = good_j0, idx_j0
    if case == "hand":
        assert seen == {"tie", "above", "below"}
        assert good_j.sum() >= 5 and idx_j[~v1].tolist() == [0, 0, 0]
    # the association scatter: matched rows and their targets repeat
    r = np.random.default_rng(5)
    assoc1 = np.where(r.uniform(size=len(d1)) < 0.8, r.integers(0, 500, len(d1)), -1)
    assoc1 = assoc1.astype(np.int32)
    matched = good_j & (assoc1 >= 0) | (r.uniform(size=len(d1)) < 0.3)
    want = (-jnp.ones(len(d2), jnp.int32)).at[jnp.asarray(idx_j)].set(
        jnp.where(jnp.asarray(matched), jnp.asarray(assoc1), -1))
    got = ttracking.bootstrap_assoc(_t(assoc1), _t(matched), _t(idx_j), len(d2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _frame(uv, level, desc, valid) -> ttracking.Frame:
    n = len(uv)
    z = torch.zeros(n)
    return ttracking.Frame(uv=_t(uv), uv_raw=_t(uv), ur=-torch.ones(n), depth=z,
                           level=_t(np.asarray(level, np.int32)), angle=z, response=z,
                           desc=_t(desc), valid=_t(valid))
