"""Parity of the port's DynaSLAM geometry path (gdslam_tpu_torch.masking.
geometry and the System entry points that run it) with the JAX package's.

The units take one geometry ring DB, built by the JAX package from
rendered frames of the dynamic scene with their ground-truth poses, handed
to the port through gdslam_tpu_torch.convert: the seed, growth and
correction maps are identical at 120x160 (the full grid) and at 240x320 (the
half grid), and so is the inpainting, because the port's reprojections round
as the JAX package's compiled programs do on the CPU (masking/geometry.py,
`_fma`) and its scatters apply their updates in the JAX order.

The slices run both packages on the same 24 dynamic 120x160 frames through
track_rgbd(use_geometry=True), staged and pipelined, and the GD path with
inpainting through track_rgbd_gd(inpaint=True); the JAX runs are shared per
module.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.core import lie as jlie
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.masking import geometry as jgeo
from gdslam_tpu.system import slam as jslam
from gdslam_tpu.utils import metrics
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.core import lie as tlie
from gdslam_tpu_torch.masking import geometry as tgeo
from gdslam_tpu_torch.system import slam as tslam

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

KMAX, PMAX = 32, 16384
N_SLICE = 24
N_GD = 14


def _cfg(H: int, W: int):
    f = W / 2
    cam = CameraConfig(fx=f, fy=f, cx=W / 2, cy=H / 2, width=W, height=H, bf=f * 0.08)
    jcfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=384, n_levels=4))
    return jcfg, convert.config_from_jax_dict(dataclasses.asdict(jcfg))


SCFG, TCFG = _cfg(120, 160)


@functools.lru_cache(maxsize=None)
def _render(i: int, H: int, W: int):
    """Frame i of the dynamic scene at H x W (the _cfg camera), rendered once
    a module: the 120x160 rig, the slice and the GD frames share theirs."""
    return jsyn.render_frame(i, _cfg(H, W)[0].camera, with_dynamic=True)


def _ate(traj, seq) -> float:
    T0 = np.asarray(seq[0].T_wc)
    est = np.array([T[:3, 3] for _, T in traj])
    gt = np.array([(np.linalg.inv(T0) @ np.asarray(seq[round(ts * 30)].T_wc))[:3, 3]
                   for ts, _ in traj])
    return metrics.ate_rmse(est, gt)


# ----------------------------------------------------------------------------
# units
# ----------------------------------------------------------------------------

def test_rotm_to_euler_matches_jax():
    """Random rotations and rotations at the gimbal lock (pitch +-90 deg,
    where R[0, 0] = R[1, 0] = 0 and the singular branch takes x from the
    second row and sets z to 0), to 1e-6 rad."""
    r = np.random.default_rng(3)
    Rs = [np.asarray(jlie.so3_exp(jnp.asarray(w))) for w in r.normal(0, 1.2, (64, 3))
          .astype(np.float32)]
    for a in (0.3, -1.1, 2.0):
        for s in (1.0, -1.0):
            c, n = np.cos(a), np.sin(a)
            Rs.append(np.array([[0, s * n, s * c], [0, c, -n], [-s, 0, 0]], np.float32))
    R = np.stack(Rs).astype(np.float32)
    want = np.asarray(jlie.rotm_to_euler(jnp.asarray(R)))
    got = tlie.rotm_to_euler(torch.from_numpy(R)).numpy()
    sing = np.sqrt(R[:, 0, 0] ** 2 + R[:, 1, 0] ** 2) < 1e-6
    assert sing.sum() == 6 and (got[sing, 2] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [5, 11, 21, 41])
def test_min_pool_and_box_mean_match_jax(size):
    """_min_pool (zeros ignored, +inf outside) and _box_mean (edge padding,
    the JAX summation order) exactly, on depth with holes."""
    r = np.random.default_rng(size)
    x = r.uniform(0.4, 4.0, (60, 80)).astype(np.float32)
    x[r.random((60, 80)) < 0.3] = 0.0
    x[:15, :20] = 0.0                   # a window with no valid depth -> 0
    np.testing.assert_array_equal(tgeo._min_pool(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jgeo._min_pool(jnp.asarray(x), size)))
    np.testing.assert_array_equal(tgeo._box_mean(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jgeo._box_mean(jnp.asarray(x), size)))


def test_db_insert_matches_jax():
    """Ring insertion past the DB's size wraps around, exactly as the JAX
    package's, and leaves the DB it was given as it was."""
    r = np.random.default_rng(1)
    H, W, D = 6, 8, 3
    jdb = jgeo.new_db(D, H, W)
    tdb = tgeo.new_db(D, H, W, device="cpu")
    for k in range(5):
        g, d, m = (r.random((H, W)).astype(np.float32) for _ in range(3))
        rgb = r.random((H, W, 3)).astype(np.float32)
        T = np.asarray(jlie.se3_exp(jnp.asarray(r.normal(0, 0.3, 6).astype(np.float32))))
        jdb = jgeo.db_insert(jdb, g, d, m, rgb, jnp.asarray(T))
        before = convert.geometry_db_to_numpy(tdb)
        tdb2 = tgeo.db_insert(tdb, *(torch.from_numpy(a.copy()) for a in (g, d, m, rgb, T)))
        for key, v in convert.geometry_db_to_numpy(tdb).items():
            np.testing.assert_array_equal(v, before[key])
        tdb = tdb2
        got = convert.geometry_db_to_numpy(tdb)
        for key in tgeo.GeometryDB._fields:
            np.testing.assert_array_equal(got[key], np.asarray(getattr(jdb, key)), err_msg=key)
    assert int(got["cursor"]) == 5 and got["valid"].all()


def _rig(H: int, W: int):
    """A ring DB of 8 frames of the dynamic scene (every 4th frame, with the
    ground-truth poses relative to frame 0 and the sphere masked out), and
    the current frame, frame 38."""
    jcfg, tcfg = _cfg(H, W)
    db = jgeo.new_db(jcfg.geometry.max_db_size, H, W)
    frames = [_render(i, H, W) for i in (0, 4, 8, 12, 16, 20, 24, 28, 38)]
    T0_inv = np.linalg.inv(np.asarray(frames[0].T_wc))

    def T_cw(fr):
        return np.linalg.inv(T0_inv @ np.asarray(fr.T_wc)).astype(np.float32)

    for fr in frames[:-1]:
        static = 1.0 - np.asarray(fr.dyn_mask, np.float32)
        db = jgeo.db_insert(db, fr.gray, fr.depth, static, fr.rgb, jnp.asarray(T_cw(fr)))
    cur = frames[-1]
    return dict(jcfg=jcfg, tcfg=tcfg, jdb=db,
                tdb=convert.geometry_db_from_numpy(
                    {k: np.asarray(v) for k, v in db._asdict().items()}, "cpu"),
                depth=np.array(cur.depth), rgb=np.array(cur.rgb), T=T_cw(cur),
                dyn=np.array(cur.dyn_mask))


@pytest.fixture(scope="module", params=[(120, 160), (240, 320)], ids=["full_grid", "half_grid"])
def rig(request):
    return _rig(*request.param)


def test_seeds_growth_and_correction_match_jax(rig):
    """extract_dynamic_seeds, depth_region_growing (on the same seeds) and
    correction_dynamic_mask (the full grid below 240 rows, the half grid at
    240) give identical maps, and the correction flags a region (in this
    rig not the sphere: the 41x41-equivalent flatness gate rejects its
    curved surface, in both packages)."""
    d_j, d_t = jnp.asarray(rig["depth"]), torch.from_numpy(rig["depth"])
    T_j, T_t = jnp.asarray(rig["T"]), torch.from_numpy(rig["T"])
    seeds_j = np.asarray(jgeo.extract_dynamic_seeds(rig["jdb"], d_j, T_j, rig["jcfg"]))
    seeds_t = tgeo.extract_dynamic_seeds(rig["tdb"], d_t, T_t, rig["tcfg"]).numpy()
    assert seeds_j.sum() > 50
    np.testing.assert_array_equal(seeds_t, seeds_j)
    grown_j = np.asarray(jgeo.depth_region_growing(jnp.asarray(seeds_j), d_j, 0.2, 16, 4))
    grown_t = tgeo.depth_region_growing(torch.from_numpy(seeds_j), d_t, 0.2, 16, 4).numpy()
    np.testing.assert_array_equal(grown_t, grown_j)
    corr_j = np.asarray(jgeo.correction_dynamic_mask(rig["jdb"], d_j, T_j, rig["jcfg"]))
    corr_t = tgeo.correction_dynamic_mask(rig["tdb"], d_t, T_t, rig["tcfg"]).numpy()
    assert corr_t.shape == rig["depth"].shape
    np.testing.assert_array_equal(corr_t, corr_j)
    assert corr_t.sum() > 0.05 * corr_t.size
    static = np.ones_like(rig["depth"])
    np.testing.assert_array_equal(
        tgeo.combine_masks(torch.from_numpy(static), torch.from_numpy(corr_t)).numpy(),
        np.asarray(jgeo.combine_masks(jnp.asarray(static), jnp.asarray(corr_j))))


def test_inpaint_matches_jax(rig):
    """inpaint with the correction's hole: the same pixels are filled, RGB
    agrees to 1e-3 (0-255 scale) and depth to 1e-5 m (on the CPU both
    accumulate in the same order and agree bit for bit), and most of the
    hole is filled from the DB."""
    hole = rig["dyn"]
    mask = (~hole).astype(np.float32)
    rj, dj = jgeo.inpaint(rig["jdb"], jnp.asarray(rig["rgb"]), jnp.asarray(rig["depth"]),
                          jnp.asarray(mask), jnp.asarray(rig["T"]), rig["jcfg"])
    rt, dt = tgeo.inpaint(rig["tdb"], torch.from_numpy(rig["rgb"]),
                          torch.from_numpy(rig["depth"]), torch.from_numpy(mask),
                          torch.from_numpy(rig["T"]), rig["tcfg"])
    rj, dj, rt, dt = np.asarray(rj), np.asarray(dj), rt.numpy(), dt.numpy()
    filled_j = (dj != rig["depth"]) | (rj != rig["rgb"]).any(-1)
    filled_t = (dt != rig["depth"]) | (rt != rig["rgb"]).any(-1)
    np.testing.assert_array_equal(filled_t, filled_j)
    assert filled_t.sum() > 0.8 * hole.sum() and not (filled_t & ~hole).any()
    np.testing.assert_allclose(rt, rj, atol=1e-3, rtol=0)
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)


def test_geometry_wrapper_gates_on_the_host_count():
    """Geometry.geometric_model_correction passes the semantic mask through
    while nothing is inserted (no read of the card), and update_db inserts
    only keyframes."""
    g = tgeo.Geometry(TCFG, device="cpu")
    sem = torch.ones(120, 160)
    assert g.geometric_model_correction(None, None, sem) is sem
    z = torch.zeros(120, 160)
    g.update_db(z, z, sem, torch.zeros(120, 160, 3), torch.eye(4), is_keyframe=False)
    assert g.inserted == 0 and int(g.db.cursor) == 0
    g.update_db(z, z, sem, torch.zeros(120, 160, 3), torch.eye(4), is_keyframe=True)
    assert g.inserted == 1 and bool(g.db.valid[0])


# ----------------------------------------------------------------------------
# slices
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    return [_render(i, 120, 160) for i in range(N_SLICE)]


def _jax_geometry_run(seq, pipeline: bool):
    """The JAX System over the frames on the geometry path. Staged, the run
    goes through track_rgbd_geom, whose tracking is track_rgbd(
    use_geometry=True)'s (the same body, then inpainting, which changes no
    tracker state), so one run serves the slice and the inpainted outputs."""
    s = jslam.System(SCFG, kmax=KMAX, pmax=PMAX, pipeline=pipeline)
    masks, outs = [], []
    for i, fr in enumerate(seq):
        rgb, depth = np.asarray(fr.rgb), np.asarray(fr.depth)
        if pipeline:
            s.track_rgbd(rgb, depth, None, i / 30.0, use_geometry=True)
        else:
            outs.append(s.track_rgbd_geom(rgb, depth, None, i / 30.0)[1:])
        masks.append(np.asarray(s._last_refined_mask))
    s.shutdown()
    return dict(tracker=s.tracker, masks=masks, outs=outs, inserts=s._geo_db_count)


@pytest.fixture(scope="module")
def jax_staged(seq):
    return _jax_geometry_run(seq, False)


@pytest.fixture(scope="module")
def jax_pipelined(seq):
    return _jax_geometry_run(seq, True)


def _port_geometry_run(seq, pipeline: bool, geom: bool = False):
    s = tslam.System(TCFG, kmax=KMAX, pmax=PMAX, pipeline=pipeline, device="cpu")
    masks, outs = [], []
    for i, fr in enumerate(seq):
        rgb, depth = np.asarray(fr.rgb), np.asarray(fr.depth)
        if geom:
            out = s.track_rgbd_geom(rgb, depth, None, i / 30.0)
            assert all(isinstance(o, torch.Tensor) for o in out[1:])
            outs.append(tuple(o.numpy() for o in out[1:]))
        else:
            T = s.track_rgbd(rgb, depth, None, i / 30.0, use_geometry=True)
            assert np.isfinite(np.asarray(T)).all()
        masks.append(s._last_refined_mask.numpy())
    s.shutdown()
    return s, masks, outs


@pytest.mark.parametrize("mode", ["staged", "pipelined"])
def test_geometry_slice_matches_jax(seq, jax_staged, jax_pipelined, mode):
    """track_rgbd(use_geometry=True) over 24 dynamic frames in both packages:
    both OK, the same keyframe timestamps and DB inserts, refined masks
    agreeing on >= 99.5% of the pixels of every frame (identical here), and
    the correction active (on the last frame it flags more than a tenth of
    the sphere, the JAX package's own test, tests/test_geometry_path.py). Staged,
    every pose agrees to 1e-3 m. Pipelined, the relative poses of the
    records agree to 1e-3 and the trajectories on every frame that both
    packages pair with the same keyframe (the JAX package pairs a frame
    committed after a keyframe of the same flush with the new keyframe,
    ROADMAP.md section 3), as test_torch_tracking.py::test_slice_matches_jax
    compares them; the port's ATE is then no worse."""
    pipelined = mode == "pipelined"
    ref = jax_pipelined if pipelined else jax_staged
    s, masks, _ = _port_geometry_run(seq, pipelined)
    tr_t, tr_j = s.tracker, ref["tracker"]
    assert tr_t.state.name == tr_j.state.name == "OK" and not tr_t._pending
    assert tr_t.kf_timestamps == tr_j.kf_timestamps and len(tr_t.kf_timestamps) >= 3
    assert s._geometry.inserted == ref["inserts"] >= 3
    for m_t, m_j in zip(masks, ref["masks"]):
        assert (m_t == m_j).mean() >= 0.995
    dyn = np.asarray(seq[-1].dyn_mask)
    assert ((masks[-1] < 0.5) & dyn).sum() > 0.1 * dyn.sum()
    traj_t, traj_j = tr_t.camera_trajectory(), tr_j.camera_trajectory()
    assert len(traj_t) == len(traj_j) == N_SLICE
    Ts_t, Ts_j = np.stack([T for _, T in traj_t]), np.stack([T for _, T in traj_j])
    if not pipelined:
        np.testing.assert_allclose(Ts_t, Ts_j, atol=1e-3)
        assert abs(_ate(traj_t, seq) - _ate(traj_j, seq)) < 1e-4
        return
    rec_t, rec_j = tr_t.records, tr_j.records
    np.testing.assert_allclose(torch.stack([r[2] for r in rec_t]).numpy(),
                               np.stack([np.asarray(r[2]) for r in rec_j]), atol=1e-3)
    same_ref = np.array([a[1] == b[1] for a, b in zip(rec_t, rec_j)])
    assert (~same_ref).sum() <= 2 * (len(tr_t.kf_timestamps) - 1)
    np.testing.assert_allclose(Ts_t[same_ref], Ts_j[same_ref], atol=1e-3)
    assert _ate(traj_t, seq) <= _ate(traj_j, seq) + 1e-4


def test_track_rgbd_geom_matches_jax(seq, jax_staged):
    """track_rgbd_geom's outputs (inpainted rgb and depth, refined mask) as
    tensors, against the JAX package's on the same frames: the same masks;
    the filled pixels the same on >= 99.9% of the pixels and RGB within 0.1
    grey levels on 99.9% of the pixels both fill (poses differ by ~1e-6 m
    and move the area weights); where the mask removed depth and the DB has
    a view, the JAX test's rule (tests/test_geometry_path.py) holds."""
    s, masks, outs = _port_geometry_run(seq, False, geom=True)
    for i, ((rgb_t, d_t, m_t), (rgb_j, d_j, m_j)) in enumerate(zip(outs, jax_staged["outs"])):
        rgb_j, d_j, m_j = np.asarray(rgb_j), np.asarray(d_j), np.asarray(m_j)
        assert rgb_t.shape == (120, 160, 3) and d_t.shape == m_t.shape == (120, 160)
        np.testing.assert_array_equal(m_t, m_j)
        rgb_in, d_in = np.asarray(seq[i].rgb), np.asarray(seq[i].depth)
        fill_t = (d_t != d_in) | (rgb_t != rgb_in).any(-1)
        fill_j = (d_j != d_in) | (rgb_j != rgb_in).any(-1)
        assert (fill_t == fill_j).mean() >= 0.999
        both = fill_t & fill_j
        if both.any():
            assert np.quantile(np.abs(rgb_t - rgb_j)[both].max(-1), 0.999) < 0.1
        hole = m_t < 0.5
        if hole.any() and i >= 2:
            assert ((d_in[hole] == 0) | (d_t[hole] > 0)).mean() > 0.5
    assert s._geometry.inserted == jax_staged["inserts"]


@pytest.fixture(scope="module")
def gd_frames():
    """The CLI's inputs of the GD + inpainting mode: uint8 rgb, uint16 depth
    and the cached semantic mask (the sphere, 1 = static)."""
    seq = [_render(i, 120, 160) for i in range(N_GD)]
    return seq, [(np.asarray(f.rgb).astype(np.uint8), (np.asarray(f.depth) * 5000).astype(
        np.uint16), 1.0 - np.asarray(f.dyn_mask, np.float32)) for f in seq]


def _gd_inpaint_run(module, system, cfg, raw, **kw):
    """track_rgbd_gd(inpaint=True) over the frames, pipelined as the CLI
    runs it; records the keyframe flag of every update_db call."""
    flags = []
    real = module.Geometry.update_db

    def update_db(self, *a, is_keyframe):
        flags.append(is_keyframe)
        return real(self, *a, is_keyframe=is_keyframe)

    module.Geometry.update_db = update_db
    try:
        s = system(cfg, kmax=KMAX, pmax=PMAX, pipeline=True, **kw)
        outs = [s.track_rgbd_gd(rgb, d, m, i / 30.0, inpaint=True)
                for i, (rgb, d, m) in enumerate(raw)]
        s.shutdown()
    finally:
        module.Geometry.update_db = real
    return s, outs, [i for i, f in enumerate(flags) if f]


@pytest.fixture(scope="module")
def jax_gd_inpaint(gd_frames):
    s, outs, inserted = _gd_inpaint_run(jgeo, jslam.System, SCFG, gd_frames[1])
    return dict(system=s, outs=[tuple(np.asarray(o) for o in out) for out in outs],
                inserted=inserted)


def test_gd_inpaint_matches_jax(gd_frames, jax_gd_inpaint):
    """track_rgbd_gd(inpaint=True), pipelined with cached semantic masks (the
    CLI's output-directory mode), in both packages: the refined masks agree
    to IoU > 0.95 per frame (the GD mask is statistical: the RANSAC draws
    differ, tests/test_torch_gd.py), the DB receives the same frames (by the
    JAX package's rule, which is not the keyframes: the next test), and the
    outputs, tensors on the device, agree: the in-flight poses to 1e-3 m
    (after a local BA the map agrees to that, ROADMAP.md section 3), the
    filled pixels on >= 99.9% of the image, and where both fill the median
    RGB difference is below 1 grey level (the pose moves the area weights)."""
    seq, raw = gd_frames
    s, outs, inserted = _gd_inpaint_run(tgeo, tslam.System, TCFG, raw, device="cpu")
    assert s.tracking_state.name == jax_gd_inpaint["system"].tracking_state.name == "OK"
    assert inserted == jax_gd_inpaint["inserted"]
    for (T_t, m_t, rgb_t, d_t), (T_j, m_j, rgb_j, d_j), (rgb, d, _) in zip(
            outs, jax_gd_inpaint["outs"], raw):
        assert all(isinstance(o, torch.Tensor) for o in (m_t, rgb_t, d_t))
        np.testing.assert_allclose(np.asarray(T_t), T_j, atol=1e-3)
        m_t, rgb_t, d_t = m_t.numpy(), rgb_t.numpy(), d_t.numpy()
        dyn_t, dyn_j = m_t < 0.5, m_j < 0.5
        assert (dyn_t & dyn_j).sum() > 0.95 * (dyn_t | dyn_j).sum()
        fill_t = (rgb_t != rgb).any(-1)
        fill_j = (rgb_j != rgb).any(-1)
        assert (fill_t == fill_j).mean() >= 0.999
        both = fill_t & fill_j
        if both.any():
            assert np.median(np.abs(rgb_t - rgb_j)[both]) < 1.0
    assert len(inserted) >= 3


def test_gd_inpaint_db_inserts_follow_the_reference_rule(gd_frames, jax_gd_inpaint):
    """The reference behaviour the port reproduces (ROADMAP.md section 3): on
    the GD + inpainting route the JAX package inserts a frame into the ring
    DB when `frames_since_kf == 0`, which a pipelined tracker updates only at
    its commits. So every frame between a flush whose last commit made a
    keyframe and the next flush is inserted, with its in-flight pose, and a
    keyframe committed before another frame of its flush would be missed.
    Both packages insert the same frames (the test above), and here those
    include frames that are not keyframes."""
    s = jax_gd_inpaint["system"]
    keyframes = [round(t * 30) for t in s.tracker.kf_timestamps]
    inserted = jax_gd_inpaint["inserted"]
    assert inserted != keyframes
    assert set(inserted) - set(keyframes)            # non-keyframes inserted
    assert s._geometry.db.cursor == len(inserted)
