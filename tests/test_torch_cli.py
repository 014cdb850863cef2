"""The port's CLIs and their I/O against the JAX package's: the PNG
module against PIL, the TUM loaders, the mask-cache protocol, and
gdslam_tpu_torch.cli.{rgbd_tum, evaluate} run with --device cpu on a
16-frame 120x160 TUM-layout sequence of the dynamic scene, held to the gates
of tests/test_cli_e2e.py and, for the geometry mode, to the JAX package's
evaluate on the same sequence."""

import contextlib
import io
import json
import os
import struct
import warnings
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gdslam_tpu.config import CameraConfig
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.io import tum as jtum
from gdslam_tpu.masking import masknet as jmasknet
from gdslam_tpu.system import trajectory as jtraj
from gdslam_tpu_torch.io import native_loader, png
from gdslam_tpu_torch.io import tum as ttum
from gdslam_tpu_torch.masking import masknet as tmasknet
from gdslam_tpu_torch.system import trajectory as ttraj
from gdslam_tpu_torch.utils import metrics as tmetrics

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
N_FRAMES = 16
T_EPOCH = 1305031790.0

SETTINGS_YAML = """%YAML:1.0
Camera.fx: 160.0
Camera.fy: 160.0
Camera.cx: 80.0
Camera.cy: 60.0
Camera.width: 160
Camera.height: 120
Camera.fps: 30.0
Camera.bf: 12.8
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 384
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""


# ----------------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------------

def _image(mode: str, content: str, H: int = 48, W: int = 64) -> np.ndarray:
    r = np.random.default_rng(len(mode) + len(content))
    yy, xx = np.mgrid[:H, :W]
    if content == "smooth":
        base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    else:
        base = r.integers(0, 256, (H, W))
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    planes = [np.roll(base, 3 * c, axis=1) for c in range(ch)]
    a = np.stack(planes, -1) if ch > 1 else planes[0]
    if mode == "I;16":
        return (a * 251 + r.integers(0, 7, a.shape)).astype(np.uint16)
    return a.astype(np.uint8)


def _filters_of(data: bytes) -> set:
    """The row filter types in a PNG's image data."""
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            W, H, bits, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    bpp = {0: 1, 4: 2, 2: 3, 6: 4}[ctype] * bits // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * bpp)
    return set(raw[:, 0].tolist())


def _encode_with_filters(a: np.ndarray) -> bytes:
    """A PNG of `a` whose rows cycle through the five filter types (0 none,
    1 sub, 2 up, 3 average, 4 Paeth), encoded here the slow, plain way."""
    a3 = a[..., None] if a.ndim == 2 else a
    H, W, ch = a3.shape
    bits = 8 * a.dtype.itemsize
    rows = np.ascontiguousarray(a3.astype(">u2") if bits == 16 else a3).view(np.uint8)
    rows = rows.reshape(H, -1).astype(np.int32)
    bpp = ch * bits // 8
    out = []
    for y in range(H):
        t = y % 5
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, bits, ctype,
                                                             0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


MODES = ["L", "LA", "RGB", "RGBA", "I;16"]


@pytest.mark.parametrize("mode", MODES)
def test_png_reads_what_pil_writes(tmp_path, mode):
    """Files PIL writes (its adaptive row filters), smooth and noisy: the
    same array as PIL reads."""
    seen = set()
    for content in ("smooth", "noise"):
        a = _image(mode, content)
        p = tmp_path / f"{content}.png"
        Image.fromarray(a).save(p)
        seen |= _filters_of(p.read_bytes())
        got = png.read(p)
        want = np.asarray(Image.open(p))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, a)
    assert len(seen) >= 2


@pytest.mark.parametrize("mode", MODES)
def test_png_all_five_filters_and_round_trip(tmp_path, mode):
    """Rows with each of the five filter types (PIL emits some of them only),
    read as PIL reads them; png.write's files (filter 0) read back the same
    in PIL and in png.read."""
    a = _image(mode, "smooth")
    p = tmp_path / "filters.png"
    p.write_bytes(_encode_with_filters(a))
    assert _filters_of(p.read_bytes()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(Image.open(p)), a)
    np.testing.assert_array_equal(png.read(p), a)
    q = tmp_path / "ours.png"
    png.write(q, a)
    assert _filters_of(q.read_bytes()) == {0}
    np.testing.assert_array_equal(np.asarray(Image.open(q)), a)
    np.testing.assert_array_equal(png.read(q), a)


def test_png_refuses_what_it_cannot_read(tmp_path):
    p = tmp_path / "p.png"
    Image.fromarray(_image("L", "smooth")).convert("P").save(p)
    with pytest.raises(ValueError, match="colour type 3"):
        png.read(p)
    with pytest.raises(ValueError, match="float32"):
        png.write(tmp_path / "f.png", np.zeros((4, 4), np.float32))


# ----------------------------------------------------------------------------
# the TUM-layout sequence
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tum_seq(tmp_path_factory):
    """A TUM-layout directory (rgb/, depth/, masks/ as PNGs named by epoch
    timestamp, assoc.txt, groundtruth.txt, settings.yaml) written by PIL, as
    a camera's tools write it; the mask cache holds the renderer's sphere."""
    root = tmp_path_factory.mktemp("tum_seq")
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(root / sub)
    assoc, gts = [], []
    for i in range(N_FRAMES):
        fr = jsyn.render_frame(i, SCAM, with_dynamic=True)
        ts = T_EPOCH + i / 30.0
        name = f"{ts:.6f}.png"
        Image.fromarray(np.asarray(fr.rgb).astype(np.uint8)).save(root / "rgb" / name)
        Image.fromarray((np.asarray(fr.depth) * 5000.0).astype(np.uint16)).save(
            root / "depth" / name)
        Image.fromarray((np.asarray(fr.dyn_mask) * 255).astype(np.uint8)).save(
            root / "masks" / name)
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        gts.append(np.asarray(fr.T_wc))
    (root / "assoc.txt").write_text("# rgb depth\n" + "\n".join(assoc) + "\n")
    (root / "settings.yaml").write_text(SETTINGS_YAML)
    jtraj.save_tum(str(root / "groundtruth.txt"),
                   [(T_EPOCH + i / 30.0, gts[i]) for i in range(N_FRAMES)])
    return str(root), gts


def _paths(seq_dir):
    return (seq_dir, os.path.join(seq_dir, "assoc.txt"), os.path.join(seq_dir, "groundtruth.txt"),
            os.path.join(seq_dir, "settings.yaml"), os.path.join(seq_dir, "masks"))


def test_loaders_match_jax(tum_seq):
    """load_associations and TumSequence equal the JAX package's (float64
    epoch timestamps, float32 rgb and metres); the native loader yields the
    same frames as uint8 / uint16."""
    seq_dir, _ = tum_seq
    _, assoc, gt, _, _ = _paths(seq_dir)
    assert ttum.load_associations(assoc) == [ttum.Association(a.timestamp, a.rgb_path,
                                                              a.depth_path)
                                             for a in jtum.load_associations(assoc)]
    ts_seq, js_seq = ttum.TumSequence(seq_dir, assoc), jtum.TumSequence(seq_dir, assoc)
    assert len(ts_seq) == len(js_seq) == N_FRAMES
    for i in (0, 7, N_FRAMES - 1):
        (rt, dt, tt), (rj, dj, tj) = ts_seq[i], js_seq[i]
        assert tt == tj == float(f"{T_EPOCH + i / 30.0:.6f}") and isinstance(tt, float)
        assert rt.dtype == rj.dtype == np.float32 and dt.dtype == dj.dtype == np.float32
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(dt, dj)
    assert native_loader.available()
    nat = native_loader.NativeTumSequence(seq_dir, assoc, 5000.0, 160, 120, raw=True)
    frames = list(nat)
    nat.close()
    assert len(frames) == N_FRAMES
    for i, (rgb, d16, ts) in enumerate(frames):
        r_ref, d_ref, t_ref = ts_seq[i]
        assert rgb.dtype == np.uint8 and d16.dtype == np.uint16 and ts == t_ref
        np.testing.assert_array_equal(rgb.astype(np.float32), r_ref)
        np.testing.assert_array_equal(d16.astype(np.float32) * np.float32(1 / 5000.0), d_ref)
    for (a, A), (b, B) in zip(ttraj.load_tum(gt), jtraj.load_tum(gt)):
        assert a == b
        np.testing.assert_array_equal(A, B)


class _Seg:
    """A stand-in segmenter: the left half of the image is dynamic."""

    image_hw = (120, 160)

    def __init__(self):
        self.calls = 0

    def __call__(self, rgb):
        self.calls += 1
        m = np.zeros(rgb.shape[:2], np.float32)
        m[:, : rgb.shape[1] // 2] = 1.0
        return m


def test_segment_dyn_object_cache_protocol(tum_seq, tmp_path):
    """A cache hit is read (as the JAX package reads it); a miss without a
    segmenter warns once and returns all-static; a miss with one runs it
    and writes the mask back, except with no_save; labels are the connected
    components, as in the JAX package."""
    seq_dir, _ = tum_seq
    rgb = np.zeros((120, 160, 3), np.float32)
    name = f"{T_EPOCH + 3 / 30.0:.6f}"
    t_hit = tmasknet.SegmentDynObject(None, os.path.join(seq_dir, "masks"))
    j_hit = jmasknet.SegmentDynObject(None, os.path.join(seq_dir, "masks"))
    np.testing.assert_array_equal(t_hit.get_segmentation(rgb, name),
                                  j_hit.get_segmentation(rgb, name))
    assert t_hit.get_segmentation(rgb, name).sum() > 100
    m_t, lab_t = t_hit.get_segmentation_label(rgb, name)
    m_j, lab_j = j_hit.get_segmentation_label(rgb, name)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert lab_t.max() >= 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        miss = tmasknet.SegmentDynObject(None, str(tmp_path / "empty"))
        assert not miss.get_segmentation(rgb, "nothing").any()
        miss.get_segmentation(rgb, "nothing else")
    assert sum("cache miss" in str(w.message) for w in caught) == 1
    seg = _Seg()
    cache = tmasknet.SegmentDynObject(seg, str(tmp_path / "cache"))
    assert seg.calls == 1                       # the warm-up
    m = cache.get_segmentation(rgb, "a")
    assert seg.calls == 2 and m[:, :80].all() and not m[:, 80:].any()
    np.testing.assert_array_equal(png.read(tmp_path / "cache" / "a.png"), m * 255)
    np.testing.assert_array_equal(cache.get_segmentation(rgb, "a"), m)   # now a hit
    assert seg.calls == 2
    ro = tmasknet.SegmentDynObject(seg, tmasknet.NO_SAVE)
    ro.get_segmentation(rgb, "b")
    assert seg.calls == 4 and not os.path.exists(tmasknet.NO_SAVE)


# ----------------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------------

def _traj_ate(path, gts):
    rows = [r.split() for r in open(path).read().strip().splitlines()]
    assert all(len(r) == 8 for r in rows)
    est, gtp = [], []
    for r in rows:
        i = int(round((float(r[0]) - T_EPOCH) * 30.0))
        est.append([float(x) for x in r[1:4]])
        gtp.append((np.linalg.inv(gts[0]) @ gts[i])[:3, 3])
    return tmetrics.ate_rmse(np.asarray(est), np.asarray(gtp)), len(rows)


@pytest.mark.parametrize("mode", ["plain", "geometry", "gd_inpaint"])
def test_rgbd_tum_modes(tum_seq, tmp_path, monkeypatch, capsys, mode):
    """rgbd_tum's three modes on the CPU: plain (ATE < 0.30 m, the unmasked
    gate), the mask cache, which runs the geometry path (ATE < 0.08 m), and
    the output directory, GD masking with inpainting (ATE < 0.15 m, the GD
    gate; rgb/, depth/, mask/ PNGs for every frame that read back). The
    trajectory files parse; the first keyframe keeps its epoch timestamp to
    within 2 s; the CLI names its loader."""
    from gdslam_tpu_torch.cli import rgbd_tum
    seq_dir, gts = tum_seq
    _, assoc, _, settings, masks = _paths(seq_dir)
    monkeypatch.chdir(tmp_path)
    args = ["none", settings, seq_dir, assoc, "--device", "cpu"]
    if mode != "plain":
        args.append(masks)
    if mode == "gd_inpaint":
        args.append(str(tmp_path / "out"))
    assert rgbd_tum.main(args) == 0
    out = capsys.readouterr().out
    assert "(native loader)" in out and "median tracking time" in out
    ate, n = _traj_ate("CameraTrajectory.txt", gts)
    assert n >= N_FRAMES - 3
    assert ate < {"plain": 0.30, "geometry": 0.08, "gd_inpaint": 0.15}[mode], ate
    kf_rows = open("KeyFrameTrajectory.txt").read().strip().splitlines()
    assert len(kf_rows) >= 1 and abs(float(kf_rows[0].split()[0]) - T_EPOCH) < 2.0
    if mode == "gd_inpaint":
        names = sorted(os.listdir(tmp_path / "out" / "rgb"))
        assert len(names) == N_FRAMES
        for sub, shape, dtype in (("rgb", (120, 160, 3), np.uint8), ("depth", (120, 160),
                                                                     np.uint16),
                                  ("mask", (120, 160), np.uint8)):
            img = png.read(tmp_path / "out" / sub / names[-1])
            assert img.shape == shape and img.dtype == dtype
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / sub /
                                                                names[-1])), img)
        mask = png.read(tmp_path / "out" / "mask" / names[-1])
        assert (mask == 0).sum() > 100        # the masked sphere


def _run_evaluate(module, seq_dir, mode, extra=()):
    _, assoc, gt, settings, masks = _paths(seq_dir)
    rc = module.main([seq_dir, assoc, gt, "--mode", mode, "--settings", settings,
                      "--masks", masks, "--rpe-delta", "5", *extra])
    assert rc == 0


def _evaluate(module, seq_dir, mode, capsys, extra=()):
    _run_evaluate(module, seq_dir, mode, extra)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _eval_extra(seq_dir, mode):
    return ("--device", "cpu") + (("--ref-masks", _paths(seq_dir)[4]) if mode != "plain"
                                  else ())


@pytest.fixture(scope="module")
def port_geometry_eval(tum_seq, tmp_path_factory):
    """The port's `evaluate --mode geometry` on the sequence, run once for
    the two tests that read it (test_evaluate_modes[geometry] and
    test_evaluate_geometry_matches_jax; --ref-masks only reads the cached
    masks after each frame, so the tracking is the run's without it): its
    JSON record and the System it built."""
    from gdslam_tpu_torch.cli import evaluate
    from gdslam_tpu_torch.system import slam as tslam
    seq_dir, _ = tum_seq
    made, real, cwd = [], tslam.System, os.getcwd()

    def build(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    out = io.StringIO()
    os.chdir(tmp_path_factory.mktemp("evaluate_geometry"))
    tslam.System = build
    try:
        with contextlib.redirect_stdout(out):
            _run_evaluate(evaluate, seq_dir, "geometry", _eval_extra(seq_dir, "geometry"))
    finally:
        tslam.System = real
        os.chdir(cwd)
    return json.loads(out.getvalue().strip().splitlines()[-1]), made[0]


@pytest.mark.parametrize("mode,gate", [("plain", 0.30), ("geometry", 0.08), ("gd", 0.15)])
def test_evaluate_modes(tum_seq, tmp_path, monkeypatch, capsys, request, mode, gate):
    """evaluate's three modes on the CPU with the JAX CLI tests' gates;
    the last line is the JSON record with the JAX package's fields; in the
    masked modes --ref-masks reports the mask IoU against the cached masks
    (the refined masks contain the semantic prior: IoU > 0.5). The geometry
    run is the module's (port_geometry_eval)."""
    from gdslam_tpu_torch.cli import evaluate
    seq_dir, _ = tum_seq
    monkeypatch.chdir(tmp_path)
    if mode == "geometry":
        rec = request.getfixturevalue("port_geometry_eval")[0]
    else:
        rec = _evaluate(evaluate, seq_dir, mode, capsys, _eval_extra(seq_dir, mode))
    assert {"mode", "frames", "tracked", "associated", "ate_rmse_m", "rpe_rmse_m",
            "keyframes"} <= set(rec)
    assert rec["mode"] == mode and rec["frames"] == N_FRAMES
    assert rec["associated"] >= N_FRAMES - 4
    assert rec["ate_rmse_m"] < gate and rec["rpe_rmse_m"] < 0.5, rec
    if mode != "plain":
        assert rec["mask_iou"] > 0.5, rec


def _capture_systems(monkeypatch, module) -> list:
    """Record the System instances that `module.System(...)` builds."""
    made, real = [], module.System

    def build(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(module, "System", build)
    return made


def test_evaluate_geometry_matches_jax(tum_seq, port_geometry_eval, tmp_path, monkeypatch,
                                       capsys):
    """The two packages' `evaluate --mode geometry` on the same sequence
    (pipelined, the semantic prior from the mask cache; the port's run is
    the module's, port_geometry_eval): the same frames tracked and
    associated, the same keyframes. evaluate runs the tracker
    pipelined, and the JAX package then pairs a frame committed after a
    keyframe of the same flush with the new keyframe although its pose is
    relative to the old one (ROADMAP.md section 3), which the port does not reproduce. So the JSON lines' ATEs
    differ by that fault, and on every frame both pair with the same
    keyframe the trajectories agree to 1e-3 m and their ATEs to 1e-3 m."""
    from gdslam_tpu.cli import evaluate as jevaluate
    from gdslam_tpu.system import slam as jslam
    seq_dir, gts = tum_seq
    monkeypatch.chdir(tmp_path)
    made_j = _capture_systems(monkeypatch, jslam)
    rec_j = _evaluate(jevaluate, seq_dir, "geometry", capsys)
    rec_t, slam_t = port_geometry_eval
    for key in ("frames", "tracked", "associated", "keyframes"):
        assert rec_t[key] == rec_j[key], key
    tr_j, tr_t = made_j[0].tracker, slam_t.tracker
    assert tr_t.kf_timestamps == tr_j.kf_timestamps
    same_ref = np.array([a[1] == b[1] for a, b in zip(tr_t.records, tr_j.records)])
    assert (~same_ref).sum() <= 2 * (len(tr_t.kf_timestamps) - 1)
    Ts_t = np.stack([T for _, T in tr_t.camera_trajectory()])
    Ts_j = np.stack([T for _, T in tr_j.camera_trajectory()])
    np.testing.assert_allclose(Ts_t[same_ref], Ts_j[same_ref], atol=1e-3)
    gt = np.stack([(np.linalg.inv(gts[0]) @ g)[:3, 3] for g in gts])[same_ref]
    ate_t = tmetrics.ate_rmse(Ts_t[same_ref][:, :3, 3], gt)
    ate_j = tmetrics.ate_rmse(Ts_j[same_ref][:, :3, 3], gt)
    assert abs(ate_t - ate_j) <= 1e-3, (ate_t, ate_j)


def test_clis_refuse_what_is_not_ported(tum_seq, tmp_path, monkeypatch):
    """A Keras .h5 for the live segmenter that is not there fails to open
    (the segmenter and the .h5 route are ported: tests/test_torch_segmenter.py
    and tests/test_torch_maskrcnn_h5.py run both drivers with `--segmenter
    flax:W.npz` and `flax:W.h5`); a vocabulary is ported
    (loop closing and BoW relocalization): `--vocab default` runs
    evaluate's plain mode to the end, and a vocabulary file that is not
    there fails to load."""
    from gdslam_tpu_torch.cli import evaluate, rgbd_tum
    seq_dir, _ = tum_seq
    _, assoc, gt, settings, masks = _paths(seq_dir)
    monkeypatch.chdir(tmp_path)
    assert evaluate.main([seq_dir, assoc, gt, "--vocab", "default", "--settings", settings,
                          "--rpe-delta", "5", "--device", "cpu"]) == 0
    with pytest.raises(FileNotFoundError):
        rgbd_tum.main([str(tmp_path / "missing.npz"), settings, seq_dir, assoc,
                       "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        rgbd_tum.main(["none", settings, seq_dir, assoc, "--segmenter", "flax:W.h5",
                       "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        evaluate.main([seq_dir, assoc, gt, "--segmenter", "flax:W.h5", "--device", "cpu"])
    assert rgbd_tum.main(["none"]) == 1
