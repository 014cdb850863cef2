"""The port's stereo and monocular trackers and command-line programs
against the JAX package's: Tracking.process_stereo over the JAX stereo
test's 6 frames and process_mono over 7 (tests/test_stereo_mono.py), and
gdslam_tpu_torch.cli.stereo_kitti, mono_tum, mono_kitti with --device cpu
on the layouts of the JAX driver tests (tests/test_drivers.py): a 10-frame
KITTI stereo sequence and a 14-frame TUM monocular sequence of the static
scene at 160x120, held to those tests' checks, and the stereo trajectory
held to the JAX driver's on the same files. The loaders read with the
port's own PNG reader. (One file, so that the JAX stereo tracker compiles
once for both.)"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.cli import stereo_kitti as jstereo_kitti
from gdslam_tpu.config import CameraConfig
from gdslam_tpu.io import kitti as jkitti
from gdslam_tpu.io import synthetic
from gdslam_tpu.system.tracking import Tracking as JTracking
from gdslam_tpu_torch.cli import mono_kitti, mono_tum, stereo_kitti
from gdslam_tpu_torch.io import kitti as tkitti
from gdslam_tpu_torch.io import png
from gdslam_tpu_torch.system import tracking as ttracking
from test_torch_stereo_mono import SCFG, TCFG, _stereo_pair

# One torch thread per test process: xdist's six workers share the cores.
torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160,
                    height=120, bf=160.0 * 0.08, fps=30.0)

# tests/test_drivers.py's settings
SETTINGS_YAML = """%YAML:1.0
Camera.fx: 160.0
Camera.fy: 160.0
Camera.cx: 80.0
Camera.cy: 60.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
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
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """tests/test_drivers.py's KITTI-layout stereo sequence (the gray
    truncated to uint8, as it writes it)."""
    root = tmp_path_factory.mktemp("kitti_seq")
    os.makedirs(root / "image_0")
    os.makedirs(root / "image_1")
    shift = np.eye(4)
    shift[0, 3] = SCAM.bf / SCAM.fx
    times = []
    for i in range(10):
        T = np.asarray(synthetic.gt_pose(i))
        left = synthetic.render(jnp.asarray(T), SCAM, False, 30.0, i)
        right = synthetic.render(jnp.asarray(T @ shift), SCAM, False, 30.0, i)
        png.write(root / "image_0" / f"{i:06d}.png", np.asarray(left.gray).astype(np.uint8))
        png.write(root / "image_1" / f"{i:06d}.png", np.asarray(right.gray).astype(np.uint8))
        times.append(i / 30.0)
    with open(root / "times.txt", "w") as f:
        f.write("\n".join(f"{t:.6f}" for t in times) + "\n")
    with open(root / "settings.yaml", "w") as f:
        f.write(SETTINGS_YAML)
    return str(root)


@pytest.fixture(scope="module")
def tum_mono_dir(tmp_path_factory):
    """tests/test_drivers.py's TUM monocular sequence (rgb.txt + rgb/)."""
    root = tmp_path_factory.mktemp("tum_mono")
    os.makedirs(root / "rgb")
    rows = []
    for i in range(14):
        fr = synthetic.render_frame(i, SCAM, with_dynamic=False)
        name = f"rgb/{i / 30.0:.6f}.png"
        png.write(root / name, np.asarray(fr.gray).astype(np.uint8))
        rows.append(f"{i / 30.0:.6f} {name}")
    with open(root / "rgb.txt", "w") as f:
        f.write("# ts path\n" + "\n".join(rows) + "\n")
    with open(root / "settings.yaml", "w") as f:
        f.write(SETTINGS_YAML)
    return str(root)


def _rows(path) -> list[list[float]]:
    return [[float(x) for x in ln.split()] for ln in open(path).read().strip().splitlines()]


def test_loaders_match_jax(kitti_dir, tum_mono_dir):
    """The port's KITTI and TUM monocular loaders give the JAX package's
    frames (read with PIL) and timestamps exactly, colour through numpy's
    0.299 r + 0.587 g + 0.114 b."""
    jseq, tseq = jkitti.KittiStereoSequence(kitti_dir), tkitti.KittiStereoSequence(kitti_dir)
    assert len(tseq) == len(jseq) == 10 and tkitti.load_times(kitti_dir) == jseq.times
    for i in (0, 9):
        for a, b in zip(tseq[i], jseq[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tkitti.KittiMonoSequence(kitti_dir)[3], jkitti.KittiMonoSequence(kitti_dir)[3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jm, tm = jkitti.TumMonoSequence(tum_mono_dir), tkitti.TumMonoSequence(tum_mono_dir)
    assert tm.rows == jm.rows
    for a, b in zip(tm[5], jm[5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # an RGB image: the same float32 conversion, in the same order
    rgb = np.random.default_rng(0).integers(0, 256, (12, 16, 3)).astype(np.uint8)
    path = os.path.join(tum_mono_dir, "rgb", "colour.png")
    png.write(path, rgb)
    from PIL import Image
    im = np.asarray(Image.open(path), dtype=np.float32)
    want = 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
    np.testing.assert_array_equal(tkitti._gray(path), want)
    os.remove(path)


def test_stereo_kitti_matches_the_jax_driver(kitti_dir, tmp_path, monkeypatch):
    """rc 0, at least 8 KITTI rows of 12 numbers (tests/test_drivers.py's
    checks), and every row within 1e-3 of the JAX driver's on the same
    files."""
    settings = os.path.join(kitti_dir, "settings.yaml")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jstereo_kitti.main(["none", settings, kitti_dir]) == 0
    monkeypatch.chdir(tmp_path / "port")
    assert stereo_kitti.main(["none", settings, kitti_dir, "--device", "cpu"]) == 0
    got = _rows(tmp_path / "port" / "CameraTrajectory.txt")
    want = _rows(tmp_path / "jax" / "CameraTrajectory.txt")
    assert len(got) >= 8 and all(len(r) == 12 for r in got)
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("driver", ["mono_tum", "mono_kitti"])
def test_mono_drivers_write_keyframe_trajectories(driver, kitti_dir, tum_mono_dir, tmp_path,
                                                  monkeypatch):
    """rc 0 and at least 2 keyframe rows in TUM format (8 numbers), as
    tests/test_drivers.py checks mono_tum; mono_kitti on the KITTI layout's
    left images. Without arguments each prints its usage and returns 1."""
    main, seq = {"mono_tum": (mono_tum.main, tum_mono_dir),
                 "mono_kitti": (mono_kitti.main, kitti_dir)}[driver]
    monkeypatch.chdir(tmp_path)
    assert main(["none", os.path.join(seq, "settings.yaml"), seq, "--device", "cpu"]) == 0
    rows = _rows(tmp_path / "KeyFrameTrajectory.txt")
    assert len(rows) >= 2 and all(len(r) == 8 for r in rows)
    assert main([]) == 1


@pytest.fixture(scope="module")
def runs():
    """Both packages' trackers: 6 stereo frames of the JAX stereo test, and
    7 monocular frames (every second one) of the JAX mono test (the port's
    bootstrap replays the JAX package's draws). Poses and counts as numpy."""
    out = {}
    pairs = [_stereo_pair(i, SCFG.camera) for i in range(6)]
    jt = JTracking(SCFG, kmax=32, pmax=16384)
    tt = ttracking.Tracking(TCFG, kmax=32, pmax=16384, device="cpu")
    out["stereo"] = dict(
        jax=[np.asarray(jt.process_stereo(jnp.asarray(gl), jnp.asarray(gr), None, i / 30.0))
             for i, (gl, gr, _) in enumerate(pairs)],
        port=[np.asarray(tt.process_stereo(gl, gr, None, i / 30.0))
              for i, (gl, gr, _) in enumerate(pairs)],
        states=(jt.state.name, tt.state.name), n_kf=(int(jt.arena.n_kf), tt.n_kf_host),
        gt=[T for _, _, T in pairs])

    grays = [np.asarray(synthetic.render_frame(i, SCFG.camera, with_dynamic=False).gray)
             for i in range(0, 14, 2)]
    jt = JTracking(SCFG, kmax=32, pmax=16384)
    tt = ttracking.Tracking(TCFG, kmax=32, pmax=16384, device="cpu")
    mono = dict(jax=[], port=[], jstate=[], tstate=[])
    for k, g in enumerate(grays):
        mono["jax"].append(np.asarray(jt.process_mono(jnp.asarray(g), 2 * k / 30.0)))
        mono["port"].append(np.asarray(tt.process_mono(g, 2 * k / 30.0)))
        mono["jstate"].append(jt.state.name)
        mono["tstate"].append(tt.state.name)
    mono.update(n_kf=(int(jt.arena.n_kf), tt.n_kf_host),
                kf_pose=(np.asarray(jt.arena.kf_pose[:2]), tt.arena.kf_pose[:2].numpy()),
                n_pt=(int(jt.arena.pt_valid.sum()), int(tt.arena.pt_valid.sum())))
    out["mono"] = mono
    return out


def test_process_stereo_matches_jax(runs):
    """Six stereo frames: both trackers OK, the same keyframes, every pose
    within 1e-3 m (and 1e-3 in rotation) of the JAX package's, and the
    last one within the JAX test's 0.10 m of ground truth."""
    r = runs["stereo"]
    assert r["states"] == ("OK", "OK")
    assert r["n_kf"][0] == r["n_kf"][1]
    for i, (Tj, Tt) in enumerate(zip(r["jax"], r["port"])):
        np.testing.assert_allclose(Tt, Tj, atol=1e-3, err_msg=f"frame {i}")
    gt_rel = np.linalg.inv(r["gt"][0]) @ r["gt"][-1]
    assert np.linalg.norm(np.linalg.inv(r["port"][-1])[:3, 3] - gt_rel[:3, 3]) < 0.10


def test_process_mono_matches_jax(runs):
    """Seven monocular frames, every second one: the bootstrap at the same
    frame, its T_21 (the unit-norm pose the tracker returns) and the scaled
    second keyframe to 1e-3, the same keyframe count, OK at the end, map
    points within 2%."""
    m = runs["mono"]
    assert m["jstate"] == m["tstate"]
    boot = m["jstate"].index("OK")
    assert boot >= 1
    np.testing.assert_allclose(m["port"][boot], m["jax"][boot], atol=1e-3)
    np.testing.assert_allclose(m["kf_pose"][1], m["kf_pose"][0], atol=1e-3)
    assert m["n_kf"][0] == m["n_kf"][1] and m["tstate"][-1] == "OK"
    assert abs(m["n_pt"][0] - m["n_pt"][1]) <= 0.02 * m["n_pt"][0]
