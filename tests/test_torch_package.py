"""Package-level checks of the PyTorch/CUDA port (gdslam_tpu_torch): it
stands alone (no JAX, nothing of gdslam_tpu), pins full f32, defaults to
the card, refuses to fall back to the CPU for CUDA tensors, and its own
copies of the JAX package's tables, config, renderer, metrics and
trajectory writer agree with the originals."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdslam_tpu_torch
from gdslam_tpu import config as jconfig
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.ops import orb as jorb
from gdslam_tpu.system import trajectory as jtraj
from gdslam_tpu.utils import metrics as jmetrics
from gdslam_tpu_torch import config as tconfig
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import loop_closing, map_arena
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.ops import match_kernel
from gdslam_tpu_torch.ops import orb as torb
from gdslam_tpu_torch.system import slam as tslam
from gdslam_tpu_torch.system import tracking as ttracking
from gdslam_tpu_torch.system import trajectory as ttraj
from gdslam_tpu_torch.utils import metrics as tmetrics

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gdslam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gdslam_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    """Static scan: no module of the port, nor chip_smoke.py, imports JAX
    or the JAX package (gdslam_tpu_torch itself is allowed)."""
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    """Importing every module of the port in a fresh interpreter loads
    neither jax nor gdslam_tpu."""
    code = (
        "import pkgutil, importlib, sys, gdslam_tpu_torch\n"
        "for m in pkgutil.walk_packages(gdslam_tpu_torch.__path__, 'gdslam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'gdslam_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('gdslam_tpu_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    n_mods, bad = out.stdout.strip().split(" ", 1)
    assert int(n_mods) > 20 and bad == "[]", out.stdout


def test_brief_tables_equal_jax():
    """The port's own numpy copies: the BRIEF pattern, and per rotation bin
    the tap that each column of the JAX one-hot bin matrix selects."""
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    assert torb.BRIEF_PATTERN.dtype == jorb.BRIEF_PATTERN.dtype
    onehot = jorb._np_bin_matrix().reshape(37 * 37, torb.N_ANGLE_BINS, 512)
    np.testing.assert_array_equal(onehot.sum(0), 1.0)
    np.testing.assert_array_equal(torb._BIN_TAPS, onehot.argmax(0))


def test_tf32_is_off():
    """Importing the port turns TF32 off for matmuls and cuDNN convolutions
    (the reference computes its geometry at Precision.HIGHEST)."""
    assert gdslam_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_config_copy_matches_jax():
    """Same fields and defaults as the JAX package's dataclasses, and
    convert.config_from_jax_dict round-trips them."""
    for name in ("CameraConfig", "OrbConfig", "GeoMaskConfig", "GeometryConfig",
                 "TrackingConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())
    jcfg = jconfig.SlamConfig(camera=jconfig.CameraConfig(fx=500.0, width=320, height=240),
                              orb=jconfig.OrbConfig(n_features=384, n_levels=4))
    tcfg = convert.config_from_jax_dict(dataclasses.asdict(jcfg))
    assert tcfg == tconfig.SlamConfig(camera=tconfig.CameraConfig(fx=500.0, width=320, height=240),
                                      orb=tconfig.OrbConfig(n_features=384, n_levels=4))


def test_opencv_yaml_reader_matches_jax(tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text("%YAML:1.0\nCamera.fx: 517.3\nCamera.width: 640\nCamera.RGB: 0\n"
                    "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
                    "DepthMapFactor: 5208.0  # comment\n")
    got = tconfig.SlamConfig.from_opencv_yaml(str(path))
    want = jconfig.SlamConfig.from_opencv_yaml(str(path))
    for section in ("camera", "orb", "geomask", "geometry", "tracking"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section))


@pytest.mark.parametrize("dynamic", [False, True])
def test_renderer_matches_jax(dynamic):
    """Depth allclose 1e-4 m; gray mean absolute difference < 0.5 grey
    levels: the sin-hash texture (`_hash2`, sin(x) * 43758.5) amplifies
    last-ulp differences of sin between the two libraries, so a few
    texels take another value and gray is not bit-exact."""
    cam = jconfig.CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160,
                               height=120, bf=12.8)
    want = jsyn.render_frame(5, cam, with_dynamic=dynamic)
    got = tsyn.render_frame(5, tconfig.CameraConfig(**dataclasses.asdict(cam)),
                            with_dynamic=dynamic, device="cpu")
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=1e-4, rtol=0)
    assert np.abs(got.gray.numpy() - np.asarray(want.gray)).mean() < 0.5
    np.testing.assert_allclose(got.T_wc.numpy(), np.asarray(want.T_wc), atol=1e-6)
    assert (got.dyn_mask.numpy() != np.asarray(want.dyn_mask)).mean() < 1e-3
    assert got.dyn_mask.numpy().any() == dynamic


def test_metrics_and_trajectory_writer_match_jax(tmp_path):
    """ate_rmse equals the JAX package's (both numpy float64), and the TUM
    file is byte-identical."""
    r = np.random.default_rng(0)
    gt = r.normal(size=(40, 3))
    est = gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 0.3 + r.normal(0, 0.01, (40, 3))
    assert tmetrics.ate_rmse(est, gt) == pytest.approx(jmetrics.ate_rmse(est, gt), abs=1e-12)
    xi = r.normal(0, 0.3, (5, 6)).astype(np.float32)
    from gdslam_tpu.core import lie as jlie
    traj = [(1.3e9 + 0.033 * i, np.asarray(jlie.se3_exp(jnp.asarray(x)))) for i, x in enumerate(xi)]
    ttraj.save_tum(str(tmp_path / "t.txt"), traj)
    jtraj.save_tum(str(tmp_path / "j.txt"), traj)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_entry_points_default_to_the_card():
    """System, Tracking, render_frame and new_arena default to "cuda"; on a
    machine without a card they fail through torch's own error rather than
    running on the CPU."""
    for fn in (tslam.System, ttracking.Tracking, tsyn.render_frame, map_arena.new_arena):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tslam.System(tconfig.SlamConfig())


def test_not_ported_entry_points_raise():
    """What is still to port raises NotImplementedError naming ROADMAP.md
    (the geometry path, track_rgbd_geom, GD inpainting and loop closing with
    a vocabulary are ported: see test_ported_entry_points_no_longer_raise)."""
    cfg = tconfig.SlamConfig(camera=tconfig.CameraConfig(width=160, height=120),
                             orb=tconfig.OrbConfig(n_features=64, n_levels=2))
    s = tslam.System(cfg, kmax=4, pmax=64, device="cpu")
    for name in ("track_stereo", "track_monocular",
                 "save_map", "load_map", "save_trajectory_kitti"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(s, name)()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tslam.System(cfg, sensor=tslam.Sensor.STEREO, kmax=4, pmax=64, device="cpu")


def test_ported_entry_points_no_longer_raise(tmp_path):
    """The entry points of this slice construct and run: the defaults are the
    JAX package's (local BA and triangulation on), a pipelined tracker is
    built, and reset, the localization-mode toggles, shutdown, light_track
    and both TUM writers work on a fresh system."""
    cfg = tconfig.SlamConfig(camera=tconfig.CameraConfig(width=160, height=120),
                             orb=tconfig.OrbConfig(n_features=64, n_levels=2))
    tr = ttracking.Tracking(cfg, kmax=4, pmax=64, pipeline=True, device="cpu")
    assert tr.pipeline and tr.use_local_ba and tr.use_triangulation
    assert (tr.commit_every, tr.frame_id, tr.n_inliers, tr.mapping_enabled) == (3, 0, 0, True)
    assert not tr.kf_arena_full_warned
    tr.flush()
    assert tr.light_track(None) == (False, None)
    assert tr._relocalize(None) == (False, None, None, 0)        # no keyframe yet
    s = tslam.System(cfg, kmax=4, pmax=64, pipeline=True, device="cpu")
    s.activate_localization_mode()
    assert not s.tracker.mapping_enabled
    s.deactivate_localization_mode()
    s.track_rgbd(np.zeros((120, 160)), np.zeros((120, 160)), None, 0.0)   # too few keypoints
    assert s.tracking_state.name == "NOT_INITIALIZED" and s.tracker.frame_id == 1
    s.reset()
    assert s.tracking_state.name == "NO_IMAGES_YET" and s.tracker.pipeline
    s.shutdown()
    s.save_trajectory_tum(str(tmp_path / "c.txt"))
    s.save_keyframe_trajectory_tum(str(tmp_path / "k.txt"))
    assert (tmp_path / "k.txt").read_text() == ""
    for name in ("local_keyframes", "compact_keyframes"):
        assert callable(getattr(map_arena, name))
    # the DynaSLAM geometry path, track_rgbd_geom and GD inpainting run on a
    # frame too poor to initialize; inpainting wants a 3-channel image
    s = tslam.System(cfg, kmax=4, pmax=64, device="cpu")
    z, rgb = np.zeros((120, 160)), np.zeros((120, 160, 3), np.uint8)
    s.track_rgbd(rgb, z, None, 0.0, use_geometry=True)
    T, rgb_o, d_o, m_o = s.track_rgbd_geom(rgb, z, None, 1.0)
    assert rgb_o.shape == (120, 160, 3) and d_o.shape == m_o.shape == (120, 160)
    T, m, rgb_o, d_o = s.track_rgbd_gd(rgb, z, None, 2.0, inpaint=True)
    assert rgb_o.shape == (120, 160, 3) and s._geometry.inserted == 0
    with pytest.raises(ValueError, match="3-channel"):
        s.track_rgbd_gd(z, z, None, 3.0, inpaint=True)
    s.reset()
    assert s._geometry is None and s._last_refined_mask is None
    # a vocabulary: a loop closer at every keyframe, kept by reset; the
    # tracker takes a LoopCloser or None
    s = tslam.System(cfg, kmax=4, pmax=64, vocabulary="default", device="cpu")
    lc = s.tracker.loop_closer
    assert isinstance(lc, loop_closing.LoopCloser) and lc.fix_scale
    assert lc.vocab.n_leaves == 10_000 and lc.db.vectors.shape == (4, 10_000)
    s.track_rgbd(np.zeros((120, 160)), np.zeros((120, 160)), None, 0.0)
    s.reset()
    assert s.tracker.loop_closer is lc and lc.loops == []
    with pytest.raises(TypeError):
        s.tracker.loop_closer = object()
    s.tracker.loop_closer = None
    assert tslam.System(cfg, kmax=4, pmax=64, device="cpu").tracker.loop_closer is None


NEW_MODULES = ("masking/geometry.py", "masking/masknet.py", "io/png.py", "io/tum.py",
               "io/native_loader.py", "cli/rgbd_tum.py", "cli/evaluate.py",
               "backend/vocabulary.py", "backend/keyframe_db.py", "backend/loop_closing.py",
               "backend/pose_graph.py", "backend/gba.py")


def test_no_import_check_covers_the_geometry_and_cli_modules():
    """The static scan and the fresh-interpreter import above reach the
    modules of the geometry path, the CLIs and loop closing (the scan takes
    every file of the package)."""
    for rel in NEW_MODULES:
        assert ROOT / "gdslam_tpu_torch" / rel in PORT_FILES, rel
        assert not [m for m in _imported_roots(ROOT / "gdslam_tpu_torch" / rel)
                    if m in FORBIDDEN], rel


def _cuda_inputs(M, N):
    f, u8, i32, b = torch.float32, torch.uint8, torch.int32, torch.bool
    return (torch.empty(M, 2, dtype=f, device="cuda"), torch.empty(M, 32, dtype=u8, device="cuda"),
            torch.empty(M, dtype=f, device="cuda"), torch.empty(M, dtype=i32, device="cuda"),
            torch.empty(M, dtype=b, device="cuda"), torch.empty(N, 2, dtype=f, device="cuda"),
            torch.empty(N, 32, dtype=u8, device="cuda"), torch.empty(N, dtype=i32, device="cuda"),
            torch.empty(N, dtype=b, device="cuda"))


def test_wrapper_raises_on_cuda_tensors_without_the_library(monkeypatch):
    """For CUDA tensors the wrapper launches the kernel or raises: with the
    library loader failing it raises and counts no launch, and it never
    takes the plain version. Fake CUDA tensors stand in for a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def missing():
        raise RuntimeError("match_top2: library missing")

    monkeypatch.setattr(match_kernel, "_load_library", missing)
    monkeypatch.setattr(match_kernel, "match_top2_plain",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = match_kernel.match_top2.launches
    with FakeTensorMode():
        args = _cuda_inputs(64, 32)
        with pytest.raises(RuntimeError, match="library missing"):
            match_kernel.match_top2(*args)
        bad = list(args)
        bad[1] = torch.empty(64, 256, dtype=torch.int8, device="cuda")   # +-1 form
        with pytest.raises(ValueError, match="cand_desc"):
            match_kernel.match_top2(*bad)
    assert match_kernel.match_top2.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler: the build raises before it creates anything."""
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(match_kernel.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(match_kernel, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        match_kernel.build_library()
    assert not (tmp_path / "kernels").exists()
