"""The rest of the port's RGB-D System API against the JAX package's: map
checkpoints (gdslam_tpu_torch.utils.checkpoint, System.save_map / load_map)
read and written in the JAX package's npz layout, and the KITTI trajectory
writer byte for byte."""

import numpy as np
import pytest
import torch

from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.system import trajectory as jtraj
from gdslam_tpu.utils import checkpoint as jckpt
from gdslam_tpu_torch import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu_torch.backend import map_arena as tma
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.system import trajectory as ttraj
from gdslam_tpu_torch.system.slam import System
from gdslam_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

CAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
TS = [1305031790.0 + i / 30.0 for i in range(6)]


def _random_arena(seed: int) -> dict:
    """Every MapArena field of a small arena, filled with seeded values of
    its dtype."""
    r = np.random.default_rng(seed)
    out = {}
    for k, v in jma.new_arena(8, 64, 32)._asdict().items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            out[k] = r.uniform(size=v.shape) < 0.5
        elif v.dtype == np.uint8:
            out[k] = r.integers(0, 256, v.shape).astype(np.uint8)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = r.integers(-1, 60, v.shape).astype(v.dtype)
        else:
            out[k] = r.normal(size=v.shape).astype(v.dtype)
    return out


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_map_files_cross_between_packages(tmp_path):
    """A map saved by the JAX package loads in the port field for field,
    float64 timestamps included, and the reverse."""
    fields = _random_arena(0)
    jckpt.save_map(jma.MapArena(**fields), str(tmp_path / "j.npz"), kf_timestamps=TS)
    arena, ts = tckpt.load_map_with_timestamps(str(tmp_path / "j.npz"), device="cpu")
    assert ts == TS and isinstance(ts[0], float)
    _same({k: getattr(arena, k).numpy() for k in tma.MapArena._fields}, fields)
    assert tckpt.load_map(str(tmp_path / "j.npz"), device="cpu").kmax == 8

    fields = _random_arena(1)
    tckpt.save_map(tma.MapArena(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                   str(tmp_path / "t.npz"), kf_timestamps=TS)
    arena, ts = jckpt.load_map_with_timestamps(str(tmp_path / "t.npz"))
    assert list(ts) == TS
    _same({k: np.asarray(getattr(arena, k)) for k in jma.MapArena._fields}, fields)
    tckpt.save_map(tma.MapArena(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                   str(tmp_path / "no_ts.npz"))
    assert tckpt.load_map_with_timestamps(str(tmp_path / "no_ts.npz"), "cpu")[1] == []


@pytest.fixture(scope="module")
def tracked():
    """A port System on the CPU after six frames of the static scene."""
    cfg = SlamConfig(camera=CAM, orb=OrbConfig(n_features=256, n_levels=4))
    s = System(cfg, kmax=8, pmax=4096, pipeline=True, device="cpu")
    for i, ts in enumerate(TS):
        fr = tsyn.render_frame(i, CAM, device="cpu")
        s.track_rgbd(fr.gray, fr.depth, None, ts)
    return s, cfg


def test_system_save_and_load_map(tracked, tmp_path):
    """System.save_map commits the in-flight frames and writes the arena the
    JAX loader reads; System.load_map gives a fresh system the same arena and
    keyframe timestamps."""
    s, cfg = tracked
    s.save_map(str(tmp_path / "m.npz"))
    assert s.keyframe_count >= 1 and s.tracker.kf_timestamps[0] == TS[0]
    want = {k: getattr(s.tracker.arena, k).numpy() for k in tma.MapArena._fields}
    arena, ts = jckpt.load_map_with_timestamps(str(tmp_path / "m.npz"))
    _same({k: np.asarray(getattr(arena, k)) for k in jma.MapArena._fields}, want)
    assert list(ts) == s.tracker.kf_timestamps
    fresh = System(cfg, kmax=8, pmax=4096, device="cpu")
    fresh.load_map(str(tmp_path / "m.npz"))
    _same({k: getattr(fresh.tracker.arena, k).numpy() for k in tma.MapArena._fields}, want)
    assert fresh.tracker.kf_timestamps == s.tracker.kf_timestamps
    assert fresh.keyframe_count == s.keyframe_count and fresh.map_point_count > 0


def test_kitti_writer_equals_jax(tracked, tmp_path):
    """save_kitti and System.save_trajectory_kitti write the JAX writer's
    bytes."""
    s, _ = tracked
    traj = s.tracker.camera_trajectory()
    assert len(traj) == len(TS)
    s.save_trajectory_kitti(str(tmp_path / "s.txt"))
    ttraj.save_kitti(str(tmp_path / "t.txt"), traj)
    jtraj.save_kitti(str(tmp_path / "j.txt"), traj)
    text = (tmp_path / "j.txt").read_text()
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "s.txt").read_text() == text
    assert len(text.splitlines()) == len(TS) and len(text.split()) == 12 * len(TS)
