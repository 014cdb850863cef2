"""The shared small rig of the port's keyframe-program tests: a three-keyframe
JAX arena built from rendered frames at their ground-truth poses, with part
of the keypoints made depthless so that epipolar triangulation, duplicate
fusion and local BA all have work to do. Other test files import `build`
and the configurations; the test here holds the rig to what they rely on.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.core import lie as jlie
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.system import tracking as jtr
from gdslam_tpu_torch import convert

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
SCFG = SlamConfig(camera=SCAM, orb=OrbConfig(n_features=384, n_levels=4))
TCFG = convert.config_from_jax_dict(dataclasses.asdict(SCFG))
KMAX, PMAX, N = 32, 16384, 384
KF_FRAMES = (0, 12, 24)
ONES = np.ones((120, 160), np.float32)


def np_tree(nt) -> dict:
    return {k: np.asarray(getattr(nt, k)) for k in nt._fields}


def jax_arena(d: dict) -> jma.MapArena:
    return jma.MapArena(**{k: jnp.asarray(v) for k, v in d.items()})


def jax_frame(idx: int, depthless: float = 0.0, seed: int = 0):
    """Frame `idx` of the static room through the JAX front end; a share
    `depthless` of its keypoints loses its depth (as a far keypoint)."""
    fr = jsyn.render_frame(idx, SCAM, with_dynamic=False)
    f = jframe.build_frame(jext.extract(fr.gray, SCFG.orb, SCAM.height, SCAM.width),
                           fr.depth, jnp.asarray(ONES), SCAM)
    if depthless > 0:
        drop = np.random.default_rng(seed + idx).random(N) < depthless
        f = f._replace(depth=jnp.where(drop, 0.0, f.depth), ur=jnp.where(drop, -1.0, f.ur))
    return f, np.asarray(fr.T_wc)


def build(depthless: float = 0.4, frames=KF_FRAMES, fuse_last: bool = True):
    """The JAX arena after keyframes at `frames` (ground-truth poses, fused
    associations), the frames, and their T_cw. With fuse_last=False the last
    keyframe is inserted unassociated, so it duplicates the points it sees."""
    arena = jma.new_arena(KMAX, PMAX, N)
    fs, poses = [], []
    for i, idx in enumerate(frames):
        f, T_wc = jax_frame(idx, depthless)
        T_cw = jlie.se3_inverse(jnp.asarray(T_wc))
        if i == 0:
            arena, _ = jtr.stereo_initialize(arena, f, T_cw, SCFG)
        else:
            assoc = -jnp.ones(N, jnp.int32)
            if fuse_last or i < len(frames) - 1:
                assoc = jtr.fuse_associate(arena, f, T_cw, assoc, SCFG)
            arena, _ = jtr.insert_keyframe(arena, f, T_cw, assoc, jnp.asarray(idx / 30.0), SCFG)
        fs.append(f)
        poses.append(np.asarray(T_cw))
    return arena, fs, poses


def assert_arena_equal(got: dict, want: dict, atol: float = 1e-5):
    """Integers and booleans exactly, floats to `atol`."""
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_rig_has_work_for_the_keyframe_program():
    arena, fs, _ = build()
    a = np_tree(arena)
    assert int(a["n_kf"]) == 3 and a["kf_valid"][:3].all()
    assert int(a["n_pt"]) > 200
    # shared observations between the keyframes, and free depthless keypoints
    assert a["covis"][2, 1] > 30 and a["covis"][2, 0] > 30
    free = a["kf_kp_valid"][:3] & (a["kf_obs"][:3] < 0) & (a["kf_depth"][:3] <= 0)
    assert (free.sum(axis=1) > 50).all()
