"""Parity of the port's geometry (gdslam_tpu_torch.core.{lie,camera}) and
pose Gauss-Newton (backend.optimizer) with the JAX package on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import optimizer as jopt
from gdslam_tpu.config import CameraConfig
from gdslam_tpu.core import camera as jcam
from gdslam_tpu.core import lie as jlie
from gdslam_tpu_torch import config as tconfig
from gdslam_tpu_torch.backend import optimizer as topt
from gdslam_tpu_torch.core import camera as tcam
from gdslam_tpu_torch.core import lie as tlie

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

RNG = np.random.default_rng(7)
XI = np.concatenate([RNG.normal(0, 0.3, (16, 3)), RNG.normal(0, 0.4, (16, 3))],
                    1).astype(np.float32)
XI[0] = 0.0                                   # theta -> 0 branch
XI[1, 3:] = 1e-5
PTS = RNG.normal(0, 1.0, (16, 3)).astype(np.float32) + np.float32([0, 0, 3])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fn", ["se3_exp", "se3_inverse", "se3_apply", "hat",
                                "so3_project", "se3_orthonormalize"])
def test_lie_matches_jax(fn):
    """allclose 1e-6: f32 closed forms, small products summed in another order."""
    T = np.asarray(jlie.se3_exp(jnp.asarray(XI)))
    args = {
        "se3_exp": (XI,),
        "se3_inverse": (T,),
        "se3_apply": (T, PTS),
        "hat": (XI[:, :3],),
        "so3_project": ((T[:, :3, :3] * 1.01).astype(np.float32),),
        "se3_orthonormalize": ((T * np.float32(1.003)).astype(np.float32),),
    }[fn]
    want = np.asarray(getattr(jlie, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(tlie, fn)(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_camera_matches_jax():
    cam = CameraConfig(k1=0.1, k2=-0.05, p1=1e-3, p2=-2e-3, k3=0.01)
    tc = tconfig.CameraConfig(**dataclasses.asdict(cam))
    uv, z = np.asarray(jcam.project(jnp.asarray(PTS), cam)[0]), PTS[:, 2]
    got_uv, got_z = tcam.project(_t(PTS), tc)
    np.testing.assert_allclose(got_uv.numpy(), uv, atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(got_z.numpy(), z)
    np.testing.assert_allclose(tcam.backproject(_t(uv), _t(z), tc).numpy(),
                               np.asarray(jcam.backproject(jnp.asarray(uv),
                                                           jnp.asarray(z), cam)),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tcam.undistort_points(_t(uv), tc).numpy(),
                               np.asarray(jcam.undistort_points(jnp.asarray(uv), cam)),
                               atol=1e-3, rtol=1e-6)


def test_pose_optimization_matches_jax():
    """T allclose 1e-5 and identical inlier masks from numpy inputs: 300
    stereo/mono observations with 20% gross outliers, perturbed start."""
    r = np.random.default_rng(3)
    n = 300
    K = (160.0, 160.0, 80.0, 60.0)
    bf = 12.8
    T_true = np.asarray(jlie.se3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.02, -0.01, 0.015],
                                                 jnp.float32)))
    pw = np.stack([r.uniform(-1.5, 1.5, n), r.uniform(-1, 1, n), r.uniform(1.5, 4, n)],
                  1).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    u = K[0] * pc[:, 0] / pc[:, 2] + K[2]
    v = K[1] * pc[:, 1] / pc[:, 2] + K[3]
    uv = np.stack([u, v], 1) + r.normal(0, 0.5, (n, 2))
    out = r.uniform(size=n) < 0.2
    uv[out] += r.uniform(-30, 30, (out.sum(), 2))
    ur = np.where(r.uniform(size=n) < 0.7, uv[:, 0] - bf / pc[:, 2], -1.0)
    level = r.integers(0, 4, n)
    obs = dict(pw=pw, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
               inv_sigma2=(1.0 / 1.2 ** (2 * level)).astype(np.float32),
               valid=r.uniform(size=n) < 0.95)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(XI[5] * 0.1)) @ T_true)
    Tj, inl_j, n_j = jopt.pose_optimization(
        jnp.asarray(T0), jopt.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}), K, bf)
    Tt, inl_t, n_t = topt.pose_optimization(
        _t(T0), topt.PoseObs(**{k: _t(v) for k, v in obs.items()}), K, bf)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 150
