"""Parity of the port's ORB front end (gdslam_tpu_torch.ops.{fast,image,orb},
frontend.{extractor,frame}) with the JAX package on the CPU, at the small
120x160 / 384-feature / 4-level rig."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.config import CameraConfig, OrbConfig
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.frontend import frame as jframe
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu.ops import fast as jfast
from gdslam_tpu.ops import image as jimg
from gdslam_tpu_torch import config as tconfig
from gdslam_tpu_torch.frontend import extractor as text
from gdslam_tpu_torch.frontend import frame as tframe
from gdslam_tpu_torch.ops import fast as tfast
from gdslam_tpu_torch.ops import image as timg

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
SORB = OrbConfig(n_features=384, n_levels=4)
TCAM = tconfig.CameraConfig(**vars(SCAM))
TORB = tconfig.OrbConfig(**vars(SORB))


@pytest.fixture(scope="module")
def gray():
    return np.array(jsyn.render_frame(3, SCAM, with_dynamic=False).gray)


def test_fast_strength_and_nms_exact():
    """Integer-valued image: differences, mins and maxes are exact in f32,
    and torch.roll wraps around as jnp.roll does."""
    img = np.random.default_rng(0).integers(0, 256, (60, 80)).astype(np.float32)
    s_j = np.asarray(jfast.fast_strength(jnp.asarray(img)))
    s_t = tfast.fast_strength(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(tfast.nms3x3(torch.from_numpy(s_j.copy())).numpy(),
                                  np.asarray(jfast.nms3x3(jnp.asarray(s_j))))
    assert (s_j > 20).sum() > 50


def test_pyramid_and_blur_close(gray):
    """allclose 1e-4: the resize is a matrix product whose summation order
    may differ between the two libraries (it is identical on this CPU)."""
    c_j, shapes_j = jimg.build_pyramid(jnp.asarray(gray), 120, 160, 4, 1.2)
    c_t, shapes_t = timg.build_pyramid(torch.from_numpy(gray), 120, 160, 4, 1.2)
    assert tuple(shapes_t) == tuple(tuple(s) for s in shapes_j)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(timg.gaussian_blur(torch.from_numpy(np.array(c_j))).numpy(),
                               np.asarray(jimg.gaussian_blur(c_j)), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(timg._interp_matrix(160, 133), jimg._interp_matrix(160, 133))


def test_extract_matches_jax(gray):
    """uv / level / valid identical on >= 98% of keypoints and desc on >= 98%
    of those. On this CPU all are identical: the pyramid, FAST, selection
    and BRIEF taps are bit-exact. The IC angle is a 31x31 float sum whose
    order differs, so it agrees to ~1e-5 rad (atol 1e-4); a keypoint whose
    angle sits on a 12-degree bin boundary could take the other bin and
    change its descriptor, which is what the 2% allows for."""
    fj = jext.extract(jnp.asarray(gray), SORB, 120, 160)
    ft = text.extract(torch.from_numpy(gray), TORB, 120, 160)
    same = (np.asarray(fj.uv) == ft.uv.numpy()).all(1) & \
        (np.asarray(fj.level) == ft.level.numpy()) & \
        (np.asarray(fj.valid) == ft.valid.numpy())
    assert same.mean() >= 0.98
    desc_same = (np.asarray(fj.desc) == ft.desc.numpy()).all(1)[same]
    assert desc_same.mean() >= 0.98
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle), atol=1e-4)
    np.testing.assert_array_equal(ft.response.numpy(), np.asarray(fj.response))
    assert int(ft.valid.sum()) > 150


def test_build_frame_exact(gray):
    """Given the same features, depth and mask, the frame is identical."""
    fr = jsyn.render_frame(3, SCAM, with_dynamic=True)
    fj = jext.extract(jnp.asarray(gray), SORB, 120, 160)
    mask = 1.0 - np.asarray(fr.dyn_mask, np.float32)
    out_j = jframe.build_frame(fj, fr.depth, jnp.asarray(mask), SCAM)
    feats_t = text.Features(*(torch.from_numpy(np.array(x)) for x in fj))
    out_t = tframe.build_frame(feats_t, torch.from_numpy(np.array(fr.depth)),
                               torch.from_numpy(mask), TCAM)
    for name in out_j._fields:
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)
    assert not out_t.valid.numpy().all()          # the mask culled keypoints
    np.testing.assert_array_equal(
        tframe.erode_mask(torch.from_numpy(mask), 7).numpy(),
        np.asarray(jframe.erode_mask(jnp.asarray(mask), 7)))
