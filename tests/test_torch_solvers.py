"""Parity of the port's closed-form solvers and RANSACs
(gdslam_tpu_torch.backend.solvers) with the JAX package's on seeded numpy
scenes. The JAX functions draw their samples from a jax.random key; the
tests make the same draw and hand it to the port as `sample_idx`, so both
score the same 300 hypotheses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import solvers as jsolvers
from gdslam_tpu.core import lie as jlie
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import solvers as tsolvers
from gdslam_tpu_torch.core import prng

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

K = (160.0, 160.0, 80.0, 60.0)


def _scene(seed: int, n: int = 200, outliers: float = 0.3, noise: float = 0.1):
    """World points in front of a camera at a seeded pose: pw, the camera's
    T_cw, the points in the camera frame, their pixels with `noise` px of
    jitter; a share `outliers` of the pixels (and camera-frame points) is
    replaced by random ones; ~10% of the rows are invalid."""
    r = np.random.default_rng(seed)
    pw = (r.uniform(-1, 1, (n, 3)) * [1.2, 0.9, 0.8] + [0, 0, 3.0]).astype(np.float32)
    xi = np.concatenate([r.uniform(-0.2, 0.2, 3), r.uniform(-0.1, 0.1, 3)]).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]], 1)
    uv = (uv + r.normal(0, noise, uv.shape)).astype(np.float32)
    bad = r.random(n) < outliers
    uv[bad] = r.uniform(0, 160, (bad.sum(), 2))
    pc = pc.astype(np.float32)
    pc[bad] = (r.uniform(-1, 1, (bad.sum(), 3)) + [0, 0, 3.0]).astype(np.float32)
    valid = r.random(n) > 0.1
    return pw, T, pc, uv, valid, bad


def _jax_draw(key, valid, n_iters: int, size: int) -> np.ndarray:
    """The draw of gdslam_tpu/backend/solvers.py:85-87 and :141-143."""
    probs = jnp.asarray(valid, jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    idx = jax.random.categorical(
        key, jnp.log(probs + 1e-12)[None, :].repeat(n_iters * size, 0))
    return np.asarray(idx.reshape(n_iters, size))


@pytest.mark.parametrize("kind", ["random", "aligned", "zero"])
def test_rotation_from_cross_covariance_is_the_svd_optimum(kind):
    """Horn's quaternion form gives the rotation of the SVD with the
    reflection fix (float64 numpy) to 2e-5 on well-posed inputs, a proper
    rotation always, and the identity for H = 0. "random": any 3x3 H, half
    of them with det < 0 (where the reflection fix acts); "aligned": the
    cross-covariance of 3-point samples under a rotation plus noise."""
    r = np.random.default_rng(5)
    if kind == "random":
        H = r.normal(size=(500, 3, 3))
    elif kind == "aligned":
        P = r.normal(size=(500, 3, 3))
        T = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(r.normal(0, 0.5, (500, 6)),
                                                          jnp.float32)))
        Q = np.einsum("bij,bnj->bni", T[:, :3, :3], P) + r.normal(0, 0.01, P.shape)
        Pc, Qc = P - P.mean(1, keepdims=True), Q - Q.mean(1, keepdims=True)
        H = np.einsum("bni,bnj->bij", Pc, Qc)
    else:
        H = np.zeros((2, 3, 3))
    U, S, Vt = np.linalg.svd(H)
    d = np.linalg.det(np.einsum("bji,bkj->bik", Vt, U))
    D = np.zeros_like(H)
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = d
    want = np.einsum("bji,bjk,blk->bil", Vt, D, U)
    got = tsolvers._rotation_from_cross_covariance(torch.from_numpy(H.astype(np.float32)))
    got = got.double().numpy()
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    if kind == "zero":
        np.testing.assert_array_equal(got, np.broadcast_to(np.eye(3), got.shape))
        return
    # the optimum is unique where the two smallest singular values (with the
    # reflection's sign) are apart; compare there
    posed = (S[:, 1] + d * S[:, 2]) > 1e-2 * S[:, 0]
    assert posed.mean() > 0.9
    np.testing.assert_allclose(got[posed], want[posed], atol=2e-5)


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_alignment_matches_jax(with_scale):
    """R, t, s to 1e-5 on weighted noisy correspondences, single and batched
    (the port batches on leading dims where the JAX package vmaps)."""
    r = np.random.default_rng(0)
    P = r.normal(size=(4, 50, 3)).astype(np.float32)
    xi = r.normal(0, 0.3, (4, 6)).astype(np.float32)
    T = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    Q = (1.7 if with_scale else 1.0) * np.einsum("bij,bnj->bni", T[:, :3, :3], P) + T[:, None, :3, 3]
    Q = (Q + r.normal(0, 0.01, Q.shape)).astype(np.float32)
    w = (r.random((4, 50)) > 0.2).astype(np.float32) * r.random((4, 50)).astype(np.float32)
    want = jax.vmap(lambda p, q, ww: jsolvers.horn_alignment(p, q, ww, with_scale))(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w))
    got = tsolvers.horn_alignment(torch.from_numpy(P), torch.from_numpy(Q), torch.from_numpy(w),
                                  with_scale)
    one = tsolvers.horn_alignment(torch.from_numpy(P[0]), torch.from_numpy(Q[0]),
                                  torch.from_numpy(w[0]), with_scale)
    for g, o, wnt in zip(got, one, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(wnt)[0], atol=1e-5)
    assert abs(float(got[2][0]) - (1.7 if with_scale else 1.0)) < 0.02


@pytest.mark.parametrize("seed", [1, 2])
def test_ransac_rigid_matches_jax(seed):
    """The same 300 3-point samples: the same consensus set, count and ok,
    T to 1e-4; the pose is the scene's to 3 cm (0.1 px of pixel noise)."""
    pw, T, pc, uv, valid, bad = _scene(seed)
    key = jax.random.PRNGKey(seed)
    want = jsolvers.ransac_rigid(jnp.asarray(pw), jnp.asarray(pc), jnp.asarray(valid), key, K,
                                 jnp.asarray(uv), 300, 3, 10, 4.0)
    idx = _jax_draw(key, valid, 300, 3)
    got = convert.ransac_result_to_numpy(tsolvers.ransac_rigid(
        torch.from_numpy(pw), torch.from_numpy(pc), torch.from_numpy(valid), K,
        torch.from_numpy(uv), 300, 3, 10, 4.0, sample_idx=torch.from_numpy(idx)))
    np.testing.assert_array_equal(got["inliers"], np.asarray(want.inliers))
    assert int(got["n_inliers"]) == int(want.n_inliers) > 60 and bool(got["ok"])
    np.testing.assert_allclose(got["T"], np.asarray(want.T), atol=1e-4)
    np.testing.assert_allclose(got["T"], T, atol=3e-2)
    assert not (got["inliers"] & ~valid).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_ransac_pnp_matches_jax(seed):
    """The same 300 6-point samples through the DLT, whose null vector's sign
    is the SVD's choice and is settled by the projective-depth rule: the
    same consensus set, count and ok, T to 1e-4 after the two refits."""
    pw, T, _, uv, valid, bad = _scene(seed)
    key = jax.random.PRNGKey(seed)
    want = jsolvers.ransac_pnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid), K, 300, 10,
                               5.991 ** 0.5, key)
    idx = _jax_draw(key, valid, 300, 6)
    got = convert.ransac_result_to_numpy(tsolvers.ransac_pnp(
        torch.from_numpy(pw), torch.from_numpy(uv), torch.from_numpy(valid), K, 300, 10,
        5.991 ** 0.5, sample_idx=torch.from_numpy(idx)))
    np.testing.assert_array_equal(got["inliers"], np.asarray(want.inliers))
    assert int(got["n_inliers"]) == int(want.n_inliers) > 60 and bool(got["ok"])
    np.testing.assert_allclose(got["T"], np.asarray(want.T), atol=1e-4)
    np.testing.assert_allclose(got["T"], T, atol=5e-2)


def test_ransac_draws_from_the_generator():
    """Without sample_idx the port draws under its key (the JAX package's
    draw; there is no torch generator any more): the same key gives the
    same result, only valid rows are sampled, the scene's pose is found,
    and a draw with no key is refused."""
    pw, T, pc, uv, valid, _ = _scene(5)
    args = (torch.from_numpy(pw), torch.from_numpy(uv), torch.from_numpy(valid), K)
    a = tsolvers.ransac_pnp(*args, key=prng.prng_key(7))
    b = tsolvers.ransac_pnp(*args, key=prng.prng_key(7))
    assert torch.equal(a.T, b.T) and torch.equal(a.inliers, b.inliers) and bool(a.ok)
    np.testing.assert_allclose(a.T.numpy(), T, atol=5e-2)
    idx = tsolvers._draw(torch.from_numpy(valid), 300, 6, prng.prng_key(7), None)
    assert valid[idx.numpy()].all() and idx.shape == (300, 6)
    none = tsolvers.ransac_pnp(args[0], args[1], torch.zeros_like(args[2]), K,
                               key=prng.prng_key(7))
    assert not bool(none.ok) and int(none.n_inliers) == 0
    with pytest.raises(ValueError, match="key or sample_idx"):
        tsolvers.ransac_pnp(*args)
