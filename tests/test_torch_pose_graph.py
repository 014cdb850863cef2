"""Parity of the port's Lie-group additions and pose graphs
(gdslam_tpu_torch.core.lie's logs and Sim3 group, backend.pose_graph) with
the JAX package on the CPU, and counterparts of tests/test_loop.py's
TestPoseGraph and TestSim3Graph checks on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import pose_graph as jpg
from gdslam_tpu.core import lie as jlie
from gdslam_tpu.utils import metrics
from gdslam_tpu_torch.backend import pose_graph as tpg
from gdslam_tpu_torch.core import lie as tlie

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# the Sim3 group and the logs of SO3 / SE3
# --------------------------------------------------------------------------

def test_lie_logs_and_sim3_group_match_jax():
    rng = np.random.default_rng(5)
    xis = (rng.normal(size=(32, 7)) * 0.5).astype(np.float32)
    xis[0] = 0.0
    xis[1, 3:6] = [1e-9, 0, 0]
    xis[2, 6] = 0.0
    Rj, tj, sj = jlie.sim3_exp(jnp.asarray(xis))
    Rt, tt, st = tlie.sim3_exp(t(xis))
    for a, b in ((Rj, Rt), (tj, tt), (sj, st)):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(n(tlie.sim3_log(Rt, tt, st)), np.asarray(jlie.sim3_log(Rj, tj, sj)),
                               atol=1e-5)
    np.testing.assert_allclose(n(tlie.sim3_log(Rt, tt, st)), xis, atol=1e-5)   # round trip
    p = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.sim3_apply(Rt, tt, st, t(p))),
                               np.asarray(jlie.sim3_apply(Rj, tj, sj, jnp.asarray(p))), atol=1e-5)
    for a, b in zip(jlie.sim3_inverse(Rj, tj, sj), tlie.sim3_inverse(Rt, tt, st)):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-5)
    comp_j = jlie.sim3_compose(Rj, tj, sj, Rj[::-1], tj[::-1], sj[::-1])
    comp_t = tlie.sim3_compose(Rt, tt, st, Rt.flip(0), tt.flip(0), st.flip(0))
    for a, b in zip(comp_j, comp_t):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-5)
    # SO3 / SE3 logs, the inverse left Jacobian and vee
    T = jlie.se3_exp(jnp.asarray(xis[:, :6]))
    np.testing.assert_allclose(n(tlie.se3_log(t(np.asarray(T)))), np.asarray(jlie.se3_log(T)),
                               atol=1e-5)
    np.testing.assert_allclose(n(tlie.so3_log(t(np.asarray(T))[:, :3, :3])),
                               np.asarray(jlie.so3_log(T[:, :3, :3])), atol=1e-5)
    w = jnp.asarray(xis[:, 3:6])
    np.testing.assert_allclose(n(tlie._so3_left_jacobian_inv(t(xis[:, 3:6]))),
                               np.asarray(jlie._so3_left_jacobian_inv(w)), atol=1e-5)
    np.testing.assert_array_equal(n(tlie.vee(tlie.hat(t(xis[:, :3])))), xis[:, :3])
    Ws = jlie._sim3_W(w, jnp.asarray(xis[:, 6]))
    np.testing.assert_allclose(n(tlie._sim3_W(t(xis[:, 3:6]), t(xis[:, 6]))), np.asarray(Ws),
                               atol=1e-5)


# --------------------------------------------------------------------------
# the pose graphs (counterparts of tests/test_loop.py's TestPoseGraph and
# TestSim3Graph, and the JAX functions on the same edges)
# --------------------------------------------------------------------------

def _chain(K=16, n_=12):
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n_):
        xi = jnp.asarray([0.5, 0, 0, 0, 2 * np.pi / n_, 0], jnp.float32)
        gt.append(np.asarray(jlie.se3_exp(xi) @ jnp.asarray(gt[-1])))
    gt = np.stack(gt + [np.eye(4, dtype=np.float32)] * (K - n_))
    est = gt.copy()
    for k in range(1, n_):
        est[k] = np.asarray(jlie.se3_exp(jnp.asarray([0.02 * k, 0.01 * k, 0, 0, 0.01 * k, 0]))
                            @ jnp.asarray(gt[k]))
    valid = np.asarray([True] * n_ + [False] * (K - n_))
    parent = np.asarray([-1] + list(range(n_ - 1)) + [-1] * (K - n_), np.int32)
    covis = np.zeros((K, K), np.int32)
    covis[3, 7] = covis[7, 3] = 120
    return gt, est, valid, parent, covis, (gt[n_ - 1] @ np.linalg.inv(gt[0])).astype(np.float32)


def test_pose_graph_matches_jax_and_closes_the_loop():
    gt, est, valid, parent, covis, T_meas = _chain()
    n_ = int(valid.sum())
    loop = (np.asarray([n_ - 1], np.int32), np.asarray([0], np.int32), T_meas[None],
            np.asarray([True]))
    ej = jpg.build_edges(jnp.asarray(est), jnp.asarray(valid), jnp.asarray(parent),
                         jnp.asarray(covis), *map(jnp.asarray, loop), max_covis_edges=4)
    et = tpg.build_edges(t(est), t(valid), t(parent), t(covis), *map(t, loop), max_covis_edges=4)
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(n(getattr(et, f)), np.asarray(getattr(ej, f)))
    np.testing.assert_allclose(n(et.T_meas), np.asarray(ej.T_meas), atol=1e-5)
    out_j = np.asarray(jpg.optimize(jnp.asarray(est), jnp.asarray(valid), ej, iters=30))
    out = n(tpg.optimize(t(est), t(valid), et, iters=30))
    np.testing.assert_allclose(out, out_j, atol=1e-3)
    # the loop edge's residual shrinks to a tenth (TestPoseGraph)
    r_end = n(tlie.se3_log(t(np.linalg.inv(T_meas) @ out[n_ - 1] @ np.linalg.inv(out[0]))))
    r_before = n(tlie.se3_log(t((np.linalg.inv(T_meas) @ est[n_ - 1] @ np.linalg.inv(est[0]))
                                .astype(np.float32))))
    assert np.linalg.norm(r_end) < 0.1 * np.linalg.norm(r_before)
    # no edges: the poses stay (test_no_edges_is_stable)
    K = 8
    poses = torch.eye(4).repeat(K, 1, 1)
    e0 = tpg.build_edges(poses, torch.ones(K, dtype=torch.bool), -torch.ones(K, dtype=torch.int32),
                         torch.zeros((K, K), dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.int32), torch.zeros((0, 4, 4)),
                         torch.zeros(0, dtype=torch.bool), max_covis_edges=4)
    np.testing.assert_allclose(n(tpg.optimize(poses, torch.ones(K, dtype=torch.bool), e0,
                                              iters=3)), n(poses), atol=1e-4)


def _circle(K):
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        Rwc = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        T = np.eye(4)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ np.asarray([2 * np.cos(a), 0.0, 2 * np.sin(a)])
        gt.append(T)
    return np.asarray(gt, np.float32)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_graph_matches_jax(fix_scale):
    """TestSim3Graph's drifted circle: the port's 7-dof graph against the
    JAX one on the same edges, the scale ramp, and bFixScale."""
    K = 20
    gt = _circle(K)
    d = 1.2 ** (1.0 / (K - 1))
    est = [gt[0]]
    for k in range(1, K):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        rel[:3, 3] *= d ** k
        est.append(rel @ est[-1])
    est = np.asarray(est, np.float32)
    parent = np.asarray([-1] + list(range(K - 1)), np.int32)
    loop = (np.asarray([K - 1], np.int32), np.asarray([0], np.int32),
            (gt[K - 1] @ np.linalg.inv(gt[0])).astype(np.float32)[None], np.asarray([True]))
    ej = jpg.build_edges(jnp.asarray(est), jnp.ones(K, bool), jnp.asarray(parent),
                         jnp.zeros((K, K), jnp.int32), *map(jnp.asarray, loop), max_covis_edges=8,
                         loop_s=jnp.asarray([1.2]))
    et = tpg.build_edges(t(est), torch.ones(K, dtype=torch.bool), t(parent),
                         torch.zeros((K, K), dtype=torch.int32), *map(t, loop), max_covis_edges=8,
                         loop_s=torch.tensor([1.2]))
    Rj, tj, sj = jpg.optimize_sim3_graph(jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
                                         jnp.ones(K), jnp.ones(K, bool), ej, fix_scale=fix_scale)
    R, tt, s = tpg.optimize_sim3_graph(t(est[:, :3, :3]), t(est[:, :3, 3]), torch.ones(K),
                                       torch.ones(K, dtype=torch.bool), et, fix_scale=fix_scale)
    np.testing.assert_allclose(n(R), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(n(tt), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(n(s), np.asarray(sj), atol=1e-3)
    s = n(s)
    if fix_scale:
        np.testing.assert_allclose(s, 1.0, atol=1e-6)
    else:
        assert abs(s[-1] / s[0] - 1.2) < 0.02 and np.all(np.diff(s) > -0.01)
        rec = np.zeros((K, 4, 4), np.float32)
        rec[:, :3, :3] = n(R)
        rec[:, :3, 3] = n(tt) / s[:, None]
        rec[:, 3, 3] = 1

        def ate(poses):
            return metrics.ate_rmse(np.stack([np.linalg.inv(p)[:3, 3] for p in poses]),
                                    np.stack([np.linalg.inv(p)[:3, 3] for p in gt]))
        assert ate(rec) < 0.25 * ate(est)
