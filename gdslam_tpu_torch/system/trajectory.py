"""Trajectory files in the reference's TUM format (`timestamp tx ty tz qx qy
qz qw`; System::SaveTrajectoryTUM, System.cc:418-513): the writer,
byte-compatible, and the reader; and the KITTI writer (the 3 x 4 [R | t]
of each T_wc as one row). Port of gdslam_tpu.system.trajectory."""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.core import lie


def _tum_line(ts: float, T_wc: np.ndarray) -> str:
    t = T_wc[:3, 3]
    q = lie.mat_to_quat(torch.from_numpy(np.array(T_wc[:3, :3], np.float32))).numpy()
    return (f"{ts:.6f} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
            f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n")


def save_tum(path: str, trajectory) -> None:
    """trajectory: iterable of (timestamp, T_wc 4x4)."""
    with open(path, "w") as f:
        for ts, T in trajectory:
            f.write(_tum_line(ts, np.asarray(T)))


def save_kitti(path: str, trajectory) -> None:
    """trajectory: iterable of (timestamp, T_wc 4x4); the timestamps are
    not written."""
    with open(path, "w") as f:
        for _, T in trajectory:
            row = np.asarray(T)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def load_tum(path: str):
    """Read a TUM trajectory file -> list of (timestamp, T_wc 4x4 float64);
    timestamps stay float64 (TUM epoch seconds)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = lie.quat_to_mat(torch.tensor([qx, qy, qz, qw],
                                                     dtype=torch.float32)).numpy()
            T[:3, 3] = [tx, ty, tz]
            out.append((ts, T))
    return out
