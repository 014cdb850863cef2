"""Map checkpoint save/load (port of gdslam_tpu.utils.checkpoint).

The reference leaves SaveMap/LoadMap as TODOs (System.h:113-115); the flat
arena serializes to one .npz keyed by the MapArena field names, plus the
keyframes' timestamps as float64 (`kf_timestamps_f64`), the layout of the
JAX package's files, so either package reads the other's.
"""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.backend.map_arena import MapArena


def save_map(arena: MapArena, path: str, kf_timestamps: list[float] | None = None) -> None:
    extra = {}
    if kf_timestamps is not None:
        # float64 on the host: kf_time is float32, which cannot hold TUM
        # epoch timestamps (~1.3e9 s, ULP = 128 s)
        extra["kf_timestamps_f64"] = np.asarray(kf_timestamps, np.float64)
    np.savez_compressed(path, **{k: getattr(arena, k).cpu().numpy() for k in MapArena._fields},
                        **extra)


def load_map(path: str, device="cuda") -> MapArena:
    return load_map_with_timestamps(path, device)[0]


def load_map_with_timestamps(path: str, device="cuda") -> tuple[MapArena, list[float]]:
    with np.load(path) as z:
        arena = MapArena(**{k: torch.from_numpy(np.array(z[k])).to(device)
                            for k in MapArena._fields})
        ts = [float(t) for t in z["kf_timestamps_f64"]] if "kf_timestamps_f64" in z else []
    return arena, ts
