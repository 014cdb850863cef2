"""State carried between the JAX package and the port as plain numpy.

A caller turns the JAX tracker's state into numpy (`np.asarray` on each
leaf) and loads it here, or the reverse; fields are matched by name, so
neither side imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from gdslam_tpu_torch.backend.ba import LocalBAProblem
from gdslam_tpu_torch.backend.keyframe_db import BowDatabase
from gdslam_tpu_torch.backend.map_arena import MapArena
from gdslam_tpu_torch.backend.solvers import RansacResult
from gdslam_tpu_torch.backend.vocabulary import Vocabulary
from gdslam_tpu_torch.config import (CameraConfig, GeoMaskConfig, GeometryConfig, OrbConfig,
                                     SlamConfig, TrackingConfig)
from gdslam_tpu_torch.frontend.extractor import Features
from gdslam_tpu_torch.frontend.frame import Frame
from gdslam_tpu_torch.masking.geometry import GeometryDB
from gdslam_tpu_torch.system.tracking import FrameState


def _to_torch(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def arena_from_numpy(d: dict, device="cuda") -> MapArena:
    """MapArena from a {field: array} dict (every MapArena field)."""
    return MapArena(**{k: _to_torch(d[k], device) for k in MapArena._fields})


def arena_to_numpy(arena: MapArena) -> dict:
    return {k: getattr(arena, k).cpu().numpy() for k in MapArena._fields}


def ba_problem_from_numpy(d: dict, device="cuda") -> LocalBAProblem:
    """LocalBAProblem from a {field: array} dict (either package's)."""
    return LocalBAProblem(**{k: _to_torch(d[k], device) for k in LocalBAProblem._fields})


def ba_problem_to_numpy(prob: LocalBAProblem) -> dict:
    return {k: getattr(prob, k).cpu().numpy() for k in LocalBAProblem._fields}


def ransac_result_to_numpy(res: RansacResult) -> dict:
    return {k: getattr(res, k).cpu().numpy() for k in RansacResult._fields}


def frame_state_from_numpy(d: dict, device="cuda") -> FrameState:
    """FrameState from a dict of the Frame fields plus `T_cw` and `assoc`."""
    frame = Frame(**{k: _to_torch(d[k], device) for k in Frame._fields})
    return FrameState(frame=frame, T_cw=_to_torch(d["T_cw"], device),
                      assoc=_to_torch(d["assoc"], device))


def frame_state_to_numpy(fs: FrameState) -> dict:
    d = {k: getattr(fs.frame, k).cpu().numpy() for k in Frame._fields}
    d["T_cw"] = fs.T_cw.cpu().numpy()
    d["assoc"] = fs.assoc.cpu().numpy()
    return d


def features_from_numpy(d: dict, device="cuda") -> Features:
    """Features from a {field: array} dict (every Features field)."""
    return Features(**{k: _to_torch(d[k], device) for k in Features._fields})


def features_to_numpy(feats: Features) -> dict:
    return {k: getattr(feats, k).cpu().numpy() for k in Features._fields}


def config_from_jax_dict(d: dict) -> SlamConfig:
    """SlamConfig from `dataclasses.asdict` of the JAX package's SlamConfig."""
    return SlamConfig(camera=CameraConfig(**d["camera"]), orb=OrbConfig(**d["orb"]),
                      geomask=GeoMaskConfig(**d["geomask"]),
                      geometry=GeometryConfig(**d["geometry"]),
                      tracking=TrackingConfig(**d["tracking"]))


def geometry_db_from_numpy(d: dict, device="cuda") -> GeometryDB:
    """GeometryDB from a {field: array} dict (every GeometryDB field)."""
    return GeometryDB(**{k: _to_torch(d[k], device) for k in GeometryDB._fields})


def geometry_db_to_numpy(db: GeometryDB) -> dict:
    return {k: getattr(db, k).cpu().numpy() for k in GeometryDB._fields}


def bow_db_from_numpy(d: dict, device="cuda") -> BowDatabase:
    """BowDatabase from a {field: array} dict (every BowDatabase field)."""
    return BowDatabase(**{k: _to_torch(d[k], device) for k in BowDatabase._fields})


def bow_db_to_numpy(db: BowDatabase) -> dict:
    return {k: getattr(db, k).cpu().numpy() for k in BowDatabase._fields}


def vocabulary_from_numpy(centers, k: int, levels: int, device="cuda") -> Vocabulary:
    """Vocabulary from its centres [n_nodes, 32] uint8 and its shape."""
    return Vocabulary(centers=_to_torch(np.asarray(centers, np.uint8), device), k=int(k),
                      levels=int(levels))
