"""Many sequences tracked at once on one card (port of
gdslam_tpu.parallel.batch_eval).

BASELINE config 5, "Batched multi-sequence eval": one TUM-style sequence
per slot, each slot the FULL per-frame tracker (feature extraction, the
optional GD scene-flow masker, motion-model + local-map tracking, the RGB-D
keyframe decision, keyframe and map-point insertion into the slot's own map
arena, point culling, local BA at keyframe rate, and relocalization of a lost
slot from its recent keyframes). The public state is a [B]-leading SeqState
of tensors with the JAX field names and dtypes.

The JAX module shards its step over a device mesh with shard_map, one
sequence a device (`make_mesh`), and reduces the metric with a psum. The
port runs B sequences on one card: there is no mesh, no shard_map and no
collective, and `mean_inliers` is the slots' inlier sum over B, computed on
the card. With one sequence a device the JAX step's lax.cond branches stay
real branches, and that is the meaning kept here: each slot runs only the
branch its predicates pick. Several sequences a device make the JAX step
vmap and run every branch for every slot (its `local_batch > 1`, which it
warns is uniformly slower); the port has no such mode, and so no
`local_batch` and no warning.

Host reads. The tracking programs take host values (the keyframe cursor,
the reference keyframe, the velocity flag), so what only the step itself
sets is mirrored on the host beside the tensors (`HostMirror`). The
predicates of all B slots come to the host in one copy: the narrow
motion-model search's statistics of the tracking slots, the init gates and
the relocalization acceptances. Only when some slot's narrow search found
fewer than 10 inliers does a second copy follow, the wide retry's
statistics. The keyframe decision is the JAX rule evaluated on the host on
those integers. Between the reads every slot's work is queued back to back,
and keyframe insertion and local BA are never read back within the step. A
relocalizing slot's PnP RANSAC adds the waits of its SVDs (torch reads their
convergence flags on the host).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gdslam_tpu_torch.backend import ba as ba_mod
from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend import optimizer, solvers
from gdslam_tpu_torch.config import SlamConfig
from gdslam_tpu_torch.core import prng
from gdslam_tpu_torch.frontend import extractor
from gdslam_tpu_torch.frontend.frame import Frame, build_frame
from gdslam_tpu_torch.masking import geomask
from gdslam_tpu_torch.system import tracking as trk

RELOC_CANDIDATES = 4            # recent keyframes tried per relocalization
RELOC_KEY = prng.prng_key(3)    # relocalization draws under fold_in(RELOC_KEY, frame_idx)
GD_KEY = prng.prng_key(7)       # the GD pose RANSAC under fold_in(GD_KEY, frame_idx)


class GdRing(NamedTuple):
    """Per-slot GD frame ring: the most recent R frames (oldest first) with
    their extracted features, so gd_step_core pairs frame t with t-R
    (GeoMaskMaker's inter_frame_size pairing, GeoMaskMaker.cc:409-429)."""

    gray: torch.Tensor           # [R, H, W] float32
    depth: torch.Tensor          # [R, H, W] float32 metres, full resolution
    feats: extractor.Features    # [R, N, ...]-leading stacked
    count: torch.Tensor          # int32: frames pushed so far


class HostMirror(NamedTuple):
    """A slot's scalars that only the step sets, mirrored on the host so the
    step reads none of them from the card."""

    initialized: bool
    lost: bool
    has_velocity: bool
    n_kf: int
    frame_idx: int
    ref_kf: int
    frames_since_kf: int
    gd_count: int


class SeqState(NamedTuple):
    """A sequence's whole tracker state: the map arena plus every scalar the
    keyframe decision needs (Tracking.cc:1306-1390), as tensors; `host` is
    the HostMirror of one slot, or a tuple of them for [B]-leading states
    (None: read from the card once, at the next step)."""

    arena: ma.MapArena
    last_frame: Frame
    last_T_cw: torch.Tensor        # [4, 4]
    last_assoc: torch.Tensor       # [N] int32
    velocity: torch.Tensor         # [4, 4]
    has_velocity: torch.Tensor     # bool
    initialized: torch.Tensor      # bool
    lost: torch.Tensor             # bool
    ref_kf: torch.Tensor           # int32
    ref_kf_matches: torch.Tensor   # int32
    frames_since_kf: torch.Tensor  # int32
    frame_idx: torch.Tensor        # int32 (doubles as the timestamp)
    gd: Optional[GdRing] = None    # present when the slot runs GD masking
    host: object = None


def _tree_map(fn, *trees):
    """fn over the tensors of NamedTuples of tensors (None stays None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    return type(t)(*(_tree_map(fn, *(getattr(x, f) for x in trees)) for f in t._fields))


def _tensors(state: SeqState) -> SeqState:
    return state._replace(host=None)


def mirrors(initialized, lost, has_velocity, n_kf, frame_idx, ref_kf, frames_since_kf,
            gd_count):
    """HostMirror from host arrays of the state's fields: one mirror for 0-d
    arrays, a tuple of B for [B] ones."""
    cols = [np.asarray(c) for c in (initialized, lost, has_velocity, n_kf, frame_idx, ref_kf,
                                    frames_since_kf, gd_count)]
    kinds = (bool, bool, bool, int, int, int, int, int)
    rows = [HostMirror(*(k(c) for k, c in zip(kinds, vals)))
            for vals in zip(*(np.atleast_1d(c) for c in cols))]
    return rows[0] if cols[0].ndim == 0 else tuple(rows)


def read_host(state: SeqState):
    """The HostMirror of `state` (one, or a tuple for [B]-leading states),
    read from its tensors in one copy."""
    count = state.gd.count if state.gd is not None else torch.zeros_like(state.frame_idx)
    return mirrors(*trk._read(state.initialized, state.lost, state.has_velocity,
                              state.arena.n_kf, state.frame_idx, state.ref_kf,
                              state.frames_since_kf, count))


def _empty_frame(n: int, device) -> Frame:
    f32 = dict(dtype=torch.float32, device=device)
    return Frame(uv=torch.zeros((n, 2), **f32), uv_raw=torch.zeros((n, 2), **f32),
                 ur=-torch.ones(n, **f32), depth=torch.zeros(n, **f32),
                 level=torch.zeros(n, dtype=torch.int32, device=device),
                 angle=torch.zeros(n, **f32), response=torch.zeros(n, **f32),
                 desc=torch.zeros((n, 32), dtype=torch.uint8, device=device),
                 valid=torch.zeros(n, dtype=torch.bool, device=device))


def _empty_feats(n: int, device) -> extractor.Features:
    f32 = dict(dtype=torch.float32, device=device)
    return extractor.Features(
        uv=torch.zeros((n, 2), **f32), response=torch.zeros(n, **f32),
        angle=torch.zeros(n, **f32), level=torch.zeros(n, dtype=torch.int32, device=device),
        desc=torch.zeros((n, 32), dtype=torch.uint8, device=device),
        valid=torch.zeros(n, dtype=torch.bool, device=device))


def _flag(v: bool, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.bool, device=device)


def _i32(v: int, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=device)


def init_seq_state(cfg: SlamConfig, kmax: int = 64, pmax: int = 8192, use_gd: bool = False,
                   device="cuda") -> SeqState:
    """The empty state of one sequence; with use_gd a ring of
    cfg.geomask.inter_frame_size frames for the GD masker."""
    dev = torch.device(device)
    n = cfg.orb.n_features
    gd = None
    if use_gd:
        R, H, W = cfg.geomask.inter_frame_size, cfg.camera.height, cfg.camera.width
        gd = GdRing(gray=torch.zeros((R, H, W), device=dev),
                    depth=torch.zeros((R, H, W), device=dev),
                    feats=_tree_map(lambda x: x[None].repeat(R, *([1] * x.dim())),
                                    _empty_feats(n, dev)),
                    count=_i32(0, dev))
    eye = torch.eye(4, device=dev)
    return SeqState(
        arena=ma.new_arena(kmax, pmax, n, dev), last_frame=_empty_frame(n, dev),
        last_T_cw=eye, last_assoc=-torch.ones(n, dtype=torch.int32, device=dev),
        velocity=eye.clone(), has_velocity=_flag(False, dev), initialized=_flag(False, dev),
        lost=_flag(False, dev), ref_kf=_i32(0, dev), ref_kf_matches=_i32(0, dev),
        frames_since_kf=_i32(0, dev), frame_idx=_i32(0, dev), gd=gd,
        host=HostMirror(False, False, False, 0, 0, 0, 0, 0))


def init_states(batch: int, cfg: SlamConfig, kmax: int = 64, pmax: int = 8192,
                use_gd: bool = False, device="cuda") -> SeqState:
    """[batch]-leading SeqState, the empty per-sequence state tiled."""
    tmpl = init_seq_state(cfg, kmax=kmax, pmax=pmax, use_gd=use_gd, device=device)
    out = _tree_map(lambda x: x[None].repeat(batch, *([1] * x.dim())), _tensors(tmpl))
    return out._replace(host=(tmpl.host,) * batch)


def unstack(states: SeqState) -> list[SeqState]:
    """The slots of [B]-leading states (views of their tensors)."""
    host = states.host if states.host is not None else read_host(states)
    return [_tree_map(lambda x: x[b], _tensors(states))._replace(host=h)
            for b, h in enumerate(host)]


def stack(slots: list[SeqState]) -> SeqState:
    """[B]-leading states of a list of slots."""
    out = _tree_map(lambda *xs: torch.stack(xs), *(_tensors(s) for s in slots))
    return out._replace(host=tuple(s.host for s in slots))


def _ref_matches_after_insert(arena: ma.MapArena, n_kf: int) -> torch.Tensor:
    """The newest keyframe's tracked points (n_kf keyframes in the arena)."""
    min_obs = 3 if n_kf > 2 else (2 if n_kf == 2 else 1)
    return trk.ref_tracked_points(arena, n_kf - 1, min_obs).to(torch.int32)


def device_relocalize(arena: ma.MapArena, frame: Frame, cfg: SlamConfig, frame_idx: int,
                      n_kf: int):
    """Relocalization of a lost slot (Relocalization, Tracking.cc:1670-1832)
    against its RELOC_CANDIDATES most recent keyframes (the batched system
    has no per-slot BoW database): each matched with the all-pairs ratio
    test (the match_top2 kernel), the best by match count (the first among
    equal counts) feeding a 2D-3D PnP RANSAC under fold_in(PRNGKey(3),
    frame_idx), the pose refined and grown against the local map with a
    >= 50-inlier acceptance. Nothing is read on the host but the RANSAC's
    SVD flags.

    Returns (ok, T, assoc, n_inl, arena'): arena' carries the visible/found
    bookkeeping and is adopted only on acceptance."""
    cam, dev = cfg.camera, frame.uv.device
    n_ms, m_idxs = [], []
    for i in range(RELOC_CANDIDATES):
        kf = n_kf - 1 - i
        if kf < 0:
            # no such keyframe: the JAX battery masks every row of it out
            m_idxs.append(torch.full_like(frame.level, -1))
            n_ms.append(torch.zeros((), dtype=torch.int64, device=dev))
            continue
        kf_ok = arena.kf_valid[kf]
        m_idx, n_m = trk._dense_ratio_matches(frame, arena.kf_uv[kf], arena.kf_desc[kf],
                                              arena.kf_level[kf], arena.kf_kp_valid[kf] & kf_ok,
                                              cfg.orb.n_levels)
        m_idxs.append(m_idx)
        n_ms.append(torch.where(kf_ok, n_m, 0))
    best = torch.argmax(torch.stack(n_ms)).reshape(1)
    kf = torch.clamp((n_kf - 1) - best, min=0)
    m_idx = torch.stack(m_idxs).index_select(0, best)[0]
    pt = ma.row(arena.kf_obs, kf)[m_idx.clamp(min=0).long()]
    pt_rows = pt.clamp(min=0).long()
    has_pt = (m_idx >= 0) & (pt >= 0) & arena.pt_valid[pt_rows]
    pw = arena.pt_pos[pt_rows]
    K = trk._K(cfg)
    res = solvers.ransac_pnp(pw, frame.uv, has_pt, K, n_iters=128, min_inliers=10,
                             px_threshold=5.991 ** 0.5, key=prng.fold_in(RELOC_KEY, frame_idx))
    matched = has_pt & res.inliers
    obs = optimizer.PoseObs(pw=torch.where(matched[:, None], pw, 0.0), uv=frame.uv,
                            ur=frame.ur,
                            inv_sigma2=trk._inv_sigma2(frame.level, float(cfg.orb.scale_factor)),
                            valid=matched)
    T, inl, n_inl = optimizer.pose_optimization(res.T, obs, K, cam.bf)
    assoc0 = torch.where(inl & matched, pt, -1)
    arena2, T2, assoc2, n2 = trk.track_local_map(arena, frame, T, cfg, assoc0)
    ok = res.ok & (n_inl >= 10) & (n2 >= 50) & (has_pt.sum() >= 15)
    return ok, T2, assoc2, n2, arena2


def _init_gate(frame: Frame, cfg: SlamConfig) -> torch.Tensor:
    n = cfg.orb.n_features
    return (frame.valid.sum() >= min(cfg.tracking.min_init_features, n // 2)) & \
        ((frame.valid & (frame.depth > 0)).sum() >= min(100, n // 4))


def _track(st: SeqState, frame: Frame, cfg: SlamConfig, wide: bool):
    """track_frame_core on a slot: the narrow search from the predicted pose,
    or the JAX program's wide retry from the last pose."""
    h = st.host
    last = trk.FrameState(frame=st.last_frame, T_cw=st.last_T_cw, assoc=st.last_assoc)
    return trk.track_frame_core(st.arena, last, st.velocity, h.has_velocity, frame, cfg,
                                h.ref_kf, wide=wide)


def _need_keyframe(cfg: SlamConfig, n_inl: int, close_tracked: int, close_untracked: int,
                   fsk: int, ref_kf_matches: int, n_kf: int, kmax: int) -> bool:
    """The JAX step's RGB-D NeedNewKeyFrame rules (Tracking.cc:1306-1390) on
    a tracked frame's integers; fsk counts this frame."""
    need_close = close_tracked < 100 and close_untracked > 70 and (fsk >= 3 or n_inl < 40)
    c1a = fsk >= int(cfg.camera.fps)
    c2 = (n_inl < 0.75 * max(ref_kf_matches, 1) or need_close) and n_inl > 15
    return (c2 or (c1a and n_inl > 15)) and n_kf < kmax - 1


def _insert_tracked_keyframe(st: SeqState, frame: Frame, cfg: SlamConfig) -> SeqState:
    """fuse -> insert -> cull -> local BA (5 + 5, from the third keyframe on)
    on a slot that just tracked `frame`."""
    h, dev = st.host, st.last_T_cw.device
    kf = h.n_kf
    assoc = trk.fuse_associate(st.arena, frame, st.last_T_cw, st.last_assoc, cfg)
    arena, assoc = trk._insert_keyframe(st.arena, frame, st.last_T_cw, assoc,
                                        float(h.frame_idx), cfg, kf_id=kf)
    arena = trk.cull_points(arena)
    if kf + 1 >= 3:
        arena, _ = ba_mod.run_local_ba(arena, ba_mod.build_problem(arena, kf, cfg), cfg, 5, 5)
    return st._replace(arena=arena, last_assoc=assoc, last_T_cw=arena.kf_pose[kf],
                       ref_kf=_i32(kf, dev),
                       ref_kf_matches=_ref_matches_after_insert(arena, kf + 1),
                       frames_since_kf=_i32(0, dev),
                       host=h._replace(n_kf=kf + 1, ref_kf=kf, frames_since_kf=0))


def _extract_and_mask(st: SeqState, gray, depth, mask, cfg: SlamConfig):
    """Extraction, the GD masker once the ring is warm (warm-up frames pass
    the mask through, cc:171-175) and the ring's shift, then the frame."""
    cam = cfg.camera
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    ring = st.gd
    if ring is not None:
        if st.host.gd_count >= ring.gray.shape[0]:
            mask = geomask.gd_step_core(feats, gray, depth, mask, ring.gray[0], ring.depth[0],
                                        _tree_map(lambda x: x[0], ring.feats), cfg,
                                        key=prng.fold_in(GD_KEY, st.host.frame_idx))
        st = st._replace(
            gd=GdRing(gray=torch.cat([ring.gray[1:], gray[None]]),
                      depth=torch.cat([ring.depth[1:], depth[None]]),
                      feats=_tree_map(lambda a, x: torch.cat([a[1:], x[None]]), ring.feats,
                                      feats),
                      count=ring.count + 1),
            host=st.host._replace(gd_count=st.host.gd_count + 1))
    return st, build_frame(feats, depth, mask, cam)


def track_slots(slots: list[SeqState], grays, depths, masks, cfg: SlamConfig):
    """One frame of every slot (slot b: grays[b], depths[b], masks[b] on the
    card). Returns (slots', stats [B, 4] int32 on the card: n1, n_inl, n_kf,
    min(n_pt, 2**30)). Each slot gives what gdslam_tpu's device_track_step
    gives it."""
    slots = [s if s.host is not None else s._replace(host=read_host(s)) for s in slots]
    built = [_extract_and_mask(s, g, d, m, cfg) for s, g, d, m in zip(slots, grays, depths, masks)]
    slots, frames = [s for s, _ in built], [f for _, f in built]

    # Every slot's branch up to its predicate, queued back to back, then the
    # predicates of all slots in one copy.
    work, probes = [], []
    for st, frame in zip(slots, frames):
        h = st.host
        if not h.initialized:
            w = ("init", _init_gate(frame, cfg))
            probes.append([w[1]])
        elif h.lost:
            w = ("reloc", device_relocalize(st.arena, frame, cfg, h.frame_idx, h.n_kf))
            probes.append([w[1][0]])
        else:
            w = ("track", _track(st, frame, cfg, wide=False))
            probes.append([w[1][4], st.ref_kf_matches])
        work.append(w)
    got = _read_groups(probes)
    retry = [b for b, w in enumerate(work) if w[0] == "track" and got[b][0][0] < 10]
    for b in retry:   # the motion model's wide retry (see track_frame_core)
        work[b] = ("track", _track(slots[b], frames[b], cfg, wide=True))
    if retry:
        for b, g in zip(retry, _read_groups([[work[b][1][4]] for b in retry])):
            got[b][0] = g[0]

    out, stats = [], []
    for st, frame, (kind, w), g in zip(slots, frames, work, got):
        st, tstats = _apply(kind, st, frame, w, g, cfg)
        st = st._replace(frame_idx=st.frame_idx + 1,
                         host=st.host._replace(frame_idx=st.host.frame_idx + 1))
        stats.append(torch.cat([tstats.to(torch.int32), torch.stack(
            [st.arena.n_kf, torch.clamp(st.arena.n_pt, max=1 << 30)]).to(torch.int32)]))
        out.append(st)
    return out, torch.stack(stats)


def _read_groups(groups: list[list[torch.Tensor]]) -> list[list[np.ndarray]]:
    """trk._read of every tensor of `groups` in one copy, regrouped."""
    flat = trk._read(*(t for g in groups for t in g))
    out, i = [], 0
    for g in groups:
        out.append(flat[i:i + len(g)])
        i += len(g)
    return out


def _apply(kind: str, st: SeqState, frame: Frame, w, got, cfg: SlamConfig):
    """A slot's branch after its predicates were read: (slot', [n1, n_inl])."""
    h, dev = st.host, st.last_T_cw.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if kind == "init":
        if got[0]:
            eye = torch.eye(4, device=dev)
            arena, assoc = trk._insert_keyframe(
                st.arena, frame, eye, -torch.ones(frame.uv.shape[0], dtype=torch.int32,
                                                  device=dev),
                float(h.frame_idx), cfg, max_depth=1e9, kf_id=h.n_kf)
            st = st._replace(
                arena=arena, last_frame=frame, last_T_cw=eye, last_assoc=assoc,
                initialized=_flag(True, dev), ref_kf=_i32(0, dev),
                ref_kf_matches=_ref_matches_after_insert(arena, h.n_kf + 1),
                frames_since_kf=_i32(0, dev),
                host=h._replace(initialized=True, n_kf=h.n_kf + 1, ref_kf=0, frames_since_kf=0))
        return st, torch.stack([zero, zero])
    if kind == "reloc":
        ok, T2, assoc2, n2, arena2 = w
        if not got[0]:
            return st, torch.stack([zero, zero])
        # the velocity stays cleared: one frame of map search re-establishes it
        st = st._replace(arena=arena2, last_frame=frame, last_T_cw=T2, last_assoc=assoc2,
                         has_velocity=_flag(False, dev), lost=_flag(False, dev),
                         frames_since_kf=st.frames_since_kf + 1,
                         host=h._replace(has_velocity=False, lost=False,
                                         frames_since_kf=h.frames_since_kf + 1))
        return st, torch.stack([zero, n2.to(torch.int32)])
    arena, new_last, vel_new, _, stats = w
    n1, n_inl, close_tracked, close_untracked = (int(x) for x in got[0])
    if not (n1 >= 10 and n_inl >= 30):
        # lost: the tracked arena, with its visible/found counts, is dropped
        st = st._replace(lost=_flag(True, dev), has_velocity=_flag(False, dev),
                         host=h._replace(lost=True, has_velocity=False))
        return st, stats[:2]
    fsk = h.frames_since_kf + 1
    st = st._replace(arena=arena, last_frame=frame, last_T_cw=new_last.T_cw,
                     last_assoc=new_last.assoc, velocity=vel_new,
                     has_velocity=_flag(True, dev), lost=_flag(False, dev),
                     frames_since_kf=_i32(fsk, dev),
                     host=h._replace(has_velocity=True, lost=False, frames_since_kf=fsk))
    if _need_keyframe(cfg, n_inl, close_tracked, close_untracked, fsk, int(got[1]), h.n_kf,
                      arena.kmax):
        st = _insert_tracked_keyframe(st, frame, cfg)
    return st, stats[:2]


def device_track_step(state: SeqState, gray: torch.Tensor, depth: torch.Tensor,
                      mask: torch.Tensor, cfg: SlamConfig):
    """One frame of one sequence's full tracker (the JAX function's results):
    init, or relocalization when lost, or tracking with the keyframe rules,
    fuse + insert + cull and local BA; with a GdRing in the state the GD
    masker refines `mask` first. Returns (state', stats [4] int32 on the
    card: n1, n_inl, n_kf, min(n_pt, 2**30))."""
    out, stats = track_slots([state], [gray], [depth], [mask], cfg)
    return out[0], stats[0]


def batched_track_step(cfg: SlamConfig, height: int, width: int, kmax: int = 64,
                       pmax: int = 8192, device="cuda"):
    """The batched full-tracker step on one card: fn(states, grays [B, H, W],
    depths [B, H, W]) -> (states', mean_inliers), states [B]-leading (from
    init_states, with use_gd=True for the GD masker), mean_inliers the
    slots' n_inl sum over B as a float32 on the card. The semantic mask is
    all ones (the GD CLI's default of no mask)."""
    dev = torch.device(device)
    ones = torch.ones((height, width), dtype=torch.float32, device=dev)

    def step(states: SeqState, grays, depths):
        if states.arena.kf_pose.shape[1] != kmax or states.arena.pt_pos.shape[1] != pmax:
            raise ValueError(f"states hold kmax={states.arena.kf_pose.shape[1]}, "
                             f"pmax={states.arena.pt_pos.shape[1]}; the step was built for "
                             f"kmax={kmax}, pmax={pmax}")
        grays = torch.as_tensor(grays, dtype=torch.float32, device=dev)
        depths = torch.as_tensor(depths, dtype=torch.float32, device=dev)
        slots = unstack(states)
        new, stats = track_slots(slots, grays, depths, [ones] * len(slots), cfg)
        return stack(new), stats[:, 1].sum().to(torch.float32) / len(slots)

    return step
