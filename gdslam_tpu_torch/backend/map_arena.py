"""Fixed-capacity device-resident map arenas (port of
gdslam_tpu.backend.map_arena).

The reference's Map/KeyFrame/MapPoint pointer graph becomes flat
preallocated tensors with validity masks. Slots grow monotonically (cursor
+ cumsum allocation); culling clears valid bits, and `compact_keyframes`
recycles culled keyframe slots once the keyframe arrays saturate.
Functions return a new arena and leave their input untouched, as the JAX
functions do; only the fields they change are copied.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdslam_tpu_torch.frontend.extractor import top_k_stable


class MapArena(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor      # [K, 4, 4] T_cw
    kf_valid: torch.Tensor     # [K] bool
    kf_time: torch.Tensor      # [K] float32 timestamp (host list is authoritative)
    kf_uv: torch.Tensor        # [K, N, 2] undistorted keypoint pixels
    kf_ur: torch.Tensor        # [K, N] right-view u (<0: mono)
    kf_depth: torch.Tensor     # [K, N] keypoint depth (0 invalid)
    kf_level: torch.Tensor     # [K, N] int32 octave
    kf_angle: torch.Tensor     # [K, N] float32
    kf_desc: torch.Tensor      # [K, N, 32] uint8
    kf_kp_valid: torch.Tensor  # [K, N] bool
    kf_obs: torch.Tensor       # [K, N] int32 map-point id per keypoint (-1 none)
    # --- map points ---
    pt_pos: torch.Tensor       # [P, 3] world position
    pt_valid: torch.Tensor     # [P] bool
    pt_desc: torch.Tensor      # [P, 32] uint8 distinctive descriptor
    pt_normal: torch.Tensor    # [P, 3] mean viewing direction
    pt_min_dist: torch.Tensor  # [P] scale-invariance range
    pt_max_dist: torch.Tensor  # [P]
    pt_ref_kf: torch.Tensor    # [P] int32 creating keyframe
    pt_n_obs: torch.Tensor     # [P] int32 keyframe observation count
    pt_visible: torch.Tensor   # [P] int32 frames where point was in frustum
    pt_found: torch.Tensor     # [P] int32 frames where point was matched
    # --- graph ---
    covis: torch.Tensor        # [K, K] int32 shared-observation weights
    kf_parent: torch.Tensor    # [K] int32 spanning-tree parent (-1 root)
    # --- cursors (0-d int32 tensors) ---
    n_kf: torch.Tensor
    n_pt: torch.Tensor

    @property
    def kmax(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def pmax(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def n_features(self) -> int:
        return self.kf_uv.shape[1]


def new_arena(kmax: int = 512, pmax: int = 65536, n_features: int = 1500,
              device="cuda") -> MapArena:
    K, P, N = kmax, pmax, n_features
    f32, i32 = dict(dtype=torch.float32, device=device), dict(dtype=torch.int32, device=device)
    b, u8 = dict(dtype=torch.bool, device=device), dict(dtype=torch.uint8, device=device)
    return MapArena(
        kf_pose=torch.eye(4, **f32).repeat(K, 1, 1),
        kf_valid=torch.zeros(K, **b),
        kf_time=torch.zeros(K, **f32),
        kf_uv=torch.zeros((K, N, 2), **f32),
        kf_ur=-torch.ones((K, N), **f32),
        kf_depth=torch.zeros((K, N), **f32),
        kf_level=torch.zeros((K, N), **i32),
        kf_angle=torch.zeros((K, N), **f32),
        kf_desc=torch.zeros((K, N, 32), **u8),
        kf_kp_valid=torch.zeros((K, N), **b),
        kf_obs=-torch.ones((K, N), **i32),
        pt_pos=torch.zeros((P, 3), **f32),
        pt_valid=torch.zeros(P, **b),
        pt_desc=torch.zeros((P, 32), **u8),
        pt_normal=torch.zeros((P, 3), **f32),
        pt_min_dist=torch.zeros(P, **f32),
        pt_max_dist=torch.zeros(P, **f32),
        pt_ref_kf=-torch.ones(P, **i32),
        pt_n_obs=torch.zeros(P, **i32),
        pt_visible=torch.ones(P, **i32),
        pt_found=torch.ones(P, **i32),
        covis=torch.zeros((K, K), **i32),
        kf_parent=-torch.ones(K, **i32),
        n_kf=torch.zeros((), **i32),
        n_pt=torch.zeros((), **i32),
    )


def set_row(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """Copy of t with row i replaced (the functional `.at[i].set`). A Python
    scalar goes in by a fill: assigning it to an element of a CUDA tensor
    would upload it, and an upload waits for the card."""
    t = t.clone()
    if isinstance(value, torch.Tensor):
        t[i] = value
    else:
        t[i].fill_(value)
    return t


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Copy of dst with rows idx[mask] set from src[mask]. Only masked rows
    are written (masked-out rows go to a dump row that is dropped), so the
    masked indices must be unique; no host sync."""
    P = dst.shape[0]
    out = torch.cat([dst, dst[:1]], 0)
    out[torch.where(mask, idx, P).long()] = src.to(dst.dtype)
    return out[:P]


def last_wins(idx: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """Of the masked rows, those that are the last to write their index:
    the order in which a serial scatter with duplicate indices (XLA on the
    CPU) resolves them, made explicit so the result is deterministic."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((size + 1,), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, torch.where(mask, idx, size).long(),
                                   torch.where(mask, rows, -1), "amax")
    return mask & (winner[torch.where(mask, idx, size).long()] == rows)


def last_writer(tgt: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """The rows of a masked scatter that decide their target: the JAX
    package writes `dst.at[tgt].set(where(mask, src, dst[tgt]))`, where a
    row outside the mask carries its target's old value (usually to a dump
    slot), and XLA on the CPU applies duplicates in row order. A row's
    value stands only if it is the last to name its target, so a masked
    row writes exactly when it is that last row; an unmasked last row puts
    the old value back. `scatter_rows(dst, tgt, src, last_writer(...))`
    gives that result without a scatter of duplicates, which has no order
    on the card."""
    return last_wins(tgt, torch.ones_like(mask), size) & mask


def row(t: torch.Tensor, i) -> torch.Tensor:
    """t[i] for a row index that may be a 0-d tensor on the device (indexing
    with one would read it on the host)."""
    if isinstance(i, torch.Tensor):
        return t.index_select(0, i.reshape(1).long())[0]
    return t[i]


def update_covisibility(arena: MapArena, kf_id: int) -> MapArena:
    """Recompute covisibility weights of keyframe `kf_id` against all others
    (KeyFrame::UpdateConnections, KeyFrame.cc:280): weight = #shared map
    points, via a point-indicator vector gathered at every keyframe's obs."""
    dev = arena.kf_obs.device
    obs_k = arena.kf_obs[kf_id]
    ind = torch.zeros(arena.pmax + 1, dtype=torch.int32, device=dev)
    ind.index_fill_(0, torch.where(obs_k >= 0, obs_k, arena.pmax).long(), 1)
    ind[arena.pmax].fill_(0)
    obs_all = torch.where(arena.kf_obs >= 0, arena.kf_obs, arena.pmax).long()
    shared = ind[obs_all].sum(dim=1, dtype=torch.int32)              # [K]
    shared = torch.where(arena.kf_valid, shared, 0)
    shared[kf_id].fill_(0)
    covis = arena.covis.clone()
    covis[kf_id, :] = shared
    covis[:, kf_id] = shared
    # Spanning-tree parent: highest-covisibility earlier keyframe (first
    # among ties, as jnp.argmax).
    earlier = torch.where(torch.arange(arena.kmax, device=dev) < kf_id, shared, -1)
    parent = torch.argmax(earlier)
    has_parent = (earlier.max() > 0) & (kf_id > 0)
    kf_parent = set_row(arena.kf_parent, kf_id,
                        torch.where(has_parent, parent, -1).to(torch.int32))
    return arena._replace(covis=covis, kf_parent=kf_parent)


def local_keyframes(arena: MapArena, kf_id: int, cap: int = 80):
    """Top-`cap` covisible keyframes of kf_id (incl. itself). Returns
    ([cap] int32 ids, [cap] bool valid): Tracking::UpdateLocalKeyFrames
    capped at 80 (Tracking.cc:1614). Lower id first among equal weights."""
    w = set_row(arena.covis[kf_id], kf_id, torch.iinfo(torch.int32).max)
    w = torch.where(arena.kf_valid, w, -1)
    if arena.kmax < cap:    # tiny arenas: pad so callers always see [cap] outputs
        w = torch.nn.functional.pad(w, (0, cap - arena.kmax), value=-1)
    top_w, top_i = top_k_stable(w, cap)
    return top_i.clamp(max=arena.kmax - 1).to(torch.int32), top_w > 0


def compact_keyframes(arena: MapArena, perm: torch.Tensor, new_of_old: torch.Tensor,
                      n_keep: int) -> MapArena:
    """Recycle culled keyframe slots by compacting the keyframe arrays (the
    counterpart of KeyFrame::SetBadFlag, KeyFrame.cc:533-580, freeing a
    keyframe): a permutation gather moves the survivors to the front, so the
    monotonic cursor regains headroom.

    perm: [K] old slot now stored at each new slot (the first n_keep are the
        surviving slots in ascending order, so recency == slot order).
    new_of_old: [K] new slot per old slot; a culled slot maps to its nearest
        surviving predecessor.
    n_keep: number of surviving keyframes."""
    K = arena.kmax
    dev = arena.kf_pose.device
    perm, new_of_old = perm.long(), new_of_old.to(torch.int32)
    j = torch.arange(K, device=dev)
    live = j < n_keep
    covis = arena.covis[perm][:, perm]
    covis = torch.where(live[:, None] & live[None, :], covis, 0)
    parent_old = arena.kf_parent[perm]
    parent_new = torch.where(parent_old >= 0, new_of_old[parent_old.clamp(min=0).long()], -1)
    # a keyframe whose remapped parent is itself (its parent was culled and
    # the nearest survivor is the keyframe) becomes a root
    parent_new = torch.where(parent_new == j, -1, parent_new)
    ref_new = new_of_old[arena.pt_ref_kf.clamp(0, K - 1).long()]
    eye = torch.eye(4, device=dev)
    return arena._replace(
        kf_pose=torch.where(live[:, None, None], arena.kf_pose[perm], eye),
        kf_valid=live & arena.kf_valid[perm],
        kf_time=torch.where(live, arena.kf_time[perm], 0.0),
        kf_uv=arena.kf_uv[perm],
        kf_ur=arena.kf_ur[perm],
        kf_depth=arena.kf_depth[perm],
        kf_level=arena.kf_level[perm],
        kf_angle=arena.kf_angle[perm],
        kf_desc=arena.kf_desc[perm],
        kf_kp_valid=torch.where(live[:, None], arena.kf_kp_valid[perm], False),
        kf_obs=torch.where(live[:, None], arena.kf_obs[perm], -1),
        covis=covis,
        kf_parent=torch.where(live, parent_new, -1).to(torch.int32),
        pt_ref_kf=torch.where(arena.pt_ref_kf >= 0, ref_new, arena.pt_ref_kf).to(torch.int32),
        n_kf=torch.tensor(n_keep, dtype=torch.int32, device=dev),
    )
