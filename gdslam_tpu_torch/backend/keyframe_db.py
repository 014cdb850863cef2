"""Keyframe database for place recognition, loop detection and
relocalization (port of gdslam_tpu.backend.keyframe_db).

Replaces KeyFrameDatabase's DBoW2 inverted file (reference
KeyFrameDatabase.cc:76-198 DetectLoopCandidates, 199-311
DetectRelocalizationCandidates). The BoW vectors are stored dense [K,
n_leaves], so scoring is one batched L1 similarity against every keyframe,
and the reference's gating rules (covisibility minimum score, the 0.75 x
best accumulated score, the covisibility exclusion) apply to the score
vector. Ties among scores keep the lower keyframe id, as `lax.top_k` does
(`extractor.top_k_stable`). Nothing is read on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdslam_tpu_torch.backend import map_arena as ma
from gdslam_tpu_torch.backend import vocabulary as voc
from gdslam_tpu_torch.frontend.extractor import top_k_stable


class BowDatabase(NamedTuple):
    vectors: torch.Tensor   # [K, n_leaves] L1-normalised BoW per keyframe
    words: torch.Tensor     # [K, N] int32 leaf word per keypoint (-1 invalid)
    valid: torch.Tensor     # [K] bool


def new_db(kmax: int, n_features: int, n_leaves: int, device="cuda") -> BowDatabase:
    return BowDatabase(
        vectors=torch.zeros((kmax, n_leaves), device=device),
        words=torch.full((kmax, n_features), -1, dtype=torch.int32, device=device),
        valid=torch.zeros(kmax, dtype=torch.bool, device=device),
    )


def db_add(db: BowDatabase, kf_id: int, vec: torch.Tensor, words: torch.Tensor) -> BowDatabase:
    return BowDatabase(vectors=ma.set_row(db.vectors, kf_id, vec),
                       words=ma.set_row(db.words, kf_id, words.to(torch.int32)),
                       valid=ma.set_row(db.valid, kf_id, True))


def query_scores(db: BowDatabase, vec: torch.Tensor) -> torch.Tensor:
    """L1 similarity of `vec` against every stored keyframe; -1 where empty. [K]"""
    return torch.where(db.valid, voc.l1_score(db.vectors, vec[None]), -1.0)


def _group_accumulate(scores: torch.Tensor, eligible: torch.Tensor, covis: torch.Tensor,
                      valid: torch.Tensor, n_neighbors: int = 10):
    """Covisibility-group score accumulation (KeyFrameDatabase.cc:120-198):
    each eligible keyframe i anchors a group, i and its top-`n_neighbors`
    covisible keyframes; acc(i) sums the direct scores of the group's
    eligible members, and the group's representative is its best-scoring
    member (the first among ties). Returns (acc [K], best_member [K] int32)."""
    K = scores.shape[0]
    es = torch.where(eligible, scores, 0.0)
    w = torch.where(valid[None, :], covis, 0)
    nb_w, nb_i = top_k_stable(w, min(n_neighbors, K))                  # [K, n]
    nb_scores = torch.where(nb_w > 0, es[nb_i], 0.0)
    acc = es + nb_scores.sum(dim=-1)
    member_scores = torch.cat([es[:, None], nb_scores], dim=1)
    member_ids = torch.cat([torch.arange(K, device=scores.device)[:, None], nb_i], dim=1)
    best = torch.argmax(member_scores, dim=-1)
    return acc, torch.gather(member_ids, 1, best[:, None])[:, 0].to(torch.int32)


def _retained(acc: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """The 0.75 x best accumulated score retention rule, as a masked score."""
    acc = torch.where(eligible, acc, -1.0)
    return torch.where(eligible & (acc >= 0.75 * acc.max()), acc, -1.0)


def loop_candidates(db: BowDatabase, arena: ma.MapArena, kf_id: int, n_candidates: int = 8):
    """DetectLoopCandidates semantics (KeyFrameDatabase.cc:76-198):
    minScore = the lowest BoW similarity between kf_id and its covisibility
    graph neighbours (edges of weight >= 15, KeyFrame::UpdateConnections),
    candidates must beat it and must not be connected to kf_id; then the
    group accumulation with the 0.75 x retention. Returns (ids [n],
    acc_scores [n], min_score); ids may repeat (callers deduplicate)."""
    vec = db.vectors[kf_id]
    scores = query_scores(db, vec)
    connected = arena.covis[kf_id] >= 15
    neighbor_scores = torch.where(connected & db.valid, scores, float("inf"))
    min_score = neighbor_scores.min().clamp(max=1.0)
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    ids = torch.arange(scores.shape[0], device=scores.device)
    eligible = db.valid & ~connected & (ids != kf_id) & (scores >= min_score)
    acc, best_member = _group_accumulate(scores, eligible, arena.covis, db.valid)
    top_s, top_g = top_k_stable(_retained(acc, eligible), n_candidates)
    return best_member[top_g], top_s, min_score


def reloc_candidates(db: BowDatabase, arena: ma.MapArena, vec: torch.Tensor,
                     n_candidates: int = 5):
    """DetectRelocalizationCandidates (KeyFrameDatabase.cc:199-311): the
    group accumulation of the loop query without the minimum score or the
    connectivity exclusion (a lost frame has no keyframe identity), with the
    0.75 x retention. Returns (ids [n], acc_scores [n], ok [n])."""
    scores = query_scores(db, vec)
    eligible = db.valid & (scores > 0)
    acc, best_member = _group_accumulate(scores, eligible, arena.covis, db.valid)
    top_s, top_g = top_k_stable(_retained(acc, eligible), n_candidates)
    return best_member[top_g], top_s, top_s > 0
