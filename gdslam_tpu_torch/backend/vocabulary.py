"""Binary BoW vocabulary: hierarchical k-medians on ORB descriptors (port of
gdslam_tpu.backend.vocabulary).

Replaces DBoW2's TemplatedVocabulary + FORB (reference
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241,1338): a k-ary tree of
256-bit binary cluster centres; `transform` walks each descriptor down the
tree by Hamming argmin; images become L1-normalised bag-of-words vectors
scored with the DBoW2 L1 metric s = 1 - 0.5 |v - w|_1.

The tree walk compares packed descriptors by XOR and popcount against the
k children of the current node, level by level; the JAX package takes the
argmax of a +-1 dot product, which is the first argmin of the Hamming
distance, so ties keep the lowest child in both. BoW vectors are dense
[n_leaves] float32, so scoring a database is one batched L1 distance.

Training is numpy (k-medians with bitwise-majority centres), copied from
the JAX package. The shipped default (10k leaves) is the port's own byte
copy of the JAX package's file, `gdslam_tpu_torch/data/vocab_default.npz`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gdslam_tpu_torch.ops import hamming


class Vocabulary(NamedTuple):
    centers: torch.Tensor  # [n_nodes, 32] uint8, level-major complete k-ary tree
    k: int                 # branching factor
    levels: int            # depth

    @property
    def n_leaves(self) -> int:
        return self.k ** self.levels

    def to(self, device) -> "Vocabulary":
        return self._replace(centers=self.centers.to(device))


def _node_offset(k: int, level: int) -> int:
    """Start index of `level` in the level-major array (root level 0 = k nodes)."""
    return sum(k ** (lv + 1) for lv in range(level))


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int32)


def _ham_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[m, 32] x [k, 32] uint8 -> [m, k] Hamming distances (numpy LUT)."""
    return _POPCNT[np.bitwise_xor(a[:, None, :], b[None, :, :])].sum(-1)


def train(descriptors: np.ndarray, k: int = 10, levels: int = 3, iters: int = 8,
          seed: int = 0, max_per_node: int = 16384, device="cpu") -> Vocabulary:
    """Hierarchical binary k-medians on [M, 32] uint8 descriptors, in numpy
    (the same draws and the same tree as the JAX package's `train`). Each
    node's medians are fit on at most `max_per_node` sampled rows; the split
    to the next level assigns every row."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint8)

    def kmedians(data: np.ndarray) -> np.ndarray:
        m = data.shape[0]
        if m == 0:
            return np.zeros((k, 32), np.uint8)
        fit = data if m <= max_per_node else \
            data[rng.choice(m, size=max_per_node, replace=False)]
        init = fit[rng.choice(fit.shape[0], size=min(k, fit.shape[0]), replace=False)]
        centers = np.zeros((k, 32), np.uint8)
        centers[:init.shape[0]] = init
        bits = np.unpackbits(fit, axis=1).astype(np.int32)   # [m, 256]
        for _ in range(iters):
            assign = np.argmin(_ham_np(fit, centers), axis=1)
            votes = np.zeros((k, 256), np.int64)
            np.add.at(votes, assign, bits)
            counts = np.bincount(assign, minlength=k)[:, None]
            new_centers = np.packbits((votes * 2 > counts).astype(np.uint8), axis=1)
            empty = counts[:, 0] == 0
            if empty.any():
                new_centers[empty] = fit[rng.choice(fit.shape[0], size=int(empty.sum()))]
            if (new_centers == centers).all():
                return new_centers
            centers = new_centers
        return centers

    all_centers = []
    groups = [desc]
    for lv in range(levels):
        lvl_centers = np.zeros((len(groups), k, 32), np.uint8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = kmedians(g)
            lvl_centers[gi] = c
            if lv < levels - 1:
                a = np.argmin(_ham_np(g, c), axis=1) if g.shape[0] > 0 else np.zeros(0, np.int64)
                for ci in range(k):
                    next_groups.append(g[a == ci])
        all_centers.append(lvl_centers.reshape(-1, 32))
        groups = next_groups
    return Vocabulary(centers=torch.from_numpy(np.concatenate(all_centers, axis=0)).to(device),
                      k=k, levels=levels)


def transform(desc: torch.Tensor, centers: torch.Tensor, k: int, levels: int) -> torch.Tensor:
    """[N, 32] uint8 descriptors -> [N] int32 leaf word ids (the DBoW2
    `transform` walk): at each level the child of least Hamming distance,
    the first among ties."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    children = torch.arange(k, device=desc.device)
    for lv in range(levels):
        child_ids = _node_offset(k, lv) + node[:, None] * k + children[None]      # [N, k]
        ham = hamming.hamming_packed(desc[:, None, :], centers[child_ids])          # [N, k]
        node = node * k + torch.argmin(ham, dim=1)
    return node.to(torch.int32)


def bow_vector(words: torch.Tensor, valid: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """Word ids -> L1-normalised dense BoW vector [n_leaves]. The counts are
    integers, exact in any order of summation."""
    counts = torch.zeros(n_leaves + 1, device=words.device).index_add_(
        0, torch.where(valid, words, n_leaves).long(), valid.float())
    v = counts[:n_leaves]
    return v / v.sum().clamp(min=1e-9)


def l1_score(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity (ScoringObject): 1 - 0.5 |v - w|_1, in [0, 1];
    batched on the leading dims of either argument."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v - w), dim=-1)


def load_orbvoc_text(path: str, device="cpu") -> Vocabulary:
    """Load a DBoW2 text vocabulary (ORBvoc.txt, the file ORB-SLAM2 ships and
    the reference loads with TemplatedVocabulary::loadFromTextFile,
    TemplatedVocabulary.h:1338): a header `k L scoring weighting`, then one
    node per line in parent-before-child order, `parent_id is_leaf d0..d31
    weight`. A DBoW2 tree may be incomplete; `transform` walks a complete
    level-major k-ary array, so a missing child inherits its parent's
    descriptor (word ids stay consistent within this package, not with
    DBoW2's)."""
    with open(path) as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        descs: list[np.ndarray] = [np.zeros(32, np.uint8)]
        children: dict[int, list[int]] = {0: []}
        for line in f:
            parts = line.split()
            if len(parts) < 2 + 32:
                continue
            pid = int(parts[0])
            nid = len(descs)
            descs.append(np.asarray([int(float(x)) for x in parts[2:2 + 32]], np.uint8))
            children.setdefault(pid, []).append(nid)
            children.setdefault(nid, [])

    centers = np.zeros((_node_offset(k, levels), 32), np.uint8)
    slot_real = [-1] * centers.shape[0]      # the real node each complete slot maps to
    root_kids = children.get(0, [])
    prev = []
    for i in range(k):
        real = root_kids[i] if i < len(root_kids) else -1
        slot_real[i] = real
        centers[i] = descs[real] if real >= 0 else descs[0]
        prev.append(i)
    off = 0
    for lv in range(1, levels):
        off += k ** lv
        new_prev = []
        for pslot in prev:
            p_in_level = pslot - (off - k ** lv)
            real_p = slot_real[pslot]
            kids = children.get(real_p, []) if real_p >= 0 else []
            for i in range(k):
                slot = off + p_in_level * k + i
                real = kids[i] if i < len(kids) else -1
                slot_real[slot] = real
                centers[slot] = descs[real] if real >= 0 else centers[pslot]
                new_prev.append(slot)
        prev = new_prev
    return Vocabulary(centers=torch.from_numpy(centers).to(device), k=k, levels=levels)


def save(vocab: Vocabulary, path: str) -> None:
    np.savez_compressed(path, centers=vocab.centers.cpu().numpy(), k=vocab.k,
                        levels=vocab.levels)


def load(path: str, device="cpu") -> Vocabulary:
    z = np.load(path)
    return Vocabulary(centers=torch.from_numpy(z["centers"]).to(device), k=int(z["k"]),
                      levels=int(z["levels"]))


def random_pose(rng: np.random.Generator) -> np.ndarray:
    """A random viewpoint inside the synthetic room (full yaw coverage, mild
    pitch and roll), float64 [4, 4] T_wc: wide pose diversity for vocabulary
    training and place-recognition tests. The same draws as the JAX
    package's random_pose."""
    from gdslam_tpu_torch.core import lie
    t = np.asarray([rng.uniform(-1.0, 1.0), rng.uniform(-0.6, 0.6), rng.uniform(-0.9, 0.9)])
    rot = np.asarray([rng.uniform(-0.25, 0.25), rng.uniform(0.0, 2 * np.pi),
                      rng.uniform(-0.15, 0.15)])
    xi = torch.cat([torch.zeros(3), torch.from_numpy(rot.astype(np.float32))])
    T = np.eye(4)
    T[:3, :3] = lie.se3_exp(xi)[:3, :3].numpy()
    T[:3, 3] = t
    return T


def train_from_synthetic(k: int = 10, levels: int = 4, n_frames: int = 150, seed: int = 0,
                         device="cpu") -> Vocabulary:
    """Train a vocabulary on the synthetic scene at diverse random viewpoints
    (the port's renderer and extractor): k=10, levels=4 -> 10,000 leaves."""
    from gdslam_tpu_torch.config import CameraConfig, OrbConfig
    from gdslam_tpu_torch.frontend import extractor
    from gdslam_tpu_torch.io import synthetic

    cam, cfg = CameraConfig(), OrbConfig()
    rng = np.random.default_rng(seed)
    descs = []
    for i in range(n_frames):
        T = torch.from_numpy(random_pose(rng).astype(np.float32)).to(device)
        fr = synthetic.render(T, cam, False, 30.0, frame_idx=i)
        f = extractor.extract(fr.gray, cfg, cam.height, cam.width)
        descs.append(f.desc[f.valid].cpu().numpy())
    return train(np.concatenate(descs, axis=0), k=k, levels=levels, seed=seed, device=device)


DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data",
                            "vocab_default.npz")


def default_vocabulary(device="cpu") -> Vocabulary:
    """The shipped default vocabulary (10k leaves), trained and saved here
    if the file is missing."""
    path = os.path.abspath(DEFAULT_PATH)
    if os.path.exists(path):
        return load(path, device)
    v = train_from_synthetic()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save(v, path)
    return v.to(device)
