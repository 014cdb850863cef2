"""Inputs that probe the edges of the stereo kernel's row buckets and band
walk (ops/stereo.py, csrc/stereo_match.cu): a hot bucket, right keypoints
exactly on the edge of each level's row band, rows at and past the image's
borders, Hamming ties whose lower index lies in a later bucket, a left
count that is not a multiple of the kernel's warps a block, and right counts
past its one-pass bucket build and past a block's shared memory (where a
first launch builds the buckets: `most_right` and the `_wide` cases, the
first four edges again at WIDE_M right keypoints). The CPU tests
hold the bucket twins to the plain gates on them, the card tests hold the
kernel to its plain twin on them; numpy only, so every caller makes the same
inputs from a seed.
"""

from __future__ import annotations

import numpy as np

from gdslam_tpu_torch.ops.stereo import BAND_LEVELS

H, W = 376, 1241                  # KITTI00-02.yaml's image
BF, MIN_Z = 386.1448, 386.1448 / 718.856
EDGES = ("hot_bucket", "band_edge", "row_edges", "tie_order")
WIDE_M = 6000                     # right keypoints past a block's shared memory
CASES = (*EDGES, "odd_n", "many_right", "most_right", *(f"{e}_wide" for e in EDGES))


def stereo_inputs(seed: int, N: int, M: int, H: int = H, W: int = W,
                  integer: bool = True) -> dict:
    """A seeded pair at KITTI's size: 70% of the left keypoints have a right
    twin at a disparity of 1-200 px, 0-2 px off their row, a level apart at
    most and a descriptor a few bits off; the rest and the images random."""
    r = np.random.default_rng(seed)
    d = dict(left_uv=np.stack([r.uniform(0, W, N), r.uniform(0, H, N)], 1).astype(np.float32),
             left_level=r.integers(0, 8, N).astype(np.int32),
             left_desc=r.integers(0, 256, (N, 32)).astype(np.uint8),
             left_valid=r.uniform(size=N) > 0.05,
             right_uv=np.stack([r.uniform(0, W, M), r.uniform(0, H, M)], 1).astype(np.float32),
             right_level=r.integers(0, 8, M).astype(np.int32),
             right_desc=r.integers(0, 256, (M, 32)).astype(np.uint8),
             right_valid=r.uniform(size=M) > 0.05)
    k = min(int(0.7 * N), M)
    src, dst = r.permutation(N)[:k], r.permutation(M)[:k]
    d["right_uv"][dst] = d["left_uv"][src] - np.stack([r.uniform(1, 200, k),
                                                       r.normal(0, 1, k)], 1)
    d["right_level"][dst] = np.clip(d["left_level"][src] + r.integers(-1, 2, k), 0, 7)
    flips = (1 << r.integers(0, 8, (k, 32))) * (r.uniform(size=(k, 32)) < 0.06)
    d["right_desc"][dst] = d["left_desc"][src] ^ flips.astype(np.uint8)
    img = r.uniform(0, 255, (2, H, W))
    d["img_left"], d["img_right"] = (np.round(img) if integer else img).astype(np.float32)
    return d


def band_values(scale_factor: float = 1.2) -> np.ndarray:
    """[BAND_LEVELS] f32: stereo.band_table's values, in numpy."""
    lv = np.arange(BAND_LEVELS, dtype=np.float64)
    return (2.0 * np.float64(np.float32(scale_factor)) ** lv).astype(np.float32)


def band_edge_row(v_left: np.float32, band: np.float32, side: int) -> np.float32:
    """The f32 row farthest from v_left on `side` (-1 below, +1 above) that
    still passes the gate |fl(v_left - v)| <= band."""
    v_left, band = np.float32(v_left), np.float32(band)
    away, toward = np.float32(side * np.inf), np.float32(-side * np.inf)
    v = np.float32(v_left + np.float32(side) * band)
    while abs(np.float32(v_left - v)) > band:
        v = np.nextafter(v, toward)
    while abs(np.float32(v_left - np.nextafter(v, away))) <= band:
        v = np.nextafter(v, away)
    return v


def _twin(d: dict, i: int, j: int, r: np.random.Generator, disparity: float,
          bits: int = 3) -> None:
    """Right keypoint j becomes left keypoint i's twin: `disparity` px to
    the left, the same level, the descriptor with `bits` bits flipped (the
    row is left to the caller)."""
    d["right_uv"][j, 0] = np.float32(d["left_uv"][i, 0] - disparity)
    d["right_level"][j] = d["left_level"][i]
    desc = d["left_desc"][i].copy()
    for b in r.choice(256, bits, replace=False):
        desc[b // 8] ^= np.uint8(1 << (b % 8))
    d["right_desc"][j] = desc
    d["right_valid"][j] = True


def stereo_edge_inputs(case: str, seed: int = 0) -> dict:
    """One of CASES, at KITTI's size (1241 x 376 integer images), 2000 left
    and 2000 right keypoints (WIDE_M right for an edge + "_wide"):
    - hot_bucket: every right keypoint on 3 rows and the left ones around
      them, 70% of the left ones with a twin;
    - band_edge: at each level 0-7, left keypoints (some just above an
      integer plus the band) with a twin on the farthest row that passes
      the band gate, below and above, and a decoy one f32 step past it;
    - row_edges: right rows at 0, H - 1e-3, just under 0, far below,
      at and past H, far above, and NaN, with left keypoints that reach them;
    - tie_order: left keypoints with two twins at the same Hamming
      distance, the lower index on a later row (a later bucket);
    - odd_n: stereo_inputs at 1997 x 2000 (not a multiple of 8 warps);
    - many_right: stereo_inputs at 2000 x 3000 (past the 2048 right
      keypoints the kernel's one-pass bucket build takes);
    - most_right: stereo_inputs at 2000 x 6000 (past the bucket table a
      block's shared memory holds)."""
    N, M = 2000, 2000
    if case.endswith("_wide") and case[:-5] in EDGES:
        case, M = case[:-5], WIDE_M
    r = np.random.default_rng(1000 + seed)
    if case == "odd_n":
        return stereo_inputs(seed, 1997, 2000)
    if case == "many_right":
        return stereo_inputs(seed, 2000, 3000)
    if case == "most_right":
        return stereo_inputs(seed, 2000, 6000)
    if case == "hot_bucket":
        d = stereo_inputs(seed, N, M)
        rows = np.float32([150.25, 151.5, 152.75])
        d["right_uv"][:, 1] = rows[r.integers(0, 3, M)]
        d["left_uv"][:, 1] = r.uniform(148.0, 155.0, N).astype(np.float32)
        d["left_level"][:] = r.integers(0, 3, N)
        d["right_level"][:] = np.clip(d["left_level"][np.arange(M) % N]
                                      + r.integers(-1, 2, M), 0, 7)
        return d
    base = stereo_inputs(seed, N, M)
    d = {k: v.copy() for k, v in base.items()}
    d["right_valid"][:] = True
    d["left_valid"][:] = True
    # the random right keypoints stay as decoys, far in descriptor space
    d["right_desc"][:] = r.integers(0, 256, (M, 32)).astype(np.uint8)
    bands = band_values()
    i = j = 0
    if case == "band_edge":
        while i + 1 < N and j + 3 < M:
            lv = i % 8
            band = bands[lv]
            if (i // 8) % 2:           # vL - band just above an integer row
                vl = np.float32(r.integers(4, H - 8) + band + np.float32(r.choice([0, 1e-5, 3e-5])))
            else:
                vl = np.float32(r.uniform(3, H - 3))
            d["left_uv"][i] = (np.float32(r.uniform(250, W)), vl)
            d["left_level"][i] = lv
            side = -1 if (i // 16) % 2 else 1
            edge = band_edge_row(vl, band, side)
            _twin(d, i, j, r, float(r.uniform(2, 200)))
            d["right_uv"][j, 1] = edge
            past = np.nextafter(edge, np.float32(side * np.inf))
            _twin(d, i, j + 1, r, float(r.uniform(2, 200)), bits=0)
            d["right_uv"][j + 1, 1] = past       # a better decoy that fails the band
            i, j = i + 1, j + 2
        return d
    if case == "row_edges":
        rights = np.float32([0.0, H - 1e-3, -0.25, -3.0, -1e6, H, H + 0.5, H + 40.0, 1e6, np.nan])
        lefts = np.float32([0.0, 0.5, H - 0.5, H - 1e-3, H + 0.25, -1.0, 1.0, H - 1.5])
        while i < N and j + 1 < M:
            lv = int(r.integers(0, 8))
            vl = lefts[i % len(lefts)]
            d["left_uv"][i] = (np.float32(r.uniform(250, W)), vl)
            d["left_level"][i] = lv
            vr = rights[(i // len(lefts)) % len(rights)]
            _twin(d, i, j, r, float(r.uniform(2, 200)))
            d["right_uv"][j, 1] = vr
            i, j = i + 1, j + 1
        return d
    if case == "tie_order":
        while i < N and j + 1 < M:
            lv = int(r.integers(0, 3))
            band = bands[lv]
            vl = np.float32(r.uniform(5, H - 5))
            d["left_uv"][i] = (np.float32(r.uniform(250, W)), vl)
            d["left_level"][i] = lv
            # j (lower) above the row, j + 1000 (higher) below: a later bucket first
            lo_j, hi_j = j, j + M // 2
            for jj, dv, disp in ((lo_j, 0.9, 20.0), (hi_j, -0.9, 40.0)):
                d["right_uv"][jj] = (np.float32(d["left_uv"][i, 0] - disp),
                                     np.float32(vl + np.float32(dv) * band))
                d["right_level"][jj] = lv
                desc = d["left_desc"][i].copy()
                desc[0] ^= np.uint8(0x0F)            # 4 bits off, for both twins
                d["right_desc"][jj] = desc
            i, j = i + 1, j + 1
            if j >= M // 2:
                break
        return d
    raise ValueError(f"unknown stereo edge case {case!r}")
