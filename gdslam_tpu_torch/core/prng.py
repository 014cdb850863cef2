"""The JAX package's counter-based random draws, replayed bit for bit.

The monocular bootstrap and the loop closer's Sim3 RANSAC of the JAX
package draw their samples with `jax.random.categorical`, under
`PRNGKey(0)` (gdslam_tpu/system/tracking.py, frontend/initializer.py) and
`PRNGKey(kf_id)` (backend/loop_closing.py). Those draws decide which
hypothesis wins: at the bootstrap's narrow baselines the winner sets the
scale of a monocular map, and a Sim3 winner whose inliers hold one bad point
refits to a wrong scale and one inlier. So the port replays them rather
than drawing its own: the Threefry-2x32 hash (Salmon et al., SC 2011) as JAX
computes it (20 rounds, key schedule with 0x1BD11BDA, counters of the
partitionable layout: the flat index's high and low words), JAX's float
construction of uniforms in [tiny, 1), the Gumbel noise -log(-log(u)) in
float32, and categorical = argmax(noise + logits). The noise depends only
on the key and the shape, so it is computed once on the host (numpy uint32
arithmetic wraps as the hash needs) and kept on each device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple, x1: np.ndarray, x2: np.ndarray) -> tuple:
    """Threefry-2x32 of the counter pairs (x1, x2) under key (k1, k2), all
    uint32: JAX's `_threefry2x32_lowering`."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, np.uint32) + ks[0]
        b = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed): the seed's high and low 32-bit words."""
    return (np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF))


def fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in(key, data): the hash of the counter (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return (a[0], b[0])


def random_bits(key: tuple, shape: tuple) -> np.ndarray:
    """32-bit words as jax.random.bits gives them (the partitionable
    layout): the hash of each flat index's (high, low) words, XORed."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (a ^ b).reshape(shape)


def gumbel(key: tuple, shape: tuple) -> np.ndarray:
    """jax.random.gumbel(key, shape) in float32 ("low" mode): uniforms from
    the 23 high bits as a float in [1, 2) minus 1, floored at the smallest
    normal, then -log(-log(u))."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    tiny = np.finfo(np.float32).tiny
    u = bits.view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(tiny), u * np.float32(1.0 - tiny) + np.float32(tiny))
    return -np.log(-np.log(u))


@functools.lru_cache(maxsize=8)
def _noise_on(key: tuple, rows: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gumbel(key, (rows, n))).to(device)


def uniform_over(key: tuple, valid: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows] int64 draws with replacement, uniform over the valid rows, as
    the JAX package draws them: categorical under `key` of the logits
    log(valid / max(sum(valid), 1) + 1e-12) (every row when none is valid)."""
    logp = torch.log(valid.float() / torch.clamp(valid.sum(), min=1) + 1e-12)
    return categorical_rows(key, logp, rows)


def categorical_rows(key: tuple, logits: torch.Tensor, rows: int) -> torch.Tensor:
    """jax.random.categorical(key, logits[None].repeat(rows, 0)): [rows]
    int64 draws, each the argmax of Gumbel noise plus the logits [n] (the
    lowest index among ties)."""
    noise = _noise_on((int(key[0]), int(key[1])), rows, logits.shape[0], logits.device)
    return torch.argmax(noise + logits[None], dim=1)
