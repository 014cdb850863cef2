"""The JAX package's counter-based random draws, replayed bit for bit in
numpy: the host reference of the port's draw.

Every RANSAC of the JAX package draws its samples with
`jax.random.categorical`: the GD pose under fold_in(PRNGKey(7), frame_id)
(gdslam_tpu/system/slam.py) or a split chain from PRNGKey(7)
(masking/geomask.py), relocalization under PRNGKey(frame_id)
(system/tracking.py), the monocular bootstrap under PRNGKey(0) and the loop
closer's Sim3 under PRNGKey(kf_id). Those draws decide which hypothesis
wins: at the bootstrap's narrow baselines the winner sets the scale of a
monocular map, and a Sim3 winner whose inliers hold one bad point refits to
a wrong scale and one inlier. So the port draws what the JAX package draws.
The draw itself runs on the device (`ops/draw_kernel.py`, a CUDA kernel on
the card); this module keeps the keys (`prng_key`, `fold_in`, `split`, made
on the host) and the numpy reference the draw is held to: the Threefry-2x32
hash (Salmon et al., SC 2011) as JAX computes it (20 rounds, key schedule
with 0x1BD11BDA, counters of the partitionable layout: the flat index's
high and low words), JAX's float construction of uniforms in [tiny, 1),
the Gumbel noise -log(-log(u)) in float32, and categorical = argmax(noise +
logits).
"""

from __future__ import annotations

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


def split(key: tuple, num: int = 2) -> list:
    """jax.random.split(key, num) of the partitionable layout: key i is the
    hash of the counter (0, i)."""
    a, b = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(a[i], b[i]) for i in range(num)]


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


def categorical_rows(key: tuple, logits: torch.Tensor, rows: int) -> torch.Tensor:
    """jax.random.categorical(key, logits[None].repeat(rows, 0)) replayed on
    the host: [rows] int64 draws (on the logits' device), each the argmax of
    Gumbel noise plus the logits [n], the lowest index among ties. The
    reference the device draw is held to; it reads the logits on the host."""
    noise = gumbel((int(key[0]), int(key[1])), (rows, logits.shape[0]))
    lg = logits.detach().cpu().numpy().astype(np.float32)
    return torch.from_numpy(np.argmax(noise + lg[None], axis=1).astype(np.int64)).to(
        logits.device)
