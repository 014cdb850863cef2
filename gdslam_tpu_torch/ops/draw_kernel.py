"""The port's one random draw: `jax.random.categorical` over a row of
logits, repeated over `rows` draws, as the hand-written CUDA kernel
`csrc/categorical_draw.cu` and its plain PyTorch twin.

Every RANSAC of the JAX package draws its samples with replacement as
`jax.random.categorical(key, log(valid / max(sum(valid), 1) + 1e-12)
[None].repeat(rows, 0))` (gdslam_tpu/backend/solvers.py:85, :141; the mono
bootstrap, the loop closer's Sim3). The port draws the same indices under
the same keys: the Gumbel noise of each flat index r * n + j is
Threefry-2x32 of its (high, low) counter words XORed, its top 23 bits as a
float in [1, 2) minus 1 floored at the smallest normal, then
-log(-log(u)) (core/prng.py is the numpy reference, held to jax.random);
the draw is the argmax of noise + logits, the lowest index among ties.

A key is a host pair of 32-bit words (prng.prng_key, fold_in, split);
`fold`, an int64 [1] tensor on the device, replaces the key by
fold_in(key, fold[0]) inside the draw, so the GD fast path's key
fold_in(PRNGKey(7), frame_id) comes from a device frame id with no host
hash and no wait for the card.

`categorical_draw` takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises, and counts its
launches in `categorical_draw.launches`. The kernel takes a row per CTA,
its columns split over 4 warps; a call without `noise` runs the variant
that stores only the indices. On the card both routes take the CUDA
library's logf (torch.log's), so the kernel's noise equals the twin's bit
for bit; on the CPU torch.log may differ from XLA's log by an ulp, which
moves no draw but a near-tie.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gdslam_tpu_torch.ops import cuda_build

M32 = 0xFFFFFFFF
TINY = 1.17549435e-38            # float32's smallest normal: the uniforms' floor
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _declare(lib) -> None:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.categorical_draw_launch.argtypes = [p, i, i, u, u, p, p, p, i, p]
    lib.categorical_draw_launch.restype = i


# ----------------------------------------------------------------------------
# the plain twin: Threefry-2x32 in int64 tensors masked to 32 bits
# ----------------------------------------------------------------------------

def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """Threefry-2x32 of the counter pairs (x0, x1) under the key (k0, k1):
    int64 tensors (or ints, for the key) holding 32-bit words; returns new
    int64 tensors (a, b). Updated in place: a third of the time."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    a = (x0 + k0) & M32
    b = (x1 + k1) & M32
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.contiguous(), b.contiguous()
    t = torch.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(M32)
            torch.bitwise_left_shift(b, r, out=t).bitwise_and_(M32)
            b.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return a, b


def _key_words(key: tuple, fold: Optional[torch.Tensor], device) -> tuple:
    """The draw's key as two ints, or with fold two int64 [1] tensors."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    if fold is not None:
        zero = torch.zeros(1, dtype=torch.int64, device=device)
        k0, k1 = threefry2x32(k0, k1, zero, fold.reshape(1).to(torch.int64) & M32)
    return k0, k1


def gumbel_plain(key: tuple, rows: int, n: int, fold: Optional[torch.Tensor] = None,
                 device="cpu") -> torch.Tensor:
    """[rows, n] f32: jax.random.gumbel(key, (rows, n)) in plain PyTorch."""
    k0, k1 = _key_words(key, fold, device)
    idx = torch.arange(rows * n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k0, k1, idx >> 32, idx & M32)
    bits = ((a ^ b) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u + TINY, min=TINY)
    return (-torch.log(-torch.log(u))).reshape(rows, n)


def categorical_draw_plain(key: tuple, logits: torch.Tensor, rows: int,
                           fold: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The draw in plain PyTorch: [rows] int64 (noise: as categorical_draw's)."""
    g = gumbel_plain(key, rows, logits.shape[0], fold, logits.device)
    if noise is not None:
        noise.copy_(g)
    return torch.argmax(g + logits[None], dim=1)


# ----------------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------------

def categorical_draw(key: tuple, logits: torch.Tensor, rows: int,
                     fold: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """jax.random.categorical(key', logits[None].repeat(rows, 0)): [rows]
    int64 indices into logits [n] f32 (finite or -inf), key' = key, or
    fold_in(key, fold[0]) with fold an int64 [1] tensor on the logits'
    device; key: a host pair of 32-bit words. With
    `noise` ([rows, n] f32) the Gumbel noise is written there too, for the
    comparison with the plain twin. One launch on the card."""
    name = "categorical_draw"
    device = logits.device
    if device.type == "cpu":
        return categorical_draw_plain(key, logits, rows, fold, noise)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    n = logits.shape[0]
    cuda_build.check(name, "logits", logits, torch.float32, (n,), device)
    if fold is not None:
        cuda_build.check(name, "fold", fold, torch.int64, (1,), device)
    if noise is not None:
        cuda_build.check(name, "noise", noise, torch.float32, (rows, n), device)
    if n < 1 or rows < 0:
        raise ValueError(f"{name}: {rows} draws over {n} logits")
    lib = cuda_build.load(name, _declare)
    out = torch.empty(rows, dtype=torch.int64, device=device)
    if rows:
        cuda_build.launch(name, device, lib.categorical_draw_launch, logits.data_ptr(), n, rows,
                          int(key[0]) & M32, int(key[1]) & M32, None if fold is None else fold.data_ptr(),
                          out.data_ptr(), None if noise is None else noise.data_ptr())
        categorical_draw.launches += 1
    return out


categorical_draw.launches = 0


def uniform_logits(valid: torch.Tensor) -> torch.Tensor:
    """[n] f32: log(valid / max(sum(valid), 1) + 1e-12), the JAX RANSACs'
    logits (uniform over the valid rows; over all rows when none is)."""
    return torch.log(valid.float() / torch.clamp(valid.sum(), min=1) + 1e-12)


def uniform_over(key: tuple, valid: torch.Tensor, rows: int,
                 fold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[rows] int64 draws with replacement, uniform over the valid rows, as
    the JAX package draws them under `key` (fold as categorical_draw's)."""
    return categorical_draw(key, uniform_logits(valid), rows, fold)
