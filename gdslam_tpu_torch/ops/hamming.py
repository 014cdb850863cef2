"""Hamming distance between 256-bit ORB descriptors (port of
gdslam_tpu.ops.hamming): XOR + popcount on packed uint8, the all-pairs
matrix as one +-1 product, and the best / second-best / argbest reduction
used by ratio tests."""

from __future__ import annotations

import torch

from gdslam_tpu_torch.ops import orb


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount (SWAR), returns int32."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed [..., 32] uint8 descriptors -> Hamming distance [...] int32."""
    return torch.sum(popcount_u8(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances [Na, Nb] int32 of packed [N, 32] uint8
    descriptors as one matrix product of their +-1 forms: ham = (256 - a.b)
    / 2. The products are integers <= 256, so f32 is exact in any summation
    order (TF32 is off package-wide). Callers mask invalid rows themselves."""
    pm1_a = orb.unpack_bits(a).float() * 2.0 - 1.0
    pm1_b = orb.unpack_bits(b).float() * 2.0 - 1.0
    return ((256.0 - pm1_a @ pm1_b.T) * 0.5).to(torch.int32)


def best_two(dists: torch.Tensor, dim: int = -1):
    """Best and second-best (counting duplicates) distances + best index
    (lowest among ties) along a dim."""
    d = dists.transpose(dim, -1)
    best = d.amin(dim=-1)
    arg = torch.argmin(d, dim=-1)       # the first index among ties
    cols = torch.arange(d.shape[-1], device=d.device)
    fill = torch.iinfo(d.dtype).max if not d.dtype.is_floating_point else float("inf")
    second = torch.where(cols == arg[..., None], fill, d).amin(dim=-1)
    return best, second, arg.to(torch.int32)
