"""The fused projection-guided matcher: a hand-written CUDA kernel
(`csrc/match_top2.cu`) and its plain PyTorch twin.

Port of the JAX package's one Pallas kernel, `gdslam_tpu/ops/pallas_match.py`
`match_top2`. For each keypoint it returns the best and second-best masked
Hamming cost and the lowest candidate row reaching the best, plus the
per-candidate-row minimum that the one-to-one rule needs.

The kernel is compiled at first use with nvcc into `build/kernels/` at the
root of the checkout (a shared library with a plain C interface, loaded
with ctypes) from the source in this package alone. `match_top2` takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gdslam_tpu_torch.ops import orb

BIG = 1 << 20
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "match_top2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # PATH, CUDA_HOME, then the default
    nvcc = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("match_top2: nvcc not found; the CUDA kernel cannot be built")
    return nvcc


def build_library() -> Path:
    """Compile csrc/match_top2.cu (cached by source and flags) and return
    the shared library's path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libmatch_top2_{tag}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)    # atomic: concurrent builders never see a partial file
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"match_top2: nvcc failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.match_top2_launch.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i,
                                          p, p, p, p, p]
        lib.match_top2_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"match_top2: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"match_top2: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"match_top2: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"match_top2: {name} must be contiguous")


def match_top2_plain(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
                     kp_uv, kp_desc, kp_level, kp_valid, level_slack: int = 1):
    """The same function in plain PyTorch over the dense [M, N] cost."""
    pm1_c = orb.unpack_bits(cand_desc).float() * 2.0 - 1.0
    pm1_k = orb.unpack_bits(kp_desc).float() * 2.0 - 1.0
    # +-1 dot products are integers <= 256: exact in f32 in any summation order
    ham = ((256.0 - pm1_c @ pm1_k.T) * 0.5).to(torch.int32)          # [M, N]
    du = cand_uv[:, None, 0] - kp_uv[None, :, 0]
    dv = cand_uv[:, None, 1] - kp_uv[None, :, 1]
    within = (du * du + dv * dv) <= (cand_radius * cand_radius)[:, None]
    lvl_ok = torch.abs(cand_level[:, None] - kp_level[None, :]) <= level_slack
    mask = within & lvl_ok & cand_valid[:, None] & kp_valid[None, :]
    cost = torch.where(mask, ham, BIG)
    best = cost.amin(dim=0)
    arg = torch.argmin(cost, dim=0)                                   # first among ties
    rows = torch.arange(cost.shape[0], device=cost.device)
    second = torch.where(rows[:, None] == arg[None, :], BIG, cost).amin(dim=0)
    arg = torch.where(best < BIG, arg, -1).to(torch.int32)
    best_cand = cost.amin(dim=1)
    return best, second, arg, best_cand


def match_top2(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
               kp_uv, kp_desc, kp_level, kp_valid, level_slack: int = 1):
    """Fused masked-Hamming top-2.

    cand_uv [M, 2] f32, cand_desc [M, 32] uint8 packed, cand_radius [M] f32,
    cand_level [M] int32, cand_valid [M] bool; kp_* likewise with N rows.
    Returns int32 (best [N], second [N], arg [N] (-1 = none), best_cand [M]).
    """
    device = cand_uv.device
    if device.type == "cpu":
        return match_top2_plain(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
                                kp_uv, kp_desc, kp_level, kp_valid, level_slack)
    if device.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {device}")
    M, N = cand_uv.shape[0], kp_uv.shape[0]
    for name, t, dt, shape in (
            ("cand_uv", cand_uv, torch.float32, (M, 2)),
            ("cand_desc", cand_desc, torch.uint8, (M, 32)),
            ("cand_radius", cand_radius, torch.float32, (M,)),
            ("cand_level", cand_level, torch.int32, (M,)),
            ("cand_valid", cand_valid, torch.bool, (M,)),
            ("kp_uv", kp_uv, torch.float32, (N, 2)),
            ("kp_desc", kp_desc, torch.uint8, (N, 32)),
            ("kp_level", kp_level, torch.int32, (N,)),
            ("kp_valid", kp_valid, torch.bool, (N,))):
        _check(name, t, dt, shape, device)
    lib = _load_library()
    if cand_desc.data_ptr() % 4 or kp_desc.data_ptr() % 4:
        raise ValueError("match_top2: descriptors must be 4-byte aligned")
    best = torch.empty(N, dtype=torch.int32, device=device)
    second = torch.empty(N, dtype=torch.int32, device=device)
    arg = torch.empty(N, dtype=torch.int32, device=device)
    best_cand = torch.empty(M, dtype=torch.int32, device=device)
    with torch.cuda.device(device):     # the C launch runs on the current device
        err = lib.match_top2_launch(
            cand_uv.data_ptr(), cand_desc.data_ptr(), cand_radius.data_ptr(),
            cand_level.data_ptr(), cand_valid.data_ptr(), M,
            kp_uv.data_ptr(), kp_desc.data_ptr(), kp_level.data_ptr(),
            kp_valid.data_ptr(), N, int(level_slack),
            best.data_ptr(), second.data_ptr(), arg.data_ptr(), best_cand.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"match_top2: kernel launch failed with CUDA error {err}")
    match_top2.launches += 1
    return best, second, arg, best_cand


match_top2.launches = 0
