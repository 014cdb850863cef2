"""Builds and launches the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain C
interface under `build/kernels/` at the root of the checkout, loaded with
ctypes. A library is named by a hash of its source and the flags, built at
first use (never at import) and moved into place with an atomic rename, so
a concurrent build never sees a partial file. `build_all` starts one nvcc
per source at once, for a caller that needs every kernel (chip_smoke.py).

Every C launch function takes its arguments, then the device index and the
stream, and returns cudaGetLastError(); `launch` raises if that is not 0.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("match_top2", "nms_fixed", "roi_align", "roi_align_backward", "paste_masks",
           "stereo_match", "categorical_draw", "orb_extract")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def nvcc(name: str) -> str:
    """The nvcc to build `name` with: PATH, CUDA_HOME, then the default."""
    from torch.utils.cpp_extension import CUDA_HOME
    exe = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not exe or not os.path.exists(exe):
        raise RuntimeError(f"{name}: nvcc not found; the CUDA kernel cannot be built")
    return exe


def library_path(name: str, build_dir: Path | None = None) -> Path:
    """Where the library of `name` lives once built (by source and flags)."""
    tag = hashlib.sha1(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir or BUILD_DIR) / f"lib{name}_{tag}.so"


def _start(name: str, build_dir: Path):
    """Start nvcc on `name` into a temporary file; (process, temporary path)."""
    exe = nvcc(name)
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    proc = subprocess.Popen([exe, *NVCC_FLAGS, "-o", tmp, str(source(name))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str, so: Path) -> None:
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_all(names=SOURCES, build_dir: Path | None = None) -> dict:
    """Compile every library of `names` that is not built yet, one nvcc per
    source, all started together. Returns {name: library path}."""
    build_dir = Path(build_dir or BUILD_DIR)
    paths = {n: library_path(n, build_dir) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    started = []
    try:
        for n in todo:
            started.append((n, *_start(n, build_dir)))
    finally:
        errors = []
        for n, proc, tmp in started:
            try:
                _finish(n, proc, tmp, paths[n])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def build_library(name: str, build_dir: Path | None = None) -> Path:
    """Compile csrc/<name>.cu if it is not built yet; the library's path."""
    return build_all((name,), build_dir)[name]


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of `name` (built at the first call), its C
    signatures set by declare(lib) once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        declare(lib)
        _libs[name] = lib
    return lib


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device, index: int) -> int:
    """The current stream's handle (the short way where torch has it)."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device, fn, *args) -> None:
    """Call a C launch function for `device` on its current stream; raise on
    a CUDA error. Nothing here synchronises."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = fn(*args, index, current_stream(device, index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def check(name: str, what: str, t, dtype, shape, device) -> None:
    """Raise ValueError unless tensor t has this device, dtype and shape and
    is contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
