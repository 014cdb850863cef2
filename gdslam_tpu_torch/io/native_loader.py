"""ctypes bindings for the native prefetching TUM loader (the port's own
binding to native/tum_loader.cpp).

The library decodes PNGs on a background thread into a bounded ring buffer,
so reading frames overlaps tracking. It is built from the checkout's
native/tum_loader.cpp with g++ and zlib into build/native/ at first use
(never into native/). If it cannot be built, available() is false and the
CLIs read frames with io.tum.TumSequence instead; reading frames is host
work either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "tum_loader.cpp"
BUILD_DIR = ROOT / "build" / "native"
LIBRARY = BUILD_DIR / "libtumloader.so"


def build_library() -> Path:
    """g++ -O3 -shared native/tum_loader.cpp -lz -lpthread into
    build/native/ (through a temporary name, so a concurrent build never
    leaves a half-written library). Raises if the source or the compiler is
    missing or the build fails."""
    if not SOURCE.is_file():
        raise FileNotFoundError(f"{SOURCE} is not in this checkout")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp,
                        str(SOURCE), "-lz", "-lpthread"], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


def _load_lib():
    try:
        path = LIBRARY if LIBRARY.is_file() else build_library()
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.tum_loader_open.restype = ctypes.c_void_p
    lib.tum_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double]
    lib.tum_loader_len.restype = ctypes.c_long
    lib.tum_loader_len.argtypes = [ctypes.c_void_p]
    for name, rgb_t, depth_t in (("tum_loader_next", ctypes.c_float, ctypes.c_float),
                                 ("tum_loader_next_raw", ctypes.c_uint8, ctypes.c_uint16)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(rgb_t), ctypes.POINTER(depth_t),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long]
    lib.tum_loader_close.restype = None
    lib.tum_loader_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    global _LIB
    if _LIB is None:
        _LIB = _load_lib() or False
    return _LIB is not False


class NativeTumSequence:
    """Sequential iterator over a TUM sequence with native prefetch."""

    def __init__(self, sequence_dir: str, associations_path: str,
                 depth_map_factor: float = 5000.0, width: int = 640, height: int = 480,
                 raw: bool = False):
        """raw=True yields (uint8 rgb, uint16 depth in sensor units, ts), a
        smaller upload; the System scales the depth on the device (the
        reference's DepthMapFactor contract). Otherwise (float32 rgb, float32
        depth in metres, ts)."""
        if not available():
            raise RuntimeError("native loader not built (g++ and zlib are needed)")
        self._h = _LIB.tum_loader_open(sequence_dir.encode(), associations_path.encode(),
                                       depth_map_factor)
        if not self._h:
            raise FileNotFoundError(associations_path)
        self._n = int(_LIB.tum_loader_len(self._h))
        self.raw = raw
        rgb_dt, depth_dt = (np.uint8, np.uint16) if raw else (np.float32, np.float32)
        self._rgb = np.empty((height, width, 3), rgb_dt)
        self._depth = np.empty((height, width), depth_dt)

    def __len__(self):
        return self._n

    def __iter__(self):
        ts = ctypes.c_double()
        fn = _LIB.tum_loader_next_raw if self.raw else _LIB.tum_loader_next
        rgb_t, depth_t = fn.argtypes[1]._type_, fn.argtypes[2]._type_
        while True:
            rc = fn(self._h, self._rgb.ctypes.data_as(ctypes.POINTER(rgb_t)),
                    self._depth.ctypes.data_as(ctypes.POINTER(depth_t)), ctypes.byref(ts),
                    self._rgb.size, self._depth.size)
            if rc == 1:
                return
            if rc == 2:
                continue   # decode failure: skip the frame
            yield self._rgb.copy(), self._depth.copy(), float(ts.value)

    def close(self):
        if self._h:
            _LIB.tum_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
