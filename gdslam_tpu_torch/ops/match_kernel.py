"""The fused projection-guided matcher: hand-written CUDA kernels
(`csrc/match_top2.cu`) and their plain PyTorch twins.

Port of the JAX package's one Pallas kernel, `gdslam_tpu/ops/pallas_match.py`
`match_top2`. For each keypoint it returns the best and second-best masked
Hamming cost and the lowest candidate row reaching the best, plus the
per-candidate-row minimum that the one-to-one rule needs.

On the card the work follows the pairs inside the search windows: the
keypoints are sorted once into a grid of image cells (`kp_grid`, kept for
as long as the same keypoint tensor is searched, which is a frame's three
matcher calls), each candidate row visits only the cells its window can
touch, and a tiled all-pairs walk takes over when the windows cover most
of the image. `kp_grid_plain` and `cand_boxes_plain` are the plain versions
of the grid and of the rows' cell boxes; `match_top2_plain` is the plain
version of the whole function.

The kernels are compiled at first use with nvcc into `build/kernels/` at
the root of the checkout (a shared library with a plain C interface, loaded
with ctypes) from the source in this package alone. `match_top2` and
`kp_grid` take the plain versions only for tensors on the CPU; for a CUDA
tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from gdslam_tpu_torch.ops import cuda_build, hamming
from gdslam_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS  # noqa: F401 (chip_smoke.py)

BIG = 1 << 20
MAX_ROWS = 1 << 20            # a row index shares a 32-bit key with its cost
GRID_CELLS = (32, 24)         # cells across the keypoints' bounding box (u, v)
PATHS = ("cells", "tiled")

_lib = None


def _nvcc() -> str:
    return cuda_build.nvcc("match_top2")


def build_library():
    """Compile csrc/match_top2.cu (cached by source and flags) and return
    the shared library's path."""
    return cuda_build.build_library("match_top2", BUILD_DIR)


def _load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kp_grid_words.argtypes = [i, i, i]
        lib.kp_grid_launch.argtypes = [p, i, i, i, p, i, p]
        lib.match_top2_words.argtypes = [i, i]
        lib.match_top2_launch.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i,
                                          p, i, i, p, i, i, p]
        lib.empty_launch.argtypes = [i, i, p]
        for fn in (lib.kp_grid_words, lib.kp_grid_launch, lib.match_top2_words,
                   lib.match_top2_launch, lib.empty_launch):
            fn.restype = ctypes.c_int
        # the two buffers are laid out here and in the C source: hold them equal
        if lib.match_top2_words(4096, 1500) != _work_words(4096, 1500) or \
                lib.kp_grid_words(1501, 32, 24) != _grid_offsets(1501, 32, 24)[2]:
            raise RuntimeError("match_top2: buffer layouts of the wrapper and the library differ")
        _lib = lib
    return _lib


def _grid_offsets(N: int, gx: int, gy: int) -> tuple[int, int, int]:
    """The grid buffer in 32-bit words: header [4], cell_start [cells + 1],
    then kp_order [N] and sorted_uv [2 N], each starting on an even word.
    Returns (where kp_order starts, where sorted_uv starts, the total)."""
    o_order = 4 + gx * gy + 1
    o_order += o_order % 2
    o_uv = o_order + N + N % 2
    return o_order, o_uv, o_uv + 2 * N


def _work_words(M: int, N: int) -> int:
    """The work buffer in 32-bit words: the keypoints' 64-bit states [2 N],
    best, second, arg [N each], best_cand [M], two scratch arrays [M each],
    one partial sum per 256 rows or keypoints, and four info words."""
    return 5 * N + 3 * M + max(1, -(-max(M, N) // 256)) + 4


def _check(name, t, dtype, shape, device):
    cuda_build.check("match_top2", name, t, dtype, shape, device)


def _launch(device, fn, *args) -> None:
    """Call a C launch function for `device` on its current stream; raise on
    a CUDA error. Nothing here synchronises."""
    cuda_build.launch("match_top2", device, fn, *args)


# ----------------------------------------------------------------------------
# The keypoint grid
# ----------------------------------------------------------------------------

class KpGrid(NamedTuple):
    """Keypoints sorted by image cell. Cell (cx, cy) has index cy * gx + cx
    and holds kp_order[cell_start[index] : cell_start[index + 1]]."""

    hdr: torch.Tensor          # [4] f32: origin u0, v0; cells per pixel in u, v
    cell_start: torch.Tensor   # [gx * gy + 1] int32
    kp_order: torch.Tensor     # [N] int32 keypoint rows, cell by cell
    sorted_uv: torch.Tensor    # [N, 2] f32 kp_uv[kp_order]
    gx: int
    gy: int


def _cell_coord(x, x0, inv, g: int, nan_cell: int):
    """Cell coordinate on one axis: floor((x - x0) * inv) clamped to the
    grid, `nan_cell` where that is not a number. Monotone in x."""
    t = (x - x0) * inv
    c = torch.clamp(torch.floor(t), 0, g - 1)
    return torch.where(torch.isnan(t), float(nan_cell), c).to(torch.int32)


def kp_grid_plain(kp_uv, gx: int = GRID_CELLS[0], gy: int = GRID_CELLS[1]) -> KpGrid:
    """The grid in plain PyTorch: gx x gy cells over the bounding box of the
    finite keypoints (one cell on an axis with no extent); a keypoint
    outside falls into the nearest border cell, a NaN into cell 0. Inside a
    cell the keypoints keep their order (the kernel leaves that order
    open)."""
    u, v = kp_uv[:, 0], kp_uv[:, 1]
    fin = torch.isfinite(u) & torch.isfinite(v)
    inf = torch.tensor([float("inf")], device=kp_uv.device)

    def axis(x, g):
        lo = torch.cat([torch.where(fin, x, inf), inf]).amin()
        hi = torch.cat([torch.where(fin, x, -inf), -inf]).amax()
        span = hi - lo
        inv = torch.where((span > 0) & torch.isfinite(span),
                          torch.tensor(float(g), device=x.device) / span, 0.0)
        return torch.where(hi >= lo, lo, 0.0), inv

    (u0, iu), (v0, iv) = axis(u, gx), axis(v, gy)
    cell = (_cell_coord(v, v0, iv, gy, 0) * gx + _cell_coord(u, u0, iu, gx, 0)).long()
    order = torch.argsort(cell, stable=True)
    counts = torch.bincount(cell, minlength=gx * gy)
    cell_start = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return KpGrid(hdr=torch.stack([u0, v0, iu, iv]), cell_start=cell_start,
                  kp_order=order.to(torch.int32), sorted_uv=kp_uv[order], gx=gx, gy=gy)


def cand_boxes_plain(cand_uv, cand_radius, cand_valid, grid: KpGrid):
    """Each candidate row's box of cells, as the kernel computes it:
    (cx0, cx1, cy0, cy1) int32 [M, 4] and skip [M] bool. The box is the
    bounding box of uv +- R with R = |r| * 1.00001 + |uv| * 1e-6 + 1e-3,
    mapped with the grid's monotone cell coordinate, so every keypoint that
    the exact window test accepts lies in a cell of the box; a row that is
    invalid or holds a NaN matches nothing and is skipped."""
    u0, v0, iu, iv = grid.hdr

    def axis(c, x0, inv, g):
        R = (cand_radius.abs() * 1.00001 + c.abs() * 1e-6) + 1e-3
        return _cell_coord(c - R, x0, inv, g, 0), _cell_coord(c + R, x0, inv, g, g - 1)

    cx0, cx1 = axis(cand_uv[:, 0], u0, iu, grid.gx)
    cy0, cy1 = axis(cand_uv[:, 1], v0, iv, grid.gy)
    skip = ~cand_valid | torch.isnan(cand_radius) | torch.isnan(cand_uv).any(dim=1)
    return torch.stack([cx0, cx1, cy0, cy1], dim=1), skip


def kp_grid(kp_uv, gx: int = GRID_CELLS[0], gy: int = GRID_CELLS[1]) -> KpGrid:
    """Sort keypoints kp_uv [N, 2] f32 into gx x gy image cells (each at
    most 256, at most 4096 cells). One kernel launch on the card."""
    if not (1 <= gx <= 256 and 1 <= gy <= 256 and gx * gy <= 4096):
        raise ValueError(f"kp_grid: unsupported grid {gx} x {gy}")
    device = kp_uv.device
    if device.type == "cpu":
        return kp_grid_plain(kp_uv, gx, gy)
    if device.type != "cuda":
        raise ValueError(f"kp_grid: unsupported device {device}")
    N = kp_uv.shape[0]
    _check("kp_uv", kp_uv, torch.float32, (N, 2), device)
    lib = _load_library()
    if kp_uv.data_ptr() % 8:
        raise ValueError("kp_grid: kp_uv must be 8-byte aligned")
    cells = gx * gy
    o_order, o_uv, words = _grid_offsets(N, gx, gy)
    buf = torch.empty(words, dtype=torch.int32, device=device)
    _launch(device, lib.kp_grid_launch, kp_uv.data_ptr(), N, gx, gy, buf.data_ptr())
    grid = KpGrid(hdr=buf[:4].view(torch.float32), cell_start=buf[4:4 + cells + 1],
                  kp_order=buf[o_order:o_order + N],
                  sorted_uv=buf[o_uv:].view(torch.float32).view(N, 2), gx=gx, gy=gy)
    kp_grid.launches += 1
    return grid


kp_grid.launches = 0

# The grid of the keypoint tensor searched last: (weak reference, the
# tensor's version counter, KpGrid). A frame's matcher calls pass the same
# tensor object, so the grid is built by the first and reused by the rest;
# an in-place write bumps the version and a new tensor is a new object, so a
# stale grid is never used. Calls that share a grid must share a stream.
_grid_cache = None


def _grid_for(kp_uv) -> tuple[KpGrid, int]:
    """The cached grid of kp_uv, or a new one; and the launches it took."""
    global _grid_cache
    c = _grid_cache
    if c is not None and c[0]() is kp_uv and c[1] == kp_uv._version:
        return c[2], 0
    grid = kp_grid(kp_uv, *GRID_CELLS)
    _grid_cache = (weakref.ref(kp_uv), kp_uv._version, grid)
    return grid, 1


# ----------------------------------------------------------------------------
# The matcher
# ----------------------------------------------------------------------------

def match_top2_plain(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
                     kp_uv, kp_desc, kp_level, kp_valid, level_slack: int = 1):
    """The same function in plain PyTorch over the dense [M, N] cost."""
    ham = hamming.hamming_matrix(cand_desc, kp_desc)                  # [M, N]
    du = cand_uv[:, None, 0] - kp_uv[None, :, 0]
    dv = cand_uv[:, None, 1] - kp_uv[None, :, 1]
    within = (du * du + dv * dv) <= (cand_radius * cand_radius)[:, None]
    lvl_ok = torch.abs(cand_level[:, None] - kp_level[None, :]) <= level_slack
    mask = within & lvl_ok & cand_valid[:, None] & kp_valid[None, :]
    cost = torch.where(mask, ham, BIG)
    if 0 in cost.shape:                          # nothing to reduce over
        i32 = dict(dtype=torch.int32, device=cost.device)
        none = torch.full((cost.shape[1],), BIG, **i32)
        return none, none.clone(), torch.full_like(none, -1), torch.full((cost.shape[0],), BIG, **i32)
    best = cost.amin(dim=0)
    arg = torch.argmin(cost, dim=0)                                   # first among ties
    rows = torch.arange(cost.shape[0], device=cost.device)
    second = torch.where(rows[:, None] == arg[None, :], BIG, cost).amin(dim=0)
    arg = torch.where(best < BIG, arg, -1).to(torch.int32)
    best_cand = cost.amin(dim=1)
    return best, second, arg, best_cand


def match_top2(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
               kp_uv, kp_desc, kp_level, kp_valid, level_slack: int = 1, *,
               path: str | None = None):
    """Fused masked-Hamming top-2.

    cand_uv [M, 2] f32, cand_desc [M, 32] uint8 packed, cand_radius [M] f32,
    cand_level [M] int32, cand_valid [M] bool; kp_* likewise with N rows.
    Returns int32 (best [N], second [N], arg [N] (-1 = none), best_cand [M]).

    On the card the kernel chooses between its cell walk and its tiled
    all-pairs walk from the inputs; `path` ("cells" or "tiled") forces one,
    for measurements and tests. The outputs are the same either way. The
    four outputs are views of one allocation.
    """
    device = cand_uv.device
    if device.type == "cpu":
        return match_top2_plain(cand_uv, cand_desc, cand_radius, cand_level, cand_valid,
                                kp_uv, kp_desc, kp_level, kp_valid, level_slack)
    if device.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {device}")
    M, N = cand_uv.shape[0], kp_uv.shape[0]
    if M >= MAX_ROWS:
        raise ValueError(f"match_top2: {M} candidate rows, at most {MAX_ROWS - 1} on the card")
    force = -1 if path is None else PATHS.index(path)
    f32, u8, i32, b8 = torch.float32, torch.uint8, torch.int32, torch.bool
    for name, t, dt, shape in (
            ("cand_uv", cand_uv, f32, (M, 2)), ("cand_desc", cand_desc, u8, (M, 32)),
            ("cand_radius", cand_radius, f32, (M,)), ("cand_level", cand_level, i32, (M,)),
            ("cand_valid", cand_valid, b8, (M,)), ("kp_uv", kp_uv, f32, (N, 2)),
            ("kp_desc", kp_desc, u8, (N, 32)), ("kp_level", kp_level, i32, (N,)),
            ("kp_valid", kp_valid, b8, (N,))):
        # the test inline, the message from _check: this runs on every call
        if t.dtype is not dt or t.shape != shape or t.device != device or not t.is_contiguous():
            _check(name, t, dt, shape, device)
    lib = _load_library()
    p_cuv, p_cdesc, p_kuv, p_kdesc = (cand_uv.data_ptr(), cand_desc.data_ptr(),
                                      kp_uv.data_ptr(), kp_desc.data_ptr())
    if p_cdesc % 16 or p_kdesc % 16:
        raise ValueError("match_top2: descriptors must be 16-byte aligned")
    if p_cuv % 8 or p_kuv % 8:
        raise ValueError("match_top2: uv must be 8-byte aligned")
    grid, grid_launches = _grid_for(kp_uv)
    words = _work_words(M, N)
    buf = torch.empty(words, dtype=torch.int32, device=device)
    _launch(device, lib.match_top2_launch,
            p_cuv, p_cdesc, cand_radius.data_ptr(), cand_level.data_ptr(),
            cand_valid.data_ptr(), M, p_kuv, p_kdesc, kp_level.data_ptr(),
            kp_valid.data_ptr(), N, int(level_slack),
            grid.hdr.data_ptr(), grid.gx, grid.gy, buf.data_ptr(), force)
    _, best, second, arg, best_cand, _ = buf.split_with_sizes(
        (2 * N, N, N, N, M, words - 5 * N - M))
    match_top2.launches += 1
    match_top2.cuda_launches += 2 + grid_launches
    match_top2.last = (buf, 2 + grid_launches)
    return best, second, arg, best_cand


match_top2.launches = 0          # calls that reached the card
match_top2.cuda_launches = 0     # CUDA kernel launches those calls made
match_top2.last = None           # (work buffer on the card, CUDA launches) of the last call


def last_call() -> dict:
    """What the last card call did: the path its kernel took, how many
    keypoints its rows' cell boxes held, and its CUDA launches (2: prep and
    match; 3 when it also built the keypoint grid). Reads the card, so it
    synchronises."""
    buf, launches = match_top2.last
    _, path, lo, hi = (int(x) & 0xFFFFFFFF for x in buf[-4:].tolist())
    return dict(path=PATHS[path], boxed_keypoints=(hi << 32) | lo, cuda_launches=launches)
