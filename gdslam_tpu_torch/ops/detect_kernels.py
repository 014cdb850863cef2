"""The detection stages of Mask R-CNN as hand-written CUDA kernels
(`csrc/nms_fixed.cu`, `csrc/roi_align.cu`, `csrc/roi_align_backward.cu`,
`csrc/paste_masks.cu`) and their plain PyTorch twins.

Ports of three stages that XLA fuses in the JAX package
(`gdslam_tpu/models/maskrcnn.py`): `nms_fixed` (:202), fixed-budget greedy
NMS; `roi_align` (:222), the bilinear crop from the FPN level chosen per box,
differentiable with respect to the levels (its gradient, the transpose
jax.grad builds, is `roi_align_backward`); `paste_masks` (:744), the union
of the dynamic-class instance masks pasted at full resolution. Each wrapper
takes its plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises, and counts its launches in
`<wrapper>.launches`. The kernels are built at first use by
`ops/cuda_build.py`.

The arithmetic that decides a comparison is kept in the JAX order, without
fused multiply-adds, on both routes: IoU term by term, the ROIAlign blend
left to right, the paste's row pass before its column pass.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gdslam_tpu_torch.ops import cuda_build

NMS_MAX_N = 1024                 # one CTA of up to 1024 threads per mask row
ROI_BACKWARD_MAX_OUT = 32        # a box's bins along a side fit one 32-bit mask
ROI_BACKWARD_MAX_R = 1024        # the listed candidates fit shared memory
MASK = 28                        # the mask head's output side
PASTE_MAX_D = 64                 # masks staged in shared memory: 64 x 3,156 bytes
ROI_STRIDES = (4, 8, 16, 32)     # P2..P5
# The smallest float32 box areas fl(max(h, 1) * max(w, 1)) of levels 1, 2, 3:
# where floor(2 + log2(sqrt(area) / 224 + 1e-9)), the JAX package's rule
# evaluated op by op in float32, steps up (the last a few ulps below 448^2,
# where 2 + log2 rounds up to 3).
ROI_LEVEL_AREA = (12544.0, 50176.0, 200703.96875)
DYNAMIC_CLASS_IDS = tuple(range(1, 10)) + tuple(range(15, 25))
# the dynamic classes as the kernel's 96-bit class mask, three 32-bit words
DYNAMIC_CLASS_WORDS = tuple(sum(1 << (c - 32 * k) for c in DYNAMIC_CLASS_IDS
                                if 32 * k <= c < 32 * k + 32) for k in range(3))
PASTE_TILE = 32                  # the kernel's tile side


def _declare(lib) -> None:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    sigs = {"nms_fixed_launch": [p, p, i, f, i, p, p],
            "roi_align_launch": [p, i, p, i, i, f] + [i] * 8 + [p] * 6,
            "roi_align_backward_launch": [p, i, i, i, p, p, p, p, p] + [i] * 8 + [p],
            "paste_masks_launch": [p, p, p, p, i, i, i, f, u, u, u, i, p]}
    for name, args in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args + [i, p]
            fn.restype = i


def _library(name: str):
    return cuda_build.load(name, _declare)


def _device(name: str, t: torch.Tensor):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


# ----------------------------------------------------------------------------
# Boxes
# ----------------------------------------------------------------------------

def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Na, Nb] IoU matrix of (y1, x1, y2, x2) boxes."""
    y1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(b[:, 3] - b[:, 1], min=0)
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter, min=1e-9)


# ----------------------------------------------------------------------------
# nms_fixed
# ----------------------------------------------------------------------------

def nms_fixed_plain(boxes, scores, iou_th: float, n_out: int) -> torch.Tensor:
    """Greedy NMS with a fixed budget: n_out steps, each picking the alive
    box of highest score (the lowest index among ties) or -1 when none is
    alive, then clearing every box whose IoU with it exceeds iou_th.
    Returns [n_out] int32 indices."""
    iou = box_iou(boxes, boxes)
    alive = scores > -torch.inf
    picked = []
    neg = torch.full_like(scores, -torch.inf)
    for _ in range(n_out):
        best = torch.argmax(torch.where(alive, scores, neg)).reshape(1)
        ok = alive.gather(0, best)
        picked.append(torch.where(ok, best, -1))
        alive = alive & (iou.index_select(0, best)[0] <= iou_th)
        alive = alive.index_fill(0, best, False)
    if not picked:
        return torch.empty(0, dtype=torch.int32, device=boxes.device)
    return torch.cat(picked).to(torch.int32)


def nms_scratch_words(n: int) -> int:
    """The kernel's scratch in int32 words: the suppression bitmask
    (n x ceil(n / 32)), then the boxes in score order (n)."""
    return n * ((n + 31) // 32) + n


def nms_fixed(boxes, scores, iou_th: float, n_out: int) -> torch.Tensor:
    """Fixed-budget NMS: boxes [N, 4] f32 (y1, x1, y2, x2), scores [N] f32
    (-inf: never picked), N <= 1024. Returns [n_out] int32 indices, -1
    padded. On the card one call is two CUDA launches (the bitmask, then the
    walk), counted as one."""
    name = "nms_fixed"
    device = _device(name, boxes)
    if device.type == "cpu":
        return nms_fixed_plain(boxes, scores, iou_th, n_out)
    N = boxes.shape[0]
    if not 1 <= N <= NMS_MAX_N:
        raise ValueError(f"{name}: {N} boxes, the kernel takes 1 to {NMS_MAX_N}")
    if n_out < 0:
        raise ValueError(f"{name}: n_out {n_out} < 0")
    cuda_build.check(name, "boxes", boxes, torch.float32, (N, 4), device)
    cuda_build.check(name, "scores", scores, torch.float32, (N,), device)
    lib = _library(name)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{name}: boxes must be 16-byte aligned")
    out = torch.empty(n_out, dtype=torch.int32, device=device)
    if n_out:
        scratch = torch.empty(nms_scratch_words(N), dtype=torch.int32, device=device)
        cuda_build.launch(name, device, lib.nms_fixed_launch, boxes.data_ptr(),
                          scores.data_ptr(), N, float(np.float32(iou_th)), n_out,
                          out.data_ptr(), scratch.data_ptr())
        nms_fixed.launches += 1
    return out


nms_fixed.launches = 0


# ----------------------------------------------------------------------------
# roi_align
# ----------------------------------------------------------------------------

def flatten_levels(feats) -> tuple[torch.Tensor, tuple]:
    """P2..P5 ([1, C, h, w] each) as one [sum(h * w), C] channels-last
    buffer, and their (h, w)."""
    C = feats[0].shape[1]
    flat = torch.cat([f[0].permute(1, 2, 0).reshape(-1, C) for f in feats[:4]])
    return flat, tuple((f.shape[2], f.shape[3]) for f in feats[:4])


def _linspace01(n: int) -> np.ndarray:
    """jnp.linspace(0, 1, n) in float32 as XLA computes it: i times the
    float32 reciprocal of n - 1, the last point exactly 1."""
    if n == 1:
        return np.zeros(1, np.float32)
    out = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(n - 1))
    out[-1] = 1
    return out


@functools.lru_cache(maxsize=None)
def _roi_tables(shapes, out_size: int, device):
    """Per level (row offset, h, w) [4, 3] int32 and stride [4] f32, and the
    sample positions [out] f32, on `device` (uploaded once)."""
    offsets = np.cumsum([0] + [a * b for a, b in shapes])[:4]
    table = torch.tensor([[o, a, b] for o, (a, b) in zip(offsets, shapes)], dtype=torch.int32)
    stride = torch.tensor(ROI_STRIDES, dtype=torch.float32)
    t = torch.from_numpy(_linspace01(out_size))
    return table.to(device), stride.to(device), t.to(device)


def roi_step(out_size: int) -> float:
    """The float32 reciprocal of out - 1, linspace's step (_linspace01),
    handed to the kernel; 0 for a lone point."""
    return float(_linspace01(out_size)[1]) if out_size > 1 else 0.0


def roi_levels(boxes: torch.Tensor) -> torch.Tensor:
    """[R] int64 FPN level (0 = P2) of each box by the sqrt(hw) / 224 rule,
    as the kernel decides it: the number of ROI_LEVEL_AREA thresholds that
    the float32 area fl(max(y2 - y1, 1) * max(x2 - x1, 1)) reaches. Every
    step of the JAX expression is monotone in the area, so this equals it
    wherever it equals it at the thresholds (tests/test_torch_maskrcnn.py
    holds it to the JAX roi_align on boxes a few ulps either side of each),
    with no log2, whose last bit differs between the CPU and the card."""
    h = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)
    w = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0)
    area = h * w
    return sum((area >= a).long() for a in ROI_LEVEL_AREA)


def roi_prologue(shapes, boxes: torch.Tensor, out_size: int):
    """The per-box part of ROIAlign, which the kernel computes for itself
    (and writes out for the gradient): the level of each box (roi_levels),
    its sample rows and columns. Returns (info [R, 3] int32: level offset,
    h, w; y0, x0 [R, out] int32; fy, fx [R, out] f32)."""
    table, strides, t = _roi_tables(tuple(shapes), out_size, boxes.device)
    level = roi_levels(boxes)
    info = table.index_select(0, level)                                  # [R, 3]
    stride = strides.index_select(0, level)[:, None]
    y = (boxes[:, 0:1] + t[None] * (boxes[:, 2:3] - boxes[:, 0:1])) / stride - 0.5
    x = (boxes[:, 1:2] + t[None] * (boxes[:, 3:4] - boxes[:, 1:2])) / stride - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    return info, y0.to(torch.int32), x0.to(torch.int32), y - y0, x - x0


def tap_rows(info, y0, x0, dy: int, dx: int) -> torch.Tensor:
    """[R, out, out] int64: the row of flat that tap (dy, dx) of every bin
    reads, its sample row and column clamped to the box's level."""
    off, h, w = (info[:, k, None, None].long() for k in range(3))           # [R, 1, 1]
    yi = torch.minimum(torch.clamp(y0.long() + dy, min=0)[:, :, None], h - 1)
    xi = torch.minimum(torch.clamp(x0.long() + dx, min=0)[:, None, :], w - 1)
    return off + yi * w + xi


def roi_align_plain(flat, shapes, boxes, out_size: int, prologue=None) -> torch.Tensor:
    """The crop in plain PyTorch: [R, out, out, C], channels last.
    `prologue` is roi_prologue(shapes, boxes, out_size) where the caller
    holds it."""
    info, y0, x0, fy, fx = prologue or roi_prologue(shapes, boxes, out_size)
    fy, fx = fy[:, :, None, None], fx[:, None, :, None]
    tap = lambda dy, dx: flat[tap_rows(info, y0, x0, dy, dx)]
    return (tap(0, 0) * (1 - fy) * (1 - fx)
            + tap(0, 1) * (1 - fy) * fx
            + tap(1, 0) * fy * (1 - fx)
            + tap(1, 1) * fy * fx)


def roi_align(flat, shapes, boxes, out_size: int) -> torch.Tensor:
    """ROIAlign over P2..P5: flat [S, C] f32 (`flatten_levels`), boxes
    [R, 4] f32 in image pixels. Returns [R, out, out, C] f32, channels last.
    One launch on the card, the per-box prologue included.
    Differentiable with respect to flat (`roi_align_backward`); the boxes
    get no gradient (they are ground truth or detached proposals), and
    boxes that require one are refused."""
    name = "roi_align"
    if torch.is_grad_enabled() and (flat.requires_grad or boxes.requires_grad):
        if boxes.requires_grad:
            raise ValueError(f"{name}: the boxes get no gradient; pass them detached")
        return _RoiAlignGrad.apply(flat, boxes, tuple(shapes), out_size)
    return _roi_align(flat, shapes, boxes, out_size)[0]


def _roi_align(flat, shapes, boxes, out_size: int, with_prologue: bool = False):
    """roi_align's forward: (out, the prologue if with_prologue else None).
    On the card the kernel computes the prologue and writes it out when
    asked, bit for bit what roi_prologue gives."""
    name = "roi_align"
    device = _device(name, flat)
    if device.type == "cpu":
        prologue = roi_prologue(shapes, boxes, out_size)
        return (roi_align_plain(flat, shapes, boxes, out_size, prologue),
                prologue if with_prologue else None)
    S, C = flat.shape
    R = boxes.shape[0]
    if C % 4 or len(shapes) != len(ROI_STRIDES) or S != sum(a * b for a, b in shapes):
        raise ValueError(f"{name}: flat [{S}, {C}] does not hold the levels {shapes} "
                         "with C a multiple of 4")
    if out_size < 1:
        raise ValueError(f"{name}: out {out_size} < 1")
    boxes = boxes.contiguous()
    cuda_build.check(name, "flat", flat, torch.float32, (S, C), device)
    cuda_build.check(name, "boxes", boxes, torch.float32, (R, 4), device)
    lib = _library(name)
    if flat.data_ptr() % 16 or boxes.data_ptr() % 16:
        raise ValueError(f"{name}: flat and boxes must be 16-byte aligned")
    out = torch.empty((R, out_size, out_size, C), dtype=torch.float32, device=device)
    prologue = None
    if with_prologue:
        prologue = (torch.empty((R, 3), dtype=torch.int32, device=device),
                    *(torch.empty((R, out_size), dtype=dt, device=device)
                      for dt in (torch.int32, torch.int32, torch.float32, torch.float32)))
    if R:
        cuda_build.launch(name, device, lib.roi_align_launch, flat.data_ptr(), C,
                          boxes.data_ptr(), R, out_size, roi_step(out_size),
                          *(v for hw in shapes for v in hw),
                          out.data_ptr(),
                          *((None,) * 5 if prologue is None else (t.data_ptr() for t in prologue)))
        roi_align.launches += 1
    return out, prologue


roi_align.launches = 0


class _RoiAlignGrad(torch.autograd.Function):
    """roi_align with its gradient: the forward kernel, which also writes
    the prologue out, and a backward kernel that scatters the cotangent back
    onto the levels on that prologue."""

    @staticmethod
    def forward(ctx, flat, boxes, shapes, out_size):
        out, prologue = _roi_align(flat, shapes, boxes, out_size, with_prologue=True)
        ctx.shapes = shapes
        ctx.save_for_backward(boxes, *prologue)
        return out

    @staticmethod
    def backward(ctx, grad):
        boxes, *prologue = ctx.saved_tensors
        return (roi_align_backward(grad.contiguous(), ctx.shapes, boxes, tuple(prologue)),
                None, None, None)


def roi_backward_prologue(prologue):
    """The plain twin's contributions, from the forward's roi_prologue (the
    kernel walks the same order without listing them). Contribution (tap,
    box r, bin i, bin j) sends (g[r, i, j] * b) * a to row `target` of flat,
    where the forward's term is (flat[target] * a) * b: a the row factor, b
    the column factor. Ids are tap-major in the order the JAX transpose adds
    its four scatter-adds (taps (1, 1), (1, 0), (0, 1), (0, 0)), then r, i,
    j. Returns (target
    [N] int32 and order [N] int32, the target rows sorted stably and the id
    of each sorted entry; fa, fb [N] f32 by id), N = 4 R out^2."""
    info, y0, x0, fy, fx = prologue
    R, o = y0.shape
    targets, fa, fb = [], [], []
    for dy, dx in ((1, 1), (1, 0), (0, 1), (0, 0)):
        targets.append(tap_rows(info, y0, x0, dy, dx).reshape(-1))
        fa.append((fy if dy else 1 - fy)[:, :, None].expand(R, o, o).reshape(-1))
        fb.append((fx if dx else 1 - fx)[:, None, :].expand(R, o, o).reshape(-1))
    target, order = torch.sort(torch.cat(targets), stable=True)
    return target.to(torch.int32), order.to(torch.int32), torch.cat(fa), torch.cat(fb)


def roi_align_backward_plain(grad, shapes, boxes, prologue=None) -> torch.Tensor:
    """The gradient of roi_align with respect to flat in plain PyTorch:
    [S, C]. Each target row sums its contributions in the sorted order, tap
    by tap into a partial sum and the partial sums in turn into the total,
    one position of every run at a time: the kernel's order, so both give
    the same bits. `prologue` as roi_align_backward's."""
    R, o = grad.shape[:2]
    C = grad.shape[-1]
    bins = R * o * o
    target, order, fa, fb = roi_backward_prologue(prologue or roi_prologue(shapes, boxes, o))
    out = torch.zeros((sum(a * b for a, b in shapes), C), dtype=grad.dtype, device=grad.device)
    n = target.shape[0]
    if n == 0:
        return out
    g = grad.reshape(bins, C)
    order = order.long()
    tap = order // bins
    starts = torch.ones(n, dtype=torch.bool, device=grad.device)
    starts[1:] = target[1:] != target[:-1]
    first = torch.nonzero(starts)[:, 0]
    length = torch.diff(first, append=first.new_tensor([n]))
    total = torch.zeros((first.shape[0], C), dtype=grad.dtype, device=grad.device)
    part = torch.zeros_like(total)
    for k in range(int(length.max())):
        run = torch.nonzero(length > k)[:, 0]
        at = first[run] + k
        if k:
            new = run[tap[at] != tap[at - 1]]
            total[new] = total[new] + part[new]
            part[new] = 0
        c = order[at]
        part[run] = part[run] + (g[c - tap[at] * bins] * fb[c, None]) * fa[c, None]
    out[target[first].long()] = total + part
    return out


def roi_align_backward(grad, shapes, boxes, prologue=None) -> torch.Tensor:
    """The gradient of roi_align(flat, shapes, boxes, out) with respect to
    flat: grad [R, out, out, C] f32 (contiguous, C a multiple of 4), boxes
    [R, 4] f32. Returns [S, C] f32, S = sum(h * w) of the levels.
    `prologue` is roi_prologue(shapes, boxes, out) where the caller holds it
    (the forward's, in autograd); without it the wrapper computes it. On the
    card one launch, which takes the prologue as it is and writes every row
    (out <= 32, R <= 1024); the sums are in a fixed order, with no atomics."""
    name = "roi_align_backward"
    device = _device(name, grad)
    if device.type == "cpu":
        return roi_align_backward_plain(grad, shapes, boxes, prologue)
    if grad.dim() != 4 or grad.shape[1] != grad.shape[2]:
        raise ValueError(f"{name}: grad must be [R, out, out, C], got {tuple(grad.shape)}")
    R, o, _, C = grad.shape
    if C % 4:
        raise ValueError(f"{name}: C = {C} is not a multiple of 4")
    if not 1 <= o <= ROI_BACKWARD_MAX_OUT or R > ROI_BACKWARD_MAX_R:
        raise ValueError(f"{name}: [R, out] = [{R}, {o}], the kernel takes out 1 to "
                         f"{ROI_BACKWARD_MAX_OUT} and R up to {ROI_BACKWARD_MAX_R}")
    if len(shapes) != len(ROI_STRIDES):
        raise ValueError(f"{name}: {len(shapes)} levels, the kernel takes {len(ROI_STRIDES)}")
    cuda_build.check(name, "grad", grad, torch.float32, (R, o, o, C), device)
    cuda_build.check(name, "boxes", boxes, torch.float32, (R, 4), device)
    lib = _library(name)
    if grad.data_ptr() % 16:
        raise ValueError(f"{name}: grad must be 16-byte aligned")
    info, y0, x0, fy, fx = prologue or roi_prologue(shapes, boxes, o)
    cuda_build.check(name, "info", info, torch.int32, (R, 3), device)
    for what, t, dtype in (("y0", y0, torch.int32), ("x0", x0, torch.int32),
                           ("fy", fy, torch.float32), ("fx", fx, torch.float32)):
        cuda_build.check(name, what, t, dtype, (R, o), device)
    out = torch.empty((sum(a * b for a, b in shapes), C), dtype=torch.float32, device=device)
    cuda_build.launch(name, device, lib.roi_align_backward_launch, grad.data_ptr(), C, R, o,
                      info.data_ptr(), y0.data_ptr(), x0.data_ptr(), fy.data_ptr(),
                      fx.data_ptr(), *(v for hw in shapes for v in hw), out.data_ptr())
    roi_align_backward.launches += 1
    return out


roi_align_backward.launches = 0


# ----------------------------------------------------------------------------
# paste_masks
# ----------------------------------------------------------------------------

def paste_ok(det: dict, dynamic_only: bool = True) -> torch.Tensor:
    """[D] bool: the detections that paste (valid, and of a dynamic class)."""
    ok = det["valid"]
    if dynamic_only:
        ok = ok & torch.isin(det["classes"].to(torch.int32), _dynamic_ids(ok.device))
    return ok


@functools.lru_cache(maxsize=None)
def _dynamic_ids(device) -> torch.Tensor:
    return torch.tensor(DYNAMIC_CLASS_IDS, dtype=torch.int32).to(device)


def _interp(coord: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Per axis of every box: the mask cell k0 [D, P] and weight w [D, P] of
    interp_matrix (the two non-zero columns of a row are k0 and k0 + 1)."""
    f = (coord[None] - lo[:, None]) / torch.clamp(hi - lo, min=1.0)[:, None] * MASK - 0.5
    k0 = torch.clamp(torch.floor(f), 0, MASK - 2)
    return k0.long(), torch.clamp(f - k0, 0, 1)


def paste_values(det: dict, image_hw) -> torch.Tensor:
    """[D, H, W] f32: each mask resampled over the whole image, the row pass
    ((Ky @ m): rows k0, k0 + 1 of the mask) before the column pass."""
    H, W = image_hw
    boxes, m = det["boxes"], det["masks"]
    dev = boxes.device
    ky, wy = _interp(torch.arange(H, dtype=torch.float32, device=dev), boxes[:, 0], boxes[:, 2])
    kx, wx = _interp(torch.arange(W, dtype=torch.float32, device=dev), boxes[:, 1], boxes[:, 3])
    rows = lambda k: torch.gather(m, 1, k[:, :, None].expand(-1, -1, MASK))     # [D, H, 28]
    r = (1 - wy)[:, :, None] * rows(ky) + wy[:, :, None] * rows(ky + 1)
    cols = lambda k: torch.gather(r, 2, k[:, None, :].expand(-1, H, -1))         # [D, H, W]
    return (1 - wx)[:, None, :] * cols(kx) + wx[:, None, :] * cols(kx + 1)


def paste_masks_plain(det: dict, image_hw, dynamic_only: bool = True,
                      mask_th: float = 0.5) -> torch.Tensor:
    """The union of the pasted masks in plain PyTorch: [H, W] uint8."""
    H, W = image_hw
    boxes = det["boxes"]
    dev = boxes.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    b = boxes[:, :, None, None]
    inside = (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3])
    hit = paste_ok(det, dynamic_only)[:, None, None] & inside & \
        (paste_values(det, image_hw) > mask_th)
    return hit.any(0).to(torch.uint8)


def class_mask_ok(classes: torch.Tensor, words=DYNAMIC_CLASS_WORDS) -> torch.Tensor:
    """[D] bool: class c in the 96-bit class mask `words`, the kernel's
    test (the plain mirror of torch.isin(classes, DYNAMIC_CLASS_IDS))."""
    c = classes.long()
    word = torch.tensor(words, dtype=torch.int64, device=c.device)[(c.clamp(0, 95) >> 5)]
    return (c >= 0) & (c < 96) & (((word >> (c & 31)) & 1) == 1)


def paste_tile_lists(det: dict, image_hw, dynamic_only: bool = True) -> torch.Tensor:
    """[tiles_y, tiles_x, D] bool: the kernel's per-tile list, the
    detections that paste and whose box meets the 32 x 32 tile (y2 above
    its first row, y1 at most its last, the same for columns). The plain
    mirror of the kernel's ballot; the kernel walks each list in order."""
    H, W = image_hw
    boxes = det["boxes"]
    dev = boxes.device
    ok = det["valid"]
    if dynamic_only:
        ok = ok & class_mask_ok(det["classes"])
    y0 = torch.arange(0, H, PASTE_TILE, dtype=torch.float32, device=dev)
    x0 = torch.arange(0, W, PASTE_TILE, dtype=torch.float32, device=dev)
    y1 = torch.clamp(y0 + PASTE_TILE, max=H) - 1
    x1 = torch.clamp(x0 + PASTE_TILE, max=W) - 1
    rows = (y1[:, None] >= boxes[None, :, 0]) & (y0[:, None] < boxes[None, :, 2])
    cols = (x1[:, None] >= boxes[None, :, 1]) & (x0[:, None] < boxes[None, :, 3])
    return rows[:, None, :] & cols[None, :, :] & ok[None, None, :]


def paste_masks_tiled_plain(det: dict, image_hw, dynamic_only: bool = True,
                            mask_th: float = 0.5) -> torch.Tensor:
    """The kernel's route in plain PyTorch: each tile pastes only the
    detections on its list (paste_tile_lists). Equal to paste_masks_plain
    wherever the lists hold every box that sets a pixel of their tile."""
    H, W = image_hw
    lists = paste_tile_lists(det, image_hw, dynamic_only)
    ty = torch.arange(H, device=lists.device) // PASTE_TILE
    tx = torch.arange(W, device=lists.device) // PASTE_TILE
    listed = lists[ty[:, None], tx[None, :]].permute(2, 0, 1)          # [D, H, W]
    boxes = det["boxes"]
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)[None, None, :]
    b = boxes[:, :, None, None]
    inside = (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3])
    hit = listed & inside & (paste_values(det, image_hw) > mask_th)
    return hit.any(0).to(torch.uint8)


def paste_masks(det: dict, image_hw, dynamic_only: bool = True,
                mask_th: float = 0.5) -> torch.Tensor:
    """GetDynSeg: det holds boxes [D, 4] f32 in output pixels, classes [D]
    int32, masks [D, 28, 28] f32, valid [D] bool. Returns [H, W] uint8, 1
    where a valid dynamic-class detection whose box holds the pixel has a
    bilinear mask value above mask_th. One launch on the card: the class
    test is in the kernel (a constant mask of the dynamic classes)."""
    name = "paste_masks"
    boxes, masks, classes, valid = det["boxes"], det["masks"], det["classes"], det["valid"]
    device = boxes.device
    if device.type == "cpu":
        return paste_masks_plain(det, image_hw, dynamic_only, mask_th)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    D = boxes.shape[0]
    H, W = image_hw
    if D > PASTE_MAX_D:
        raise ValueError(f"{name}: {D} detections, the kernel takes at most {PASTE_MAX_D}")
    cuda_build.check(name, "boxes", boxes, torch.float32, (D, 4), device)
    cuda_build.check(name, "masks", masks, torch.float32, (D, MASK, MASK), device)
    cuda_build.check(name, "classes", classes, torch.int32, (D,), device)
    cuda_build.check(name, "valid", valid, torch.bool, (D,), device)
    lib = _library(name)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{name}: boxes must be 16-byte aligned")
    out = torch.empty((H, W), dtype=torch.uint8, device=device)
    cuda_build.launch(name, device, lib.paste_masks_launch, boxes.data_ptr(),
                      classes.data_ptr(), valid.data_ptr(), masks.data_ptr(), D, H, W,
                      float(np.float32(mask_th)), *DYNAMIC_CLASS_WORDS, int(dynamic_only),
                      out.data_ptr())
    paste_masks.launches += 1
    return out


paste_masks.launches = 0

WRAPPERS = (nms_fixed, roi_align, roi_align_backward, paste_masks)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
