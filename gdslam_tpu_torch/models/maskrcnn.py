"""Mask R-CNN inference for semantic dynamic-object masking (port of
gdslam_tpu.models.maskrcnn).

ResNet50-FPN backbone, RPN with fixed-budget proposal selection, ROIAlign,
class/box/mask heads and the `GetDynSeg` postprocessing (the union of the
instance masks of the movable COCO classes, reference MaskRCNN.py:83-140).
The three detection stages that XLA fuses in the JAX package, `nms_fixed`,
`roi_align` and `paste_masks`, are hand-written CUDA kernels on the card
(`ops/detect_kernels.py`); everything else is plain PyTorch, with the
backbone in `torch.channels_last` so that P2..P5 already lie as [h * w, C]
rows for ROIAlign.

Module and parameter names follow the JAX package's flax auto-names
(`Bottleneck_3.Conv_1`, `Dense_0`, `ConvTranspose_0`), so a weight file of
`save_variables` (either package's) maps onto the modules leaf by leaf
(`maskrcnn_from_numpy`). Training and the Keras `.h5` route are not ported
(ROADMAP.md section 1, item 12).
"""

from __future__ import annotations

import json
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gdslam_tpu_torch.frontend.extractor import top_k_stable
from gdslam_tpu_torch.ops import detect_kernels as dk

NUM_CLASSES = 81  # COCO + background (reference coco.py:63-84)
DYNAMIC_CLASS_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe")
DYNAMIC_CLASS_IDS = dk.DYNAMIC_CLASS_IDS   # COCO ids 1-9 and 15-24
BBOX_STD = np.asarray([0.1, 0.1, 0.2, 0.2], np.float32)
MEAN_PIXEL = (123.7, 116.8, 103.9)         # matterport MEAN_PIXEL, no std scaling
BN_EPS = 1e-3

box_iou = dk.box_iou   # the JAX module's name; the detection stages live in ops/detect_kernels.py


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1, projection: bool = False):
        super().__init__()
        self.projection = projection
        self.Conv_0 = nn.Conv2d(cin, filters, 1, stride=strides, bias=False)
        self.BatchNorm_0 = _bn(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.BatchNorm_1 = _bn(filters)
        self.Conv_2 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.BatchNorm_2 = _bn(filters * 4)
        if projection:
            self.Conv_3 = nn.Conv2d(cin, filters * 4, 1, stride=strides, bias=False)
            self.BatchNorm_3 = _bn(filters * 4)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.projection else x
        return F.relu(y + residual)


class ResNetFPN(nn.Module):
    """ResNet50 C2-C5 + FPN P2-P6 (model.py resnet_graph + fpn)."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), fpn_dim: int = 256):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = _bn(64)
        k, cin = 0, 64
        for i, n_block in enumerate(blocks):
            filters = 64 * 2 ** i
            for b in range(n_block):
                setattr(self, f"Bottleneck_{k}", Bottleneck(
                    cin, filters, strides=(1 if i == 0 else 2) if b == 0 else 1,
                    projection=b == 0))
                k, cin = k + 1, filters * 4
        self.stage_ends = tuple(int(e) - 1 for e in np.cumsum(blocks))
        c = [256 * 2 ** i for i in range(4)]
        for j, cin in enumerate((c[3], c[2], c[1], c[0])):            # laterals c5..c2
            setattr(self, f"Conv_{j + 1}", nn.Conv2d(cin, fpn_dim, 1))
        for j in range(4):                                            # outputs p2..p5
            setattr(self, f"Conv_{j + 5}", nn.Conv2d(fpn_dim, fpn_dim, 3, padding=1))

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        cs = []
        for k in range(self.stage_ends[-1] + 1):
            x = getattr(self, f"Bottleneck_{k}")(x)
            if k in self.stage_ends:
                cs.append(x)
        c2, c3, c4, c5 = cs
        # jax.image.resize "nearest" samples at half-pixel centres: "nearest-exact"
        up = lambda p, c: F.interpolate(p, size=c.shape[-2:], mode="nearest-exact")
        p5 = self.Conv_1(c5)
        p4 = self.Conv_2(c4) + up(p5, c4)
        p3 = self.Conv_3(c3) + up(p4, c3)
        p2 = self.Conv_4(c2) + up(p3, c2)
        p2, p3, p4, p5 = self.Conv_5(p2), self.Conv_6(p3), self.Conv_7(p4), self.Conv_8(p5)
        return [p2, p3, p4, p5, p5[:, :, ::2, ::2]]    # p6: max_pool (1, 1), stride 2


class RPNHead(nn.Module):
    def __init__(self, fpn_dim: int = 256, anchors_per_loc: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(fpn_dim, 512, 3, padding=1)
        self.Conv_1 = nn.Conv2d(512, anchors_per_loc, 1)
        self.Conv_2 = nn.Conv2d(512, anchors_per_loc * 4, 1)

    def forward(self, feat):
        """Logits [B, h * w * A] and deltas [B, h * w * A, 4], location-major
        with the anchor innermost (the flax NHWC reshape)."""
        shared = F.relu(self.Conv_0(feat))
        B = feat.shape[0]
        logits = self.Conv_1(shared).permute(0, 2, 3, 1).reshape(B, -1)
        deltas = self.Conv_2(shared).permute(0, 2, 3, 1).reshape(B, -1, 4)
        return logits, deltas


class BoxHead(nn.Module):
    def __init__(self, roi: int = 7, fpn_dim: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(roi * roi * fpn_dim, 1024)
        self.Dense_1 = nn.Linear(1024, 1024)
        self.Dense_2 = nn.Linear(1024, NUM_CLASSES)
        self.Dense_3 = nn.Linear(1024, NUM_CLASSES * 4)

    def forward(self, rois):  # [R, 7, 7, C] channels last: flattened in (y, x, c) order
        x = rois.reshape(rois.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x), self.Dense_3(x).reshape(-1, NUM_CLASSES, 4)


class MaskHead(nn.Module):
    def __init__(self, fpn_dim: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"Conv_{i}", nn.Conv2d(fpn_dim if i == 0 else 256, 256, 3, padding=1))
        self.ConvTranspose_0 = nn.ConvTranspose2d(256, 256, 2, stride=2)
        self.Conv_4 = nn.Conv2d(256, NUM_CLASSES, 1)

    def forward(self, rois):  # [R, 14, 14, C] channels last -> [R, classes, 28, 28]
        x = rois.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = F.relu(self.ConvTranspose_0(x))
        return self.Conv_4(x)


# ----------------------------------------------------------------------------
# Anchors and boxes (utils.py equivalents)
# ----------------------------------------------------------------------------

def generate_anchors(image_hw: tuple, strides=(4, 8, 16, 32, 64),
                     scales=(32, 64, 128, 256, 512),
                     ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """[A, 4] anchors (y1, x1, y2, x2) over all FPN levels, location-major
    with `ratios` innermost, so anchors[i] pairs with the RPN's logits[i]."""
    H, W = image_hw
    out = []
    for stride, scale in zip(strides, scales):
        fh, fw = int(np.ceil(H / stride)), int(np.ceil(W / stride))
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        cy, cx = np.meshgrid(cy, cx, indexing="ij")
        per_ratio = []
        for r in ratios:
            h = scale / np.sqrt(r)
            w = scale * np.sqrt(r)
            per_ratio.append(np.stack([cy - h / 2, cx - w / 2,
                                       cy + h / 2, cx + w / 2], -1))
        out.append(np.stack(per_ratio, axis=2).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Standard (dy, dx, log dh, log dw) box regression."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    cy = boxes[:, 0] + 0.5 * h
    cx = boxes[:, 1] + 0.5 * w
    cy = cy + deltas[:, 0] * h
    cx = cx + deltas[:, 1] * w
    h = h * torch.exp(torch.clamp(deltas[:, 2], -4, 4))
    w = w * torch.exp(torch.clamp(deltas[:, 3], -4, 4))
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def _clip_boxes(b: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return torch.stack([b[:, 0].clamp(0, H), b[:, 1].clamp(0, W),
                        b[:, 2].clamp(0, H), b[:, 3].clamp(0, W)], -1)


# ----------------------------------------------------------------------------
# Full model
# ----------------------------------------------------------------------------

class MaskRCNN(nn.Module):
    def __init__(self, image_hw: tuple = (480, 640), pre_nms: int = 1024, post_nms: int = 128,
                 max_det: int = 32, blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.image_hw = tuple(image_hw)
        self.pre_nms, self.post_nms, self.max_det = pre_nms, post_nms, max_det
        self.blocks = tuple(blocks)
        self.backbone = ResNetFPN(blocks=blocks)
        self.rpn = RPNHead()
        self.box_head = BoxHead()
        self.mask_head = MaskHead()
        self.register_buffer("anchors", torch.from_numpy(generate_anchors(self.image_hw)),
                             persistent=False)
        self.register_buffer("mean_pixel", torch.tensor(MEAN_PIXEL, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("bbox_std", torch.from_numpy(BBOX_STD), persistent=False)

    def features(self, image: torch.Tensor) -> list:
        """P2..P6 of image [H, W, 3] f32 (0..255), channels last."""
        x = (image - self.mean_pixel).permute(2, 0, 1)[None]     # NCHW view, NHWC memory
        return self.backbone(x.contiguous(memory_format=torch.channels_last))

    def rpn_outputs(self, feats: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Objectness [A] and deltas [A, 4] over every level, anchor order."""
        outs = [self.rpn(f) for f in feats]
        return torch.cat([o[0][0] for o in outs]), torch.cat([o[1][0] for o in outs])

    def forward(self, image: torch.Tensor, score_th: float = 0.7) -> dict:
        """image [H, W, 3] f32 (0..255). Returns fixed-size detections:
        boxes [D, 4], classes [D] int32, scores [D], masks [D, 28, 28],
        valid [D] bool."""
        H, W = self.image_hw
        feats = self.features(image)
        logits, deltas = self.rpn_outputs(feats)

        # proposals: top pre_nms by objectness -> decode -> NMS -> post_nms
        top_s, top_i = top_k_stable(logits, self.pre_nms)
        props = _clip_boxes(apply_deltas(self.anchors[top_i], deltas[top_i] * self.bbox_std),
                            H, W)
        keep = dk.nms_fixed(props, top_s.contiguous(), 0.7, self.post_nms)
        rois = props[keep.clamp(min=0)]
        roi_valid = keep >= 0

        # box head
        flat, shapes = dk.flatten_levels(feats)
        cls_logits, box_deltas = self.box_head(dk.roi_align(flat, shapes, rois, 7))
        probs = torch.softmax(cls_logits, dim=-1)[:, 1:]
        cls = torch.argmax(probs, dim=-1)                              # the first maximum
        score = probs.gather(1, cls[:, None])[:, 0] * roi_valid
        cls = cls + 1
        d = box_deltas.gather(1, cls[:, None, None].expand(-1, 1, 4))[:, 0]
        boxes = _clip_boxes(apply_deltas(rois, d * self.bbox_std), H, W)
        score = torch.where(score >= score_th, score, 0.0)
        det_keep = dk.nms_fixed(boxes, torch.where(score > 0, score, -torch.inf), 0.3,
                                self.max_det)
        det_rows = det_keep.clamp(min=0).long()
        det_valid = (det_keep >= 0) & (score[det_rows] > 0)
        det_boxes = boxes[det_rows]
        det_cls = cls[det_rows]

        # mask head on the final detections (the class channel, then sigmoid)
        logits_m = self.mask_head(dk.roi_align(flat, shapes, det_boxes, 14))
        det_masks = torch.sigmoid(logits_m[torch.arange(det_cls.shape[0], device=det_cls.device),
                                           det_cls]).contiguous()
        return {"boxes": det_boxes, "classes": det_cls.to(torch.int32),
                "scores": score[det_rows] * det_valid, "masks": det_masks, "valid": det_valid}


# ----------------------------------------------------------------------------
# Weights: the npz layout of save_variables, flax names and layouts
# ----------------------------------------------------------------------------

def _flax_key(torch_key: str) -> str:
    """The flax variable path of a torch state-dict key."""
    *scope, leaf = torch_key.split(".")
    path = "/".join(scope)
    if leaf == "running_mean":
        return f"batch_stats/{path}/mean"
    if leaf == "running_var":
        return f"batch_stats/{path}/var"
    is_bn = scope[-1].startswith("BatchNorm")
    name = {"weight": "scale" if is_bn else "kernel", "bias": "bias"}[leaf]
    return f"params/{path}/{name}"


def _to_torch_layout(module: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    """A flax leaf in the torch module's layout."""
    if leaf != "weight":
        return a
    if isinstance(module, nn.ConvTranspose2d):
        # flax ConvTranspose is a fractionally strided forward conv with a
        # [kh, kw, in, out] kernel: torch's [in, out, kh, kw], flipped
        return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
    if isinstance(module, nn.Conv2d):
        return a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
    if isinstance(module, nn.Linear):
        return a.T                                  # [in, out] -> [out, in]
    return a                                        # BatchNorm scale


def _from_torch_layout(module: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return a
    if isinstance(module, nn.ConvTranspose2d):
        return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
    if isinstance(module, nn.Conv2d):
        return a.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Linear):
        return a.T
    return a


def _leaves(model: nn.Module):
    """(state-dict key, owning module, leaf name) of every weight and BN
    statistic, in state-dict order."""
    modules = dict(model.named_modules())
    for key in model.state_dict():
        scope, leaf = key.rsplit(".", 1)
        if leaf != "num_batches_tracked":
            yield key, modules[scope], leaf


def maskrcnn_from_numpy(flat: dict, image_hw=(480, 640), blocks=(3, 4, 6, 3),
                        device="cuda", **kw) -> MaskRCNN:
    """A MaskRCNN in eval mode on `device` (channels last) holding the
    variables `flat` ({flax path: array}, as load_variables returns them)."""
    model = MaskRCNN(image_hw=image_hw, blocks=blocks, **kw)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    state = {}
    for key, module, leaf in _leaves(model):
        path = _flax_key(key)
        a = np.asarray(flat[path], np.float32)
        t = torch.from_numpy(np.array(_to_torch_layout(module, leaf, a), np.float32, order="C"))
        want = shapes[key]
        if t.shape != want:
            raise ValueError(f"{path}: shape {tuple(t.shape)} does not fit {key} {tuple(want)}")
        state[key] = t
    used = {_flax_key(k) for k, _, _ in _leaves(model)}
    extra = sorted(set(flat) - used - {"__meta__"})
    if extra:
        raise ValueError(f"variables not in a blocks={tuple(blocks)} model: {extra[:4]}")
    model.load_state_dict(state, strict=False)
    return model.eval().to(device=device, memory_format=torch.channels_last)


def variables_to_numpy(model: MaskRCNN) -> dict:
    """{flax path: array} of a model (the inverse of maskrcnn_from_numpy)."""
    state = model.state_dict()
    return {_flax_key(k): _from_torch_layout(m, leaf, state[k].detach().cpu().numpy())
            for k, m, leaf in _leaves(model)}


def init_variables(blocks=(3, 4, 6, 3), seed: int = 0) -> dict:
    """Seeded random variables {flax path: array} (numpy): kernels drawn as
    flax's lecun_normal (a normal truncated at 2 sigma, variance 1 / fan_in),
    biases 0, BatchNorm scale 1, bias 0, mean 0, var 1. Not flax's numbers:
    the same distribution, for runs that need weights of the right shapes."""
    rng = np.random.default_rng(seed)
    model = MaskRCNN(image_hw=(64, 64), blocks=blocks)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for key, module, leaf in _leaves(model):
        path = _flax_key(key)
        shape = shapes[key]
        if leaf == "weight" and not isinstance(module, nn.BatchNorm2d):
            flax_shape = _from_torch_layout(module, leaf, np.empty(shape, np.float32)).shape
            fan_in = int(np.prod(flax_shape[:-1]))
            z = rng.standard_normal(flax_shape).astype(np.float32)
            while (far := np.abs(z) > 2).any():               # truncated, not clipped
                z[far] = rng.standard_normal(int(far.sum()))
            out[path] = z * np.float32(1 / np.sqrt(fan_in) / 0.87962566)
        elif leaf in ("weight", "running_var"):
            out[path] = np.ones(shape, np.float32)
        else:
            out[path] = np.zeros(shape, np.float32)
    return out


def save_variables(flat: dict, path: str, meta: dict | None = None) -> None:
    """Write {flax path: array} as the JAX package's save_variables does:
    one compressed npz keyed by path, the model shape in `__meta__`."""
    out = {k: np.asarray(v) for k, v in flat.items()}
    if meta:
        out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_variables(path: str) -> dict:
    """{flax path: array} of a save_variables npz (either package's)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def load_meta(path: str) -> dict:
    """The meta dict stored by save_variables ({} if absent)."""
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


# ----------------------------------------------------------------------------
# The segmenter callable
# ----------------------------------------------------------------------------

def default_infer_hw(image_hw) -> tuple:
    """Large inputs (>= 384 rows) are molded to half resolution."""
    return (image_hw[0] // 2, image_hw[1] // 2) if image_hw[0] >= 384 else tuple(image_hw)


def mold(rgb: torch.Tensor, infer_hw) -> torch.Tensor:
    """An [H, W, 3] image as f32 at the inference size: the antialiased
    bilinear resize of jax.image.resize when the sizes differ."""
    im = rgb.to(torch.float32)
    if tuple(im.shape[:2]) == tuple(infer_hw):
        return im
    return F.interpolate(im.permute(2, 0, 1)[None], size=tuple(infer_hw), mode="bilinear",
                         align_corners=False, antialias=True)[0].permute(1, 2, 0)


class TorchSegmenter:
    """Callable segmenter for masking.masknet.SegmentDynObject (port of
    FlaxSegmenter): uint8 RGB [H, W, 3] in, float32 [H, W] out (1 =
    dynamic).

    infer_hw: the inference resolution; inputs are molded to it with an
    antialiased bilinear resize (as jax.image.resize), detection boxes are
    rescaled to the output frame and the 28 x 28 masks pasted at full output
    resolution. The weights are the module's tensors on `device`."""

    def __init__(self, variables: dict | None = None, image_hw=(480, 640), seed: int = 0,
                 infer_hw: tuple | None = None, blocks: tuple = (3, 4, 6, 3),
                 device="cuda"):
        self.image_hw = tuple(image_hw)
        self.infer_hw = default_infer_hw(image_hw) if infer_hw is None else tuple(infer_hw)
        if variables is None:
            variables = init_variables(blocks, seed)
        self.device = torch.device(device)
        self.model = maskrcnn_from_numpy(variables, self.infer_hw, tuple(blocks), self.device)
        sy = self.image_hw[0] / self.infer_hw[0]
        sx = self.image_hw[1] / self.infer_hw[1]
        self._scale = torch.tensor([sy, sx, sy, sx], dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def detect(self, rgb: torch.Tensor, score_th: float = 0.7) -> dict:
        """The detections of an [H, W, 3] image tensor on the device, boxes
        in its pixels."""
        im = mold(rgb, self.infer_hw)
        # cuDNN's deterministic algorithms: the transposed conv runs as a
        # convolution's backward-data, whose default algorithm sums by atomics
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            det = self.model(im.contiguous(), score_th)
        return {**det, "boxes": det["boxes"] * self._scale}

    def segment(self, rgb: torch.Tensor, score_th: float = 0.7) -> torch.Tensor:
        """[H, W] uint8 mask of an [H, W, 3] image tensor on the device."""
        return dk.paste_masks(self.detect(rgb, score_th), self.image_hw)

    def __call__(self, rgb) -> np.ndarray:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        t = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        return self.segment(t).cpu().numpy().astype(np.float32)


def build_segmenter(spec: str, image_hw=(480, 640), device="cuda") -> TorchSegmenter:
    """A live segmenter from a CLI spec (`--segmenter` of cli/rgbd_tum and
    cli/evaluate; the reference's always-on MaskNet, MaskNet.cc:30-49):

      'flax'            seeded random weights (architecture smoke only; warns)
      'flax:W.npz'      variables of save_variables (either package's), with
                        the model shape from its meta
      'flax:W.h5'       the reference's Keras weights: not ported (raises)
    """
    if not spec.startswith("flax"):
        raise ValueError(f"unknown segmenter spec '{spec}'")
    weights = spec.split(":", 1)[1] if ":" in spec else None
    variables, infer_hw, blocks = None, None, (3, 4, 6, 3)
    if weights:
        if weights.endswith(".h5"):
            raise NotImplementedError(
                "--segmenter flax:W.h5: converting the reference's Keras mask_rcnn_coco.h5 is "
                "not ported to gdslam_tpu_torch yet; see ROADMAP.md section 1, item 12 (a "
                "save_variables .npz works)")
        variables = load_variables(weights)
        meta = load_meta(weights)
        blocks = tuple(meta.get("blocks", blocks))
        if "infer_hw" in meta:
            infer_hw = tuple(meta["infer_hw"])
    else:
        warnings.warn("--segmenter flax without weights: the net is "
                      "randomly initialized and its masks are meaningless; "
                      "pass flax:weights.npz")
    return TorchSegmenter(variables, image_hw=image_hw, infer_hw=infer_hw, blocks=blocks,
                          device=device)
