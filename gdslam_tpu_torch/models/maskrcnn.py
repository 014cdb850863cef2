"""Mask R-CNN for semantic dynamic-object masking: inference and training
(port of gdslam_tpu.models.maskrcnn).

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
(`maskrcnn_from_numpy`).

Training follows the JAX module: `train_losses` (teacher-forced heads) and
`train_losses_sampled` (heads on sampled RPN proposals), the frozen-BN
calibration `calibrate_batch_stats`, and the fits `train_toy` (clipped Adam)
and `train_sampled` (clipped SGD with momentum), with optax's update rules
written out. The model trains in eval mode: the BatchNorm statistics stay
frozen, their scale and bias train, as flax trains them. ROIAlign's gradient
is a CUDA kernel (`detect_kernels.roi_align_backward`); the rest of the
backward is PyTorch's. The reference's Keras weights (`mask_rcnn_coco.h5`)
convert to the same {flax path: array} form (`convert_keras_h5`, numpy and
h5py, imported only there).
"""

from __future__ import annotations

import functools
import json
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gdslam_tpu_torch.backend.map_arena import last_writer, scatter_rows
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


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor, stats: dict | None) -> torch.Tensor:
    """bn(x) with its running statistics, or, with a `stats` dict, flax's
    batch-statistics mode (use_running_average=False): the batch's mean and
    variance E[x^2] - E[x]^2 (biased, clipped at 0) normalise x as
    (x - mean) * (rsqrt(var + eps) * scale) + bias and are recorded in
    stats[bn]."""
    if stats is None:
        return bn(x)
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0)
    stats[bn] = (mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


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

    def forward(self, x, stats: dict | None = None):
        y = F.relu(_norm(self.BatchNorm_0, self.Conv_0(x), stats))
        y = F.relu(_norm(self.BatchNorm_1, self.Conv_1(y), stats))
        y = _norm(self.BatchNorm_2, self.Conv_2(y), stats)
        residual = _norm(self.BatchNorm_3, self.Conv_3(x), stats) if self.projection else x
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

    def forward(self, x, stats: dict | None = None):
        """P2..P6; with a `stats` dict, in batch-statistics mode (`_norm`)."""
        x = F.relu(_norm(self.BatchNorm_0, self.Conv_0(x), stats))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        cs = []
        for k in range(self.stage_ends[-1] + 1):
            x = getattr(self, f"Bottleneck_{k}")(x, stats)
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
# Training targets and loss pieces
# ----------------------------------------------------------------------------

def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (the JAX module's optax_sigmoid_bce)."""
    return torch.maximum(logits, torch.zeros_like(logits)) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a < delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def box_deltas_inverse(boxes: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(dy, dx, log dh, log dw) that move `boxes` onto `targets`."""
    h = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-3)
    w = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-3)
    th = torch.clamp(targets[:, 2] - targets[:, 0], min=1e-3)
    tw = torch.clamp(targets[:, 3] - targets[:, 1], min=1e-3)
    cy = boxes[:, 0] + 0.5 * h
    cx = boxes[:, 1] + 0.5 * w
    tcy = targets[:, 0] + 0.5 * th
    tcx = targets[:, 1] + 0.5 * tw
    return torch.stack([(tcy - cy) / h, (tcx - cx) / w, torch.log(th / h), torch.log(tw / w)], -1)


def crop_mask(mask: torch.Tensor, box: torch.Tensor, out: int) -> torch.Tensor:
    """Bilinear crop of a full-image mask [H, W] to each box ([..., 4]),
    resampled to [..., out, out] (the minimask of utils.py): sample rows at
    box y1 + (k + 0.5) / out * height - 0.5, floored, the floor clipped to
    [0, H - 2] and the fraction to [0, 1]; the same for columns."""
    H, W = mask.shape
    k = (torch.arange(out, dtype=torch.float32, device=mask.device) + 0.5) / out
    ys = box[..., 0, None] + k * (box[..., 2, None] - box[..., 0, None]) - 0.5
    xs = box[..., 1, None] + k * (box[..., 3, None] - box[..., 1, None]) - 0.5
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 2)
    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 2)
    fy = torch.clamp(ys - y0, 0, 1)[..., :, None]
    fx = torch.clamp(xs - x0, 0, 1)[..., None, :]
    m = mask.to(torch.float32)

    def tap(yi, xi):
        return m[yi[..., :, None], xi[..., None, :]]

    return (tap(y0, x0) * (1 - fy) * (1 - fx) + tap(y0, x0 + 1) * (1 - fy) * fx
            + tap(y0 + 1, x0) * fy * (1 - fx) + tap(y0 + 1, x0 + 1) * fy * fx)


@functools.lru_cache(maxsize=None)
def _bbox_std(device) -> torch.Tensor:
    return torch.from_numpy(BBOX_STD).to(device)


def detection_targets(proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
                      n_rois: int = 64, pos_ratio: float = 0.33):
    """Static-shape detection_targets_graph (model.py:451-560), selected by
    top-k instead of at random: positives by match IoU (>= 0.5), then the
    negatives half hard (the highest IoU below 0.5) and half easy (the
    lowest). Ties keep the lower index (lax.top_k's order). Returns (rois
    [n, 4], roi_cls [n] int64, box_tgt [n, 4] BBOX_STD-normalised, is_pos
    [n] bool, roi_valid [n] bool, matched_gt [n])."""
    iou = box_iou(proposals, gt_boxes) * gt_valid[None, :]
    iou = torch.where(prop_valid[:, None], iou, 0.0)
    best_iou, best_gt = iou.amax(1), iou.argmax(1)
    pos = (best_iou >= 0.5) & prop_valid
    neg = (best_iou < 0.5) & prop_valid
    P = proposals.shape[0]
    n_pos = min(max(1, int(round(n_rois * pos_ratio))), P)
    n_neg = min(n_rois - n_pos, P)
    pv, pi = top_k_stable(torch.where(pos, best_iou, -1.0), n_pos)
    pos_ok = pv >= 0.5
    n_hard = n_neg // 2
    hv, hi = top_k_stable(torch.where(neg, best_iou, -1.0), n_hard)
    hard_ok = hv >= 0.0
    taken = torch.zeros(P, dtype=torch.bool, device=proposals.device).index_put((hi,), hard_ok)
    ev, ei = top_k_stable(torch.where(neg & ~taken, -best_iou, -2.0), n_neg - n_hard)
    easy_ok = ev >= -1.0
    idx = torch.cat([pi, hi, ei])
    roi_valid = torch.cat([pos_ok, hard_ok, easy_ok])
    is_pos = torch.cat([pos_ok, torch.zeros(n_neg, dtype=torch.bool, device=pos_ok.device)])
    rois = proposals[idx]
    matched_gt = best_gt[idx]
    roi_cls = torch.where(is_pos, gt_classes[matched_gt].long(), 0)
    box_tgt = box_deltas_inverse(rois, gt_boxes[matched_gt]) / _bbox_std(rois.device)
    box_tgt = torch.where(is_pos[:, None], box_tgt, 0.0)
    return rois, roi_cls, box_tgt, is_pos, roi_valid, matched_gt


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

    def features(self, image: torch.Tensor, stats: dict | None = None) -> list:
        """P2..P6 of image [H, W, 3] f32 (0..255), channels last."""
        x = (image - self.mean_pixel).permute(2, 0, 1)[None]     # NCHW view, NHWC memory
        return self.backbone(x.contiguous(memory_format=torch.channels_last), stats)

    def backbone_stats(self, image: torch.Tensor) -> dict:
        """One backbone pass in batch-statistics mode, every layer normalised
        by its own batch statistics (as calibrate_batch_stats runs it).
        Returns {BatchNorm module: (mean, var)}."""
        stats: dict = {}
        self.features(image, stats)
        return stats

    def rpn_outputs(self, feats: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Objectness [A] and deltas [A, 4] over every level, anchor order."""
        outs = [self.rpn(f) for f in feats]
        return torch.cat([o[0][0] for o in outs]), torch.cat([o[1][0] for o in outs])

    def proposals(self, logits: torch.Tensor, deltas: torch.Tensor):
        """ProposalLayer: the top pre_nms anchors by objectness, decoded and
        clipped, then NMS at 0.7 down to post_nms. Returns (rois [post_nms, 4],
        valid [post_nms] bool)."""
        H, W = self.image_hw
        top_s, top_i = top_k_stable(logits, self.pre_nms)
        props = _clip_boxes(apply_deltas(self.anchors[top_i], deltas[top_i] * self.bbox_std),
                            H, W)
        keep = dk.nms_fixed(props, top_s.contiguous(), 0.7, self.post_nms)
        return props[keep.clamp(min=0)], keep >= 0

    def forward(self, image: torch.Tensor, score_th: float = 0.7) -> dict:
        """image [H, W, 3] f32 (0..255). Returns fixed-size detections:
        boxes [D, 4], classes [D] int32, scores [D], masks [D, 28, 28],
        valid [D] bool."""
        H, W = self.image_hw
        feats = self.features(image)
        rois, roi_valid = self.proposals(*self.rpn_outputs(feats))

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

    # ------------------------------------------------------------------
    # Training losses (model.py's rpn_*_loss and mrcnn_*_loss graphs)
    # ------------------------------------------------------------------

    def _rpn_losses(self, logits, deltas, gt_boxes, gt_valid):
        """RPN objectness and box losses towards IoU-matched anchors: positive
        above 0.5 (and every valid gt's best anchor), negative below 0.3."""
        A = self.anchors.shape[0]
        iou = box_iou(self.anchors, gt_boxes) * gt_valid[None, :]
        best_iou, best_gt = iou.amax(1), iou.argmax(1)       # argmax: the first maximum
        pos = best_iou > 0.5
        # every gt's single best anchor is positive even below the threshold;
        # two gts with one best anchor write it twice, and the last write
        # stands, as in XLA's scatter
        top = iou.argmax(0)
        pos = scatter_rows(pos, top, pos[top] | gt_valid, last_writer(top, gt_valid, A))
        neg = best_iou < 0.3
        bce = sigmoid_bce(logits, pos.to(logits.dtype))
        n_pos = torch.clamp(pos.sum(), min=1)
        rpn_cls = torch.where(pos, bce, 0).sum() / n_pos + \
            torch.where(neg, bce, 0).sum() / torch.clamp(neg.sum(), min=1)
        tgt = box_deltas_inverse(self.anchors, gt_boxes[best_gt]) / self.bbox_std
        rpn_box = torch.where(pos[:, None], huber(deltas - tgt), 0).sum() / n_pos
        return rpn_cls, rpn_box

    def train_losses(self, image, gt_boxes, gt_classes, gt_mask, gt_valid) -> torch.Tensor:
        """The total training loss with the heads teacher-forced on the gt
        boxes, plus background ROIs for the class head (the full image, two
        quadrants and the gt boxes shifted down by 1.5 heights, each kept if
        its IoU with every gt is below 0.3). image [H, W, 3] f32, gt_boxes
        [G, 4] (y1, x1, y2, x2), gt_classes [G], gt_mask [H, W], gt_valid [G]
        bool."""
        H, W = self.image_hw
        feats = self.features(image)
        rpn_cls, rpn_box = self._rpn_losses(*self.rpn_outputs(feats), gt_boxes, gt_valid)
        G = gt_boxes.shape[0]
        f32 = dict(dtype=torch.float32, device=gt_boxes.device)
        h = gt_boxes[:, 2] - gt_boxes[:, 0]
        shift = torch.stack([h, torch.zeros_like(h), h, torch.zeros_like(h)], -1) * 1.5
        fixed = torch.tensor([[0.0, 0.0, H, W], [0.0, 0.0, H / 2, W / 2], [H / 2, W / 2, H, W]],
                             **f32)
        lim = torch.tensor([H, W, H, W], **f32)
        neg_boxes = torch.cat([fixed, torch.minimum(torch.clamp(gt_boxes + shift, min=0.0), lim)])
        neg_valid = (box_iou(neg_boxes, gt_boxes) * gt_valid[None, :]).amax(1) < 0.3
        roi_boxes = torch.cat([gt_boxes, neg_boxes])
        roi_classes = torch.cat([gt_classes, gt_classes.new_zeros(neg_boxes.shape[0])]).long()
        roi_valid = torch.cat([gt_valid, neg_valid])
        flat, shapes = dk.flatten_levels(feats)
        cls_logits, box_d_all = self.box_head(dk.roi_align(flat, shapes, roi_boxes, 7))
        R = roi_boxes.shape[0]
        ce = -torch.log_softmax(cls_logits, -1)[torch.arange(R, device=roi_boxes.device),
                                                roi_classes]
        head_cls = torch.where(roi_valid, ce, 0).sum() / torch.clamp(roi_valid.sum(), min=1)
        cls = gt_classes.long()
        rows = torch.arange(G, device=gt_boxes.device)
        # with the gt boxes as ROIs the target deltas are zero
        d_sel = box_d_all[:G][rows, cls]
        head_box = torch.where(gt_valid[:, None], huber(d_sel), 0).sum() / \
            torch.clamp(gt_valid.sum() * 4, min=1)
        m_sel = self.mask_head(dk.roi_align(flat, shapes, gt_boxes, 14))[rows, cls]
        mbce = sigmoid_bce(m_sel, crop_mask(gt_mask, gt_boxes, 28))
        head_mask = torch.where(gt_valid[:, None, None], mbce, 0).sum() / \
            torch.clamp(gt_valid.sum() * 28 * 28, min=1)
        return rpn_cls + rpn_box + head_cls + head_box + head_mask

    def train_losses_sampled(self, image, gt_boxes, gt_classes, gt_mask, gt_valid,
                             n_rois: int = 64, pos_ratio: float = 0.33) -> dict:
        """The reference's full training graph: the RPN losses of
        train_losses plus the heads on RPN proposals sampled at a fixed
        positive ratio (ProposalLayer + detection_targets). The proposals are
        training data, not a differentiable path: they are computed without
        gradient (the JAX stop_gradient). Returns the named losses: total,
        rpn_class, rpn_box, head_class, head_box, head_mask, n_pos_rois."""
        feats = self.features(image)
        logits, deltas = self.rpn_outputs(feats)
        rpn_cls, rpn_box = self._rpn_losses(logits, deltas, gt_boxes, gt_valid)
        with torch.no_grad():
            proposals, prop_valid = self.proposals(logits.detach(), deltas.detach())
        rois, roi_cls, box_tgt, is_pos, roi_valid, _ = detection_targets(
            proposals, prop_valid, gt_boxes, gt_classes, gt_valid, n_rois=n_rois,
            pos_ratio=pos_ratio)
        flat, shapes = dk.flatten_levels(feats)
        cls_logits, box_d_all = self.box_head(dk.roi_align(flat, shapes, rois, 7))
        rows = torch.arange(rois.shape[0], device=rois.device)
        ce = -torch.log_softmax(cls_logits, -1)[rows, roi_cls]
        head_cls = torch.where(roi_valid, ce, 0).sum() / torch.clamp(roi_valid.sum(), min=1)
        head_box = torch.where(is_pos[:, None], huber(box_d_all[rows, roi_cls] - box_tgt),
                               0).sum() / torch.clamp(is_pos.sum() * 4, min=1)
        m_sel = self.mask_head(dk.roi_align(flat, shapes, rois, 14))[rows, roi_cls]
        mbce = sigmoid_bce(m_sel, crop_mask(gt_mask, rois, 28))
        head_mask = torch.where(is_pos[:, None, None], mbce, 0).sum() / \
            torch.clamp(is_pos.sum() * 28 * 28, min=1)
        total = rpn_cls + rpn_box + head_cls + head_box + head_mask
        return {"total": total, "rpn_class": rpn_cls, "rpn_box": rpn_box,
                "head_class": head_cls, "head_box": head_box, "head_mask": head_mask,
                "n_pos_rois": is_pos.sum().to(torch.float32)}


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


def set_variables(model: MaskRCNN, flat: dict) -> MaskRCNN:
    """Load the variables `flat` ({flax path: array}, as load_variables
    returns them) into `model`, in place."""
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
        raise ValueError(f"variables not in a blocks={model.blocks} model: {extra[:4]}")
    model.load_state_dict(state, strict=False)
    return model


def maskrcnn_from_numpy(flat: dict, image_hw=(480, 640), blocks=(3, 4, 6, 3),
                        device="cuda", **kw) -> MaskRCNN:
    """A MaskRCNN in eval mode on `device` (channels last) holding the
    variables `flat` ({flax path: array}, as load_variables returns them)."""
    model = set_variables(MaskRCNN(image_hw=image_hw, blocks=blocks, **kw), flat)
    return model.eval().to(device=device, memory_format=torch.channels_last)


def variables_to_numpy(model: MaskRCNN) -> dict:
    """{flax path: array} of a model (the inverse of maskrcnn_from_numpy),
    copies that later training of the model leaves as they are."""
    state = model.state_dict()
    return {_flax_key(k): np.array(_from_torch_layout(m, leaf, state[k].detach().cpu().numpy()))
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
# Keras h5 weights (the reference's mask_rcnn_coco.h5, matterport layout)
# ----------------------------------------------------------------------------

# ResNet50 stage layout: (stage number, block letters) -> Bottleneck_i order.
_RESNET_STAGES = ((2, "abc"), (3, "abcd"), (4, "abcdef"), (5, "abc"))


def _h5_weight(f, layer: str, suffix: str) -> np.ndarray:
    """A weight array of a Keras-format h5: the group `layer` holds datasets
    whose names end with `<suffix>:0`, possibly nested one level (e.g.
    f['conv1']['conv1']['kernel:0']). A layer of a Keras sub-model is saved
    inside the sub-model's group (matterport's f['rpn_model']
    ['rpn_conv_shared']['kernel:0']); it is found there when it is not at
    the top."""

    def search(group):
        for k in group:
            item = group[k]
            if hasattr(item, "shape"):
                if k.endswith(suffix + ":0") or k == suffix:
                    return np.asarray(item)
            elif (hit := search(item)) is not None:
                return hit
        return None

    if layer in f:
        group = f[layer]
    else:
        group = next((f[g][layer] for g in f if not hasattr(f[g], "shape") and layer in f[g]),
                     None)
        if group is None:
            raise KeyError(f"h5 layer '{layer}' not found")
    got = search(group)
    if got is None:
        raise KeyError(f"weight '{suffix}:0' not found under layer '{layer}'")
    return got


def _fold_bn(f, bn_layer: str, conv_bias=None):
    """Keras BN weights -> (scale, bias, mean, var); a preceding conv bias is
    folded into the running mean (the model's convs have no bias)."""
    gamma = _h5_weight(f, bn_layer, "gamma")
    beta = _h5_weight(f, bn_layer, "beta")
    mean = _h5_weight(f, bn_layer, "moving_mean")
    var = _h5_weight(f, bn_layer, "moving_variance")
    if conv_bias is not None:
        mean = mean - conv_bias
    return gamma, beta, mean, var


def _fold_bn_into_dense(kernel, bias, f, bn_layer: str, eps: float = 1e-3):
    """Inference-mode BN folded into the dense or conv weights before it:
    y = gamma * (W x + b - mean) / sqrt(var + eps) + beta = W' x + b'."""
    gamma, beta, mean, var = _fold_bn(f, bn_layer)
    s = gamma / np.sqrt(var + eps)
    return kernel * s, (bias - mean) * s + beta


def convert_keras_h5(h5_path: str, image_hw=(480, 640)) -> dict:
    """The reference's `mask_rcnn_coco.h5` (matterport Keras layout, which
    MaskRCNN.py:15-61 loads by name) as {flax path: array}, the variables
    maskrcnn_from_numpy maps onto a MaskRCNN() of the default shape (the
    ResNet50 backbone). Every leaf comes from the file; its shape is held
    to the model's.

    Layout: conv1 / bn_conv1 stem; res{S}{b}_branch{1,2a,2b,2c} and their bn
    layers (conv biases folded into the BN means); fpn_c{2..5}p{2..5} and
    fpn_p{2..5}; rpn_model (rpn_conv_shared, rpn_class_raw with 2 logits an
    anchor folded to 1 as fg - bg, rpn_bbox_pred); mrcnn_class_conv1/2 with
    their BN folded into the dense weights (eps 1e-3), mrcnn_class_logits,
    mrcnn_bbox_fc; mrcnn_mask_conv1..4 with BN folded, mrcnn_mask_deconv
    (Keras [kh, kw, out, in] with scatter semantics: flipped on both spatial
    axes and swapped to flax's [kh, kw, in, out]) and mrcnn_mask."""
    import h5py  # only needed when a Keras weight file is given

    tmpl = variables_to_numpy(MaskRCNN(image_hw=image_hw))
    out = {}

    def put(path: str, a) -> None:
        a = np.asarray(a, np.float32)
        if a.shape != tmpl[path].shape:
            raise ValueError(f"{path}: the h5 gives {a.shape}, the model wants "
                             f"{tmpl[path].shape}")
        out[path] = a

    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def conv_bn(scope: str, conv_key: str, bn_key: str, conv_layer: str, bn_layer: str):
            try:
                b = _h5_weight(root, conv_layer, "bias")
            except KeyError:
                b = None
            put(f"params/{scope}/{conv_key}/kernel", _h5_weight(root, conv_layer, "kernel"))
            g, beta, mean, var = _fold_bn(root, bn_layer, conv_bias=b)
            put(f"params/{scope}/{bn_key}/scale", g)
            put(f"params/{scope}/{bn_key}/bias", beta)
            put(f"batch_stats/{scope}/{bn_key}/mean", mean)
            put(f"batch_stats/{scope}/{bn_key}/var", var)

        def conv(scope: str, key: str, layer: str, deconv: bool = False):
            k = _h5_weight(root, layer, "kernel").astype(np.float32)
            if deconv:
                # Keras Conv2DTranspose is the scatter form; the model's
                # transposed conv is flax's fractionally strided forward conv
                k = np.transpose(k[::-1, ::-1], (0, 1, 3, 2))
            put(f"params/{scope}/{key}/kernel", k)
            put(f"params/{scope}/{key}/bias", _h5_weight(root, layer, "bias"))

        conv_bn("backbone", "Conv_0", "BatchNorm_0", "conv1", "bn_conv1")
        blk = 0
        for stage, letters in _RESNET_STAGES:
            for j, letter in enumerate(letters):
                name, scope = f"{stage}{letter}", f"backbone/Bottleneck_{blk}"
                for ci, branch in enumerate(("2a", "2b", "2c")):
                    conv_bn(scope, f"Conv_{ci}", f"BatchNorm_{ci}", f"res{name}_branch{branch}",
                            f"bn{name}_branch{branch}")
                if j == 0:      # the projection shortcut
                    conv_bn(scope, "Conv_3", "BatchNorm_3", f"res{name}_branch1",
                            f"bn{name}_branch1")
                blk += 1
        # FPN lateral 1x1 then output 3x3 convs, in the model's call order
        for key, layer in (("Conv_1", "fpn_c5p5"), ("Conv_2", "fpn_c4p4"),
                           ("Conv_3", "fpn_c3p3"), ("Conv_4", "fpn_c2p2"),
                           ("Conv_5", "fpn_p2"), ("Conv_6", "fpn_p3"),
                           ("Conv_7", "fpn_p4"), ("Conv_8", "fpn_p5")):
            conv("backbone", key, layer)

        conv("rpn", "Conv_0", "rpn_conv_shared")
        kc = _h5_weight(root, "rpn_class_raw", "kernel").astype(np.float32)
        bc = _h5_weight(root, "rpn_class_raw", "bias").astype(np.float32)
        put("params/rpn/Conv_1/kernel", kc[..., 1::2] - kc[..., 0::2])
        put("params/rpn/Conv_1/bias", bc[1::2] - bc[0::2])
        conv("rpn", "Conv_2", "rpn_bbox_pred")

        # box head: matterport's 7x7-valid and 1x1 convs are dense layers over
        # the flattened ROI, their BN folded in
        for i in (1, 2):
            k = _h5_weight(root, f"mrcnn_class_conv{i}", "kernel").astype(np.float32)
            b = _h5_weight(root, f"mrcnn_class_conv{i}", "bias").astype(np.float32)
            k, b = _fold_bn_into_dense(k.reshape(-1, k.shape[-1]), b, root, f"mrcnn_class_bn{i}")
            put(f"params/box_head/Dense_{i - 1}/kernel", k)
            put(f"params/box_head/Dense_{i - 1}/bias", b)
        for key, layer in (("Dense_2", "mrcnn_class_logits"), ("Dense_3", "mrcnn_bbox_fc")):
            conv("box_head", key, layer)

        for i in range(4):
            k = _h5_weight(root, f"mrcnn_mask_conv{i + 1}", "kernel").astype(np.float32)
            b = _h5_weight(root, f"mrcnn_mask_conv{i + 1}", "bias").astype(np.float32)
            k, b = _fold_bn_into_dense(k, b, root, f"mrcnn_mask_bn{i + 1}")
            put(f"params/mask_head/Conv_{i}/kernel", k)
            put(f"params/mask_head/Conv_{i}/bias", b)
        conv("mask_head", "ConvTranspose_0", "mrcnn_mask_deconv", deconv=True)
        conv("mask_head", "Conv_4", "mrcnn_mask")

    missing = sorted(set(tmpl) - set(out))
    if missing:
        raise ValueError(f"the h5 conversion leaves {len(missing)} variables unset: "
                         f"{missing[:4]}")
    return out


# ----------------------------------------------------------------------------
# Training: frozen-BN calibration and the fits
# ----------------------------------------------------------------------------

def exact_cudnn():
    """cuDNN with its deterministic algorithms and no TF32: the transposed
    conv (a convolution's backward-data) and the weight gradients of the
    convolutions otherwise sum by atomics, in an order that changes from run
    to run."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


@torch.no_grad()
def calibrate_batch_stats(model: MaskRCNN, images, passes: int = 2) -> MaskRCNN:
    """Set the frozen-BN running statistics from real activation
    statistics, as the JAX calibrate_batch_stats does: each pass runs the
    backbone on every image in batch-statistics mode (each layer's
    statistics taken under the previous layers' batch normalisation) and
    assigns the mean over the images to every BatchNorm's running mean and
    variance (flax's momentum 0). images [B, H, W, 3]. In place; returns
    the model."""
    images = torch.as_tensor(images, dtype=torch.float32, device=model.anchors.device)
    for _ in range(passes):
        with exact_cudnn():
            runs = [model.backbone_stats(images[i]) for i in range(images.shape[0])]
        for bn in runs[0]:
            bn.running_mean.copy_(torch.stack([r[bn][0] for r in runs]).mean(0))
            bn.running_var.copy_(torch.stack([r[bn][1] for r in runs]).mean(0))
    return model


def _train_params(model: MaskRCNN) -> list:
    """The trained parameters in the order of their flax paths (the order
    optax walks the tree in, for the global norm's sum)."""
    named = [(_flax_key(k), p) for k, p in model.named_parameters()]
    return [p for _, p in sorted(named, key=lambda kp: kp[0])]


def _clip_by_global_norm(grads: list, max_norm: float = 5.0) -> list:
    """optax.clip_by_global_norm: every gradient scaled by max_norm / g_norm
    when the global norm g_norm reaches max_norm, else left as it is."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm) for g in grads]


class _Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 outside the root,
    bias-corrected), in optax's order of operations."""

    def __init__(self, params: list, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params: list, grads: list) -> None:
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -self.lr)


class _SgdMomentum:
    """optax.sgd(lr, momentum): trace = g + momentum * trace, step -lr *
    trace."""

    def __init__(self, params: list, lr: float, momentum: float = 0.9):
        self.lr, self.momentum = lr, momentum
        self.trace = [torch.zeros_like(p) for p in params]

    def step(self, params: list, grads: list) -> None:
        for p, g, t in zip(params, grads, self.trace):
            t.copy_(g + self.momentum * t)
            p.add_(t * -self.lr)


def _fit_setup(model: MaskRCNN, variables: dict, images, boxes, classes, masks, valids,
               calibrate: bool):
    """Load the variables, calibrate, move the data to the model's device."""
    set_variables(model, variables)
    model.eval()
    dev = model.anchors.device
    data = (torch.as_tensor(images, dtype=torch.float32, device=dev),
            torch.as_tensor(boxes, dtype=torch.float32, device=dev),
            torch.as_tensor(classes, dtype=torch.int64, device=dev),
            torch.as_tensor(masks, dtype=torch.float32, device=dev),
            torch.as_tensor(valids, dtype=torch.bool, device=dev))
    if calibrate:
        calibrate_batch_stats(model, data[0])
    return data


def _apply_step(model: MaskRCNN, params: list, opt, loss: torch.Tensor) -> None:
    """Backward, global-norm clip at 5.0 (config.py GRADIENT_CLIP_NORM),
    then the optimizer's step."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = _clip_by_global_norm([p.grad for p in params], 5.0)
    with torch.no_grad():
        opt.step(params, grads)


def train_toy(model: MaskRCNN, variables: dict, images, boxes, classes, masks, valids,
              steps: int = 100, lr: float = 1e-3, seed: int = 0,
              calibrate: bool = True) -> dict:
    """Few-epoch fit on synthetic data (the JAX train_toy): train_losses on
    image step % B each step, clipped Adam. images [B, H, W, 3]; boxes
    [B, G, 4]; classes [B, G]; masks [B, H, W]; valids [B, G]. `variables`
    ({flax path: array}) are loaded into `model` first, and the model
    trains in place in eval mode (frozen BN statistics, trained BN scale and
    bias). calibrate=False keeps the incoming BN statistics (fine-tuning
    converted weights). Returns the trained {flax path: array}."""
    images, boxes, classes, masks, valids = _fit_setup(model, variables, images, boxes, classes,
                                                       masks, valids, calibrate)
    params = _train_params(model)
    opt = _Adam(params, lr)
    B = images.shape[0]
    with exact_cudnn():
        for step in range(steps):
            i = step % B
            loss = model.train_losses(images[i], boxes[i], classes[i], masks[i], valids[i])
            _apply_step(model, params, opt, loss)
    return variables_to_numpy(model)


def train_sampled(model: MaskRCNN, variables: dict, images, boxes, classes, masks, valids,
                  steps: int = 100, lr: float = 1e-3, batch: int = 2, seed: int = 0,
                  with_components: bool = False, calibrate: bool = True):
    """Batched proposal-sampled training (the JAX train_sampled): each step
    the mean over a minibatch of train_losses_sampled (the images of
    np.random.default_rng(seed).permutation(B), taken `batch` at a time
    round the permutation), clipped SGD with momentum 0.9. Arguments as
    train_toy's. Returns (variables, per-step total losses), and the
    per-step named losses with with_components=True."""
    images, boxes, classes, masks, valids = _fit_setup(model, variables, images, boxes, classes,
                                                       masks, valids, calibrate)
    params = _train_params(model)
    opt = _SgdMomentum(params, lr, 0.9)
    B = images.shape[0]
    order = np.random.default_rng(seed).permutation(B)
    steps_out = []
    with exact_cudnn():
        for step in range(steps):
            sel = order[np.arange(step * batch, (step + 1) * batch) % B]
            per = [model.train_losses_sampled(images[i], boxes[i], classes[i], masks[i],
                                              valids[i]) for i in sel]
            comps = {k: torch.stack([c[k] for c in per]).mean() for k in per[0]}
            _apply_step(model, params, opt, comps["total"])
            steps_out.append({k: v.detach() for k, v in comps.items()})
    components = [{k: float(v) for k, v in c.items()} for c in steps_out]
    losses = [c["total"] for c in components]
    if with_components:
        return variables_to_numpy(model), losses, components
    return variables_to_numpy(model), losses


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
        with exact_cudnn():
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
      'flax:W.h5'       the reference's Keras mask_rcnn_coco.h5, converted by
                        convert_keras_h5 (ResNet50; a frame of 384 rows or more
                        is molded to half size, as the JAX package does)
    """
    if not spec.startswith("flax"):
        raise ValueError(f"unknown segmenter spec '{spec}'")
    weights = spec.split(":", 1)[1] if ":" in spec else None
    variables, infer_hw, blocks = None, None, (3, 4, 6, 3)
    if weights:
        if weights.endswith(".h5"):
            infer_hw = default_infer_hw(image_hw)
            variables = convert_keras_h5(weights, image_hw=infer_hw)
        else:
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
