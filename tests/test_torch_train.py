"""Mask R-CNN training in the port (gdslam_tpu_torch.models.maskrcnn and
ops/detect_kernels.roi_align_backward_plain) against the JAX package's
(gdslam_tpu.models.maskrcnn) on the same seeded numpy inputs and the same
flax-initialised weights.

The rig is a blocks (1, 1, 1, 1) model at 96 x 128 with pre/post NMS 64/16,
on two images of a red disk with a second gt box (valid on image 0, where it
covers most of the frame so that the sampled heads get positive proposals;
invalid on image 1). Its BatchNorm statistics are the JAX
calibrate_batch_stats's, as every fit starts from them.

Tolerances, each with its reason:
- the loss pieces, the targets' boxes and the ROIAlign gradient to 1e-6
  absolute: the same operations in the same order, the JAX functions run op
  by op;
- indices, classes and masks of detection_targets exactly;
- losses and their named components to 1e-4 relative (1e-6 absolute where
  one is 0): the backbone's convolutions sum in another order than XLA's;
- each parameter leaf's gradient to 1e-2 in relative norm
  (|g - g_jax| / |g_jax|; 1.3e-3 is the largest seen, on the mask head's
  first bias): the same reordered sums, carried back through the network;
- the calibrated statistics to 1e-4 relative to each leaf's largest value.
Three steps of train_sampled here, with their own tolerances; those of
train_toy and the weight files: tests/test_torch_train_fit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.models import maskrcnn as jm
from gdslam_tpu_torch.models import maskrcnn as tm
from gdslam_tpu_torch.ops import detect_kernels as dk

torch.set_num_threads(1)

HW = (96, 128)
KW = dict(pre_nms=64, post_nms=16, max_det=8)
BLOCKS = (1, 1, 1, 1)


def _flat(variables) -> dict:
    """{flax path: numpy array}: the keys of save_variables."""
    return {"/".join(str(k.key) for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _disk_image(r, cy, cx, rad):
    img = r.uniform(0, 60, HW + (3,)).astype(np.float32)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < rad * rad
    img[disk] = np.asarray([220.0, 40.0, 40.0]) + r.uniform(-10, 10, (disk.sum(), 3))
    return img, [cy - rad, cx - rad, cy + rad, cx + rad], disk.astype(np.float32)


@pytest.fixture(scope="module")
def rig():
    r = np.random.default_rng(0)
    samples = [_disk_image(r, 40, 50, 18), _disk_image(r, 55, 80, 15)]
    data = dict(images=np.stack([s[0] for s in samples]),
                boxes=np.asarray([[samples[0][1], [6, 4, 90, 124]],
                                  [samples[1][1], [5, 5, 30, 40]]], np.float32),
                classes=np.asarray([[1, 3], [1, 3]], np.int32),
                masks=np.stack([s[2] for s in samples]),
                valids=np.asarray([[True, True], [True, False]]))
    jmodel = jm.MaskRCNN(image_hw=HW, blocks=BLOCKS, **KW)
    v0 = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros(HW + (3,)))
    vc = jm.calibrate_batch_stats(jmodel, v0, jnp.asarray(data["images"]))
    return dict(jmodel=jmodel, v0=v0, vc=vc, flat=_flat(vc), **data)


def _port(rig):
    return tm.maskrcnn_from_numpy(rig["flat"], HW, BLOCKS, "cpu", **KW)


def _inputs(rig, i, jax_side: bool):
    keys = ("images", "boxes", "classes", "masks", "valids")
    if jax_side:
        return tuple(jnp.asarray(rig[k][i]) for k in keys)
    return tuple(torch.as_tensor(rig[k][i]) for k in keys)


def _rel(got, want) -> float:
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-2)


def _grads(model) -> dict:
    """{flax path: gradient} of the port's parameters, in the flax layouts."""
    modules = dict(model.named_modules())
    out = {}
    for key, p in model.named_parameters():
        scope, leaf = key.rsplit(".", 1)
        out[tm._flax_key(key)] = tm._from_torch_layout(modules[scope], leaf, p.grad.numpy())
    return out


def _hold_grads(model, jax_grads):
    want = _flat({"params": jax_grads})
    got = _grads(model)
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-12)
        assert err <= 1e-2, (k, err, np.linalg.norm(want[k]))


# ----------------------------------------------------------------------------
# Loss pieces and targets
# ----------------------------------------------------------------------------

def _piece_case(name, r):
    boxes = np.sort(r.uniform(-10, 140, (12, 2, 2)), axis=1).transpose(0, 2, 1)
    boxes = boxes.reshape(12, 4)[:, [0, 2, 1, 3]].astype(np.float32)     # y1 x1 y2 x2
    if name == "sigmoid_bce":
        return (r.normal(0, 8, (50,)).astype(np.float32),
                (r.uniform(size=50) < 0.5).astype(np.float32))
    if name == "huber":
        return (r.normal(0, 2, (60,)).astype(np.float32),)
    if name == "box_deltas_inverse":
        boxes[0, 2] = boxes[0, 0]                           # a zero height
        return boxes, boxes[::-1].copy()
    mask = (r.uniform(size=HW) < 0.3).astype(np.float32)
    boxes[1] = [-20, -20, 200, 300]                         # beyond every border
    boxes[2] = [95.5, 127.5, 96, 128]                       # the last row and column
    return mask, boxes


@pytest.mark.parametrize("name", ["sigmoid_bce", "huber", "box_deltas_inverse", "crop_mask"])
def test_loss_pieces_match_jax(name):
    """The loss pieces to 1e-6 absolute, crop_mask on boxes inside, across
    and beyond the image borders."""
    args = _piece_case(name, np.random.default_rng(len(name)))
    if name == "crop_mask":
        mask, boxes = args
        got = tm.crop_mask(torch.from_numpy(mask), torch.from_numpy(boxes), 28).numpy()
        want = np.stack([np.asarray(jm.crop_mask(jnp.asarray(mask), jnp.asarray(b), 28))
                         for b in boxes])
        assert np.array_equal(tm.crop_mask(torch.from_numpy(mask), torch.from_numpy(boxes[3]),
                                           28).numpy(), got[3])
    else:
        jfn = jm.optax_sigmoid_bce if name == "sigmoid_bce" else getattr(jm, name)
        got = getattr(tm, name)(*(torch.from_numpy(a) for a in args)).numpy()
        want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _target_case(kind, r):
    P, G = 16, 3
    gt = np.asarray([[10, 10, 40, 50], [50, 60, 90, 120], [0, 0, 5, 5]], np.float32)
    props = np.clip(gt[r.integers(0, 2, P)] + r.normal(0, 8, (P, 4)), 0, 128).astype(np.float32)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 2)
    props[3] = gt[0]
    valid = r.uniform(size=P) < 0.85
    if kind == "tied":
        props[8:] = props[:8]                               # every IoU appears twice
        props[5] = props[6] = [100, 100, 120, 120]          # tied at IoU 0
        valid[:] = True
    return props, valid, gt, np.asarray([3, 7, 2], np.int32), np.asarray([True, True, False])


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_detection_targets_match_jax(kind):
    """Indices (through the rois), classes, positives and validity exactly;
    the box targets to 1e-6; random proposals and proposals whose IoUs tie
    (top_k keeps the lower index)."""
    args = _target_case(kind, np.random.default_rng(7))
    for n_rois, ratio in ((64, 0.33), (8, 0.5)):
        got = tm.detection_targets(*(torch.from_numpy(a) for a in args), n_rois=n_rois,
                                   pos_ratio=ratio)
        want = jm.detection_targets(*(jnp.asarray(a) for a in args), n_rois=n_rois,
                                    pos_ratio=ratio)
        rois, cls, tgt, is_pos, valid, matched = (g.numpy() for g in got)
        assert np.array_equal(rois, np.asarray(want[0]))
        for a, b in ((cls, want[1]), (is_pos, want[3]), (valid, want[4]), (matched, want[5])):
            assert np.array_equal(a, np.asarray(b))
        np.testing.assert_allclose(tgt, np.asarray(want[2]), rtol=0, atol=1e-6)
        assert is_pos.any() and (~is_pos & valid).any()


# ----------------------------------------------------------------------------
# The ROIAlign gradient
# ----------------------------------------------------------------------------

def _backward_boxes(kind, r, n):
    if kind == "levels":            # sides from 4 to 400 px: every level
        sides = np.exp(r.uniform(np.log(4), np.log(400), n))
        ys, xs = r.uniform(-20, HW[0], n), r.uniform(-20, HW[1], n)
        return np.stack([ys, xs, ys + sides, xs + sides * r.uniform(0.5, 2, n)], -1)
    if kind == "borders":           # clipped taps meet on the border rows of each level
        b = np.asarray([[-30, -30, 10, 12], [90, 120, 96, 128], [0, 0, 96, 128],
                        [-5, 100, 30, 140], [80, -10, 110, 20], [94, 126, 200, 300]])
        return np.concatenate([b, b[:, [0, 1, 2, 3]] * 0.5]).astype(np.float64)
    base = np.asarray([30, 40, 50, 70])   # shared rows: one box repeated and nudged
    return base + r.normal(0, 0.3, (n, 4)).cumsum(0) * (np.arange(n) % 3 != 0)[:, None]


@pytest.mark.parametrize("kind", ["levels", "borders", "shared_rows"])
@pytest.mark.parametrize("out_size", [7, 14])
def test_roi_align_backward_plain_matches_jax_vjp(kind, out_size):
    """The gradient of roi_align with respect to the four levels, carried
    back through flatten_levels into channels-last [1, C, h, w] features,
    against jax.vjp of the JAX roi_align run op by op: to 1e-6 (in fact the
    same bits: the scatter-adds are summed in the JAX transpose's order).
    The boxes reach every level, hang over the image and level borders
    (clipped taps land on one row) and repeat (long runs of one row)."""
    r = np.random.default_rng(out_size + len(kind))
    C = 16
    shapes = [(24, 32), (12, 16), (6, 8), (3, 4)]
    levels = [r.normal(0, 1, (1, h, w, C)).astype(np.float32) for h, w in shapes]
    p6 = jnp.zeros((1, 2, 2, C))
    boxes = _backward_boxes(kind, r, 12).astype(np.float32)
    g = r.normal(0, 1, (boxes.shape[0], out_size, out_size, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda fs: jm.roi_align(fs + [p6], jnp.asarray(boxes), out_size, HW),
                       [jnp.asarray(f) for f in levels])
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]

    feats = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for f in levels]
    flat, tshapes = dk.flatten_levels(feats)
    assert tshapes == tuple(shapes)
    crop = dk.roi_align(flat, tshapes, torch.from_numpy(boxes), out_size)
    np.testing.assert_array_equal(crop.detach().numpy(), np.asarray(out))
    crop.backward(torch.from_numpy(g))
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), w, rtol=0, atol=1e-6)
    direct = dk.roi_align_backward_plain(torch.from_numpy(g), tshapes, torch.from_numpy(boxes))
    assert torch.equal(direct, torch.cat([f.grad[0].permute(1, 2, 0).reshape(-1, C)
                                          for f in feats]))


def _gather_mirror(g, shapes, prologue, tile=(2, 4)):
    """csrc/roi_align_backward.cu in plain numpy: per tile (rows x columns)
    of one level, the candidates (tap, box) of that level that meet it, in
    (tap, box) order, with the bins i of each tile row and j of each tile
    column; per row, their contributions (g * b) * a summed in (tap, box, i,
    j) order, each tap into a partial sum added to the total when the next
    tap begins; every row written."""
    info, y0, x0, fy, fx = (t.numpy() for t in prologue)
    R, o, _, C = g.shape
    out = np.empty((sum(h * w for h, w in shapes), C), np.float32)
    one, zero = np.float32(1), np.zeros(C, np.float32)
    off, (th, tw) = 0, tile
    for h, w in shapes:
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                listed = []
                for tap, (dy, dx) in enumerate(((1, 1), (1, 0), (0, 1), (0, 0))):
                    for r in range(R):
                        if info[r, 0] != off:
                            continue
                        yi = np.clip(y0[r].astype(np.int64) + dy, 0, info[r, 1] - 1) - ty0
                        xi = np.clip(x0[r].astype(np.int64) + dx, 0, info[r, 2] - 1) - tx0
                        im = [np.flatnonzero(yi == q) for q in range(th)]
                        jm = [np.flatnonzero(xi == q) for q in range(tw)]
                        if any(len(v) for v in im) and any(len(v) for v in jm):
                            listed.append((tap, dy, dx, r, im, jm))
                for ty in range(min(th, h - ty0)):
                    for tx in range(min(tw, w - tx0)):
                        total, part, group = zero, zero, -1
                        for tap, dy, dx, r, im, jm in listed:
                            for i in im[ty]:
                                for j in jm[tx]:
                                    if tap != group:
                                        if group >= 0:
                                            total = total + part
                                        part, group = zero, tap
                                    a = fy[r, i] if dy else one - fy[r, i]
                                    b = fx[r, j] if dx else one - fx[r, j]
                                    part = part + (g[r, i, j] * b) * a
                        out[off + (ty0 + ty) * w + tx0 + tx] = total + part
        off += h * w
    return out


@pytest.mark.parametrize("kind", ["levels", "borders", "shared_rows"])
@pytest.mark.parametrize("out_size", [7, 14])
def test_roi_align_backward_gather_equals_plain(kind, out_size):
    """The order argument of the card's ROIAlign gradient
    (csrc/roi_align_backward.cu), proved here on a plain mirror of its
    per-tile gather: walking each target row's (tap, box, i, j) in nested
    order gives the sorted, stable list of roi_align_backward_plain, so the
    two agree to the bit, zero rows included, on boxes over every level,
    hanging over the borders, sharing rows, and one inverted box."""
    r = np.random.default_rng(out_size + len(kind))
    C = 16
    shapes = ((24, 32), (12, 16), (6, 8), (3, 4))
    boxes = np.concatenate([_backward_boxes(kind, r, 12), [[60.0, 90.0, 20.0, 30.0]]])
    boxes = torch.from_numpy(boxes.astype(np.float32))
    g = r.normal(0, 1, (boxes.shape[0], out_size, out_size, C)).astype(np.float32)
    pro = dk.roi_prologue(shapes, boxes, out_size)
    want = dk.roi_align_backward_plain(torch.from_numpy(g), shapes, boxes, pro).numpy()
    got = _gather_mirror(g, shapes, pro)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert 0 < (want != 0).any(1).sum() < want.shape[0]


def test_roi_align_refuses_boxes_that_want_a_gradient():
    flat = torch.zeros(24 * 32 + 12 * 16 + 6 * 8 + 3 * 4, 8, requires_grad=True)
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]], requires_grad=True)
    with pytest.raises(ValueError, match="boxes get no gradient"):
        dk.roi_align(flat, ((24, 32), (12, 16), (6, 8), (3, 4)), boxes, 7)


# ----------------------------------------------------------------------------
# Calibration, the losses and their gradients
# ----------------------------------------------------------------------------

def test_calibrate_batch_stats_matches_jax(rig):
    """Flax's batch-statistics mode (biased variance, clipped at 0), the mean
    over the images, two passes: every statistic to 1e-4 of its leaf's
    largest magnitude; the parameters untouched."""
    port = tm.maskrcnn_from_numpy(_flat(rig["v0"]), HW, BLOCKS, "cpu", **KW)
    assert tm.calibrate_batch_stats(port, rig["images"], passes=2) is port
    got = tm.variables_to_numpy(port)
    want, start = rig["flat"], _flat(rig["v0"])
    for k in want:
        if k.startswith("batch_stats"):
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
            assert not np.array_equal(got[k], start[k])
        else:
            assert np.array_equal(got[k], start[k])


@pytest.mark.parametrize("i", [0, 1], ids=["two_valid_gts", "one_invalid_gt"])
def test_train_losses_and_gradients_match_jax(rig, i):
    """train_losses (teacher-forced heads, background ROIs) to 1e-4 relative
    and the gradient of every parameter leaf to 1e-2 in relative norm."""
    jmodel, vc = rig["jmodel"], rig["vc"]
    jin = _inputs(rig, i, True)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p, "batch_stats": vc["batch_stats"]}, *jin,
        method=jm.MaskRCNN.train_losses)))(vc["params"])
    port = _port(rig)
    got = port.train_losses(*_inputs(rig, i, False))
    assert _rel(got, loss) <= 1e-4, (float(got), float(loss))
    got.backward()
    _hold_grads(port, grads)


def test_train_losses_sampled_match_jax(rig):
    """train_losses_sampled on both images (positives on image 0, none on
    image 1): every named loss to 1e-4 relative, n_pos_rois exactly; on
    image 0 the gradient of every leaf to 1e-2 in relative norm."""
    jmodel, vc = rig["jmodel"], rig["vc"]

    def jloss(p, *a):
        return jmodel.apply({"params": p, "batch_stats": vc["batch_stats"]}, *a,
                            method=jm.MaskRCNN.train_losses_sampled)

    for i in (0, 1):
        jin = _inputs(rig, i, True)
        if i == 0:
            want, grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, *jin)["total"]))(
                vc["params"])
        comps = jax.jit(jloss)(vc["params"], *jin)
        port = _port(rig)
        got = port.train_losses_sampled(*_inputs(rig, i, False))
        assert set(got) == set(comps)
        for k, v in comps.items():
            assert abs(float(got[k].detach()) - float(v)) <= max(1e-4 * abs(float(v)), 1e-6), \
                (k, i)
        assert float(got["n_pos_rois"]) == float(comps["n_pos_rois"]) == (2.0 if i == 0 else 0.0)
        if i == 0:
            assert _rel(got["total"], want) <= 1e-4
            got["total"].backward()
            _hold_grads(port, grads)



def _update_gap(got: dict, want: dict, start: dict) -> tuple[float, float]:
    """Over all parameters: |update_port - update_jax| / |update_jax| in
    global norm, and the largest elementwise parameter difference."""
    keys = [k for k in want if k.startswith("params")]
    du = np.concatenate([(got[k] - want[k]).ravel() for k in keys])
    u = np.concatenate([(want[k] - start[k]).ravel() for k in keys])
    return float(np.linalg.norm(du) / np.linalg.norm(u)), float(np.abs(du).max())


def _data(rig, jax_side):
    keys = ("images", "boxes", "classes", "masks", "valids")
    return tuple(jnp.asarray(rig[k]) if jax_side else rig[k] for k in keys)


def test_train_sampled_three_steps_match_jax(rig):
    """Three clipped SGD-momentum steps on batches of the permutation of
    seed 0 (no calibration: the rig's statistics): the per-step mean losses
    to 1e-3 relative and every named component to 1e-2 (head_box averages
    the huber terms of two positive ROIs, and after two steps the 1e-3
    gradient differences move it by 1.3e-3; 1e-3, set first, failed at
    that), the parameter updates to 2% of their global norm (SGD moves
    every parameter by its gradient, which the two packages agree on to
    ~1e-3)."""
    jmodel = rig["jmodel"]
    want_v, want_l, want_c = jm.train_sampled(jmodel, rig["vc"], *_data(rig, True), steps=3,
                                              lr=1e-3, batch=2, with_components=True,
                                              calibrate=False)
    got_v, got_l, got_c = tm.train_sampled(_port(rig), rig["flat"], *_data(rig, False), steps=3,
                                           lr=1e-3, batch=2, with_components=True,
                                           calibrate=False)
    assert len(got_l) == len(want_l) == 3
    for a, b, ca, cb in zip(got_l, want_l, got_c, want_c):
        assert _rel(a, b) <= 1e-3, (got_l, want_l)
        assert set(ca) == set(cb)
        for k in cb:
            assert abs(ca[k] - cb[k]) <= max(1e-2 * abs(cb[k]), 1e-5), (k, ca[k], cb[k])
    gap, worst = _update_gap(got_v, _flat(want_v), rig["flat"])
    assert gap <= 0.02, (gap, worst)
    assert want_l[-1] < want_l[0] and got_l[-1] < got_l[0]


def test_variables_to_numpy_returns_copies(rig):
    """The {flax path: array} a fit returns stays as it was when the model
    trains on: on the CPU a tensor's .numpy() shares its memory."""
    port = _port(rig)
    flat = tm.variables_to_numpy(port)
    before = {k: v.copy() for k, v in flat.items()}
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
    assert all(np.array_equal(flat[k], before[k]) for k in flat)
