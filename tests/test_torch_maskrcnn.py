"""The port's Mask R-CNN (gdslam_tpu_torch.models.maskrcnn and the plain
versions of ops/detect_kernels) against the JAX package's
(gdslam_tpu.models.maskrcnn) on the same inputs and the same flax-initialised
weights, carried across by the npz layout of save_variables.

The JAX model is the test fixture of tests/test_maskrcnn.py (128 x 160,
pre_nms 128, post_nms 16, max_det 8, ResNet50 depth), initialised once under
jit. Tolerances: integers, anchors, NMS indices and detections exact; boxes
to 1e-6; the ROIAlign crops to 1e-6 absolute (the same operations in the
same order); features and head outputs to 1e-4 relative, with a floor of
1e-5 of each tensor's largest magnitude (convolutions and dense layers sum
thousands of terms in another order than XLA; the floor absorbs the
cancellation of elements near zero); the pasted masks equal on every pixel
but those within 1e-6 of the threshold, which are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.models import maskrcnn as jm
from gdslam_tpu_torch.models import maskrcnn as tm
from gdslam_tpu_torch.ops import detect_kernels as dk
from gdslam_tpu_torch.ops.detect_cases import paste_adversarial_det, roi_boundary_boxes

torch.set_num_threads(1)

HW = (128, 160)
KW = dict(pre_nms=128, post_nms=16, max_det=8)


def _flat(variables) -> dict:
    """{flax path: numpy array}: the keys of save_variables."""
    return {"/".join(str(k.key) for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}


@pytest.fixture(scope="module")
def models():
    jmodel = jm.MaskRCNN(image_hw=HW, **KW)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros(HW + (3,)))
    flat = _flat(variables)
    tmodel = tm.maskrcnn_from_numpy(flat, image_hw=HW, device="cpu", **KW)
    return jmodel, variables, tmodel, flat


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 255, HW + (3,)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_feats(models, image):
    jmodel, variables, _, _ = models
    x = jnp.asarray(image)[None] - jnp.asarray([123.7, 116.8, 103.9])
    return [np.asarray(f) for f in jmodel.apply(variables, x,
                                                method=lambda mod, x: mod.backbone(x))]


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# ----------------------------------------------------------------------------
# Functional pieces
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(128, 160), (120, 160), (240, 320), (480, 640)])
def test_generate_anchors_equal_jax(hw):
    got, want = tm.generate_anchors(hw), jm.generate_anchors(hw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _random_boxes(r, n, H, W, min_side=2.0):
    y1, x1 = r.uniform(0, H - min_side, n), r.uniform(0, W - min_side, n)
    h = min_side + r.uniform(0, 1, n) ** 2 * (H - y1 - min_side)
    w = min_side + r.uniform(0, 1, n) ** 2 * (W - x1 - min_side)
    return np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)


def test_apply_deltas_and_box_iou_match_jax():
    r = np.random.default_rng(1)
    boxes = _random_boxes(r, 300, 240, 320)
    deltas = r.normal(0, 1.5, (300, 4)).astype(np.float32)       # log terms reach the clip
    got = tm.apply_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas)).numpy()
    want = np.asarray(jm.apply_deltas(jnp.asarray(boxes), jnp.asarray(deltas)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    b2 = _random_boxes(r, 200, 240, 320)
    got = dk.box_iou(torch.from_numpy(boxes), torch.from_numpy(b2)).numpy()
    want = np.asarray(jm.box_iou(jnp.asarray(boxes), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _nms_case(kind, n, seed):
    r = np.random.default_rng(seed)
    # clustered boxes, so that suppression chains are long
    centres = _random_boxes(r, max(24, n // 8), 240, 320, 20.0)
    boxes = centres[r.integers(0, len(centres), n)] + r.normal(0, 4, (n, 4)).astype(np.float32)
    boxes = np.clip(boxes, 0, [240, 320, 240, 320]).astype(np.float32)
    scores = r.normal(0, 3, n).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores).astype(np.float32)             # a handful of values
        scores[r.uniform(size=n) < 0.3] = -np.inf
    elif kind == "all_inf":
        scores[:] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("kind", ["random", "ties", "all_inf"])
@pytest.mark.parametrize("n, n_out, th", [(1024, 128, 0.7), (128, 32, 0.3)],
                         ids=["proposals", "detections"])
def test_nms_fixed_matches_jax(kind, n, n_out, th):
    """Indices exact at both call shapes, -1 padded alike."""
    boxes, scores = _nms_case(kind, n, 7 + n)
    got = dk.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), th, n_out).numpy()
    want = np.asarray(jm.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), th, n_out))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if kind == "all_inf":
        assert (got == -1).all()
    else:
        assert (got >= 0).sum() > n_out // 4


def _nms_bitmask_mirror(boxes, scores, th, n_out):
    """csrc/nms_fixed.cu in plain numpy. Launch 1: the suppression bitmask
    (row i, word w, bit b: !(iou(box_i, box_32w+b) <= th)) and each box's
    rank by (score descending, index ascending), dead boxes last. Launch 2:
    the walk over that order in chunks of 32, each decided from the chunk's
    own 32 x 32 suppression bits and the removed set, capped at n_out, up
    to the first dead box; then -1."""
    n, words = len(boxes), (len(boxes) + 31) // 32
    b = torch.from_numpy(boxes)
    sup = np.zeros((n, words * 32), np.uint64)
    sup[:, :n] = ~(dk.box_iou(b, b) <= th).numpy()
    mask = (sup.reshape(n, words, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    alive = scores > -np.inf
    key = np.where(alive, scores, -np.inf)
    idx = np.arange(n)
    beats = (key[None] > key[:, None]) | ((key[None] == key[:, None]) & (idx[None] < idx[:, None]))
    order = np.empty(n, np.int64)
    order[beats.sum(1)] = idx
    assert sorted(beats.sum(1)) == list(idx)
    removed, out = np.zeros(words, np.uint64), []
    for base in range(0, n, 32):
        if len(out) >= n_out:
            break
        cand = order[base:base + 32]
        rows = [mask[c] if alive[c] else np.zeros(words, np.uint64) for c in cand]
        bit = lambda word, c: (int(word[c >> 5]) >> (c & 31)) & 1
        local = [sum(bit(row, c) << u for u, c in enumerate(cand)) for row in rows]
        open_ = sum((bool(alive[c]) and not bit(removed, c)) << u for u, c in enumerate(cand))
        kept = 0
        for t in range(len(cand)):
            if (open_ >> t) & 1:
                kept |= 1 << t
                open_ &= ~local[t]
        while bin(kept).count("1") > n_out - len(out):
            kept &= ~(1 << (kept.bit_length() - 1))
        for t, c in enumerate(cand):
            if (kept >> t) & 1:
                out.append(int(c))
                removed |= rows[t]
        if len(cand) < 32 or not alive[cand].all():
            break
    return np.asarray(out + [-1] * (n_out - len(out)), np.int32)


@pytest.mark.parametrize("kind, n, n_out, th", [
    ("random", 1024, 128, 0.7), ("ties", 1024, 128, 0.7), ("all_inf", 1024, 128, 0.7),
    ("random", 128, 32, 0.3), ("ties", 128, 32, 0.3), ("all_inf", 128, 32, 0.3),
    ("ties", 100, 160, 0.5), ("random", 1, 4, 0.5)],
    ids=["proposals-random", "proposals-ties", "proposals-all_inf", "detections-random",
         "detections-ties", "detections-all_inf", "n_out_above_n", "one_box"])
def test_nms_bitmask_walk_matches_jax(kind, n, n_out, th):
    """The order argument of the card's NMS (csrc/nms_fixed.cu), proved here
    on a plain mirror of its two launches: the greedy's picks are the boxes
    of the score order that no earlier kept box suppresses, so the mirror's
    indices equal the JAX nms_fixed exactly, -1 padded alike."""
    boxes, scores = _nms_case(kind, n, 7 + n)
    got = _nms_bitmask_mirror(boxes, scores, th, n_out)
    want = np.asarray(jm.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), th, n_out))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() == (0 if kind == "all_inf" else (want >= 0).sum())


@pytest.mark.parametrize("out_size, n", [(7, 128), (14, 32)], ids=["box_head", "mask_head"])
def test_roi_align_matches_jax(models, jax_feats, out_size, n):
    """On the small model's P2..P5, boxes spanning all four levels, to 1e-6
    absolute against the JAX function run op by op: each primitive rounds
    once, in the order the kernel keeps. (Under jit XLA contracts the
    sample coordinates and the blend into fused multiply-adds, which moves
    these crops, of magnitude ~100, by up to 1e-3.)"""
    r = np.random.default_rng(out_size)
    # sides from 20 to 1000 px: P4 and P5 take boxes larger than this image
    sides = np.exp(r.uniform(np.log(20), np.log(1000), n))
    ys, xs = r.uniform(-20, HW[0], n), r.uniform(-20, HW[1], n)
    boxes = np.stack([ys, xs, ys + sides * r.uniform(0.5, 1.5, n), xs + sides],
                     -1).astype(np.float32)
    flat, shapes = dk.flatten_levels([torch.tensor(f).permute(0, 3, 1, 2)
                                      for f in jax_feats])
    info = dk.roi_prologue(shapes, torch.from_numpy(boxes), out_size)[0].numpy()
    levels = np.searchsorted(np.cumsum([0] + [a * b for a, b in shapes])[:4], info[:, 0])
    assert set(levels) == {0, 1, 2, 3}
    got = dk.roi_align(flat, shapes, torch.from_numpy(boxes), out_size).numpy()
    want = np.asarray(jm.roi_align([jnp.asarray(f) for f in jax_feats], jnp.asarray(boxes),
                                   out_size, HW))
    assert got.shape == want.shape == (n, out_size, out_size, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_roi_level_rule_matches_jax():
    """The kernel's level rule (roi_levels, the area against ROI_LEVEL_AREA)
    gives the JAX roi_align's levels on boxes a few ulps either side of each
    threshold, and on random boxes: each level's features hold a distinct
    constant, so the crop reads back the level. It is what the log2 formula
    gave before it (torch on the CPU, the JAX package op by op: the same
    bits). Under jit XLA rounds sqrt(hw) / 224 otherwise and moves the first
    two thresholds down by 1-2 ulps of the area (ROADMAP section 3)."""
    shapes = ((32, 40), (16, 20), (8, 10), (4, 5))
    feats = [np.full((1, h, w, 4), 10.0 * lv, np.float32) for lv, (h, w) in enumerate(shapes)]
    r = np.random.default_rng(2)
    sides = np.exp(r.uniform(np.log(5), np.log(1500), (200, 2))).astype(np.float32)
    boxes = np.concatenate([roi_boundary_boxes(), np.concatenate(
        [np.zeros((200, 2), np.float32), sides], 1)])
    crop = np.asarray(jm.roi_align([jnp.asarray(f) for f in feats], jnp.asarray(boxes), 2,
                                   (128, 160)))
    want = np.rint(crop[:, 0, 0, 0] / 10).astype(np.int64)
    tb = torch.from_numpy(boxes)
    got = dk.roi_levels(tb).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got) == {0, 1, 2, 3}
    h = torch.clamp(tb[:, 2] - tb[:, 0], min=1.0)
    w = torch.clamp(tb[:, 3] - tb[:, 1], min=1.0)
    log2_rule = torch.clamp(torch.floor(2 + torch.log2(torch.sqrt(h * w) / 224.0 + 1e-9)), 0, 3)
    np.testing.assert_array_equal(got, log2_rule.long().numpy())
    flat, _ = dk.flatten_levels([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    info = dk.roi_prologue(shapes, tb, 2)[0].numpy()
    offsets = np.cumsum([0] + [a * b for a, b in shapes])[:4]
    np.testing.assert_array_equal(info[:, 0], offsets[got])


@pytest.mark.parametrize("D, hw", [(32, (480, 640)), (64, (120, 161)), (5, (33, 31))])
def test_paste_tile_lists_keep_the_union(D, hw):
    """The paste kernel's per-tile lists (paste_tile_lists, its plain
    mirror) hold every detection that sets a pixel of their tile, so
    pasting each tile's list alone
    (paste_masks_tiled_plain) gives paste_masks_plain on every pixel, with
    the class test as a bitmask (class_mask_ok) equal to torch.isin over the
    dynamic classes. Masks below the threshold everywhere, a hair under it,
    and a single blob are among them."""
    H, W = hw
    for seed in range(3):
        det = {k: torch.from_numpy(v) for k, v in paste_adversarial_det(
            np.random.default_rng(seed), D, H, W).items()}
        for dynamic_only in (True, False):
            want = dk.paste_masks_plain(det, hw, dynamic_only)
            assert torch.equal(dk.paste_masks_tiled_plain(det, hw, dynamic_only), want)
            # every (detection, pixel) that pastes lies in a tile that lists it
            b = det["boxes"][:, :, None, None]
            ys = torch.arange(H, dtype=torch.float32)[None, :, None]
            xs = torch.arange(W, dtype=torch.float32)[None, None, :]
            sets = dk.paste_ok(det, dynamic_only)[:, None, None] & \
                (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3]) & \
                (dk.paste_values(det, hw) > 0.5)
            lists = dk.paste_tile_lists(det, hw, dynamic_only)
            ty, tx = torch.arange(H) // dk.PASTE_TILE, torch.arange(W) // dk.PASTE_TILE
            listed = lists[ty[:, None], tx[None, :]].permute(2, 0, 1)
            assert not (sets & ~listed).any()
        assert 0 < int(want.sum()) < H * W
    c = torch.arange(-5, 200, dtype=torch.int32)
    assert torch.equal(dk.class_mask_ok(c),
                       torch.isin(c, torch.tensor(dk.DYNAMIC_CLASS_IDS, dtype=torch.int32)))


def _random_det(r, D, H, W):
    boxes = _random_boxes(r, D, H, W, 4.0)
    return {"boxes": boxes, "classes": r.integers(0, 81, D).astype(np.int32),
            "masks": r.uniform(0, 1, (D, 28, 28)).astype(np.float32),
            "valid": r.uniform(size=D) < 0.8}


@pytest.mark.parametrize("D, hw, dynamic_only", [(32, (480, 640), True), (8, HW, False)])
def test_paste_masks_matches_jax(D, hw, dynamic_only):
    """Equal on every pixel but those whose value lies within 1e-6 of the
    threshold (XLA contracts the separable product into fused multiply-adds);
    those are counted and reported."""
    det = _random_det(np.random.default_rng(D), D, *hw)
    tdet = {k: torch.from_numpy(v) for k, v in det.items()}
    got = dk.paste_masks(tdet, hw, dynamic_only).numpy()
    want = np.asarray(jm.paste_masks({k: jnp.asarray(v) for k, v in det.items()}, hw,
                                     dynamic_only))
    assert got.dtype == np.uint8 and got.shape == hw
    v = dk.paste_values(tdet, hw).numpy()
    ok = dk.paste_ok(tdet, dynamic_only).numpy()
    near = (np.abs(v - 0.5) < 1e-6)[ok].any(0)
    differ = got != want
    assert not (differ & ~near).any(), f"{(differ & ~near).sum()} pixels differ off the margin"
    print(f"paste: {differ.sum()} differing pixels, {near.sum()} within the margin")
    assert 0.02 < got.mean() < 0.9


# ----------------------------------------------------------------------------
# Layers on flax-initialised weights
# ----------------------------------------------------------------------------

def test_backbone_full_depth_matches_jax(models):
    """ResNet50 depth (3, 4, 6, 3): every Bottleneck's mapping, the FPN's
    nearest upsampling at sizes that are not a clean 2x (64 x 96: p5 2 x 3,
    c4 4 x 6), P6 as the strided max-pool."""
    jmodel, variables, tmodel, _ = models
    img = np.random.default_rng(3).uniform(0, 255, (64, 96, 3)).astype(np.float32)
    x = jnp.asarray(img)[None] - jnp.asarray([123.7, 116.8, 103.9])
    want = jmodel.apply(variables, x, method=lambda mod, x: mod.backbone(x))
    with torch.no_grad():
        got = tmodel.features(torch.from_numpy(img))
    assert len(got) == 5 and len(tmodel.backbone.stage_ends) == 4
    assert tmodel.backbone.stage_ends == (2, 6, 12, 15)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    assert all(g.is_contiguous(memory_format=torch.channels_last) for g in got[:4])


def test_rpn_matches_jax(models, jax_feats):
    """Logits and deltas per level, in anchor order."""
    jmodel, variables, tmodel, _ = models
    for f in jax_feats:
        wl, wd = jmodel.apply(variables, jnp.asarray(f), method=lambda mod, x: mod.rpn(x))
        with torch.no_grad():
            gl, gd = tmodel.rpn(torch.tensor(f).permute(0, 3, 1, 2))
        _close(gl.numpy(), wl)
        _close(gd.numpy(), wd)


def test_heads_match_jax(models):
    """The box head on [R, 7, 7, C] crops (flattened in (y, x, c) order) and
    the mask head on [R, 14, 14, C] crops, the transposed conv included."""
    jmodel, variables, tmodel, _ = models
    r = np.random.default_rng(4)
    crops7 = r.normal(0, 3, (16, 7, 7, 256)).astype(np.float32)
    crops14 = r.normal(0, 3, (8, 14, 14, 256)).astype(np.float32)
    wc, wb = jmodel.apply(variables, jnp.asarray(crops7), method=lambda mod, x: mod.box_head(x))
    wm = jmodel.apply(variables, jnp.asarray(crops14), method=lambda mod, x: mod.mask_head(x))
    with torch.no_grad():
        gc, gb = tmodel.box_head(torch.from_numpy(crops7))
        gm = tmodel.mask_head(torch.from_numpy(crops14))
    _close(gc.numpy(), wc)
    _close(gb.numpy(), wb)
    assert gm.shape == (8, 81, 28, 28)
    _close(_nhwc(gm), wm)


def test_whole_model_matches_jax(models, image):
    """score_th 0, so that detections exist: kept indices (through the
    boxes), classes and validity equal, boxes to 1e-3 px, masks to 1e-4."""
    jmodel, variables, tmodel, _ = models
    want = jax.jit(lambda v, im: jmodel.apply(v, im, score_th=0.0))(variables,
                                                                      jnp.asarray(image))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(image), score_th=0.0)
    assert got["valid"].any()
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0,
                               atol=1e-4)
    assert got["classes"].dtype == torch.int32 and got["masks"].shape == (8, 28, 28)


# ----------------------------------------------------------------------------
# Weight files
# ----------------------------------------------------------------------------

def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, a in flat.items():
        *scope, leaf = key.split("/")
        node = out
        for part in scope:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(a)
    return out


def test_every_leaf_maps_and_round_trips(models, tmp_path):
    """The 307 leaves of the ResNet50 model map onto the modules and back
    unchanged; a file written by either package's save_variables reads in the
    other to the same leaves, meta included (the leaves of a blocks
    (1, 1, 1, 1) model under a million elements: every kind of leaf, a
    file that compresses in a second)."""
    _, _, tmodel, flat = models
    assert len(flat) == 307
    back = tm.variables_to_numpy(tmodel)
    assert set(back) == set(flat)
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k
    small = {k: v for k, v in tm.init_variables((1, 1, 1, 1), seed=2).items() if v.size < 1e6}
    assert any("ConvTranspose_0" in k for k in small) and any("mean" in k for k in small)
    meta = {"blocks": [1, 1, 1, 1], "infer_hw": [120, 160]}
    jm.save_variables(_nested(small), str(tmp_path / "j.npz"), meta=meta)
    got = tm.load_variables(str(tmp_path / "j.npz"))
    assert set(got) == set(small) and all(np.array_equal(got[k], small[k]) for k in small)
    assert tm.load_meta(str(tmp_path / "j.npz")) == meta
    tm.save_variables(small, str(tmp_path / "t.npz"), meta=meta)
    want = _flat(jm.load_variables(str(tmp_path / "t.npz")))
    assert set(want) == set(small) and all(np.array_equal(want[k], small[k]) for k in small)
    assert jm.load_meta(str(tmp_path / "t.npz")) == meta


def test_init_variables_fit_both_packages():
    """The port's seeded numpy weights have the flax tree's paths and shapes
    (blocks (1, 1, 1, 1)) and the flax initialisers' statistics."""
    jmodel = jm.MaskRCNN(image_hw=(64, 64), blocks=(1, 1, 1, 1), **KW)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)))
    want = {"/".join(str(k.key) for k in kp): leaf.shape
            for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = tm.init_variables((1, 1, 1, 1), seed=5)
    assert {k: v.shape for k, v in got.items()} == want
    k = got["params/backbone/Bottleneck_2/Conv_1/kernel"]                # fan_in 3 * 3 * 256
    assert abs(k.std() * np.sqrt(9 * 256) - 1) < 0.02 and np.abs(k).max() <= 2.3 / 48
    assert (got["batch_stats/backbone/BatchNorm_0/var"] == 1).all()
    assert np.array_equal(tm.init_variables((1, 1, 1, 1), seed=5)["params/rpn/Conv_0/kernel"],
                          got["params/rpn/Conv_0/kernel"])
