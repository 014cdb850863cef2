"""The reference's Keras weights for the live segmenter on the port:
gdslam_tpu_torch.models.maskrcnn.convert_keras_h5, `build_segmenter("flax:
W.h5")` and `--segmenter flax:W.h5` in both drivers.

The COCO weights (mask_rcnn_coco.h5) are not in the repository, so the file
here is synthetic, written in the matterport layout as
tests/test_maskrcnn.py::TestWeightConversion writes it (the same layer names
and Keras conventions: conv biases before BN, raw BN parameters, the RPN's
two logits an anchor, [kh, kw, out, in] deconv kernels, nested groups), with
the shapes of the port's own MaskRCNN(). Every converted leaf is held to the
raw arrays by the conversion's rules (copies exactly, folds to 1e-6), and the
converter's pieces (the weight lookup, the BN folds) to the JAX package's on
the same file. The JAX convert_keras_h5 itself is not run here: its flax
init of the template costs 44-54 s on this CPU.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from gdslam_tpu.models import maskrcnn as jm
from gdslam_tpu_torch import CameraConfig
from gdslam_tpu_torch.io import png
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.models import maskrcnn as tm

torch.set_num_threads(1)

HW = (120, 160)
N_FRAMES = 6
T_EPOCH = 1305031790.0
SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
SETTINGS_YAML = """%YAML:1.0
Camera.fx: 160.0
Camera.fy: 160.0
Camera.cx: 80.0
Camera.cy: 60.0
Camera.width: 160
Camera.height: 120
Camera.fps: 30.0
Camera.bf: 12.8
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 384
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""


def write_matterport_h5(path: str, shapes: dict, seed: int = 7, nested: bool = True,
                        rpn_model: bool = False) -> dict:
    """A Keras h5 in the matterport layout with the kernel shapes of
    `shapes` ({flax path: shape} of a MaskRCNN()); returns {(layer, name):
    array}. With `nested`, the stem's datasets sit one group deeper; with
    `rpn_model`, the RPN's layers sit inside an `rpn_model` group, as Keras
    saves the layers of a sub-model."""
    import h5py
    rng = np.random.default_rng(seed)
    raw = {}

    def put(f, layer, **arrays):
        if rpn_model and layer.startswith("rpn_"):
            f = f.require_group("rpn_model")
        g = f.create_group(layer) if layer not in f else f[layer]
        if nested and layer in ("conv1", "bn_conv1"):
            g = g.create_group(layer) if layer not in g else g[layer]
        for name, arr in arrays.items():
            arr = np.asarray(arr, np.float32)
            g.create_dataset(f"{name}:0", data=arr)
            raw[(layer, name)] = arr

    def rand(shape):
        return rng.normal(0, 0.05, shape)

    def put_conv_bn(f, conv_layer, bn_layer, kshape):
        put(f, conv_layer, kernel=rand(kshape), bias=rand(kshape[-1:]))
        c = kshape[-1]
        put(f, bn_layer, gamma=1 + 0.1 * rand((c,)), beta=rand((c,)), moving_mean=rand((c,)),
            moving_variance=np.abs(1 + 0.1 * rand((c,))))

    def kshape(scope):
        return shapes[f"params/{scope}/kernel"]

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        put_conv_bn(root, "conv1", "bn_conv1", kshape("backbone/Conv_0"))
        blk = 0
        for stage, letters in tm._RESNET_STAGES:
            for j, letter in enumerate(letters):
                for ci, br in enumerate(("2a", "2b", "2c")):
                    put_conv_bn(root, f"res{stage}{letter}_branch{br}",
                                f"bn{stage}{letter}_branch{br}",
                                kshape(f"backbone/Bottleneck_{blk}/Conv_{ci}"))
                if j == 0:
                    put_conv_bn(root, f"res{stage}{letter}_branch1", f"bn{stage}{letter}_branch1",
                                kshape(f"backbone/Bottleneck_{blk}/Conv_3"))
                blk += 1
        for key, layer in (("Conv_1", "fpn_c5p5"), ("Conv_2", "fpn_c4p4"),
                           ("Conv_3", "fpn_c3p3"), ("Conv_4", "fpn_c2p2"),
                           ("Conv_5", "fpn_p2"), ("Conv_6", "fpn_p3"),
                           ("Conv_7", "fpn_p4"), ("Conv_8", "fpn_p5")):
            ks = kshape(f"backbone/{key}")
            put(root, layer, kernel=rand(ks), bias=rand(ks[-1:]))
        put(root, "rpn_conv_shared", kernel=rand((3, 3, 256, 512)), bias=rand((512,)))
        put(root, "rpn_class_raw", kernel=rand((1, 1, 512, 6)), bias=rand((6,)))
        put(root, "rpn_bbox_pred", kernel=rand((1, 1, 512, 12)), bias=rand((12,)))
        put_conv_bn(root, "mrcnn_class_conv1", "mrcnn_class_bn1", (7, 7, 256, 1024))
        put_conv_bn(root, "mrcnn_class_conv2", "mrcnn_class_bn2", (1, 1, 1024, 1024))
        put(root, "mrcnn_class_logits", kernel=rand((1024, 81)), bias=rand((81,)))
        put(root, "mrcnn_bbox_fc", kernel=rand((1024, 324)), bias=rand((324,)))
        for i in range(1, 5):
            put_conv_bn(root, f"mrcnn_mask_conv{i}", f"mrcnn_mask_bn{i}", (3, 3, 256, 256))
        put(root, "mrcnn_mask_deconv", kernel=rand((2, 2, 256, 256)), bias=rand((256,)))
        put(root, "mrcnn_mask", kernel=rand((1, 1, 256, 81)), bias=rand((81,)))
    return raw


def expected_variables(raw: dict) -> dict:
    """{flax path: array} the conversion rules give from the raw arrays of
    write_matterport_h5, written out leaf by leaf."""
    out = {}

    def conv_bn(scope, conv_key, bn_key, conv_layer, bn_layer):
        out[f"params/{scope}/{conv_key}/kernel"] = raw[(conv_layer, "kernel")]
        out[f"params/{scope}/{bn_key}/scale"] = raw[(bn_layer, "gamma")]
        out[f"params/{scope}/{bn_key}/bias"] = raw[(bn_layer, "beta")]
        out[f"batch_stats/{scope}/{bn_key}/mean"] = (raw[(bn_layer, "moving_mean")] -
                                                     raw[(conv_layer, "bias")])
        out[f"batch_stats/{scope}/{bn_key}/var"] = raw[(bn_layer, "moving_variance")]

    def conv(scope, key, layer):
        out[f"params/{scope}/{key}/kernel"] = raw[(layer, "kernel")]
        out[f"params/{scope}/{key}/bias"] = raw[(layer, "bias")]

    def folded(scope, key, layer, bn, flatten):
        k, b = raw[(layer, "kernel")], raw[(layer, "bias")]
        s = raw[(bn, "gamma")] / np.sqrt(raw[(bn, "moving_variance")] + 1e-3)
        out[f"params/{scope}/{key}/kernel"] = (k.reshape(-1, k.shape[-1]) if flatten else k) * s
        out[f"params/{scope}/{key}/bias"] = (b - raw[(bn, "moving_mean")]) * s + raw[(bn, "beta")]

    conv_bn("backbone", "Conv_0", "BatchNorm_0", "conv1", "bn_conv1")
    blk = 0
    for stage, letters in tm._RESNET_STAGES:
        for j, letter in enumerate(letters):
            scope = f"backbone/Bottleneck_{blk}"
            for ci, br in enumerate(("2a", "2b", "2c")):
                conv_bn(scope, f"Conv_{ci}", f"BatchNorm_{ci}", f"res{stage}{letter}_branch{br}",
                        f"bn{stage}{letter}_branch{br}")
            if j == 0:
                conv_bn(scope, "Conv_3", "BatchNorm_3", f"res{stage}{letter}_branch1",
                        f"bn{stage}{letter}_branch1")
            blk += 1
    for i, layer in enumerate(("fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
                               "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5")):
        conv("backbone", f"Conv_{i + 1}", layer)
    conv("rpn", "Conv_0", "rpn_conv_shared")
    kc, bc = raw[("rpn_class_raw", "kernel")], raw[("rpn_class_raw", "bias")]
    out["params/rpn/Conv_1/kernel"] = kc[..., 1::2] - kc[..., 0::2]
    out["params/rpn/Conv_1/bias"] = bc[1::2] - bc[0::2]
    conv("rpn", "Conv_2", "rpn_bbox_pred")
    folded("box_head", "Dense_0", "mrcnn_class_conv1", "mrcnn_class_bn1", True)
    folded("box_head", "Dense_1", "mrcnn_class_conv2", "mrcnn_class_bn2", True)
    conv("box_head", "Dense_2", "mrcnn_class_logits")
    conv("box_head", "Dense_3", "mrcnn_bbox_fc")
    for i in range(4):
        folded("mask_head", f"Conv_{i}", f"mrcnn_mask_conv{i + 1}", f"mrcnn_mask_bn{i + 1}", False)
    conv("mask_head", "ConvTranspose_0", "mrcnn_mask_deconv")
    # Keras' scatter-form deconv: flipped on both spatial axes, (out, in) swapped
    dk = out["params/mask_head/ConvTranspose_0/kernel"]
    out["params/mask_head/ConvTranspose_0/kernel"] = np.transpose(dk[::-1, ::-1], (0, 1, 3, 2))
    conv("mask_head", "Conv_4", "mrcnn_mask")
    return out


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    """The synthetic weight file, its raw arrays and the port's conversion."""
    shapes = {k: v.shape for k, v in tm.variables_to_numpy(tm.MaskRCNN(image_hw=HW)).items()}
    path = str(tmp_path_factory.mktemp("keras") / "mask_rcnn_coco.h5")
    raw = write_matterport_h5(path, shapes)
    return path, raw, tm.convert_keras_h5(path, image_hw=HW)


def test_every_leaf_follows_the_raw_arrays(h5):
    """Every variable of a MaskRCNN() comes from the file, by the rules:
    copies exactly, the folds to 1e-6, all float32."""
    _, raw, got = h5
    want = expected_variables(raw)
    template = tm.variables_to_numpy(tm.MaskRCNN(image_hw=HW))
    assert set(got) == set(want) == set(template) and len(got) > 300
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == template[k].shape, k
        np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)


def test_converter_pieces_equal_jax(h5):
    """The weight lookup (nested and flat groups) and the BN folds give the
    JAX package's arrays bit for bit on the same file."""
    import h5py
    path, _, _ = h5
    with h5py.File(path, "r") as f:
        root = f["model_weights"]
        for layer, suffix in (("conv1", "kernel"), ("bn_conv1", "moving_variance"),
                              ("res4c_branch2b", "bias"), ("mrcnn_mask_deconv", "kernel")):
            np.testing.assert_array_equal(tm._h5_weight(root, layer, suffix),
                                          jm._h5_weight(root, layer, suffix))
        b = tm._h5_weight(root, "conv1", "bias")
        for a, w in zip(tm._fold_bn(root, "bn_conv1", conv_bias=b),
                        jm._fold_bn(root, "bn_conv1", conv_bias=b)):
            np.testing.assert_array_equal(a, w)
        for layer, bn in (("mrcnn_class_conv2", "mrcnn_class_bn2"),
                          ("mrcnn_mask_conv1", "mrcnn_mask_bn1")):
            k = tm._h5_weight(root, layer, "kernel")
            b = tm._h5_weight(root, layer, "bias")
            for a, w in zip(tm._fold_bn_into_dense(k, b, root, bn),
                            jm._fold_bn_into_dense(k, b, root, bn)):
                np.testing.assert_array_equal(a, w)


def test_fold_rules_on_the_raw_arrays(h5):
    """The conversion rules against the raw arrays: conv biases folded into
    the BN means, BN folded into the box head's dense layers and the mask
    convs (eps 1e-3), the RPN's two logits folded to fg - bg, the deconv
    kernel flipped on both spatial axes with (out, in) swapped."""
    _, raw, got = h5
    np.testing.assert_array_equal(got["params/backbone/Conv_0/kernel"], raw[("conv1", "kernel")])
    np.testing.assert_allclose(got["batch_stats/backbone/BatchNorm_0/mean"],
                               raw[("bn_conv1", "moving_mean")] - raw[("conv1", "bias")],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["batch_stats/backbone/Bottleneck_0/BatchNorm_3/var"],
                                  raw[("bn2a_branch1", "moving_variance")])
    kc, bc = raw[("rpn_class_raw", "kernel")], raw[("rpn_class_raw", "bias")]
    np.testing.assert_allclose(got["params/rpn/Conv_1/kernel"], kc[..., 1::2] - kc[..., 0::2],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["params/rpn/Conv_1/bias"], bc[1::2] - bc[0::2], atol=1e-6,
                               rtol=0)
    for i, (dense, layer, bn) in enumerate((("Dense_0", "mrcnn_class_conv1", "mrcnn_class_bn1"),
                                           ("Conv_2", "mrcnn_mask_conv3", "mrcnn_mask_bn3"))):
        k, b = raw[(layer, "kernel")], raw[(layer, "bias")]
        s = raw[(bn, "gamma")] / np.sqrt(raw[(bn, "moving_variance")] + 1e-3)
        scope = "box_head" if i == 0 else "mask_head"
        want_k = (k.reshape(-1, k.shape[-1]) if i == 0 else k) * s
        np.testing.assert_allclose(got[f"params/{scope}/{dense}/kernel"], want_k, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got[f"params/{scope}/{dense}/bias"],
                                   (b - raw[(bn, "moving_mean")]) * s + raw[(bn, "beta")],
                                   atol=1e-6, rtol=0)
    dk_raw = raw[("mrcnn_mask_deconv", "kernel")]
    dk = got["params/mask_head/ConvTranspose_0/kernel"]
    np.testing.assert_array_equal(dk[1, 0, 3, 5], dk_raw[0, 1, 5, 3])
    np.testing.assert_array_equal(dk, np.transpose(dk_raw[::-1, ::-1], (0, 1, 3, 2)))


def test_h5_layout_errors_name_what_is_wrong(h5, tmp_path):
    """A file without a layer fails naming it; a layer of the wrong width
    fails naming the variable; a file that is not there fails to open."""
    import h5py
    path, _, _ = h5
    shapes = {k: v.shape for k, v in tm.variables_to_numpy(tm.MaskRCNN(image_hw=HW)).items()}
    cut = str(tmp_path / "cut.h5")
    write_matterport_h5(cut, shapes, nested=False)
    with h5py.File(cut, "a") as f:
        del f["model_weights"]["mrcnn_mask"]
    with pytest.raises(KeyError, match="mrcnn_mask"):
        tm.convert_keras_h5(cut, image_hw=HW)
    narrow = dict(shapes)
    narrow["params/backbone/Conv_0/kernel"] = (7, 7, 3, 32)
    bad = str(tmp_path / "bad.h5")
    write_matterport_h5(bad, narrow)
    with pytest.raises(ValueError, match="backbone/Conv_0/kernel"):
        tm.convert_keras_h5(bad, image_hw=HW)
    with pytest.raises(FileNotFoundError):
        tm.build_segmenter(f"flax:{tmp_path / 'missing.h5'}", image_hw=HW, device="cpu")


def test_rpn_inside_its_sub_model_group(h5, tmp_path):
    """The RPN's layers saved inside an `rpn_model` group (matterport's
    sub-model) convert to the same variables as at the top."""
    path, _, want = h5
    shapes = {k: v.shape for k, v in want.items()}
    sub = str(tmp_path / "rpn_model.h5")
    write_matterport_h5(sub, shapes, rpn_model=True)
    got = tm.convert_keras_h5(sub, image_hw=HW)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_h5_segmenter_is_the_converted_model(h5):
    """build_segmenter('flax:W.h5') is a ResNet50 MaskRCNN() holding the
    converted variables: its detections and mask of a rendered frame are
    those of maskrcnn_from_numpy on the converted dict, bit for bit."""
    path, _, conv = h5
    seg = tm.build_segmenter(f"flax:{path}", image_hw=HW, device="cpu")
    assert seg.model.blocks == (3, 4, 6, 3) and seg.infer_hw == HW
    ref = tm.TorchSegmenter(conv, image_hw=HW, device="cpu")
    rgb = tsyn.render_frame(4, SCAM, with_dynamic=True, device="cpu").rgb.to(torch.uint8)
    got, want = seg.detect(rgb), ref.detect(rgb)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(seg.segment(rgb), ref.segment(rgb))
    assert np.array_equal(seg(rgb.numpy()), ref(rgb.numpy()))


@pytest.fixture(scope="module")
def tum_seq(tmp_path_factory):
    """A short TUM-layout sequence of the dynamic scene (RGB and 16-bit depth
    PNGs, assoc.txt, settings, ground truth)."""
    root = tmp_path_factory.mktemp("tum_h5")
    for sub in ("rgb", "depth"):
        os.makedirs(root / sub)
    assoc, gt = [], []
    for i in range(N_FRAMES):
        fr = tsyn.render_frame(i, SCAM, with_dynamic=True, device="cpu")
        ts = T_EPOCH + i / 30.0
        name = f"{ts:.6f}.png"
        Image.fromarray(fr.rgb.numpy().astype(np.uint8)).save(root / "rgb" / name)
        Image.fromarray((fr.depth.numpy() * 5000.0).astype(np.uint16)).save(
            root / "depth" / name)
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        T = fr.T_wc.numpy().astype(np.float64)
        gt.append(f"{ts:.6f} {T[0, 3]:.6f} {T[1, 3]:.6f} {T[2, 3]:.6f} 0 0 0 1")
    (root / "assoc.txt").write_text("\n".join(assoc) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (root / "settings.yaml").write_text(SETTINGS_YAML)
    return str(root)


def test_rgbd_tum_runs_the_h5_segmenter(h5, tum_seq, tmp_path, monkeypatch):
    """rgbd_tum ... MASKS --segmenter flax:W.h5 --device cpu: the net runs
    on every frame (an empty mask cache), every mask is written back as the
    segmenter's own mask of the frame, and the run writes its trajectory."""
    from gdslam_tpu_torch.cli import rgbd_tum
    path, _, _ = h5
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "mask_cache")
    assert rgbd_tum.main(["none", os.path.join(tum_seq, "settings.yaml"), tum_seq,
                          os.path.join(tum_seq, "assoc.txt"), cache,
                          "--segmenter", f"flax:{path}", "--device", "cpu"]) == 0
    names = sorted(os.listdir(cache))
    assert names == [f"{T_EPOCH + i / 30.0:.6f}.png" for i in range(N_FRAMES)]
    seg = tm.build_segmenter(f"flax:{path}", image_hw=HW, device="cpu")
    rgb = png.read(os.path.join(tum_seq, "rgb", names[2]))
    np.testing.assert_array_equal(png.read(os.path.join(cache, names[2])) > 0, seg(rgb) > 0)
    assert os.path.getsize("CameraTrajectory.txt") > 0


def test_evaluate_runs_the_h5_segmenter(h5, tum_seq, tmp_path, monkeypatch, capsys):
    """evaluate --mode geometry --segmenter flax:W.h5 --device cpu on the
    first 4 frames runs to its JSON line."""
    import json

    from gdslam_tpu_torch.cli import evaluate
    path, _, _ = h5
    monkeypatch.chdir(tmp_path)
    assert evaluate.main([tum_seq, os.path.join(tum_seq, "assoc.txt"),
                          os.path.join(tum_seq, "groundtruth.txt"), "--mode", "geometry",
                          "--settings", os.path.join(tum_seq, "settings.yaml"),
                          "--segmenter", f"flax:{path}", "--rpe-delta", "2",
                          "--max-frames", "4", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["associated"] >= 1
