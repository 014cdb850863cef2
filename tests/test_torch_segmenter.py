"""The port's live segmenter (gdslam_tpu_torch.models.maskrcnn.build_segmenter,
TorchSegmenter) and `--segmenter` in both port drivers, held against the JAX
package's segmenter on the same weight file.

No toy training (the JAX recipe of tests/test_live_segmenter_e2e.py costs
minutes): a flax-initialised blocks (1, 1, 1, 1) model at 120 x 160 whose
class head is edited before it is written with the JAX save_variables. Raw
flax-init class logits spread over ~50 per row, so every proposal would
score ~1 as a random class; the kernel is scaled by 0.01 and bias[1]
(person, a dynamic class) raised by 6, after which all 32 detections score
as person at ~0.85, distinct. The person channel of the mask head's last
bias is lowered by 1, so that the masks cover 0-4% of a frame: as written by
the flax init they reach 10.8% on frame 9, and there both packages' drivers
(pipelined, the geometry route) lose the track and reset, while the same
masks not pipelined track every frame (ROADMAP.md section 3).
The port on the CPU and the JAX segmenter (under jit) give the same
detections (classes and validity equal on every frame); their pasted mask
values differ by rounding only (at most 0.012
on these 14 frames: the JAX program contracts ROIAlign's arithmetic into
fused multiply-adds, the boxes agree to 0.03 px, and some boxes are under a
pixel high, where that is a large part of a mask cell). So the masks are
held by a rule rounding cannot break: equal on every pixel whose JAX pasted
value lies more than PASTE_DELTA from the 0.5 threshold, and IoU >= 0.95 on
every frame where either mask holds at least 100 pixels. (On frame 4, 19
pixels, one pixel whose JAX value is 0.50061 and the port's 0.49886 alone
moves the IoU to 0.947; the JAX segmenter against itself without jit gives
0.95 there.)
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gdslam_tpu.models import maskrcnn as jm
from gdslam_tpu.system import trajectory as jtraj
from gdslam_tpu_torch import CameraConfig
from gdslam_tpu_torch.io import png
from gdslam_tpu_torch.io import synthetic as tsyn
from gdslam_tpu_torch.masking.masknet import SegmentDynObject
from gdslam_tpu_torch.models import maskrcnn as tm
from gdslam_tpu_torch.ops import detect_kernels as dk
from gdslam_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

SCAM = CameraConfig(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120,
                    bf=160.0 * 0.08)
HW = (120, 160)
N_FRAMES = 14
PASTE_DELTA = 0.05      # 4x the largest port-to-JAX pasted-value difference here
IOU_MIN_PX = 100        # frames with a mask this large keep the IoU >= 0.95 gate
T_EPOCH = 1305031790.0
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


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """A 14-frame TUM-layout sequence of the dynamic scene (as the JAX live
    segmenter test writes it), the weight file, and the JAX segmenter's mask
    of every frame."""
    root = tmp_path_factory.mktemp("live_seg")
    for sub in ("rgb", "depth"):
        os.makedirs(root / sub)
    frames, assoc, gts = [], [], []
    for i in range(N_FRAMES):
        # the port's renderer (a copy of the JAX one, held to it in
        # tests/test_torch_package.py): no XLA compile; both packages read
        # the same PNGs
        fr = tsyn.render_frame(i, SCAM, with_dynamic=True, device="cpu")
        ts = T_EPOCH + i / 30.0
        name = f"{ts:.6f}.png"
        rgb = fr.rgb.numpy().astype(np.uint8)
        Image.fromarray(rgb).save(root / "rgb" / name)
        Image.fromarray((fr.depth.numpy() * 5000.0).astype(np.uint16)).save(
            root / "depth" / name)
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        frames.append(rgb)
        gts.append(fr.T_wc.numpy().astype(np.float64))
    (root / "assoc.txt").write_text("\n".join(assoc) + "\n")
    (root / "settings.yaml").write_text(SETTINGS_YAML)
    jtraj.save_tum(str(root / "groundtruth.txt"),
                   [(T_EPOCH + i / 30.0, g) for i, g in enumerate(gts)])

    model = jm.MaskRCNN(image_hw=HW, blocks=(1, 1, 1, 1))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(HW + (3,)))
    head = dict(variables["params"]["box_head"]["Dense_2"])
    head["kernel"] = head["kernel"] * 0.01
    head["bias"] = head["bias"].at[1].add(6.0)
    mask = dict(variables["params"]["mask_head"]["Conv_4"])
    mask["bias"] = mask["bias"].at[1].add(-1.0)
    params = {**variables["params"],
              "box_head": {**variables["params"]["box_head"], "Dense_2": head},
              "mask_head": {**variables["params"]["mask_head"], "Conv_4": mask}}
    weights = str(root / "seg.npz")
    jm.save_variables({"params": params, "batch_stats": variables["batch_stats"]}, weights,
                      meta={"blocks": [1, 1, 1, 1], "infer_hw": list(HW)})
    jseg = jm.build_segmenter(f"flax:{weights}", image_hw=HW)
    masks = [np.asarray(jseg(rgb)) for rgb in frames]
    detect = jax.jit(jseg.model.apply)
    p = jm.load_variables(weights)
    values = [_pasted_value({k: np.asarray(v) for k, v in
                             detect(p, jnp.asarray(rgb, jnp.float32)).items()}) for rgb in frames]
    return str(root), frames, gts, weights, list(zip(masks, values))


def _pasted_value(det) -> np.ndarray:
    """[H, W]: the largest pasted mask value (before the 0.5 threshold) of
    the detections that paste at each pixel (0 where none does), computed
    from the JAX segmenter's detections with the port's plain paste
    arithmetic (held to the JAX paste_masks in tests/test_torch_maskrcnn.py)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in det.items()}
    b = t["boxes"][:, :, None, None]
    ys = torch.arange(HW[0], dtype=torch.float32)[None, :, None]
    xs = torch.arange(HW[1], dtype=torch.float32)[None, None, :]
    inside = (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3])
    pastes = dk.paste_ok(t)[:, None, None] & inside
    return torch.where(pastes, dk.paste_values(t, HW), 0.0).amax(0).numpy()


def _iou(a, b) -> float:
    a, b = a > 0.5, b > 0.5
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 1.0


def _hold_to_jax(masks, want):
    """Against the JAX segmenter's (mask, pasted value) of each frame: equal
    on every pixel whose JAX pasted value lies more than PASTE_DELTA from
    0.5; IoU >= 0.95 where either mask holds IOU_MIN_PX pixels; at least
    half the frames non-empty."""
    for i, (m, (w, value)) in enumerate(zip(masks, want)):
        off = ((m > 0.5) != (w > 0.5)) & (np.abs(value - 0.5) > PASTE_DELTA)
        assert not off.any(), (i, np.argwhere(off)[:8].tolist(), value[off][:8])
        if max((m > 0.5).sum(), (w > 0.5).sum()) >= IOU_MIN_PX:
            assert _iou(m, w) >= 0.95, (i, _iou(m, w))
    assert sum((m > 0.5).any() for m in masks) >= len(masks) / 2


def test_segmenter_matches_jax_segmenter(seq):
    """build_segmenter("flax:W.npz") on the CPU on the first frames (the
    driver test below takes all 14): the meta's blocks and inference size,
    float32 [H, W] masks, the JAX segmenter's masks; every detection of the
    first frame is a valid person."""
    _, frames, _, weights, want = seq
    seg = tm.build_segmenter(f"flax:{weights}", image_hw=HW, device="cpu")
    assert seg.infer_hw == HW and seg.model.blocks == (1, 1, 1, 1)
    masks = [seg(rgb) for rgb in frames[:4]]
    assert all(m.dtype == np.float32 and m.shape == HW for m in masks)
    _hold_to_jax(masks, want[:4])
    with torch.no_grad():
        det = seg.model(torch.from_numpy(frames[0].astype(np.float32)))
    assert det["valid"].all() and (det["classes"] == 1).all()
    assert len(set(det["scores"].tolist())) > 16 and (det["scores"] > 0.7).all()


def test_rgbd_tum_runs_the_live_segmenter(seq, tmp_path, monkeypatch):
    """rgbd_tum ... MASKS --segmenter flax:W.npz --device cpu: every frame
    misses the empty cache, runs the net and is written back; the cached
    masks are the JAX segmenter's (by _hold_to_jax's rule); the geometry path tracks
    to the JAX driver test's gate, ATE < 0.30 m."""
    from gdslam_tpu_torch.cli import rgbd_tum
    seq_dir, _, gts, weights, want = seq
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "mask_cache")
    assert rgbd_tum.main(["none", os.path.join(seq_dir, "settings.yaml"), seq_dir,
                          os.path.join(seq_dir, "assoc.txt"), cache,
                          "--segmenter", f"flax:{weights}", "--device", "cpu"]) == 0
    names = sorted(os.listdir(cache))
    assert names == [f"{T_EPOCH + i / 30.0:.6f}.png" for i in range(N_FRAMES)]
    _hold_to_jax([png.read(os.path.join(cache, n)) / 255.0 for n in names], want)
    rows = [r.split() for r in open("CameraTrajectory.txt").read().strip().splitlines()]
    assert len(rows) >= N_FRAMES - 3
    est = np.array([[float(x) for x in r[1:4]] for r in rows])
    gt = np.array([(np.linalg.inv(gts[0]) @ gts[round((float(r[0]) - T_EPOCH) * 30.0)])[:3, 3]
                   for r in rows])
    assert tmetrics.ate_rmse(est, gt) < 0.30


def test_evaluate_runs_the_live_segmenter(seq, tmp_path, monkeypatch, capsys):
    """evaluate --mode geometry --segmenter flax:W.npz --device cpu with no
    mask directory on the first 6 frames: the net runs on every frame,
    nothing is written, and the run ends with its JSON line inside the same
    gate."""
    from gdslam_tpu_torch.cli import evaluate
    seq_dir, _, _, weights, _ = seq
    monkeypatch.chdir(tmp_path)
    calls = []
    real = SegmentDynObject.get_segmentation

    def spy(self, rgb, name="", cache_dir=None):
        calls.append(name)
        return real(self, rgb, name, cache_dir)

    monkeypatch.setattr(SegmentDynObject, "get_segmentation", spy)
    assert evaluate.main([seq_dir, os.path.join(seq_dir, "assoc.txt"),
                          os.path.join(seq_dir, "groundtruth.txt"), "--mode", "geometry",
                          "--settings", os.path.join(seq_dir, "settings.yaml"),
                          "--segmenter", f"flax:{weights}", "--rpe-delta", "5",
                          "--max-frames", "6", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == 6 and os.listdir(tmp_path) == []
    assert rec["associated"] >= 6 - 3 and rec["ate_rmse_m"] < 0.30


def test_segmenter_specs():
    """'flax' builds the ResNet50 model on seeded random weights and warns;
    'flax:W.h5' goes to the Keras converter (a file that is not there fails
    to open; tests/test_torch_maskrcnn_h5.py converts one); other specs are
    refused. A large frame is molded to half size."""
    with pytest.warns(UserWarning, match="randomly initialized"):
        seg = tm.build_segmenter("flax", image_hw=HW, device="cpu")
    assert seg.model.blocks == (3, 4, 6, 3) and seg.infer_hw == HW
    out = seg(np.zeros(HW + (3,), np.float32))
    assert out.shape == HW and out.dtype == np.float32
    with pytest.raises(FileNotFoundError):
        tm.build_segmenter("flax:mask_rcnn_coco.h5", device="cpu")
    with pytest.raises(ValueError, match="unknown segmenter"):
        tm.build_segmenter("detectron", device="cpu")
    assert tm.default_infer_hw((480, 640)) == (240, 320)
    assert tm.default_infer_hw(HW) == HW


def test_mold_resize_matches_jax():
    """The inference resize: 480 x 640 uint8 to 240 x 320 with the
    antialiased bilinear of jax.image.resize, to 1e-4 grey levels."""
    rgb = np.random.default_rng(0).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(rgb, jnp.float32), (240, 320, 3),
                                       "bilinear"))
    got = tm.mold(torch.from_numpy(rgb), (240, 320)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_segment_dyn_object_warms_the_live_net_up(seq, tmp_path):
    """The bridge runs the segmenter once on a zero image at construction
    (MaskNet.cc:45-48) and then on every cache miss, writing masks back."""
    _, frames, _, weights, want = seq
    seg = tm.build_segmenter(f"flax:{weights}", image_hw=HW, device="cpu")
    calls = []
    real = seg.segment

    def count(t):
        calls.append(tuple(t.shape))
        return real(t)

    seg.segment = count
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bridge = SegmentDynObject(seg, cache_dir=str(tmp_path / "c"))
    assert calls == [HW + (3,)]
    m = bridge.get_segmentation(frames[3], "f3")
    assert len(calls) == 2 and _iou(m, want[3][0]) >= 0.95
    assert np.array_equal(bridge.get_segmentation(frames[3], "f3"), m) and len(calls) == 2
