"""The live segmenter of the PyTorch port against the JAX package's, both on
the CPU, at the 120x160 rig of the live-segmenter tests.

    python tools/seg_quality_cpu.py pixels [--frames 4] [--nojit]
    python tools/seg_quality_cpu.py toyfit --package jax|port \
        [--frames-from jax|port] [--noise 0.01] [--init flax|seed] [--driver jax|port]

`pixels` rebuilds the weights of tests/test_torch_segmenter.py (flax init,
class and mask heads edited) and, for each frame asked for, lists every
pixel where the port's mask (TorchSegmenter, CPU) and the JAX segmenter's
(FlaxSegmenter, under jit) differ, with each package's largest pasted value
there (the value before the 0.5 threshold, over the detections that paste
at the pixel) and the detection behind it, whether both NMS calls picked the
same indices, and the largest box and pasted-value differences of the frame.
--nojit also holds the JAX segmenter under jit against itself run op by op.

`toyfit` runs the toy fit of tests/test_live_segmenter_e2e.py (train_toy,
blocks (1, 1, 1, 1), pre/post NMS 256/32, 8 detections, 150 Adam steps at
lr 2e-3) in one package, on the frames of either package's renderer
(--noise adds uniform noise of that many grey levels to the training
images), from the flax init (PRNGKey(0)) or the port's seeded
init_variables, then prints each frame's mask cover, recall and IoU of the
sphere and runs the chosen package's rgbd_tum --segmenter on the 14-frame
sequence: its trajectory rows (the test's gate: >= 11) and ATE. A fit takes
~4 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gdslam_tpu.config import CameraConfig as JaxCamera  # noqa: E402
from gdslam_tpu.io import synthetic as jsyn  # noqa: E402
from gdslam_tpu.models import maskrcnn as jm  # noqa: E402
from gdslam_tpu_torch import CameraConfig  # noqa: E402
from gdslam_tpu_torch.io import png  # noqa: E402
from gdslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from gdslam_tpu_torch.models import maskrcnn as tm  # noqa: E402
from gdslam_tpu_torch.ops import detect_kernels as dk  # noqa: E402
from gdslam_tpu_torch.utils import metrics  # noqa: E402

HW = (120, 160)
N_FRAMES = 14
T_EPOCH = 1305031790.0
CAM = dict(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160, height=120, bf=12.8)
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


def _flat(variables) -> dict:
    return {col + "/" + "/".join(str(k.key) for k in kp): np.asarray(leaf)
            for col, tree in variables.items()
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _frames(which: str) -> list:
    """(rgb float [H, W, 3], dyn_mask bool, T_wc, depth) of the 14 dynamic
    frames of either package's renderer."""
    if which == "jax":
        cam = JaxCamera(**CAM)
        out = [jsyn.render_frame(i, cam, with_dynamic=True) for i in range(N_FRAMES)]
        return [(np.asarray(f.rgb, np.float32), np.asarray(f.dyn_mask), np.asarray(f.T_wc),
                 np.asarray(f.depth)) for f in out]
    cam = CameraConfig(**CAM)
    out = [tsyn.render_frame(i, cam, with_dynamic=True, device="cpu") for i in range(N_FRAMES)]
    return [(f.rgb.numpy().astype(np.float32), f.dyn_mask.numpy(), f.T_wc.numpy(),
             f.depth.numpy()) for f in out]


def _pasted(det: dict) -> tuple[np.ndarray, np.ndarray]:
    """[H, W] largest pasted value over the detections pasting at each pixel
    and the index of that detection (-1 where none pastes)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in det.items()}
    b = t["boxes"][:, :, None, None]
    ys = torch.arange(HW[0], dtype=torch.float32)[None, :, None]
    xs = torch.arange(HW[1], dtype=torch.float32)[None, None, :]
    pastes = dk.paste_ok(t)[:, None, None] & (ys >= b[:, 0]) & (ys < b[:, 2]) & \
        (xs >= b[:, 1]) & (xs < b[:, 3])
    v = torch.where(pastes, dk.paste_values(t, HW), -1.0)
    best, idx = v.max(0)
    return best.clamp(min=0).numpy(), torch.where(best >= 0, idx, -1).numpy()


def pixels(frames_wanted: list, nojit: bool) -> None:
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
    tmp = tempfile.mkdtemp()
    weights = os.path.join(tmp, "seg.npz")
    jm.save_variables({"params": params, "batch_stats": variables["batch_stats"]}, weights,
                      meta={"blocks": [1, 1, 1, 1], "infer_hw": list(HW)})
    jseg = jm.build_segmenter(f"flax:{weights}", image_hw=HW)
    tseg = tm.build_segmenter(f"flax:{weights}", image_hw=HW, device="cpu")
    jp = jm.load_variables(weights)
    picks = []
    real_nms, real_tnms = jm.nms_fixed, dk.nms_fixed

    def spy(boxes, scores, th, n):
        p = real_nms(boxes, scores, th, n)
        jax.debug.callback(lambda q: picks.append(("jax", np.asarray(q))), p)
        return p

    def tspy(*a):
        p = real_tnms(*a)
        picks.append(("port", p.numpy()))
        return p

    jm.nms_fixed, dk.nms_fixed = spy, tspy
    detect = jax.jit(lambda p, im: jseg.model.apply(p, im.astype(jnp.float32)))
    frames = _frames("port")
    try:
        for f in frames_wanted:
            rgb = frames[f][0].astype(np.uint8)
            picks.clear()
            jd = {k: np.asarray(v) for k, v in detect(jp, jnp.asarray(rgb)).items()}
            with torch.no_grad():
                td = {k: v.numpy() for k, v in tseg.detect(torch.from_numpy(rgb)).items()}
            jmask, tmask = np.asarray(jseg(rgb)) > 0.5, tseg(rgb) > 0.5
            jv, jdet = _pasted(jd)
            tv, tdet = _pasted(td)
            both = (jdet >= 0) & (tdet >= 0)
            jpk = [p for w, p in picks if w == "jax"]
            tpk = [p for w, p in picks if w == "port"]
            union = (jmask | tmask).sum()
            rec = dict(frame=f, jax_px=int(jmask.sum()), port_px=int(tmask.sum()),
                       iou=float((jmask & tmask).sum() / union) if union else 1.0,
                       nms_picks_equal=[bool(np.array_equal(a, b)) for a, b in zip(jpk, tpk)],
                       classes_equal=bool(np.array_equal(jd["classes"], td["classes"])),
                       valid_equal=bool(np.array_equal(jd["valid"], td["valid"])),
                       box_max_diff_px=float(np.abs(jd["boxes"] - td["boxes"]).max()),
                       pasted_max_diff=float(np.abs(jv - tv)[both].max()) if both.any() else 0.0,
                       pixels=[])
            for y, x in np.argwhere(jmask != tmask):
                d = int(jdet[y, x])
                rec["pixels"].append(dict(
                    yx=[int(y), int(x)], jax=int(jmask[y, x]), port=int(tmask[y, x]),
                    jax_value=float(jv[y, x]), port_value=float(tv[y, x]), detection=d,
                    jax_box=jd["boxes"][d].tolist() if d >= 0 else None,
                    port_box=td["boxes"][d].tolist() if d >= 0 else None,
                    score=[float(jd["scores"][d]), float(td["scores"][d])] if d >= 0 else None))
            if nojit:
                with jax.disable_jit():
                    nd = {k: np.asarray(v) for k, v in jseg.model.apply(
                        jp, jnp.asarray(rgb, jnp.float32)).items()}
                nv, ndet = _pasted(nd)
                a, b = jv > 0.5, nv > 0.5
                common = (jdet >= 0) & (ndet >= 0)
                rec["jax_jit_vs_op_by_op"] = dict(
                    iou=float((a & b).sum() / max((a | b).sum(), 1)),
                    pasted_max_diff=float(np.abs(jv - nv)[common].max()) if common.any() else 0.0,
                    box_max_diff_px=float(np.abs(jd["boxes"] - nd["boxes"]).max()))
            print(json.dumps(rec), flush=True)
    finally:
        jm.nms_fixed, dk.nms_fixed = real_nms, real_tnms
        shutil.rmtree(tmp)


def _write_sequence(root: str, frames) -> None:
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub))
    assoc = []
    for i, (rgb, _, _, depth) in enumerate(frames):
        name = f"{T_EPOCH + i / 30.0:.6f}.png"
        png.write(os.path.join(root, "rgb", name), rgb.astype(np.uint8))
        png.write(os.path.join(root, "depth", name), (depth * 5000.0).astype(np.uint16))
        assoc.append(f"{name[:-4]} rgb/{name} {name[:-4]} depth/{name}")
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write(SETTINGS_YAML)


def toyfit(package: str, frames_from: str, noise: float, init: str, driver: str) -> None:
    frames = _frames(frames_from)
    r = np.random.default_rng(1)
    imgs, boxes, masks = [], [], []
    for rgb, dyn, _, _ in frames:
        ys, xs = np.nonzero(dyn)
        imgs.append(rgb + (r.uniform(-noise, noise, rgb.shape).astype(np.float32)
                           if noise else 0))
        boxes.append([[float(ys.min()), float(xs.min()), float(ys.max() + 1),
                       float(xs.max() + 1)]])
        masks.append(dyn.astype(np.float32))
    imgs, boxes, masks = np.stack(imgs), np.asarray(boxes, np.float32), np.stack(masks)
    classes, valids = np.ones((N_FRAMES, 1), np.int32), np.ones((N_FRAMES, 1), bool)
    jmodel = jm.MaskRCNN(image_hw=HW, blocks=(1, 1, 1, 1), pre_nms=256, post_nms=32, max_det=8)
    if init == "flax":
        start = _flat(jmodel.init(jax.random.PRNGKey(0), jnp.zeros(HW + (3,))))
    else:
        start = tm.init_variables((1, 1, 1, 1), 0)
    if package == "jax":
        nested: dict = {}
        for k, v in start.items():
            *path, leaf = k.split("/")
            node = nested
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        trained = _flat(jm.train_toy(jmodel, nested, jnp.asarray(imgs), jnp.asarray(boxes),
                                     jnp.asarray(classes), jnp.asarray(masks),
                                     jnp.asarray(valids), steps=150, lr=2e-3))
    else:
        model = tm.maskrcnn_from_numpy(start, HW, (1, 1, 1, 1), "cpu", pre_nms=256,
                                       post_nms=32, max_det=8)
        trained = tm.train_toy(model, start, imgs, boxes, classes, masks, valids, steps=150,
                               lr=2e-3)
    tmp = tempfile.mkdtemp()
    try:
        weights = os.path.join(tmp, "toy.npz")
        tm.save_variables(trained, weights, meta={"blocks": [1, 1, 1, 1], "infer_hw": list(HW)})
        seq = os.path.join(tmp, "seq")
        _write_sequence(seq, frames)
        cache, run = os.path.join(tmp, "cache"), os.path.join(tmp, "run")
        os.makedirs(run)
        old = os.getcwd()
        os.chdir(run)
        try:
            argv = ["none", os.path.join(seq, "settings.yaml"), seq,
                    os.path.join(seq, "assoc.txt"), cache, "--segmenter", f"flax:{weights}"]
            if driver == "jax":
                from gdslam_tpu.cli import rgbd_tum
                rc = rgbd_tum.main(argv)
            else:
                from gdslam_tpu_torch.cli import rgbd_tum
                rc = rgbd_tum.main(argv + ["--device", "cpu"])
            rows = [ln.split() for ln in open("CameraTrajectory.txt").read().strip().splitlines()
                    if ln.strip()]
        finally:
            os.chdir(old)
        cover, recall, iou = [], [], []
        for i, (_, dyn, _, _) in enumerate(frames):
            m = png.read(os.path.join(cache, f"{T_EPOCH + i / 30.0:.6f}.png")) > 127
            cover.append(float(m.mean()))
            recall.append(float((m & dyn).sum() / dyn.sum()))
            iou.append(float((m & dyn).sum() / (m | dyn).sum()))
        ate = None
        if rows:
            T0 = np.linalg.inv(frames[0][2])
            est = np.array([[float(x) for x in row[1:4]] for row in rows])
            gt = np.array([(T0 @ frames[round((float(row[0]) - T_EPOCH) * 30.0)][2])[:3, 3]
                           for row in rows])
            ate = float(metrics.ate_rmse(est, gt))
        print(json.dumps(dict(package=package, frames_from=frames_from, noise=noise, init=init,
                              driver=driver, rc=rc, rows=len(rows), ate_m=ate,
                              sphere_cover=[float(f[1].mean()) for f in frames],
                              mask_cover=cover, recall=recall, iou=iou,
                              recall_mean=float(np.mean(recall)))), flush=True)
    finally:
        shutil.rmtree(tmp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pixels")
    p.add_argument("--frames", type=int, nargs="*", default=list(range(N_FRAMES)))
    p.add_argument("--nojit", action="store_true")
    t = sub.add_parser("toyfit")
    t.add_argument("--package", choices=("jax", "port"), required=True)
    t.add_argument("--frames-from", choices=("jax", "port"), default="port")
    t.add_argument("--noise", type=float, default=0.0)
    t.add_argument("--init", choices=("flax", "seed"), default="flax")
    t.add_argument("--driver", choices=("jax", "port"), default="port")
    opts = ap.parse_args()
    torch.set_num_threads(1)          # as the tests run the port
    if opts.cmd == "pixels":
        pixels(opts.frames, opts.nojit)
    else:
        toyfit(opts.package, opts.frames_from, opts.noise, opts.init, opts.driver)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
