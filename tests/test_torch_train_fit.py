"""Mask R-CNN training in the port against the JAX package, part two: three
steps of train_toy in both packages from the same weights, and weight files
trained by one package loaded by the other's segmenter. The rig and the
tolerances of the single steps are tests/test_torch_train.py's (where the
three steps of train_sampled are too); each test here states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.models import maskrcnn as jm
from gdslam_tpu_torch.models import maskrcnn as tm
from test_torch_train import BLOCKS, HW, KW, _data, _flat, _inputs, _rel, _update_gap, rig  # noqa: F401

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def toy_fits(rig):
    """Three steps of train_toy (clipped Adam, lr 2e-3, calibrating from the
    initial statistics) in both packages."""
    jmodel = rig["jmodel"]
    want = _flat(jm.train_toy(jmodel, rig["v0"], *_data(rig, True), steps=3, lr=2e-3))
    got = tm.train_toy(tm.maskrcnn_from_numpy(_flat(rig["v0"]), HW, BLOCKS, "cpu", **KW),
                       _flat(rig["v0"]), *_data(rig, False), steps=3, lr=2e-3)
    return got, want


def test_train_toy_three_steps_match_jax(rig, toy_fits):
    """After three Adam steps: the parameter updates to 10% of their global
    norm (Adam divides each gradient by its own root mean square, so a
    gradient at the level of rounding, such as a BatchNorm bias's, takes a
    step of the full learning rate in either direction), no parameter more
    than 3 steps x 2 x lr = 0.012 apart; and the trained weights'
    train_losses on image 0 to 2e-2 relative. Adam's first steps move every
    parameter by about lr whatever its gradient, and the loss rises from 15
    to ~1100 in both packages (the JAX train_sampled's docstring measures
    the same); the packages' loss there differs by 0.6% (1e-3, set first,
    failed at that)."""
    got, want = toy_fits
    start = _flat(rig["v0"])
    gap, worst = _update_gap(got, want, start)
    assert gap <= 0.10 and worst <= 0.012, (gap, worst)
    jmodel = rig["jmodel"]
    jl = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jm.MaskRCNN.train_losses))(
        _nested(want), *_inputs(rig, 0, True))
    tl = tm.maskrcnn_from_numpy(got, HW, BLOCKS, "cpu", **KW).train_losses(
        *_inputs(rig, 0, False))
    assert _rel(tl, jl) <= 2e-2, (float(tl), float(jl))


def _nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def test_weight_files_cross_both_ways(rig, toy_fits, tmp_path):
    """A port-trained file (the port's save_variables) loads into the JAX
    build_segmenter and segments; the JAX-trained file loads into the
    port's. On one image both packages' models give the same detections
    from either file: classes and validity equal, boxes to 1e-2 px, masks
    to 1e-3. (One JAX detection program serves both files.)"""
    got, want = toy_fits
    meta = {"blocks": list(BLOCKS), "infer_hw": list(HW)}
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tm.save_variables(got, port_file, meta=meta)
    jm.save_variables(_nested(want), jax_file, meta=meta)
    rgb = rig["images"][0].astype(np.uint8)
    jseg = jm.build_segmenter(f"flax:{port_file}", image_hw=HW)
    assert jseg.infer_hw == HW and np.asarray(jseg(rgb)).shape == HW
    detect = jax.jit(jseg.model.apply)
    for path in (port_file, jax_file):
        tseg = tm.build_segmenter(f"flax:{path}", image_hw=HW, device="cpu")
        assert tseg.infer_hw == HW and tseg.model.blocks == BLOCKS and tseg(rgb).shape == HW
        jdet = detect(jm.load_variables(path), jnp.asarray(rgb, jnp.float32), 0.0)
        with torch.no_grad():
            tdet = tseg.model(torch.from_numpy(rgb.astype(np.float32)), 0.0)
        assert np.array_equal(tdet["classes"].numpy(), np.asarray(jdet["classes"]))
        assert np.array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
        np.testing.assert_allclose(tdet["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=1e-2)
        np.testing.assert_allclose(tdet["masks"].numpy(), np.asarray(jdet["masks"]), atol=1e-3)
