"""The port's draw (gdslam_tpu_torch.ops.draw_kernel, the plain twin of
csrc/categorical_draw.cu) against jax.random: the keys (split, fold_in),
jax.random.categorical's indices at the GD RANSAC's shape, the staged
masker's split chain, and the RANSACs under PRNGKey(frame_id) against the
same RANSAC fed the JAX draw. The draws are made with no JAX compile beyond
jax.random's own; tests/test_torch_cuda.py holds the kernel to the twin on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.masking import geomask as jgeo
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import solvers as tsolvers
from gdslam_tpu_torch.core import prng
from gdslam_tpu_torch.masking import geomask as tgeo
from gdslam_tpu_torch.ops import cuda_build
from gdslam_tpu_torch.ops import draw_kernel as dkw
from gdslam_tpu_torch.system import slam as tslam
from test_torch_solvers import K, _jax_draw, _scene

# One torch thread per test process: xdist's six workers share the cores,
# and eight spinning OpenMP threads in each ran these tests twice as slow.
torch.set_num_threads(1)

ROWS, N = 900, 384          # the GD RANSAC's 300 x 3 rows over a cut match set


def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(key))


def test_split_chain_matches_jax():
    """prng.split is jax.random.split (the partitionable layout) along a
    chain of 12, the staged masker's `key, k = split(key)`."""
    kj, kt = jax.random.PRNGKey(7), prng.prng_key(7)
    for _ in range(12):
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        assert _words(kj) == _words(kt) and _words(sj) == _words(st)
    assert [_words(k) for k in jax.random.split(jax.random.PRNGKey(3), 4)] == \
        [_words(k) for k in prng.split(prng.prng_key(3), 4)]


@pytest.mark.parametrize("share", [0.0, 0.07, 0.5, 1.0])
def test_categorical_draw_plain_matches_jax(share):
    """The plain draw gives jax.random.categorical's indices at 900 x 384 on
    several keys, over logits uniform on a share of valid rows (none valid:
    uniform over all, as log(p + 1e-12) makes it): the key as the port's
    host pair, as the JAX key's words, and folded from a frame-id tensor
    (the fast path's fold_in(PRNGKey(7), frame_id)); the noise is the
    numpy reference's to an ulp or two of log."""
    r = np.random.default_rng(int(share * 100))
    for frame_id in (0, 5, 123, 2 ** 31 + 9):
        valid = r.random(N) < share
        p = jnp.asarray(valid, jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
        key = jax.random.fold_in(jax.random.PRNGKey(7), frame_id)
        want = np.asarray(jax.random.categorical(key, jnp.log(p + 1e-12)[None].repeat(ROWS, 0)))
        v = torch.from_numpy(valid)
        got = [dkw.uniform_over(prng.fold_in(prng.prng_key(7), frame_id), v, ROWS),
               dkw.uniform_over(_words(key), v, ROWS),
               dkw.uniform_over(prng.prng_key(7), v, ROWS,
                                fold=torch.tensor([frame_id], dtype=torch.int64))]
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
        if valid.any():
            assert valid[want].all()
    noise = torch.empty(ROWS, N)
    dkw.categorical_draw(prng.prng_key(7), torch.zeros(N), ROWS, noise=noise)
    np.testing.assert_allclose(noise.numpy(), prng.gumbel(prng.prng_key(7), (ROWS, N)),
                               rtol=0, atol=4e-6)


def test_staged_masker_key_chain_matches_jax(monkeypatch):
    """The staged GeoMaskMaker splits its key, from PRNGKey(7), on each
    get_mask that reaches gd_step and draws under the second half, as the
    JAX GeoMaskMaker does; warm-up frames split nothing. Both makers see the
    same ring (placeholder features, gd_step and the extractor stubbed)."""
    keys = {"jax": [], "port": []}

    def stub(side):
        def gd_step(cur_gray, cur_depth, sem_mask, ref_gray, ref_depth, ref_feats, *rest):
            key = rest[0] if side == "jax" else rest[1]
            keys[side].append(_words(key) if side == "jax" else tuple(int(x) for x in key))
            return "feats", sem_mask
        return gd_step

    monkeypatch.setattr(jgeo, "gd_step", stub("jax"))
    monkeypatch.setattr(tgeo, "gd_step", stub("port"))
    monkeypatch.setattr(jgeo.extractor, "extract", lambda *a, **k: "feats")
    monkeypatch.setattr(tgeo.extractor, "extract", lambda *a, **k: "feats")
    jm, tm = jgeo.GeoMaskMaker(_jax_cfg()), tgeo.GeoMaskMaker(_port_cfg())
    for i in range(14):
        img = np.full((4, 4), i, np.float32)
        jm.add_new_image(img, img, None)
        tm.add_new_image(torch.from_numpy(img), torch.from_numpy(img))
        jm.get_mask(np.ones((4, 4)))
        tm.get_mask(torch.ones(4, 4))
    assert len(keys["jax"]) == 14 - 5 and keys["port"] == keys["jax"]
    assert _words(jm._key) == tuple(int(x) for x in tm._key)


def _jax_cfg():
    from gdslam_tpu.config import SlamConfig
    return SlamConfig()


def _port_cfg():
    import dataclasses
    return convert.config_from_jax_dict(dataclasses.asdict(_jax_cfg()))


@pytest.mark.parametrize("frame_id", [3, 41])
def test_relocalization_ransacs_draw_under_the_frame_key(frame_id):
    """ransac_pnp and ransac_rigid under PRNGKey(frame_id), relocalization's
    key in the JAX package, equal the same RANSAC fed the JAX draw."""
    pw, T, pc, uv, valid, _ = _scene(frame_id)
    t = [torch.from_numpy(a) for a in (pw, pc, uv, valid)]
    jkey = jax.random.PRNGKey(frame_id)
    for fn, args, size in ((tsolvers.ransac_pnp, (t[0], t[2], t[3], K), 6),
                           (tsolvers.ransac_rigid, (t[0], t[1], t[3], K, t[2]), 3)):
        drawn = fn(*args, key=prng.prng_key(frame_id))
        fed = fn(*args, sample_idx=torch.from_numpy(np.array(_jax_draw(jkey, valid, 300, size))))
        a, b = convert.ransac_result_to_numpy(drawn), convert.ransac_result_to_numpy(fed)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fn.__name__} {k}")
        assert bool(a["ok"])


def test_packed_upload_carries_the_frame_id():
    """The GD fast path's upload buffer keeps the frame id as an int64 at an
    8-byte boundary after the image planes; packed_frame_id views it on the
    device, and the image planes unpack as before."""
    for H, W in ((480, 640), (7, 9)):
        gray = np.random.default_rng(0).integers(0, 256, (H, W), dtype=np.uint8)
        depth = np.random.default_rng(1).integers(0, 65535, (H, W), dtype=np.uint16)
        packed = tslam.PackedUpload(H, W, torch.device("cpu"))(gray, depth, 2 ** 33 + 17)
        assert packed.numel() == tslam.packed_nbytes(H, W) and packed.numel() % 8 == 0
        fid = tslam.packed_frame_id(packed, H, W)
        assert fid.dtype == torch.int64 and fid.tolist() == [2 ** 33 + 17]
        g, d = tslam.unpack_gd_frame(packed, H, W, 1.0)
        np.testing.assert_array_equal(g.numpy(), gray)
        np.testing.assert_array_equal(d.numpy()[::2, ::2], depth[::2, ::2])


def test_draw_wrapper_raises_on_cuda_tensors_without_the_library(monkeypatch):
    """categorical_draw, like the other wrappers: for CUDA tensors it
    launches or raises, with no library it raises and counts no launch, a
    wrong dtype is refused, and it never takes the plain version. Fake CUDA
    tensors stand in for a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def missing(name, declare):
        raise RuntimeError(f"{name}: library missing")

    monkeypatch.setattr(cuda_build, "load", missing)
    monkeypatch.setattr(dkw, "categorical_draw_plain",
                        lambda *a, **k: pytest.fail("fell back to the plain version"))
    before = dkw.categorical_draw.launches
    with FakeTensorMode():
        logits = torch.empty(1500, dtype=torch.float32, device="cuda")
        fold = torch.empty(1, dtype=torch.int64, device="cuda")
        with pytest.raises(RuntimeError, match="categorical_draw: library missing"):
            dkw.categorical_draw(prng.prng_key(7), logits, 900, fold)
        with pytest.raises(ValueError, match="logits"):
            dkw.categorical_draw(prng.prng_key(7), logits.double(), 900)
        with pytest.raises(ValueError, match="fold"):
            dkw.categorical_draw(prng.prng_key(7), logits, 900, fold.int())
    assert dkw.categorical_draw.launches == before
