"""Parity of the port's vocabulary and keyframe database
(gdslam_tpu_torch.backend.{vocabulary, keyframe_db}) with the JAX package on
the CPU, the counterparts of tests/test_loop.py's vocabulary and database
checks and of tests/test_vocab_retrieval.py, and the port's own copy of the
shipped vocabulary."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdslam_tpu.backend import keyframe_db as jkdb
from gdslam_tpu.backend import map_arena as jma
from gdslam_tpu.backend import vocabulary as jvoc
from gdslam_tpu.config import CameraConfig, OrbConfig
from gdslam_tpu.frontend import extractor as jext
from gdslam_tpu.io import synthetic as jsyn
from gdslam_tpu_torch import convert
from gdslam_tpu_torch.backend import keyframe_db as tkdb
from gdslam_tpu_torch.backend import map_arena as tma
from gdslam_tpu_torch.backend import vocabulary as tvoc
from gdslam_tpu_torch.config import CameraConfig as TCameraConfig
from gdslam_tpu_torch.config import OrbConfig as TOrbConfig
from gdslam_tpu_torch.frontend import extractor as text

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CAM = CameraConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
                   bf=260.0 * 0.08)
ORB = OrbConfig(n_features=512, n_levels=4)
TCAM = TCameraConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240,
                     bf=260.0 * 0.08)
TORB = TOrbConfig(n_features=512, n_levels=4)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def vocabs():
    """The same small vocabulary trained by both packages (numpy k-medians
    with the same seed), and the shipped default of each."""
    descs = np.random.default_rng(0).integers(0, 256, (3000, 32)).astype(np.uint8)
    return (jvoc.train(descs, k=5, levels=2, iters=5), tvoc.train(descs, k=5, levels=2, iters=5),
            jvoc.default_vocabulary(), tvoc.default_vocabulary())


def test_shipped_vocabulary_is_the_jax_packages_file():
    """gdslam_tpu_torch/data/vocab_default.npz is a byte copy of the JAX
    package's (the port reads no path inside gdslam_tpu/), at >= 10^4 leaves
    (test_default_vocab_scale)."""
    mine = (ROOT / "gdslam_tpu_torch" / "data" / "vocab_default.npz").read_bytes()
    ref = (ROOT / "gdslam_tpu" / "data" / "vocab_default.npz").read_bytes()
    assert hashlib.sha256(mine).hexdigest() == hashlib.sha256(ref).hexdigest()
    assert Path(tvoc.DEFAULT_PATH).resolve() == ROOT / "gdslam_tpu_torch" / "data" / \
        "vocab_default.npz"
    assert tvoc.default_vocabulary().n_leaves >= 10_000


def test_train_and_transform_match_jax(vocabs):
    """The trained tree is the same, and the words of random and of real
    descriptors are exactly the JAX walk's (ties keep the lowest child)."""
    jv, tv, jd, td = vocabs
    np.testing.assert_array_equal(tv.centers.numpy(), np.asarray(jv.centers))
    assert (tv.k, tv.levels, tv.n_leaves) == (jv.k, jv.levels, jv.n_leaves)
    rng = np.random.default_rng(1)
    d = rng.integers(0, 256, (300, 32)).astype(np.uint8)
    d[100:110] = d[100]                      # repeated rows
    d[110] = 0
    for j, tt in ((jv, tv), (jd, td)):
        wj = np.asarray(jvoc.transform(jnp.asarray(d), j.centers, j.k, j.levels))
        wt = tvoc.transform(t(d), tt.centers, tt.k, tt.levels).numpy()
        np.testing.assert_array_equal(wt, wj)
        assert wt.max() < tt.n_leaves
    # descriptors of a rendered view, through the default vocabulary
    fr = jsyn.render(jnp.asarray(jvoc.random_pose(np.random.default_rng(4)), jnp.float32), CAM,
                     False)
    f = jext.extract(fr.gray, ORB, CAM.height, CAM.width)
    wj = np.asarray(jvoc.transform(f.desc, jd.centers, jd.k, jd.levels))
    wt = tvoc.transform(t(np.asarray(f.desc)), td.centers, td.k, td.levels).numpy()
    np.testing.assert_array_equal(wt, wj)


def test_bow_vector_and_scores_match_jax(vocabs):
    """bow_vector exact; l1_score and query_scores to 1e-6 (a sum of 10^4
    terms in another order); the self score is 1 (test_identical_sets_score_one)
    and a perturbed set beats a random one (test_similar_beats_random)."""
    _, _, jd, td = vocabs
    rng = np.random.default_rng(2)
    d1 = rng.integers(0, 256, (200, 32)).astype(np.uint8)
    d2 = d1.copy()
    d2[:, 0] ^= 1
    d3 = rng.integers(0, 256, (200, 32)).astype(np.uint8)
    valid = rng.random(200) < 0.9
    vj, vt = [], []
    for d in (d1, d2, d3):
        wj = jvoc.transform(jnp.asarray(d), jd.centers, jd.k, jd.levels)
        vj.append(jvoc.bow_vector(wj, jnp.asarray(valid), jd.n_leaves))
        wt = tvoc.transform(t(d), td.centers, td.k, td.levels)
        vt.append(tvoc.bow_vector(wt, t(valid), td.n_leaves))
        np.testing.assert_array_equal(vt[-1].numpy(), np.asarray(vj[-1]))
    assert abs(float(tvoc.l1_score(vt[0], vt[0])) - 1.0) < 1e-6
    s_sim, s_rand = float(tvoc.l1_score(vt[0], vt[1])), float(tvoc.l1_score(vt[0], vt[2]))
    assert s_sim > s_rand
    np.testing.assert_allclose(s_sim, float(jvoc.l1_score(vj[0], vj[1])), atol=1e-6)
    dbj = jkdb.new_db(8, 200, jd.n_leaves)
    dbt = tkdb.new_db(8, 200, td.n_leaves, "cpu")
    for k in range(3):
        w = jvoc.transform(jnp.asarray((d1, d2, d3)[k]), jd.centers, jd.k, jd.levels)
        dbj = jkdb.db_add(dbj, jnp.asarray(k), vj[k], w)
        dbt = tkdb.db_add(dbt, k, vt[k], t(np.asarray(w)))
    for f in ("words", "valid"):
        np.testing.assert_array_equal(getattr(dbt, f).numpy(), np.asarray(getattr(dbj, f)))
    sj, st = jkdb.query_scores(dbj, vj[1]), tkdb.query_scores(dbt, vt[1])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    assert int(st.argmax()) in (0, 1) and float(st[4]) == -1.0      # empty slots masked
    rt = convert.bow_db_to_numpy(convert.bow_db_from_numpy(convert.bow_db_to_numpy(dbt), "cpu"))
    for f in rt:
        np.testing.assert_array_equal(rt[f], getattr(dbt, f).numpy())


def _constructed_db(vocab_n_leaves: int):
    """test_group_scoring_beats_direct_topk's database: keyframe 5 scores
    best alone, keyframes 1-3 are mutually covisible and score a little
    less; plus a few more covisibility edges for the loop query."""
    K, nl = 8, vocab_n_leaves
    vecs = np.zeros((K, nl), np.float32)
    for k, s in ((5, 0.9), (1, 0.6), (2, 0.6), (3, 0.6), (0, 0.3), (4, 0.2), (6, 0.45)):
        vecs[k, 0], vecs[k, 1] = s, 1.0 - s
    valid = np.asarray([True] * 7 + [False])
    covis = np.zeros((K, K), np.int32)
    for a in (1, 2, 3):
        for b in (1, 2, 3):
            if a != b:
                covis[a, b] = 100
    covis[6, 0] = covis[0, 6] = 20
    covis[6, 4] = covis[4, 6] = 8
    words = -np.ones((K, 16), np.int32)
    return vecs, valid, covis, words


def test_candidates_and_group_accumulation_match_jax(vocabs):
    """reloc_candidates and loop_candidates give the JAX ids exactly on a
    database where the group rule and the direct top-1 disagree, and
    _group_accumulate the same members; the group's best member wins
    (test_group_scoring_beats_direct_topk)."""
    _, _, jd, _ = vocabs
    vecs, valid, covis, words = _constructed_db(jd.n_leaves)
    K = len(valid)
    dbj = jkdb.BowDatabase(vectors=jnp.asarray(vecs), words=jnp.asarray(words),
                           valid=jnp.asarray(valid))
    dbt = tkdb.BowDatabase(vectors=t(vecs), words=t(words), valid=t(valid))
    aj = jma.new_arena(K, 64, 16)._replace(covis=jnp.asarray(covis), kf_valid=jnp.asarray(valid))
    at = tma.new_arena(K, 64, 16, "cpu")._replace(covis=t(covis), kf_valid=t(valid))
    q = np.zeros(jd.n_leaves, np.float32)
    q[0] = 1.0
    ij, sj, okj = jkdb.reloc_candidates(dbj, aj, jnp.asarray(q))
    it, st, okt = tkdb.reloc_candidates(dbt, at, t(q))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    assert int(it[0]) in (1, 2, 3)
    for kf in range(7):
        ij, sj, mj = jkdb.loop_candidates(dbj, aj, jnp.asarray(kf))
        it, st, mt = tkdb.loop_candidates(dbt, at, kf)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
        np.testing.assert_allclose(float(mt), float(mj), atol=1e-6)
    scores = np.asarray(jkdb.query_scores(dbj, jnp.asarray(q)))
    elig = valid & (scores > 0)
    accj, bestj = jkdb._group_accumulate(jnp.asarray(scores), jnp.asarray(elig),
                                         jnp.asarray(covis), jnp.asarray(valid))
    acct, bestt = tkdb._group_accumulate(t(scores), t(elig), t(covis), t(valid))
    np.testing.assert_array_equal(bestt.numpy(), np.asarray(bestj))
    np.testing.assert_allclose(acct.numpy(), np.asarray(accj), atol=1e-6)


def test_save_load_and_orbvoc_text_match_jax(vocabs, tmp_path):
    """save / load round trip (test_save_load_roundtrip), the npz readable
    by the other package, and a DBoW2 text vocabulary with an incomplete
    tree read into the same complete array."""
    jv, tv, _, _ = vocabs
    tvoc.save(tv, str(tmp_path / "t.npz"))
    back = tvoc.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.centers.numpy(), tv.centers.numpy())
    assert (back.k, back.levels) == (tv.k, tv.levels)
    np.testing.assert_array_equal(np.asarray(jvoc.load(str(tmp_path / "t.npz")).centers),
                                  tv.centers.numpy())
    rng = np.random.default_rng(3)
    lines = ["3 2 0 0"]
    nid = 0
    for parent, kids in ((0, 3), (1, 2), (2, 3), (3, 0)):      # node 3 has no children
        for _ in range(kids):
            nid += 1
            d = " ".join(str(x) for x in rng.integers(0, 256, 32))
            lines.append(f"{parent} {int(parent > 0)} {d} 0.5")
    (tmp_path / "voc.txt").write_text("\n".join(lines) + "\n")
    jt = jvoc.load_orbvoc_text(str(tmp_path / "voc.txt"))
    tt = tvoc.load_orbvoc_text(str(tmp_path / "voc.txt"))
    np.testing.assert_array_equal(tt.centers.numpy(), np.asarray(jt.centers))
    assert (tt.k, tt.levels) == (jt.k, jt.levels) == (3, 2)
    cv = convert.vocabulary_from_numpy(np.asarray(jt.centers), jt.k, jt.levels, "cpu")
    np.testing.assert_array_equal(cv.centers.numpy(), tt.centers.numpy())


def test_random_pose_matches_jax():
    for seed in range(4):
        np.testing.assert_allclose(tvoc.random_pose(np.random.default_rng(seed)),
                                   jvoc.random_pose(np.random.default_rng(seed)), atol=1e-6)


def test_retrieval_precision_default_vocab(vocabs):
    """tests/test_vocab_retrieval.py's retrieval on the port: 8 places of the
    synthetic room, 2 perturbed queries each, top-1 of the BoW score must be
    the same place in >= 85% (the port's extractor and the JAX renderer's
    images)."""
    _, _, _, td = vocabs
    rng = np.random.default_rng(3)
    tc = TCAM
    to = TORB

    def bow(T):
        gray = np.asarray(jsyn.render(jnp.asarray(T, jnp.float32), CAM, False).gray)
        f = text.extract(t(gray), to, tc.height, tc.width)
        w = torch.where(f.valid, tvoc.transform(f.desc, td.centers, td.k, td.levels), -1)
        return tvoc.bow_vector(w, w >= 0, td.n_leaves)

    anchors, queries = [], []
    for _ in range(8):
        T = tvoc.random_pose(rng)
        anchors.append(T)
        qs = []
        for _ in range(2):
            d = np.eye(4)
            yaw = rng.uniform(-0.04, 0.04)
            d[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]]
            d[:3, 3] = rng.uniform(-0.05, 0.05, 3)
            qs.append(T @ d)
        queries.append(qs)
    db = torch.stack([bow(T) for T in anchors])
    hits = [int(tvoc.l1_score(db, bow(T)[None]).argmax()) == p
            for p, qs in enumerate(queries) for T in qs]
    assert np.mean(hits) >= 0.85, hits
