"""Where does monocular tracking on the card part from the same tracking on
the CPU? chip_smoke.py's mono cell (the SlamConfig() defaults at 480 x 640,
every second frame of the static scene, written as TUM monocular PNGs) run
through two Systems in lockstep in one process, one with device "cpu" and
one on the card, on the same decoded images:

    python3 tools/mono_divergence.py [--frames 60] [--out build/mono_divergence.json]

Per processed frame, for both: the tracking state, the statistics that feed
the keyframe decision (motion-model matches n1, pose inliers, close tracked
and untracked points, frames since the last keyframe, the reference
keyframe's matches), the decision, keyframes and map points, and the pose
difference between the two runs. The first frame whose discrete entries
differ is the parting frame. Where that is the two-view bootstrap, its
stages are compared from the CPU's inputs (bootstrap_bisect: extraction,
matches, initialize's hypotheses and result). Else the frame is re-run
from the CPU run's state just before it, one stage at a time fed from the
CPU: the card's own
extraction against the CPU's (keypoints, descriptors), then the card's
tracking from the CPU's state moved to the card with the card's features
and with the CPU's, and the card's own state with the CPU's features; so
the stage whose card result first departs is named. Also the state
difference accumulated before the parting frame (last pose, map points).

Prints one JSON line per frame and a summary line, and writes all of it to
--out. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def to_device(obj, dev, torch):
    """obj with every tensor in it (tuples, named tuples, lists, dicts)
    moved to `dev`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, dev, torch) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, dev, torch) for x in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, dev, torch) for k, v in obj.items()}
    return obj


PROBED = ("_dispatch", "_need_keyframe_stats")


def fork(tr):
    """A tracker that goes on from `tr`'s state without touching it (its
    tensors are never written in place; the host lists are copied), with
    the class's methods where a Probe wrapped `tr`'s."""
    t2 = copy.copy(tr)
    for k in PROBED:
        vars(t2).pop(k, None)
    t2.records, t2.kf_timestamps, t2._pending = list(tr.records), list(tr.kf_timestamps), []
    return t2


def moved_tracker(tr, dev, torch):
    """fork(tr) with its whole state on `dev`."""
    t2 = fork(tr)
    for k, v in vars(t2).items():
        if k not in ("cfg", "_loop_closer"):
            setattr(t2, k, to_device(v, dev, torch))
    t2.device = torch.device(dev)
    return t2


class Probe:
    """While installed on a Tracking instance: each frame's dispatch
    statistics and keyframe decision inputs."""

    def __init__(self, tracker):
        self.tr, self.rec = tracker, {}
        real_dispatch, real_need = tracker._dispatch, tracker._need_keyframe_stats

        def dispatch(frame, wide=False):
            out = real_dispatch(frame, wide)
            self.rec.setdefault("stats", []).append([int(x) for x in out[4].tolist()])
            return out

        def need(n_inl, ct, cu):
            d = real_need(n_inl, ct, cu)
            self.rec["decision"] = dict(n_inl=n_inl, close_tracked=ct, close_untracked=cu,
                                        frames_since_kf=tracker.frames_since_kf,
                                        ref_kf_matches=tracker.ref_kf_matches, keyframe=d)
            return d

        tracker._dispatch, tracker._need_keyframe_stats = dispatch, need

    def take(self) -> dict:
        tr, rec = self.tr, self.rec
        self.rec = {}
        T = tr.last.T_cw.detach().cpu().numpy() if tr.last is not None else np.eye(4)
        return dict(state=tr.state.name, keyframes=tr.n_kf_host,
                    map_points=int(tr.arena.pt_valid.sum()), n_inliers=int(tr.n_inliers),
                    T_cw=T.tolist(), **rec)


DISCRETE = ("state", "keyframes", "map_points", "stats", "decision")


def frame_stats(tr, frame) -> dict:
    """One frame through the common body on a fork of `tr`: its dispatch
    statistics, the keyframe decision's inputs and the map afterwards."""
    t2 = fork(tr)
    probe = Probe(t2)
    t2._process_built_frame(frame, 0.0)
    out = probe.take()
    out.pop("T_cw")
    return out


def features_diff(a, b) -> dict:
    a_uv, b_uv = a.uv.cpu(), b.uv.cpu()
    va, vb = a.valid.cpu(), b.valid.cpu()
    both = va & vb
    return dict(valid=[int(va.sum()), int(vb.sum())], valid_differ=int((va != vb).sum()),
                uv_max_abs=float((a_uv - b_uv)[both].abs().max()) if both.any() else 0.0,
                uv_rows_differ=int(((a_uv != b_uv).any(1) & both).sum()),
                desc_rows_differ=int(((a.desc.cpu() != b.desc.cpu()).any(1) & both).sum()),
                level_differ=int(((a.level.cpu() != b.level.cpu()) & both).sum()))


def hypotheses(x1, x2, valid, K, n_iters, torch):
    """initialize's fundamental and homography hypotheses on this device,
    under the JAX draws: their scores, the F winner, and which 8-point
    samples repeat a row (their F is whatever null vector the SVD gives)."""
    from gdslam_tpu_torch.core import prng
    from gdslam_tpu_torch.frontend import initializer as ini
    from gdslam_tpu_torch.ops import draw_kernel
    key = prng.prng_key(0)
    idx_f = draw_kernel.uniform_over(key, valid, n_iters * 8).reshape(n_iters, 8)
    idx_h = draw_kernel.uniform_over(prng.fold_in(key, 1), valid, n_iters * 4).reshape(n_iters, 4)
    w = valid.float()
    x1n, T1 = ini._normalize(x1, w)
    x2n, T2 = ini._normalize(x2, w)
    _, sf, _ = ini.fundamental_hypotheses(x1, x2, valid, idx_f, (x1n, T1, x2n, T2))
    Hs = torch.linalg.inv(T2) @ ini._homography_4pt(x1n[idx_h], x2n[idx_h]) @ T1
    sh = ini._score_h(Hs, x1, x2, valid)
    repeat = torch.tensor([len(set(r)) < 8 for r in idx_f.tolist()])
    return dict(idx_f=idx_f.cpu(), idx_h=idx_h.cpu(), sf=sf.cpu(), sh=sh.cpu(),
                best_f=int(torch.argmax(sf)), repeat=repeat)


def bootstrap_bisect(cfg, tc, tg, gray, systems, torch) -> dict:
    """The bootstrap at the parting frame, stage by stage: the first and the
    current frame's extraction on both devices; bootstrap_matches on the
    card from the CPU's frames; initialize's hypotheses from the CPU's
    matches on both devices (the draws, the F and H scores, the winner and
    whether it is a sample that repeats a row); initialize's result from the
    CPU's matches on both devices."""
    from gdslam_tpu_torch.frontend import extractor, initializer
    from gdslam_tpu_torch.frontend.frame import build_frame
    from gdslam_tpu_torch.system import tracking
    cam, n_levels = cfg.camera, cfg.orb.n_levels
    first_c, first_g = tc._mono_first[0], tg._mono_first[0]
    frames = {}
    for d in ("cpu", "card"):
        g = systems[d]._to_gray(gray)
        f = extractor.extract(g, cfg.orb, cam.height, cam.width)
        frames[d] = build_frame(f, torch.zeros_like(g), torch.ones_like(g), cam)
    out = dict(extraction_first=features_diff(first_c, first_g),
               extraction_current=features_diff(frames["cpu"], frames["card"]))
    good_c, idx_c = tracking.bootstrap_matches(first_c, frames["cpu"], n_levels)
    card = systems["card"].device
    first_c_g, frame_c_g = to_device(first_c, card, torch), to_device(frames["cpu"], card, torch)
    good_g, idx_g = tracking.bootstrap_matches(first_c_g, frame_c_g, n_levels)
    good_own, _ = tracking.bootstrap_matches(first_g, frames["card"], n_levels)
    out["matches"] = dict(cpu=int(good_c.sum()), card_from_cpu_frames=int(good_g.sum()),
                          card_own=int(good_own.sum()),
                          card_from_cpu_frames_equal=bool(torch.equal(good_c, good_g.cpu()) and
                                                          torch.equal(idx_c, idx_g.cpu())))
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    args = (first_c.uv, frames["cpu"].uv[idx_c.long()], good_c)
    devs = {"cpu": "cpu", "card": card}
    hyp = {d: hypotheses(*to_device(args, v, torch), K, 200, torch) for d, v in devs.items()}
    hc, hg = hyp["cpu"], hyp["card"]
    rep = hc["repeat"]
    out["hypotheses"] = dict(
        draws_equal=bool(torch.equal(hc["idx_f"], hg["idx_f"]) and
                         torch.equal(hc["idx_h"], hg["idx_h"])),
        samples_repeating_a_row=int(rep.sum()),
        f_score_max_abs_diff_distinct=float((hc["sf"] - hg["sf"])[~rep].abs().max()),
        f_score_max_abs_diff_repeating=float((hc["sf"] - hg["sf"])[rep].abs().max())
        if rep.any() else None,
        h_score_max_abs_diff=float((hc["sh"] - hg["sh"]).abs().max()),
        best_f=dict(cpu=hc["best_f"], card=hg["best_f"]),
        best_f_repeats_a_row=dict(cpu=bool(rep[hc["best_f"]]), card=bool(rep[hg["best_f"]])),
        best_f_score=dict(cpu=float(hc["sf"][hc["best_f"]]), card=float(hg["sf"][hg["best_f"]])),
        top_f_scores_cpu=sorted(hc["sf"].tolist(), reverse=True)[:5],
        top_f_scores_card=sorted(hg["sf"].tolist(), reverse=True)[:5])
    res = {d: initializer.initialize(*to_device(args, v, torch), K, seed=0)
           for d, v in devs.items()}
    rc, rg = res["cpu"], res["card"]
    out["initialize_from_cpu_matches"] = dict(
        ok=[bool(rc.ok), bool(rg.ok)], used_homography=[bool(rc.used_homography),
                                                        bool(rg.used_homography)],
        good=[int(rc.is_good.sum()), int(rg.is_good.sum())],
        T_21_max_abs_diff=float((rc.T_21 - rg.T_21.cpu()).abs().max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=str(ROOT / "build" / "mono_divergence.json"))
    ap.add_argument("--card", default="cuda",
                    help="the second run's device ('cpu' rehearses the tool without a card)")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if opts.card == "cuda" and not torch.cuda.is_available():
        print("mono_divergence: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.frontend import extractor
    from gdslam_tpu_torch.frontend.frame import build_frame
    from gdslam_tpu_torch.io import kitti, png, synthetic
    from gdslam_tpu_torch.system.slam import Sensor, System

    base = Path(tempfile.mkdtemp(prefix="mono_div_", dir=ROOT / "build"))
    cs.write_mono_sequence(torch, SlamConfig(), opts.frames, base, png, synthetic, opts.card)
    cfg = SlamConfig.from_opencv_yaml(str(base / "settings.yaml"))
    seq = kitti.TumMonoSequence(str(base))
    systems = {"cpu": System(cfg, Sensor.MONOCULAR, device="cpu"),
               "card": System(cfg, Sensor.MONOCULAR, device=opts.card)}
    probes = {d: Probe(s.tracker) for d, s in systems.items()}
    log, parting, snapshot = [], None, None
    for i in range(len(seq)):
        gray, ts = seq[i]
        before = {d: fork(s.tracker) for d, s in systems.items()}
        for d, s in systems.items():
            s.track_monocular(gray, ts)
        rec = {d: probes[d].take() for d in systems}
        pose_diff = float(np.abs(np.asarray(rec["cpu"]["T_cw"]) -
                                 np.asarray(rec["card"]["T_cw"])).max())
        differ = [k for k in DISCRETE if rec["cpu"].get(k) != rec["card"].get(k)]
        entry = dict(frame=2 * i, index=i, differ=differ, pose_max_abs_diff=pose_diff,
                     cpu={k: v for k, v in rec["cpu"].items() if k != "T_cw"},
                     card={k: v for k, v in rec["card"].items() if k != "T_cw"})
        log.append(entry)
        print(json.dumps(entry), flush=True)
        if differ and parting is None:
            parting, snapshot = i, (before, gray)
    summary = dict(frames=len(seq), parting_index=parting,
                   parting_frame=None if parting is None else 2 * parting,
                   keyframes={d: s.tracker.n_kf_host for d, s in systems.items()},
                   first_pose_diff_index=next((e["index"] for e in log
                                               if e["pose_max_abs_diff"] > 0), None),
                   card=cs.nvidia_smi_line() if opts.card == "cuda" else "cpu")
    if parting is not None and snapshot[0]["cpu"].last is None:
        before, gray = snapshot
        summary["bisect"] = dict(stage="bootstrap", **bootstrap_bisect(
            cfg, before["cpu"], before["card"], gray, systems, torch))
    elif parting is not None:
        (before, gray) = snapshot
        cam = cfg.camera
        tc, tg = before["cpu"], before["card"]
        g_cpu, g_dev = (systems[d]._to_gray(gray) for d in ("cpu", "card"))
        card = systems["card"].device
        f_cpu = extractor.extract(g_cpu, cfg.orb, cam.height, cam.width)
        f_dev = extractor.extract(g_dev, cfg.orb, cam.height, cam.width)
        frame = lambda f, g: build_frame(f, torch.zeros_like(g), torch.ones_like(g), cam)  # noqa
        fr_cpu, fr_dev = frame(f_cpu, g_cpu), frame(f_dev, g_dev)
        fr_cpu_on_dev = to_device(fr_cpu, card, torch)
        tc_on_dev = moved_tracker(tc, card, torch)
        state_diff = dict(
            map_points=[int(tc.arena.pt_valid.sum()), int(tg.arena.pt_valid.sum())],
            keyframes=[tc.n_kf_host, tg.n_kf_host],
            last_pose_max_abs=float((tc.last.T_cw - tg.last.T_cw.cpu()).abs().max()),
            kf_pose_max_abs=float((tc.arena.kf_pose[:tc.n_kf_host] -
                                   tg.arena.kf_pose[:tg.n_kf_host].cpu()).abs().max())
            if tc.n_kf_host == tg.n_kf_host else None)
        both = tc.arena.pt_valid & tg.arena.pt_valid.cpu()
        if both.any():
            state_diff["points_max_abs"] = float(
                (tc.arena.pt_pos[both] - tg.arena.pt_pos.cpu()[both]).abs().max())
        summary["bisect"] = dict(
            extraction=features_diff(f_cpu, f_dev),
            state_before=state_diff,
            cpu=frame_stats(tc, fr_cpu),
            card_from_cpu_state_card_features=frame_stats(tc_on_dev, fr_dev),
            card_from_cpu_state_cpu_features=frame_stats(tc_on_dev, fr_cpu_on_dev),
            card_own_state_cpu_features=frame_stats(tg, fr_cpu_on_dev),
            card=frame_stats(tg, fr_dev))
    print(json.dumps(dict(phase="mono_divergence", **summary)), flush=True)
    out = Path(opts.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(summary=summary, frames=log), indent=1))
    shutil.rmtree(base)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
