"""Evaluation harness on the port (port of gdslam_tpu.cli.evaluate): run a
pipeline over a TUM-layout sequence, associate the trajectory with ground
truth and print ATE / RPE and one JSON line.

    python -m gdslam_tpu_torch.cli.evaluate SEQ_DIR ASSOC GROUNDTRUTH \\
        [--mode plain|geometry|gd] [--settings TUM.yaml] [--masks DIR] \\
        [--ref-masks DIR] [--vocab default|none|PATH] [--max-frames N] \\
        [--rpe-delta N] [--device cuda|cpu]

The estimated trajectory is associated to ground truth by timestamp
(nearest neighbour within 20 ms, the TUM tools' rule). With --ref-masks it
also reports the mean IoU of the refined dynamic masks against reference
mask images ({ts}.png, dynamic = nonzero).

Modes (BASELINE.md configs):
  plain    - no dynamic masking (TrackRGBD, System.cc:157)
  geometry - DynaSLAM multi-view geometric masking (4-arg GrabImageRGBD,
             Tracking.cc:331-369)
  gd       - GD dense-scene-flow masking (TrackRGBD_GD, Tracking.cc:212-269),
             fed uint8 gray + uint16 depth as a camera gives them; --masks
             adds the semantic prior
--vocab default (or a vocabulary .npz) turns on loop closing and BoW
relocalization; --segmenter raises (ROADMAP.md section 1, item 12).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _associate(est_ts: np.ndarray, gt_ts: np.ndarray, max_dt: float = 0.02):
    """Index pairs (i_est, i_gt) of nearest-timestamp matches within max_dt
    (the TUM associate.py rule)."""
    pairs = []
    for i, t in enumerate(est_ts):
        j = int(np.searchsorted(gt_ts, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(gt_ts) and abs(gt_ts[k] - t) <= best_dt:
                best, best_dt = k, abs(gt_ts[k] - t)
        if best >= 0:
            pairs.append((i, best))
    return pairs


def _mask_iou(est_mask: np.ndarray, ref_mask: np.ndarray) -> float:
    """IoU of the dynamic region (est: 1 = static; ref: dynamic = nonzero)."""
    dyn_e = est_mask < 0.5
    dyn_r = ref_mask > 0.5
    inter = float(np.sum(dyn_e & dyn_r))
    union = float(np.sum(dyn_e | dyn_r))
    return inter / union if union > 0 else 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gdslam_tpu_torch.cli.evaluate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir")
    ap.add_argument("assoc")
    ap.add_argument("groundtruth")
    ap.add_argument("--mode", choices=("plain", "geometry", "gd"), default="plain")
    ap.add_argument("--settings", default=None,
                    help="OpenCV-YAML settings (default: TUM3-like intrinsics)")
    ap.add_argument("--masks", default=None, help="semantic-mask cache dir (MaskNet protocol)")
    ap.add_argument("--ref-masks", default=None,
                    help="reference dynamic-mask dir ({ts}.png) for mask IoU")
    ap.add_argument("--vocab", default="none",
                    help="'default', a vocabulary .npz, or 'none' (no loop closing)")
    ap.add_argument("--segmenter", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--rpe-delta", type=int, default=30,
                    help="RPE frame spacing (default 30 = 1 s at 30 fps)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.segmenter:
        raise NotImplementedError(
            "--segmenter: the live Mask R-CNN segmenter is not ported to gdslam_tpu_torch "
            "yet; see ROADMAP.md section 1, item 12 (--masks works)")

    from gdslam_tpu_torch.config import SlamConfig
    from gdslam_tpu_torch.io import png
    from gdslam_tpu_torch.io.tum import TumSequence
    from gdslam_tpu_torch.masking.masknet import SegmentDynObject
    from gdslam_tpu_torch.system import trajectory as traj
    from gdslam_tpu_torch.system.slam import Sensor, System
    from gdslam_tpu_torch.utils import metrics

    cfg = SlamConfig.from_opencv_yaml(args.settings) if args.settings else SlamConfig()
    segmenter = SegmentDynObject(None, cache_dir=args.masks) if args.masks else None
    vocab = None if args.vocab in ("none", "-") else args.vocab
    slam = System(cfg, Sensor.RGBD, vocabulary=vocab, pipeline=True, device=args.device)
    seq = TumSequence(args.seq_dir, args.assoc, cfg.camera.depth_map_factor)
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    ious = []
    for i in range(n):
        rgb, depth, ts = seq[i]
        mask = None
        if segmenter is not None:
            mask = 1.0 - segmenter.get_segmentation(rgb, f"{ts:.6f}")
        if args.mode == "gd":
            # uint8 gray + uint16 depth in sensor units, as a camera gives
            # them: the GD fast path uploads them as one packed buffer
            g8 = rgb if rgb.ndim == 2 else (
                rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
            ).astype(np.uint8)
            d16 = depth if depth.dtype == np.uint16 else np.clip(
                depth * cfg.camera.depth_map_factor, 0, 65535).astype(np.uint16)
            _, refined = slam.track_rgbd_gd(g8, d16, mask, ts)
        elif args.mode == "geometry":
            slam.track_rgbd(rgb, depth, mask, ts, use_geometry=True)
            refined = slam._last_refined_mask
        else:
            slam.track_rgbd(rgb, depth, mask, ts)
            refined = None
        if args.ref_masks and refined is not None:
            p = os.path.join(args.ref_masks, f"{ts:.6f}.png")
            if os.path.exists(p):
                ref = png.read(p).astype(np.float32)
                if ref.ndim == 3:
                    ref = ref[..., 0]
                ious.append(_mask_iou(refined.cpu().numpy(),
                                      ref / 255.0 if ref.max() > 1 else ref))
        if i % 100 == 0:
            print(f"frame {i}/{n} state={slam.tracking_state.name} "
                  f"kfs={slam.keyframe_count}", file=sys.stderr)
    slam.shutdown()

    est = slam.tracker.camera_trajectory()   # [(ts, T_wc)]
    gt = traj.load_tum(args.groundtruth)
    if not est:
        print(json.dumps({"error": "no tracked frames"}))
        return 1
    pairs = _associate(np.array([t for t, _ in est]), np.array([t for t, _ in gt]))
    if len(pairs) < 2:
        print(json.dumps({"error": "no timestamp associations with groundtruth",
                          "est_frames": len(est)}))
        return 1
    est_T = np.stack([est[i][1] for i, _ in pairs])
    gt_T = np.stack([gt[j][1] for _, j in pairs])
    ate = metrics.ate_rmse(est_T[:, :3, 3], gt_T[:, :3, 3])
    rpe = metrics.rpe_rmse(est_T, gt_T, delta=min(args.rpe_delta, len(pairs) - 1))
    out = {"mode": args.mode, "frames": n, "tracked": len(est), "associated": len(pairs),
           "ate_rmse_m": round(ate, 5), "rpe_rmse_m": round(rpe, 5),
           "keyframes": slam.keyframe_count}
    if ious:
        out["mask_iou"] = round(float(np.mean(ious)), 4)
    print(f"ATE RMSE: {ate:.4f} m over {len(pairs)} associated frames")
    print(f"RPE RMSE: {rpe:.4f} m (delta={args.rpe_delta})")
    if ious:
        print(f"mask IoU: {np.mean(ious):.4f} over {len(ious)} frames")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
