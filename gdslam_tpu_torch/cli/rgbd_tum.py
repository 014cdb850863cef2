"""TUM RGB-D command-line program on the port, the counterpart of Examples/RGB-D/rgbd_tum.cc
(port of gdslam_tpu.cli.rgbd_tum).

Usage (positional, mirroring rgbd_tum.cc:30-33):

    python -m gdslam_tpu_torch.cli.rgbd_tum VOCAB SETTINGS SEQUENCE_DIR ASSOC \\
        [MASKS_DIR|no_save [OUTPUT_DIR]] [--segmenter flax[:WEIGHTS]] [--device cuda|cpu]

- VOCAB: 'default' (the shipped 10k-leaf vocabulary), the path of a
  vocabulary .npz, or 'none' (or '-'): no loop closing, relocalization from
  the recent keyframes
- SETTINGS: OpenCV-YAML camera/ORB settings (e.g. TUM3.yaml)
- MASKS_DIR: semantic-mask cache directory (the PATH_TO_MASKS protocol,
  rgbd_tum.cc:99-109; 'no_save' reads without writing back); with it the
  DynaSLAM geometry path tracks (4-arg GrabImageRGBD, Tracking.cc:331-369)
- OUTPUT_DIR: GD masking with background inpainting (the argc==7 mode,
  rgbd_tum.cc:165-171); writes the inpainted rgb/ and depth/ and the refined
  mask/ as PNGs named by timestamp
- --segmenter: the live Mask R-CNN (models/maskrcnn.py), run on every
  mask-cache miss (the reference's per-frame MaskNet inference,
  MaskNet.cc:86-93); WEIGHTS is a save_variables .npz of either package
  ('flax' alone: seeded random weights). Fresh masks are written back to
  MASKS_DIR (unless 'no_save'); with the segmenter and no OUTPUT_DIR the
  geometry path tracks. WEIGHTS may also be the reference's Keras
  mask_rcnn_coco.h5, converted on load (models/maskrcnn.convert_keras_h5)
- --device: where the system and the segmenter run, the card unless 'cpu'
  is given

Frames are read by the native prefetching loader when it builds
(build/native/), else by io.tum.TumSequence; it prints which.
Writes CameraTrajectory.txt and KeyFrameTrajectory.txt into the working
directory (rgbd_tum.cc:203-204) and prints the median and mean tracking
time (rgbd_tum.cc:192-200).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _take_option(argv: list, name: str):
    """Remove `name VALUE` or `name=VALUE` from argv; returns VALUE or None."""
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith(name + "="):
            del argv[i]
            return a.split("=", 1)[1]
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _take_option(argv, "--device") or "cuda"
    seg_spec = _take_option(argv, "--segmenter")
    if len(argv) < 4:
        print(__doc__)
        return 1
    vocab_arg, settings_path, seq_dir, assoc_path = argv[:4]
    masks_dir = argv[4] if len(argv) > 4 else None
    output_dir = argv[5] if len(argv) > 5 else None
    vocab = None if vocab_arg in ("none", "-") else vocab_arg

    from gdslam_tpu_torch.config import SlamConfig
    from gdslam_tpu_torch.io import native_loader, png
    from gdslam_tpu_torch.io.tum import TumSequence
    from gdslam_tpu_torch.masking.masknet import SegmentDynObject
    from gdslam_tpu_torch.system.slam import Sensor, System

    cfg = SlamConfig.from_opencv_yaml(settings_path)
    if native_loader.available():
        # uint8 rgb + uint16 depth: the smaller upload; the System scales
        # the depth on the device
        seq = native_loader.NativeTumSequence(seq_dir, assoc_path, cfg.camera.depth_map_factor,
                                              cfg.camera.width, cfg.camera.height, raw=True)
        frames_iter = iter(seq)
        print(f"Loaded {len(seq)} frames from {seq_dir} (native loader)")
    else:
        seq = TumSequence(seq_dir, assoc_path, cfg.camera.depth_map_factor)
        frames_iter = (seq[i] for i in range(len(seq)))
        print(f"Loaded {len(seq)} frames from {seq_dir} (TumSequence)")

    net = None
    if seg_spec:
        from gdslam_tpu_torch.models.maskrcnn import build_segmenter
        net = build_segmenter(seg_spec, image_hw=(cfg.camera.height, cfg.camera.width),
                              device=device)
    segmenter = SegmentDynObject(net, cache_dir=masks_dir) \
        if (masks_dir or net is not None) else None
    slam = System(cfg, Sensor.RGBD, vocabulary=vocab, pipeline=True, device=device)
    use_gd = output_dir is not None
    if use_gd:
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    times = []
    for i, (rgb, depth, ts) in enumerate(frames_iter):
        mask = None
        if segmenter is not None:
            dyn = segmenter.get_segmentation(rgb, f"{ts:.6f}")
            mask = 1.0 - dyn                       # static = 1 (rgbd_tum.cc:137-150)
        t0 = time.perf_counter()
        if use_gd:
            # argc==7 mode (rgbd_tum.cc:154): GD scene-flow masking with
            # inpainted rgb/depth outputs
            _, refined, rgb_o, depth_o = slam.track_rgbd_gd(rgb, depth, mask, ts, inpaint=True)
        elif segmenter is not None:
            # argc==6 mode (rgbd_tum.cc:157 -> the 4-arg GrabImageRGBD):
            # LightTrack + the geometric mask correction
            slam.track_rgbd(rgb, depth, mask, ts, use_geometry=True)
        else:
            slam.track_rgbd(rgb, depth, mask, ts)
        times.append(time.perf_counter() - t0)
        if use_gd:
            name = f"{ts:.6f}.png"
            png.write(os.path.join(output_dir, "rgb", name),
                      rgb_o.cpu().numpy().astype(np.uint8))
            png.write(os.path.join(output_dir, "depth", name),
                      (depth_o.cpu().numpy() * cfg.camera.depth_map_factor).astype(np.uint16))
            png.write(os.path.join(output_dir, "mask", name),
                      (refined.cpu().numpy() * 255).astype(np.uint8))
        if i % 50 == 0:
            print(f"frame {i}/{len(seq)} state={slam.tracking_state.name} "
                  f"kfs={slam.keyframe_count}")

    slam.shutdown()
    times_s = sorted(times)
    print(f"median tracking time: {times_s[len(times_s) // 2]:.4f}")
    print(f"mean tracking time: {sum(times) / len(times):.4f}")
    slam.save_trajectory_tum("CameraTrajectory.txt")
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print("trajectory saved!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
