"""KITTI stereo command-line program on the port, the counterpart of
Examples/Stereo/stereo_kitti.cc (port of gdslam_tpu.cli.stereo_kitti).

Usage (positional, mirroring stereo_kitti.cc):

    python -m gdslam_tpu_torch.cli.stereo_kitti VOCAB SETTINGS SEQUENCE_DIR [--device cuda|cpu]

- VOCAB: 'default' (the shipped 10k-leaf vocabulary), a vocabulary .npz,
  an ORBvoc.txt, or 'none' (or '-'): no loop closing
- SETTINGS: OpenCV-YAML camera/ORB settings (e.g. KITTI00-02.yaml)
- SEQUENCE_DIR: KITTI odometry sequence (image_0/, image_1/, times.txt)
- --device: where the system runs, the card unless 'cpu' is given

Writes CameraTrajectory.txt in KITTI format into the working directory
(stereo_kitti.cc SaveTrajectoryKITTI) and prints the median and mean
tracking time.
"""

from __future__ import annotations

import sys
import time


def load_vocab(arg: str, device):
    """The VOCAB argument as a Vocabulary, or None for 'none' / '-'."""
    if arg in ("none", "-"):
        return None
    from gdslam_tpu_torch.backend import vocabulary as voc
    if arg == "default":
        return voc.default_vocabulary(device)
    if arg.endswith(".txt"):
        return voc.load_orbvoc_text(arg, device)
    return voc.load(arg, device)


def run(argv, sensor_name: str, sequence_cls: str, doc: str) -> int:
    """The shared body of the three stereo / monocular programs: track every
    frame of the sequence (not pipelined, as the JAX drivers run), print the
    tracking times, write the trajectory."""
    from gdslam_tpu_torch.cli.rgbd_tum import _take_option
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _take_option(argv, "--device") or "cuda"
    if len(argv) < 3:
        print(doc)
        return 1
    vocab_arg, settings_path, seq_dir = argv[:3]

    from gdslam_tpu_torch.config import SlamConfig
    from gdslam_tpu_torch.io import kitti
    from gdslam_tpu_torch.system.slam import Sensor, System

    cfg = SlamConfig.from_opencv_yaml(settings_path)
    seq = getattr(kitti, sequence_cls)(seq_dir)
    sensor = Sensor[sensor_name]
    kind = "stereo" if sensor == Sensor.STEREO else "mono"
    print(f"Loaded {len(seq)} {kind} frames from {seq_dir}")
    slam = System(cfg, sensor, vocabulary=load_vocab(vocab_arg, device), device=device)

    times = []
    for i in range(len(seq)):
        item = seq[i]
        t0 = time.perf_counter()
        if sensor == Sensor.STEREO:
            slam.track_stereo(*item)
        else:
            slam.track_monocular(*item)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{len(seq)} state={slam.tracking_state.name} "
                  f"kfs={slam.keyframe_count}")

    slam.shutdown()
    times_s = sorted(times)
    print(f"median tracking time: {times_s[len(times_s) // 2]:.4f}")
    print(f"mean tracking time: {sum(times) / len(times):.4f}")
    if sensor == Sensor.STEREO:
        slam.save_trajectory_kitti("CameraTrajectory.txt")
    else:
        # monocular: keyframes only, the frame trajectory depends on the gauge
        slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print("trajectory saved!")
    return 0


def main(argv=None) -> int:
    return run(argv, "STEREO", "KittiStereoSequence", __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
