"""KITTI monocular command-line program on the port, the counterpart of
Examples/Monocular/mono_kitti.cc (port of gdslam_tpu.cli.mono_kitti).

Usage: python -m gdslam_tpu_torch.cli.mono_kitti VOCAB SETTINGS SEQUENCE_DIR [--device cuda|cpu]
(image_0/ + times.txt; VOCAB as for stereo_kitti; writes
KeyFrameTrajectory.txt in TUM format and prints the tracking times).
"""

from __future__ import annotations

from gdslam_tpu_torch.cli.stereo_kitti import run


def main(argv=None) -> int:
    return run(argv, "MONOCULAR", "KittiMonoSequence", __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
