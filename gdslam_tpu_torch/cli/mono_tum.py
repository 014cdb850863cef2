"""TUM monocular command-line program on the port, the counterpart of
Examples/Monocular/mono_tum.cc (port of gdslam_tpu.cli.mono_tum).

Usage (positional, mirroring mono_tum.cc):

    python -m gdslam_tpu_torch.cli.mono_tum VOCAB SETTINGS SEQUENCE_DIR [--device cuda|cpu]

- VOCAB: as for stereo_kitti ('default', a .npz, an ORBvoc.txt, or 'none')
- SETTINGS: OpenCV-YAML camera/ORB settings (e.g. TUM1.yaml)
- SEQUENCE_DIR: TUM sequence directory holding rgb.txt and rgb/
- --device: where the system runs, the card unless 'cpu' is given

Writes KeyFrameTrajectory.txt in TUM format (mono_tum.cc saves keyframes
only: the monocular scale makes the frame trajectory gauge-dependent) and
prints the median and mean tracking time.
"""

from __future__ import annotations

from gdslam_tpu_torch.cli.stereo_kitti import run


def main(argv=None) -> int:
    return run(argv, "MONOCULAR", "TumMonoSequence", __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
