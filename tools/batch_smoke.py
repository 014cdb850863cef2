"""The batch phase of chip_smoke.py alone, on one NVIDIA card: the kernels'
build, then `batch` (parallel/batch_eval.py at the SlamConfig() width: B =
1, 4 and 8 on static frames, each slot bitwise its B = 1 run, a blacked-out
slot relocalized, B = 4 GD slots; seconds per step, sequences x frames per
second, host waits and idle share per step; match_top2 and the draw exact on
the path's call shapes). For iterating on the batched tracker without the
full run.

    python3 tools/batch_smoke.py

Prints chip_smoke.py's JSON lines for those phases; exits non-zero when a
phase fails or there is no card.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("batch_smoke: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gdslam_tpu_torch import SlamConfig
    from gdslam_tpu_torch.frontend import matcher
    from gdslam_tpu_torch.io import synthetic
    from gdslam_tpu_torch.masking import geomask
    from gdslam_tpu_torch.ops import draw_kernel
    from gdslam_tpu_torch.ops import match_kernel as mk
    from gdslam_tpu_torch.parallel import batch_eval
    from gdslam_tpu_torch.system import tracking
    from gdslam_tpu_torch.utils import metrics
    (ROOT / "build").mkdir(exist_ok=True)
    cs.emit(cs.phase_build(mk))
    cs.phase_batch(torch, mk, SlamConfig(), "cuda", (batch_eval, synthetic, metrics, tracking,
                                                      geomask, matcher, draw_kernel))
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
