"""gdslam_tpu_torch — the PyTorch/CUDA port of gdslam_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (core/ ops/ frontend/ backend/ system/
io/ utils/) and function names; plain tensor code is PyTorch, and the one
Pallas kernel of the JAX package (`ops/pallas_match.match_top2`) is a
hand-written CUDA kernel (`csrc/match_top2.cu`, `ops/match_kernel.py`).

Entry points (`System`, `Tracking`, `render_frame`) run on the card unless
the caller passes `device="cpu"`.
"""

import torch as _torch

__version__ = "0.1.0"

# The reference pins geometry to full f32 (Precision.HIGHEST) and records a
# >10x ATE loss from reduced-precision descriptor/pyramid math; TF32 keeps
# about three decimal digits, so it is off for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from gdslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig  # noqa: E402,F401
