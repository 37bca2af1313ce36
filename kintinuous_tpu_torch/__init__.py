"""kintinuous_tpu_torch — the PyTorch/CUDA port of kintinuous_tpu.

The fast tracker step (bilateral filter, half-resolution ICP or fused
ICP+RGB-D odometry, rolling volume shifts with slice extraction and
band meshes, block-classified TSDF fusion and the warm-started raycast
against a dense bf16 mirror) and the offline runtime around it, written
as plain PyTorch around hand-written CUDA C++ kernels for Hopper
(csrc/). The JAX package beside it is the reference this port is tested
against; the port imports nothing from it.

Entry points take ``device=None``, meaning CUDA, and raise when no card
is present unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# The tracking path is full of small f32 geometry matmuls (pose @ delta,
# SE3 transforms, GN system builds). TF32 keeps ~3 decimal digits and
# re-quantises metre-scale coordinates to ~1 cm per frame — the reason
# the JAX package pins f32 matmul precision (kintinuous_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from kintinuous_tpu_torch.config import KintinuousConfig  # noqa: E402
from kintinuous_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["KintinuousConfig", "resolve_device", "__version__"]
