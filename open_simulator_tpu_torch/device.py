"""Device selection for the port's entry points, and the TF32 switch.

Counts are reconstructed as integer-valued f32 sums, which must stay exact,
so TF32 is switched off for every float32 product and convolution when this
module is imported; every module that computes imports it (ops/kernels.py
does, and every other ops module imports that).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off"
assert not torch.backends.cudnn.allow_tf32, "TF32 convolution must stay off"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The torch.device an entry point runs on. CUDA is the default; asking
    for CUDA on a machine without it raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
