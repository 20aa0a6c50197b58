"""PyTorch/CUDA port of the open_simulator_tpu scheduling engine.

The JAX package `open_simulator_tpu` is the reference; this package has the
same module layout and names, holds its own copy of every host helper it
needs, and imports neither jax nor the reference. Entry points take an
explicit `device` and default to CUDA (see `device.resolve_device`).

Counts are reconstructed as integer-valued f32 sums, which must stay exact:
TF32 is switched off for every float32 product and convolution.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off"
assert not torch.backends.cudnn.allow_tf32, "TF32 convolution must stay off"
