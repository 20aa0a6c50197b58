"""PyTorch/CUDA port of the open_simulator_tpu scheduling engine.

The JAX package `open_simulator_tpu` is the reference; this package has the
same module layout and names, holds its own copy of every host helper it
needs, and imports neither jax nor the reference. Entry points take an
explicit `device` and default to CUDA (see `device.resolve_device`).

Counts are reconstructed as integer-valued f32 sums, which must stay exact:
device.py switches TF32 off for every float32 product and convolution, and
every module that computes imports it (through ops/kernels.py). Importing
the package itself loads no torch, so the static analysers (`simon lint
--no-jaxpr`, `simon audit`) run without it.
"""
