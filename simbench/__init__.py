"""The benchmark of the PyTorch/CUDA port, `open_simulator_tpu_torch`.

`python3 -m simbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json (run.py). Configurations, traffic mixes and
per-layer metric readers are files under configs/, traffic/ and metrics/,
found by the names BENCHMARK.json gives; gen.py is the one generator, and
reference/ the plain scheduler `correct` is judged by. Nothing here imports
JAX or the JAX package.
"""
