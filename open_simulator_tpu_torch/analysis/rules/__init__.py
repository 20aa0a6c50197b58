"""Lint rules. Importing this package registers every rule with the
engine's registry (`analysis.lint.rule`). Each module groups rules by the
contract they guard.

The reference's eight rules, and what each became in the port
(`RULE_DECISIONS`, held against the reference's catalogue by a test):

* `tracer-coercion`: kept, restated. float()/int()/bool(), .item(),
  .tolist(), .cpu(), .numpy() and np.asarray on a tensor in entry code are
  a host sync per call and raise under torch.func.vmap (`purity`).
* `impure-read`: kept, restated for determinism. Eager code re-reads
  time.* and os.environ on every call, so nothing is frozen; what still
  breaks bit-identical results is unseeded randomness (`purity`).
* `unhashable-static-default`: dropped. No cache is keyed by static
  arguments in eager PyTorch, so an unhashable default raises nowhere.
* `import-time-jnp` -> `import-time-cuda`: CUDA work at import breaks
  every later fork, and the port forks (`import_time`).
* `f64-literal`: kept with torch spellings; int64 that only feeds an index
  is exempt, float64 never (`dtype`).
* `unbucketed-jit-shape`: kept. Nothing recompiles, but a raw size pads
  differently from the reference, whose bits are the contract (`shapes`).
* `device-sync-in-loop`: kept with torch's syncs (`device_sync`).
* `lock-in-hot-path`: kept as it is (`hotpath`).
"""

from . import (  # noqa: F401
    device_sync,
    dtype,
    hotpath,
    import_time,
    purity,
    shapes,
)

#: reference rule id -> (port rule id or None when dropped, decision)
RULE_DECISIONS = {
    "tracer-coercion": ("tracer-coercion", "restated: host syncs in entry code"),
    "impure-read": ("impure-read", "restated: unseeded randomness in entry code"),
    "unhashable-static-default": (None, "dropped: no cache keyed by static arguments"),
    "import-time-jnp": ("import-time-cuda", "restated: CUDA initialised at import"),
    "f64-literal": ("f64-literal", "kept: torch spellings, index int64 exempt"),
    "unbucketed-jit-shape": ("unbucketed-jit-shape", "kept: padding is the contract"),
    "device-sync-in-loop": ("device-sync-in-loop", "kept: torch syncs"),
    "lock-in-hot-path": ("lock-in-hot-path", "kept as it is"),
}
