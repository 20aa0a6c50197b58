"""Conflict-parallel wave commit: the round body.

The port of the JAX package's ops/wave.py. The serial scan decides and
commits one pod per step; the wave engine runs a Jacobi fixpoint over a
wave of W pods instead:

  round r:
    1. REPLAY (cheap, sequential): commit the round r-1 choices (i32[W],
       -1 = no commit) through `kernels.commit_choices_lanes`, the row-wise
       form of the scan's commit, keeping each pod's PRE-commit carry, the
       allocation takes and the wave's exit carry.
    2. PROBE (heavy, data-parallel): re-decide every pod at its own prefix
       carry with schedule_step's filter/score/argmax/reason expressions,
       all W pods of all S lanes in one `torch.func.vmap` call.

  converged when the probe reproduces its own input choices; that round's
  replay outputs are then bitwise the serial scan's.

Pod 0's prefix carry is the wave-input carry in every round, so its choice
is right after round 1; inductively pod i's is right after round i+1, so a
wave converges within W+1 rounds, and any fixpoint is the serial solution.

Knobs, read per call (the JAX package's own):
  OSIM_WAVE_COMMIT  unset/"" = auto, "1" = on, "0" = off (the serial scan).
  OSIM_WAVE_SIZE    pods per wave (default OSIM_COMMIT_CHUNK if set, else
                    256).
  OSIM_WAVE_ROUNDS  rounds before a wave falls back to the serial chunked
                    scan (default 24; 0 = no bound).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from .kernels import (
    Carry,
    NodeStatic,
    PodRow,
    commit_choice,
    commit_choices_lanes,
    reason_row,
    run_filters,
    run_scores,
)
from .sanitize import sanitizable

# auto mode takes the wave engine only from this many pods on
WAVE_AUTO_MIN_PODS = 512

DEFAULT_WAVE_SIZE = 256
DEFAULT_MAX_ROUNDS = 24
# pods per vmapped probe call: bounds the [S, W, N, ...] intermediates
PROBE_SUB_BATCH = 64

_NEG_INF = float("-inf")


def wave_mode() -> str:
    """'off' | 'on' | 'auto' from OSIM_WAVE_COMMIT."""
    raw = os.environ.get("OSIM_WAVE_COMMIT", "").strip()
    if raw == "0":
        return "off"
    if raw == "":
        return "auto"
    return "on"


def wave_size() -> int:
    """Pods per wave: OSIM_WAVE_SIZE, else OSIM_COMMIT_CHUNK, else 256."""
    for var in ("OSIM_WAVE_SIZE", "OSIM_COMMIT_CHUNK"):
        raw = os.environ.get(var, "").strip()
        if raw:
            try:
                v = int(raw)
            except ValueError:
                continue
            if v > 0:
                return v
    return DEFAULT_WAVE_SIZE


def wave_max_rounds() -> int:
    try:
        return max(0, int(os.environ.get("OSIM_WAVE_ROUNDS", "") or DEFAULT_MAX_ROUNDS))
    except ValueError:
        return DEFAULT_MAX_ROUNDS


def _parallel_backend(device: torch.device) -> bool:
    """Auto mode helps only where the probe runs in parallel: a CUDA device,
    or a CPU with at least 8 cores."""
    if device.type != "cpu":
        return True
    return (os.cpu_count() or 1) >= 8


def wave_enabled(p_real: int, device: torch.device) -> bool:
    """Should a scenario sweep of `p_real` pods on `device` take the wave
    driver?"""
    mode = wave_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    if not _parallel_backend(device):
        return False
    return int(p_real) >= max(WAVE_AUTO_MIN_PODS, 2 * wave_size())


def probe_choice(ns: NodeStatic, weights, carry: Carry, pod: PodRow, filter_on=None):
    """schedule_step without the commit: decide ONE pod against `carry` as
    the serial scan would -> (node i32, -1 = unschedulable; reasons
    i32[F])."""
    mask, first_fail = run_filters(ns, carry, pod, filter_on)
    score = torch.where(mask, run_scores(ns, carry, pod, weights), _NEG_INF)
    node = score.argmax()
    ok = mask.any() & pod.valid
    reasons = torch.where(ok, 0, reason_row(first_fail, ns.valid))
    return torch.where(ok, node, -1).to(torch.int32), reasons


def _probe_lanes(ns: NodeStatic, filter_on):
    """probe_choice over [S lanes, W pods]: lanes vary valid, weights and
    carry; pods vary the pod row and (per pod) the carry."""

    def one(valid, weights, carry, pod):
        return probe_choice(ns._replace(valid=valid), weights, carry, pod, filter_on)

    per_pod = torch.func.vmap(one, in_dims=(None, None, 0, 0))
    return torch.func.vmap(per_pod, in_dims=(0, 0, 0, None))


def _stack_prefix(planes: List[torch.Tensor]) -> torch.Tensor:
    """[S, ...] planes of W prefix carries -> [S, W, ...]. A plane no pod of
    the wave changed is one tensor W times: read through a stride-0 view
    (the probe only reads it)."""
    first = planes[0]
    if all(p is first for p in planes):
        return first.unsqueeze(1).expand((first.shape[0], len(planes)) + tuple(first.shape[1:]))
    return torch.stack(planes, dim=1)


def wave_round(
    ns: NodeStatic,
    weights_s: torch.Tensor,
    valid_s: torch.Tensor,
    carry_s: Carry,
    pods: PodRow,
    choices_s: torch.Tensor,
    count: Optional[int],
    parts: Sequence[frozenset],
    filter_on=None,
):
    """One Jacobi round on S lanes. `choices_s` i32[S,W] are the previous
    round's decisions (-1 initially); `count` gates pad pods (their choice
    pins to -1: a no-op commit); `parts[w]` names the carry parts pod w can
    change (kernels.commit_parts).

    Returns (exit carry_s, new_choices i32[S,W], reasons i32[S,W,F],
    gpu_take i32[S,W,G], vg_take f32[S,W,V], dev_take f32[S,W,DV]): the
    takes and exit carry replay THIS round's input choices."""
    W = choices_s.shape[1]
    dev = choices_s.device
    live = None
    if count is not None and count < W:
        live = torch.arange(W, device=dev) < count
        choices_s = torch.where(live[None, :], choices_s, -1)

    pre: List[Carry] = []
    gpu, vg, dv = [], [], []
    c = carry_s
    for w in range(W):
        pre.append(c)
        pod = PodRow(*(a[w] for a in pods))
        c, g, v, d = commit_choices_lanes(ns, c, pod, choices_s[:, w], parts[w])
        gpu.append(g)
        vg.append(v)
        dv.append(d)
    pre_s = Carry(*(_stack_prefix([getattr(p, f) for p in pre]) for f in Carry._fields))

    probe = _probe_lanes(ns, filter_on)
    outs = []
    for lo in range(0, W, PROBE_SUB_BATCH):
        hi = min(W, lo + PROBE_SUB_BATCH)
        outs.append(probe(
            valid_s, weights_s,
            Carry(*(a[:, lo:hi] for a in pre_s)),
            PodRow(*(a[lo:hi] for a in pods)),
        ))
    new_choices = torch.cat([o[0] for o in outs], dim=1)
    reasons = torch.cat([o[1] for o in outs], dim=1)
    if live is not None:
        new_choices = torch.where(live[None, :], new_choices, -1)
    return (
        c, new_choices, reasons,
        torch.stack(gpu, dim=1).to(torch.int32), torch.stack(vg, dim=1), torch.stack(dv, dim=1),
    )



def _universe_probe(filter_on):
    """probe_choice over [S universes, W pods]: every NodeStatic, weight,
    carry and pod leaf varies per universe; the carry and the pod vary per
    pod within one."""

    def one(ns, weights, carry, pod):
        return probe_choice(ns, weights, carry, pod, filter_on)

    per_pod = torch.func.vmap(one, in_dims=(None, None, 0, 0))
    return torch.func.vmap(per_pod, in_dims=(0, 0, 0, 0))


def _universe_commit(parts: frozenset):
    """commit_choice on S universes, each with its own node table and pod."""

    def one(ns, carry, pod, choice):
        return commit_choice(ns, carry, pod, choice, parts)

    return torch.func.vmap(one)


@sanitizable("ops.fast:schedule_universes_wave")
def universe_round(
    ns_s: NodeStatic,
    weights_s: torch.Tensor,
    carry_s: Carry,
    pods_s: PodRow,
    choices_s: torch.Tensor,
    parts: Sequence[frozenset],
    filter_on=None,
):
    """One Jacobi round on S whole universes (every leaf of `ns_s`,
    `weights_s`, `carry_s` stacked on axis 0; `pods_s` [S, W, ...]), the
    whole pod sequence as one wave, every pod live. `parts[w]` must cover
    pod w of EVERY universe (fast.universe_parts):
    a plane that only another lane's pod changes would otherwise be
    skipped in that lane's replay.

    Returns the tuple of wave_round: (exit carry_s, new_choices i32[S,W],
    reasons i32[S,W,F], gpu_take i32[S,W,G], vg_take f32[S,W,V], dev_take
    f32[S,W,DV])."""
    W = choices_s.shape[1]
    pre: List[Carry] = []
    gpu, vg, dv = [], [], []
    c = carry_s
    for w in range(W):
        pre.append(c)
        pod = PodRow(*(a[:, w] for a in pods_s))
        c, g, v, d = _universe_commit(parts[w])(ns_s, c, pod, choices_s[:, w])
        gpu.append(g)
        vg.append(v)
        dv.append(d)
    pre_s = Carry(*(_stack_prefix([getattr(p, f) for p in pre]) for f in Carry._fields))
    new_choices, reasons = _universe_probe(filter_on)(ns_s, weights_s, pre_s, pods_s)
    return (
        c, new_choices, reasons,
        torch.stack(gpu, dim=1).to(torch.int32), torch.stack(vg, dim=1), torch.stack(dv, dim=1),
    )
