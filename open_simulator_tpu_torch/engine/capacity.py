"""Capacity planning: the add-node search.

The port of the JAX package's engine/capacity.py. The reference's
interactive loop re-simulates after each manually added node
(`pkg/apply/apply.go:197-259`) and gates success on the MaxCPU / MaxMemory /
MaxVG utilization limits (`satisfyResourceSetting`, `apply.go:689-775`);
`plan_capacity` searches for the minimum clone count instead, in one of two
shapes that return the same plan:

  - serial: an exponential bracket seeded by the demand estimate, then a
    bisection, one simulate() per probe (the fast path and the `domain_pop`
    kernel), every bisection probe padded to the bracket's node bucket;
  - batched: whole ladders of node counts per sweep through
    Simulator.run_scenarios (the lane-batched scan, or the wave engine at
    512 pods and more on a CUDA device), then a bracket refinement, all on
    the ladder's node bucket with the encoder and table delta-updated
    between sweeps (_TrialReuse).

Either way the winning count is re-simulated serially (`finalize`) and must
still pass. A probe whose pods failed on a transient extender error (a
blip, not a verdict) is re-run once before its verdict is trusted
(`CapacityPlan.retries` counts those re-runs). A journaled search commits
every verdict as it lands and resumes from them (see plan_capacity). With
a `mesh`, every probe and the finalize run node-sharded and every sweep's
lanes split over the mesh (Simulator); the plan is the unsharded one.
"""

from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..core.objects import LABEL_NEW_NODE, Node
from ..device import DEFAULT_DEVICE, resolve_device
from ..durable.watchdog import call_deadline_s, guarded_call
from ..ops.encode import clear_node_row, encode_node_into, node_bucket
from ..resilience.policy import RetryExhaustedError, RetryPolicy
from ..utils import metrics
from ..utils.tracing import log, span
from .simulator import (
    AppResource,
    ClusterResource,
    Scenario,
    ScenarioOutcome,
    SimulateResult,
    Simulator,
    batch_ineligible_reason,
    simulate,
)

# Lanes per batched sweep: the exponential ladder probes LADDER_LANES
# doubling counts per call, the refinement up to SWEEP_LANES interior
# candidates; both equal the scenario bucket, so every sweep pads to S=8.
LADDER_LANES = 8
SWEEP_LANES = 8


def new_fake_nodes(template: Node, count: int, start: int = 0) -> List[Node]:
    """Clones simon-NNNNN (ordinals start..count-1) of the candidate node
    with the new-node label (parity: utils.NewFakeNodes, utils.go:885-915,
    with ordinals instead of random suffixes so names are unique and equal
    across probes). Every clone carries the template's `_stamp_token`, which
    stands for its content in the stamping encode (ops/encode.py); code that
    mutates a clone's labels or taints afterwards must delete it."""
    token = template.__dict__.get("_clone_token")
    if token is None:
        token = object()
        template.__dict__["_clone_token"] = token
    out = []
    for i in range(start, count):
        node = copy.deepcopy(template)
        node.meta.name = f"simon-{i:05d}"
        node.meta.labels["kubernetes.io/hostname"] = node.meta.name
        node.meta.labels[LABEL_NEW_NODE] = "true"
        node.__dict__.pop("_clone_token", None)  # don't inherit minting state
        node.__dict__["_stamp_token"] = token
        out.append(node)
    return out


class _TrialReuse:
    """Reuse of the batched sweeps' trial state across sweeps of one plan:
    clones are deep-copied once and grown as needed, and within a ladder
    rung (one n_pad) the previous sweep's encoder and node table are
    delta-updated (surplus rows cleared to pad values, new rows encoded)
    instead of re-encoded. Rows are byte-identical to a fresh encode, since
    clear_node_row restores exactly the pad values encode_nodes allocates."""

    def __init__(self, template: Node, n_base: int) -> None:
        self._template = template
        self.n_base = n_base
        self._fakes: List[Node] = []
        self.enc = None
        self.table = None
        self.encoded = 0  # real rows currently encoded (n_base + clones)
        self.n_pad = 0
        self.rungs_touched: set = set()

    def fakes(self, count: int) -> List[Node]:
        if count > len(self._fakes):
            self._fakes.extend(new_fake_nodes(self._template, count, start=len(self._fakes)))
        return self._fakes[:count]

    def preencoded(self, max_count: int, n_pad: int):
        """(enc, table) delta-updated for a trial of n_base + max_count
        nodes at this rung, or None when the rung changed (full encode)."""
        if self.table is None or n_pad != self.n_pad:
            return None
        want = self.n_base + max_count
        if want > n_pad:
            return None
        table = self.table
        if want < self.encoded:
            for i in range(want, self.encoded):
                clear_node_row(table, i)
            del table.names[want:]
        elif want > self.encoded:
            grown = self.fakes(max_count)[self.encoded - self.n_base:]
            for i, nd in enumerate(grown, start=self.encoded):
                clear_node_row(table, i)
                encode_node_into(self.enc, table, i, nd, {}, {})
                table.names.append(nd.name)
        self.encoded = want
        return self.enc, table

    def capture(self, sim, n_real: int, n_pad: int) -> None:
        if sim._table is None:
            return
        self.enc = sim.enc
        self.table = sim._table
        self.encoded = n_real
        self.n_pad = n_pad


def max_resource_limits() -> Tuple[float, float, float]:
    """Env knobs MaxCPU / MaxMemory / MaxVG as percentages
    (pkg/type/const.go:29-31); 100 means no limit."""

    def read(name: str) -> float:
        try:
            v = float(os.environ.get(name, "100"))
        except ValueError:
            return 100.0
        return v if 0 < v <= 100 else 100.0

    return read("MaxCPU"), read("MaxMemory"), read("MaxVG")


def satisfy_resource_setting(result: SimulateResult) -> bool:
    """Cluster-average requested/allocatable must stay under MaxCPU and
    MaxMemory, and cluster-total VG requested/capacity under MaxVG
    (apply.go:689-775: whole percents, failing only strictly above)."""
    max_cpu, max_mem, max_vg = max_resource_limits()
    if max_cpu >= 100 and max_mem >= 100 and max_vg >= 100:
        return True
    total_cpu = total_cpu_req = total_mem = total_mem_req = 0
    for st in result.node_status:
        total_cpu += st.node.allocatable.get("cpu", 0)
        total_mem += st.node.allocatable.get("memory", 0)
        for pod in st.pods:
            total_cpu_req += pod.requests.get("cpu", 0)
            total_mem_req += pod.requests.get("memory", 0)
    cpu_ok = total_cpu == 0 or int(100.0 * total_cpu_req / total_cpu) <= max_cpu
    mem_ok = total_mem == 0 or int(100.0 * total_mem_req / total_mem) <= max_mem
    vg_cap = vg_req = 0
    for storage in result.storage.values():
        for vg in storage.vgs:
            vg_cap += vg.capacity
            vg_req += vg.requested
    vg_ok = vg_cap == 0 or int(100.0 * vg_req / vg_cap) <= max_vg
    return cpu_ok and mem_ok and vg_ok


def satisfy_outcome(out: ScenarioOutcome) -> bool:
    """satisfy_resource_setting over a verdict lane's totals (the same
    truncation and comparison)."""
    max_cpu, max_mem, max_vg = max_resource_limits()
    if max_cpu >= 100 and max_mem >= 100 and max_vg >= 100:
        return True
    cpu_ok = out.cpu_alloc == 0 or int(100.0 * out.cpu_req / out.cpu_alloc) <= max_cpu
    mem_ok = out.mem_alloc == 0 or int(100.0 * out.mem_req / out.mem_alloc) <= max_mem
    vg_ok = out.vg_cap == 0 or int(100.0 * out.vg_req / out.vg_cap) <= max_vg
    return cpu_ok and mem_ok and vg_ok


def _good_outcome(out: ScenarioOutcome) -> bool:
    """plan_capacity's good() for a batched lane."""
    return out.unscheduled == 0 and satisfy_outcome(out)


@dataclass
class CapacityPlan:
    nodes_added: int
    result: SimulateResult
    attempts: int
    # probes re-run because a transient extender failure (not a scheduling
    # verdict) left pods unscheduled: nonzero means the search ran degraded
    retries: int = 0
    # batched sweeps the search issued; 0 on the serial bisection
    batched_calls: int = 0


class _TransientTrialError(Exception):
    """A capacity probe left pods unscheduled because of a transient extender
    failure (UnscheduledPod.transient), not a scheduling verdict. Carries the
    result so an exhausted retry can still return it honestly."""

    def __init__(self, result: SimulateResult, reason: str) -> None:
        super().__init__(reason)
        self.result = result


def lower_bound_nodes(result: SimulateResult, template: Node) -> int:
    """Node-count estimate from aggregate demand, ceil(unmet demand /
    template allocatable) per resource. Not a true lower bound
    (re-simulation can move placed pods onto clones), so it only seeds the
    exponential phase; the bisection still covers the full [0, hi]."""
    demand: dict = {"pods": 0}
    for u in result.unscheduled:
        demand["pods"] += 1
        for res, q in u.pod.requests.items():
            demand[res] = demand.get(res, 0) + q
    k = 1
    for res, q in demand.items():
        alloc = template.allocatable.get(res, 0)
        if q > 0 and alloc > 0:
            k = max(k, -(-q // alloc))
    return k


def plan_capacity(
    cluster: ClusterResource,
    apps: Sequence[AppResource],
    new_node: Node,
    max_new_nodes: int = 1 << 14,
    weights: Optional[dict] = None,
    use_greed: bool = False,
    mesh=None,
    profiles=None,
    extenders=None,
    journal=None,
    resume: bool = False,
    sweep_mode: str = "auto",
    device=DEFAULT_DEVICE,
) -> Optional[CapacityPlan]:
    """Minimum clones of `new_node` so every pod schedules and the
    utilization gates pass, simulated on `device` (CUDA by default); None
    when even max_new_nodes does not suffice.

    `sweep_mode`: "serial" bisects probe by probe; "batched" evaluates
    ladders of node counts per sweep; "auto" takes batched whenever the
    workload is batch-eligible (batch_ineligible_reason), and a batched
    sweep that meets preemption-eligible pods falls back to serial. Both
    return the same plan, and `attempts` / `batched_calls` count as the
    reference's do.

    Durability: with a `journal` (durable.RunJournal), a PlanCheckpointer
    is installed for the call, so the chunked and wave drivers journal
    `plan_chunk` records and snapshot their carry; every trial's verdict is
    committed as a `trial` record after it completes, every batched sweep
    as one `sweep` record with all its lane verdicts. With `resume=True`
    the journaled verdicts are consumed (FIFO per node count, FIFO sweeps)
    instead of re-running them, and a resumed run replays the crashed run's
    search shape: journaled `sweep` records force batched mode, journaled
    non-base `trial` records force serial. The materializing replay of the
    winner is journaled as `final` and never counted in `attempts`, so an
    interrupted and resumed search returns the plan an uninterrupted one
    does."""
    if journal is None:
        return _plan_capacity_impl(
            cluster, apps, new_node, max_new_nodes, weights, use_greed, mesh, profiles,
            extenders, None, resume, sweep_mode, device,
        )
    from ..durable.checkpoint import PlanCheckpointer, installed

    with installed(PlanCheckpointer(journal, resume=resume)):
        return _plan_capacity_impl(
            cluster, apps, new_node, max_new_nodes, weights, use_greed, mesh, profiles,
            extenders, journal, resume, sweep_mode, device,
        )


def _plan_capacity_impl(
    cluster, apps, new_node, max_new_nodes, weights, use_greed, mesh, profiles, extenders,
    journal, resume, sweep_mode, device,
) -> Optional[CapacityPlan]:
    """plan_capacity's search, with the checkpointer (if any) installed."""
    if sweep_mode not in ("auto", "serial", "batched"):
        raise ValueError(f"sweep_mode must be auto|serial|batched, got {sweep_mode!r}")
    dev = resolve_device(device)

    attempts = 0
    retries = 0
    batched_calls = 0
    n_base = len(cluster.nodes)
    # expansion is node-independent for everything but DaemonSets: one
    # cache expands the workload once for the whole search
    expand_cache: dict = {}
    # a trial whose pods failed on a transient extender error is re-run once
    # before its node count is trusted: buying nodes for a transport timeout
    # would mis-size the cluster
    trial_policy = RetryPolicy.from_env(max_attempts=2)

    # node_count -> FIFO of journaled trial records of the crashed run(s);
    # sweep_cache: FIFO of its journaled sweep records
    resume_cache: dict = {}
    sweep_cache: list = []
    if resume and journal is not None:
        for e in journal.events("trial"):
            resume_cache.setdefault(int(e["node_count"]), []).append(e)
        sweep_cache = list(journal.events("sweep"))

    # a resume replays the crashed run's search shape: its verdicts only
    # line up with the search that produced them
    mode = sweep_mode
    if resume and journal is not None:
        if sweep_cache:
            mode = "batched"
        elif any(int(e.get("node_count", 0)) > 0 for e in journal.events("trial")):
            mode = "serial"
    if mode != "serial":
        reason = batch_ineligible_reason(
            cluster, apps, [Scenario(node_count=0)], use_greed=use_greed,
            profiles=profiles, extenders=extenders,
        )
        if reason is not None:
            if mode == "batched":
                log.warning(
                    "plan_capacity: batched sweep unavailable (%s); using serial bisection",
                    reason,
                )
            mode = "serial"
        else:
            mode = "batched"

    seed_hi: Optional[int] = None
    # the only result whose pod bindings are current (probes share cached
    # pod objects; see finalize)
    last_live: Optional[SimulateResult] = None

    def good(res: SimulateResult) -> bool:
        return not res.unscheduled and satisfy_resource_setting(res)

    def _probe(k: int, n_pad: Optional[int]) -> SimulateResult:
        trial = ClusterResource(
            nodes=list(cluster.nodes) + new_fake_nodes(new_node, k),
            pods=list(cluster.pods),
            daemonsets=list(cluster.daemonsets),
            others=dict(cluster.others),
        )
        metrics.CAPACITY_PROBES.inc()
        with span("capacity-probe", nodes_added=k):
            return guarded_call(
                "capacity-probe",
                lambda: simulate(
                    trial, apps, weights=weights, use_greed=use_greed, mesh=mesh, n_pad=n_pad,
                    profiles=profiles, expand_cache=expand_cache, extenders=extenders,
                    device=dev,
                ),
                call_deadline_s(),
            )

    def run_trial(k: int, n_pad: Optional[int]):
        """One live probe with transient-blip retry -> (result,
        attempts_this_trial, retries_this_trial)."""
        t_attempts = 0
        t_retries = 0

        def once(_timeout: Optional[float]) -> SimulateResult:
            nonlocal t_attempts
            t_attempts += 1
            res = _probe(k, n_pad)
            blips = [u for u in res.unscheduled if u.transient]
            if blips:
                raise _TransientTrialError(res, blips[0].reason)
            return res

        def note(_attempt: int, exc: BaseException, _delay: float) -> None:
            nonlocal t_retries
            t_retries += 1
            log.warning(
                "capacity probe (%d nodes) hit a transient extender failure "
                "(%s); retrying trial", k, exc,
            )

        try:
            res = trial_policy.execute(
                once, retryable=(_TransientTrialError,), target="capacity-probe", on_retry=note,
            )
        except RetryExhaustedError as e:
            # the retry blipped too: return the degraded result honestly (its
            # unscheduled list carries the extender error as the reason)
            res = e.last_exc.result  # type: ignore[union-attr]
        return res, t_attempts, t_retries

    def probe(k: int, n_pad: Optional[int] = None):
        """One committed trial: a journaled verdict, or a journal hit on
        resume -> (good, result), the result None when the verdict came from
        the journal (no simulation ran)."""
        nonlocal attempts, retries, seed_hi, last_live
        pending = resume_cache.get(k)
        if pending:
            e = pending.pop(0)
            if not pending:
                resume_cache.pop(k, None)
            attempts += int(e.get("attempt", 1))
            retries += int(e.get("retries", 0))
            if k == 0 and e.get("seed_hi") is not None:
                seed_hi = int(e["seed_hi"])
            return bool(e.get("good")), None
        res, t_attempts, t_retries = run_trial(k, n_pad)
        attempts += t_attempts
        retries += t_retries
        last_live = res
        g = good(res)
        payload = dict(node_count=k, good=g, attempt=t_attempts, retries=t_retries)
        if k == 0 and not g:
            seed_hi = max(min(lower_bound_nodes(res, new_node), max_new_nodes), 1)
            payload["seed_hi"] = seed_hi
        if journal is not None:
            journal.append("trial", **payload)
        return g, res

    def finalize(k: int, n_pad: Optional[int]) -> SimulateResult:
        """Re-simulate the winning count: probes share cached pod objects
        and rebind them, so only the last live result carries true
        bindings. Not counted in attempts or retries. simulate() is
        deterministic, so the replay must pass again; a replay that fails is
        an error, unless extenders are configured: HTTP extenders may answer
        differently between probes, so then the replayed result is returned
        as it is."""
        res, _t_attempts, _t_retries = run_trial(k, n_pad)
        g = good(res)
        if journal is not None:
            journal.append("final", node_count=k, good=g)
        if not g:
            if extenders:
                log.warning(
                    "capacity replay of the winning probe (%d nodes) no longer "
                    "satisfies the plan (an extender answered differently "
                    "between probes); returning the replayed result as-is", k,
                )
            else:
                raise RuntimeError(
                    "capacity replay of the winning probe no longer satisfies the "
                    f"plan ({k} nodes): simulate() is nondeterministic"
                )
        return res

    reuse = _TrialReuse(new_node, n_base)

    def sweep(counts: List[int], n_pad_sweep: int, phase: str):
        """One batched sweep: verdicts for a ladder of node counts. Lane k
        is the base cluster plus the first k clones of the largest trial
        (Scenario.node_count masks the rest). Returns [good?] per count, or
        None when run_scenarios refused (preemption-eligible pods), before
        anything was journaled. On resume, the next journaled sweep record
        answers instead when its counts are these."""
        nonlocal attempts, batched_calls
        counts = list(counts)
        if sweep_cache:
            e = sweep_cache.pop(0)
            if list(map(int, e.get("counts", []))) == counts:
                attempts += len(counts)
                batched_calls += 1
                return [bool(g) for g in e.get("good", [])]
            # the journaled search diverged from this one (utilization
            # limits changed between runs, say): no later record can line
            # up either, so everything from here runs live
            log.warning(
                "plan_capacity resume: journaled sweep counts %s do not match planned %s; "
                "discarding the remaining sweep records and re-running live",
                e.get("counts"), counts,
            )
            sweep_cache.clear()
        trial = ClusterResource(
            nodes=list(cluster.nodes) + reuse.fakes(max(counts)),
            pods=list(cluster.pods),
            daemonsets=list(cluster.daemonsets),
            others=dict(cluster.others),
        )
        scenarios = [Scenario(name=f"+{k}", node_count=n_base + k) for k in counts]
        metrics.CAPACITY_PROBES.inc(len(counts))
        metrics.NODE_BUCKET.set(n_pad_sweep)
        reuse.rungs_touched.add(n_pad_sweep)
        pre = reuse.preencoded(max(counts), n_pad_sweep)
        t0 = time.monotonic()
        holder = {}

        def run():
            sim = Simulator(
                trial, weights=weights, use_greed=use_greed, mesh=mesh, n_pad=n_pad_sweep,
                expand_cache=expand_cache, preencoded=pre, device=dev,
            )
            holder["sim"] = sim
            return sim.run_scenarios(apps, scenarios, materialize=False)

        with span("capacity-sweep", lanes=len(counts), phase=phase):
            outs = guarded_call("capacity-sweep", run, call_deadline_s())
        if outs is None:
            return None
        reuse.capture(holder["sim"], n_base + max(counts), n_pad_sweep)
        metrics.BATCH_SWEEP_DURATION.observe(time.monotonic() - t0)
        verdicts = [_good_outcome(o) for o in outs]
        attempts += len(counts)
        batched_calls += 1
        if journal is not None:
            journal.append("sweep", phase=phase, counts=counts, good=verdicts,
                           n_pad=n_pad_sweep)
        return verdicts

    g0, base = probe(0)
    if g0:
        if base is None:
            base = finalize(0, None)
        metrics.CAPACITY_NODES_ADDED.set(0)
        return CapacityPlan(0, base, attempts, retries)

    if mode == "batched":
        # geometric ladder, LADDER_LANES counts per sweep, seeded by the
        # demand estimate as the serial exponential phase is
        ladder = []
        k = seed_hi or 1
        while k <= max_new_nodes:
            ladder.append(k)
            k *= 2
        hi: Optional[int] = None
        lo = 0
        fell_back = False
        n_pad_ladder = 0
        for start in range(0, len(ladder), LADDER_LANES):
            chunk = ladder[start:start + LADDER_LANES]
            n_pad_ladder = node_bucket(n_base + chunk[-1])
            verdicts = sweep(chunk, n_pad_ladder, "ladder")
            if verdicts is None:
                fell_back = True
                break
            goods = [c for c, g in zip(chunk, verdicts) if g]
            if goods:
                hi = min(goods)
                lo = max([lo] + [c for c, g in zip(chunk, verdicts) if not g and c < hi])
                break
            lo = max([lo] + chunk)
        if fell_back:
            log.warning(
                "plan_capacity: workload has preemption-eligible pods; batched "
                "sweep cannot reproduce per-scenario preemption, using serial bisection"
            )
            mode = "serial"
        elif hi is None:
            return None  # the whole ladder failed: the workload does not fit
        else:
            # close (lo, hi] with up to SWEEP_LANES interior candidates per
            # sweep, every sweep on the ladder's node bucket
            while hi - lo > 1:
                width = hi - lo - 1
                if width <= SWEEP_LANES:
                    cands = list(range(lo + 1, hi))
                else:
                    step = (hi - lo) / (SWEEP_LANES + 1)
                    cands = sorted({
                        min(hi - 1, max(lo + 1, lo + int(round(step * (i + 1)))))
                        for i in range(SWEEP_LANES)
                    })
                verdicts = sweep(cands, n_pad_ladder, "refine")
                if verdicts is None:  # unreachable after a live ladder sweep
                    raise RuntimeError("plan_capacity: a refine sweep refused the workload")
                goods = [c for c, g in zip(cands, verdicts) if g]
                if goods:
                    hi = min(goods)
                bads = [c for c, g in zip(cands, verdicts) if not g and c < hi]
                if bads:
                    lo = max(bads)
            best_result = finalize(hi, node_bucket(n_base + hi))
            metrics.CAPACITY_NODES_ADDED.set(hi)
            return CapacityPlan(hi, best_result, attempts, retries, batched_calls)

    # exponential growth to a bracket from the demand estimate, then a
    # bisection over the FULL [0, hi] with every probe on the bracket's
    # node bucket
    lo, hi = 0, (seed_hi or 1)
    best_result: Optional[SimulateResult] = None
    while hi <= max_new_nodes:
        g, hi_result = probe(hi)
        if g:
            best_result = hi_result
            break
        lo = hi  # a failed probe is a verified lower bound
        hi *= 2
    else:
        return None
    best = hi
    n_pad = node_bucket(n_base + hi)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        g, res = probe(mid, n_pad=n_pad)
        if g:
            hi, best, best_result = mid, mid, res
        else:
            lo = mid
    if best_result is None or best_result is not last_live:
        best_result = finalize(best, n_pad)
    metrics.CAPACITY_NODES_ADDED.set(best)
    return CapacityPlan(best, best_result, attempts, retries)
