"""The Applier: config → cluster/apps → simulate → report.

Parity: upstream `pkg/apply/apply.go` (NewApplier/Run), as the JAX package's
engine/apply.py ports it: builds the cluster from the config's custom
config directory, renders each app (chart or manifest directory), runs the
simulation on the caller's device and, when pods stay unscheduled and the
config names a new node, searches for the number of new nodes
(engine/capacity.py) or runs the interactive add-node loop; then prints the
report.

A config's `kubeConfig` snapshots a real cluster through
utils/kubeclient.py. With a run directory the run is journaled
(durable/journal.py) and resumable. Nothing falls back to another device:
the backend is reached through the watchdog's acquisition ladder, and a
watchdog deadline (OSIM_CALL_DEADLINE_S) is journaled and reaches the
caller as DeadlineExceeded; `simon runs resume` then continues the run on
the same device from what its journal committed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass, field as dataclass_field
from typing import List, Optional, TextIO

from ..api.config import SimonConfig
from ..core.objects import (
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    ANNO_WORKLOAD_NAMESPACE,
    Node,
)
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import metrics
from ..utils.tracing import span
from ..utils.yamlio import json_files_by_stem, load_yaml_documents, objects_from_directory
from .capacity import CapacityPlan, new_fake_nodes, plan_capacity
from .report import full_report
from .simulator import AppResource, ClusterResource, SimulateResult, simulate


class ApplyError(Exception):
    pass


def build_cluster(cfg: SimonConfig) -> ClusterResource:
    if cfg.kube_config:
        # a real cluster's snapshot (CreateClusterResourceFromClient,
        # simulator.go:503-601) through the built-in REST client
        from ..utils.kubeclient import KubeClientError, create_cluster_resource_from_kubeconfig

        try:
            cluster = create_cluster_resource_from_kubeconfig(cfg.kube_config)
        except KubeClientError as e:
            raise ApplyError(f"spec.cluster.kubeConfig: {e}")
        if not cluster.nodes:
            raise ApplyError("cluster snapshot returned no nodes")
        return cluster
    objs = objects_from_directory(cfg.custom_config)
    cluster = ClusterResource.from_objects(objs)
    if not cluster.nodes:
        raise ApplyError(f"no Node objects found under {cfg.custom_config}")
    cluster.attach_local_storage(json_files_by_stem(cfg.custom_config))
    return cluster


def render_chart(path: str, name: str) -> List[dict]:
    """Helm chart rendering (parity: chart.ProcessChart, pkg/chart/chart.go).

    The built-in renderer (utils/chart.py) handles the Go-template subset
    application charts use; charts beyond that subset go to a real
    `helm template` binary when one is installed."""
    from ..utils.chart import ChartError, process_chart

    try:
        return process_chart(path, release_name=name)
    except ChartError as e:
        helm = shutil.which("helm")
        if helm is None:
            raise ApplyError(
                f"app {name}: built-in chart renderer: {e} (and no helm "
                "binary is installed to fall back to; pre-render with "
                "`helm template` and point the app path at the output)"
            )
        proc = subprocess.run(
            [helm, "template", name, path], capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise ApplyError(f"helm template failed for {name}: {proc.stderr.strip()}")
        return load_yaml_documents(proc.stdout)


@dataclass
class FailedApp:
    """An app whose chart/manifests could not be rendered; the remaining
    apps still simulate."""

    name: str
    error: str


def build_apps(
    cfg: SimonConfig, failures: Optional[List[FailedApp]] = None
) -> List[AppResource]:
    """Render every app in the config. With `failures` supplied, an app whose
    chart fails to render is recorded there and skipped; without it the first
    render error raises."""
    import yaml

    apps = []
    for app in cfg.app_list:
        try:
            if app.chart:
                objects = render_chart(app.path, app.name)
            else:
                objects = objects_from_directory(app.path)
        except (ApplyError, yaml.YAMLError, OSError, UnicodeDecodeError, ValueError) as e:
            if failures is None:
                if isinstance(e, ApplyError):
                    raise
                raise ApplyError(f"app {app.name}: {e}")
            failures.append(FailedApp(name=app.name, error=str(e)))
            continue
        apps.append(AppResource(name=app.name, objects=objects))
    return apps


def load_new_node(cfg: SimonConfig) -> Optional[Node]:
    if not cfg.new_node:
        return None
    objs = objects_from_directory(cfg.new_node)
    nodes = [o for o in objs if o.get("kind") == "Node"]
    if not nodes:
        return None
    # the reference supports exactly one candidate node
    node = Node.from_dict(nodes[0])
    info = json_files_by_stem(cfg.new_node).get(node.name)
    if info is not None:
        node.meta.annotations[ANNO_NODE_LOCAL_STORAGE] = info
    return node


@dataclass
class ApplyOutcome:
    result: SimulateResult
    plan: Optional[CapacityPlan] = None
    report: str = ""
    failed_apps: List[FailedApp] = dataclass_field(default_factory=list)
    # provenance: the device the simulation ran on (the card's name on
    # CUDA). The reference's CPU-fallback fields stay, always empty: the
    # port never moves a run to another device.
    device: str = ""
    fallback: str = ""
    fallback_reason: str = ""


def placement_digest(result: SimulateResult) -> str:
    """Stable digest of the workload→node assignment, keyed by (workload
    kind/ns/name, node, replica count), not pod name: two runs produced the
    same plan iff their digests match."""
    counts: dict = {}
    for st in result.node_status:
        for p in st.pods:
            ann = p.meta.annotations
            wl = (
                ann.get(ANNO_WORKLOAD_KIND, ""),
                ann.get(ANNO_WORKLOAD_NAMESPACE, p.meta.namespace),
                # standalone pods carry no workload annotation; their
                # manifest name is already deterministic
                ann.get(ANNO_WORKLOAD_NAME) or p.meta.name,
                st.node.name,
            )
            counts[wl] = counts.get(wl, 0) + 1
    blob = "\n".join("\t".join(k) + f"\t{n}" for k, n in sorted(counts.items()))
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


def select_apps(apps: List[AppResource], out: TextIO, input_fn) -> List[AppResource]:
    """Interactive multi-select of the apps to deploy (parity: the survey
    MultiSelect prompt, apply.go:173-195): comma-separated indices or names;
    empty input deploys everything."""
    if not apps:
        return apps
    print("applications:", file=out)
    for i, app in enumerate(apps):
        print(f"  [{i}] {app.name}", file=out)
    raw = input_fn("deploy which apps? (comma list of numbers/names, empty = all) ")
    raw = (raw or "").strip()
    if not raw:
        return apps
    chosen: List[AppResource] = []
    by_name = {a.name: a for a in apps}
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.isdigit() and int(tok) < len(apps):
            app = apps[int(tok)]
        elif tok in by_name:
            app = by_name[tok]
        else:
            print(f"  ignoring unknown app {tok!r}", file=out)
            continue
        if app not in chosen:
            chosen.append(app)
    return chosen or apps


def run_apply(
    cfg: SimonConfig,
    interactive: bool = False,
    auto_plan: bool = True,
    out: Optional[TextIO] = None,
    input_fn=input,
    scheduler_config: str = "",
    use_greed: bool = False,
    extended_resources: Optional[List[str]] = None,
    run_dir: Optional[str] = None,
    resume: bool = False,
    config_path: str = "",
    device=DEFAULT_DEVICE,
) -> ApplyOutcome:
    """Simulate the config's apps on its cluster on `device` (CUDA by
    default). When pods stay unscheduled and the config names a new node:
    with `interactive`, the add-node loop (prompts through `input_fn`);
    else with `auto_plan`, the capacity search, which prints the
    reference's `N pod(s) unschedulable; searching ...` and `capacity plan:
    add K x <node> (A simulations)` lines and reports the planned cluster.
    Then the report (`extended_resources`: the extended views to show, None
    = every view with data) and a `device:` line.

    With `run_dir`, the run is journaled: `run_start` (or `run_resume`
    with `resume=True`), the backend acquisition, every capacity trial and
    the outcome record, and a timestamp-free `outcome.json` with the
    placement digest is written atomically; `resume=True` replays the
    journal so a crashed run re-simulates only what it never committed. A
    watchdog deadline is journaled (`watchdog`) and re-raised."""
    from ..durable import (
        DeadlineExceeded,
        RunJournal,
        acquire_backend,
        atomic_write,
        call_deadline_s,
        guarded_call,
    )
    from ..models.profiles import load_scheduler_config

    dev = resolve_device(device)
    report_to_file = out is not None and out is not sys.stdout
    out = out or sys.stdout
    # interactive prompts stay on the terminal when the report goes to a file
    ui_out = sys.stderr if report_to_file else out

    journal: Optional[RunJournal] = None
    if run_dir:
        journal = RunJournal.open(run_dir)
        if not journal.has("run_start"):
            journal.append("run_start", kind="apply", name=cfg.name, simon_config=config_path)
        if resume:
            metrics.RUN_RESUMED.inc()
            journal.append("run_resume")

    with span("backend-acquire"):
        backend = acquire_backend(journal=journal, device=dev)
    with span("build-cluster"):
        cluster = build_cluster(cfg)
    failed_apps: List[FailedApp] = []
    with span("render-apps"):
        apps = build_apps(cfg, failures=failed_apps)
    if report_to_file:
        # the report (with its FAILED APP lines) goes to the file, so
        # surface render failures on the terminal too
        for fa in failed_apps:
            print(f"app {fa.name}: failed to render: {fa.error}", file=ui_out)
    if interactive:
        apps = select_apps(apps, ui_out, input_fn)
    new_node = load_new_node(cfg)
    sched_cfg = load_scheduler_config(scheduler_config)
    profiles = sched_cfg.profiles
    extenders = sched_cfg.extenders
    plan: Optional[CapacityPlan] = None
    try:
        result = guarded_call(
            "apply-simulate",
            lambda: simulate(
                cluster, apps, profiles=profiles, use_greed=use_greed,
                extenders=extenders, device=dev,
            ),
            call_deadline_s(),
        )
        if result.unscheduled and new_node is not None:
            if interactive:
                result = _interactive_loop(
                    cluster, apps, new_node, result, ui_out, input_fn,
                    profiles=profiles, use_greed=use_greed, extenders=extenders, device=dev,
                )
            elif auto_plan:
                print(
                    f"{len(result.unscheduled)} pod(s) unschedulable; "
                    f"searching for minimum copies of node {new_node.name}...",
                    file=out,
                )
                with span("capacity-search"):
                    plan = plan_capacity(
                        cluster, apps, new_node, profiles=profiles, use_greed=use_greed,
                        extenders=extenders, journal=journal, resume=resume, device=dev,
                    )
                if plan is None:
                    print("capacity search failed: workload does not fit", file=out)
                else:
                    degraded = (
                        f", {plan.retries} retried on transient extender errors"
                        if plan.retries else ""
                    )
                    print(
                        f"capacity plan: add {plan.nodes_added} x {new_node.name} "
                        f"({plan.attempts} simulations{degraded})",
                        file=out,
                    )
                    result = plan.result
    except DeadlineExceeded as e:
        # the reference retries on the CPU here; the port records the fire
        # and stops, and `simon runs resume` continues on the same device
        if journal is not None:
            journal.append("watchdog", stage=e.stage, deadline_s=e.deadline_s)
            journal.close()
        raise

    with span("render-report"):
        report = full_report(result, extended_resources=extended_resources)
    if failed_apps:
        report += "\n" + "\n".join(f"FAILED APP {fa.name}: {fa.error}" for fa in failed_apps)
    outcome = "ok"
    if result.unscheduled:
        outcome = "unschedulable"
    elif failed_apps:
        outcome = "render_failed"
    metrics.APPLY_RUNS.inc(outcome=outcome)
    # color only live terminal output; the returned report and a report
    # file stay plain text
    display = report
    if not report_to_file and getattr(out, "isatty", lambda: False)():
        from ..utils.tables import colorize_report

        display = colorize_report(report)
    print(display, file=out)
    print(f"device: {backend['device']}", file=out)

    digest = placement_digest(result)
    if journal is not None:
        journal.append(
            "run_end", outcome=outcome, nodes_added=(plan.nodes_added if plan else 0),
            digest=digest,
        )
        # timestamp-free, so an interrupted and resumed run writes the
        # same bytes as an uninterrupted one
        atomic_write(
            os.path.join(journal.run_dir, "outcome.json"),
            json.dumps(
                {
                    "outcome": outcome,
                    "device": backend["device"],
                    "fallback": "",
                    "fallback_reason": "",
                    "nodes_added": plan.nodes_added if plan else 0,
                    "attempts": plan.attempts if plan else 0,
                    "retries": plan.retries if plan else 0,
                    "unscheduled": len(result.unscheduled),
                    "failed_apps": [fa.name for fa in failed_apps],
                    "placement_digest": digest,
                },
                indent=2,
                sort_keys=True,
            ) + "\n",
        )
        journal.close()
    return ApplyOutcome(
        result=result, plan=plan, report=report, failed_apps=failed_apps,
        device=backend["device"],
    )


def _interactive_loop(
    cluster: ClusterResource,
    apps,
    new_node: Node,
    result: SimulateResult,
    out: TextIO,
    input_fn,
    weights=None,
    use_greed: bool = False,
    profiles=None,
    extenders=None,
    device=DEFAULT_DEVICE,
) -> SimulateResult:
    """The reference's manual loop (apply.go:203-259): add one node, show
    the reasons, or quit, re-simulating from scratch after each node."""
    added = 0
    while result.unscheduled:
        print(f"{len(result.unscheduled)} pod(s) failed to schedule.", file=out)
        choice = input_fn("[a]dd a new node, show [r]easons, or [q]uit? ").strip().lower()
        if choice.startswith("r"):
            for u in result.unscheduled:
                print(f"  {u.pod.key}: {u.reason}", file=out)
            continue
        if not choice.startswith("a"):
            break
        added += 1
        trial = ClusterResource(
            nodes=list(cluster.nodes) + new_fake_nodes(new_node, added),
            pods=list(cluster.pods),
            daemonsets=list(cluster.daemonsets),
            others=dict(cluster.others),
        )
        result = simulate(
            trial, apps, weights=weights, use_greed=use_greed,
            profiles=profiles, extenders=extenders, device=device,
        )
    return result
