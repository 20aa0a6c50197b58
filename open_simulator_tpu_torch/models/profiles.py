"""Scheduler profiles: plugin enable/disable, weights, multi-profile configs.

Parity: the reference assembles a KubeSchedulerConfiguration programmatically —
default provider plugins + Simon/Open-Local/Open-Gpu-Share injected, DefaultBinder
disabled, PercentageOfNodesToScore pinned to 100
(upstream `pkg/simulator/utils.go:304-381`) — optionally merged with a
user-supplied scheduler config file (`--default-scheduler-config`,
`cmd/apply/apply.go:28`), then hands every profile to scheduler.New
(`simulator.go:204-216`, WithProfiles...). Extenders in the user config
parse into ExtenderConfig entries; the port's engine does not call them yet
and refuses a config that has any (engine/simulator.py).

A profile carries (a) the weight vector for the score kernels, (b) a
bool[NUM_FILTERS] filter-enable mask honoring the config's Filter
enable/disable lists, keyed by schedulerName. Kube plugin names map to kernel
names so user config files written for the reference keep working.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..ops.kernels import DEFAULT_WEIGHTS, FILTER_PLUGIN_MAP, NUM_FILTERS

# kube plugin name -> kernel score name
PLUGIN_NAME_MAP = {
    "NodeResourcesLeastAllocated": "least_allocated",
    "NodeResourcesBalancedAllocation": "balanced_allocation",
    "NodeAffinity": "node_affinity",
    "TaintToleration": "taint_toleration",
    "PodTopologySpread": "topology_spread",
    "InterPodAffinity": "inter_pod_affinity",
    "NodePreferAvoidPods": "prefer_avoid_pods",
    "Simon": "simon",
    "Open-Local": "open_local",
    "Open-Gpu-Share": "gpu_share",
    # score-neutral in a fake cluster (no images, see SURVEY §2.2): accepted
    # and ignored so reference configs parse cleanly
    "ImageLocality": None,
    "NodeResourcesMostAllocated": None,
    "RequestedToCapacityRatio": None,
    "SelectorSpread": None,
    "DefaultPodTopologySpread": None,
}


@dataclass
class SchedulerProfile:
    scheduler_name: str = "default-scheduler"
    weights: Dict[str, float] = field(default_factory=lambda: dict(DEFAULT_WEIGHTS))
    # filter plugins enabled (index = kernels.F_*); Open-Local/Open-Gpu-Share
    # filters stay on regardless — the reference injects them after the user
    # config merge (utils.go:337-347)
    filters_enabled: List[bool] = field(
        default_factory=lambda: [True] * NUM_FILTERS
    )

    def with_plugin(self, kube_name: str, weight: float = 1.0) -> "SchedulerProfile":
        kernel = PLUGIN_NAME_MAP.get(kube_name)
        if kernel:
            self.weights[kernel] = weight
        return self

    def without_plugin(self, kube_name: str) -> "SchedulerProfile":
        kernel = PLUGIN_NAME_MAP.get(kube_name)
        if kernel:
            self.weights[kernel] = 0.0
        return self

    def disable_filter(self, kube_name: str) -> "SchedulerProfile":
        idx = FILTER_PLUGIN_MAP.get(kube_name)
        if idx is not None:
            self.filters_enabled[idx] = False
        return self

    def enable_filter(self, kube_name: str) -> "SchedulerProfile":
        idx = FILTER_PLUGIN_MAP.get(kube_name)
        if idx is not None:
            self.filters_enabled[idx] = True
        return self

    def filter_on_array(self) -> Optional[np.ndarray]:
        """bool[NUM_FILTERS] for the kernels, or None when everything is on
        (the kernels then skip the mask)."""
        if all(self.filters_enabled):
            return None
        return np.asarray(self.filters_enabled, bool)


_GO_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
    "s": 1.0, "m": 60.0, "h": 3600.0,
}


def _parse_go_duration(s: str) -> Optional[float]:
    """metav1.Duration / Go time.ParseDuration subset: one or more
    (number)(unit) segments, e.g. "5s", "1m30s", "100ms". Returns seconds,
    or None when the string is not a valid duration."""
    import re as _re

    if not s:
        return None
    sign = 1.0
    if s[0] in "+-":
        sign = -1.0 if s[0] == "-" else 1.0
        s = s[1:]
        if not s:
            return None   # a bare sign is not a duration
    if s == "0":
        return 0.0   # the one unit-less form Go accepts
    total = 0.0
    pos = 0
    seg = _re.compile(r"([\d.]+)(ns|us|µs|ms|s|m|h)")
    while pos < len(s):
        m = seg.match(s, pos)
        if not m:
            return None
        try:
            total += float(m.group(1)) * _GO_DURATION_UNITS[m.group(2)]
        except ValueError:
            return None
        pos = m.end()
    return sign * total if total else 0.0


def _is_extended_resource_name(name: str) -> bool:
    """v1helper.IsExtendedResourceName (vendored helpers.go:37-61): a
    qualified name outside the *kubernetes.io/ namespace — never a native
    resource (cpu/memory/pods and anything containing "kubernetes.io/"),
    never a requests.-prefixed quota name."""
    if "/" not in name or "kubernetes.io/" in name:
        return False  # IsNativeResource
    if name.startswith("requests."):
        return False
    return True


@dataclass
class ExtenderConfig:
    """One `extenders:` entry of a KubeSchedulerConfiguration (parity:
    vendored KubeSchedulerConfiguration.Extenders → HTTPExtender,
    vendor/.../scheduler/core/extender.go:93-123). preemptVerb wires into the
    preemption pass (ProcessPreemption, engine/preemption.py). bindVerb is
    accepted but inert: simon disables DefaultBinder and binds through its
    own plugin."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    preempt_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout_s: float = 30.0
    node_cache_capable: bool = False
    # resource names; empty = interested in every pod (extender.go:442-445)
    managed_resources: List[str] = field(default_factory=list)
    # managedResources[].ignoredByScheduler names: the reference adds these
    # to NodeResourcesFit's IgnoredResources for every profile
    # (vendor/.../scheduler/factory.go:105-130) so the in-tree resource fit
    # never rejects a pod for an extender-owned resource — the engine skips
    # encoding them into the fit tensors (ops/encode.Encoder).
    ignored_resources: List[str] = field(default_factory=list)
    ignorable: bool = False

    @staticmethod
    def from_dict(d: dict) -> "ExtenderConfig":
        timeout = d.get("httpTimeout")
        seconds = 30.0
        if isinstance(timeout, (int, float)):
            seconds = float(timeout)
        elif isinstance(timeout, str) and timeout:
            parsed = _parse_go_duration(timeout.strip())
            if parsed is None:
                raise ValueError(
                    f"extender httpTimeout: invalid duration {timeout!r}"
                )
            seconds = parsed
        if seconds < 0:
            # a Go http.Client with negative Timeout fails every request;
            # letting it through would crash urlopen(timeout<0)
            # mid-simulation instead of failing at parse time
            raise ValueError(
                f"extender httpTimeout: must not be negative, got {timeout!r}"
            )
        # httpTimeout: 0 is reference-valid (Go zero Timeout = no client
        # timeout); http_timeout_s=0.0 means "no timeout" in _send
        managed = [
            r for r in (d.get("managedResources") or []) if isinstance(r, dict)
        ]
        for r in managed:
            name = r.get("name", "")
            if name and not _is_extended_resource_name(name):
                # kube component-config validation requires managedResources
                # names to be extended resources (validation.go:149,
                # validateExtendedResourceName) — a native name like "cpu"
                # with ignoredByScheduler would disable the in-tree fit check
                raise ValueError(
                    f"extender managedResources: {name!r} is not an extended "
                    "resource name"
                )
        return ExtenderConfig(
            url_prefix=d.get("urlPrefix", "") or "",
            filter_verb=d.get("filterVerb", "") or "",
            prioritize_verb=d.get("prioritizeVerb", "") or "",
            preempt_verb=d.get("preemptVerb", "") or "",
            bind_verb=d.get("bindVerb", "") or "",
            weight=1 if d.get("weight") is None else int(d["weight"]),
            enable_https=bool(d.get("enableHTTPS")),
            http_timeout_s=seconds,
            node_cache_capable=bool(d.get("nodeCacheCapable")),
            managed_resources=[r.get("name", "") for r in managed],
            ignored_resources=[
                r.get("name", "")
                for r in managed
                if r.get("ignoredByScheduler") and r.get("name")
            ],
            ignorable=bool(d.get("ignorable")),
        )


@dataclass
class SchedulerConfig:
    """All profiles of one KubeSchedulerConfiguration, keyed by scheduler
    name. profiles[0] is the default profile (the reference forces
    Profiles[0].SchedulerName = default-scheduler, utils.go:318).
    `extenders` is config-global (shared by every profile), exactly like
    ComponentConfig.Extenders in the reference."""
    profiles: List[SchedulerProfile] = field(
        default_factory=lambda: [SchedulerProfile()]
    )
    extenders: List[ExtenderConfig] = field(default_factory=list)


def default_profile() -> SchedulerProfile:
    """Default provider score weights + Simon at 1 (utils.go:304-368 plus
    algorithmprovider/registry.go:71-148)."""
    return SchedulerProfile()


def _apply_profile_doc(profile: SchedulerProfile, p: dict) -> None:
    plugins = p.get("plugins") or {}
    score = plugins.get("score") or {}
    for item in score.get("disabled") or []:
        name = item.get("name", "")
        if name == "*":
            for k in list(profile.weights):
                if k != "simon":  # simon is re-injected unconditionally
                    profile.weights[k] = 0.0
        else:
            profile.without_plugin(name)
    for item in score.get("enabled") or []:
        profile.with_plugin(item.get("name", ""), float(item.get("weight") or 1))
    filt = plugins.get("filter") or {}
    for item in filt.get("disabled") or []:
        name = item.get("name", "")
        if name == "*":
            for kube_name in FILTER_PLUGIN_MAP:
                profile.disable_filter(kube_name)
        else:
            profile.disable_filter(name)
    for item in filt.get("enabled") or []:
        profile.enable_filter(item.get("name", ""))


def load_scheduler_config(path: Optional[str]) -> SchedulerConfig:
    """Parse a KubeSchedulerConfiguration YAML into simon defaults.

    Mirrors InitKubeSchedulerConfiguration: every profile's score plugin
    enable/disable adjusts weights, filter enable/disable flips the filter
    mask, multiple profiles are kept keyed by schedulerName; simon's own
    plugins stay enabled regardless (the reference injects them after
    merging). Extenders parse into ExtenderConfig entries; a filter-less,
    prioritize-less extender (bind/preempt only) is rejected since nothing
    would ever call it."""
    cfg = SchedulerConfig()
    if not path:
        return cfg
    import yaml

    with open(path, "r") as fh:
        doc = yaml.safe_load(fh) or {}
    kind = doc.get("kind", "")
    if kind and kind != "KubeSchedulerConfiguration":
        raise ValueError(f"{path}: expected KubeSchedulerConfiguration, got {kind}")
    for e in doc.get("extenders") or []:
        ext = ExtenderConfig.from_dict(e or {})
        if not ext.url_prefix:
            raise ValueError(f"{path}: extender missing urlPrefix")
        if not ext.filter_verb and not ext.prioritize_verb and not ext.preempt_verb:
            raise ValueError(
                f"{path}: extender {ext.url_prefix}: neither filterVerb, "
                "prioritizeVerb nor preemptVerb set — nothing for the "
                "engine to call"
            )
        if ext.prioritize_verb and ext.weight <= 0:
            # kube's component-config validation: a prioritizing extender
            # must have a positive weight
            raise ValueError(
                f"{path}: extender {ext.url_prefix}: prioritizeVerb set "
                f"with non-positive weight {ext.weight}"
            )
        cfg.extenders.append(ext)
    profiles = doc.get("profiles") or [{}]
    names = [
        (p or {}).get("schedulerName", "default-scheduler") for p in profiles
    ]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        # kube's component-config validation rejects duplicate profile names
        raise ValueError(
            f"{path}: duplicate schedulerName(s) across profiles: "
            f"{sorted(dupes)}"
        )
    cfg.profiles = []
    for p in profiles:
        p = p or {}
        profile = default_profile()
        if p.get("schedulerName"):
            profile.scheduler_name = p["schedulerName"]
        # percentageOfNodesToScore is accepted and ignored: the engine
        # scores every node (simon pins 100, utils.go:370)
        _apply_profile_doc(profile, p)
        cfg.profiles.append(profile)
    return cfg
