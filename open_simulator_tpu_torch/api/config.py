"""The Simon config CR (apiVersion simon/v1alpha1, kind Config).

Parity: upstream `pkg/api/v1alpha1/types.go` and the validation in
`pkg/apply/apply.go:62-74,269-306`. Paths are resolved relative to the config
file's directory when not absolute (the reference resolves relative to CWD;
we accept both, preferring an existing CWD-relative path for compatibility).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class AppInConfig:
    name: str
    path: str
    chart: bool = False


@dataclass
class SimonConfig:
    name: str = ""
    custom_config: str = ""     # directory of cluster manifests
    kube_config: str = ""       # kubeconfig of a real cluster
    app_list: List[AppInConfig] = field(default_factory=list)
    new_node: str = ""          # directory/file with the candidate node

    @staticmethod
    def load(path: str) -> "SimonConfig":
        import yaml

        with open(path, "r") as fh:
            doc = yaml.safe_load(fh)
        if not isinstance(doc, dict):
            raise ValueError(f"invalid simon config: {path}")
        api_version = doc.get("apiVersion", "")
        kind = doc.get("kind", "")
        if kind != "Config" or not api_version.startswith("simon/"):
            raise ValueError(
                f"invalid simon config {path}: want kind Config, apiVersion simon/v1alpha1, "
                f"got {kind}/{api_version}"
            )
        spec = doc.get("spec") or {}
        cluster = spec.get("cluster") or {}
        base = os.path.dirname(os.path.abspath(path))

        def resolve(p: str) -> str:
            if not p or os.path.isabs(p) or os.path.exists(p):
                return p
            candidate = os.path.join(base, p)
            return candidate if os.path.exists(candidate) else p

        cfg = SimonConfig(
            name=(doc.get("metadata") or {}).get("name", ""),
            custom_config=resolve(cluster.get("customConfig", "") or ""),
            kube_config=resolve(cluster.get("kubeConfig", "") or ""),
            app_list=[
                AppInConfig(
                    name=a.get("name", f"app-{i}"),
                    path=resolve(a.get("path", "")),
                    chart=bool(a.get("chart")),
                )
                for i, a in enumerate(spec.get("appList") or [])
            ],
            new_node=resolve(spec.get("newNode", "") or ""),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """apply.go:269-306 parity: exactly one cluster source; paths exist."""
        if bool(self.custom_config) == bool(self.kube_config):
            raise ValueError(
                "simon config: exactly one of spec.cluster.customConfig / "
                "spec.cluster.kubeConfig must be set"
            )
        if self.custom_config and not os.path.exists(self.custom_config):
            raise ValueError(f"cluster customConfig path not found: {self.custom_config}")
        for app in self.app_list:
            if not app.path or not os.path.exists(app.path):
                raise ValueError(f"app {app.name}: path not found: {app.path}")
        if self.new_node and not os.path.exists(self.new_node):
            raise ValueError(f"newNode path not found: {self.new_node}")
