"""YAML/JSON ingestion: recursive file walker + multi-document decode.

Parity: the reference walks directories recursively collecting .yaml/.yml files
(upstream `pkg/utils/utils.go:43-70`), splits multi-doc manifests via
Helm's SplitManifests and decodes through the scheme codec
(`utils.go:73-87`, `pkg/simulator/utils.go:233-275`). We use PyYAML's
safe_load_all and keep decoded objects as dicts classified by `kind`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

def walk_files(path: str, exts: Tuple[str, ...]) -> List[str]:
    """All files under path (or path itself) with one of the extensions, sorted
    for determinism."""
    if os.path.isfile(path):
        return [path] if path.endswith(exts) else []
    found: List[str] = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for f in sorted(files):
            if f.endswith(exts):
                found.append(os.path.join(root, f))
    return found


def load_yaml_documents(text: str) -> List[dict]:
    import yaml

    docs = []
    for doc in yaml.safe_load_all(text):
        if isinstance(doc, dict) and doc.get("kind"):
            docs.append(doc)
    return docs


def objects_from_directory(path: str) -> List[dict]:
    """Decode every YAML object under a directory (recursively)."""
    objs: List[dict] = []
    for f in walk_files(path, (".yaml", ".yml")):
        with open(f, "r") as fh:
            objs.extend(load_yaml_documents(fh.read()))
    return objs


def json_files_by_stem(path: str) -> Dict[str, str]:
    """Map file basename (sans extension) → raw JSON text; used to match
    node-local-storage specs to node names (pkg/simulator/utils.go:385-401)."""
    out: Dict[str, str] = {}
    for f in walk_files(path, (".json",)):
        stem = os.path.splitext(os.path.basename(f))[0]
        with open(f, "r") as fh:
            text = fh.read()
        try:
            json.loads(text)
        except json.JSONDecodeError:
            continue
        out[stem] = text
    return out
