"""Local stub servers on 127.0.0.1 for the extender and kubeConfig paths.

`StubExtender` speaks the scheduler-extender wire protocol (filter,
prioritize and preempt verbs; ExtenderArgs in, ExtenderFilterResult /
HostPriorityList / NodeNameToMetaVictims out) with a configurable
behavior, and records every request. `StubApiServer` answers GETs of a
fixed {api path: document} map, as a Kubernetes apiserver's list endpoints
do. Both run on a daemon thread on an ephemeral port; `chip_smoke.py` and
the port's tests drive `simulate()`, `plan_capacity` and `run_apply`
against them. `KUBE_APIS` is the apiserver's document map that both use,
`kubeconfig_doc` a kubeconfig for a server, and `write_kube_apply_config`
a simon config whose cluster is such a kubeConfig.

    stub = StubExtender({"allow": {"n1"}, "scores": {"n1": 10}})
    ... ExtenderConfig(url_prefix=stub.url, filter_verb="filter", ...)
    stub.close()

Extender behavior keys: `allow` (node names kept by filter, None = all),
`failed` ({node: message} FailedNodes), `error` (filter Error string),
`scores` ({node: 0..10} prioritize scores, 0 elsewhere), `http_error`
(status code returned to every request), `preempt_allow` (nodes kept in
the preempt verb's answer, None = all), `preempt_raw` (a literal
NodeNameToMetaVictims answer).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Tuple


def _victim_uid(p: dict) -> str:
    meta = (p or {}).get("metadata") or {}
    return meta.get("uid") or "{}/{}".format(meta.get("namespace", "default"), meta.get("name", ""))


def extender_response(behavior: dict, path: str, body: dict):
    """The stub extender's answer to one request (a JSON-able value)."""
    if path.endswith("/filter"):
        names = body.get("NodeNames")
        if names is None:
            names = [(i.get("metadata") or {}).get("name")
                     for i in (body.get("Nodes") or {}).get("items") or []]
        allow = behavior.get("allow")
        failed = behavior.get("failed") or {}
        keep = [n for n in names if (allow is None or n in allow) and n not in failed]
        if body.get("NodeNames") is not None:
            return {"NodeNames": keep, "FailedNodes": failed, "Error": behavior.get("error", "")}
        return {
            "Nodes": {"items": [{"metadata": {"name": n}} for n in keep]},
            "FailedNodes": failed,
            "Error": behavior.get("error", ""),
        }
    if path.endswith("/preempt"):
        if behavior.get("preempt_raw") is not None:
            return {"NodeNameToMetaVictims": behavior["preempt_raw"]}
        allow = behavior.get("preempt_allow")
        meta = body.get("NodeNameToMetaVictims")
        if meta is None:
            meta = {
                node: {
                    "Pods": [{"UID": _victim_uid(p)} for p in (v or {}).get("Pods") or []],
                    "NumPDBViolations": (v or {}).get("NumPDBViolations", 0),
                }
                for node, v in (body.get("NodeNameToVictims") or {}).items()
            }
        return {"NodeNameToMetaVictims": {
            node: v for node, v in meta.items() if allow is None or node in allow
        }}
    names = body.get("NodeNames")
    if names is None:
        names = [(i.get("metadata") or {}).get("name")
                 for i in (body.get("Nodes") or {}).get("items") or []]
    scores = behavior.get("scores") or {}
    return [{"Host": n, "Score": int(scores.get(n, 0))} for n in names]


class StubExtender:
    """A scheduler extender on 127.0.0.1 (HTTP/1.1 keep-alive, a thread per
    connection); `calls` holds (path, body) of every request in arrival
    order."""

    def __init__(self, behavior: dict) -> None:
        self.behavior = behavior
        self.calls: List[Tuple[str, dict]] = []
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out in separate writes: without this,
            # Nagle's algorithm holds the body for the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                with stub._lock:
                    stub.calls.append((self.path, body))
                status = stub.behavior.get("http_error")
                if status:
                    self.send_response(int(status))
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                out = json.dumps(extender_response(stub.behavior, self.path, body)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/ext"

    def verb_counts(self) -> Dict[str, int]:
        """Requests per verb (the last path component)."""
        out: Dict[str, int] = {}
        with self._lock:
            for path, _ in self.calls:
                verb = path.rsplit("/", 1)[-1]
                out[verb] = out.get(verb, 0) + 1
        return out

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class StubApiServer:
    """A read-only apiserver on 127.0.0.1 serving `apis` ({path: document},
    the query string ignored; 404 elsewhere). `auth_seen` holds each
    request's Authorization header."""

    def __init__(self, apis: Dict[str, dict]) -> None:
        self.apis = apis
        self.auth_seen: List[str] = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802
                stub.auth_seen.append(self.headers.get("Authorization"))
                doc = stub.apis.get(self.path.split("?")[0])
                if doc is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


# a read-only apiserver's list endpoints (tests/test_kubeclient.py's)
def _kube_node(name):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}}}


def _kube_pod(name, phase="Running", node="n1", owner_kind=None, deleting=False):
    meta = {"name": name, "namespace": "default"}
    if owner_kind:
        meta["ownerReferences"] = [{"kind": owner_kind, "name": "own", "controller": True}]
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {
        "metadata": meta,
        "spec": {"nodeName": node if phase == "Running" else "",
                 "containers": [{"name": "c", "image": "img",
                                 "resources": {"requests": {"cpu": "1"}}}]},
        "status": {"phase": phase},
    }


KUBE_APIS = {
    "/api/v1/nodes": {"items": [_kube_node("n1"), _kube_node("n2")]},
    "/api/v1/pods": {"items": [
        _kube_pod("run-1"), _kube_pod("pend-1", phase="Pending"),
        _kube_pod("ds-pod", owner_kind="DaemonSet"), _kube_pod("dying", deleting=True),
        _kube_pod("done", phase="Succeeded"),
    ]},
    "/apis/policy/v1beta1/poddisruptionbudgets": {"items": [
        {"metadata": {"name": "pdb", "namespace": "default"},
         "spec": {"minAvailable": 1, "selector": {"matchLabels": {"a": "b"}}}},
    ]},
    "/api/v1/services": {"items": []},
    "/apis/storage.k8s.io/v1/storageclasses": {"items": [{"metadata": {"name": "open-local-lvm"}}]},
    "/api/v1/persistentvolumeclaims": {"items": []},
    "/api/v1/configmaps": {"items": []},
    "/apis/apps/v1/daemonsets": {"items": [
        {"metadata": {"name": "agent", "namespace": "kube-system"},
         "spec": {"template": {"spec": {"containers": [
             {"name": "c", "image": "img", "resources": {"requests": {"cpu": "100m"}}}]}}}},
    ]},
    "/apis/apps/v1/statefulsets": {"items": [{"metadata": {"name": "db", "namespace": "default"}}]},
    "/apis/apps/v1/replicasets": {"items": [
        {"metadata": {"name": "web-abc123", "namespace": "default",
                      "ownerReferences": [{"kind": "Deployment", "name": "web"}]}},
    ]},
}


def kubeconfig_doc(server: str, token: str = "sekrit") -> dict:
    return {
        "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
        "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": server}}],
        "users": [{"name": "u", "user": {"token": token}}],
    }


def write_kube_apply_config(directory: str, server: str) -> str:
    """Write a kubeconfig for `server` and a simon config whose cluster is
    that kubeConfig and whose one app is the repo's
    example/application/simple; returns the config's path."""
    import os

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    kube = os.path.join(directory, "kubeconfig")
    with open(kube, "w") as fh:
        yaml.safe_dump(kubeconfig_doc(server), fh)
    cfg = {
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "kube"},
        "spec": {"cluster": {"kubeConfig": kube},
                 "appList": [{"name": "simple",
                              "path": os.path.join(repo, "example", "application", "simple")}]},
    }
    path = os.path.join(directory, "simon-kube.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path
