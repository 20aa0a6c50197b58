"""The port's `version`, `gen-doc` and `warmup --check` verbs against the
JAX CLI's, on the CPU: the same version line; the same document files,
headings and cross-links for the verbs both CLIs have; the warm-start
check's answer equal to the JAX sweep's constant, with no kernel built.
"""

import pytest
import json

import torch

from open_simulator_tpu.cli import main as jcli
from open_simulator_tpu_torch import cli, sim_configs

torch.set_num_threads(1)  # tiny tensors: threads only add contention


def test_version_line_equals_jax(capsys):
    assert jcli.main(["version"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out == want
    assert cli.VERSION == jcli.VERSION


def _doc_outline(path):
    """The headings and links of a generated document: what the layout
    fixes, apart from each parser's own help text."""
    return [line for line in path.read_text().splitlines()
            if line.startswith(("## ", "### ", "* [simon"))]


def test_gen_doc_layout_equals_jax(tmp_path, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["gen-doc", "--output-dir", str(jdir)]) == 0
    capsys.readouterr()
    assert cli.main(["gen-doc", "--output-dir", str(tdir)]) == 0
    wrote = capsys.readouterr().out.splitlines()
    port_files = {p.name for p in tdir.iterdir()}
    assert {f"wrote {tdir / f}" for f in port_files} == set(wrote)
    verbs = {"apply", "audit", "chaos", "check", "interleave", "lint", "preflight", "profile",
             "prove", "runs", "server", "sweep", "warmup", "version", "gen-doc"}
    assert port_files == {"simon.md"} | {f"simon_{v}.md" for v in verbs}
    shared = port_files & {p.name for p in jdir.iterdir()}
    assert shared == port_files  # every port verb is one of the reference's
    for name in sorted(shared - {"simon.md"}):
        assert _doc_outline(tdir / name) == _doc_outline(jdir / name), name
    root = (tdir / "simon.md").read_text()
    for v in verbs:
        assert f"* [simon {v}](simon_{v}.md)" in root


def test_warmup_check_cli(capsys):
    rc = cli.main(["warmup", "--check", "--device", "cpu", "--format", "json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["cold_compiles"] == 0
    assert doc["nodes_added"] == doc["batched_nodes_added"] == sim_configs.WARM_START_NODES_ADDED


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()
