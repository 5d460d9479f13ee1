"""skylark-lint over the port (``libskylark_tpu_torch/analysis/``, ROADMAP
A item 3, C29) against the reference's (``libskylark_tpu/analysis/``).

- The reference's fixture corpus (``tests/lint_fixtures/``, untouched),
  copied with ``libskylark_tpu`` renamed ``libskylark_tpu_torch`` and, in
  the jit fixtures, ``jax.jit`` replaced by the port's ``compiled``: the
  port's rules give the reference rules' findings on the originals — the
  same rule, line, message and symbol, up to the package's name.
- The repo gates of ``tests/test_analysis.py``, over the port's tree: the
  gate exits 0 on the committed tree and baseline; an injected raw
  ``SKYLARK_*`` read and a stale baseline entry fail it; the static lock
  graph is acyclic; the metric names are clean; the rules are the
  reference's; the env table has the reference's rows.
- The runtime lock witness on a port serve leg agrees with the static
  graph (``tests/test_analysis.py:324-378``).
- Both call forms of ``engine.compiled`` make capture roots; torch's
  process-wide generator is host RNG.
- The faults the rules found in the port, each repaired (ROADMAP C29).

The port's tree is parsed and its rules run once for the file.
"""

from __future__ import annotations

import os
import re
import sys

import pytest

from libskylark_tpu.analysis import (
    Project as RProject, registered_rules as r_registered_rules,
    run_rules as r_run_rules,
)
from libskylark_tpu_torch.analysis import (
    Project, compare_to_baseline, registered_rules, run_rules,
)
from libskylark_tpu_torch.analysis import __main__ as lint
from libskylark_tpu_torch.analysis.callgraph import CallGraph
from libskylark_tpu_torch.analysis.rules import jit_purity
from libskylark_tpu_torch.analysis.rules.lock_discipline import (
    _find_cycles, static_lock_graph,
)
from libskylark_tpu_torch.base import locks as _locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
METRICS_PROJ = ("libskylark_tpu/telemetry/names.py", "app_ok.py",
                "app_flag.py")


@pytest.fixture(scope="module")
def tree():
    """(the port's parsed tree, every finding of every rule)."""
    proj = Project.load(REPO)
    return proj, run_rules(proj)


# ---------------------------------------------------------------------------
# the reference's fixtures, in both packages
# ---------------------------------------------------------------------------


def _port_text(text: str) -> str:
    text = re.sub(r"\blibskylark_tpu\b", "libskylark_tpu_torch", text)
    text = re.sub(r"^import jax$",
                  "from libskylark_tpu_torch.engine.compiled import compiled",
                  text, flags=re.M)
    return text.replace("jax.jit", "compiled")


def _normal(findings) -> list:
    return sorted((f.rule, f.path, f.line,
                   f.symbol.replace("libskylark_tpu_torch", "libskylark_tpu"),
                   f.message.replace("libskylark_tpu_torch",
                                     "libskylark_tpu"))
                  for f in findings)


def _both(tmp_path, rels, root=FIXTURES):
    """(reference findings on the originals, port findings on the
    rewritten copies), every rule."""
    ref, port = RProject(root), Project(str(tmp_path))
    for rel in rels:
        ref.add_file(os.path.join(root, rel))
        dst = tmp_path / _port_text(rel)
        dst.parent.mkdir(parents=True, exist_ok=True)
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            dst.write_text(_port_text(fh.read()), encoding="utf-8")
        port.add_file(str(dst))
    got_ref = _normal(r_run_rules(ref))
    got_port = _normal(run_rules(port))
    for i, f in enumerate(got_port):
        # the rewritten metrics tree's path names the port's package
        got_port[i] = (f[0], f[1].replace("libskylark_tpu_torch",
                                          "libskylark_tpu"), *f[2:])
    return got_ref, got_port


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(FIXTURES) if f.endswith(".py")))
def test_fixture_findings_match_the_reference(tmp_path, name):
    ref, port = _both(tmp_path, [name])
    assert port == ref
    if name.endswith("_flag.py"):
        assert ref, name


def test_metrics_fixture_findings_match_the_reference(tmp_path):
    ref, port = _both(tmp_path, METRICS_PROJ,
                      root=os.path.join(FIXTURES, "metrics_proj"))
    assert port == ref and len(ref) >= 6


def test_jit_fixture_roots_are_the_compiled_bodies(tmp_path):
    """The rewritten must-flag file's decorated body and the closure passed
    to ``compiled(...)`` are roots, each reaching its impurities."""
    _, port = _both(tmp_path, ["jit_impure_flag.py"])
    by_root: dict = {}
    for rule, _, _, symbol, msg in port:
        if rule != "jit-purity":
            continue
        kind = msg.split("reaches ")[1].split(" impurity")[0]
        by_root.setdefault(symbol.split(":")[1], set()).add(kind)
    assert by_root["impure_root"] == {"env", "clock", "host-rng",
                                      "mutable-global"}
    assert "env" in by_root["build.<locals>.inner"]


# ---------------------------------------------------------------------------
# the gates over the port's tree
# ---------------------------------------------------------------------------


def test_the_gate_passes_on_the_committed_tree(tree, capsys):
    proj, findings = tree
    new, stale = compare_to_baseline(findings)
    assert new == [] and stale == [], [f.render() for f in new] + stale
    assert lint.main([], project=proj) == 0
    assert "0 new" in capsys.readouterr().out


def test_python_m_runs_the_driver(monkeypatch, capsys):
    """``-m``'s own path (``runpy``, as ``python -m`` runs a package):
    the rules listed, exit 0; an unknown flag is a usage error, 2."""
    import runpy

    # run as a fresh ``__main__``, as ``-m`` does (this file imported the
    # module under its own name)
    monkeypatch.delitem(sys.modules, "libskylark_tpu_torch.analysis.__main__")
    for argv, code in ((["--list-rules"], 0), (["--bogus"], 2)):
        monkeypatch.setattr(sys, "argv", ["analysis", *argv])
        with pytest.raises(SystemExit) as stop:
            runpy.run_module("libskylark_tpu_torch.analysis",
                             run_name="__main__", alter_sys=True)
        assert stop.value.code == code
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.strip()] == sorted(registered_rules())


def test_an_injected_raw_read_fails_the_gate(tree, tmp_path):
    proj, _ = tree
    bad = tmp_path / "bad_module.py"
    bad.write_text("import os\n\n\ndef leak():\n"
                   "    return os.environ.get('SKYLARK_TELEMETRY')\n")
    copy = Project(proj.root)
    copy.modules = dict(proj.modules)
    mod = copy.add_file(str(bad))
    mod.relpath = "libskylark_tpu_torch/bad_module.py"
    new, _ = compare_to_baseline(run_rules(copy, only=["env-registry"]))
    assert [f.symbol for f in new] == ["SKYLARK_TELEMETRY"]


def test_a_stale_baseline_entry_fails_the_gate(tree, tmp_path):
    import json

    from libskylark_tpu_torch.analysis import baseline_load

    _, findings = tree
    base = baseline_load()
    base.append({"rule": "env-registry",
                 "path": "libskylark_tpu_torch/gone.py",
                 "symbol": "SKYLARK_GONE", "message": "fixed"})
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"findings": base}))
    new, stale = compare_to_baseline(findings, path=str(path))
    assert new == [] and [b["symbol"] for b in stale] == ["SKYLARK_GONE"]


def test_the_static_lock_graph_is_acyclic_and_sees_the_mesh(tree):
    g = static_lock_graph(tree[0])
    assert _find_cycles({a: list(b) for a, b in g["edges"].items()}) == []
    assert {"serve.state", "serve.mesh"} <= set(g["sites"])


def test_the_metric_names_are_clean(tree):
    assert [f for f in tree[1] if f.rule == "metric-names"] == []


def test_the_rules_are_the_references():
    assert set(registered_rules()) == set(r_registered_rules()) == {
        "jit-purity", "lock-discipline", "env-registry", "metric-names"}


def test_the_env_table_has_the_references_rows(tree, tmp_path):
    """Every row of the reference's committed ``docs/env_vars.rst``, in
    order, with its kind, default and propagation; the Role column is the
    port's own doc (what reads the variable in the port, and the four
    departures of ROADMAP C26)."""
    with open(os.path.join(REPO, "docs", "env_vars.rst")) as fh:
        ref = re.findall(r"   \* - ``(SKYLARK_\w+)``\n     - (.*)\n"
                         r"     - ``(.*)``\n     - (yes|no)\n", fh.read())
    assert lint.main(["--env-table", str(tmp_path / "t.rst")],
                     project=tree[0]) == 0
    got = re.findall(r"   \* - ``(SKYLARK_\w+)``\n     - (.*)\n"
                     r"     - ``(.*)``\n     - (yes|no)\n",
                     (tmp_path / "t.rst").read_text())
    assert got == ref and len(ref) == 88


# ---------------------------------------------------------------------------
# the runtime witness against the static graph
# ---------------------------------------------------------------------------


@pytest.fixture()
def witness():
    _locks.enable_witness(True)
    _locks.reset_witness()
    yield
    _locks.enable_witness(False)
    _locks.reset_witness()


def test_the_witness_on_a_serve_leg_agrees_with_the_static_graph(tree,
                                                                  witness):
    """The reference's serve leg (``test_witness_serve_leg_clean``) on a
    CPU executor: a poisoned request, forced flushes and a drain; no
    acquisition closes a cycle, and every witnessed edge joins sites the
    static analysis knows."""
    import numpy as np

    import libskylark_tpu_torch as P
    from libskylark_tpu_torch import engine, sketch as sk
    from libskylark_tpu_torch.resilience import faults

    rng = np.random.default_rng(0)
    T = sk.CWT(24, 8, P.Context(seed=0))
    ops = [rng.standard_normal((24, 3)).astype(np.float32)
           for _ in range(8)]
    plan = faults.FaultPlan({"seed": 3, "faults": [
        {"site": "serve.flush", "error": "SketchError", "tag": "poison"}]})
    with faults.fault_plan(plan):
        ex = engine.MicrobatchExecutor(max_batch=4, linger_us=10_000_000,
                                       device="cpu")
        futs = []
        for i, A in enumerate(ops):
            if i == 2:
                with faults.tag("poison"):
                    futs.append(ex.submit_sketch(T, A))
            else:
                futs.append(ex.submit_sketch(T, A))
            if (i + 1) % 4 == 0:
                ex.flush()
        assert ex.drain(timeout=60.0)
    assert all(f.done() for f in futs)
    assert type(futs[2].exception()).__name__ == "SketchError"
    rep = _locks.witness_report()
    assert rep["acquisitions"] > 0 and rep["violations"] == []
    _locks.check_witness()
    g = static_lock_graph(tree[0])
    known = set(g["sites"]) | set(g["named"])
    assert rep["edges"]
    for a, bs in rep["edges"].items():
        assert a in known and set(bs) <= known, (a, bs)


# ---------------------------------------------------------------------------
# the port's capture roots
# ---------------------------------------------------------------------------


def _roots(proj) -> set:
    graph = CallGraph.of(proj)
    facts = {m.modname: jit_purity._ModuleFacts(m)
             for m in proj.modules.values()}
    return set(jit_purity._roots(graph, facts))


def test_both_call_forms_of_compiled_make_roots(tmp_path):
    (tmp_path / "imported.py").write_text(
        "import time\n\n"
        "from libskylark_tpu_torch.engine.compiled import compiled\n\n\n"
        "def build():\n"
        "    def body(x):\n"
        "        return x * time.time()\n\n"
        "    return compiled(body, name='b')\n")
    (tmp_path / "attribute.py").write_text(
        "import os\n\n"
        "from libskylark_tpu_torch import engine\n\n\n"
        "def body(x):\n"
        "    return x * float(os.environ.get('X', '1'))\n\n\n"
        "def factory(k):\n"
        "    def run(x):\n"
        "        return x + len(os.getenv('Y', ''))\n\n"
        "    return run\n\n\n"
        "_c = engine.compiled(body, name='c')\n"
        "_d = engine.compiled(factory(2), name='d')\n")
    proj = Project(str(tmp_path))
    for f in ("imported.py", "attribute.py"):
        proj.add_file(str(tmp_path / f))
    assert _roots(proj) == {"imported:build.<locals>.body",
                            "attribute:body",
                            "attribute:factory.<locals>.run"}
    kinds = {(f.symbol, f.message.split("reaches ")[1].split(" ")[0])
             for f in run_rules(proj, only=["jit-purity"])}
    assert kinds == {("imported:build.<locals>.body", "clock"),
                     ("attribute:body", "env"),
                     ("attribute:factory.<locals>.run", "env")}


def test_the_ported_bodies_are_roots(tree):
    """The engine's captured bodies in the port's tree, in both forms: the
    serve flush builders' ``compiled(...)``, the solver modules'
    ``engine.compiled(...)`` and KRR's factories and parameter."""
    roots = _roots(tree[0])
    P = "libskylark_tpu_torch."
    assert {P + "engine.serve:_build_flush_fn.<locals>.batched_sketch",
            P + "engine.serve:_build_flush_fn.<locals>.batched_fastfood",
            P + "nla.svd:_svd_pipeline", P + "nla.svd:_symmetric_svd_pipeline",
            P + "algorithms.regression:_sketch_and_solve",
            P + "algorithms.regression:_precond_body",
            P + "ml.krr:_exact_program.<locals>.solve",
            P + "ml.krr:_predict_program.<locals>.run",
            P + "ml.krr:_features_ridge",
            P + "ml.krr:_split_features_ridge"} <= roots


def test_torchs_process_generator_is_host_rng(tmp_path):
    (tmp_path / "rng.py").write_text(
        "import torch\n\n"
        "from libskylark_tpu_torch.engine.compiled import compiled\n\n\n"
        "@compiled\n"
        "def seeded(x):\n"
        "    torch.manual_seed(0)\n"
        "    return x\n\n\n"
        "@compiled\n"
        "def drawn(x):\n"
        "    return x + torch.randn(3) + x.normal_()\n\n\n"
        "@compiled\n"
        "def own(x, g):\n"
        "    return x + torch.randn(3, generator=g)\n")
    proj = Project(str(tmp_path))
    proj.add_file(str(tmp_path / "rng.py"))
    got = sorted((f.symbol, f.message) for f in run_rules(proj))
    assert got == [
        ("rng:drawn", "traced root reaches host-rng impurity "
                      "(Tensor.normal_)"),
        ("rng:drawn", "traced root reaches host-rng impurity "
                      "(torch.randn)"),
        ("rng:seeded", "traced root reaches host-rng impurity "
                       "(torch.manual_seed)")]


# ---------------------------------------------------------------------------
# the faults the rules found in the port, repaired (ROADMAP C29)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["randgen.panels", "engine.load_keys",
                                  "kernels.build", "kernels.counts",
                                  "checkpoint.writer"])
def test_a_direct_lock_became_a_named_site(tree, site):
    """Five locks were ``threading.Lock()``, invisible to the witness and
    the static graph; each is a ``base.locks`` site now."""
    assert site in static_lock_graph(tree[0])["named"]
    assert not [f for f in tree[1] if f.rule == "lock-discipline"]


def test_the_declared_engine_metrics_are_created(tree):
    """``engine.load_seconds`` and ``engine.persistent_cache_failures``
    were declared and never created: the first is observed by a boot's
    captures, the second counts a persistent-cache request the port
    cannot wire."""
    import importlib
    import warnings

    from libskylark_tpu_torch import telemetry

    compiled = importlib.import_module("libskylark_tpu_torch.engine.compiled")
    metrics = telemetry.registry().metrics()
    assert metrics["engine.load_seconds"].__class__.__name__ == "Histogram"
    fails = metrics["engine.persistent_cache_failures"]
    before = telemetry.snapshot()["metrics"][
        "engine.persistent_cache_failures"]["values"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert compiled.enable_persistent_cache(str(REPO)) is False
    after = telemetry.snapshot()["metrics"][
        "engine.persistent_cache_failures"]["values"]
    assert fails.__class__.__name__ == "Counter" and after != before
    assert not [f for f in tree[1] if f.rule == "metric-names"]
