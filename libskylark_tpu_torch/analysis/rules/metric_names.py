"""``metric-names`` — every telemetry instrument is declared once (the
port of libskylark_tpu/analysis/rules/metric_names.py).

The unified registry (r10) made metric *plumbing* uniform; the names
stayed convention. This rule makes the convention checkable against
:mod:`libskylark_tpu_torch.telemetry.names`:

- a ``counter("x")`` / ``gauge("x")`` / ``histogram("x")`` creation
  whose name is not declared → finding;
- a declared name created at more than one call site → finding (two
  sites silently share one instrument, or disagree on kind and raise);
- a creation whose kind differs from the declaration → finding;
- a declaration with no creation site → finding (stale — delete it);
- a name that would not render as a valid Prometheus metric after the
  exporter's ``.`` → ``_`` mapping → finding;
- a non-literal name argument → finding (unauditable).

Creation sites are calls ``<telemetry alias>.counter/gauge/histogram``
(``_metrics``, ``_telemetry``, ... — any alias resolving to
``libskylark_tpu_torch.telemetry`` or ``.telemetry.metrics``) or the bare
names imported from there. The registry's own module and the names
module are exempt (definitions, not uses).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from libskylark_tpu_torch.analysis.core import Finding, Project, rule

NAMES_MODULE = "libskylark_tpu_torch.telemetry.names"
_EXEMPT = ("libskylark_tpu_torch.telemetry.metrics", NAMES_MODULE)
_TELEMETRY_MODULES = ("libskylark_tpu_torch.telemetry",
                      "libskylark_tpu_torch.telemetry.metrics")
_KINDS = ("counter", "gauge", "histogram")
# the exporter maps "." to "_"; everything else must conform already
_PROM_OK = re.compile(r"^[a-z][a-z0-9_.]*$")


def declared_metrics(project: Project) -> Dict[str, str]:
    """The METRICS dict from telemetry/names.py, via AST."""
    mod = project.module_for(NAMES_MODULE)
    if mod is None:
        return {}
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)
                and node.target.id == "METRICS"
                and isinstance(node.value, ast.Dict)):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if (isinstance(k, ast.Constant)
                        and isinstance(v, ast.Constant)):
                    out[k.value] = v.value
            return out
    return {}


def _creation_sites(project: Project) -> List[Tuple[str, object, str, object]]:
    """(kind, name-node-or-None, relpath, call-node) for every
    instrument creation call outside the exempt modules."""
    sites = []
    for mod in project.modules.values():
        if mod.modname in _EXEMPT:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            kind = None
            if (isinstance(f, ast.Attribute) and f.attr in _KINDS
                    and isinstance(f.value, ast.Name)
                    and mod.resolve_alias_module(f.value.id)
                    in _TELEMETRY_MODULES):
                kind = f.attr
            elif isinstance(f, ast.Name) and f.id in _KINDS:
                target = mod.import_aliases.get(f.id, "")
                if target.split(":")[0] in _TELEMETRY_MODULES:
                    kind = f.id
            if kind is None:
                continue
            name_node = node.args[0] if node.args else None
            sites.append((kind, name_node, mod.relpath, node))
    return sites


@rule("metric-names",
      "telemetry instrument names are declared once in "
      "telemetry/names.py, Prometheus-conformant")
def check(project: Project) -> List[Finding]:
    declared = declared_metrics(project)
    findings: List[Finding] = []
    created: Dict[str, List[Tuple[str, int]]] = {}

    for kind, name_node, relpath, call in _creation_sites(project):
        if not (isinstance(name_node, ast.Constant)
                and isinstance(name_node.value, str)):
            findings.append(Finding(
                "metric-names", relpath, call.lineno, "<dynamic>",
                f"{kind}() with a non-literal name — metric names "
                f"must be auditable string literals"))
            continue
        name = name_node.value
        created.setdefault(name, []).append((relpath, call.lineno))
        if name not in declared:
            findings.append(Finding(
                "metric-names", relpath, call.lineno, name,
                f"metric {name!r} is not declared in "
                f"telemetry/names.py"))
        elif declared[name] != kind:
            findings.append(Finding(
                "metric-names", relpath, call.lineno, name,
                f"metric {name!r} created as {kind} but declared as "
                f"{declared[name]}"))
        if not _PROM_OK.match(name):
            findings.append(Finding(
                "metric-names", relpath, call.lineno, name,
                f"metric name {name!r} cannot render as a Prometheus "
                f"metric (want ^[a-z][a-z0-9_.]*$)"))

    for name, sites in created.items():
        if len(sites) > 1:
            where = ", ".join(f"{p}:{ln}" for p, ln in sites)
            findings.append(Finding(
                "metric-names", sites[1][0], sites[1][1], name,
                f"metric {name!r} created at {len(sites)} sites "
                f"({where}) — declare and create once"))

    names_mod = project.module_for(NAMES_MODULE)
    if names_mod is not None:
        for name in declared:
            if name not in created:
                findings.append(Finding(
                    "metric-names", names_mod.relpath, 1, name,
                    f"declared metric {name!r} has no creation site — "
                    f"stale declaration, delete it"))
    return findings
