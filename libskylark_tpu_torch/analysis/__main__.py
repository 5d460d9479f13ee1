"""skylark-lint over the port: ``python -m libskylark_tpu_torch.analysis``
(the port's counterpart of the reference's ``script/lint``).

Usage::

  python -m libskylark_tpu_torch.analysis          gate mode: run every
                                                   rule over
                                                   libskylark_tpu_torch/,
                                                   compare against the
                                                   committed baseline
  ... --all                  print every finding (baseline ignored)
  ... --rules a,b            restrict to the named rules
  ... --write-baseline       rewrite the baseline from the current
                             findings (to DELETE entries of fixed
                             findings — adding debt is a reviewed diff)
  ... --list-rules           names + one-liners
  ... --graph                the static lock-order graph as JSON
                             (compare with base.locks.witness_report())
  ... --env-table [PATH]     the generated env-var reference (RST), to
                             PATH or to standard output

Exit codes: 0 clean; 1 new findings or stale baseline entries (gate),
any finding (``--all``); 2 usage error.

``-m`` imports the package root (and with it torch); this module and the
rules import nothing but the standard library.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from typing import List, Optional

from libskylark_tpu_torch.analysis import (
    BASELINE_PATH, Project, baseline_save, compare_to_baseline,
    registered_rules, run_rules,
)
from libskylark_tpu_torch.analysis.rules.lock_discipline import (
    static_lock_graph,
)

PACKAGE = "libskylark_tpu_torch"
ENV_MODULE = f"{PACKAGE}.base.env"
#: The checkout the package lives in (what ``Project.load`` reads).
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_FLAGS = ("--all", "--write-baseline", "--list-rules", "--graph",
          "--env-table", "--rules")


def env_rows(project: Project) -> List[dict]:
    """``base/env.py``'s declarations, from its AST, sorted by name: each
    row's name, kind, default (its repr, or ``(computed)``), propagate
    flag and doc (whitespace folded)."""
    mod = project.module_for(ENV_MODULE)
    rows = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "declare" and node.args
                and isinstance(node.args[0], ast.Constant)):
            continue
        kw = {k.arg: k.value for k in node.keywords}

        def const(key, default=None):
            v = kw.get(key)
            return v.value if isinstance(v, ast.Constant) else default

        default_node = kw.get("default")
        if isinstance(default_node, ast.Constant):
            default = repr(default_node.value)
        elif default_node is not None:
            try:
                default = repr(ast.literal_eval(default_node))
            except (ValueError, SyntaxError):
                default = "(computed)"
        else:
            default = "None"
        rows.append({
            "name": node.args[0].value,
            "kind": const("kind", "str"),
            "default": default,
            "propagate": bool(const("propagate", False)),
            "doc": " ".join((const("doc", "") or "").split()),
        })
    rows.sort(key=lambda r: r["name"])
    return rows


def env_table(project: Project) -> str:
    """``base/env.py``'s declarations as the RST reference the reference
    renders into its ``docs/env_vars.rst``, from the registry's AST."""
    lines = [
        ".. GENERATED by ``python -m libskylark_tpu_torch.analysis",
        "   --env-table`` from libskylark_tpu_torch/base/env.py — do not",
        "   edit by hand.",
        "",
        "Environment variables",
        "=====================",
        "",
        "Every ``SKYLARK_*`` variable, from the typed registry",
        "(:mod:`libskylark_tpu_torch.base.env`). *Propagated* variables",
        "are snapshotted into process-replica children at spawn",
        "(:data:`libskylark_tpu_torch.fleet.replica.PROPAGATED_ENV`).",
        "",
        ".. list-table::",
        "   :header-rows: 1",
        "   :widths: 28 8 12 10 42",
        "",
        "   * - Variable",
        "     - Kind",
        "     - Default",
        "     - Propagated",
        "     - Role",
    ]
    for r in env_rows(project):
        lines.append(f"   * - ``{r['name']}``")
        lines.append(f"     - {r['kind']}")
        lines.append(f"     - ``{r['default']}``")
        lines.append(f"     - {'yes' if r['propagate'] else 'no'}")
        lines.append(f"     - {r['doc']}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None,
         project: Optional[Project] = None) -> int:
    """The driver; ``argv`` without the program name. ``project`` (a
    loaded :class:`Project`) skips loading the checkout."""
    args = list(sys.argv[1:] if argv is None else argv)
    only = None
    if "--rules" in args:
        i = args.index("--rules")
        if i + 1 >= len(args):
            print("--rules needs a comma-separated list", file=sys.stderr)
            return 2
        only = [r.strip() for r in args[i + 1].split(",")]
        del args[i:i + 2]
        unknown = sorted(set(only) - set(registered_rules()))
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
    table_path = None
    if "--env-table" in args:
        i = args.index("--env-table")
        if i + 1 < len(args) and not args[i + 1].startswith("-"):
            table_path = args.pop(i + 1)
    bad = [a for a in args if a not in _FLAGS]
    if bad:
        print(f"unknown argument(s): {' '.join(bad)}\n{__doc__}",
              file=sys.stderr)
        return 2

    if "--list-rules" in args:
        for name, doc in sorted(registered_rules().items()):
            print(f"{name:18s} {doc}")
        return 0

    if project is None:
        project = Project.load(ROOT, package=PACKAGE)

    if "--env-table" in args:
        text = env_table(project)
        if table_path is None:
            sys.stdout.write(text)
        else:
            with open(table_path, "w", encoding="utf-8") as fh:
                fh.write(text)
            print(f"wrote {table_path}")
        return 0

    if "--graph" in args:
        g = static_lock_graph(project)
        print(json.dumps({
            "edges": g["edges"],
            "sites": g["sites"],
            "named": g["named"],
            "edge_sites": {f"{a} -> {b}": f"{p}:{ln}"
                           for (a, b), (p, ln)
                           in sorted(g["edge_sites"].items())},
        }, indent=1))
        return 0

    findings = run_rules(project, only=only)

    if "--write-baseline" in args:
        baseline_save(findings)
        print(f"baseline: {len(findings)} finding(s) -> "
              f"{os.path.relpath(BASELINE_PATH, ROOT)}")
        return 0

    if "--all" in args:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
        return 1 if findings else 0

    # gate mode
    new, stale = compare_to_baseline(findings)
    if only:
        stale = [b for b in stale if b["rule"] in only]
    for f in new:
        print(f"NEW  {f.render()}")
    for b in stale:
        print(f"STALE baseline entry (finding fixed? delete it): "
              f"[{b['rule']}] {b['path']} {b['symbol']}: {b['message']}")
    n_base = len(findings) - len(new)
    print(f"skylark-lint: {len(findings)} finding(s) "
          f"({n_base} baselined, {len(new)} new), "
          f"{len(stale)} stale baseline entr(y/ies)")
    if new or stale:
        print("gate FAILED — fix the finding, suppress it with a "
              "justified '# skylark-lint: disable=<rule>', or (for "
              "stale entries) shrink the baseline")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
