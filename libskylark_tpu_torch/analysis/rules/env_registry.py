"""``env-registry`` — every ``SKYLARK_*`` environment read goes
through the typed registry in ``base/env.py`` (the port of
libskylark_tpu/analysis/rules/env_registry.py).

Motivating bug class (r13): a process replica booted with whatever
``os.environ`` happened to hold at ``Process.start()`` — a variable
read raw somewhere could silently disagree between parent and child
because nothing forced it into the propagation snapshot. With the
registry, the declaration *is* the propagation decision, so the rule
reduces the invariant to "no reads outside the registry":

- ``os.environ[...]`` / ``os.environ.get(...)`` / ``os.getenv(...)`` /
  ``"SKYLARK_X" in os.environ`` with a ``SKYLARK_*`` literal, anywhere
  but ``base/env.py`` → finding;
- any env read with a **non-literal** key (it could hide a SKYLARK
  read) → finding;
- any ``SKYLARK_[A-Z0-9_]+`` token in a non-docstring string constant
  that is not a declared variable name → finding (catches typos and
  undeclared-but-referenced vars);
- a duplicate ``declare()`` would raise at import; the rule also flags
  ``declare()`` calls outside ``base/env.py``.

Writes (``os.environ[k] = v``, ``.pop``, ``.setdefault``) and whole-
environment snapshots (``dict(os.environ)``) are allowed — the replica
apply path and subprocess spawns need them; only *reads of specific
keys* route through the registry.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from libskylark_tpu_torch.analysis.core import Finding, Project, rule

ENV_MODULE = "libskylark_tpu_torch.base.env"
_TOKEN_RE = re.compile(r"SKYLARK_[A-Z0-9_]+")


def declared_names(project: Project) -> Set[str]:
    """Variable names declared in base/env.py, extracted from its AST
    (no runtime import — the lint must run on a broken tree too)."""
    mod = project.module_for(ENV_MODULE)
    if mod is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "declare"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value)
    return out


def _is_os_environ(node: ast.AST, mod) -> bool:
    """``os.environ`` (or an alias of the os module).environ."""
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and mod.resolve_alias_module(node.value.id) == "os")


def _docstring_positions(tree: ast.AST) -> Set[int]:
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                c = body[0].value
                for ln in range(c.lineno, (c.end_lineno or c.lineno) + 1):
                    out.add(ln)
    return out


@rule("env-registry",
      "SKYLARK_* env reads must go through base/env.py; referenced "
      "names must be declared there")
def check(project: Project) -> List[Finding]:
    declared = declared_names(project)
    findings: List[Finding] = []

    for mod in project.modules.values():
        if mod.modname == ENV_MODULE:
            continue
        doclines = _docstring_positions(mod.tree)
        for node in ast.walk(mod.tree):
            # -- raw reads ------------------------------------------------
            key_node = None
            form = None
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _is_os_environ(node.value, mod)):
                key_node, form = node.slice, "os.environ[...]"
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("get",)
                        and _is_os_environ(f.value, mod)):
                    key_node = node.args[0] if node.args else None
                    form = "os.environ.get(...)"
                elif (isinstance(f, ast.Attribute)
                        and f.attr == "getenv"
                        and isinstance(f.value, ast.Name)
                        and mod.resolve_alias_module(f.value.id) == "os"):
                    key_node = node.args[0] if node.args else None
                    form = "os.getenv(...)"
                elif (isinstance(f, ast.Name) and f.id == "declare"
                        and mod.import_aliases.get("declare", "")
                        .startswith(ENV_MODULE)):
                    findings.append(Finding(
                        "env-registry", mod.relpath, node.lineno,
                        "declare",
                        "declare() outside base/env.py — declarations "
                        "live in the registry module only"))
            elif (isinstance(node, ast.Compare)
                    and len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.In, ast.NotIn))
                    and _is_os_environ(node.comparators[0], mod)):
                key_node, form = node.left, "... in os.environ"

            if form is not None:
                if (isinstance(key_node, ast.Constant)
                        and isinstance(key_node.value, str)):
                    key = key_node.value
                    if key.startswith("SKYLARK_"):
                        findings.append(Finding(
                            "env-registry", mod.relpath, node.lineno,
                            key,
                            f"raw {form} read of {key} — use the "
                            f"base/env.py registry accessor"))
                else:
                    findings.append(Finding(
                        "env-registry", mod.relpath, node.lineno,
                        "<dynamic>",
                        f"{form} with a non-literal key — could hide "
                        f"a SKYLARK_* read; use base/env.py"))

            # -- undeclared names in string constants --------------------
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.lineno not in doclines):
                for token in _TOKEN_RE.findall(node.value):
                    tok = token.rstrip("_")
                    if tok not in declared and tok != "SKYLARK_":
                        findings.append(Finding(
                            "env-registry", mod.relpath, node.lineno,
                            tok,
                            f"references undeclared environment "
                            f"variable {tok} — declare it in "
                            f"base/env.py"))
    return findings
