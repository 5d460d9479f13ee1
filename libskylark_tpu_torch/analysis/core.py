"""Checker framework: parsed project model, rule registry, per-line
suppressions, and the committed shrink-only baseline (the port of
libskylark_tpu/analysis/core.py).

Dependency-free by design (stdlib ``ast`` only): the lint must run
wherever Python does, before — and regardless of — whatever else the
environment has. Nothing here imports torch or the package's runtime
modules; rules read *source*, not live objects (rule modules parse
``base/env.py`` / ``telemetry/names.py`` as text to extract
declarations — still no runtime import). :meth:`Project.load` reads
``libskylark_tpu_torch/`` unless told another package.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

#: The committed baseline of grandfathered findings. Shrink-only: the
#: gate fails on any finding not in the file (new debt) AND on any
#: entry no longer matching a finding (stale debt — remove the entry
#: when you fix the finding, so the file tracks reality exactly and
#: can only shrink).
BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

_SUPPRESS_RE = re.compile(
    r"#\s*skylark-lint:\s*disable=([A-Za-z0-9_,-]+)")


@dataclasses.dataclass
class Finding:
    """One rule violation. ``symbol`` is the stable anchor (qualified
    function, lock site, env/metric name) the baseline keys on —
    never a line number, so unrelated edits don't churn the file."""

    rule: str
    path: str          # package-relative posix path
    line: int
    symbol: str
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.symbol}: {self.message}")


class Module:
    """One parsed source file: AST + source lines + suppressions +
    import alias map (name -> dotted module target)."""

    def __init__(self, relpath: str, modname: str, source: str):
        self.relpath = relpath
        self.modname = modname
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.suppressed = self._parse_suppressions()
        self.import_aliases = self._parse_imports()

    def _parse_suppressions(self) -> Dict[int, set]:
        """lineno -> suppressed rule names. A directive on a code line
        covers that line; a directive alone on a comment line covers
        the next line (the 79-column escape hatch)."""
        out: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            target = i + 1 if text.lstrip().startswith("#") else i
            out.setdefault(target, set()).update(rules)
        return out

    def is_suppressed(self, rule: str, lineno: int) -> bool:
        rules = self.suppressed.get(lineno, ())
        return rule in rules or "all" in rules

    def _parse_imports(self) -> Dict[str, str]:
        """Top-level ``import x.y as z`` / ``from p import q as r``
        name bindings, as ``alias -> dotted target`` (modules) or
        ``alias -> dotted.target:name`` (imported symbols)."""
        aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue  # no relative imports in this repo
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = (
                        f"{node.module}:{a.name}")
        return aliases

    def resolve_alias_module(self, name: str) -> Optional[str]:
        """The dotted module ``name`` is bound to at module scope
        (``_env`` -> ``libskylark_tpu_torch.base.env``), or None."""
        target = self.import_aliases.get(name)
        if target is None or ":" not in target:
            return target
        # ``from pkg import sub`` binds a module when pkg.sub exists as
        # a module path; the project decides (callers check membership)
        pkg, sym = target.split(":", 1)
        return f"{pkg}.{sym}"


class Project:
    """Every parsed module under one (or more) roots."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: Dict[str, Module] = {}

    @classmethod
    def load(cls, root: str,
             package: str = "libskylark_tpu_torch") -> "Project":
        proj = cls(root)
        pkg_dir = os.path.join(proj.root, package)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__",)]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                proj.add_file(path)
        return proj

    def add_file(self, path: str) -> Module:
        rel = os.path.relpath(os.path.abspath(path),
                              self.root).replace(os.sep, "/")
        modname = rel[:-3].replace("/", ".")
        if modname.endswith(".__init__"):
            modname = modname[: -len(".__init__")]
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        mod = Module(rel, modname, source)
        self.modules[modname] = mod
        return mod

    def module_for(self, dotted: str) -> Optional[Module]:
        return self.modules.get(dotted)


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

_RULES: Dict[str, Callable[[Project], List[Finding]]] = {}
_RULE_DOCS: Dict[str, str] = {}


def rule(name: str, doc: str = ""):
    """Register a rule: a callable ``(Project) -> list[Finding]``."""

    def deco(fn):
        _RULES[name] = fn
        _RULE_DOCS[name] = doc or (fn.__doc__ or "").strip()
        return fn

    return deco


def registered_rules() -> Dict[str, str]:
    _ensure_rules_loaded()
    return dict(_RULE_DOCS)


def _ensure_rules_loaded() -> None:
    # rule modules self-register on import
    from libskylark_tpu_torch.analysis import rules  # noqa: F401


def run_rules(project: Project,
              only: Optional[List[str]] = None) -> List[Finding]:
    """Run every (or the selected) registered rule; suppressed
    findings are dropped here, centrally. A rule runs once per project
    and module set: a second call reuses its findings."""
    _ensure_rules_loaded()
    ident = tuple(id(m) for m in project.modules.values())
    cache = getattr(project, "_rule_cache", None)
    if cache is None or cache[0] != ident:
        cache = project._rule_cache = (ident, {})
    findings: List[Finding] = []
    for name, fn in sorted(_RULES.items()):
        if only and name not in only:
            continue
        if name not in cache[1]:
            cache[1][name] = list(fn(project))
        for f in cache[1][name]:
            mod = next((m for m in project.modules.values()
                        if m.relpath == f.path), None)
            if mod is not None and mod.is_suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def baseline_load(path: str = BASELINE_PATH) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return list(doc.get("findings", []))


def baseline_save(findings: List[Finding],
                  path: str = BASELINE_PATH) -> None:
    doc = {
        "comment": (
            "Grandfathered skylark-lint findings. SHRINK-ONLY: fix a "
            "finding, delete its entry. The gate fails on findings "
            "missing here (new debt) and on entries matching nothing "
            "(stale debt)."),
        "findings": [
            {"rule": f.rule, "path": f.path, "symbol": f.symbol,
             "message": f.message}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def compare_to_baseline(
        findings: List[Finding],
        path: str = BASELINE_PATH) -> Tuple[List[Finding], List[dict]]:
    """(new findings not in the baseline, stale baseline entries
    matching no current finding). Both must be empty for the gate."""
    base = baseline_load(path)
    base_keys = {(b["rule"], b["path"], b["symbol"], b["message"])
                 for b in base}
    current_keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in base_keys]
    stale = [b for b in base
             if (b["rule"], b["path"], b["symbol"], b["message"])
             not in current_keys]
    return new, stale
