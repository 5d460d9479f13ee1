"""``lock-discipline`` — the static lock-order graph stays acyclic and
nothing blocking runs under a held lock (the port of
libskylark_tpu/analysis/rules/lock_discipline.py).

Motivating bug class (r9): the SIGTERM handler once drained an
executor while a flush worker held a lock the drain needed — a
deadlock that only manifests under the right interleaving. The
*ordering* both code paths exhibit on every run is statically visible;
this rule derives it from the AST over the same ``base.locks`` site
names the runtime witness records, so the two graphs are directly
comparable (the chaos battery validates them against each other).

Checks:

1. **lock naming** — ``threading.Lock()`` / ``RLock()`` / a bare
   ``Condition()`` constructed anywhere but ``base/locks.py``: use
   ``base.locks.make_lock(<site name>)`` so both graphs see the site
   (``Condition(existing_lock)`` is fine — it aliases a named lock).
2. **order cycles** — an edge A → B is recorded when B's site is
   acquired (directly, or transitively through resolvable calls) in a
   ``with A:`` body. Any cycle in the resulting graph is a finding.
3. **blocking under a lock** — in a ``with <lock>:`` body:
   ``Future.result()`` / ``.join()`` / ``time.sleep`` / pipe
   ``.recv()`` / ``.wait()`` on anything that is not a Condition over
   the held lock; plus callback fan-out (calling a loop variable —
   the subscriber-list pattern) and inline future resolution
   (``set_result`` / ``set_exception`` / ``add_done_callback`` run
   arbitrary client callbacks on this thread, under the lock).

The graph is exported for ``python -m libskylark_tpu_torch.analysis
--graph`` via :func:`static_lock_graph`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from libskylark_tpu_torch.analysis.callgraph import CallGraph
from libskylark_tpu_torch.analysis.core import Finding, Module, Project, rule

RULE = "lock-discipline"
LOCKS_MODULE = "libskylark_tpu_torch.base.locks"
_FACTORIES = ("make_lock", "make_rlock")


class LockIndex:
    """Where every named lock lives: module globals, class attributes,
    function locals — plus Condition aliases onto them."""

    def __init__(self, project: Project):
        self.project = project
        # (modname, scope, varname) -> site name;  scope is "" for
        # module level, the class name for attributes, the function
        # qualpath for locals
        self.slots: Dict[Tuple[str, str, str], str] = {}
        self._scopes: Dict[str, list] = {}
        for mod in project.modules.values():
            self._index(mod)
        # second pass: Condition aliases resolve against known slots
        for mod in project.modules.values():
            self._index_conditions(mod)

    def _factory_site(self, mod: Module,
                      call: ast.AST) -> Optional[str]:
        if not isinstance(call, ast.Call):
            return None
        f = call.func
        ok = False
        if isinstance(f, ast.Attribute) and f.attr in _FACTORIES:
            if (isinstance(f.value, ast.Name)
                    and mod.resolve_alias_module(f.value.id)
                    == LOCKS_MODULE):
                ok = True
        elif isinstance(f, ast.Name) and f.id in _FACTORIES:
            ok = (mod.import_aliases.get(f.id, "").split(":")[0]
                  == LOCKS_MODULE)
        if not ok:
            return None
        if (call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            return call.args[0].value
        return "<unnamed>"

    def _walk_scopes(self, mod: Module):
        """(scope, class_name, assign-node) of every Assign, tracking the
        lexical scope it executes in (walked once per module)."""
        got = self._scopes.get(mod.modname)
        if got is None:
            got = self._scopes[mod.modname] = list(self._scan_scopes(mod))
        return got

    def _scan_scopes(self, mod: Module):

        def visit(node, scope: str, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    yield from visit(child, child.name, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    fscope = (f"{scope}.{child.name}" if scope
                              else child.name)
                    yield from visit(child, fscope, cls)
                else:
                    if isinstance(child, ast.Assign):
                        yield (scope, cls, child)
                    yield from visit(child, scope, cls)

        yield from visit(mod.tree, "", None)

    def _slot_for_target(self, mod: Module, scope: str,
                         cls: Optional[str],
                         target: ast.AST) -> Optional[Tuple]:
        if isinstance(target, ast.Name):
            key_scope = "" if scope == "" else scope
            return (mod.modname, key_scope, target.id)
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self" and cls):
            return (mod.modname, f"class:{cls}", target.attr)
        return None

    def _index(self, mod: Module) -> None:
        for scope, cls, assign in self._walk_scopes(mod):
            site = self._factory_site(mod, assign.value)
            if site is None:
                continue
            for t in assign.targets:
                slot = self._slot_for_target(mod, scope, cls, t)
                if slot:
                    self.slots[slot] = site

    def _index_conditions(self, mod: Module) -> None:
        for scope, cls, assign in self._walk_scopes(mod):
            v = assign.value
            if not (isinstance(v, ast.Call) and v.args):
                continue
            f = v.func
            is_cond = ((isinstance(f, ast.Attribute)
                        and f.attr == "Condition")
                       or (isinstance(f, ast.Name)
                           and f.id == "Condition"))
            if not is_cond:
                continue
            inner = self.resolve(mod, scope, cls, v.args[0])
            if inner is None:
                continue
            for t in assign.targets:
                slot = self._slot_for_target(mod, scope, cls, t)
                if slot:
                    self.slots[slot] = inner

    def resolve(self, mod: Module, scope: str, cls: Optional[str],
                expr: ast.AST) -> Optional[str]:
        """Site name of a lock expression in the given scope."""
        if isinstance(expr, ast.Name):
            # function local (any enclosing function scope), else
            # module global
            parts = scope.split(".") if scope else []
            for cut in range(len(parts), 0, -1):
                hit = self.slots.get(
                    (mod.modname, ".".join(parts[:cut]), expr.id))
                if hit:
                    return hit
            return self.slots.get((mod.modname, "", expr.id))
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)):
            if expr.value.id == "self" and cls:
                return self.slots.get(
                    (mod.modname, f"class:{cls}", expr.attr))
            target = mod.resolve_alias_module(expr.value.id)
            if target:
                return self.slots.get((target, "", expr.attr))
        return None

    def is_condition_expr(self, mod: Module, scope: str,
                          cls: Optional[str], expr: ast.AST) -> bool:
        """Whether expr resolves through a Condition alias slot (its
        ``.wait()`` releases the lock — not a blocking violation)."""
        # conditions were folded into slots with their lock's name, so
        # any resolvable slot is either the lock or a condition on it;
        # for the blocking check both are acceptable wait targets.
        return self.resolve(mod, scope, cls, expr) is not None


# ---------------------------------------------------------------------------


def _fn_scope(qualname: str) -> str:
    """callgraph qualpath -> LockIndex scope string."""
    return qualname.split(":", 1)[1].replace(".<locals>", "")


def _analyze_function(graph: CallGraph, index: LockIndex, qn: str):
    """(direct-acquires, edges, calls-under-lock, blocking-findings)
    for one function."""
    fn = graph.functions[qn]
    mod = fn.module
    scope = _fn_scope(qn)
    cls = fn.cls
    acquires: Set[str] = set()
    edges: List[Tuple[str, str, int]] = []
    calls_under: List[Tuple[Tuple[str, ...], str, int]] = []
    blocking: List[Tuple[str, str, int]] = []

    def visit(node, held: Tuple[str, ...]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return
        if isinstance(node, ast.With):
            new = list(held)
            for item in node.items:
                site = index.resolve(mod, scope, cls, item.context_expr)
                if site:
                    acquires.add(site)
                    for h in new:
                        if h != site:
                            edges.append((h, site, node.lineno))
                    new.append(site)
            for child in node.body:
                visit(child, tuple(new))
            return
        if isinstance(node, ast.Call):
            f = node.func
            callee = graph.resolve_call(mod, fn, node)
            if held:
                if callee:
                    calls_under.append((held, callee, node.lineno))
                _check_blocking(node, f, held)
            # loop-variable callback fan-out handled via _check_blocking
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    loop_vars: Set[str] = set()

    def collect_loop_vars(node):
        for n in ast.walk(node):
            if isinstance(n, ast.For) and isinstance(n.target, ast.Name):
                loop_vars.add(n.target.id)

    collect_loop_vars(fn.node)

    def _check_blocking(call: ast.Call, f, held):
        desc = None
        if isinstance(f, ast.Attribute):
            if f.attr == "result":
                desc = "Future.result()"
            elif (f.attr == "join"
                    and not isinstance(f.value, ast.Constant)):
                desc = ".join()"
            elif f.attr == "recv":
                desc = "pipe .recv()"
            elif (f.attr == "wait"
                    and not index.is_condition_expr(mod, scope, cls,
                                                    f.value)):
                desc = ".wait() on a non-condition"
            elif f.attr == "sleep" and isinstance(f.value, ast.Name) \
                    and mod.resolve_alias_module(f.value.id) == "time":
                desc = "time.sleep()"
            elif f.attr in ("set_result", "set_exception",
                            "add_done_callback"):
                desc = f"Future.{f.attr}() (runs done-callbacks inline)"
        elif isinstance(f, ast.Name) and f.id in loop_vars:
            desc = f"callback fan-out ({f.id}(...) from a loop)"
        if desc:
            blocking.append((held[-1], desc, call.lineno))

    for stmt in fn.node.body:
        visit(stmt, ())
    return acquires, edges, calls_under, blocking


def static_lock_graph(project: Project) -> Dict[str, object]:
    """The derived graph: ``{"edges": {A: [B...]}, "sites": [...]}`` —
    the static counterpart of ``base.locks.witness_report()`` (derived
    once per project and module set)."""
    ident = tuple(id(m) for m in project.modules.values())
    cached = getattr(project, "_lock_graph", None)
    if cached is None or cached[0] != ident:
        cached = project._lock_graph = (ident, _derive_graph(project))
    return cached[1]


def _derive_graph(project: Project) -> Dict[str, object]:
    graph = CallGraph.of(project)
    index = LockIndex(project)
    direct_acq: Dict[str, Set[str]] = {}
    all_edges: Dict[str, Set[str]] = {}
    edge_sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
    calls_under_all = []
    blocking_all = []
    for qn in graph.functions:
        acq, edges, calls_under, blocking = _analyze_function(
            graph, index, qn)
        direct_acq[qn] = acq
        for a, b, ln in edges:
            all_edges.setdefault(a, set()).add(b)
            edge_sites.setdefault(
                (a, b), (graph.functions[qn].module.relpath, ln))
        calls_under_all.append((qn, calls_under))
        blocking_all.append((qn, blocking))
    # transitive: a call made under lock H reaches everything the
    # callee (transitively) acquires
    trans_acq = graph.propagate(direct_acq)
    for qn, calls_under in calls_under_all:
        for held, callee, ln in calls_under:
            for b in trans_acq.get(callee, ()):
                for h in held:
                    if h != b:
                        all_edges.setdefault(h, set()).add(b)
                        edge_sites.setdefault(
                            (h, b),
                            (graph.functions[qn].module.relpath, ln))
    return {
        "edges": {a: sorted(bs) for a, bs in sorted(all_edges.items())},
        "edge_sites": edge_sites,
        "sites": sorted({s for s in (set(all_edges)
                                     | {b for bs in all_edges.values()
                                        for b in bs})}),
        # every site a make_lock names, on an edge or not (a witnessed
        # acquisition the graph cannot reach statically is still a site
        # the analysis knows)
        "named": sorted(set(index.slots.values()) - {"<unnamed>"}),
        "blocking": blocking_all,
    }


def _find_cycles(edges: Dict[str, List[str]]) -> List[List[str]]:
    cycles: List[List[str]] = []
    seen_cycle_keys: Set[Tuple[str, ...]] = set()

    def dfs(start: str):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in edges.get(node, ()):
                if nxt == start:
                    cyc = path[:]
                    key = tuple(sorted(cyc))
                    if key not in seen_cycle_keys:
                        seen_cycle_keys.add(key)
                        cycles.append(cyc + [start])
                elif nxt not in path and len(path) < 8:
                    stack.append((nxt, path + [nxt]))

    for a in edges:
        dfs(a)
    return cycles


@rule(RULE,
      "static lock-order graph acyclic; no blocking calls, callback "
      "fan-outs, or direct threading.Lock() under/outside base.locks")
def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []

    # 1. direct lock construction outside base/locks.py
    for mod in project.modules.values():
        if mod.modname == LOCKS_MODULE:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = None
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and mod.resolve_alias_module(f.value.id)
                    == "threading"
                    and f.attr in ("Lock", "RLock")):
                name = f"threading.{f.attr}"
            elif (isinstance(f, ast.Attribute) and f.attr == "Condition"
                    and not node.args
                    and isinstance(f.value, ast.Name)
                    and mod.resolve_alias_module(f.value.id)
                    == "threading"):
                name = "threading.Condition (bare: hidden RLock)"
            if name:
                findings.append(Finding(
                    RULE, mod.relpath, node.lineno, name,
                    f"direct {name}() — construct through "
                    f"base.locks.make_lock(<site>) so the witness and "
                    f"the static graph see the site"))

    g = static_lock_graph(project)

    # 2. cycles
    graph_obj = CallGraph.of(project)  # for relpaths in findings
    for cyc in _find_cycles(g["edges"]):
        desc = " -> ".join(cyc)
        a, b = cyc[0], cyc[1]
        relpath, ln = g["edge_sites"].get((a, b), ("<unknown>", 1))
        findings.append(Finding(
            RULE, relpath, ln, f"cycle:{'|'.join(sorted(set(cyc)))}",
            f"lock-order cycle {desc} — two paths take these sites in "
            f"opposite orders"))

    # 3. blocking under a held lock
    for qn, blocking in g["blocking"]:
        fn = graph_obj.functions.get(qn)
        if fn is None:
            continue
        for held, desc, ln in blocking:
            if fn.module.is_suppressed(RULE, ln):
                continue
            findings.append(Finding(
                RULE, fn.module.relpath, ln, qn,
                f"{desc} while holding lock {held!r}"))
    return findings
