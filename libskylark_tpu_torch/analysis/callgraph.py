"""Best-effort project call graph for the transitive rules (the port
of libskylark_tpu/analysis/callgraph.py).

Resolution is deliberately conservative — a call the grapher cannot
resolve contributes nothing (no edge), so the transitive rules
(jit-purity, lock-discipline) under-approximate rather than hallucinate.
Resolved forms:

- ``f(...)``            — module-level function / nested function in
  the enclosing scope / symbol imported ``from mod import f``;
- ``self.m(...)``       — method of the lexically enclosing class;
- ``cls.m(...)`` / ``Klass.m(...)`` — method of a same-project class;
- ``alias.f(...)``      — function of an imported project module;
- a module-level alias of a top-level function (``get_x = get_y``) is
  that function;
- ``g(...)`` where ``g`` is a local variable the same function assigns
  one of those function references (``g = mod.f if c else mod.h``): an
  edge to each (the port's flush builders choose a kernel wrapper or its
  plain version this way).

Function identity is ``"<module>:<qualpath>"`` where qualpath mirrors
``ast`` nesting (``Class.method``, ``outer.<locals>.inner``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from libskylark_tpu_torch.analysis.core import Module, Project


class FunctionInfo:
    def __init__(self, module: Module, qualname: str,
                 node: ast.AST, cls: Optional[str]):
        self.module = module
        self.qualname = qualname            # "mod:Class.method"
        self.node = node
        self.cls = cls                      # enclosing class name or None
        self.calls: List[Tuple[ast.Call, int]] = []
        self._own: Optional[List[ast.AST]] = None
        self._own_by: Dict[type, List[ast.AST]] = {}

    def own_nodes(self, node_type=ast.AST) -> List[ast.AST]:
        """:func:`iter_own_nodes` of this function, walked once."""
        got = self._own_by.get(node_type)
        if got is None:
            if self._own is None:
                self._own = list(iter_own_nodes(self.node, ast.AST))
            got = self._own_by[node_type] = [
                n for n in self._own if isinstance(n, node_type)]
        return got


class CallGraph:
    """Function index + per-call resolution over one project."""

    @classmethod
    def of(cls, project: Project) -> "CallGraph":
        """The project's graph, built once for the rules of one run (and
        again when modules were added since)."""
        ident = tuple(id(m) for m in project.modules.values())
        cached = getattr(project, "_callgraph", None)
        if cached is None or cached[0] != ident:
            cached = project._callgraph = (ident, cls(project))
        return cached[1]

    def __init__(self, project: Project):
        self.project = project
        self.functions: Dict[str, FunctionInfo] = {}
        # (module, class) -> {method name -> qualname}
        self._methods: Dict[Tuple[str, str], Dict[str, str]] = {}
        # module -> {top-level fn name -> qualname}
        self._toplevel: Dict[str, Dict[str, str]] = {}
        # module -> {class name}
        self._classes: Dict[str, Set[str]] = {}
        # qualname -> its resolved direct calls, computed once
        self._direct: Dict[str, List[Tuple[str, ast.Call]]] = {}
        for mod in project.modules.values():
            self._index_module(mod)

    # -- indexing --

    def _index_module(self, mod: Module) -> None:
        self._toplevel.setdefault(mod.modname, {})
        self._classes.setdefault(mod.modname, set())

        def visit(node, prefix: str, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qp = (f"{prefix}.{child.name}" if prefix
                          else child.name)
                    qn = f"{mod.modname}:{qp}"
                    self.functions[qn] = FunctionInfo(mod, qn, child, cls)
                    if not prefix:
                        self._toplevel[mod.modname][child.name] = qn
                    elif cls is not None and prefix == cls:
                        self._methods.setdefault(
                            (mod.modname, cls), {})[child.name] = qn
                    visit(child, f"{qp}.<locals>", cls)
                elif isinstance(child, ast.ClassDef):
                    self._classes[mod.modname].add(child.name)
                    visit(child, child.name, child.name)
                else:
                    visit(child, prefix, cls)

        visit(mod.tree, "", None)
        # module-level aliases of top-level functions (``get_x = get_y``)
        top = self._toplevel[mod.modname]
        for node in mod.tree.body:
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in top):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in top:
                        top[t.id] = top[node.value.id]

    # -- resolution --

    def resolve_call(self, mod: Module, fn: FunctionInfo,
                     call: ast.Call) -> Optional[str]:
        """Callee qualname for a Call node, or None when unresolvable."""
        func = call.func
        if isinstance(func, ast.Name):
            return self._resolve_name(mod, fn, func.id)
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and fn.cls:
                    return self._methods.get(
                        (mod.modname, fn.cls), {}).get(func.attr)
                if base.id in self._classes.get(mod.modname, ()):
                    return self._methods.get(
                        (mod.modname, base.id), {}).get(func.attr)
                target = mod.resolve_alias_module(base.id)
                if target and target in self.project.modules:
                    return self._toplevel.get(target, {}).get(func.attr)
        return None

    def _resolve_name(self, mod: Module, fn: FunctionInfo,
                      name: str) -> Optional[str]:
        # nested function of any enclosing scope
        prefix = fn.qualname.split(":", 1)[1]
        parts = prefix.split(".")
        for cut in range(len(parts), 0, -1):
            cand = (f"{mod.modname}:"
                    f"{'.'.join(parts[:cut])}.<locals>.{name}")
            if cand in self.functions:
                return cand
        # module-level function
        qn = self._toplevel.get(mod.modname, {}).get(name)
        if qn:
            return qn
        # from mod import f
        target = mod.import_aliases.get(name)
        if target and ":" in target:
            pkg, sym = target.split(":", 1)
            if pkg in self.project.modules:
                return self._toplevel.get(pkg, {}).get(sym)
        return None

    def direct_calls(self, qn: str) -> List[Tuple[str, ast.Call]]:
        """Resolved (callee qualname, call node) pairs made directly
        inside ``qn`` (excluding its nested function bodies)."""
        out = self._direct.get(qn)
        if out is None:
            fn = self.functions[qn]
            local = self._local_refs(fn)
            out = []
            for call in fn.own_nodes(ast.Call):
                callee = self.resolve_call(fn.module, fn, call)
                if callee:
                    out.append((callee, call))
                elif isinstance(call.func, ast.Name):
                    out += [(c, call) for c in local.get(call.func.id, ())]
            self._direct[qn] = out
        return out

    def _local_refs(self, fn: FunctionInfo) -> Dict[str, List[str]]:
        """Local name -> the project functions the function's own
        assignments bind to it (``g = a.f if c else a.h``)."""
        refs: Dict[str, List[str]] = {}

        def funcs(expr) -> List[str]:
            if isinstance(expr, ast.IfExp):
                return funcs(expr.body) + funcs(expr.orelse)
            if isinstance(expr, (ast.Name, ast.Attribute)):
                qn = self.resolve_call(fn.module, fn, ast.Call(
                    func=expr, args=[], keywords=[]))
                return [qn] if qn else []
            return []

        for node in fn.own_nodes(ast.Assign):
            if len(node.targets) == 1 and isinstance(node.targets[0],
                                                     ast.Name):
                found = funcs(node.value)
                if found:
                    refs.setdefault(node.targets[0].id, []).extend(found)
        return refs

    def propagate(self, direct: Dict[str, Set],
                  max_rounds: int = 40) -> Dict[str, Set]:
        """Fixpoint union of per-function fact sets along call edges:
        a function's transitive set = its direct set ∪ every (direct)
        callee's transitive set."""
        edges: Dict[str, List[str]] = {}
        for qn in self.functions:
            edges[qn] = [c for c, _ in self.direct_calls(qn)]
        trans = {qn: set(direct.get(qn, ())) for qn in self.functions}
        for _ in range(max_rounds):
            changed = False
            for qn, callees in edges.items():
                for c in callees:
                    add = trans.get(c, ()) - trans[qn]
                    if add:
                        trans[qn].update(add)
                        changed = True
            if not changed:
                break
        return trans


def iter_own_nodes(fn_node: ast.AST, node_type):
    """Every node of ``node_type`` in a function body, NOT descending
    into nested function/class definitions (their bodies execute under
    their own call, not this one)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, node_type):
            yield node
        stack.extend(ast.iter_child_nodes(node))
