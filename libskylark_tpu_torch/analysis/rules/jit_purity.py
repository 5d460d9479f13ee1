"""``jit-purity`` — captured bodies must be pure (the port of
libskylark_tpu/analysis/rules/jit_purity.py).

Motivating bug class: ``engine.compiled`` captures a body as a CUDA
graph on its first call and replays that graph on every later one
(ROADMAP C20). A body that reads ``os.environ``, a wall clock, host RNG
or a mutable module global bakes the capture-time value into the graph:
a replay silently disagrees with the process it runs in, and nothing
invalidates it unless the capture key covers the read.

Roots (the functions whose bodies are captured): any alias of
``libskylark_tpu_torch.engine.compiled:compiled`` —

- as a decorator (``@compiled``, ``@engine.compiled(...)``,
  ``functools.partial(compiled, ...)``);
- called with the body as its first argument, by its imported name
  (``compiled(batched_sketch, ...)``, the serve flush builders) or as
  the package attribute (``engine.compiled(_svd_pipeline, ...)``, the
  solver-module idiom, at module level too);
- where that argument is a factory call (``engine.compiled(
  _predict_program(k))``), the nested functions the factory returns;
- where it is a parameter of the enclosing function (``_run_program(fn,
  ...)``), what each caller passes in that place, resolved the same way.

The port has no ``jax.jit``. From each root the rule follows the project
call graph (conservative: unresolved calls contribute nothing) and flags
every reachable impurity:

- ``os.environ`` / ``os.getenv`` / ``base.env`` registry reads;
- wall clocks: ``time.time/monotonic/perf_counter/time_ns``,
  ``datetime.now/utcnow``;
- host RNG: the stdlib ``random`` module, ``np.random``, and torch's
  process-wide generator — ``torch.manual_seed`` (and the other seeding
  calls), and ``torch.rand``/``randn``/``randint``/``randperm``/
  ``normal``/``bernoulli`` (their ``_like`` forms, ``multinomial``,
  ``poisson``, and the in-place ``Tensor.normal_``/``uniform_``/...)
  called with no ``generator=``;
- reads of mutable module globals — names rebound via ``global``
  somewhere in their module (the set-at-runtime knob pattern).

A *deliberate* capture-time read (a precision regime resolved when the
body runs and carried in the capture key) is suppressed **at the impure
line** with ``# skylark-lint: disable=jit-purity`` plus a comment naming
the key field that covers it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from libskylark_tpu_torch.analysis.callgraph import CallGraph
from libskylark_tpu_torch.analysis.core import Finding, Project, rule

RULE = "jit-purity"

ENV_MODULE = "libskylark_tpu_torch.base.env"
_COMPILE_WRAPPERS = {"libskylark_tpu_torch.engine.compiled:compiled"}
_CLOCK_ATTRS = {"time", "monotonic", "perf_counter", "time_ns",
                "monotonic_ns", "perf_counter_ns"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}
# torch's samplers on the process-wide generator unless given one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "poisson", "rand_like",
                   "randn_like", "randint_like"}
_TORCH_SEEDING = {"manual_seed", "manual_seed_all", "seed", "seed_all",
                  "set_rng_state"}
# in-place samplers of a tensor, on the process-wide generator unless
# given one
_TENSOR_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                    "exponential_", "cauchy_", "log_normal_",
                    "geometric_"}


def _dotted(node: ast.AST) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class _ModuleFacts:
    """Per-module context shared by root + impurity detection."""

    def __init__(self, mod):
        self.mod = mod
        # names rebound via ``global`` in any function of the module
        self.mutable_globals: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Global):
                self.mutable_globals.update(node.names)

    def alias_of(self, name: str) -> Optional[str]:
        return self.mod.resolve_alias_module(name)

    def is_compile_wrapper(self, node: ast.AST) -> bool:
        """Any alias of engine.compiled.compiled (``compiled``,
        ``engine_compile``, ``engine.compiled``,
        ``engine.compiled.compiled``...)."""
        if isinstance(node, ast.Name):
            return (self.mod.import_aliases.get(node.id, "")
                    in _COMPILE_WRAPPERS)
        d = _dotted(node)
        if d and d[-1] == "compiled" and len(d) >= 2:
            target = self.alias_of(d[0])
            if target and "engine" in target:
                return True
        return False

    def torch_call(self, call: ast.Call) -> Optional[str]:
        """``torch.<name>`` (or a name imported from torch) of a call on
        torch's process-wide generator, or None."""
        d = _dotted(call.func)
        if not d:
            return None
        if len(d) == 1:
            target = self.mod.import_aliases.get(d[0], "")
            if not target.startswith("torch:"):
                return None
            d = ["torch", target.split(":", 1)[1]]
        elif self.alias_of(d[0]) != "torch":
            if (len(d) >= 2 and d[-1] in _TENSOR_SAMPLERS
                    and not _has_generator(call)):
                return f"Tensor.{d[-1]}"
            return None
        if d[-1] in _TORCH_SEEDING:
            return ".".join(["torch", *d[1:]])
        if (len(d) == 2 and d[1] in _TORCH_SAMPLERS
                and not _has_generator(call)):
            return f"torch.{d[1]}"
        return None


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _direct_impurities(graph: CallGraph,
                       facts: Dict[str, _ModuleFacts]
                       ) -> Dict[str, Set[Tuple[str, str, int]]]:
    """qualname -> {(kind, detail, lineno)} of impurities written
    directly in that function's own body (suppressed lines skipped)."""
    out: Dict[str, Set[Tuple[str, str, int]]] = {}
    for qn, fn in graph.functions.items():
        mod = fn.module
        mf = facts[mod.modname]
        found: Set[Tuple[str, str, int]] = set()

        def note(kind, detail, lineno):
            if not mod.is_suppressed(RULE, lineno):
                found.add((kind, detail, lineno))

        for node in fn.own_nodes(ast.AST):
            if isinstance(node, ast.Call):
                rng = mf.torch_call(node)
                if rng is not None:
                    note("host-rng", rng, node.lineno)
                continue
            d = _dotted(node) if isinstance(node, ast.Attribute) else None
            if d:
                root_target = mf.alias_of(d[0])
                # os.environ / os.getenv
                if root_target == "os" and len(d) >= 2 and d[1] in (
                        "environ", "getenv"):
                    note("env", ".".join(d[:2]), node.lineno)
                # base.env registry access
                elif root_target == ENV_MODULE and len(d) >= 2:
                    note("env", f"base.env.{d[1]}", node.lineno)
                # clocks
                elif (root_target == "time" and len(d) == 2
                        and d[1] in _CLOCK_ATTRS):
                    note("clock", ".".join(d), node.lineno)
                elif (root_target == "datetime" and d[-1]
                        in _DATETIME_ATTRS):
                    note("clock", ".".join(d), node.lineno)
                # host RNG
                elif root_target == "random" and len(d) >= 2:
                    note("host-rng", ".".join(d[:2]), node.lineno)
                elif (root_target in ("numpy", "np")
                        and len(d) >= 2 and d[1] == "random"):
                    note("host-rng", ".".join(d[:2]), node.lineno)
                elif (root_target == "numpy.random"):
                    note("host-rng", "numpy.random", node.lineno)
            elif (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in mf.mutable_globals):
                # reading a module global some function rebinds
                note("mutable-global",
                     f"{mod.modname}:{node.id}", node.lineno)
        if found:
            out[qn] = found
    return out


def _returned_locals(graph: CallGraph, qn: str) -> List[str]:
    """The nested functions ``qn`` returns by name (a body factory)."""
    fn = graph.functions[qn]
    out = []
    for ret in fn.own_nodes(ast.Return):
        if isinstance(ret.value, ast.Name):
            cand = f"{qn}.<locals>.{ret.value.id}"
            if cand in graph.functions:
                out.append(cand)
    return out


def _param_index(fn) -> Dict[str, int]:
    """Parameter name -> the position a caller passes it in (a method's
    ``self``/``cls`` not counted)."""
    args = [a.arg for a in (*fn.node.args.posonlyargs, *fn.node.args.args)]
    if fn.cls is not None and args and args[0] in ("self", "cls"):
        args = args[1:]
    return {a: i for i, a in enumerate(args)}


def _bodies(graph: CallGraph, fn, arg: ast.AST, callers, depth: int = 0
            ) -> List[str]:
    """The functions a compile wrapper's first argument ``arg`` names in
    the scope of ``fn``: a function, the locals a factory call returns,
    or — for a parameter of ``fn`` — whatever each caller passes in its
    place (one level)."""
    if isinstance(arg, ast.Call):
        callee = graph.resolve_call(fn.module, fn, arg)
        return _returned_locals(graph, callee) if callee else []
    if not isinstance(arg, ast.Name):
        return []
    callee = graph._resolve_name(fn.module, fn, arg.id)
    if callee:
        return [callee]
    pos = _param_index(fn).get(arg.id)
    if pos is None or depth > 0:
        return []
    out = []
    for caller, call in callers().get(fn.qualname, ()):
        passed = (call.args[pos] if pos < len(call.args) else next(
            (k.value for k in call.keywords if k.arg == arg.id), None))
        if passed is not None:
            out += _bodies(graph, graph.functions[caller], passed, callers,
                           depth + 1)
    return out


def _roots(graph: CallGraph,
           facts: Dict[str, _ModuleFacts]) -> Dict[str, int]:
    """qualname -> lineno of every capture root."""
    roots: Dict[str, int] = {}
    for qn, fn in graph.functions.items():
        mf = facts[fn.module.modname]
        for deco in getattr(fn.node, "decorator_list", []):
            target = deco.func if isinstance(deco, ast.Call) else deco
            if mf.is_compile_wrapper(target):
                roots[qn] = fn.node.lineno
            elif (isinstance(deco, ast.Call)
                    and _dotted(deco.func)
                    and _dotted(deco.func)[-1] == "partial"
                    and deco.args
                    and mf.is_compile_wrapper(deco.args[0])):
                roots[qn] = fn.node.lineno

    memo: Dict[str, list] = {}

    def callers() -> Dict[str, list]:
        """callee -> [(caller, call node)], built on first need."""
        if not memo:
            memo["_"] = {}
            for qn in graph.functions:
                for callee, call in graph.direct_calls(qn):
                    memo["_"].setdefault(callee, []).append((qn, call))
        return memo["_"]

    def add(callees):
        for callee in callees:
            if callee not in roots:
                roots[callee] = graph.functions[callee].node.lineno

    # call-form roots: compiled(f) / engine.compiled(f), inside functions
    # (full scope resolution) ...
    for qn, fn in graph.functions.items():
        mf = facts[fn.module.modname]
        for call in fn.own_nodes(ast.Call):
            if mf.is_compile_wrapper(call.func) and call.args:
                add(_bodies(graph, fn, call.args[0], callers))
    # ... and at module level (``_svd_compiled = engine.compiled(fn,
    # ...)`` — the solver-module idiom), resolving against top-level
    # function names only
    modules = {fn.module.modname: fn.module
               for fn in graph.functions.values()}
    for mod in modules.values():
        mf = facts[mod.modname]
        top = graph._toplevel.get(mod.modname, {})
        for call in ast.walk(mod.tree):
            if not (isinstance(call, ast.Call)
                    and mf.is_compile_wrapper(call.func) and call.args):
                continue
            arg = call.args[0]
            if isinstance(arg, ast.Name) and arg.id in top:
                add([top[arg.id]])
            elif (isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)
                    and arg.func.id in top):
                add(_returned_locals(graph, top[arg.func.id]))
    return roots


@rule(RULE,
      "functions reaching engine.compiled's captured bodies must not "
      "read env, clocks, host RNG (torch's generator included), or "
      "mutable module globals")
def check(project: Project) -> List[Finding]:
    graph = CallGraph.of(project)
    facts = {m.modname: _ModuleFacts(m)
             for m in project.modules.values()}
    direct = _direct_impurities(graph, facts)
    trans = graph.propagate(direct)
    findings: List[Finding] = []
    for qn, lineno in sorted(_roots(graph, facts).items()):
        fn = graph.functions[qn]
        for kind, detail in sorted({(k, d)
                                    for k, d, _ in trans.get(qn, ())}):
            findings.append(Finding(
                RULE, fn.module.relpath, lineno, qn,
                f"traced root reaches {kind} impurity ({detail})"))
    return findings
