"""Deterministic, seeded fault injection behind named sites (the port
of libskylark_tpu/resilience/faults.py).

Code plants cheap named injection sites (``faults.check("serve.flush",
...)``, a no-op unless a plan is active) and a **fault plan** decides,
deterministically, which hits of which sites raise which error class.
The same plan and the same sequence of checks fire the same list in both
packages.

Sites planted in the port:

====================  =====================================================
``serve.flush``       the microbatch flush, once per cohort execution
                      attempt before anything is stacked or launched
                      (``engine.serve``; bisection retries enter the site
                      again)
``serve.mesh_block``  a mesh follower's block of the front's flush, once
                      per block before it runs (``engine.serve``; the
                      front's cohort tags ride the block): a fired fault
                      fails the front's attempt as a MeshError
``qos.admit``         the QoS admission point, once per submit after the
                      tenant is resolved (``engine.serve``): a fired fault
                      refuses one admission without touching the queue
``engine.compile``    a cold key's materialization (``engine.compiled``),
                      before the warm-up and the capture: a fired fault
                      aborts the single-flight and releases its waiters
``checkpoint.save``   every checkpoint write (``utility.checkpoint``)
``session.append``    a session append, before its journal write
                      (``sessions.registry``)
``io.chunked.*``      a libsvm batch (``batch``) and an HDF5 slice read
                      (``read``, retried) of ``io.chunked``
``io.webhdfs.*``      a WebHDFS connection attempt (``open``) and chunk
                      read (``read``, reconnect-resume)
``train.slice``       a training slice, before its journal write
                      (``train.jobs``)
``dist.shard``        a shard task's entry (``dist.plan.compute_shard``)
``dist.ingest``       each batch a shard ingests (resumed at the consumed
                      offset)
``dist.merge``        a merge's entry (``dist.plan.merge_partials``, the
                      incremental merger's result)
``net.accept``        the TCP front door's accept path, once per accepted
                      connection (``net.server``): a fired fault closes the
                      fresh socket before any frame is read; the client's
                      reconnect budget absorbs it
``net.read``          one frame read on a server connection: a fired fault
                      tears the connection down; inflight futures detach
                      and the client's byte-identical re-send joins the
                      original flight
``net.write``         one frame write on a server connection, the same
                      teardown from the response side
``fleet.route``       one route attempt of the fleet router
                      (``fleet.router``: a request's owner or a failover
                      candidate, a hedge's mirror, a session or train
                      verb): a fired fault moves the request to the next
                      replica in ring preference order
====================  =====================================================

A process replica's child reads the plan from its own environment
(``SKYLARK_FAULT_PLAN``, through the pool's ``replica_env``), and a
request's tags cross the pipe with it.

A plan is a JSON document (or the equivalent dict)::

    {"seed": 7,
     "faults": [
       {"site": "serve.flush", "error": "SketchError", "tag": "poison"},
       {"site": "serve.flush", "error": "IOError_", "every": 64},
       {"site": "qos.admit", "error": "AllocationError",
        "prob": 0.01, "times": 2}
     ]}

Spec fields (all optional except ``site``): ``error`` (a class name from
:mod:`libskylark_tpu_torch.base.errors`, or a builtin exception name;
default ``IOError_``), ``message``, and the firing rule —

``on_hit``  fire exactly on the Nth matching hit (1-indexed);
``every``   fire on every Nth matching hit;
``prob``    fire with probability p from a per-spec RNG seeded by
            ``(plan seed, site, spec index)``: same seed, same hit
            sequence, same decisions;
``after``   skip the first N matching hits;
``times``   fire at most N times (default unlimited);
``tag``     fire only when the check's ``tags`` contain this tag (pins a
            fault to a request: a test submits under ``with
            faults.tag("poison"):``).

A spec may carry ``stall_s`` instead of ``error`` (the site sleeps that
long, then proceeds; ``fired()`` records ``"stall"``), or ``"crash":
true`` (the process ends with ``os._exit(137)``, as a ``kill -9``).

Activation: ``with fault_plan(plan): ...``, or ``SKYLARK_FAULT_PLAN``
holding the JSON or a path to it; a context plan shadows the env plan.
Every fired fault is recorded: ``fired()`` returns the ``(site, hit,
error_name)`` sequence. A fault fires on the host, before any launch; it
cannot stand for a sticky CUDA error, which no retry heals.
"""

from __future__ import annotations

import builtins
import contextlib
import json
import os
import random
import threading
import time
from typing import Iterable, Optional

from libskylark_tpu_torch.base import env as _env
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base import locks as _locks
from libskylark_tpu_torch.telemetry import metrics as _metrics

_VALID_KEYS = {"site", "error", "message", "on_hit", "every", "prob",
               "after", "times", "tag", "stall_s", "crash"}

# fired injections are always counted (a fire raises an exception; the
# counter bump is noise)
_FIRED = _metrics.counter(
    "resilience.faults_fired",
    "Injected faults that fired, by site and error class")


def _resolve_error(name: str) -> type:
    cls = getattr(errors, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    raise errors.InvalidParametersError(
        f"fault plan names unknown error class {name!r} (expected a "
        f"libskylark_tpu_torch.base.errors class or a builtin exception)")


class FaultSpec:
    """One compiled plan entry; owns its hit counter and RNG stream."""

    __slots__ = ("site", "error_name", "error_cls", "message", "on_hit",
                 "every", "prob", "after", "times", "tag", "stall_s",
                 "crash", "hits", "fires", "_rng")

    def __init__(self, doc: dict, seed: int, index: int):
        unknown = set(doc) - _VALID_KEYS
        if unknown:
            raise errors.InvalidParametersError(
                f"fault spec has unknown field(s) {sorted(unknown)}")
        if "site" not in doc:
            raise errors.InvalidParametersError(
                f"fault spec missing 'site': {doc!r}")
        modes = [k for k in ("error", "stall_s", "crash") if k in doc]
        if len(modes) > 1:
            raise errors.InvalidParametersError(
                "a fault spec is an error, a stall, OR a crash — "
                f"{modes} together make no sense: {doc!r}")
        self.site = str(doc["site"])
        # a stall spec delays the hit instead of raising: the straggler
        # injector the fleet hedging leg replays (a slow replica is a
        # failure mode no error class models)
        self.stall_s = (float(doc["stall_s"]) if "stall_s" in doc
                        else None)
        if self.stall_s is not None and self.stall_s < 0:
            raise errors.InvalidParametersError(
                f"fault spec stall_s must be >= 0, got {self.stall_s}")
        # a crash spec hard-kills the process at the site (module doc):
        # the deterministic kill -9 for process-replica chaos targets
        self.crash = bool(doc.get("crash", False))
        if self.stall_s is not None:
            self.error_name = "stall"
        elif self.crash:
            self.error_name = "crash"
        else:
            self.error_name = str(doc.get("error", "IOError_"))
        self.error_cls = (None if self.stall_s is not None or self.crash
                          else _resolve_error(self.error_name))
        self.message = doc.get("message")
        self.on_hit = int(doc["on_hit"]) if "on_hit" in doc else None
        self.every = int(doc["every"]) if "every" in doc else None
        self.prob = float(doc["prob"]) if "prob" in doc else None
        self.after = int(doc.get("after", 0))
        self.times = int(doc["times"]) if "times" in doc else None
        self.tag = doc.get("tag")
        self.hits = 0
        self.fires = 0
        # per-spec stream: decisions depend only on (plan seed, site,
        # spec position, matching-hit index) — replay is bit-identical
        self._rng = random.Random(f"{seed}:{self.site}:{index}")

    def decide(self, tags: frozenset) -> bool:
        """Whether this check fires the spec. Caller holds the plan
        lock; counters and the RNG advance only on *matching* hits so
        tag-filtered specs replay independently of other traffic."""
        if self.tag is not None and self.tag not in tags:
            return False
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.on_hit is not None and self.hits != self.on_hit:
            return False
        if self.every is not None and self.hits % self.every != 0:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self.fires += 1
        return True


class FaultPlan:
    """A compiled, activatable plan: specs + the fired-fault log."""

    def __init__(self, doc: dict):
        if not isinstance(doc, dict):
            raise errors.InvalidParametersError(
                f"fault plan must be a JSON object, got {type(doc).__name__}")
        self.seed = int(doc.get("seed", 0))
        self.specs = [FaultSpec(d, self.seed, i)
                      for i, d in enumerate(doc.get("faults", []))]
        self._sites = {s.site for s in self.specs}
        self._lock = _locks.make_lock("resilience.fault_plan")
        self.fired: list[tuple] = []      # (site, matching-hit, error name)

    @classmethod
    def parse(cls, text_or_path: str) -> "FaultPlan":
        """JSON text, or a path to a JSON file (the env-var forms)."""
        text = text_or_path.strip()
        if not text.startswith("{") and os.path.exists(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        try:
            return cls(json.loads(text))
        except json.JSONDecodeError as e:
            raise errors.InvalidParametersError(
                f"SKYLARK_FAULT_PLAN is neither valid JSON nor a "
                f"readable path: {e}") from e

    def check(self, site: str, tags: frozenset, detail: str) -> None:
        if site not in self._sites:
            return
        hit_spec = None
        with self._lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.decide(tags):
                    self.fired.append((site, spec.hits, spec.error_name))
                    _FIRED.inc_always(site=site, error=spec.error_name)
                    hit_spec, hit_n = spec, spec.hits
                    break
        if hit_spec is None:
            return
        if hit_spec.crash:
            # the deterministic kill -9: no exception, no cleanup, no
            # atexit. 137 = 128 + SIGKILL.
            os._exit(137)
            return  # pragma: no cover — only a test-stubbed _exit returns
        if hit_spec.stall_s is not None:
            # stall OUTSIDE the plan lock: a sleeping site must not
            # serialize every other site's checks behind it
            time.sleep(hit_spec.stall_s)
            return
        err = hit_spec.error_cls(
            hit_spec.message
            or f"injected fault at {site} (hit {hit_n})")
        if isinstance(err, errors.SkylarkError):
            err.append_trace(
                f"fault-injected: site={site} hit={hit_n}"
                + (f" detail={detail}" if detail else ""))
        raise err

    def reset(self) -> None:
        """Zero every counter, RNG stream, and the fired log — the next
        run under this plan replays from the beginning."""
        with self._lock:
            self.fired.clear()
            for i, spec in enumerate(self.specs):
                spec.hits = spec.fires = 0
                spec._rng = random.Random(f"{self.seed}:{spec.site}:{i}")


# ---------------------------------------------------------------------------
# activation: context-manager stack shadowing the env plan
# ---------------------------------------------------------------------------

_STACK: list[FaultPlan] = []
_STACK_LOCK = _locks.make_lock("resilience.fault_stack")
_ENV_RAW: Optional[str] = None
_ENV_PLAN: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    """The plan checks consult: the innermost context plan, else the
    ``SKYLARK_FAULT_PLAN`` env plan (parsed once per distinct value),
    else ``None`` (every site a no-op)."""
    if _STACK:
        return _STACK[-1]
    env = _env.FAULT_PLAN.raw()
    if not env:
        return None
    global _ENV_RAW, _ENV_PLAN
    if env != _ENV_RAW:
        # parse-and-cache under the lock: two threads racing the first
        # check must end up counting hits on ONE plan instance, or the
        # bit-identical-replay guarantee (and on_hit accounting) breaks
        with _STACK_LOCK:
            if env != _ENV_RAW:
                _ENV_PLAN = FaultPlan.parse(env)
                _ENV_RAW = env
    return _ENV_PLAN


@contextlib.contextmanager
def fault_plan(plan):
    """Activate ``plan`` (a dict, JSON string, or :class:`FaultPlan`)
    for the dynamic extent of the block. Nests; the innermost wins."""
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan(plan)
    elif not isinstance(plan, FaultPlan):
        raise errors.InvalidParametersError(
            f"fault_plan takes a dict / JSON string / FaultPlan, got "
            f"{type(plan).__name__}")
    with _STACK_LOCK:
        _STACK.append(plan)
    try:
        yield plan
    finally:
        with _STACK_LOCK:
            _STACK.remove(plan)


def check(site: str, tags: Iterable[str] = (), detail: str = "") -> None:
    """The injection-site entry point. Near-zero cost when no plan is
    active (one attr read + one env lookup); under a plan, consults the
    site's specs and raises the chosen error class when one fires."""
    plan = active_plan()
    if plan is None:
        return
    plan.check(site, frozenset(tags) | current_tags(), detail)


def fired() -> list[tuple]:
    """The active plan's fired-fault log ``[(site, hit, error), ...]``
    — the same plan and the same checks give the same list."""
    plan = active_plan()
    return list(plan.fired) if plan is not None else []


def reset() -> None:
    """Reset the active plan's counters and log (a replay starts over)."""
    plan = active_plan()
    if plan is not None:
        plan.reset()


# ---------------------------------------------------------------------------
# request tagging: pin a fault to a request, not a call count
# ---------------------------------------------------------------------------

_TAGS = threading.local()


def current_tags() -> frozenset:
    """The calling thread's active fault tags (see :func:`tag`)."""
    return getattr(_TAGS, "tags", frozenset())


@contextlib.contextmanager
def tag(*names: str):
    """Tag everything submitted or executed in this block. The serve
    layer captures the submitting thread's tags onto each request and
    replays their union at every flush attempt: a spec with ``"tag":
    "poison"`` fires exactly when the tagged request is in the executing
    cohort, which is what lets bisection converge on it."""
    prev = current_tags()
    _TAGS.tags = prev | frozenset(names)
    try:
        yield
    finally:
        _TAGS.tags = prev


def _telemetry_block() -> dict:
    """Snapshot collector: the active plan's state (the process-lifetime
    fire counts live in the ``resilience.faults_fired`` counter)."""
    plan = active_plan()
    return {"active_plan": plan is not None,
            "fired_this_plan": len(plan.fired) if plan is not None else 0}


_metrics.register_collector("resilience.faults", _telemetry_block)


__all__ = [
    "FaultPlan", "FaultSpec", "active_plan", "check", "current_tags",
    "fault_plan", "fired", "reset", "tag",
]
