"""Typed registry of every ``SKYLARK_*`` environment variable (the port
of libskylark_tpu/base/env.py).

Each variable is declared once, with its name, default, parser, kind and
``propagate`` flag equal to the reference's: a mixed fleet of port and
reference replicas reads one set of names with one meaning, and
:func:`propagated_names` names what a process replica must agree with its
parent on. The port reads the environment only through this module.

Each declaration's doc says what reads the variable in the port. Where
the port has no reader yet, the doc names the ROADMAP item that brings
one; where the variable has no meaning on the card (the TPU's VMEM
budgets, the Pallas pipeline switch, jax's compilation cache), the doc
says so and the variable stays declared only so that both packages see
one set of names.

Reads are never cached here: :meth:`EnvVar.get` consults ``os.environ``
on every call. Modules that latch a value (``telemetry.metrics.enabled``,
``utility.timer``) keep their own latch.

Parse conventions:

- *flag*: set and not ``"0"``/empty is on (``SKYLARK_TELEMETRY``);
- *off-words*: ``0/off/no/false/""`` disable a path-valued variable;
- *a typo degrades to the default*: a malformed int or float falls back
  to the declared default, it never raises.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

_UNSET = object()

#: Values that disable a path-valued variable when set explicitly.
OFF_WORDS = ("", "0", "off", "no", "false")


def parse_flag(raw: str) -> bool:
    """On unless empty or ``"0"``."""
    return raw not in ("", "0")


def parse_bool_default_on(raw: str) -> bool:
    """Off only for an explicit off-word."""
    return raw.strip().lower() not in OFF_WORDS


def parse_path_or_off(raw: str) -> Optional[str]:
    """A path, or ``None`` when the value is an off-word."""
    return None if raw.strip().lower() in OFF_WORDS else raw


def parse_int(raw: str) -> int:
    return int(raw)


def parse_positive_int(raw: str) -> int:
    n = int(raw)
    if n <= 0:
        raise ValueError(f"expected a positive integer, got {n}")
    return n


def parse_float(raw: str) -> float:
    return float(raw)


def parse_one(raw: str) -> bool:
    """Strict opt-in: only the literal ``"1"`` enables."""
    return raw == "1"


class EnvVar:
    """One declared variable. ``get()`` parses the live value (a typo
    degrades to the default); ``raw()`` and ``is_set()`` serve readers
    whose semantics the parsers cannot express."""

    __slots__ = ("name", "default", "parser", "doc", "propagate", "kind")

    def __init__(self, name: str, *, default=None,
                 parser: Optional[Callable[[str], object]] = None,
                 doc: str = "", propagate: bool = False,
                 kind: str = "str"):
        self.name = name
        self.default = default
        self.parser = parser
        self.doc = doc
        self.propagate = propagate
        self.kind = kind

    def raw(self) -> Optional[str]:
        """The unparsed value (``None`` when unset)."""
        return os.environ.get(self.name)

    def is_set(self) -> bool:
        return self.name in os.environ

    def get(self, default=_UNSET):
        """The parsed value; the declared default (or ``default=``) when
        unset or malformed."""
        fallback = self.default if default is _UNSET else default
        raw = os.environ.get(self.name)
        if raw is None:
            return fallback
        if self.parser is None:
            return raw
        try:
            return self.parser(raw)
        except (ValueError, TypeError):
            return fallback

    def __repr__(self) -> str:
        return (f"EnvVar({self.name!r}, default={self.default!r}, "
                f"propagate={self.propagate})")


REGISTRY: Dict[str, EnvVar] = {}


def declare(name: str, *, default=None,
            parser: Optional[Callable[[str], object]] = None,
            doc: str = "", propagate: bool = False,
            kind: str = "str") -> EnvVar:
    """Register one variable; a second declaration of a name raises."""
    if name in REGISTRY:
        raise ValueError(f"environment variable {name!r} declared twice")
    v = REGISTRY[name] = EnvVar(name, default=default, parser=parser,
                                doc=doc, propagate=propagate, kind=kind)
    return v


def lookup(name: str) -> EnvVar:
    """The declared variable of that name."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a declared SKYLARK environment variable; "
            f"declare it in libskylark_tpu_torch/base/env.py") from None


def propagated_names() -> Tuple[str, ...]:
    """Names a process replica must agree with its parent on, in
    declaration order."""
    return tuple(v.name for v in REGISTRY.values() if v.propagate)


def snapshot_propagated() -> Dict[str, Optional[str]]:
    """Raw values of every propagating variable (``None``: unset)."""
    return {name: os.environ.get(name) for name in propagated_names()}


def _choice(choices: tuple, fallback):
    """A parser that keeps a value among ``choices`` (stripped and
    lower-cased) and degrades anything else to ``fallback``."""
    def parse(raw: str):
        v = raw.strip().lower()
        return v if v in choices else fallback

    return parse


# ---------------------------------------------------------------------------
# declarations, grouped by subsystem (the reference's order)
# ---------------------------------------------------------------------------

# -- telemetry --------------------------------------------------------------

TELEMETRY = declare(
    "SKYLARK_TELEMETRY", default=False, parser=parse_flag, kind="flag",
    propagate=True,
    doc="Enable telemetry recording (any value but empty/``0``); read by "
        "``telemetry.metrics.enabled``. ``SKYLARK_TELEMETRY_DIR`` also "
        "enables it.")

TELEMETRY_DIR = declare(
    "SKYLARK_TELEMETRY_DIR", default=None, kind="path", propagate=True,
    doc="Directory for the JSONL telemetry exporter "
        "(``telemetry.export``); setting it both enables telemetry and "
        "installs the exporter at first import.")

TPU_PROFILE = declare(
    "SKYLARK_TPU_PROFILE", default=False, parser=parse_flag, kind="flag",
    doc="Enable the phase timers (``utility.timer``), latched at first "
        "use; ``timer.set_enabled`` overrides.")

# -- engine / executable cache ---------------------------------------------

EXEC_CACHE_SIZE = declare(
    "SKYLARK_EXEC_CACHE_SIZE", default=128, parser=parse_positive_int,
    kind="int",
    doc="Capacity of the executable cache (``engine.compiled``'s LRU of "
        "captured CUDA graphs, read once at import).")

ENGINE_DONATE = declare(
    "SKYLARK_ENGINE_DONATE", default=False, parser=parse_one, kind="flag",
    doc="Operand donation of the solver entry points "
        "(``engine.donation_enabled``, read at every call of a "
        "``donate=\"auto\"`` site): a donated tensor is consumed.")

EXEC_CACHE_DIR = declare(
    "SKYLARK_EXEC_CACHE_DIR", default=None, parser=parse_path_or_off,
    kind="path", propagate=True,
    doc="jax's persistent compilation cache: no meaning on the card (a "
        "CUDA graph cannot be serialized); ``engine."
        "enable_persistent_cache`` reads it, warns once and returns "
        "False. Alone (without ``SKYLARK_AOT_DIR``) it is the deprecated "
        "alias of the capture-record store at ``<dir>/aot`` "
        "(``engine.aot.aot_dir``).")

ENGINE_STATS_DUMP = declare(
    "SKYLARK_ENGINE_STATS_DUMP", default=None, kind="path",
    doc="Path of the engine's stats rollup, written at exit "
        "(``engine.dump_stats``; read once at import).")

AOT_DIR = declare(
    "SKYLARK_AOT_DIR", default=None, parser=parse_path_or_off,
    kind="path", propagate=True,
    doc="Store of capture records (``engine.aot.aot_dir``): with it set, "
        "each capture of the executable cache writes its key's record "
        "there; an off-word disables the store.")

AOT_LOCK_STALE = declare(
    "SKYLARK_AOT_LOCK_STALE", default=600.0, parser=parse_float,
    kind="float",
    doc="Age past which a peer's file lock is taken over "
        "(``engine.aot.FileLock``: capture records, kernel builds).")

AOT_LOCK_TIMEOUT = declare(
    "SKYLARK_AOT_LOCK_TIMEOUT", default=600.0, parser=parse_float,
    kind="float",
    doc="Wait on a cross-process file lock (a capture record's, a "
        "kernel library's build) before going on without it.")

# -- serving / fleet --------------------------------------------------------

#: The reference's flush-kernel backends, the values its env parsers
#: accept; the port's executor names its routes ``cuda``/``plain``
#: (``engine.serve.KERNEL_CHOICES``): ``pallas`` is ``cuda`` and ``xla``
#: is ``plain``.
SERVE_KERNEL_BACKENDS = ("pallas", "xla")

SERVE_KERNEL = declare(
    "SKYLARK_SERVE_KERNEL", default=None, kind="choice", propagate=True,
    parser=_choice(SERVE_KERNEL_BACKENDS, None),
    doc="Flush-route pin of the sketch endpoints' buckets (``pallas``: "
        "the kernel, ``xla``: the plain program), after the executor's "
        "``kernel=`` and before a warmup pack's decision "
        "(``engine.serve``).")

BOOT_T0 = declare(
    "SKYLARK_BOOT_T0", default=None, parser=parse_float, kind="float",
    doc="Parent's spawn time of a boot probe (``skylark_warmup "
        "boot-probe`` reports the wall time since it).")

#: The fleet replica backends.
FLEET_BACKENDS = ("thread", "process", "auto")

FLEET_BACKEND = declare(
    "SKYLARK_FLEET_BACKEND", default="thread", kind="choice",
    parser=_choice(FLEET_BACKENDS, "thread"),
    doc="Default ``fleet.ReplicaPool`` backend when the constructor "
        "names none: ``thread`` | ``process`` | ``auto`` (process on "
        "hosts with at least 4 cores, each child a CUDA context of its "
        "own; thread below).")

FLEET_SHM = declare(
    "SKYLARK_FLEET_SHM", default=True, parser=parse_bool_default_on,
    kind="flag",
    doc="Shared-memory operand/result transport of process replicas "
        "(``fleet.shm``; default on, ``0`` puts every payload on the "
        "pickle pipe).")

FLEET_SHM_MIN_BYTES = declare(
    "SKYLARK_FLEET_SHM_MIN_BYTES", default=16 * 1024,
    parser=parse_int, kind="bytes",
    doc="Arrays (and tensors) at or above this size ride a "
        "shared-memory slot; smaller values stay on the pickle pipe.")

FLEET_SHM_SLOTS = declare(
    "SKYLARK_FLEET_SHM_SLOTS", default=8, parser=parse_positive_int,
    kind="int",
    doc="Slots per shared-memory ring direction of a process replica; "
        "an exhausted ring falls back to the pickle pipe, never "
        "blocks.")

FLEET_SHM_SLOT_BYTES = declare(
    "SKYLARK_FLEET_SHM_SLOT_BYTES", default=1 << 20,
    parser=parse_positive_int, kind="bytes",
    doc="Bytes per shared-memory slot; a larger array falls back to "
        "the pickle pipe (counted, not an error).")

FLEET_AUTOSCALE_MIN = declare(
    "SKYLARK_FLEET_AUTOSCALE_MIN", default=1, parser=parse_positive_int,
    kind="int",
    doc="Default ``fleet.Autoscaler`` floor: the pool never drains "
        "below it, and a reaped replica is replaced up to it.")

FLEET_AUTOSCALE_MAX = declare(
    "SKYLARK_FLEET_AUTOSCALE_MAX", default=8, parser=parse_positive_int,
    kind="int",
    doc="Default ``fleet.Autoscaler`` ceiling: the pool never grows "
        "past it.")

FLEET_AUTOSCALE_INTERVAL = declare(
    "SKYLARK_FLEET_AUTOSCALE_INTERVAL", default=0.25, parser=parse_float,
    kind="float",
    doc="Seconds between ``fleet.Autoscaler`` ticks.")

FLEET_AUTOSCALE_UP_DEPTH = declare(
    "SKYLARK_FLEET_AUTOSCALE_UP_DEPTH", default=8, parser=parse_int,
    kind="int",
    doc="Mean queued and in-flight requests per replica at or above "
        "which sustained ticks scale up (a pack boot).")

FLEET_AUTOSCALE_DOWN_DEPTH = declare(
    "SKYLARK_FLEET_AUTOSCALE_DOWN_DEPTH", default=1, parser=parse_int,
    kind="int",
    doc="Mean queued and in-flight requests per replica at or below "
        "which sustained ticks scale down (a SIGTERM drain).")

FLEET_AUTOSCALE_COOLDOWN = declare(
    "SKYLARK_FLEET_AUTOSCALE_COOLDOWN", default=5.0, parser=parse_float,
    kind="float",
    doc="Seconds after a scale event before the autoscaler may act "
        "again.")

FLEET_HEDGE = declare(
    "SKYLARK_FLEET_HEDGE", default=False, parser=parse_flag, kind="flag",
    propagate=False,
    doc="``fleet.Router`` hedged requests: a request unresolved after "
        "the hedge delay is mirrored to the next ring-preference "
        "replica and the first result wins.")

FLEET_HEDGE_DELAY_MS = declare(
    "SKYLARK_FLEET_HEDGE_DELAY_MS", default=None, parser=parse_float,
    kind="float",
    doc="Fixed hedge delay in milliseconds; unset, the router derives "
        "it from the p99 of its request latencies.")

FLEET_HEDGE_VERIFY = declare(
    "SKYLARK_FLEET_HEDGE_VERIFY", default=False, parser=parse_flag,
    kind="flag",
    doc="Let a hedge's loser finish and compare the two results bit "
        "for bit (``torch.equal``), counting ``fleet.hedge_mismatches`` "
        "on a divergence.")

# -- stateful serve sessions ------------------------------------------------

SESSION_DIR = declare(
    "SKYLARK_SESSION_DIR", default=None, parser=parse_path_or_off,
    kind="path", propagate=True,
    doc="Durability root of the stateful serve sessions (``sessions``): "
        "per-session journals, checkpoints, meta and lease files live "
        "here, and a peer resumes a drained or crashed session from it. "
        "Unset: a private directory under the system temp dir.")

SESSION_TTL = declare(
    "SKYLARK_SESSION_TTL", default=600.0, parser=parse_float,
    kind="float",
    doc="Default idle TTL in seconds of a stateful serve session: one "
        "untouched this long is evicted (artifacts removed, later verbs "
        "raise ``SessionEvictedError``). ``ttl_s`` overrides per "
        "session.")

SESSION_FSYNC_EVERY = declare(
    "SKYLARK_SESSION_FSYNC_EVERY", default=8, parser=parse_positive_int,
    kind="int",
    doc="Journal fsync batching: every Nth session append also fsyncs "
        "the journal (every append reaches the page cache). 1 = fsync "
        "every append.")

# -- training jobs (libskylark_tpu_torch/train) -----------------------------

TRAIN_SLICE_ITERS = declare(
    "SKYLARK_TRAIN_SLICE_ITERS", default=8, parser=parse_positive_int,
    kind="int", propagate=True,
    doc="Default solver iterations per training slice, the unit of "
        "preemption and checkpointing of a train job: a slice is never "
        "interrupted mid-step, so this bounds how long a job holds an "
        "idle scheduler slot and how much work a crash loses past the "
        "last checkpoint. A job's ``slice_iters`` overrides it.")

TRAIN_RETRY_BUDGET = declare(
    "SKYLARK_TRAIN_RETRY_BUDGET", default=3, parser=parse_int,
    kind="int", propagate=True,
    doc="Failed slices a training job absorbs (requeued and re-run from "
        "the journaled state) before it fails terminally. A resume on a "
        "peer does not spend it.")

TRAIN_CKPT_EVERY = declare(
    "SKYLARK_TRAIN_CKPT_EVERY", default=4, parser=parse_positive_int,
    kind="int", propagate=True,
    doc="Checkpoint cadence of training jobs: every Nth slice boundary "
        "writes the solver state through the session checkpoint, so a "
        "crash replays at most N slices of journal. 1 = every slice.")

TRAIN_DEADLINE_S = declare(
    "SKYLARK_TRAIN_DEADLINE_S", default=600.0, parser=parse_float,
    kind="float", propagate=True,
    doc="Default wall-clock deadline in seconds of a training job, from "
        "its submit: past it the job fails with "
        "``TrainBudgetExhaustedError`` at the next slice boundary, with "
        "the exact iterations completed. A job's ``deadline_s`` "
        "overrides it.")

# -- distributed sketching (libskylark_tpu_torch/dist) ----------------------

DIST_SHARD_ROWS = declare(
    "SKYLARK_DIST_SHARD_ROWS", default=8192, parser=parse_positive_int,
    kind="int",
    doc="Default rows per shard task when a ``ShardPlan`` does not pin "
        "``shard_rows``: the unit of re-executable work of a distributed "
        "sketch.")

DIST_RETRIES = declare(
    "SKYLARK_DIST_RETRIES", default=3, parser=parse_int, kind="int",
    doc="Per-shard retry budget of the distributed-sketch coordinator: "
        "how often a failed shard task is re-executed (reassigned to the "
        "next ring-preference replica) before it is abandoned into the "
        "degraded-merge accounting.")

DIST_MIN_COVERAGE = declare(
    "SKYLARK_DIST_MIN_COVERAGE", default=1.0, parser=parse_float,
    kind="float",
    doc="Default ``min_coverage`` gate of a distributed merge: a coverage "
        "(the fraction of the declared rows folded in) below it raises "
        "``SketchCoverageError`` instead of returning a degraded result. "
        "1.0 = any abandoned shard raises.")

DIST_HEDGE = declare(
    "SKYLARK_DIST_HEDGE", default=False, parser=parse_flag, kind="flag",
    doc="Mirror a straggling shard task to the next ring-preference "
        "replica after ``SKYLARK_DIST_HEDGE_DELAY_MS`` and take the first "
        "result (bit-equal by construction: a partial is a function of "
        "the plan).")

DIST_HEDGE_DELAY_MS = declare(
    "SKYLARK_DIST_HEDGE_DELAY_MS", default=1000.0, parser=parse_float,
    kind="float",
    doc="Straggler threshold of shard hedging: an unresolved shard task "
        "older than this is mirrored when ``SKYLARK_DIST_HEDGE`` is on.")

DIST_SERVE_PIPELINE = declare(
    "SKYLARK_DIST_SERVE_PIPELINE", default=0, parser=parse_int,
    kind="int", propagate=True,
    doc="Pipeline depth of a dist-serve job (``submit_dist_sketch`` and "
        "the others): the most shard tasks outstanding at once. 0 = the "
        "coordinator's ``max_inflight`` (default twice the replicas, at "
        "least 2).")

DIST_SERVE_MERGE_FANIN = declare(
    "SKYLARK_DIST_SERVE_MERGE_FANIN", default=8,
    parser=parse_positive_int, kind="int", propagate=True,
    doc="Ready merge combines a dist-serve job folds per landed partial "
        "(the rest drain later); it never changes the merge tree, so "
        "never the bits.")

DIST_SERVE_MIN_COVERAGE_INTERACTIVE = declare(
    "SKYLARK_DIST_SERVE_MIN_COVERAGE_INTERACTIVE", default=1.0,
    parser=parse_float, kind="float", propagate=True,
    doc="Coverage gate of interactive dist-serve requests; below 1.0 an "
        "interactive job may resolve early and degraded once every "
        "unresolved shard has failed at least once.")

DIST_SERVE_MIN_COVERAGE_STANDARD = declare(
    "SKYLARK_DIST_SERVE_MIN_COVERAGE_STANDARD", default=1.0,
    parser=parse_float, kind="float", propagate=True,
    doc="Coverage gate of standard dist-serve requests (checked on the "
        "final merge).")

DIST_SERVE_MIN_COVERAGE_BEST_EFFORT = declare(
    "SKYLARK_DIST_SERVE_MIN_COVERAGE_BEST_EFFORT", default=1.0,
    parser=parse_float, kind="float", propagate=True,
    doc="Coverage gate of best_effort dist-serve requests (checked on "
        "the final merge).")

FAULT_PLAN = declare(
    "SKYLARK_FAULT_PLAN", default=None, kind="json",
    doc="Deterministic fault-injection plan (inline JSON or a path); read "
        "by ``resilience.faults.active_plan``.")

LOCK_WITNESS = declare(
    "SKYLARK_LOCK_WITNESS", default=False, parser=parse_flag, kind="flag",
    doc="Instrumented locks: ``base.locks`` records the runtime "
        "acquisition order and ``check_witness`` fails on a cycle.")

# -- tune / plan cache ------------------------------------------------------

PLAN_CACHE = declare(
    "SKYLARK_PLAN_CACHE", default=None, parser=parse_path_or_off,
    kind="path", propagate=True,
    doc="Autotuner plan-cache file (``tune/cache.py``); unset: "
        "``~/.cache/libskylark_tpu_torch/plan_cache.json``, never the JAX "
        "package's TPU plans (ROADMAP C22); ``0``/``off`` disables "
        "persistence.")

USE_PLAN_CACHE = declare(
    "SKYLARK_USE_PLAN_CACHE", default=True, parser=parse_bool_default_on,
    kind="flag",
    doc="Consult the plan cache at dispatch (``sketch.params."
        "get_use_plan_cache``): B1's single-lane applies, B4's variant, the "
        "hash apply and the serve executor; with it off an executor also "
        "declines a warmup pack's route decisions "
        "(``restore_kernel_choice``).")

COST_CALIB = declare(
    "SKYLARK_COST_CALIB", default=None, parser=parse_path_or_off,
    kind="path",
    doc="Measured calibration of the cost model (``tune/cost.py`` "
        "``effective_rates``): a JSON-lines ledger of ``cost_calib_<rate>`` "
        "records; ``auto``: ``cost_calib.jsonl`` beside the plan cache.")

# -- sparse serve operands --------------------------------------------------

SPARSE_MIN_DENSITY = declare(
    "SKYLARK_SPARSE_MIN_DENSITY", default=0.25, parser=parse_float,
    kind="float",
    doc="Density at or above which ``submit_sparse`` and "
        "``submit_sparse_solve`` densify the operand onto the dense "
        "endpoints (``engine.serve``).")

SPARSE_NNZ_FLOOR = declare(
    "SKYLARK_SPARSE_NNZ_FLOOR", default=64, parser=parse_positive_int,
    kind="int",
    doc="Floor of the serve layer's pow2 nnz class (``engine.serve``): "
        "requests below it share one class.")

SPARSE_KERNEL = declare(
    "SKYLARK_SPARSE_KERNEL", default=None, kind="choice", propagate=True,
    parser=_choice(SERVE_KERNEL_BACKENDS, None),
    doc="Flush-route pin of the sparse serve buckets, ahead of "
        "``SKYLARK_SERVE_KERNEL`` (``engine.serve``).")

# -- panel-free FWHT tier ---------------------------------------------------

FWHT_KERNEL = declare(
    "SKYLARK_FWHT_KERNEL", default=None, kind="choice", propagate=True,
    parser=_choice(SERVE_KERNEL_BACKENDS, None),
    doc="Flush-route pin of the SRHT serve buckets, ahead of "
        "``SKYLARK_SERVE_KERNEL`` (``engine.serve``).")

FWHT_MIN_N = declare(
    "SKYLARK_FWHT_MIN_N", default=4096, parser=parse_positive_int,
    kind="int", propagate=True,
    doc="The reference's floor of the in-kernel SRHT serve route. Not "
        "read by the port, a recorded departure (ROADMAP C26): B5 serves "
        "every n from ``sketch.cuda_fwht.MIN_N`` (128), and declining a "
        "CUDA bucket below this knob would send it to the plain version "
        "(C22).")

FWHT_CM_SDIM = declare(
    "SKYLARK_FWHT_CM_SDIM", default=256, parser=parse_positive_int,
    kind="int", propagate=True,
    doc="Sketch dimension of ``submit_compressed_matmul`` when the caller "
        "passes no transform (``engine.serve.default_cmm_transform``).")

# -- multi-tenant QoS -------------------------------------------------------

#: The QoS priority classes, most- to least-protected (``qos.tenants``
#: takes this tuple as its ``CLASSES``).
QOS_CLASSES = ("interactive", "standard", "best_effort")

QOS_ADAPT = declare(
    "SKYLARK_QOS_ADAPT", default=True, parser=parse_bool_default_on,
    kind="flag", propagate=True,
    doc="``0`` freezes every adaptive controller's targets "
        "(``qos.controller``), even on an executor built with "
        "``adaptive=True``.")

QOS_DEFAULT_CLASS = declare(
    "SKYLARK_QOS_DEFAULT_CLASS", default="standard", kind="choice",
    propagate=True, parser=_choice(QOS_CLASSES, "standard"),
    doc="Class of requests with no ``tenant=`` and of unknown tenants "
        "(``qos.tenants.default_class``).")

QOS_SHED_INTERACTIVE = declare(
    "SKYLARK_QOS_SHED_INTERACTIVE", default=0.5, parser=parse_float,
    kind="float",
    doc="DEGRADED-shed fraction of ``max_queue`` of the interactive "
        "class, the last to shed (``qos.tenants.shed_fraction``).")

QOS_SHED_STANDARD = declare(
    "SKYLARK_QOS_SHED_STANDARD", default=0.25, parser=parse_float,
    kind="float",
    doc="DEGRADED-shed fraction of ``max_queue`` of the standard class "
        "(the executor's ``shed_fraction`` scales all three).")

QOS_SHED_BEST_EFFORT = declare(
    "SKYLARK_QOS_SHED_BEST_EFFORT", default=0.1, parser=parse_float,
    kind="float",
    doc="DEGRADED-shed fraction of ``max_queue`` of the best_effort "
        "class, the first to shed; best_effort also sheds at half the "
        "queue bound on a healthy executor.")

QOS_RATE_DEFAULT = declare(
    "SKYLARK_QOS_RATE_DEFAULT", default=None, parser=parse_float,
    kind="float",
    doc="Admission rate (requests/s) of tenants registered without "
        "``rate=``; unset: unlimited (``qos.tenants``).")

QOS_BURST_DEFAULT = declare(
    "SKYLARK_QOS_BURST_DEFAULT", default=None, parser=parse_float,
    kind="float",
    doc="Token-bucket burst of rate-limited tenants without ``burst=``; "
        "unset: twice the rate (``qos.tenants``).")

QOS_ADAPT_INTERVAL = declare(
    "SKYLARK_QOS_ADAPT_INTERVAL", default=0.25, parser=parse_float,
    kind="float",
    doc="Seconds between adaptive-controller ticks (``qos.controller``).")

QOS_SLO_INTERACTIVE_MS = declare(
    "SKYLARK_QOS_SLO_INTERACTIVE_MS", default=25.0, parser=parse_float,
    kind="float",
    doc="p99 latency SLO (ms) of the interactive class "
        "(``qos.tenants.slo_seconds``).")

QOS_SLO_STANDARD_MS = declare(
    "SKYLARK_QOS_SLO_STANDARD_MS", default=250.0, parser=parse_float,
    kind="float",
    doc="p99 latency SLO (ms) of the standard class.")

QOS_SLO_BEST_EFFORT_MS = declare(
    "SKYLARK_QOS_SLO_BEST_EFFORT_MS", default=5000.0,
    parser=parse_float, kind="float",
    doc="p99 latency SLO (ms) of the best_effort class.")

# -- content-addressed result cache -----------------------------------------

CACHE = declare(
    "SKYLARK_CACHE", default=False, parser=parse_flag, kind="flag",
    propagate=True,
    doc="Result cache and single-flight on the serve path for executors "
        "built without ``cache=`` (``engine.serve``).")

CACHE_MAX_BYTES = declare(
    "SKYLARK_CACHE_MAX_BYTES", default=256 * 1024 * 1024,
    parser=parse_positive_int, kind="bytes", propagate=True,
    doc="Byte budget of one executor's result cache; on the port the "
        "bytes are the cached tensors' device memory "
        "(``engine.resultcache.ResultCache``).")

CACHE_QUOTA_INTERACTIVE = declare(
    "SKYLARK_CACHE_QUOTA_INTERACTIVE", default=0.5, parser=parse_float,
    kind="float", propagate=True,
    doc="Share of the cache budget held for the interactive class; a "
        "class evicts only its own entries.")

CACHE_QUOTA_STANDARD = declare(
    "SKYLARK_CACHE_QUOTA_STANDARD", default=0.35, parser=parse_float,
    kind="float", propagate=True,
    doc="Share of the cache budget held for the standard class.")

CACHE_QUOTA_BEST_EFFORT = declare(
    "SKYLARK_CACHE_QUOTA_BEST_EFFORT", default=0.15,
    parser=parse_float, kind="float", propagate=True,
    doc="Share of the cache budget held for the best_effort class.")

CACHE_SINGLE_FLIGHT_TIMEOUT = declare(
    "SKYLARK_CACHE_SINGLE_FLIGHT_TIMEOUT", default=30.0,
    parser=parse_float, kind="float", propagate=True,
    doc="Seconds an in-flight request accepts identical followers.")

# -- network serve front door -----------------------------------------------

NET_HOST = declare(
    "SKYLARK_NET_HOST", default="127.0.0.1", kind="str",
    doc="Bind address of the TCP front door (``net.NetServer``).")

NET_PORT = declare(
    "SKYLARK_NET_PORT", default=0, parser=parse_int, kind="int",
    doc="Bind port of the TCP front door (0: an ephemeral port).")

NET_MAX_CONNECTIONS = declare(
    "SKYLARK_NET_MAX_CONNECTIONS", default=256,
    parser=parse_positive_int, kind="int",
    doc="Live-connection ceiling of the front door.")

NET_INFLIGHT_WINDOW = declare(
    "SKYLARK_NET_INFLIGHT_WINDOW", default=32,
    parser=parse_positive_int, kind="int",
    doc="Per-connection inflight window of the front door.")

NET_DRAIN_TIMEOUT_S = declare(
    "SKYLARK_NET_DRAIN_TIMEOUT_S", default=10.0, parser=parse_float,
    kind="float",
    doc="Socket-layer drain budget of the front door, in seconds.")

NET_RETRY_BUDGET = declare(
    "SKYLARK_NET_RETRY_BUDGET", default=3, parser=parse_int,
    kind="int",
    doc="Reconnect-resend attempts of ``net.NetClient``.")

NET_RETRY_BACKOFF_S = declare(
    "SKYLARK_NET_RETRY_BACKOFF_S", default=0.05, parser=parse_float,
    kind="float",
    doc="Base backoff of ``net.NetClient``'s retry loop, in "
        "seconds.")

# -- sketch kernels ---------------------------------------------------------

PALLAS_MTILE = declare(
    "SKYLARK_PALLAS_MTILE", default=None, parser=parse_int, kind="int",
    doc="The m-tile pin (``sketch.params.pallas_m_tile_overridden``): "
        "B1's single-lane applies then take the heuristic n-split, not a "
        "cached plan's; B1's 128-row tile does not change.")

MATMUL_PRECISION = declare(
    "SKYLARK_MATMUL_PRECISION", default=None, kind="choice",
    doc="The reference's ambient matmul precision, installed at import. "
        "Not read by the port, a recorded departure (ROADMAP C26): the "
        "port installs true f32 (TF32 off) unconditionally, and TF32 "
        "appears only in B1's ``f32`` regime.")

FASTFOOD_PRECISION = declare(
    "SKYLARK_FASTFOOD_PRECISION", default=None, kind="choice",
    doc="The reference's contraction regime of the fused Fastfood "
        "kernel. Not read by the port, a recorded departure (ROADMAP "
        "C26): B4's WHT adds and subtracts in f32 with no matmul, so "
        "there is no regime to choose.")

PALLAS_PIPELINE = declare(
    "SKYLARK_PALLAS_PIPELINE", default=None, kind="choice",
    doc="The Pallas pipelined-kernel switch: no meaning on the card, "
        "declared so that both packages see one set of names.")

HASH_KERNEL = declare(
    "SKYLARK_HASH_KERNEL", default=None, kind="choice",
    doc="The reference's CWT kernel override (``mxu``, ``exact`` or "
        "the XLA scatter). Not read by the port, a recorded departure "
        "(ROADMAP C26): a CUDA tensor always takes B2's exact mode, since "
        "``xla`` would route it off its kernel (C22) and ``mxu`` is not "
        "ported (B-i 3).")

PALLAS_VMEM_BUDGET = declare(
    "SKYLARK_PALLAS_VMEM_BUDGET", default=16 * 1024 * 1024,
    parser=parse_int, kind="bytes",
    doc="A TPU core's VMEM budget: no meaning on the card, declared so "
        "that both packages see one set of names.")

PALLAS_SCRATCH_CAP = declare(
    "SKYLARK_PALLAS_SCRATCH_CAP", default=8 * 1024 * 1024,
    parser=parse_int, kind="bytes",
    doc="A TPU core's VMEM cap for the cached operator: no meaning on "
        "the card, declared so that both packages see one set of names.")

AUTO_MATERIALIZE = declare(
    "SKYLARK_AUTO_MATERIALIZE", default=True,
    parser=parse_bool_default_on, kind="flag",
    doc="Materialize-and-reuse dispatch: a transform pins its operator "
        "after its Nth plain-route apply; ``0`` turns it off. Read at "
        "import of ``sketch/params.py``, as the reference reads it.")

# -- io ---------------------------------------------------------------------

STREAM_PREFETCH = declare(
    "SKYLARK_STREAM_PREFETCH", default=2, parser=parse_int, kind="int",
    doc="Prefetch depth of the double-buffered streaming overlap "
        "(``io.chunked``); 0 disables the overlap.")

WEBHDFS_RETRIES = declare(
    "SKYLARK_WEBHDFS_RETRIES", default=4, parser=parse_int, kind="int",
    doc="Attempt bound of the WebHDFS transport's default retry "
        "policy (``io.webhdfs``).")


__all__ = [
    "EnvVar", "OFF_WORDS", "REGISTRY", "declare", "lookup",
    "parse_flag", "parse_bool_default_on", "parse_path_or_off",
    "parse_int", "parse_positive_int", "parse_float", "parse_one",
    "propagated_names", "snapshot_propagated",
]
