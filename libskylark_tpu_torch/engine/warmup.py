"""``engine.warmup``: warmup packs, the serve buckets a fresh process
captures before traffic (the port of libskylark_tpu/engine/warmup.py).

A **warmup pack** is a directory holding one capture record per hot
(serve bucket, capacity) flush (``artifacts/``, :mod:`.aot`) and a
``pack.json`` manifest with the reference's schema: per entry the record's
digest, the endpoint and bucket statics, the capacity class, the **kernel
decision** (the port's route, ``cuda`` or ``plain``), the bucket spec and
the digest of its canonical cohort's results; pack-wide the compat stamp
and the plan fingerprint everything was keyed under.

The reference's pack holds serialized executables that a boot
deserializes. A CUDA graph cannot be serialized, so a port pack holds
capture records, and **loading** an entry is capturing it: :func:`load_pack`
serves the entry's canonical cohort (:func:`_spec_requests`, made from the
recorded spec) through an executor of the pack's geometry, which captures
the packed key, checks the results' digest against the builder's, and
restores the packed route into the given executors. Those captures count
as ``aot_loads`` with their warm-up and capture time in ``load_seconds``,
never as misses or compiles: after a load, the first request of every
packed bucket is a cache **hit** that replays the graph, with results
bit-equal to the builder's (a replay runs the builder's launches on the
same kernels, which the compat stamp pins).

Invalidation is the key's: a code change re-keys (the load's capture
lands on another key and is counted failed), a torch/CUDA/device or
kernel-source change fails the compat probe, a plan-fingerprint change
skips the pack. A skipped or partial pack is never an error unless
``strict=True``: boot degrades to capturing on first traffic.

:func:`select_top_buckets` reads tune's plan cache in the reference; tune
is not ported yet (ROADMAP A6), so it raises. Pass explicit
:class:`BucketSpec`\\ s to :func:`build_pack`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Optional, Sequence

from libskylark_tpu_torch.engine import aot as _aot


def _compiled_module():
    """:mod:`libskylark_tpu_torch.engine.compiled`, fetched by full name:
    the package re-exports the same-named decorator."""
    import importlib

    return importlib.import_module("libskylark_tpu_torch.engine.compiled")


PACK_SCHEMA = 1
MANIFEST = "pack.json"
_ARTIFACTS = "artifacts"
# a pack's executors flush only when told: no linger-expired partial
# cohort can land on another capacity class
_LINGER_US = 60_000_000


@dataclasses.dataclass
class BucketSpec:
    """One serve bucket to pack: the transform family and a
    representative operand shape (padding classes derive exactly as on the
    serve path, so a pow2-padded representative is the class)."""

    endpoint: str             # "sketch_apply" | "fastfood_features"
    family: str               # "JLT" | "CWT" | "CT" | "FastGaussianRFT" | ...
    n: int                    # transform input dim (contracted extent)
    m: int                    # free extent (rows rowwise / cols columnwise)
    s_dim: int
    dtype: str = "float32"
    rowwise: bool = False
    capacities: tuple = (1,)
    sigma: float = 1.0        # fastfood kernel bandwidth (bucket static)
    seed: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["capacities"] = list(self.capacities)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BucketSpec":
        d = dict(d)
        d["capacities"] = tuple(int(c) for c in d.get("capacities", (1,)))
        return cls(**d)


def _make_transform(spec: BucketSpec):
    from libskylark_tpu_torch import Context
    from libskylark_tpu_torch import sketch as sk

    ctx = Context(seed=int(spec.seed))
    if spec.family == "CWT":
        return sk.CWT(spec.n, spec.s_dim, ctx)
    if spec.family == "JLT":
        return sk.JLT(spec.n, spec.s_dim, ctx)
    if spec.family == "CT":
        return sk.CT(spec.n, spec.s_dim, ctx)
    if spec.family == "FastGaussianRFT":
        return sk.FastGaussianRFT(spec.n, spec.s_dim, ctx, sigma=spec.sigma)
    if spec.family == "FastMaternRFT":
        # the spec's sigma rides as the length scale l
        return sk.FastMaternRFT(spec.n, spec.s_dim, ctx, nu=1.5,
                                l=spec.sigma)
    raise ValueError(f"warmup pack cannot build family {spec.family!r}")


def _spec_requests(spec: BucketSpec, capacity: int):
    """``capacity`` distinct (transform, operand) pairs for one flush of
    the spec's bucket, ragged free extents inside one padding class, as
    the reference makes them (the same operands, numpy on the host)."""
    import numpy as np

    rng = np.random.default_rng(spec.seed + capacity)
    out = []
    for i in range(capacity):
        T = _make_transform(dataclasses.replace(spec, seed=spec.seed + i))
        m = max(1, spec.m - (i % min(4, spec.m)))
        if spec.endpoint == "fastfood_features":
            shape = (m, spec.n)
        else:
            shape = (m, spec.n) if spec.rowwise else (spec.n, m)
        A = rng.standard_normal(shape).astype(spec.dtype)
        out.append((T, A))
    return out


def _submit(ex, spec: BucketSpec, T, A):
    from libskylark_tpu_torch.sketch import COLUMNWISE, ROWWISE

    if spec.endpoint == "fastfood_features":
        return ex.submit_fastfood(T, A)
    return ex.submit_sketch(T, A,
                            dimension=ROWWISE if spec.rowwise
                            else COLUMNWISE)


def _serve(ex, spec: BucketSpec, cohort: int) -> list:
    """The spec's canonical cohort of ``cohort`` requests served in one
    flush of ``ex``: the results."""
    futs = [_submit(ex, spec, T, A)
            for (T, A) in _spec_requests(spec, cohort)]
    ex.flush()
    return [f.result(timeout=600) for f in futs]


def result_digest(arrays) -> str:
    """Content hash of a cohort's results (shape, dtype and bytes per
    lane; tensors read back to the host): the bit-equality witness a boot
    compares with the builder's. The same arrays give the reference's
    hex."""
    import hashlib

    import numpy as np
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:32]


def _statics_and_kernel(key: tuple) -> tuple[tuple, Optional[str]]:
    extra = key[3]
    if len(extra) >= 2 and extra[-2] == "kernel":
        return extra[:-2], extra[-1]
    return extra, None


def _entry_from_key(key: tuple) -> dict:
    """Manifest entry metadata from one executable-cache key (the
    anatomy of engine/compiled's docstring): the first argument is the
    (B, 2) key stack, so its lead extent is the capacity."""
    statics, kernel = _statics_and_kernel(key)
    capacity = None
    if key[4]:
        lead = key[4][0][0]
        capacity = int(lead[0]) if lead else None
    return {
        "digest": _aot.key_digest(key),
        "name": key[0],
        "endpoint": statics[0] if statics else None,
        "kernel": kernel,
        "capacity": capacity,
        "statics": repr(statics),
    }


def _executor(max_batch: int, pad_floor: int, device, kernel=None,
              workers: int = 1):
    from libskylark_tpu_torch.engine.serve import MicrobatchExecutor

    return MicrobatchExecutor(max_batch=int(max_batch), linger_us=_LINGER_US,
                              workers=workers, pad_floor=int(pad_floor),
                              kernel=kernel, device=device)


def build_pack(pack_dir: str, specs: Sequence, *,
               pad_floor: Optional[int] = None, workers: int = 1,
               reset_engine: bool = True, device=None) -> dict:
    """Capture every (spec, capacity) serve flush and write its capture
    record into ``pack_dir`` (records under ``artifacts/``, the manifest
    at ``pack.json``). Returns the manifest.

    The builder drives a real :class:`MicrobatchExecutor` on ``device``
    (the package default when None), so the packed keys are the serve
    path's own (statics, shapes, route). The executable cache is reset
    first (``reset_engine``), so every packed key demonstrably captures. A
    spec whose flush runs eagerly (FastMaternRFT, an unqualified bucket)
    packs nothing; it is listed under the manifest's ``uncaptured`` with
    the reason."""
    from libskylark_tpu_torch.engine import bucket as bucketing

    _compiled = _compiled_module()
    specs = [s if isinstance(s, BucketSpec) else BucketSpec.from_dict(s)
             for s in specs]
    if not specs:
        raise ValueError("a warmup pack needs at least one bucket spec")
    max_cap = max(max(s.capacities) for s in specs)
    floor = pad_floor if pad_floor is not None else bucketing.PAD_FLOOR
    artifacts = os.path.join(pack_dir, _ARTIFACTS)
    os.makedirs(artifacts, exist_ok=True)
    if reset_engine:
        _compiled.reset()

    entries: list[dict] = []
    uncaptured: list[dict] = []
    with _aot.override_dir(artifacts):
        ex = _executor(max_cap, floor, device, workers=workers)
        ex_device = str(ex.device)
        try:
            for spec in specs:
                for cap in sorted(set(int(c) for c in spec.capacities)):
                    before = set(_compiled.cache().keys())
                    eager = dict(ex.stats()["capture"]["eager_flushes"])
                    # the canonical cohort is made from the spec, so this
                    # digest is what any process replaying the packed
                    # graph must reproduce, bit for bit
                    rdigest = result_digest(_serve(ex, spec, cap))
                    new = [k for k in _compiled.cache().keys()
                           if k not in before]
                    for k in new:
                        ent = _entry_from_key(k)
                        ent["spec"] = spec.to_dict()
                        ent["cohort"] = cap
                        ent["results_digest"] = rdigest
                        if not os.path.exists(_aot.artifact_path(
                                ent["digest"], artifacts)):
                            ent["artifact_missing"] = True
                        entries.append(ent)
                    if not new:
                        now = ex.stats()["capture"]["eager_flushes"]
                        why = [r for r, n in now.items()
                               if n > eager.get(r, 0)]
                        uncaptured.append({
                            "spec": spec.to_dict(), "cohort": cap,
                            "reason": why[0] if why else "no new key"})
        finally:
            ex.shutdown()

    manifest = {
        "schema": PACK_SCHEMA,
        "created": time.time(),
        "compat": _aot.compat_stamp(),
        "plan_fingerprint": _compiled.plan_fingerprint(),
        "pad_floor": int(floor),
        "max_batch": max_cap,
        "device": ex_device,
        "entries": entries,
        "uncaptured": uncaptured,
    }
    path = os.path.join(pack_dir, MANIFEST)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return manifest


def read_manifest(pack_dir: str) -> dict:
    path = (pack_dir if pack_dir.endswith(".json")
            else os.path.join(pack_dir, MANIFEST))
    with open(path) as fh:
        return json.load(fh)


def _pack_device(manifest: dict, executors, device):
    """Where a pack's entries are captured: the executors' device, else
    ``device``, else the device the pack was built on (its type: a
    card's index is the process's own)."""
    if executors:
        return executors[0].device
    if device is not None:
        return device
    return manifest.get("device", "cuda").split(":")[0]


_warned: set = set()


def _warn_once(reason: str, detail: str) -> None:
    if reason not in _warned:
        _warned.add(reason)
        warnings.warn(f"warmup pack entry not loaded ({reason}): {detail}",
                      RuntimeWarning, stacklevel=3)


def load_pack(pack_dir: str, executors: Sequence = (), *,
              strict: bool = False, device=None) -> dict:
    """Capture a pack's entries into the process executable cache before
    traffic, and restore each entry's route into ``executors``. Returns a
    report::

        {"entries": N, "loaded": n, "resident": n, "failed": n,
         "kernel_restored": n, "skipped": why-or-None,
         "plan_fingerprint_match": bool, "mismatches": [...]}

    A compat mismatch or plan-fingerprint drift skips the pack (reported,
    not raised, unless ``strict``). Per entry: the record is read and
    probed (:func:`~.aot.load_file`: a torn one is quarantined); unless
    its key is already in the cache (``resident``: another replica of
    this process loaded the pack), the entry's canonical cohort is served
    through an executor of the pack's geometry on the executors' device,
    pinned to the entry's route, which captures the packed key; its
    results' digest must equal the builder's, and the capture must land
    on the packed key. These captures are AOT loads
    (:func:`~.compiled.loading`): ``aot_loads`` and ``load_seconds``, never
    misses or compiles, so a packed bucket's first request is a hit.
    Failures are counted (``failed``, ``aot_load_failures``) and warned
    once a reason; they raise only under ``strict``. Nothing is routed
    past the kernel: a load that fails leaves its bucket to capture on
    first traffic."""
    _compiled = _compiled_module()
    report = {"entries": 0, "loaded": 0, "resident": 0, "failed": 0,
              "kernel_restored": 0, "skipped": None,
              "plan_fingerprint_match": None, "mismatches": []}

    def _bail(why: str) -> dict:
        if strict:
            raise RuntimeError(f"warmup pack {pack_dir!r}: {why}")
        report["skipped"] = why
        return report

    try:
        manifest = read_manifest(pack_dir)
    except Exception as e:  # noqa: BLE001 — a missing pack degrades
        return _bail(f"unreadable manifest ({e!r})")
    if manifest.get("schema") != PACK_SCHEMA:
        return _bail(f"schema {manifest.get('schema')!r} != {PACK_SCHEMA}")
    report["entries"] = len(manifest.get("entries", ()))
    ok, why = _aot.compat_probe(manifest.get("compat"))
    if not ok:
        return _bail(f"compat: {why}")
    fp = _compiled.plan_fingerprint()
    fp_match = fp == manifest.get("plan_fingerprint")
    report["plan_fingerprint_match"] = fp_match
    if not fp_match:
        # every packed key embeds the builder's fingerprint: none could
        # ever be hit
        return _bail("plan-fingerprint drift (plan cache edited since "
                     "the pack was built)")

    root = (os.path.dirname(pack_dir) if pack_dir.endswith(".json")
            else pack_dir)
    artifacts = os.path.join(root, _ARTIFACTS)
    dev = _pack_device(manifest, executors, device)
    loaders: dict = {}

    def failed(ent, reason: str, detail: str) -> None:
        report["failed"] += 1
        _compiled.cache().note_aot_load_failure()
        if strict:
            raise RuntimeError(
                f"warmup pack entry {ent.get('digest')}: {reason}: {detail}")
        _warn_once(reason, detail)

    try:
        resident = {repr(k) for k in _compiled.cache().keys()}
        for ent in manifest.get("entries", ()):
            path = _aot.artifact_path(ent["digest"], artifacts)
            try:
                key, _record, _header = _aot.load_file(path)
            except Exception as e:  # noqa: BLE001 — per-entry containment
                failed(ent, getattr(e, "reason", type(e).__name__), repr(e))
                continue
            statics, token = _statics_and_kernel(key)
            capacity = ent.get("capacity")
            if repr(key) in resident:
                report["resident"] += 1
            else:
                ex = loaders.get(token)
                if ex is None:
                    ex = loaders[token] = _executor(
                        manifest.get("max_batch", 8),
                        manifest.get("pad_floor", 8), dev, kernel=token)
                spec = BucketSpec.from_dict(ent["spec"])
                try:
                    with _compiled.loading([key]):
                        outs = _serve(ex, spec, int(ent.get("cohort")
                                                    or capacity or 1))
                except Exception as e:  # noqa: BLE001
                    failed(ent, "capture", repr(e))
                    continue
                got = result_digest(outs)
                if got != ent.get("results_digest"):
                    report["mismatches"].append(
                        {"digest": ent["digest"], "got": got,
                         "want": ent.get("results_digest")})
                    failed(ent, "results-digest",
                           f"{ent['digest']}: {got} != "
                           f"{ent.get('results_digest')}")
                    continue
                if repr(key) not in {repr(k)
                                     for k in _compiled.cache().keys()}:
                    failed(ent, "key-drift",
                           f"{ent['digest']}: the capture landed on "
                           "another key (code or configuration changed)")
                    continue
                report["loaded"] += 1
            if token:
                for ex in executors:
                    if capacity and ex.restore_kernel_choice(
                            statics, capacity, token):
                        report["kernel_restored"] += 1
    finally:
        for ex in loaders.values():
            ex.shutdown()
    return report


def serve_probe(pack_dir: str, *, load: bool = True,
                strict: bool = False, device=None) -> dict:
    """Boot-and-serve probe: through a fresh executor, after loading the
    pack when ``load`` (the warm side of the boot A/B) or straight onto
    the capture path when not (the cold side), serve every entry's
    canonical cohort and compare its results' digest with the builder's.
    The one implementation behind :func:`spawn_boot_probe` and the CLI's
    ``boot-probe``.

    Returns ``{"entries", "served", "bit_equal", "mismatches", "warmup":
    load-report-or-None, "engine": counter deltas, "t_first_result_s",
    "t_total_s", "flush_ms"}``: ``flush_ms`` per entry is its cohort's
    submit-to-results time, the operands made beforehand (a cold entry's
    includes its capture); the engine counters are deltas from entry, so
    a packed boot shows ``compiles == misses == 0``."""
    _compiled = _compiled_module()
    manifest = read_manifest(pack_dir)
    s0 = dataclasses.replace(_compiled.stats())
    t_start = time.perf_counter()
    ex = _executor(manifest.get("max_batch", 8), manifest.get("pad_floor", 8),
                   _pack_device(manifest, (), device))
    report: dict = {"entries": len(manifest.get("entries", ())),
                    "served": 0, "bit_equal": True, "mismatches": [],
                    "warmup": None}
    try:
        if load:
            report["warmup"] = load_pack(pack_dir, executors=(ex,),
                                         strict=strict)
        t_first = None
        report["flush_ms"] = []
        for ent in manifest.get("entries", ()):
            spec = BucketSpec.from_dict(ent["spec"])
            cohort = int(ent.get("cohort") or ent.get("capacity") or 1)
            reqs = _spec_requests(spec, cohort)
            t0 = time.perf_counter()
            futs = [_submit(ex, spec, T, A) for T, A in reqs]
            ex.flush()
            outs = [f.result(timeout=600) for f in futs]
            now = time.perf_counter()
            report["flush_ms"].append(round((now - t0) * 1e3, 3))
            if t_first is None:
                t_first = now - t_start
            report["served"] += cohort
            got = result_digest(outs)
            want = ent.get("results_digest")
            if want is not None and got != want:
                report["bit_equal"] = False
                report["mismatches"].append(
                    {"digest": ent["digest"], "got": got, "want": want})
        report["t_first_result_s"] = (round(t_first, 4)
                                      if t_first is not None else None)
        report["t_total_s"] = round(time.perf_counter() - t_start, 4)
        report["kernel"] = ex.stats()["kernel"]
    finally:
        ex.shutdown()
    s1 = _compiled.stats()
    delta = {f.name: getattr(s1, f.name) - getattr(s0, f.name)
             for f in dataclasses.fields(s0)}
    for k in ("compile_seconds", "load_seconds", "execute_seconds"):
        delta[k] = round(delta[k], 4)
    report["engine"] = delta
    return report


def spawn_boot_probe(pack_dir: str, *, load: bool = True,
                     timeout: float = 600.0) -> dict:
    """Run :func:`serve_probe` in a fresh Python process (``python -m
    libskylark_tpu_torch.cli.skylark_warmup boot-probe``) and return its
    record, which carries ``wall_since_spawn_s`` (interpreter, torch and
    package import included). The child's environment is scrubbed as the
    reference's is: an ambient ``SKYLARK_AOT_DIR`` or
    ``SKYLARK_EXEC_CACHE_DIR`` would point the cold side at records of an
    earlier run, and an ambient ``SKYLARK_SERVE_KERNEL`` pin would make
    the executor decline every packed route."""
    import re
    import subprocess
    import sys

    env = dict(os.environ)
    for k in ("SKYLARK_AOT_DIR", "SKYLARK_EXEC_CACHE_DIR",
              "SKYLARK_SERVE_KERNEL"):
        env.pop(k, None)
    env["SKYLARK_BOOT_T0"] = repr(time.time())
    cmd = [sys.executable, "-m",
           "libskylark_tpu_torch.cli.skylark_warmup", "boot-probe",
           "--pack", os.path.abspath(pack_dir)]
    if not load:
        cmd.append("--no-load")
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=repo_root, env=env)
    m = re.search(r"BOOT_PROBE (\{.*\})", proc.stdout + proc.stderr)
    if not m:
        raise RuntimeError(
            f"boot probe (load={load}) produced no record "
            f"rc={proc.returncode}: "
            f"{(proc.stdout + proc.stderr)[-800:]}")
    return json.loads(m.group(1))


def select_top_buckets(top_n: int = 8, *, stats: Optional[dict] = None,
                       device_kind: Optional[str] = None
                       ) -> list[BucketSpec]:
    """The reference ranks the tune plan cache's serve entries (and a
    serve-stats block's capacity histogram) into the top-N buckets to
    pack. tune is not ported yet, so this raises; build a pack from
    explicit :class:`BucketSpec`\\ s."""
    from libskylark_tpu_torch.base import errors

    raise errors.NotImplementedYetError(
        "select_top_buckets reads tune's plan cache, which is not ported "
        "yet (ROADMAP A6): pass explicit BucketSpecs to build_pack")


__all__ = [
    "BucketSpec", "MANIFEST", "PACK_SCHEMA", "build_pack", "load_pack",
    "read_manifest", "result_digest", "select_top_buckets",
    "serve_probe", "spawn_boot_probe",
]
