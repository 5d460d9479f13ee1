"""Declared metric names (the port of libskylark_tpu/telemetry/names.py).

Every counter, gauge and histogram recorded by either package is declared
here once as (name, kind), the reference's list: a snapshot or a
dashboard reads one set of names from a port replica and a reference one.
Names whose subsystem the port has not reached yet (fleet/'s pool,
router and autoscaler, net/) are declared for the ROADMAP item that
brings them (A7); the executable cache records
``engine.compile_seconds``.

Naming: ``<subsystem>.<noun>``.
"""

from __future__ import annotations

from typing import Dict

#: name -> kind ("counter" | "gauge" | "histogram")
METRICS: Dict[str, str] = {
    # engine (engine/compiled.py)
    "engine.compile_seconds": "histogram",
    "engine.load_seconds": "histogram",
    "engine.persistent_cache_failures": "counter",
    # telemetry's own bookkeeping (telemetry/trace.py)
    "telemetry.spans": "counter",
    # tune (tune/cache.py)
    "tune.plan_cache_lookups": "counter",
    # ml (ml/admm.py)
    "ml.admm.iterations": "counter",
    "ml.admm.objective": "gauge",
    "ml.admm.reldel": "gauge",
    # io (io/chunked.py, io/webhdfs.py)
    "io.chunked.batches": "counter",
    "io.webhdfs.reconnects": "counter",
    # resilience (resilience/faults.py, policy.py, health.py)
    "resilience.faults_fired": "counter",
    "resilience.retries": "counter",
    "resilience.health_transitions": "counter",
    # sparse serve operands (engine/serve.py, docs/serving)
    "serve.sparse_submits": "counter",
    "serve.sparse_densified": "counter",
    "serve.sparse_kernel_flushes": "counter",
    "serve.sparse_nnz_class": "histogram",
    # FWHT serve tier (engine/serve.py, docs/performance)
    "serve.fwht_flushes": "counter",
    "serve.compressed_matmul_submits": "counter",
    # stateful serve sessions (sessions/registry.py)
    "sessions.opened": "counter",
    "sessions.appends": "counter",
    "sessions.finalized": "counter",
    "sessions.evicted": "counter",
    "sessions.resumed": "counter",
    "sessions.replayed_records": "counter",
    "sessions.checkpoints": "counter",
    "sessions.fenced": "counter",
    "sessions.live": "gauge",
    # distributed sketching (dist/coordinator.py)
    "dist.shards_dispatched": "counter",
    "dist.shards_retried": "counter",
    "dist.shards_reassigned": "counter",
    "dist.shards_abandoned": "counter",
    "dist.merges": "counter",
    "dist.coverage": "gauge",
    # pipelined dist-serve jobs (dist/serve.py, docs/distributed)
    "dist.shard_tasks": "counter",
    "dist.merge_depth": "gauge",
    "dist.jobs": "counter",
    "dist.early_resolves": "counter",
    # multi-tenant QoS (qos/tenants.py, qos/controller.py,
    # engine/serve.py — docs/qos)
    "qos.admitted": "counter",
    "qos.shed": "counter",
    "qos.rate_limited": "counter",
    "qos.queue_depth": "gauge",
    "qos.request_latency": "histogram",
    "qos.linger_target": "gauge",
    "qos.batch_target": "gauge",
    # content-addressed result cache (engine/resultcache.py,
    # docs/caching) — rendered as skylark_cache_* on Prometheus
    "cache.hits": "counter",
    "cache.misses": "counter",
    "cache.bytes_saved": "counter",
    "cache.evicted": "counter",
    "cache.single_flight_coalesced": "counter",
    "cache.resident_operands": "gauge",
    # fleet (fleet/router.py)
    "fleet.session_handoffs": "counter",
    "fleet.routed": "counter",
    "fleet.affinity_hit": "counter",
    "fleet.failover": "counter",
    "fleet.spilled": "counter",
    "fleet.hedged": "counter",
    "fleet.hedge_wins": "counter",
    "fleet.hedge_mismatches": "counter",
    # fleet shared-memory transport (fleet/shm.py)
    "fleet.shm_sends": "counter",
    "fleet.shm_fallbacks": "counter",
    # fleet autoscaler (fleet/autoscale.py)
    "fleet.autoscale_up": "counter",
    "fleet.autoscale_down": "counter",
    "fleet.replicas": "gauge",
    # training jobs (train/jobs.py, docs/training)
    "train.jobs_submitted": "counter",
    "train.slices_run": "counter",
    "train.preemptions": "counter",
    "train.resumes": "counter",
    "train.budget_exhausted": "counter",
    "train.progress": "gauge",
    "train.residual": "gauge",
    # network serve front door (net/server.py, docs/networking) —
    # rendered as skylark_net_* on Prometheus via the net collector
    "net.connections": "gauge",
    "net.requests": "counter",
    "net.wire_errors": "counter",
    "net.bytes_in": "counter",
    "net.bytes_out": "counter",
    "net.drains": "counter",
}

__all__ = ["METRICS"]
