"""Engine layer: the microbatch serving executor, its shape classes and
its result cache.

``MicrobatchExecutor`` coalesces concurrent requests of the reference's
twelve local endpoints (sketches of dense, Fastfood and sparse CSR
operands; sketch-and-solve, compressed matmul and lowrank; KRR/RLSC
predict, condest and graph ASE/PPR) into one batched flush per shape
bucket, with deadlines, DEGRADED shedding, QoS tenants and scheduling,
and the result cache with single-flight and operand residency
(``resultcache``); ``bucket`` holds the pow2 pad-and-mask policy.

``compiled`` serves the solver entry points' bodies and the sketch
endpoints' flushes from the executable cache (``cache()``): a CUDA graph
captured once per key on the card, the body itself on the CPU. ``aot``
keeps capture records (a CUDA graph cannot be serialized), and
``warmup`` packs a fleet's hot serve buckets, which a fresh process
captures before traffic."""

from libskylark_tpu_torch.engine import aot, bucket, resultcache, warmup
from libskylark_tpu_torch.engine.cache import (CacheEntry, EngineStats,
                                               ExecutableCache)
from libskylark_tpu_torch.engine.compiled import (CompiledFn, cache,
                                                  code_version, compiled,
                                                  digest,
                                                  donation_enabled,
                                                  dump_stats,
                                                  enable_persistent_cache,
                                                  maybe_donate,
                                                  plan_fingerprint, reset,
                                                  stats)
from libskylark_tpu_torch.engine.serve import (DEGRADED, DRAINING, SERVING,
                                               STOPPED, MicrobatchExecutor,
                                               ServeOverloadedError,
                                               derive_request,
                                               request_statics, serve_stats)

__all__ = ["CacheEntry", "CompiledFn", "DEGRADED", "DRAINING",
           "EngineStats", "ExecutableCache", "MicrobatchExecutor", "SERVING",
           "STOPPED", "ServeOverloadedError", "aot", "bucket", "cache",
           "code_version", "compiled", "derive_request", "digest",
           "donation_enabled", "dump_stats", "enable_persistent_cache",
           "maybe_donate", "plan_fingerprint", "request_statics", "reset",
           "resultcache", "serve_stats", "stats", "warmup"]
