"""Engine layer: the microbatch serving executor, its shape classes and
its result cache.

``MicrobatchExecutor`` coalesces concurrent requests of the reference's
twelve local endpoints (sketches of dense, Fastfood and sparse CSR
operands; sketch-and-solve, compressed matmul and lowrank; KRR/RLSC
predict, condest and graph ASE/PPR) into one batched flush per shape
bucket, with deadlines, DEGRADED shedding, QoS tenants and scheduling,
and the result cache with single-flight and operand residency
(``resultcache``); ``bucket`` holds the pow2 pad-and-mask policy."""

from libskylark_tpu_torch.engine import bucket, resultcache
from libskylark_tpu_torch.engine.serve import (DEGRADED, DRAINING, SERVING,
                                               STOPPED, MicrobatchExecutor,
                                               ServeOverloadedError,
                                               derive_request,
                                               request_statics, serve_stats)

__all__ = ["DEGRADED", "DRAINING", "MicrobatchExecutor", "SERVING",
           "STOPPED", "ServeOverloadedError", "bucket", "derive_request",
           "request_statics", "resultcache", "serve_stats"]
