"""Engine layer: the microbatch serving executor and its shape classes.

``MicrobatchExecutor`` coalesces concurrent requests of the reference's
twelve local endpoints (sketches of dense, Fastfood and sparse CSR
operands; sketch-and-solve, compressed matmul and lowrank; KRR/RLSC
predict, condest and graph ASE/PPR) into one batched flush per shape
bucket; ``bucket`` holds the pow2 pad-and-mask policy."""

from libskylark_tpu_torch.engine import bucket
from libskylark_tpu_torch.engine.serve import (MicrobatchExecutor,
                                               ServeOverloadedError,
                                               derive_request,
                                               request_statics)

__all__ = ["MicrobatchExecutor", "ServeOverloadedError", "request_statics",
           "derive_request", "bucket"]
