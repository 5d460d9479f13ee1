"""Training as a service: preemptible, crash-survivable iterative solver
jobs inside the serve tier (the port of libskylark_tpu/train/).

- :mod:`libskylark_tpu_torch.train.slices`: bounded-iteration slice
  engines over the foreground solvers (ADMM-KRR, LSQR, CG, randomized
  block Gauss–Seidel) and the deterministic state byte codec;
- :mod:`libskylark_tpu_torch.train.state`: the session state that makes a
  job a ``kind="train"`` session (journal, checkpoint and lease fencing
  come with it);
- :mod:`libskylark_tpu_torch.train.jobs`: the per-executor manager that
  schedules slices as best-effort work and owns the retry, budget and
  resume semantics.
"""

from libskylark_tpu_torch.train.jobs import (TrainJobHandle, TrainJobSpec,
                                             TrainManager, train_stats)
from libskylark_tpu_torch.train.slices import (SOLVERS, decode_state,
                                               encode_state, make_engine,
                                               step_bytes)
from libskylark_tpu_torch.train.state import TrainSessionState

__all__ = [
    "SOLVERS", "TrainJobHandle", "TrainJobSpec", "TrainManager",
    "TrainSessionState", "decode_state", "encode_state", "make_engine",
    "step_bytes", "train_stats",
]
