"""Survivable stateful serve sessions (the port of
libskylark_tpu/sessions/): bucket-lived sessions that hold a maintained
sketch open across requests — CountSketch, JLT and SRHT row-batch
appenders, incremental randomized SVD, online KRR — kept alive when
their executor drains (checkpoint + peer resume) or dies (journal
replay, idempotent sequence numbers).

- :mod:`~libskylark_tpu_torch.sessions.state` — the per-kind maintained
  sketch and its fold/finalize math;
- :mod:`~libskylark_tpu_torch.sessions.journal` — the append-only
  durability log under ``SKYLARK_SESSION_DIR``;
- :mod:`~libskylark_tpu_torch.sessions.registry` — open/append/finalize,
  TTL eviction, checkpoints, leases, resume with replay;
- the serve executor's session verbs
  (:meth:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor.
  open_sketch_session` and its siblings) put it behind traffic.
"""

from libskylark_tpu_torch.sessions.journal import SessionJournal
from libskylark_tpu_torch.sessions.registry import (SessionRegistry,
                                                    default_session_dir,
                                                    sessions_stats)
from libskylark_tpu_torch.sessions.state import (KINDS, SessionSpec,
                                                 SessionState)

__all__ = [
    "KINDS",
    "SessionJournal",
    "SessionRegistry",
    "SessionSpec",
    "SessionState",
    "default_session_dir",
    "sessions_stats",
]
