"""``skylark-lint`` over the port — repo-specific static analysis (the
port of libskylark_tpu/analysis/).

The serving stack's contracts (capture once and replay many, deadlock-free
drain, hermetic replica environments, one declaration per metric) are
held at runtime by gates that catch one instance at a time. This package
checks them as AST-level invariants over ``libskylark_tpu_torch/``
(``python -m libskylark_tpu_torch.analysis``). Four rule families:

- ``jit-purity`` (:mod:`.rules.jit_purity`) — the bodies that
  ``engine.compiled`` captures as CUDA graphs (and every function they
  reach) must not read the environment, wall clocks, host RNG (torch's
  process-wide generator included), or mutable module globals: a graph
  replays what its body read on the host at capture time;
- ``lock-discipline`` (:mod:`.rules.lock_discipline`) — the static
  lock-acquisition graph over the ``base.locks`` site names must stay
  acyclic, and blocking calls / callback fan-outs must not run under a
  held lock;
- ``env-registry`` (:mod:`.rules.env_registry`) — every ``SKYLARK_*``
  environment read goes through :mod:`libskylark_tpu_torch.base.env`;
- ``metric-names`` (:mod:`.rules.metric_names`) — every telemetry
  instrument name is declared once
  (:mod:`libskylark_tpu_torch.telemetry.names`) and Prometheus-renderable.

Workflow: findings suppress per line
(``# skylark-lint: disable=<rule>`` on the line, or alone on the line
above) or live in the committed shrink-only baseline
(``libskylark_tpu_torch/analysis/baseline.json``). The analysis modules
import nothing but the standard library.
"""

from __future__ import annotations

from libskylark_tpu_torch.analysis.core import (
    BASELINE_PATH, Finding, Project, baseline_load, baseline_save,
    compare_to_baseline, registered_rules, run_rules,
)

__all__ = [
    "BASELINE_PATH", "Finding", "Project", "baseline_load",
    "baseline_save", "compare_to_baseline", "registered_rules",
    "run_rules",
]
