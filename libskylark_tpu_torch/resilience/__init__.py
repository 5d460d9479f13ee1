"""Resilience: retry policies and deadlines, deterministic fault
injection, health-state publication and preemption-safe teardown (the
port of libskylark_tpu/resilience/).

- :mod:`~libskylark_tpu_torch.resilience.policy`: :class:`RetryPolicy`
  and :class:`Deadline`;
- :mod:`~libskylark_tpu_torch.resilience.faults`: the seeded fault plans
  behind named sites (``serve.flush``, ``qos.admit``);
- :mod:`~libskylark_tpu_torch.resilience.health`: the hub the serve
  executor publishes its state transitions to;
- :mod:`~libskylark_tpu_torch.resilience.preemption`: SIGTERM drains
  every live executor and runs the registered hooks.

Consumers: the microbatch executor's bisection retries, deadlines,
health states and admission (:mod:`libskylark_tpu_torch.engine.serve`).
"""

from libskylark_tpu_torch.resilience import faults, health
from libskylark_tpu_torch.resilience.faults import (FaultPlan, fault_plan,
                                                    fired)
from libskylark_tpu_torch.resilience.policy import (TRANSIENT_ERRORS,
                                                    Deadline,
                                                    DeadlineExceededError,
                                                    RetryPolicy)
from libskylark_tpu_torch.resilience.preemption import (
    drain_serving, install_preemption_handler, on_preemption,
    preemption_requested, register_checkpoint, reset_preemption,
    uninstall_preemption_handler, wait_for_preemption_teardown)

__all__ = [
    "Deadline", "DeadlineExceededError", "FaultPlan", "RetryPolicy",
    "TRANSIENT_ERRORS", "drain_serving", "fault_plan", "faults", "fired",
    "health",
    "install_preemption_handler", "on_preemption", "preemption_requested",
    "register_checkpoint", "reset_preemption",
    "uninstall_preemption_handler", "wait_for_preemption_teardown",
]
