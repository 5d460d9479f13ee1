"""Multi-tenant QoS for the serve executor: tenants and classes with
token-bucket admission, weighted-fair deficit scheduling across the class
queues, and the adaptive batching controller (the port of
libskylark_tpu/qos/).

Usage::

    from libskylark_tpu_torch import qos

    reg = qos.TenantRegistry()
    reg.register("search-ui", qos.INTERACTIVE)
    reg.register("bulk-etl", qos.BEST_EFFORT, rate=200.0)
    ex = engine.MicrobatchExecutor(tenants=reg)
    fut = ex.submit_sketch(T, A, tenant="search-ui")
"""

from libskylark_tpu_torch.qos.controller import AdaptiveController
from libskylark_tpu_torch.qos.scheduler import DeficitScheduler, drain_order
from libskylark_tpu_torch.qos.tenants import (BEST_EFFORT, CLASSES,
                                        DEFAULT_WEIGHTS, INTERACTIVE,
                                        STANDARD, ClassPolicy, Tenant,
                                        TenantRegistry, TokenBucket,
                                        class_policy, coerce_class,
                                        default_class, get_registry,
                                        shed_fraction, slo_seconds)

__all__ = [
    "AdaptiveController", "BEST_EFFORT", "CLASSES", "ClassPolicy",
    "DEFAULT_WEIGHTS", "DeficitScheduler", "INTERACTIVE", "STANDARD",
    "Tenant", "TenantRegistry", "TokenBucket", "class_policy",
    "coerce_class", "default_class", "drain_order", "get_registry",
    "shed_fraction", "slo_seconds",
]
