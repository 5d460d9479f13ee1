"""Rule modules self-register with :func:`..core.rule` on import."""

from libskylark_tpu_torch.analysis.rules import (  # noqa: F401
    env_registry, jit_purity, lock_discipline, metric_names,
)
