"""Fleet subsystem: a replicated serving tier over N microbatch
executors (the port of libskylark_tpu/fleet/).

Ported so far: :mod:`~libskylark_tpu_torch.fleet.ring`, the
consistent-hash :class:`HashRing` that places shard tasks (the dist
coordinator) and, with the router, bucket classes. The replica pool, the
replicas, the router, the shared-memory transport and the autoscaler
come with a later slice (ROADMAP A7, C12).
"""

from libskylark_tpu_torch.fleet.ring import HashRing

__all__ = ["HashRing"]
