"""Fleet subsystem: a replicated serving tier over N microbatch executors
(the port of libskylark_tpu/fleet/).

- :mod:`~libskylark_tpu_torch.fleet.replica`: the unit of capacity,
  :class:`ThreadReplica` (an in-process executor) and
  :class:`ProcessReplica` (a spawned child with its own executor, CUDA
  context and preemption handler).
- :mod:`~libskylark_tpu_torch.fleet.pool`: :class:`ReplicaPool`, N
  uniform named replicas on one ``device``, per-replica drain hooks, and
  single-replica preemption composed with the process-wide SIGTERM
  handler.
- :mod:`~libskylark_tpu_torch.fleet.ring`: the consistent-hash
  :class:`HashRing` that makes routing sticky (one bucket class, one warm
  replica) and places dist shard tasks.
- :mod:`~libskylark_tpu_torch.fleet.router`: :class:`Router`, the front
  door whose ``submit`` mirrors the executor's and routes on affinity,
  live queue depth and subscribed health states, failing over past
  refusing or draining replicas, and hedging stragglers when enabled.
- :mod:`~libskylark_tpu_torch.fleet.shm`: :class:`ShmTransport`, the
  shared-memory operand and result rings of a process replica (pickle
  fallback, unlink-at-boot lifecycle; no tensor on a pipe).
- :mod:`~libskylark_tpu_torch.fleet.autoscale`: :class:`Autoscaler`, the
  queue-depth controller that grows the pool by a pack boot and shrinks
  it by a SIGTERM drain.

``net.NetServer`` fronts a :class:`Router`, and the dist coordinator runs
its shard tasks on a :class:`ReplicaPool`. Where the port departs from
the reference is ROADMAP C28.
"""

from libskylark_tpu_torch.fleet.autoscale import Autoscaler, autoscale_stats
from libskylark_tpu_torch.fleet.pool import ReplicaPool, resolve_backend
from libskylark_tpu_torch.fleet.replica import (PROPAGATED_ENV,
                                                ProcessReplica, Replica,
                                                ThreadReplica,
                                                propagated_env)
from libskylark_tpu_torch.fleet.ring import HashRing
from libskylark_tpu_torch.fleet.router import (NoHealthyReplicaError,
                                               Router, fleet_stats)
from libskylark_tpu_torch.fleet.shm import ShmTransport, shm_entries

__all__ = [
    "Autoscaler", "HashRing", "NoHealthyReplicaError", "PROPAGATED_ENV",
    "ProcessReplica", "Replica", "ReplicaPool", "Router",
    "ShmTransport", "ThreadReplica", "autoscale_stats", "fleet_stats",
    "propagated_env", "resolve_backend", "shm_entries",
]
