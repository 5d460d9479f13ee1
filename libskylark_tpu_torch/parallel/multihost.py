"""Process bootstrap and host-level queries (the port of
libskylark_tpu/parallel/multihost.py).

The reference's process model is one JAX controller per host joined by
``jax.distributed.initialize`` (MPI_Init's analog). Here it is SPMD: one
process per device, joined by ``torch.distributed.init_process_group``
over TCP (``tcp://host:port``, the coordinator's address; rank 0 hosts
the store). The backend follows the package default device — NCCL for
CUDA, gloo for the CPU — unless the call names one (gloo also carries
``all_reduce`` and ``broadcast`` of CUDA tensors, which lets two processes
share one card).
"""

from __future__ import annotations

import datetime
import socket
import time
from typing import Optional

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.base.device import default_device


def _probe_coordinator(address: str, timeout: float) -> None:
    """Bounded TCP reachability probe of the coordinator, retried until
    ``timeout`` (the coordinator may start moments after its workers).

    It runs before ``init_process_group``, whose TCP store client waits
    out its whole timeout on an unreachable coordinator and then raises
    an untyped error; a plain socket connect gives a
    :class:`~libskylark_tpu_torch.base.errors.CommunicationError` with the
    coordinator in its trace instead."""
    host, _, port = address.rpartition(":")
    try:
        port_no = int(port)
    except ValueError:
        raise errors.CommunicationError(
            f"malformed coordinator address {address!r} (expected host:port)")
    deadline = time.monotonic() + timeout
    last: Optional[BaseException] = None
    while True:
        step = max(min(deadline - time.monotonic(), 1.0), 0.05)
        try:
            with socket.create_connection((host or "127.0.0.1", port_no),
                                          timeout=step):
                return
        except OSError as e:
            last = e
        if time.monotonic() >= deadline:
            err = errors.CommunicationError(
                f"coordinator {address!r} unreachable after "
                f"{timeout}s: {last}")
            err.append_trace(f"coordinator={address!r} "
                             f"connect_timeout={timeout}")
            raise err from last
        time.sleep(min(0.1, max(deadline - time.monotonic(), 0)))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    connect_timeout: Optional[float] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (MPI_Init's analog; a no-op once joined).

    ``coordinator_address`` ("host:port") becomes ``init_method=
    "tcp://host:port"``, ``num_processes`` the world size and
    ``process_id`` the rank; with no address, torch reads the group from
    the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``backend`` defaults to NCCL when the package default
    device is CUDA, else gloo.

    ``connect_timeout`` (seconds) becomes the group's ``timeout``. With
    it, a worker with an *explicit* nonzero ``process_id`` TCP-probes the
    coordinator first and raises
    :class:`~libskylark_tpu_torch.base.errors.CommunicationError` with the
    coordinator in its trace, never a raw ``RuntimeError``. Process 0
    hosts the store itself and is not probed. Any failure of
    ``init_process_group`` is a ``CommunicationError`` too.
    """
    import torch.distributed as dist

    if dist.is_initialized():  # already joined — MPI_Init semantics
        return
    kw = {}
    if connect_timeout is not None:
        if coordinator_address and process_id not in (None, 0):
            _probe_coordinator(coordinator_address, connect_timeout)
        kw["timeout"] = datetime.timedelta(
            seconds=max(float(connect_timeout), 1.0))
    if coordinator_address:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if backend is None:
        backend = "nccl" if default_device().type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, **kw)
    except (RuntimeError, ValueError) as e:
        err = errors.CommunicationError(
            f"distributed initialization failed: {e}")
        err.append_trace(
            f"coordinator={coordinator_address!r} "
            f"num_processes={num_processes} process_id={process_id} "
            f"connect_timeout={connect_timeout} backend={backend}")
        raise err from e


def process_count() -> int:
    """Number of processes in the group (MPI size analog); 1 before
    joining one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (MPI rank analog); 0 is the reference's
    'root'."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_root() -> bool:
    """ref: the ubiquitous ``rank == 0`` guard (e.g. ml/io.hpp readers)."""
    return process_index() == 0
