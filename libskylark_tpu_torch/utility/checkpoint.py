"""Training-state checkpoints and durable state snapshots (the port of
libskylark_tpu/utility/checkpoint.py).

Two tiers, as in the reference:

- :func:`save_sync` / :func:`load_sync` — one atomic, durable snapshot of
  a dict of host arrays: an npz whose reserved ``__meta__`` record holds
  the JSON metadata (so one ``os.replace`` commits arrays and metadata
  together), a ``.json`` twin for forensics only, tmp file + fsync +
  rename. The format is the reference's byte for byte: a snapshot
  written by either package loads in the other.
- :class:`TrainCheckpointer` — a versioned store of training states
  (pytrees of tensors) under one directory. The reference wraps orbax,
  which needs jax; here each step is a directory holding one
  :func:`save_sync` snapshot, written by a background thread after
  :meth:`TrainCheckpointer.save` has copied every device tensor to host
  memory (so a later in-place update of the state cannot race the
  write). The on-disk layout is the port's own (ROADMAP C23): a
  reference orbax checkpoint is not read, nor is this one by the
  reference.

:func:`sample_digest` is the resume identity of a dataset: the
reference's hex for the same float32 bytes, on the CPU or the card (a
CUDA tensor sends only the sampled rows to the host).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.resilience import faults

# ---------------------------------------------------------------------------
# synchronous state snapshots
# ---------------------------------------------------------------------------


def save_sync(path: str, arrays: dict, metadata: Optional[dict] = None
              ) -> None:
    """Atomically persist ``arrays`` (name -> host array or tensor) at
    ``path`` (``<path>.npz`` + ``<path>.json``), durable before return.
    ``np.save`` stores raw bytes, so a restored accumulator continues
    bit-equal. The ``checkpoint.save`` fault site fires here."""
    faults.check("checkpoint.save", detail=f"sync:{os.path.basename(path)}")
    payload = {k: _host(v) for k, v in arrays.items()}
    if "__meta__" in payload:
        raise ValueError("'__meta__' is a reserved checkpoint key")
    # the metadata rides inside the npz: one os.replace commits both, and
    # a resume can never pair arrays and metadata of two generations
    payload["__meta__"] = np.frombuffer(
        json.dumps(metadata or {}).encode("utf-8"), dtype=np.uint8)
    npz_tmp = path + ".npz.tmp"
    with open(npz_tmp, "wb") as fh:
        np.savez(fh, **payload)
        fh.flush()
        os.fsync(fh.fileno())
    json_tmp = path + ".json.tmp"
    with open(json_tmp, "w") as fh:
        json.dump(metadata or {}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(npz_tmp, path + ".npz")
    os.replace(json_tmp, path + ".json")


def load_sync(path: str):
    """``(arrays, metadata)`` written by :func:`save_sync` (either
    package's), or ``None`` when no committed snapshot exists at
    ``path``. The metadata comes from the npz's ``__meta__`` record,
    never from the forensics sidecar."""
    if not os.path.exists(path + ".npz"):
        return None
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        metadata = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    return arrays, metadata


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array, bytes
    unchanged."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# pytrees of tensors: flatten to named leaves and back
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: list):
    """The structure of ``tree`` as JSON, its leaves appended to
    ``leaves`` in order (dicts by sorted key, lists and tuples in
    order)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        if any(not isinstance(k, str) for k in keys):
            raise errors.InvalidParametersError(
                "checkpoint state dicts need string keys")
        return {"t": "dict", "k": keys,
                "c": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {"t": type(tree).__name__,
                "c": [_flatten(x, leaves) for x in tree]}
    if tree is None:
        return {"t": "none"}
    leaves.append(tree)
    return {"t": "leaf", "i": len(leaves) - 1,
            "tensor": isinstance(tree, torch.Tensor)}


def _unflatten(spec, leaves: list, target=None):
    t = spec["t"]
    if t == "dict":
        return {k: _unflatten(c, leaves, _child(target, k))
                for k, c in zip(spec["k"], spec["c"])}
    if t in ("list", "tuple"):
        out = [_unflatten(c, leaves, _child(target, i))
               for i, c in enumerate(spec["c"])]
        return tuple(out) if t == "tuple" else out
    if t == "none":
        return None
    arr = leaves[spec["i"]]
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=target.device,
                                                  dtype=target.dtype)
    return arr


def _child(target, key):
    try:
        return None if target is None else target[key]
    except (KeyError, IndexError, TypeError):
        return None


# ---------------------------------------------------------------------------
# the training checkpointer
# ---------------------------------------------------------------------------

_STATE = "state"


class TrainCheckpointer:
    """Versioned training-state store under one directory.

    ``save(step, state, metadata)`` persists a pytree of tensors and
    arrays plus a small JSON dict; ``restore()`` returns the newest
    ``(step, state, metadata)``. Saves are asynchronous unless
    ``async_save=False``: :meth:`save` copies the state to host memory,
    then a background thread writes ``<directory>/<step>/`` (a
    :func:`save_sync` snapshot in a temporary directory renamed into
    place, so a step is there whole or not at all). In-flight writes
    finish on :meth:`close`, on the context manager's exit and before
    any read. ``keep`` bounds the disk to the newest N steps."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(str(directory))
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(int(keep), 1)
        self._async = bool(async_save)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write side --

    def save(self, step: int, state: Any,
             metadata: Optional[dict] = None) -> None:
        """Persist ``state`` at ``step``. Returns once the state is in
        host memory (async mode) or on disk."""
        faults.check("checkpoint.save", detail=f"step={int(step)}")
        leaves: list = []
        tree = _flatten(state, leaves)
        # the host copy, before returning: a later in-place update of a
        # device tensor must not race the background write
        arrays = {f"leaf_{i}": _host(x).copy() for i, x in enumerate(leaves)}
        meta = {"tree": tree, "metadata": dict(metadata or {}),
                "step": int(step)}
        self.wait_until_finished()
        if not self._async:
            self._write(int(step), arrays, meta)
            return
        t = threading.Thread(target=self._write_bg,
                             args=(int(step), arrays, meta),
                             name="skylark-checkpoint", daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def _write_bg(self, step: int, arrays: dict, meta: dict) -> None:
        try:
            self._write(step, arrays, meta)
        except BaseException as e:  # noqa: BLE001 — re-raised at the wait
            with self._lock:
                self._error = e

    def _write(self, step: int, arrays: dict, meta: dict) -> None:
        final = os.path.join(self._dir, str(step))
        tmp = os.path.join(self._dir, f".{step}.{uuid.uuid4().hex[:12]}.tmp")
        os.makedirs(tmp)
        try:
            save_sync(os.path.join(tmp, _STATE), arrays, meta)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self._dir)
        for old in self._steps()[:-self._keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until the in-flight write is on disk; re-raise its
        failure, if it failed."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()
        with self._lock:
            self._thread = None
            err, self._error = self._error, None
        if err is not None:
            raise err

    def save_sync(self, step: int, state: Any,
                  metadata: Optional[dict] = None, retry=None) -> None:
        """The preemption-handler save: blocks until the step is durable,
        retrying transient failures under ``retry`` (default: 3
        attempts, short backoff)."""
        from libskylark_tpu_torch.resilience.policy import RetryPolicy

        retry = retry or RetryPolicy(max_attempts=3, base_delay=0.1,
                                     max_delay=1.0)

        def attempt():
            self.save(step, state, metadata)
            self.wait_until_finished()

        retry.call(attempt)

    # -- read side --

    def _steps(self) -> list:
        out = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self._dir, name, _STATE + ".npz")):
                out.append(int(name))
        return sorted(out)

    def all_steps(self) -> list:
        self.wait_until_finished()
        return self._steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise errors.InvalidParametersError(
                f"no checkpoint found under {self._dir}")
        got = load_sync(os.path.join(self._dir, str(step), _STATE))
        if got is None:
            raise errors.InvalidParametersError(
                f"no checkpoint at step {step} under {self._dir}")
        return step, got[0], got[1]

    def restore(self, step: Optional[int] = None, target: Any = None):
        """``(step, state, metadata)`` for ``step`` (default: newest).
        Leaves come back as host numpy arrays; with ``target`` (a pytree
        of like-structured tensors, e.g. the fresh solver state) each
        leaf whose target is a tensor comes back as a tensor on the
        target's device, of its dtype."""
        step, arrays, meta = self._load(step)
        leaves = [arrays[f"leaf_{i}"] for i in range(len(arrays))]
        state = _unflatten(meta["tree"], leaves, target)
        return step, state, dict(meta.get("metadata") or {})

    def metadata(self, step: Optional[int] = None):
        """``(step, metadata)`` without building the state: callers check
        identity first, then :meth:`restore`."""
        step, _, meta = self._load(step)
        return step, dict(meta.get("metadata") or {})

    # -- lifecycle --

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fsync_dir(path: str) -> None:
    """Make a rename in ``path`` durable (POSIX; a no-op elsewhere)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def as_checkpointer(obj) -> TrainCheckpointer:
    """A path-or-checkpointer argument as a :class:`TrainCheckpointer`
    (a directory string gets the defaults)."""
    if isinstance(obj, TrainCheckpointer):
        return obj
    return TrainCheckpointer(str(obj))


# ---------------------------------------------------------------------------
# resume identities
# ---------------------------------------------------------------------------


def sample_digest(a, rows: int | None = None,
                  byte_budget: int = 64 << 20) -> str:
    """Exact, platform-independent data identity for resume checks:
    sha256 over the float32 bytes of a deterministic sample of
    leading-axis slices plus the full shape — the reference's digest,
    hex for hex. Every byte is hashed while the float32 view fits
    ``byte_budget`` (64 MiB); above it, as many evenly strided slices as
    the budget buys (never fewer than 16), the same ones as the
    reference's. ``rows`` overrides the sample size. A CUDA tensor sends
    only the sampled rows to the host. A DTensor is refused: its rows lie
    on other ranks (ROADMAP C23)."""
    from libskylark_tpu_torch.parallel.mesh import _is_sharded

    if _is_sharded(a):
        raise errors.UnsupportedError(
            "sample_digest of a DTensor: its rows lie on other ranks "
            "(ROADMAP C23)")
    shape = tuple(int(d) for d in getattr(a, "shape", ()))
    ndim = len(shape)
    n = shape[0] if ndim else 1
    if rows is None:
        row_bytes = 4 * int(np.prod(shape[1:], dtype=np.int64) or 1)
        rows = max(16, byte_budget // max(row_bytes, 1))
    idx = sorted(set(
        int(i) for i in np.linspace(0, max(n - 1, 0), num=min(rows, n))))
    if isinstance(a, torch.Tensor):
        if ndim:
            sel = a.index_select(0, torch.as_tensor(idx, dtype=torch.int64,
                                                    device=a.device))
        else:
            sel = a
        sample = np.ascontiguousarray(
            sel.detach().to(torch.float32).cpu().numpy())
    else:
        a = np.asarray(a) if not hasattr(a, "shape") else a
        idx_arr = np.asarray(idx, dtype=np.intp)
        sample = np.ascontiguousarray(
            np.asarray(a[idx_arr] if ndim else a, np.float32))
    h = hashlib.sha256()
    h.update(repr((shape, idx)).encode())
    h.update(sample.tobytes())
    return h.hexdigest()


def device_state(state, dtype=None, device=None):
    """A pytree of host arrays as tensors on ``device`` (default: the
    package default), floating-point leaves cast to ``dtype`` when
    given; integer and bool leaves keep their stored dtype."""
    from libskylark_tpu_torch.base.device import resolve_device

    dev = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if not hasattr(x, "shape"):
            return x
        t = (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x)))
        if dtype is not None and t.is_floating_point():
            return t.to(device=dev, dtype=dtype)
        return t.to(dev)

    return put(state)


__all__ = ["TrainCheckpointer", "as_checkpointer", "device_state",
           "load_sync", "sample_digest", "save_sync"]
