"""Sketch-size-communication algorithms over the distributed sketch (the
port of libskylark_tpu/dist/algorithms.py).

Randomized SVD and sketched least squares whose only traffic between
replicas is the merged ``s_dim × d`` sketch: each replica folds its own
row shards and returns a partial. Both entry points have the whole
fault-tolerance contract: retried shard tasks, quantified degraded
merges, the ``min_coverage`` gate.

The plan builders (:func:`svd_plan`, :func:`lstsq_plan`) and the local
factor steps are shared with the serve endpoints (``submit_dist_svd`` /
``submit_dist_lstsq``, :mod:`libskylark_tpu_torch.dist.serve`), so the
library call and the serve request of the same arguments sketch the same
plan: the same bits and the same cache digest.
"""

from __future__ import annotations

from typing import Optional

from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.dist import plan as _plan
from libskylark_tpu_torch.dist.coordinator import DistSketchCoordinator


def svd_plan(source: _plan.ShardSource, rank: int, *,
             s_dim: Optional[int] = None, seed: int = 0,
             kind: str = "jlt", shard_rows: int = 0) -> _plan.ShardPlan:
    """The validated :class:`~libskylark_tpu_torch.dist.plan.ShardPlan` of
    a distributed randomized SVD: an additive row sketch of
    ``s_dim or max(2·rank, rank+8)`` rows (at most ``source.n``)."""
    if rank < 1:
        raise errors.InvalidParametersError(
            f"rank must be >= 1, got {rank}")
    s = int(s_dim) if s_dim else max(2 * int(rank), int(rank) + 8)
    if kind not in _plan.ADDITIVE_KINDS:
        raise errors.InvalidParametersError(
            f"randomized_svd needs an additive sketch kind, got {kind!r}")
    return _plan.ShardPlan(kind=kind, n=source.n,
                           s_dim=min(s, source.n), d=source.d,
                           seed=seed, shard_rows=shard_rows).validate()


def lstsq_plan(source: _plan.ShardSource, *, s_dim: int, seed: int = 0,
               kind: str = "cwt",
               shard_rows: int = 0) -> _plan.ShardPlan:
    """The validated joint-sketch plan of a distributed sketched
    least-squares solve: the source must carry targets (``Y``)."""
    if source.targets < 1:
        raise errors.InvalidParametersError(
            "sketched_lstsq needs a source with targets (Y rows)")
    if kind not in _plan.ADDITIVE_KINDS:
        raise errors.InvalidParametersError(
            f"sketched_lstsq needs an additive sketch kind, got {kind!r}")
    return _plan.ShardPlan(kind=kind, n=source.n,
                           s_dim=min(int(s_dim), source.n),
                           d=source.d, seed=seed,
                           targets=source.targets,
                           shard_rows=shard_rows).validate()


def _run(plan: _plan.ShardPlan, source: _plan.ShardSource,
         coordinator: Optional[DistSketchCoordinator],
         min_coverage: Optional[float], device) -> _plan.DistSketchResult:
    if coordinator is None:
        result = _plan.sketch_local(plan, source, device=device)
        gate = 1.0 if min_coverage is None else float(min_coverage)
        return result.require(gate)
    return coordinator.sketch(plan, source, min_coverage=min_coverage)


def randomized_svd(source: _plan.ShardSource, rank: int, *,
                   s_dim: Optional[int] = None, seed: int = 0,
                   kind: str = "jlt", shard_rows: int = 0,
                   coordinator: Optional[DistSketchCoordinator] = None,
                   min_coverage: Optional[float] = None,
                   device=None) -> dict:
    """Distributed one-pass randomized SVD of a row-sharded dataset:
    merge the ``s_dim × d`` row sketch, then factor it locally. Returns
    ``singular_values`` and ``Vt`` (top ``rank``, tensors on the sketch's
    device), the merge's exact ``coverage`` and ``missing`` ranges, and
    ``degraded``: a degraded merge above ``min_coverage`` gives the SVD
    of the surviving rows' sketch, labeled so. Without a
    ``coordinator`` the shards compute here on ``device``."""
    from libskylark_tpu_torch.dist.serve import solve_svd

    plan = svd_plan(source, rank, s_dim=s_dim, seed=seed, kind=kind,
                    shard_rows=shard_rows)
    return solve_svd(_run(plan, source, coordinator, min_coverage,
                          device), rank)


def sketched_lstsq(source: _plan.ShardSource, *,
                   s_dim: int, seed: int = 0, kind: str = "cwt",
                   shard_rows: int = 0,
                   coordinator: Optional[DistSketchCoordinator] = None,
                   min_coverage: Optional[float] = None,
                   device=None) -> dict:
    """Distributed sketch-and-solve least squares ``min_w ||X w − Y||``:
    merge the joint ``(S·X, S·Y)`` sketch off the row shards, solve the
    small ``s_dim × d`` problem locally. The source must carry targets.
    Returns ``coef`` (d × targets) and the coverage accounting."""
    from libskylark_tpu_torch.dist.serve import solve_lstsq

    plan = lstsq_plan(source, s_dim=s_dim, seed=seed, kind=kind,
                      shard_rows=shard_rows)
    return solve_lstsq(_run(plan, source, coordinator, min_coverage,
                            device))


__all__ = ["lstsq_plan", "randomized_svd", "sketched_lstsq", "svd_plan"]
