"""Distributed sketching over row-sharded data, failure handling first
(the port of libskylark_tpu/dist/).

Sketching is linear, so a row shard is a recomputable, idempotent unit
of work, and a lost shard still leaves a valid sketch of the surviving
rows whose coverage is reported, never silent.

- :mod:`~libskylark_tpu_torch.dist.plan`: :class:`ShardPlan` (numbered
  row-range shard tasks whose operator slices are positional functions
  of the plan seed), range-readable :class:`ShardSource` descriptors
  (in-memory rows, HDF5, libsvm streams with resume at the consumed
  offset), the canonical merge tree, and the coverage-quantified results
  (:class:`DistSketchResult` / :class:`DegradedSketchResult`).
- :mod:`~libskylark_tpu_torch.dist.coordinator`:
  :class:`DistSketchCoordinator`: ring-preference placement over
  replicas, retry and reassignment under ``SKYLARK_DIST_RETRIES``,
  straggler hedging, and the ``min_coverage`` gate
  (:class:`~libskylark_tpu_torch.base.errors.SketchCoverageError`).
- :mod:`~libskylark_tpu_torch.dist.algorithms`: distributed randomized
  SVD and sketched least squares whose only traffic between replicas is
  the merged sketch.
- :mod:`~libskylark_tpu_torch.dist.serve`: :class:`DistServeJob` behind
  the ``submit_dist_sketch`` / ``submit_dist_lstsq`` /
  ``submit_dist_svd`` endpoints of
  :class:`~libskylark_tpu_torch.engine.serve.MicrobatchExecutor`:
  incremental merging, per-class ``min_coverage`` gates with early
  resolve of interactive requests, tenant-billed retries and hedges, and
  content-addressed caching of whole jobs.
"""

from libskylark_tpu_torch.dist.algorithms import (lstsq_plan,
                                                  randomized_svd,
                                                  sketched_lstsq, svd_plan)
from libskylark_tpu_torch.dist.coordinator import (DistSketchCoordinator,
                                                   dist_stats)
from libskylark_tpu_torch.dist.plan import (ArraySource,
                                            DegradedSketchResult,
                                            DistSketchResult, HDF5Source,
                                            LibsvmSource, ShardPlan,
                                            ShardSource, merge_partials,
                                            sketch_local)
from libskylark_tpu_torch.dist.serve import (DistServeJob,
                                             IncrementalMerger,
                                             class_min_coverage,
                                             dist_request_digest,
                                             dist_serve_stats)

__all__ = [
    "ArraySource", "DegradedSketchResult", "DistServeJob",
    "DistSketchCoordinator", "DistSketchResult", "HDF5Source",
    "IncrementalMerger", "LibsvmSource", "ShardPlan", "ShardSource",
    "class_min_coverage", "dist_request_digest", "dist_serve_stats",
    "dist_stats", "lstsq_plan", "merge_partials", "randomized_svd",
    "sketch_local", "sketched_lstsq", "svd_plan",
]
