"""chip_smoke.py's train_dist phase rehearsed on the CPU at a small size:
the Block-ADMM job under an interactive storm (preempted, equal to the
engine stepped straight and to BlockADMMSolver.train), the LSQR job with
Blendenpik's preconditioner, a child process killed with SIGKILL after
two slices and its job resumed here bit-equal, the four dist kinds
through submit_dist_sketch against sketch_local and a shuffled merge,
in-process replicas with an injected fault, a lost shard (a standard
request refused, an interactive one degraded), a cache hit, and the
lstsq and SVD endpoints, with every kernel on its plain version (CPU
tensors), so the phase launches nothing.

Small size: the LS operand 4096 × 32 (s = 128, 8 shards of 512 rows,
LSQR slices of 4);
ADMM on 600 × 20 with 64 features in 4 partitions; the SVD operand 256²
of rank 32 (rank 8, shards of 32 rows); the storm JLT 256 → 32 on 64
rows.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_dist_phase_holds_on_the_cpu(chip_smoke, capsys):
    admm = dict(chip_smoke.ML_FULL, n=600, test=10, d=20)
    size = dict(chip_smoke.TRAIN_DIST_FULL, ls_rows=4096, ls_cols=32, s=128,
                shard_rows=512, lsqr_slice=4, admm=admm, admm_features=64, svd_n=256,
                svd_r=32, svd_rank=8, svd_shard_rows=32, storm_threads=2,
                storm_requests=8, storm_rows=64, storm_n=256, storm_s=32)
    before = os.environ.get("SKYLARK_SESSION_DIR")
    out = chip_smoke.train_dist_phase(torch, P, np, size=size, device="cpu")
    assert os.environ.get("SKYLARK_SESSION_DIR") == before
    assert not any(out["launches"].values())
    assert out["checked"] == []
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "train_dist"')][-1]
    rec = json.loads(line)
    assert rec["admm"]["equal"] and rec["admm"]["preemptions"] > 0
    assert rec["lsqr"]["equal"] and rec["lsqr"]["killed"]["equal"]
    assert rec["lsqr"]["killed"]["child_rc"] == -9
    assert set(rec["dist"]["kinds"]) == {"cwt", "jlt", "srht", "ust"}
    assert all(k["equal"] and k["merge_equal"]
               for k in rec["dist"]["kinds"].values())
    assert rec["dist"]["degraded"]["coverage"] == 7 / 8
    assert rec["dist"]["cache"]["hits"] == 1
    assert rec["removed_session_dir"]
    assert set(rec["launches_by_run"]) == {
        "admm_job", "lsqr_job", "lsqr_resume", "dist_cwt", "dist_jlt",
        "dist_srht", "dist_ust", "dist_replicas", "dist_degraded",
        "dist_cache_hit", "dist_lstsq", "dist_svd"}
