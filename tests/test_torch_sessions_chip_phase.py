"""chip_smoke.py's sessions phase rehearsed on the CPU at a small size:
the same streamed libsvm sketch (prefetch on and off, checkpointed and
resumed), the five session kinds through a MicrobatchExecutor against
their one-shot sketches, a session child killed with SIGKILL and resumed
from the session directory, the drain's checkpoint and the fence, ADMM
stopped and resumed, the exporter's spans and the Prometheus counters,
with every kernel on its plain version (CPU tensors), so the phase
launches nothing.

Small size: the LS operand 4096 × 16 (s = 64) in 16 appends of 256 rows,
isvd k = 8; krr on 600 × 20 (s = 128) in 15 appends of 40; the
rcv1-shaped file at 300 rows into s = 32 in 64-row batches; ADMM with
s = 64 in 2 partitions, 4 iterations.
"""

import importlib.util
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


def test_sessions_phase_holds_on_the_cpu(chip_smoke, capsys):
    """The phase runs its checks, reports each step on its JSON line,
    restores the session directory variable and removes its own."""
    import json

    admm = dict(chip_smoke.ML_FULL, n=600, test=10, d=20, s=64,
                partitions=2, admm_iters=4)
    size = dict(chip_smoke.SESSIONS_FULL, ls_rows=4096, ls_cols=16, s=64,
                batch=256, krr_rows=600, krr_batch=40, krr_s=128,
                rcv1_rows=300, stream_s=32, stream_batch=64, isvd_k=8,
                admm=admm)
    before = os.environ.get("SKYLARK_SESSION_DIR")
    out = chip_smoke.sessions_phase(torch, P, np, size=size, device="cpu")
    assert os.environ.get("SKYLARK_SESSION_DIR") == before
    assert not any(out["launches"].values())
    assert out["checked"] == []
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "sessions"')][-1]
    rec = json.loads(line)
    assert set(rec["kinds"]) == {"cwt", "jlt", "srht", "isvd", "krr"}
    assert rec["kinds"]["cwt"]["equal"] and rec["stream"]["resumed"]["equal"]
    assert rec["killed"]["child_rc"] == -9
    assert rec["killed"]["replayed_records"] == 9
    assert rec["drain"]["fenced"] and rec["admm"]["equal"]
    assert rec["removed_session_dir"]
    assert "chip.sessions.stream" in rec["telemetry"]["spans"]
