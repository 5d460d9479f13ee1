"""chip_smoke.py's fleet phase (4l) rehearsed on the CPU at a small size:
a thread fleet, two process pools (slots that hold an operand, and slots
too small for any, so every array falls back to the pipe) with the same
requests, a dist cwt sketch over the children, a session and an lsqr job
whose owner is drained by a real SIGTERM with requests queued behind its
stalled slice, a NetServer over the router with a client child and a
torn connection's resend, a hedge whose primary's flush is stalled in
the child, and a ``kill -9``'d child replaced by an autoscaler's pack
boot. Every result is held ``torch.equal`` to its one-process twin.
Every kernel takes its plain version on CPU tensors, so the phase
launches nothing.

Small size: JLT 256 → 32 rowwise on 33–64 rows (8 requests), CWT 256 →
32 on 17–32 rows (2); LS 1024 × 32 → 64 in shards of 128 rows and 8
session appends; lsqr slices of 2 iterations.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P
from libskylark_tpu_torch import fleet

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"),
    reason="POSIX shared memory filesystem not available")


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fleet_phase_holds_on_the_cpu(chip_smoke, capsys):
    size = dict(chip_smoke.FLEET_FULL, n=256, s=32, rw_requests=8,
                rw_seeds=4, rw_rows=(33, 65), cwt_requests=2,
                cwt_rows=(17, 33), threads=2, big_slot_bytes=1 << 17,
                small_slot_bytes=1 << 12, ls_rows=1024, ls_cols=32,
                ls_s=64, shard_rows=128, lsqr_slice=2, lsqr_budget=64,
                train_stall_s=0.3, hedge_stall_s=0.6, net_requests=4)
    before = os.environ.get("SKYLARK_SESSION_DIR")
    out = chip_smoke.fleet_phase(torch, P, np, size=size, device="cpu")
    assert os.environ.get("SKYLARK_SESSION_DIR") == before
    assert not any(out["launches"].values())
    assert fleet.shm_entries(pid=os.getpid()) == []
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "fleet"')][-1]
    rec = json.loads(line)
    assert set(rec["launches_by_run"]) == {
        "thread", "process_big", "process_small", "dist", "drain", "net",
        "hedge", "replacement"}
    big, small = rec["process_big"]["transport"], \
        rec["process_small"]["transport"]
    assert big["shm_bytes"] > 0 and big["fallbacks"] == 0
    assert small["shm_bytes"] == 0 and small["pickle_bytes"] > 0
    drain = rec["drain"]
    assert drain["hub"][-2:] == ["DRAINING", "STOPPED"]
    assert drain["session_handoffs"] >= 1 and drain["train_resumes"] >= 1
    assert rec["net"]["resend"]["flushes"] == 1
    assert rec["net"]["resend"]["transport_retries"] == 1
    assert rec["hedge"]["hedge_wins"] == 1
    assert rec["hedge"]["hedge_mismatches"] == 0
    assert rec["crash"]["warmup"]["loaded"] >= 1
    assert rec["crash"]["first_request"]["misses"] == 0
    assert rec["crash"]["crashed"] == [rec["crash"]["victim"]]
