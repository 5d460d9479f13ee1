"""chip_smoke.py's cli_net phase rehearsed on the CPU at a small size:
skylark_svd, skylark_linear (default and -p) and skylark_ml (train, then
--testfile) through ``main(argv)`` with ``--device cpu``, each output
byte-identical to the library call it wraps made in-process; then a
NetServer over a CPU executor and a NetClient in a child process: the
dense-rw requests from two threads, a dist cwt sketch, a cwt session,
ping and stats, and a drain with requests inflight, each result
byte-equal to the same request made in-process. Every kernel takes its
plain version on CPU tensors, so the phase launches nothing.

Small size: the SVD 256² (rank 8); LS 1024 × 32; ADMM on 600 × 784 with
64 features in 2 partitions, 3 iterations; the requests JLT 256 → 32 on
33–64 rows; the dist and session operand 1024 × 32 into 64.
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


def test_cli_net_phase_holds_on_the_cpu(chip_smoke, capsys):
    size = dict(chip_smoke.CLI_NET_FULL, svd_n=256, svd_k=8, ls_rows=1024,
                ls_cols=32, ml_rows=600, ml_test=100, ml_features=64,
                ml_parts=2, ml_iters=3, net_requests=8, net_seeds=4,
                net_threads=2, net_n=256, net_s=32, net_rows=(33, 65),
                dist_rows=1024, dist_cols=32, dist_s=64,
                dist_shard_rows=256, drain_burst=3)
    before = os.environ.get("SKYLARK_SESSION_DIR")
    out = chip_smoke.cli_net_phase(torch, P, np, size=size, device="cpu")
    assert os.environ.get("SKYLARK_SESSION_DIR") == before
    assert not any(out["launches"].values())
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "cli_net"')][-1]
    rec = json.loads(line)
    cli, net = rec["cli"], rec["net"]
    assert cli["svd_identical"] and cli["linear_identical"]
    assert cli["ml_identical"] and cli["accuracy"].startswith("Accuracy")
    # 8 dense-rw, ping, stats, the dist sketch, the session (open, 4
    # appends, finalize) and the drain's burst of 3
    assert net["identical"] and net["requests"] == 8 + 2 + 1 + 6 + 3
    assert net["drain"]["quiesced"] and net["drain"]["inflight"] >= 1
    assert net["drain"]["goaways_seen"] >= 1
    assert net["drain"]["settled"] == 3
    assert set(rec["launches_by_run"]) == {
        "cli_svd", "cli_linear", "cli_linear_p", "cli_ml_train",
        "cli_ml_test", "net"}


def test_the_libsvm_writer_reads_back(chip_smoke, tmp_path):
    """The phase's vectorized writer: what the port's reader parses is
    the data rounded to the written decimals."""
    from libskylark_tpu_torch.io import read_libsvm

    rng = np.random.default_rng(0)
    X = (rng.standard_normal((37, 12)) * 40).astype(np.float32)
    y = (rng.standard_normal(37) * 900).astype(np.float32)
    path = str(tmp_path / "d.libsvm")
    n = chip_smoke.write_dense_libsvm(np, path, X, y)
    assert n == os.path.getsize(path)
    Xr, yr = read_libsvm(path)
    assert Xr.shape == X.shape
    for got, want in ((Xr, X), (yr, y)):
        # half a unit of the sixth decimal, then float32's rounding
        limit = 5e-7 + np.spacing(np.abs(want).max())
        assert np.abs(got - want).max() <= limit
