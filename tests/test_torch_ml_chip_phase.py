"""chip_smoke.py's ml phase (config 5) rehearsed on the CPU at a small
size: the same entry points, data model and checks as on the card, with
every kernel on its plain version (a CPU tensor), so each step launches
nothing; and the launch check that the card run applies, on the launch
counts the card run must show and on counts it must refuse.

Small size: 1200 training and 300 held-out rows of the phase's d = 784,
s = 128 in 4 BCD blocks, 1024 rows for the exact-Gram solvers with an
s = 256 preconditioner. The phase's own limits apply unchanged.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P

SIZE = {"n": 1200, "test": 300, "s": 128, "max_split": 63,
        "faster_rows": 1024, "faster_s": 256}


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ml_phase_holds_on_the_cpu(chip_smoke, monkeypatch):
    seen = []
    monkeypatch.setattr(chip_smoke, "ml_launch_checks", seen.append)
    size = dict(chip_smoke.ML_FULL, **SIZE)
    out = chip_smoke.ml_phase(torch, P, np, size=size, device="cpu")
    assert seen == [out]
    assert all(c["ok"] for c in out["checks"].values()), out["checks"]
    # a CPU tensor takes every kernel's plain version: nothing launches
    assert set(out["launches_by_step"]) == {
        "rlsc_approximate", "rlsc_sketched_cwt", "rlsc_sketched_fjlt",
        "rlsc_fast", "rlsc_large_scale", "rlsc_kernel", "rlsc_faster",
        "rlsc_faster_s0", "admm_train", "admm_predict",
        "model_load_predict"}
    assert all(v == {} for v in out["launches_by_step"].values())
    assert out["bcd_blocks"] == [31, 31, 31, 35]
    assert 1 < out["bcd_sweeps"] < 1000
    assert (out["cg_iterations"]["rlsc_faster"]
            < out["cg_iterations"]["rlsc_faster_s0"])
    assert len(out["admm_objectives"]) == size["admm_iters"]
    assert min(out["accuracy"].values()) > 5 * 100.0 / size["classes"]


def _card_counts(sweeps=7, partitions=4, iters=10):
    cos = "dense_rowwise_cos"
    steps = {
        "rlsc_approximate": {cos: 1},
        "rlsc_sketched_cwt": {cos: 1, "hash_columnwise": 2},
        "rlsc_sketched_fjlt": {cos: 1},
        "rlsc_fast": {"fastfood": 1},
        "rlsc_large_scale": {cos: 4 * sweeps},
        "rlsc_kernel": {},
        "rlsc_faster": {cos: 1},
        "rlsc_faster_s0": {},
        "admm_train": {cos: partitions * (1 + iters)},
        "admm_predict": {cos: partitions},
        "model_load_predict": {cos: partitions},
    }
    launches = {}
    for st in steps.values():
        for k, v in st.items():
            launches[k] = launches.get(k, 0) + v
    return {"size": {"partitions": partitions, "admm_iters": iters},
            "bcd_sweeps": sweeps, "launches_by_step": steps,
            "launches": launches}


def test_ml_launch_check_takes_the_card_counts(chip_smoke):
    chip_smoke.ml_launch_checks(_card_counts())


@pytest.mark.parametrize("step,counts", [
    ("rlsc_approximate", {}),  # the map took its plain route
    ("rlsc_sketched_cwt", {"dense_rowwise_cos": 1, "hash_columnwise": 1}),
    ("rlsc_large_scale", {"dense_rowwise_cos": 27}),
    ("admm_train", {"dense_rowwise_cos": 40}),
    ("rlsc_fast", {"fastfood_split": 1}),
])
def test_ml_launch_check_refuses_other_counts(chip_smoke, step, counts):
    out = _card_counts()
    out["launches_by_step"][step] = counts
    with pytest.raises(RuntimeError, match="ml path launches"):
        chip_smoke.ml_launch_checks(out)


def test_ml_iterations_reads_the_solvers_logs(chip_smoke):
    import io

    from libskylark_tpu_torch import ml

    g = np.random.default_rng(9)
    X = g.standard_normal((96, 6)).astype(np.float32)
    y = g.integers(0, 3, 96)
    k = ml.Gaussian(6, 2.0)
    counts = []
    for solve, kw in ((ml.large_scale_kernel_rlsc, {"max_split": 31}),
                      (ml.faster_kernel_rlsc, {})):
        log = io.StringIO()
        params = ml.RlscParams(am_i_printing=True, log_level=3,
                               log_stream=log, **kw)
        solve(k, X, y, 1.0, 64, P.Context(9), params, device="cpu")
        counts.append(chip_smoke.ml_iterations(log.getvalue()))
    assert all(isinstance(c, int) and c > 0 for c in counts), counts
    assert chip_smoke.ml_iterations("admm: 10 iterations") is None


def test_check_cases_cover_every_ml_launch_shape(chip_smoke):
    """Every s at which the ml phase launches B1-cos on the training rows
    at full size, each other row count it launches at, and its B4 and
    B2-cw shapes are cases of the check phase."""
    from libskylark_tpu_torch.ml.admm import _partition
    from libskylark_tpu_torch.ml.krr import _split_sizes

    size = chip_smoke.ML_FULL
    n, m, d, s = (size[k] for k in ("n", "test", "d", "s"))
    blocks = _split_sizes(s, d, size["max_split"])
    parts = _partition(s, size["partitions"])
    assert blocks == [2047, 2047, 2047, 2051] and parts == [2048] * 4
    cos = {(n, d, w) for w in [s] + blocks + parts} | {
        (size["faster_rows"], d, size["faster_s"]), (m, d, parts[0])}
    assert cos <= {(*shape, w) for shape, w, *_ in chip_smoke.COS_CASES}
    assert {(n, d, s), (m, d, s)} <= set(chip_smoke.FASTFOOD_CASES)
    assert {("hash_columnwise", (n, s), 4 * s),
            ("hash_columnwise", (n, size["classes"]), 4 * s)} <= set(
                chip_smoke.HASH_CASES)
