"""chip_smoke.py's a3 phase rehearsed on the CPU at a small size: the same
entry points, data models and checks as on the card, with every kernel on
its plain version (a CPU tensor), so each step launches nothing; and the
launch check that the card run applies, on the counts it must show and
on counts it must refuse.

Small size: Matern features 256 × 64 → 4096 on 128 sampled rows; Gamma
at 20,000 samples a shape; ADMM on the ml rehearsal's 1200 × 784 rows
with s = 128; krank on a 1024² operand of rank 256 with the gap at rank
64;
randlobpcg on 4096 × 64; an R-MAT graph at scale 11; the block solvers on
512 rows. The phase's own limits apply unchanged.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P

ADMM = {"n": 1200, "test": 300, "s": 128, "max_split": 63,
        "faster_rows": 1024, "faster_s": 256}
SIZE = {"rft_rows": 256, "rft_d": 64, "rft_s": 4096, "gram_rows": 128,
        "gamma_n": 20000, "krank_n": 1024, "krank_r": 256, "rank": 64,
        "ls_rows": 4096, "ls_cols": 64, "evd_k": 4, "graph_scale": 11,
        "dense_sub": 256, "serve_sub": 512, "cluster_seeds": 2,
        "block_rows": 512}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the phase is hundreds of small host-side
    steps, which thread hand-offs slow many times over when the test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_a3_phase_holds_on_the_cpu(chip_smoke, monkeypatch):
    seen = []
    monkeypatch.setattr(chip_smoke, "a3_launch_checks", seen.append)
    size = dict(chip_smoke.A3_FULL, **SIZE)
    size["admm"] = dict(chip_smoke.ML_FULL, **ADMM)
    out = chip_smoke.a3_phase(torch, P, np, size=size, device="cpu")
    assert seen == [out]
    assert all(c["ok"] for c in out["checks"].values()), out["checks"]
    assert all(v == {} for v in out["launches_by_step"].values())
    assert out["recorded"]["graph"]["vertices"] > 1000
    assert 0 < out["recorded"]["fcg_iterations"] < size["fcg_iter_lim"]


def _card_counts(nus=(0.5, 1.5, 2.5), partitions=4, iters=10):
    steps = {}
    for nu in nus:
        steps[f"matern_rft_{nu}"] = {"dense_rowwise_cos": 1}
        steps[f"fast_matern_{nu}"] = {"fastfood": 1}
        steps[f"gamma_{nu}"] = {}
    steps.update({
        "admm_matern_train": {"dense_rowwise_cos": partitions * (1 + iters)},
        "admm_matern_predict": {"dense_rowwise_cos": partitions},
        "krank_generic": {}, "lobpcg_cwt": {"hash_columnwise": 1},
        "lobpcg_jlt": {"dense_columnwise": 1}, "lobpcg_fjlt": {},
        "power_evd": {"dense_rowwise": 1}, "graph_ase_sparse": {},
        "graph_ase_dense": {"dense_rowwise": 1}, "rand_block_fcg": {}})
    launches = {}
    for st in steps.values():
        for k, v in st.items():
            launches[k] = launches.get(k, 0) + v
    return {"size": {"nus": nus, "admm": {"partitions": partitions,
                                          "admm_iters": iters}},
            "launches_by_step": steps, "launches": launches}


def test_a3_launch_check_takes_the_card_counts(chip_smoke):
    chip_smoke.a3_launch_checks(_card_counts())


@pytest.mark.parametrize("step,counts", [
    ("matern_rft_0.5", {}),                      # the plain route
    ("fast_matern_1.5", {"fastfood_split": 1}),  # another variant
    ("lobpcg_cwt", {}),                          # the sketch took no kernel
    ("krank_generic", {"dense_rowwise": 1}),     # an unexpected launch
    ("admm_matern_train", {"dense_rowwise_cos": 40}),
])
def test_a3_launch_check_refuses_other_counts(chip_smoke, step, counts):
    out = _card_counts()
    out["launches_by_step"][step] = counts
    with pytest.raises(RuntimeError):
        chip_smoke.a3_launch_checks(out)


def test_check_cases_cover_every_a3_launch_shape(chip_smoke):
    """Every shape the a3 phase launches a kernel at is a case of the
    check phase: the Matern maps at config 3's shape (B1-cos, B4) and
    ADMM's at config 5's, the LOBPCG sketches (B2-cw, B1-cw), the power
    EVD's and the dense ASE's range sketches (B1-rw)."""
    size = chip_smoke.A3_FULL
    m, d, s = size["rft_rows"], size["rft_d"], size["rft_s"]
    cos = {(tuple(c[0]), c[1], c[2]) for c in chip_smoke.COS_CASES
           if len(c) > 2}
    for nu in size["nus"]:
        assert ((m, d), s, nu) in cos
        assert (m, d, s, nu) in chip_smoke.FASTFOOD_CASES
    a = size["admm"]
    part = a["s"] // a["partitions"]
    for rows in (a["n"], a["test"]):
        assert ((rows, a["d"]), part, size["admm_nu"]) in cos
    ls = (size["ls_rows"], size["ls_cols"])
    assert ("hash_columnwise", ls, 4 * size["ls_cols"]) in {
        (k, tuple(sh), w) for k, sh, w in chip_smoke.HASH_CASES}
    dense = {(k, tuple(sh), w) for k, _, sh, w in chip_smoke.check_cases()}
    assert ("dense_columnwise", ls, 4 * size["ls_cols"]) in dense
    assert ("dense_rowwise", ls, size["evd_k"]) in dense
    sub = size["dense_sub"]
    assert ("dense_rowwise", (sub, sub), 2 * size["ase_k"]) in dense
