"""chip_smoke.py's serve-solve phase rehearsed on the CPU at a small size:
the same requests, storm, references and checks as on the card, with
every kernel on its plain version (CPU tensors), so the measured storm
launches nothing and its sketch buckets flush on the plain programs; the
route check the card run applies, on the counts the card run must show
and on counts it must refuse.

Small size: least squares on 33–64 × 8 rows (s = 64), sparse least
squares on a 1,024 × 16 CSR at 5% (CWT s = 128, JLT s = 64), compressed
matmuls at n = 256 and a 600-column CSR, lowrank on a 64² rank-16
operand, KRR/RLSC on 256 training rows of the ml phase's data model,
condest on 65–128 × 16, and an R-MAT graph at scale 8. The phase's own
limits apply unchanged.
"""

import importlib.util
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


def _size(cs):
    return dict(
        cs.SOLVE_FULL, ls_rows=(33, 65), ls_cols=8, ls_s=64, ls_requests=4,
        sparse_requests=2, sparse_s={"CWT": 128, "JLT": 64},
        cmm_rows=(9, 17), cmm_n=256, cmm_p=8, cmm_s=32, cmm_requests=3,
        lowrank_rows=(33, 65), lowrank_s=8, lowrank_t=16, lowrank_k=4,
        lowrank_requests=3, krr_rows=(5, 9), krr_train=256, krr_requests=3,
        condest_rows=(65, 129), condest_cols=16, condest_steps=6,
        condest_requests=3, graph_scale=8, graph_requests=3, ase_k=4,
        sparse_ls=(1024, 16, 0.05), rcv1_d=600, svd_n=64, svd_rank=16,
        ml=dict(cs.ML_FULL, n=400, test=100))


def test_serve_solve_phase_holds_on_the_cpu(chip_smoke, monkeypatch):
    seen = []

    def cpu_routes(out, st):
        seen.append(out)
        assert set(st["kernel"]["by_backend"]) == {"plain"}
        for b, v in out["buckets"].items():
            want = ("library" if b in chip_smoke.LIBRARY_BUCKETS
                    else "plain")
            assert v["route"] == want, b
        # a CPU tensor takes every kernel's plain version
        assert not any(out["launches"].values())
        assert out["panels"] > 0

    monkeypatch.setattr(chip_smoke, "serve_solve_route_checks", cpu_routes)
    size = _size(chip_smoke)
    out = chip_smoke.serve_solve_phase(torch, P, np, size=size,
                                       device="cpu")
    assert seen == [out]
    assert set(out["buckets"]) == set(chip_smoke.SOLVE_ROUTES) | set(
        chip_smoke.LIBRARY_BUCKETS)
    st = out["stats"]
    assert st["failed"] == 0 and st["completed"] == st["submitted"]
    assert st["models"]["uploads"] == 2
    assert max(v["max"] for v in out["residual_ratio"].values()) <= 1.5
    assert len(out["condest"]) == size["condest_requests"]
    assert all(c["ok"] for c in out["sketch_checks"])
    assert {c["bucket"] for c in out["sketch_checks"]} == set(
        chip_smoke.SOLVE_ROUTES)


def _card_out(flushes, launches=None, panels=0, route="cuda"):
    out = {"buckets": {b: {"flushes": f,
                           "route": "library" if b in LIB else route}
                       for b, f in flushes.items()},
           "launches": launches, "panels": panels}
    return out


LIB = ("krr-predict", "rlsc-predict", "condest", "graph-ase", "graph-ppr")
FLUSHES = {"solve-jlt": 2, "solve-cwt": 3, "sparse-solve-cwt": 1,
           "sparse-solve-jlt": 1, "cmm-srht": 1, "cmm-cwt-sparse": 2,
           "lowrank": 1, **{b: 2 for b in LIB}}


def _card_launches(cs):
    counts = {k: 0 for k in ("dense_batched_columnwise",
                             "dense_batched_rowwise", "hash_batched",
                             "fwht_batched", "sparse_columnwise",
                             "sparse_rowwise", "hash_columnwise",
                             "dense_columnwise", "fwht_rowwise")}
    counts.update(dense_batched_columnwise=2 * (2 + 1),
                  dense_batched_rowwise=2, hash_batched=2 * 3 + 1 + 2,
                  fwht_batched=2, sparse_columnwise=1, sparse_rowwise=2)
    return counts


@pytest.mark.parametrize("fault", [None, "lane_by_lane", "two_d_entry",
                                   "panel", "declined", "library_route"])
def test_route_check_takes_the_card_counts_and_refuses_others(chip_smoke,
                                                              fault):
    launches = _card_launches(chip_smoke)
    st = {"kernel": {"by_backend": {"cuda": {"flushes": 11}},
                     "by_reason": {}}}
    out = _card_out(FLUSHES, launches)
    if fault == "lane_by_lane":
        launches["hash_batched"] += 3
    elif fault == "two_d_entry":
        launches["hash_columnwise"] = 1
    elif fault == "panel":
        out["panels"] = 2
    elif fault == "declined":
        st["kernel"]["by_reason"] = {"dtype float64 != float32":
                                     {"declined_flushes": 1}}
    elif fault == "library_route":
        out["buckets"]["condest"]["route"] = "cuda"
    if fault is None:
        chip_smoke.serve_solve_route_checks(out, st)
        assert out["launches_expected"] == launches
    else:
        with pytest.raises(RuntimeError, match="chip_smoke"):
            chip_smoke.serve_solve_route_checks(out, st)
