"""The port's command-line drivers against the JAX package's, on the CPU.

Each driver runs through ``main(argv)`` in both packages on the same files
(the shapes of ``tests/test_cli.py``'s fixtures) with the same seed; the
port with ``--device cpu``. The outputs are held within the limits the
port's tests already hold for the library call each driver wraps:

- ``skylark_svd``: singular values relative ≤ 1e-4, singular vectors
  |cos θ| ≥ 1 − 1e-4 (``test_torch_nla.py``);
- ``skylark_linear``: the solution relative ≤ 1e-4 (``test_torch_nla.py``);
- ``skylark_ml``: ``coef`` within 1e-4·max|ref| and a model file read
  by the other package giving the same labels and decision values within
  1e-4·max|ref|: the reference's oracle, which ``test_torch_ml_model.py``
  holds in the default bf16x3 regime (ROADMAP C9). (At this driver's
  σ = 1 and 8 iterations the bf16x3 features move ``coef`` entries by up
  to 5e-5 of max|coef|, past ``test_torch_ml_admm.py``'s elementwise
  rtol 1e-4, atol 1e-5 at σ = 3 and 5 iterations);
- ``skylark_graph_se``: the embedding within 1e-4·max|ref| up to column
  signs, the vertex order identical (``test_torch_graph.py``);
- ``skylark_community``: the same printed cluster
  (``find_local_cluster`` is equal in ``test_torch_graph.py``);
- ``skylark_convert2hdf5``: files that read back equal in both packages.

``write_ascii_matrix`` writes the reference's bytes, ``--streaming`` gives
the whole-file read's outputs byte for byte, and a bad command line exits
2 in both packages.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import libskylark_tpu.io as rio
from libskylark_tpu import cli as rcli
from libskylark_tpu.cli import (skylark_community as r_community,
                                skylark_convert2hdf5 as r_convert,
                                skylark_graph_se as r_graph_se,
                                skylark_linear as r_linear,
                                skylark_ml as r_ml, skylark_svd as r_svd)
from libskylark_tpu.ml.model import HilbertModel as RModel
from libskylark_tpu_torch import cli as pcli
from libskylark_tpu_torch import io as pio
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.cli import (skylark_community as p_community,
                                      skylark_convert2hdf5 as p_convert,
                                      skylark_graph_se as p_graph_se,
                                      skylark_linear as p_linear,
                                      skylark_ml as p_ml, skylark_svd as p_svd)
from libskylark_tpu_torch.ml.model import HilbertModel as PModel

SIGMA_REL = 1e-4     # test_torch_nla.py
COS_TOL = 1e-4       # test_torch_nla.py
SOLVE_REL = 1e-4     # test_torch_nla.py
COEF_REL = 1e-4      # the reference's oracle in bf16x3 (C9)
DV_REL = 1e-4        # test_torch_ml_model.py, bf16x3 (C9)
EMBED_REL = 1e-4     # test_torch_graph.py
CPU = ["--device", "cpu"]
ML_ARGS = ["-l", "2", "-r", "1", "-k", "1", "-g", "1.0", "-c", "0.01",
           "-f", "64", "-i", "8"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _cos_ok(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = np.abs(np.sum(got * want, axis=0)) / (
        np.linalg.norm(got, axis=0) * np.linalg.norm(want, axis=0))
    assert cos.min() >= 1 - COS_TOL, cos


def _aligned_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    return np.abs(got * s - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The fixtures' files (``tests/test_cli.py``: a 200 × 10 regression,
    a 120 × 6 two-class problem, two 5-cliques joined by an edge) and the
    reference drivers' outputs on them, made once."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 10)).astype(np.float32)
    w = rng.standard_normal(10).astype(np.float32)
    y = X @ w + 0.01 * rng.standard_normal(200).astype(np.float32)
    rio.write_libsvm(d / "reg.libsvm", X, y)
    rng = np.random.default_rng(1)
    Xc = rng.standard_normal((120, 6)).astype(np.float32)
    yc = (Xc[:, 0] + 0.3 * Xc[:, 1] > 0).astype(np.float32)
    rio.write_libsvm(d / "cls.libsvm", Xc, yc)
    lines = []
    for off in (0, 5):
        for i in range(5):
            for j in range(i + 1, 5):
                lines.append(f"{off + i} {off + j}")
    lines.append("0 5")
    (d / "graph.txt").write_text("\n".join(lines) + "\n")
    p = {k: str(d / k) for k in ("reg.libsvm", "cls.libsvm", "graph.txt")}
    p["dir"] = str(d)
    assert r_svd.main([p["reg.libsvm"], "-k", "4", "--prefix",
                       str(d / "r_svd")]) == 0
    for tag, flags in (("r_lin", []), ("r_linp", ["-p"])):
        assert r_linear.main([p["reg.libsvm"], "--prefix", str(d / tag)]
                             + flags) == 0
    assert r_ml.main([p["cls.libsvm"], str(d / "r_model.json")]
                     + ML_ARGS) == 0
    assert r_graph_se.main([p["graph.txt"], "-k", "2", "-n", "--prefix",
                            str(d / "r_se")]) == 0
    return p


def _path(work, name):
    return os.path.join(work["dir"], name)


def test_write_ascii_matrix_writes_the_reference_bytes(tmp_path):
    rng = np.random.default_rng(3)
    for i, M in enumerate((rng.standard_normal((7, 5)).astype(np.float32),
                           rng.standard_normal(9).astype(np.float32),
                           rng.standard_normal((4, 3)))):
        a, b = tmp_path / f"r{i}.txt", tmp_path / f"p{i}.txt"
        rcli.write_ascii_matrix(str(a), M)
        pcli.write_ascii_matrix(str(b), torch.from_numpy(M))
        assert a.read_bytes() == b.read_bytes()
        pcli.write_ascii_matrix(str(b), M, digits=4)
        rcli.write_ascii_matrix(str(a), M, digits=4)
        assert a.read_bytes() == b.read_bytes()


def test_svd_driver_matches_the_reference(work):
    prefix = _path(work, "p_svd")
    assert p_svd.main([work["reg.libsvm"], "-k", "4", "--prefix", prefix]
                      + CPU) == 0
    ref = _path(work, "r_svd")
    S, jS = np.loadtxt(prefix + ".S.txt"), np.loadtxt(ref + ".S.txt")
    assert np.max(np.abs(S - jS) / jS) <= SIGMA_REL
    for suffix in (".U.txt", ".V.txt"):
        _cos_ok(np.loadtxt(prefix + suffix), np.loadtxt(ref + suffix))


def test_svd_profile_mode_matches_the_reference(tmp_path):
    """``--profile`` makes the reference's matrix from its seed."""
    a, b = str(tmp_path / "r"), str(tmp_path / "p")
    args = ["--profile", "64", "32", "-k", "3", "-s", "7"]
    assert r_svd.main(args + ["--prefix", a]) == 0
    assert p_svd.main(args + ["--prefix", b] + CPU) == 0
    S, jS = np.loadtxt(b + ".S.txt"), np.loadtxt(a + ".S.txt")
    assert S.shape == (3,) and np.max(np.abs(S - jS) / jS) <= SIGMA_REL
    _cos_ok(np.loadtxt(b + ".V.txt"), np.loadtxt(a + ".V.txt"))


@pytest.mark.parametrize("driver", ["svd", "linear"])
def test_streaming_equals_the_whole_file_read(work, tmp_path, driver):
    """``--streaming`` reads through a one-rank mesh on the run's device
    (a process group made for the read and released after it) and gives
    the whole-file read's outputs byte for byte."""
    import torch.distributed as dist

    a, b = str(tmp_path / "whole"), str(tmp_path / "stream")
    if driver == "svd":
        main, args, outs = (p_svd.main, [work["reg.libsvm"], "-k", "4"],
                            (".U.txt", ".S.txt", ".V.txt"))
    else:
        main, args, outs = (p_linear.main, [work["reg.libsvm"], "-p"],
                            (".x.txt",))
    assert main(args + ["--prefix", a] + CPU) == 0
    assert main(args + ["--prefix", b, "--streaming", "--batch-rows", "7"]
                + CPU) == 0
    assert not dist.is_initialized()
    for suffix in outs:
        with open(a + suffix, "rb") as f1, open(b + suffix, "rb") as f2:
            assert f1.read() == f2.read()


@pytest.mark.parametrize("tag,flags", [("lin", []), ("linp", ["-p"])])
def test_linear_driver_matches_the_reference(work, tag, flags):
    prefix = _path(work, "p_" + tag)
    assert p_linear.main([work["reg.libsvm"], "--prefix", prefix] + flags
                         + CPU) == 0
    x = np.loadtxt(prefix + ".x.txt")
    want = np.loadtxt(_path(work, "r_" + tag) + ".x.txt")
    assert np.linalg.norm(x - want) / np.linalg.norm(want) <= SOLVE_REL


@pytest.fixture(scope="module")
def port_model(work):
    path = _path(work, "p_model.json")
    assert p_ml.main([work["cls.libsvm"], path] + ML_ARGS + CPU) == 0
    return path


def test_ml_driver_trains_the_reference_model(work, port_model):
    got = PModel.load(port_model, device="cpu")
    want = RModel.load(_path(work, "r_model.json"))
    assert got.label_coding == want.label_coding == [0.0, 1.0]
    assert _rel(got.coef.numpy(), np.asarray(want.coef)) <= COEF_REL
    assert [m.to_dict() for m in got.maps] == [m.to_dict()
                                               for m in want.maps]


def test_ml_model_files_cross_packages(work, port_model, capsys):
    """A port model file predicts in the reference driver and the other
    way round: the same labels, decision values within C9's 1e-4."""
    out = {}
    for who, main, model in (("r_of_p", r_ml.main, port_model),
                             ("p_of_r", p_ml.main,
                              _path(work, "r_model.json")),
                             ("r_of_r", r_ml.main,
                              _path(work, "r_model.json")),
                             ("p_of_p", p_ml.main, port_model)):
        for what, flags in (("dv", ["--decisionvals"]), ("lab", [])):
            stem = _path(work, f"{who}_{what}")
            extra = CPU if main is p_ml.main else []
            assert main(["--testfile", work["cls.libsvm"], "--modelfile",
                         model, "--outputfile", stem] + flags + extra) == 0
            out[who, what] = np.loadtxt(stem + ".txt")
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Accuracy")]
    assert len(printed) == 8
    # the reference reading the port's file, and the port its own
    assert _rel(out["r_of_p", "dv"], out["p_of_p", "dv"]) <= DV_REL
    assert np.array_equal(out["r_of_p", "lab"], out["p_of_p", "lab"])
    # the port reading the reference's file, and the reference its own
    assert _rel(out["p_of_r", "dv"], out["r_of_r", "dv"]) <= DV_REL
    assert np.array_equal(out["p_of_r", "lab"], out["r_of_r", "lab"])


def test_ml_label_coding_decodes_noncontiguous_labels(tmp_path):
    """Labels {3, 7, 9}: the model stores the coding, and a test file
    with a subset of the labels scores against the raw values."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((90, 4)).astype(np.float32)
    raw = np.where(X[:, 0] > 0.5, 9, np.where(X[:, 0] > -0.5, 7, 3))
    p = tmp_path / "odd.libsvm"
    pio.write_libsvm(p, X, raw.astype(np.float32))
    model = str(tmp_path / "odd.json")
    assert p_ml.main([str(p), model, "-c", "0.001", "-i", "30"] + CPU) == 0
    assert PModel.load(model, device="cpu").label_coding == [3, 7, 9]
    assert RModel.load(model).label_coding == [3, 7, 9]
    mask = raw != 3
    p2 = tmp_path / "subset.libsvm"
    pio.write_libsvm(p2, X[mask], raw[mask].astype(np.float32))
    out = str(tmp_path / "pred")
    assert p_ml.main(["--testfile", str(p2), "--modelfile", model,
                      "--outputfile", out] + CPU) == 0
    assert set(np.unique(np.loadtxt(out + ".txt"))) <= {3.0, 7.0, 9.0}


def test_graph_se_driver_matches_the_reference(work):
    prefix = _path(work, "p_se")
    assert p_graph_se.main([work["graph.txt"], "-k", "2", "-n", "--prefix",
                            prefix] + CPU) == 0
    ref = _path(work, "r_se")
    V = np.loadtxt(prefix + ".V.txt")
    assert V.shape == (10, 2)
    assert _aligned_err(V, np.loadtxt(ref + ".V.txt")) <= EMBED_REL
    with open(prefix + ".index.txt") as f1, open(ref + ".index.txt") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("flags", [["0", "-n", "-q"],
                                   ["0", "3", "-n", "-q", "-c"],
                                   ["7", "-n", "-q", "-r"]])
def test_community_driver_prints_the_reference_cluster(work, capsys, flags):
    assert r_community.main([work["graph.txt"]] + flags) == 0
    want = capsys.readouterr().out
    assert p_community.main([work["graph.txt"]] + flags + CPU) == 0
    assert capsys.readouterr().out == want
    assert want.strip()


@pytest.mark.parametrize("mode", ["0", "1"])
def test_convert2hdf5_writes_what_both_packages_read(work, tmp_path, mode):
    pytest.importorskip("h5py")
    a, b = str(tmp_path / "r.h5"), str(tmp_path / "p.h5")
    src = work["reg.libsvm"] if mode == "0" else work["cls.libsvm"]
    assert r_convert.main([src, a, "--mode", mode]) == 0
    assert p_convert.main([src, b, "--mode", mode] + CPU) == 0
    sparse = mode == "1"
    read = []
    for path in (a, b):
        X1, Y1 = rio.read_hdf5(path, sparse=sparse)
        X2, Y2 = pio.read_hdf5(path, sparse=sparse)
        if sparse:
            X1, X2 = np.asarray(X1.todense()), X2.to_scipy().toarray()
        np.testing.assert_array_equal(X2, np.asarray(X1))
        np.testing.assert_array_equal(np.asarray(Y2), np.asarray(Y1))
        read.append((X2, np.asarray(Y2)))
    # the two packages' files hold the same dataset
    np.testing.assert_array_equal(read[0][0], read[1][0])
    np.testing.assert_array_equal(read[0][1], read[1][1])


BAD = {
    "svd_no_input": ("svd", ["-k", "2"]),
    "svd_streaming_sparse": ("svd", ["{reg}", "--streaming", "--sparse"]),
    "svd_streaming_profile": ("svd", ["--streaming", "--profile", "8",
                                      "4"]),
    "svd_bad_filetype": ("svd", ["{reg}", "--filetype", "CSV"]),
    "linear_streaming_directory": ("linear", ["{reg}", "--streaming",
                                              "-d"]),
    "linear_no_input": ("linear", []),
    "ml_no_modelfile": ("ml", ["{cls}"]),
    "ml_streaming_hdf5": ("ml", ["{cls}", "m.json", "--streaming",
                                 "--fileformat", "2"]),
    "ml_no_trainfile": ("ml", ["-c", "0.1"]),
    "community_no_seeds": ("community", ["{graph}", "-n"]),
    "community_missing_seed": ("community", ["{graph}", "99", "-n"]),
    "convert_bad_mode": ("convert", ["{reg}", "x.h5", "--mode", "2"]),
}
DRIVERS = {"svd": (r_svd, p_svd), "linear": (r_linear, p_linear),
           "ml": (r_ml, p_ml), "community": (r_community, p_community),
           "convert": (r_convert, p_convert)}


def _exit_code(main, argv):
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_command_lines_exit_2_as_in_the_reference(work, case, capsys):
    driver, argv = BAD[case]
    argv = [a.format(reg=work["reg.libsvm"], cls=work["cls.libsvm"],
                     graph=work["graph.txt"]) for a in argv]
    ref, port = DRIVERS[driver]
    assert _exit_code(ref.main, argv) == 2
    assert _exit_code(port.main, argv + CPU) == 2


def test_a_driver_runs_on_the_card_unless_told_otherwise(monkeypatch,
                                                         tmp_path):
    """No ``--device``: the package default, cuda. Without a card that
    raises; no platform variable moves the run (``honor_platform_env``
    does nothing)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert pcli.honor_platform_env() is None
    argv = ["--profile", "8", "4", "-k", "2", "--prefix",
            str(tmp_path / "o")]
    if torch.cuda.is_available():
        assert p_svd.main(argv) == 0
    else:
        with pytest.raises(errors.UnsupportedError):
            p_svd.main(argv)
        assert not (tmp_path / "o.S.txt").exists()
