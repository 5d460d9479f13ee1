"""The serve layer's solve-family endpoints on the CPU: the port's
``MicrobatchExecutor(device="cpu")`` against the JAX package's
single-request programs on the same seeds — ``sketched_solve_serve``,
``sparse_solve_serve``, ``krr_predict``, ``rlsc_predict``,
``condest_serve``, ``lowrank_serve``, ``graph_ase_serve`` and
``graph_ppr_serve`` — and, for ``compressed_matmul``, the reference
executor's own ``submit_compressed_matmul`` (an XLA flush).

Tolerances:

- solves, compressed matmul, KRR, PPR and condest: max |Δ| ≤ 1e-4 ·
  max|ref| (the reference's oracle; JLT's Normal draws differ by ROADMAP
  C2, the QR and the products round in another order); the bound of a
  compressed matmul within 1e-6 relative;
- the CWT sketches of a flush bit-equal to the reference's, the SRHT's on
  dyadic data too;
- lowrank and ASE free of column signs: the projectors Z·Zᵀ within 1e-4,
  the ASE's columns aligned by sign within 1e-4 · max|ref|;
- RLSC labels equal wherever the reference's top two scores differ by
  more than 1e-5;
- ``_seed_key_data`` bit-equal to ``jax.random.key(seed)``'s data.

Also: every lane of a capacity-8 flush ``torch.equal`` to its capacity-1
flush at cohorts of 1, 3 and 8; the kernel route's program (the batched
wrappers, one call per operand, then the lanes' library half), run on CPU
tensors where each wrapper takes its plain version, ``torch.equal`` to
the plain route; the bucket statics equal the reference's (KRR/RLSC's but
for the kernel's identity, a digest there and JSON here); the densify
rule of ``submit_sparse_solve``; one model upload per KRR bucket; the
errors of bad shapes and families those of the reference.
"""

import hashlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from libskylark_tpu import engine as jengine
from libskylark_tpu import ml as jml
from libskylark_tpu import sketch as jsk
from libskylark_tpu.algorithms import regression as jreg
from libskylark_tpu.base.context import Context as JContext
from libskylark_tpu.engine import serve as jserve
from libskylark_tpu.ml import graph as jgraph
from libskylark_tpu.ml import rlsc as jrlsc
from libskylark_tpu.nla import condest as jcondest
from libskylark_tpu.nla import lowrank as jlowrank
from libskylark_tpu.sketch import sparse_serve as jss
from libskylark_tpu_torch import engine, ml
from libskylark_tpu_torch import sketch as sk
from libskylark_tpu_torch.algorithms import regression
from libskylark_tpu_torch.base import env, randgen
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.engine import bucket, serve
from libskylark_tpu_torch.nla import lowrank
from libskylark_tpu_torch.sketch import (cuda_dense, cuda_fwht, cuda_hash,
                                         cuda_sparse)

ORACLE = 1e-4
PROJECTOR = 1e-4
MARGIN = 1e-5
BOUND_REL = 1e-6

# the JAX package and the port build a transform from the same (module,
# Context) pair
MODS = {"ref": (jsk, JContext), "port": (sk, Context)}


def _cpu(**kw):
    return engine.MicrobatchExecutor(device="cpu", **kw)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=ORACLE):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _padded_rows(X, rows):
    out = np.zeros((rows,) + X.shape[1:], X.dtype)
    out[:X.shape[0]] = X
    return out


def _csr(rows, cols, density, seed):
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=seed, dtype=np.float32)


def _graph_edges(n, p, seed):
    rng = np.random.default_rng(seed)
    half = n // 2
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < (p if (i < half) == (j < half) else p / 8)]


# ---------------------------------------------------------------------------
# the requests of each endpoint: (submit on a port executor, reference)
# ---------------------------------------------------------------------------


def _solve_requests(family, count, uniform):
    rng = np.random.default_rng(10 + len(family))
    out = []
    for i in range(count):
        n = int(rng.integers(40, 64))
        A = rng.standard_normal((n, 5)).astype(np.float32)
        B = (A @ rng.standard_normal(5) + 0.1 * rng.standard_normal(n)
             ).astype(np.float32)
        if i % 2 and not uniform:
            B = np.stack([B, rng.standard_normal(n).astype(np.float32)], 1)
        make = (lambda M, C, n=n, i=i: M.JLT(n, 24, C(100 + i % 3))
                if family == "JLT" else M.CWT(n, 24, C(100 + i % 3)))
        out.append((make, A, B))
    return out


def _solve_cases(family, count, uniform):
    cases = []
    for make, A, B in _solve_requests(family, count, uniform):
        T = make(sk, Context)

        def ref(T=T, A=A, B=B):
            rows = bucket.pow2_pad(A.shape[0])
            Bm = B[:, None] if B.ndim == 1 else B
            x = np.asarray(jreg.sketched_solve_serve(
                jnp.asarray(T.allocation.key),
                jnp.float32(getattr(T, "scale", 1.0)),
                jnp.asarray(_padded_rows(A, rows)),
                jnp.asarray(_padded_rows(Bm, rows)), sketch_type=family,
                s_dim=24))
            return x[:, 0] if B.ndim == 1 else x

        cases.append((lambda ex, T=T, A=A, B=B: ex.submit_solve(A, B, T),
                      ref))
    return cases


def _sparse_solve_cases(family, count, uniform):
    rng = np.random.default_rng(20)
    cases = []
    for i in range(count):
        n = int(rng.integers(150, 256))
        A = _csr(n, 6, 0.15, 30 + i)
        B = rng.standard_normal(n).astype(np.float32)
        T = (sk.JLT(n, 32, Context(200 + i)) if family == "JLT"
             else sk.CWT(n, 32, Context(200 + i)))

        def ref(T=T, A=A, B=B):
            from libskylark_tpu_torch.base.sparse import as_sparse

            S = as_sparse(A)
            rows = bucket.pow2_pad(n_rows := A.shape[0])
            lanes = serve.MicrobatchExecutor._pack_csr(
                S, rows, bucket.nnz_class(S.nnz), np.dtype(np.float32))
            x = np.asarray(jss.sparse_solve_serve(
                jnp.asarray(T.allocation.key),
                jnp.float32(getattr(T, "scale", 1.0)),
                *(jnp.asarray(v) for v in lanes),
                jnp.asarray(_padded_rows(B[:, None], rows)),
                sketch_type=family, s_dim=32, method="qr",
                shape=(rows, A.shape[1])))
            assert n_rows == A.shape[0]
            return x[:, 0]

        cases.append((lambda ex, T=T, A=A, B=B: ex.submit_sparse_solve(
            A, B, T), ref))
    return cases


def _krr_model():
    rng = np.random.default_rng(40)
    X = rng.standard_normal((48, 6)).astype(np.float32)
    coef = rng.standard_normal((48, 3)).astype(np.float32)
    return X, coef


_KRR_MODEL = _krr_model()


def _krr_cases(endpoint, count, uniform):
    rng = np.random.default_rng(41)
    X, coef = _KRR_MODEL
    gk, jk = ml.kernels.Gaussian(6, 1.5), jml.Gaussian(6, 1.5)
    cases = []
    for i in range(count):
        q = rng.standard_normal((int(rng.integers(2, 9)), 6)).astype(
            np.float32)
        if endpoint == "krr_predict":
            cases.append((
                lambda ex, q=q: ex.submit_krr_predict(gk, q, X, coef),
                lambda q=q: np.asarray(jml.krr_predict(jk, jnp.asarray(q),
                                                       X, coef))))
        else:
            cases.append((
                lambda ex, q=q: ex.submit_rlsc_predict(gk, q, X, coef),
                lambda q=q: (np.asarray(jrlsc.rlsc_predict(jk, q, X, coef)),
                             np.asarray(jml.krr_predict(
                                 jk, jnp.asarray(q), X, coef)))))
    return cases


def _condest_cases(count, uniform):
    rng = np.random.default_rng(50)
    cases = []
    for i in range(count):
        rows = int(rng.integers(17, 33) if uniform else rng.integers(24, 40))
        A = rng.standard_normal((rows, 10)).astype(np.float32)
        cases.append((
            lambda ex, A=A, i=i: ex.submit_condest(A, steps=6, seed=i % 2),
            lambda A=A, i=i: np.asarray(jcondest.condest_serve(
                A, steps=6, seed=i % 2), np.float32)))
    return cases


def _lowrank_cases(count, uniform):
    rng = np.random.default_rng(60)
    U0 = rng.standard_normal((64, 3)).astype(np.float32)
    V0 = rng.standard_normal((3, 20)).astype(np.float32)
    cases = []
    for i in range(count):
        m = int(rng.integers(33, 65) if uniform else rng.integers(17, 64))
        A = (U0[:m] @ V0 + 0.01 * rng.standard_normal((m, 20))).astype(
            np.float32)
        pair = {}
        for side, (M, C) in MODS.items():
            kern = (jml.Linear(20) if side == "ref"
                    else ml.kernels.Linear(20))
            ctx = C(70 + i % 2)
            pair[side] = (kern.create_rft(8, ctx), kern.create_rft(12, ctx))
        cases.append((
            lambda ex, A=A, p=pair["port"]: ex.submit_lowrank(*p, A, 3),
            lambda A=A, p=pair["ref"]: np.asarray(jlowrank.lowrank_serve(
                *p, A, 3))))
    return cases


def _graph_cases(endpoint, count, uniform):
    cases = []
    for i in range(count):
        # one graph for every request of a uniform cohort
        edges = (_graph_edges(40, 0.4, 80) if uniform
                 else _graph_edges(24 + 4 * i, 0.4, 80 + i))
        jG, G = jml.Graph(edges), ml.Graph(edges)
        n = G.num_vertices()
        if endpoint == "graph_ase":
            cases.append((
                lambda ex, G=G, i=i: ex.submit_graph_ase(G, 2, seed=i,
                                                         iters=3),
                lambda jG=jG, i=i: np.asarray(jgraph.graph_ase_serve(
                    jG, 2, seed=i, iters=3)[0])))
        else:
            s = np.zeros(n, np.float32)
            s[[i % n, (3 * i + 1) % n]] = 1.0
            cases.append((
                lambda ex, G=G, s=s: ex.submit_graph_ppr(G, s, alpha=0.8,
                                                         iters=12),
                lambda jG=jG, s=s: np.asarray(jgraph.graph_ppr_serve(
                    jG, s, alpha=0.8, iters=12)[0])))
    return cases


def _cmm_operands(kind, count, uniform):
    rng = np.random.default_rng(90)
    out = []
    for i in range(count):
        lo = (13 if kind.endswith("sparse") else 9) if uniform else 5
        m, p = int(rng.integers(lo, 17)), int(rng.integers(3, 9))
        n = 256 if kind.startswith("srht") else 200
        if kind.endswith("sparse"):
            A = _csr(m, n, 0.1, 95 + i)
        elif kind == "srht-dyadic":
            A = rng.integers(-8, 9, (m, n)).astype(np.float32)
        else:
            A = rng.standard_normal((m, n)).astype(np.float32)
        B = (rng.integers(-8, 9, (n, p)) if kind == "srht-dyadic"
             else rng.standard_normal((n, p))).astype(np.float32)
        out.append((A, B, i % 2))
    return out


def _cmm_cases(kind, count, uniform):
    cases = []
    for A, B, seed in _cmm_operands(kind, count, uniform):
        def ref(A=A, B=B, seed=seed):
            with jengine.MicrobatchExecutor(max_batch=1,
                                            kernel="xla") as jex:
                est, bound = jex.submit_compressed_matmul(
                    A, B, s_dim=16, seed=seed).result(timeout=120)
            return np.asarray(est), bound

        cases.append((lambda ex, A=A, B=B, seed=seed:
                      ex.submit_compressed_matmul(A, B, s_dim=16,
                                                  seed=seed), ref))
    return cases


def _cases(name, count, uniform=False):
    """``count`` requests of ``name``: ragged, or with ``uniform`` all in
    one bucket."""
    if name.startswith("solve-"):
        return _solve_cases(name[6:].upper(), count, uniform)
    if name.startswith("sparse-solve-"):
        return _sparse_solve_cases(name[13:].upper(), count, uniform)
    if name in ("krr_predict", "rlsc_predict"):
        return _krr_cases(name, count, uniform)
    if name == "condest":
        return _condest_cases(count, uniform)
    if name == "lowrank":
        return _lowrank_cases(count, uniform)
    if name in ("graph_ase", "graph_ppr"):
        return _graph_cases(name, count, uniform)
    return _cmm_cases(name[4:], count, uniform)


ENDPOINT_CASES = ["solve-jlt", "solve-cwt", "sparse-solve-cwt",
                  "sparse-solve-jlt", "krr_predict", "rlsc_predict",
                  "condest", "lowrank", "graph_ase", "graph_ppr",
                  "cmm-srht", "cmm-cwt", "cmm-cwt-sparse", "cmm-srht-sparse"]


def _storm(ex, submits, threads=3):
    futs = [None] * len(submits)

    def worker(t):
        for i in range(t, len(submits), threads):
            futs[i] = submits[i](ex)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return [f.result(timeout=120) for f in futs]


def _projector(Z):
    Z = np.asarray(Z, np.float64)
    return Z @ Z.T


def _sign_aligned(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    idx = np.argmax(np.abs(want), axis=0)
    cols = np.arange(want.shape[1])
    return got * (np.sign(got[idx, cols]) * np.sign(want[idx, cols]))


@pytest.mark.parametrize("name", ENDPOINT_CASES)
def test_executor_matches_the_reference(name):
    cases = _cases(name, 5)
    with _cpu(max_batch=4, linger_us=50_000) as ex:
        got = _storm(ex, [c[0] for c in cases])
        ex.flush()
        st = ex.stats()
    assert st["completed"] == st["submitted"] == 5 and st["failed"] == 0
    for g, (_, ref) in zip(got, cases):
        want = ref()
        if name == "lowrank":
            assert g.shape == want.shape
            assert np.abs(_projector(_np(g)) - _projector(want)).max() \
                <= PROJECTOR
        elif name == "graph_ase":
            _close(_sign_aligned(_np(g), want), want)
        elif name == "rlsc_predict":
            labels, scores = want
            g = _np(g)
            assert g.dtype == np.int32 and g.shape == labels.shape
            top = np.sort(scores, axis=1)
            sure = top[:, -1] - top[:, -2] > MARGIN
            assert np.array_equal(g[sure], labels[sure])
        elif name.startswith("cmm-"):
            est, bound = g
            assert isinstance(bound, float)
            assert abs(bound - want[1]) <= BOUND_REL * abs(want[1])
            _close(_np(est), want[0])
        elif name == "condest":
            g = _np(g)
            assert g.shape == (3,)
            assert np.all(np.abs(g - want) <= ORACLE * np.abs(want))
        else:
            _close(_np(g), want)
    routes = {b["route"] for b in st["by_bucket"].values()}
    library = name in serve._LIBRARY_ENDPOINTS
    assert routes == ({"library"} if library else {"plain"})
    assert st["library"]["flushes"] == (st["flushes"] if library else 0)
    assert "library" not in st["kernel"]["by_backend"]


@pytest.mark.parametrize("cohort", [1, 3, 8])
@pytest.mark.parametrize("name", ENDPOINT_CASES)
def test_every_lane_equals_its_capacity_one_flush(name, cohort):
    submits = [c[0] for c in _cases(name, cohort, uniform=True)]
    with _cpu(max_batch=8, linger_us=60_000_000) as ex8, \
            _cpu(max_batch=1) as ex1:
        futs = [s(ex8) for s in submits]
        ex8.flush()
        got = [f.result(timeout=120) for f in futs]
        alone = [s(ex1).result(timeout=120) for s in submits]
        st = ex8.stats()
    assert st["flushes"] == 1 and st["completed"] == cohort
    for g, a in zip(got, alone):
        if name.startswith("cmm-"):
            assert torch.equal(g[0], a[0]) and g[1] == a[1]
        elif isinstance(g, torch.Tensor):
            assert torch.equal(g, a)
        else:
            assert np.array_equal(g, a)


# ---------------------------------------------------------------------------
# the kernel route's program on CPU tensors
# ---------------------------------------------------------------------------


KERNEL_ROUTES = {
    "solve-jlt": {"serve_batched_apply": 2},
    "solve-cwt": {"cwt_apply_batched": 2},
    "sparse-solve-cwt": {"cwt_sparse_apply_batched": 1,
                         "cwt_apply_batched": 1},
    "sparse-solve-jlt": {"serve_batched_apply": 2},
    "cmm-srht": {"srht_apply_batched": 2},
    "cmm-cwt": {"cwt_apply_batched": 2},
    "cmm-cwt-sparse": {"cwt_sparse_apply_batched": 1,
                       "cwt_apply_batched": 1},
    "cmm-srht-sparse": {"srht_apply_batched": 2},
    "lowrank": {"serve_batched_apply": 2},
}
_WRAPPERS = {"serve_batched_apply": cuda_dense,
             "cwt_apply_batched": cuda_hash,
             "srht_apply_batched": cuda_fwht,
             "cwt_sparse_apply_batched": cuda_sparse}
# the one-request entry points a batched flush must not call
_SINGLE = {"rowwise_apply": cuda_dense, "columnwise_apply": cuda_dense,
           "cwt_apply": cuda_hash, "srht_apply": cuda_fwht,
           "cwt_sparse_apply": cuda_sparse}


def _flush_inputs(name, count):
    """(ctx, kd, scale, arrays, requests) of one capacity-``count`` flush
    of ``name``'s first requests, stacked by the executor's own code."""
    ex = _cpu(max_batch=8)
    try:
        captured = []
        real = ex._enqueue
        ex._enqueue = lambda key, ctx, req, timeout: captured.append(
            (ctx, req))
        for submit, _ in _cases(name, count, uniform=True):
            submit(ex)
        ex._enqueue = real
        ctx = captured[0][0]
        reqs = [r for _, r in captured]
        kd, scale, arrays, _ = ex._stack_cohort(ctx, reqs, count)
    finally:
        ex.shutdown()
    return ctx, kd, scale, arrays, reqs


@pytest.mark.parametrize("name", sorted(KERNEL_ROUTES))
def test_kernel_route_is_one_batched_call_per_operand(name, monkeypatch):
    """On CPU tensors each batched wrapper runs its plain version, so the
    kernel route's program must be torch.equal to the plain route's, with
    exactly the batched calls of ``KERNEL_ROUTES`` and no one-request
    entry point."""
    calls = {k: 0 for k in (*_WRAPPERS, *_SINGLE)}

    def counted(mod, fn_name):
        real = getattr(mod, fn_name)

        def fn(*a, **k):
            calls[fn_name] += 1
            return real(*a, **k)
        return fn

    ctx, kd, scale, arrays, _ = _flush_inputs(name, 3)
    plain = serve.run_flush(ctx, "plain", kd, scale, arrays)
    for fn_name, mod in {**_WRAPPERS, **_SINGLE}.items():
        monkeypatch.setattr(mod, fn_name, counted(mod, fn_name))
    got = serve.run_flush(ctx, "cuda", kd, scale, arrays)
    assert torch.equal(got, plain)
    want = {k: KERNEL_ROUTES[name].get(k, 0) for k in calls}
    assert calls == want


def test_cwt_and_dyadic_srht_sketches_are_the_references_bits():
    """The kernel route's sketches of a flush (the batched entry points'
    plain versions here) bit-equal the reference's single-request serve
    sketches: CWT at any data, SRHT on integer data at n = 256, s = 16."""
    from libskylark_tpu.sketch import fjlt as jfjlt
    from libskylark_tpu.sketch import hash as jhash

    for name, fn in (("solve-cwt", jhash.cwt_serve_apply),
                     ("cmm-cwt", jhash.cwt_serve_apply),
                     ("cmm-srht-dyadic", jfjlt.srht_serve_apply)):
        ctx, kd, scale, arrays, _ = _flush_inputs(name, 3)
        SA, SB = serve.sketch_stage(ctx, kd, scale, arrays)
        a_rowwise = name.startswith("cmm")
        for i in range(3):
            want_a = fn(jnp.asarray(kd[i]),
                        jnp.asarray(arrays["A"][i].numpy()),
                        s_dim=ctx["s_dim"], rowwise=a_rowwise)
            want_b = fn(jnp.asarray(kd[i]),
                        jnp.asarray(arrays["B"][i].numpy()),
                        s_dim=ctx["s_dim"], rowwise=False)
            assert np.array_equal(SA[i].numpy(), np.asarray(want_a)), name
            assert np.array_equal(SB[i].numpy(), np.asarray(want_b)), name


def test_solve_jlt_kernel_route_makes_no_panel_of_its_own():
    """The kernel route's only operator panels are those its wrappers'
    plain versions make on CPU tensors (one per lane and operand): the
    route itself makes none, so on the card, where the wrappers launch,
    it makes none at all."""
    ctx, kd, scale, arrays, _ = _flush_inputs("solve-jlt", 3)
    before = randgen.panels["dense_panel"]
    serve.run_flush(ctx, "cuda", kd, scale, arrays)
    assert randgen.panels["dense_panel"] - before == 2 * 3


# ---------------------------------------------------------------------------
# statics, intake rules, errors
# ---------------------------------------------------------------------------


def _statics_kwargs(endpoint, side):
    M, C = MODS[side]
    rng = np.random.default_rng(7)
    A = rng.standard_normal((37, 6)).astype(np.float32)
    if endpoint == "solve_l2_sketched":
        return [dict(transform=M.JLT(37, 16, C(1)), A=A, B=A[:, 0]),
                dict(transform=M.CWT(37, 16, C(1)), A=A, B=A[:, :2],
                     method="svd")]
    if endpoint == "sparse_solve_l2_sketched":
        S = _csr(100, 7, 0.1, 3)
        return [dict(transform=M.CWT(100, 16, C(2)), A=S,
                     B=np.ones(100, np.float32)),
                dict(transform=M.JLT(100, 16, C(2)), A=S,
                     B=np.ones((100, 3), np.float32))]
    if endpoint in ("graph_ase", "graph_ppr"):
        edges = _graph_edges(20, 0.3, 5)
        G = jml.Graph(edges) if side == "ref" else ml.Graph(edges)
        if endpoint == "graph_ase":
            return [dict(A=G, k=3), dict(A=G, k=2, iters=5)]
        s = np.ones(G.num_vertices(), np.float32)
        return [dict(A=G, s=s), dict(A=G, s=s, alpha=0.5, iters=4)]
    if endpoint == "condest":
        A = rng.standard_normal((37, 12)).astype(np.float32)
        return [dict(A=A), dict(A=A, steps=3)]
    if endpoint == "lowrank":
        kern = jml.Linear(6) if side == "ref" else ml.kernels.Linear(6)
        ctx = C(4)
        return [dict(transform_s=kern.create_rft(4, ctx),
                     transform_t=kern.create_rft(5, ctx), A=A, k=2)]
    B = rng.standard_normal((256, 5)).astype(np.float32)
    A2 = rng.standard_normal((9, 256)).astype(np.float32)
    return [dict(transform=M.FJLT(256, 16, C(5), fut="wht"), A=A2, B=B),
            dict(transform=M.CWT(256, 16, C(5)), A=_csr(9, 256, 0.1, 6),
                 B=B)]


@pytest.mark.parametrize("endpoint", [
    "solve_l2_sketched", "sparse_solve_l2_sketched", "graph_ase",
    "graph_ppr", "condest", "lowrank", "compressed_matmul"])
def test_request_statics_match_the_reference(endpoint):
    for jkw, pkw in zip(_statics_kwargs(endpoint, "ref"),
                        _statics_kwargs(endpoint, "port")):
        assert (engine.request_statics(endpoint, **pkw)
                == jengine.request_statics(endpoint, **jkw))


@pytest.mark.parametrize("endpoint", ["krr_predict", "rlsc_predict"])
def test_krr_statics_match_the_reference_but_for_the_kernel_identity(
        endpoint):
    X, coef = _KRR_MODEL
    q = np.ones((5, 6), np.float32)
    got = engine.request_statics(endpoint, kernel=ml.kernels.Gaussian(6, 2.0),
                                 X_new=q, X_train=X, coef=coef)
    want = jengine.request_statics(endpoint, kernel=jml.Gaussian(6, 2.0),
                                   X_new=q, X_train=X, coef=coef)
    # the kernel identity is now the reference's too: the first 16 hex
    # digits of the sha256 of the kernel's JSON
    assert got == want
    assert got[1] == hashlib.sha256(
        ml.kernels.Gaussian(6, 2.0).to_json().encode()).hexdigest()[:16]
    assert got[1] != engine.request_statics(
        endpoint, kernel=ml.kernels.Gaussian(6, 3.0), X_new=q, X_train=X,
        coef=coef)[1]


@pytest.mark.parametrize("seed", [0, 1, 754, 2**31 - 1, 2**31, -3,
                                  -2**31 - 1, 2**32 + 7, 2**40 + 5,
                                  2**63 - 1])
def test_seed_key_data_is_the_reference_bits(seed):
    got = serve._seed_key_data(seed)
    want = jserve._seed_key_data(seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


def test_default_cmm_transform_is_the_reference_operator():
    for n, cls in ((256, "FJLT"), (200, "CWT")):
        A = np.ones((3, n), np.float32)
        T = serve.default_cmm_transform(A, seed=9)
        J = jserve.default_cmm_transform(A, seed=9)
        assert type(T).__name__ == type(J).__name__ == cls
        assert T.sketch_dim == J.sketch_dim == env.FWHT_CM_SDIM.get()
        assert np.array_equal(T.allocation.key, jserve.MicrobatchExecutor.
                              _key_data(J))


@pytest.mark.parametrize("density", [0.1, 0.25, 0.3])
def test_sparse_solve_densifies_at_a_quarter(density):
    rng = np.random.default_rng(int(density * 100))
    A = np.zeros((64, 4), np.float32)
    cells = rng.choice(256, int(round(density * 256)), replace=False)
    A.flat[cells] = rng.standard_normal(cells.size)
    b = rng.standard_normal(64).astype(np.float32)
    T = sk.CWT(64, 16, Context(3))
    with _cpu(max_batch=2) as ex:
        got = ex.submit_sparse_solve(sp.csr_matrix(A), b, T).result(60)
        ex.flush()
        st = ex.stats()
        dense = ex.submit_solve(A, b, T).result(60)
    dens = density >= env.SPARSE_MIN_DENSITY.get()
    assert st["sparse"]["densified"] == (1 if dens else 0)
    endpoint = ("solve_l2_sketched" if dens else "sparse_solve_l2_sketched")
    assert [eval(k)[0] for k in st["by_bucket"]] == [endpoint]
    if dens:
        assert torch.equal(got, dense)
    else:
        _close(got.numpy(), dense.numpy())
    with pytest.raises(TypeError):
        engine.MicrobatchExecutor(device="cpu").submit_sparse_solve(A, b, T)


def test_krr_model_is_uploaded_once_per_bucket():
    X, coef = _KRR_MODEL
    coef2 = coef.copy()
    k = ml.kernels.Gaussian(6, 1.5)
    q = np.ones((3, 6), np.float32)
    with _cpu(max_batch=2, linger_us=1000) as ex:
        futs = [ex.submit_krr_predict(k, q, X, coef) for _ in range(5)]
        futs += [ex.submit_rlsc_predict(k, q, X, coef2) for _ in range(3)]
        for f in futs:
            f.result(60)
        ex.flush()
        st = ex.stats()
    assert st["flushes"] >= 4
    assert st["models"]["uploads"] == 2 == st["models"]["resident"]
    assert st["models"]["upload_bytes"] == 2 * (X.nbytes + coef.nbytes)


def test_rlsc_decodes_labels_and_the_readers_report():
    X, coef = _KRR_MODEL
    k = ml.kernels.Gaussian(6, 1.5)
    q = np.random.default_rng(3).standard_normal((6, 6)).astype(np.float32)
    with _cpu(max_batch=4) as ex:
        assert ex.queue_depth() == 0 and ex.latency_quantile() is None
        idx = ex.submit_rlsc_predict(k, q, X, coef).result(60)
        labels = ex.submit_rlsc_predict(k, q, X, coef,
                                        coding=["a", "b", "c"]).result(60)
        one = ex.submit_rlsc_predict(k, q[0], X, coef).result(60)
        ex.flush()
        assert ex.queue_depth() == 0
        assert ex.latency_quantile(0.5) <= ex.latency_quantile(0.99)
    assert idx.dtype == torch.int32
    assert list(labels) == [["a", "b", "c"][i] for i in idx.tolist()]
    assert one.ndim == 0 and int(one) == int(idx[0])


def _error_cases():
    """(name, kwargs of submit for a (module, Context, Graph, kernels)
    side, the endpoint)."""
    A = np.ones((16, 4), np.float32)
    return {
        "solve-ct": ("solve_l2_sketched",
                     lambda M, C, _: dict(transform=M.CT(16, 8, C(0)), A=A,
                                          B=A[:, 0])),
        "solve-srht": ("solve_l2_sketched",
                       lambda M, C, _: dict(transform=M.FJLT(
                           16, 8, C(0), fut="wht"), A=A, B=A[:, 0])),
        "solve-rows": ("solve_l2_sketched",
                       lambda M, C, _: dict(transform=M.JLT(16, 8, C(0)),
                                            A=A, B=np.ones(15, np.float32))),
        "solve-input-dim": ("solve_l2_sketched",
                            lambda M, C, _: dict(transform=M.JLT(
                                17, 8, C(0)), A=A, B=A[:, 0])),
        "sparse-solve-dense": ("sparse_solve_l2_sketched",
                               lambda M, C, _: dict(transform=M.CWT(
                                   16, 8, C(0)), A=A, B=A[:, 0])),
        "condest-steps": ("condest", lambda M, C, _: dict(A=A, steps=4)),
        "condest-vector": ("condest",
                           lambda M, C, _: dict(A=A[:, 0], steps=2)),
        "lowrank-cwt": ("lowrank", lambda M, C, _: dict(
            transform_s=M.CWT(4, 3, C(0)), transform_t=M.CWT(4, 3, C(1)),
            A=A, k=2)),
        "lowrank-mixed": ("lowrank", lambda M, C, _: dict(
            transform_s=M.JLT(4, 3, C(0)), transform_t=M.CT(4, 3, C(1)),
            A=A, k=2)),
        "lowrank-k": ("lowrank", lambda M, C, _: dict(
            transform_s=M.JLT(4, 3, C(0)), transform_t=M.JLT(4, 3, C(1)),
            A=A, k=4)),
        "lowrank-dim": ("lowrank", lambda M, C, _: dict(
            transform_s=M.JLT(5, 3, C(0)), transform_t=M.JLT(5, 3, C(1)),
            A=A, k=2)),
        "cmm-jlt": ("compressed_matmul", lambda M, C, _: dict(
            transform=M.JLT(4, 3, C(0)), A=A, B=A.T)),
        "cmm-b-vector": ("compressed_matmul", lambda M, C, _: dict(
            transform=M.CWT(4, 3, C(0)), A=A, B=A[0])),
        "cmm-contraction": ("compressed_matmul", lambda M, C, _: dict(
            transform=M.CWT(4, 3, C(0)), A=A, B=A)),
        "ase-k": ("graph_ase", lambda M, C, G: dict(A=G, k=0)),
        "ppr-vector": ("graph_ppr",
                       lambda M, C, G: dict(A=G, s=np.ones(3, np.float32))),
        "ppr-alpha": ("graph_ppr", lambda M, C, G: dict(
            A=G, s=np.ones(G.num_vertices(), np.float32), alpha=1.0)),
        "krr-dim": ("krr_predict", lambda M, C, _: dict(
            kernel=None, X_new=np.ones((2, 5), np.float32),
            X_train=_KRR_MODEL[0], coef=_KRR_MODEL[1])),
    }


@pytest.mark.parametrize("case", sorted(_error_cases()))
def test_bad_requests_raise_what_the_reference_raises(case):
    endpoint, make = _error_cases()[case]
    edges = _graph_edges(12, 0.5, 2)
    with pytest.raises(Exception) as want:
        jengine.request_statics(endpoint, **make(jsk, JContext,
                                                 jml.Graph(edges)))
    assert want.type in (ValueError, TypeError)
    with _cpu() as ex:
        with pytest.raises(want.type):
            ex.submit(endpoint, **make(sk, Context, ml.Graph(edges)))
        assert ex.stats()["submitted"] == 0


def test_twins_are_the_served_programs():
    """The eager twins compute what a capacity-1 flush does."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((20, 12)).astype(np.float32)
    kern = ml.kernels.Linear(12)
    ctx = Context(8)
    Ts, Tt = kern.create_rft(6, ctx), kern.create_rft(9, ctx)
    T = sk.JLT(20, 16, Context(9))
    b = rng.standard_normal(20).astype(np.float32)
    with _cpu(max_batch=1) as ex:
        Z = ex.submit_lowrank(Ts, Tt, A, 2).result(60)
        x = ex.submit_solve(A, b, T).result(60)
    Ze = lowrank.lowrank_serve(Ts, Tt, A, 2, device="cpu")
    assert np.abs(Z.numpy() - Ze).max() <= 1e-6 * np.abs(Ze).max()
    xe = regression.sketched_solve_serve(
        T.allocation.key, T.scale, torch.from_numpy(_padded_rows(A, 32)),
        torch.from_numpy(_padded_rows(b[:, None], 32)), sketch_type="JLT",
        s_dim=16)[:, 0]
    assert np.abs(x.numpy() - xe.numpy()).max() \
        <= 1e-6 * np.abs(xe.numpy()).max()
