"""The port's public names against the JAX package's (ROADMAP C10).

For every module that both packages define, each public name of the
reference must exist in the port, and each parameter name of a public
function, class or method must be accepted by the port's counterpart
(``inspect.signature`` on the CPU; a port signature with ``**kwargs``
accepts any keyword). A module's public names are the functions and
classes it defines, its upper-case constants, and a package's
``__all__``. Only what ROADMAP defers is exempt, each exemption with its
item: what the serve executor still lacks (its ``mesh``, A6; sessions,
training jobs and the dist endpoints, A7), the telemetry exporter (A7),
and the names of reference modules not ported yet (C12).
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil

import pytest

import libskylark_tpu
import libskylark_tpu_torch

# the dist endpoints run the reference's dist/ package (A7)
_SERVE_DIST = ("submit_dist_sketch", "submit_dist_lstsq", "submit_dist_svd")
_SERVE_A7 = ("sessions", "open_sketch_session", "session_append",
             "session_finalize", "train_jobs", "submit_train_job",
             "resume_train_job", "train_job_status")

# "module:name" (a name, a Class.member or a callable's "(param)") -> the
# ROADMAP item that brings it. The deferred kinds: what the serve
# executor still lacks (A6 and A7 by feature), and the telemetry
# exporter (A7). Every other name the port lacks is C12: a module of the
# reference not yet ported, each named there with the A item that brings
# it.
EXEMPT = {
    # A7: telemetry/export.py, the JSONL exporter and Prometheus renderer
    "telemetry:JsonlExporter": "A7",
    "telemetry:get_exporter": "A7", "telemetry:install_exporter": "A7",
    "telemetry:prometheus_text": "A7", "telemetry:shutdown_exporter": "A7",
    # C12: names of reference modules the port has not reached yet.
    # the kernel-dispatch knobs that read tune/'s plan cache or choose a
    # route off the kernel, which the port's CUDA path does not have
    # (A6)
    "sketch.dense:pallas_ambient_ok": "C12",
    "sketch.dense:pallas_serves_eager": "C12",
    "sketch.dense:try_pallas_apply": "C12",
    "sketch.params:get_use_pallas": "C12",
    "sketch.params:set_use_pallas": "C12",
    "sketch.params:get_use_plan_cache": "C12",
    "sketch.params:set_use_plan_cache": "C12",
    "sketch.params:get_pallas_m_tile": "C12",
    "sketch.params:set_pallas_m_tile": "C12",
    "sketch.params:pallas_m_tile_overridden": "C12",
    # io/streaming.py, chunked.py and webhdfs.py (A7)
    "io:StreamingCWT": "C12", "io:iter_libsvm_batches": "C12",
    "io:iter_hdf5_batches": "C12", "io:prefetch_batches": "C12",
    "io:read_libsvm_sharded": "C12", "io:scan_libsvm_dims": "C12",
    "io:stream_sketch_libsvm": "C12", "io:webhdfs_lines": "C12",
    # cli/__init__.py's helpers, which the other drivers share (A8)
    "cli:LIBSVM_DENSE": "A8", "cli:LIBSVM_SPARSE": "A8",
    "cli:HDF5_DENSE": "A8", "cli:HDF5_SPARSE": "A8",
    "cli:read_dataset": "A8", "cli:honor_platform_env": "A8",
    "cli:write_ascii_matrix": "A8", "cli:add_streaming_args": "A8",
    "cli:read_streaming": "A8",
    # utility/checkpoint.py (A7)
    "utility:TrainCheckpointer": "C12", "utility:as_checkpointer": "C12",
    "utility:device_state": "C12", "utility:load_sync": "C12",
    "utility:save_sync": "C12",
}
for _m in ("engine", "engine.serve"):
    EXEMPT[f"{_m}:MicrobatchExecutor(mesh)"] = "A6"
    for _n in _SERVE_DIST:
        EXEMPT[f"{_m}:MicrobatchExecutor.{_n}"] = "A7"
    for _n in _SERVE_A7:
        EXEMPT[f"{_m}:MicrobatchExecutor.{_n}"] = "A7"


def _modules(pkg) -> dict:
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name.split(".", 1)[1]] = m.name
    return out


def _common_modules() -> list:
    ref, port = _modules(libskylark_tpu), _modules(libskylark_tpu_torch)
    return sorted(set(ref) & set(port))


def _public(mod) -> dict:
    """name -> object: what ``mod`` defines, its upper-case constants and
    its ``__all__`` (a package's exported submodules included). A
    package's other submodule attributes are left out: they exist only
    once something has imported them."""
    out = {}
    for name in getattr(mod, "__all__", ()):
        try:
            out[name] = getattr(mod, name)
        except AttributeError:  # a lazy name the reference leaves out
            continue
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if getattr(obj, "__module__", None) == mod.__name__:
                out[name] = obj
        elif name.isupper() and isinstance(obj, (int, float, str, tuple)):
            out[name] = obj
    return out


def _params(obj) -> tuple:
    """(parameter names, takes **kwargs) of a callable, or None."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    names = [p.name for p in sig.parameters.values()
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
             and p.name not in ("self", "cls")]
    varkw = any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())
    return names, varkw


def _missing_params(ref, port, label, mod_key) -> list:
    r, p = _params(ref), _params(port)
    if r is None or p is None or p[1]:
        return []
    return [f"{label}({n})" for n in r[0]
            if n not in p[0] and f"{mod_key}:{label}({n})" not in EXEMPT]


def _mismatches(mod_key: str) -> list:
    ref = importlib.import_module(_modules(libskylark_tpu)[mod_key])
    port = importlib.import_module(_modules(libskylark_tpu_torch)[mod_key])
    bad = []
    for name, obj in sorted(_public(ref).items()):
        if f"{mod_key}:{name}" in EXEMPT:
            continue
        if not hasattr(port, name):
            bad.append(name)
            continue
        pobj = getattr(port, name)
        if inspect.ismodule(obj):
            continue
        if inspect.isclass(obj):
            bad += _missing_params(obj, pobj, name, mod_key)
            for member, f in vars(obj).items():
                label = f"{name}.{member}"
                if member.startswith("_") or f"{mod_key}:{label}" in EXEMPT:
                    continue
                if not hasattr(pobj, member):
                    bad.append(label)
                elif callable(f) or isinstance(f, (staticmethod,
                                                  classmethod)):
                    bad += _missing_params(getattr(obj, member),
                                           getattr(pobj, member), label,
                                           mod_key)
        elif callable(obj):
            bad += _missing_params(obj, pobj, name, mod_key)
    return bad


@pytest.mark.parametrize("mod_key", _common_modules())
def test_reference_names_exist_in_the_port(mod_key):
    assert _mismatches(mod_key) == []


def test_the_new_modules_are_compared():
    """The NLA, graph, block-solver, HDF5, parallel, and the serve
    production layer's modules (the artifact store, warmup packs and
    their CLI among them) are among those both packages define, so the
    parity test above covers them; none of the last has an exemption."""
    common = set(_common_modules())
    for m in ("nla.krank", "nla.randlobpcg", "nla.spectral", "ml.graph",
              "algorithms.asynch", "io.hdf5", "parallel", "parallel.mesh",
              "parallel.multihost", "parallel.shard_apply",
              "base.dist_sparse", "sketch.dist_sparse_apply"):
        assert m in common, m
    serve_layer = ("base.env", "base.locks", "telemetry.names",
                   "telemetry.trace", "telemetry.metrics", "resilience",
                   "resilience.policy", "resilience.faults",
                   "resilience.health", "resilience.preemption", "qos",
                   "qos.tenants", "qos.scheduler", "qos.controller",
                   "engine.resultcache", "engine.aot", "engine.warmup",
                   "cli.skylark_warmup")
    for m in serve_layer:
        assert m in common, m
        assert not [k for k in EXEMPT if k.split(":")[0] == m], m


def test_every_exemption_names_a_later_roadmap_item():
    assert set(EXEMPT.values()) <= {"A5", "A6", "A7", "A8", "C12"}


def test_pallas_precision_knob_has_the_reference_semantics():
    from libskylark_tpu_torch.sketch import params

    before = params.get_pallas_precision()
    try:
        assert before == "bf16x3"
        assert not params.pallas_precision_overridden()
        params.set_pallas_precision("f32")
        assert params.get_kernel_precision() == "f32"
        assert params.pallas_precision_overridden()
        with pytest.raises(ValueError):
            params.set_pallas_precision("tf32")
        assert params.get_pallas_precision() == "f32"
    finally:
        params.set_pallas_precision(before)


def test_sample_and_random_value_match_the_reference():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libskylark_tpu.base import context as rctx, randgen as rr
    from libskylark_tpu_torch.base import context as pctx, randgen as pr

    key = jax.random.key(11)
    kd = np.asarray(jax.random.key_data(key))
    for rd, pd in ((rr.Uniform(-1.0, 2.0), pr.Uniform(-1.0, 2.0)),
                   (rr.Rademacher(), pr.Rademacher()),
                   (rr.UniformInt(3, 40), pr.UniformInt(3, 40))):
        want = np.asarray(rd.sample(key, (7, 5)))
        got = pd.sample(kd, (7, 5), device="cpu").numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want)
    want = np.asarray(rr.Normal().sample(key, (300,), jnp.float32))
    got = pr.Normal().sample(kd, (300,), device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    rv = rctx.Context(5).random_value(rr.Uniform().sample, shape=(4,))
    pv = pctx.Context(5).random_value(pr.Uniform().sample, shape=(4,),
                                      device="cpu")
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_sample_and_random_value_run_on_the_default_device():
    """With no ``device=``, ``sample`` and ``random_value`` run on the
    package default: the CPU once it is set so, and a CUDA default with
    no card raises."""
    import jax
    import numpy as np
    import torch

    from libskylark_tpu.base import context as rctx, randgen as rr
    from libskylark_tpu_torch.base import (context as pctx, device,
                                           errors, randgen as pr)

    key = jax.random.key(12)
    kd = np.asarray(jax.random.key_data(key))
    device.set_default_device("cpu")
    try:
        got = pr.Uniform().sample(kd, (6, 3))
        assert got.device == torch.device("cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rr.Uniform().sample(key, (6, 3))))
        rv = rctx.Context(6).random_value(rr.Normal().sample, shape=(5,))
        pv = pctx.Context(6).random_value(pr.Normal().sample, shape=(5,))
        assert pv.device == torch.device("cpu")
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5,
                                   rtol=0)
    finally:
        device.set_default_device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(errors.UnsupportedError):
            pr.Uniform().sample(kd, (2,))
        with pytest.raises(errors.UnsupportedError):
            pctx.Context(6).random_value(pr.Normal().sample, shape=(5,))


def test_stream_chunk_parameter_makes_the_reference_stream():
    import jax
    import numpy as np

    from libskylark_tpu.base import randgen as rr
    from libskylark_tpu_torch.base import randgen as pr

    key = jax.random.key(4)
    kd = np.asarray(jax.random.key_data(key))
    want = np.asarray(rr.stream_slice(key, rr.Uniform(), 100, 900,
                                      chunk=256))
    got = pr.stream_slice(kd, pr.Uniform(), 100, 900, device="cpu",
                          chunk=256).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(rr.stream_chunks(key, rr.Rademacher(), 3, 2,
                                       chunk=128))
    got = pr.stream_chunks(kd, pr.Rademacher(), 3, 2, device="cpu",
                           chunk=128).numpy()
    np.testing.assert_array_equal(got, want)


def test_wht_accepts_and_ignores_precision():
    import torch

    from libskylark_tpu_torch.sketch import fut

    A = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    want = fut.wht(A)
    assert torch.equal(fut.wht(A, 0, precision="highest"), want)
    assert torch.equal(fut.fwht(A, precision="highest"), want)
    assert torch.equal(fut.WHT(8).apply(A, 0, precision="highest"), want)
    assert torch.equal(fut.WHT(8).apply_inverse(A, 0, precision=None),
                       want)
    d = torch.ones(8)
    idx = torch.arange(4)
    assert torch.equal(
        fut.fwht_sketch(A, d, idx, 1.0, 1.0, 0, precision="highest"),
        want[:4])


def test_error_codes_and_readers_match_the_reference():
    from libskylark_tpu.base import errors as re_
    from libskylark_tpu_torch.base import errors as pe

    for code in range(100, 120):
        want, got = re_.from_code(code, "m"), pe.from_code(code, "m")
        assert type(got).__name__ == type(want).__name__
        assert got.code == want.code and str(got) == "m"
        known = code in re_._CODE_TABLE
        assert (code in pe._CODE_TABLE) == known
        assert pe.strerror(code).startswith("unknown") != known
    assert pe.WIRE_OVERLOADED_CODE == re_.WIRE_OVERLOADED_CODE
    assert issubclass(pe.WireProtocolError, pe.CommunicationError)
    e = pe.SketchCoverageError("low", coverage=0.5, missing=[(0, 4)])
    assert e.code == 114 and e.coverage == 0.5 and e.missing == ((0, 4),)
    assert pe.SparseError().append_trace("spmm").trace == ["spmm"]
    assert isinstance(pe.NotImplementedYetError(), NotImplementedError)


def test_solver_precision_holds_the_matmul_precision():
    import torch

    from libskylark_tpu_torch.base import precision

    seen = []
    probe = precision.with_solver_precision(
        lambda: seen.append(torch.get_float32_matmul_precision()))
    assert precision.get_solver_precision() == "highest"
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        probe()
        precision.set_solver_precision("tensorfloat32")
        probe()
        precision.set_solver_precision("default")
        probe()
        with pytest.raises(ValueError):
            precision.set_solver_precision("tf33")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        precision.set_solver_precision("highest")
        torch.set_float32_matmul_precision(before)
    assert seen == ["highest", "high", "medium"]


def test_factor_knob_and_result_nbytes():
    import numpy as np
    import torch

    from libskylark_tpu.engine import bucket as rb
    from libskylark_tpu.sketch import params as rp
    from libskylark_tpu_torch.engine import bucket as pb
    from libskylark_tpu_torch.sketch import params as pp

    assert pp.get_factor() == rp.get_factor() == 20
    try:
        pp.set_factor(7)
        assert pp.get_factor() == 7
    finally:
        pp.set_factor(20)
    value = (np.zeros((3, 4), np.float32), {"a": b"xyz", "b": 1.0}, [])
    assert pb.result_nbytes(value) == rb.result_nbytes(value)
    assert pb.result_nbytes(torch.zeros(3, 4)) == 48
