"""Warmup packs (engine/warmup.py) and the sketch endpoints' captured
flushes (engine/serve.py) on the CPU, against the JAX package.

On the CPU the executable cache's executable is the flush body itself,
keyed and counted as on the card, so a pack built here, then loaded into
a fresh executor, must leave its traffic with no compile and a hit on
every packed bucket's first request. Sizes: n ≤ 256, m ≤ 32, s ≤ 64,
capacities 1 and 2. The two boot probes are the only child processes.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from libskylark_tpu_torch import engine
from libskylark_tpu_torch.engine import serve, warmup
from libskylark_tpu_torch.sketch import COLUMNWISE, ROWWISE

compiled_mod = __import__("importlib").import_module(
    "libskylark_tpu_torch.engine.compiled")

S = warmup.BucketSpec
SPECS = [S("sketch_apply", "JLT", 256, 32, 64, rowwise=True,
           capacities=(1, 2)),
         S("sketch_apply", "CWT", 256, 32, 64, rowwise=False,
           capacities=(1, 2), seed=5),
         S("sketch_apply", "CT", 200, 20, 48, rowwise=False,
           capacities=(1, 2), seed=9),
         S("fastfood_features", "FastGaussianRFT", 100, 16, 64,
           capacities=(1, 2), sigma=4.0, seed=3)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SKYLARK_AOT_DIR", "SKYLARK_EXEC_CACHE_DIR",
              "SKYLARK_SERVE_KERNEL", "SKYLARK_FWHT_KERNEL",
              "SKYLARK_SPARSE_KERNEL", "SKYLARK_USE_PLAN_CACHE"):
        monkeypatch.delenv(k, raising=False)
    engine.reset()
    yield
    engine.reset()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pack"))
    manifest = warmup.build_pack(d, SPECS, device="cpu")
    engine.reset()
    return d, manifest


def _executor(manifest, **kw):
    return engine.MicrobatchExecutor(
        max_batch=manifest["max_batch"], linger_us=60_000_000,
        pad_floor=manifest["pad_floor"], device="cpu", **kw)


def test_the_pack_records_every_bucket_and_capacity(pack):
    d, m = pack
    assert m["schema"] == warmup.PACK_SCHEMA and m["max_batch"] == 2
    assert m["device"] == "cpu" and not m["uncaptured"]
    got = sorted((e["spec"]["family"], e["capacity"]) for e in m["entries"])
    assert got == sorted((s.family, c) for s in SPECS for c in (1, 2))
    for e in m["entries"]:
        assert e["kernel"] == "plain" and not e.get("artifact_missing")
        assert e["name"] == ("serve.fastfood_features"
                             if e["endpoint"] == "fastfood_features"
                             else "serve.sketch_apply")
    assert warmup.read_manifest(d) == m
    assert warmup.read_manifest(d + "/pack.json") == m


def test_a_loaded_pack_serves_its_traffic_from_hits(pack):
    d, m = pack
    with _executor(m) as ex:
        report = ex.load_warmup_pack(d)
        assert report["skipped"] is None and report["failed"] == 0
        assert report["loaded"] == report["entries"] == len(m["entries"])
        assert report["kernel_restored"] == report["entries"]
        assert report["plan_fingerprint_match"]
        s = engine.stats()
        assert (s.aot_loads, s.misses, s.compiles) == (len(m["entries"]),
                                                       0, 0)
        s0 = dataclasses.replace(engine.stats())
        for ent in m["entries"]:
            spec = S.from_dict(ent["spec"])
            hits = engine.stats().hits
            outs = warmup._serve(ex, spec, ent["cohort"])
            # the packed bucket's first request is a hit, bit-equal to
            # the builder's
            assert engine.stats().hits == hits + 1
            assert warmup.result_digest(outs) == ent["results_digest"]
        s1 = engine.stats()
        assert s1.misses == s0.misses and s1.compiles == s0.compiles
        st = ex.stats()
        assert st["kernel"]["by_source"] == {"device": {"flushes": 8}}
        assert st["capture"] == {"captured_flushes": 8, "eager_flushes": {}}
        # a second load into the same process finds every key resident
        again = warmup.load_pack(d, executors=(ex,))
        assert again["resident"] == again["entries"]
        assert again["loaded"] == 0


def test_an_explicit_pin_declines_the_restore(pack, monkeypatch):
    d, m = pack
    with _executor(m, kernel="plain") as ex:
        report = ex.load_warmup_pack(d)
    assert report["loaded"] == report["entries"]
    assert report["kernel_restored"] == 0
    engine.reset()
    monkeypatch.setenv("SKYLARK_SERVE_KERNEL", "xla")
    with _executor(m) as ex:
        assert warmup.load_pack(d, executors=(ex,))["kernel_restored"] == 0
        statics = ("sketch_apply", "CWT", "None", 64, False, "float32",
                   (256, 32))
        assert not ex.restore_kernel_choice(statics, 2, "plain")
    monkeypatch.delenv("SKYLARK_SERVE_KERNEL")
    monkeypatch.setenv("SKYLARK_USE_PLAN_CACHE", "0")
    with _executor(m) as ex:
        assert not ex.restore_kernel_choice(statics, 2, "plain")
    monkeypatch.delenv("SKYLARK_USE_PLAN_CACHE")
    with _executor(m) as ex:
        assert not ex.restore_kernel_choice(statics, 2, "tpu")
        assert ex.restore_kernel_choice(statics, 2, "xla")
        assert ex._restored[(statics, 2)] == "plain"


def test_the_environment_pins_route_the_buckets(monkeypatch):
    srht = ("sketch_apply", "SRHT", "None", 64, True, "float32", (8, 256))
    jlt = ("sketch_apply", "JLT", "Normal()", 64, True, "float32", (8, 256))
    sparse = ("sparse_sketch_apply", "CWT", "None", 64, True, "float32",
              (8, 256), 64)
    assert serve._env_route(jlt) is None
    monkeypatch.setenv("SKYLARK_SERVE_KERNEL", "xla")
    assert [serve._env_route(s) for s in (srht, jlt, sparse)] == [
        "plain"] * 3
    monkeypatch.setenv("SKYLARK_FWHT_KERNEL", "pallas")
    monkeypatch.setenv("SKYLARK_SPARSE_KERNEL", "pallas")
    assert [serve._env_route(s) for s in (srht, jlt, sparse)] == [
        "cuda", "plain", "cuda"]
    assert serve._env_route(("solve_l2_sketched", "JLT")) is None


def test_fingerprint_drift_or_a_missing_pack_degrades(pack, monkeypatch,
                                                      tmp_path):
    d, m = pack
    monkeypatch.setattr(compiled_mod, "plan_fingerprint",
                        lambda: "another-plan-cache")
    report = warmup.load_pack(d, device="cpu")
    assert report["skipped"].startswith("plan-fingerprint drift")
    assert report["plan_fingerprint_match"] is False
    assert report["loaded"] == 0 and engine.stats().aot_loads == 0
    with pytest.raises(RuntimeError, match="plan-fingerprint"):
        warmup.load_pack(d, device="cpu", strict=True)
    monkeypatch.undo()
    missing = warmup.load_pack(str(tmp_path / "nothing"), device="cpu")
    assert missing["skipped"].startswith("unreadable manifest")
    with pytest.raises(RuntimeError, match="unreadable manifest"):
        warmup.load_pack(str(tmp_path / "nothing"), strict=True)


def test_a_broken_entry_is_counted_not_served(pack, tmp_path):
    import shutil

    d, m = pack
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    ent = m["entries"][0]
    path = warmup._aot.artifact_path(ent["digest"], copy + "/artifacts")
    with open(path, "rb+") as fh:
        fh.truncate(30)
    with pytest.warns(RuntimeWarning, match="not loaded"):
        report = warmup.load_pack(copy, device="cpu")
    assert report["failed"] == 1 and report["loaded"] == report[
        "entries"] - 1
    assert engine.stats().aot_load_failures == 1
    assert (tmp_path / "copy" / "artifacts" /
            (path.rsplit("/", 1)[1] + ".bad")).exists()


def test_the_matern_bucket_is_kept_out_of_capture(tmp_path):
    spec = S("fastfood_features", "FastMaternRFT", 100, 16, 64,
             capacities=(2,), sigma=4.0)
    m = warmup.build_pack(str(tmp_path), [spec], device="cpu")
    assert m["entries"] == []
    (u,) = m["uncaptured"]
    assert u["reason"] == "FastMaternRFT: the Gamma loop reads the host"


def test_a_captured_flush_under_other_keys_equals_its_eager_flush():
    """Each sketch bucket's flush through its CompiledFn, the second time
    under another cohort's keys, is torch.equal to the eager program on
    the same stacked inputs (on the card the second call replays the
    graph the first captured)."""
    with engine.MicrobatchExecutor(max_batch=2, linger_us=60_000_000,
                                   device="cpu") as ex:
        for spec in SPECS:
            for seed in (spec.seed, spec.seed + 100):
                sp = dataclasses.replace(spec, seed=seed)
                reqs = warmup._spec_requests(sp, 2)
                prepared = [ex._prepare(
                    spec.endpoint, transform=T, A=A,
                    **({} if spec.endpoint == "fastfood_features" else
                       {"dimension": ROWWISE if spec.rowwise
                        else COLUMNWISE})) for T, A in reqs]
                key, ctx, _ = prepared[0]
                kd, scale, arrays, _ = ex._stack_cohort(
                    ctx, [q for _, _, q in prepared], 2)
                want = serve.run_flush(ctx, "plain", kd, scale,
                                       {"A": arrays["A"].clone()})
                fn, why = ex._flush_fn_locked(key, ctx, "plain")
                assert why is None
                got = serve.run_flush(dict(ctx, flush_fn=fn), "plain", kd,
                                      scale, arrays)
                assert torch.equal(got, want)
                # the stacked operand was donated to the flush
                assert arrays["A"].numel() == 0
    assert engine.stats().misses == len(SPECS)
    assert engine.stats().hits == len(SPECS)


class _NoHost(torch.Tensor):
    """A tensor whose values may not reach the host: what a captured
    flush's keys must be (a capture would bake a host read in)."""

    def __array__(self, *a, **k):
        raise AssertionError("a key tensor was read on the host")

    def numpy(self, *a, **k):
        raise AssertionError("a key tensor was read on the host")

    def tolist(self):
        raise AssertionError("a key tensor was read on the host")

    def item(self):
        raise AssertionError("a key tensor was read on the host")


def test_the_kernel_routes_take_device_keys_with_no_host_read():
    from libskylark_tpu_torch.sketch import cuda_dense, cuda_fastfood

    words = np.array([[1, 2], [0xFFFFFFF0, 7], [12345, 0x80000001]],
                     dtype=np.uint32)
    keys = torch.from_numpy(words.view(np.int32).copy())
    guarded = keys.as_subclass(_NoHost)
    for fut_n, s in ((100, 300), (64, 64)):
        want = cuda_fastfood.batched_streams(words, fut_n, s, device="cpu")
        got = cuda_fastfood.batched_streams(guarded, fut_n, s)
        for g, w in zip(got, want):
            assert torch.equal(g.as_subclass(torch.Tensor), w)
    assert cuda_dense.lane_keys(guarded, "cpu") is not None
    scales = torch.ones(3).as_subclass(_NoHost)
    assert cuda_dense.lane_scales(scales, "cpu") is not None
    with pytest.raises(Exception, match="int32"):
        cuda_dense.lane_keys(keys.to(torch.int64), "cpu")


def test_the_port_and_the_reference_serve_the_same_cohorts():
    """The same ``_spec_requests`` operands; a CWT bucket's served results
    bit-equal to the JAX package's CWT applied to them, a JLT bucket's
    within 1e-4·max; ``result_digest`` the same hex; BucketSpec dicts
    cross between the packages."""
    import jax
    import jax.numpy as jnp

    from libskylark_tpu.engine import warmup as ref_warmup
    from libskylark_tpu.sketch import COLUMNWISE as R_CW, ROWWISE as R_RW

    for spec in SPECS[:2]:
        rspec = ref_warmup.BucketSpec.from_dict(spec.to_dict())
        assert rspec.to_dict() == spec.to_dict()
        assert S.from_dict(rspec.to_dict()) == spec
        ours = warmup._spec_requests(spec, 2)
        theirs = ref_warmup._spec_requests(rspec, 2)
        for (T, A), (RT, RA) in zip(ours, theirs):
            assert np.array_equal(A, RA)
            assert np.array_equal(
                np.asarray(T.allocation.key, np.uint32),
                np.asarray(jax.random.key_data(RT.allocation.key),
                           np.uint32))
        with engine.MicrobatchExecutor(max_batch=2, linger_us=60_000_000,
                                       device="cpu") as ex:
            served = warmup._serve(ex, spec, 2)
        dim = R_RW if spec.rowwise else R_CW
        ref = [np.asarray(RT.apply(jnp.asarray(RA), dim))
               for RT, RA in theirs]
        for got, want in zip(served, ref):
            got = got.numpy()
            assert got.shape == want.shape
            if spec.family == "CWT":
                assert np.array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert warmup.result_digest(ref) == ref_warmup.result_digest(ref)
        assert warmup.result_digest([torch.tensor(r) for r in ref]) == \
            ref_warmup.result_digest(ref)


def test_the_cli_inspects_and_verifies_a_pack(pack, capsys, monkeypatch):
    from libskylark_tpu_torch.cli import skylark_warmup

    d, m = pack
    assert skylark_warmup.main(["inspect", "--pack", d]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["compat_ok_here"] and doc["plan_fingerprint_match"]
    assert len(doc["entries"]) == len(m["entries"])
    # verify loads on the device the pack was built on
    assert skylark_warmup.main(["verify", "--pack", d]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["loaded"] == doc["entries"] and doc["backend_compiles"] == 0
    assert skylark_warmup.main(["build", "--pack", d + "-top"]) == 2
    with pytest.raises(Exception, match="A6"):
        warmup.select_top_buckets(4)


def test_boot_probes_in_fresh_processes(pack):
    d, m = pack
    cold = warmup.spawn_boot_probe(d, load=False, timeout=300)
    packed = warmup.spawn_boot_probe(d, load=True, timeout=300)
    n = len(m["entries"])
    for r in (cold, packed):
        assert r["bit_equal"] and r["entries"] == n
        assert r["t_first_result_s"] is not None
        assert r["wall_since_spawn_s"] >= r["t_first_result_s"]
    assert cold["warmup"] is None
    assert cold["engine"]["compiles"] == n and cold["engine"]["misses"] == n
    w = packed["warmup"]
    assert w["loaded"] == n and w["kernel_restored"] == n and not w["failed"]
    e = packed["engine"]
    assert (e["compiles"], e["misses"], e["aot_loads"], e["hits"]) == (
        0, 0, n, n)


def test_the_chip_phase_holds_on_the_cpu(monkeypatch):
    """chip_smoke.py's warmup phase at a small size on the CPU: the pack,
    each entry's cold, replay and eager flush, and both boot probes (in
    this process, the cache reset between)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    specs = [s.to_dict() for s in SPECS[1:]]
    out = chip_smoke.warmup_phase(torch, None, np, specs=specs,
                                  device="cpu")
    n = sum(len(s["capacities"]) for s in specs)
    assert len(out["entries"]) == len(out["cells"]) == n
    assert out["boot_probe"]["packed"]["compiles"] == 0
    assert out["boot_probe"]["cold"]["compiles"] == n
    assert all(c["cold_ms"] > 0 and c["eager_ms"] > 0
               for c in out["cells"].values())
