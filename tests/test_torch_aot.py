"""The port's artifact store of capture records (engine/aot.py) against
the reference's file format, and the file locks it shares with the kernel
build (kernels/build.py).

A CUDA graph cannot be serialized, so the port's artifact is a capture
record (ROADMAP C20); the file format is the reference's byte for byte,
so each package reads the other's headers, and each refuses the other's
payload on the compat probe without deleting the file.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import subprocess
import time
import warnings

import pytest
import torch

from libskylark_tpu_torch import engine
from libskylark_tpu_torch.engine import aot

# the module: the package re-exports its decorator under the same name
compiled_mod = __import__("importlib").import_module(
    "libskylark_tpu_torch.engine.compiled")

KEY = ("serve.sketch_apply", "v1", (), ("sketch_apply", "CWT", "None", 64,
                                        True, "float32", (32, 256),
                                        "kernel", "plain"),
       (((2, 2), "torch.int32", "cpu"),), ("unsharded",), (2,),
       "no-plan-cache", ("highest",), "cpu")


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    for k in ("SKYLARK_AOT_DIR", "SKYLARK_EXEC_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    engine.reset()
    yield
    engine.reset()


def test_header_round_trip(tmp_path):
    record = {"name": "serve.sketch_apply", "args": [((2, 2), "int32")]}
    path = aot.save(KEY, record, name="serve.sketch_apply",
                    compile_seconds=0.25, meta={"endpoint": "sketch_apply"},
                    dirpath=str(tmp_path))
    assert path == aot.artifact_path(aot.key_digest(KEY), str(tmp_path))
    with open(path, "rb") as fh:
        assert fh.read(8) == b"SKYAOT1\n"
    h = aot.read_header(path)
    assert h["digest"] == aot.key_digest(KEY)
    assert h["key_repr"] == repr(KEY)
    assert h["name"] == "serve.sketch_apply"
    assert h["endpoint"] == "sketch_apply"
    assert h["compile_seconds"] == 0.25
    assert h["compat"] == aot.compat_stamp()
    assert aot.compat_probe(h["compat"]) == (True, None)
    key, rec, header = aot.load_file(path)
    assert key == KEY and rec == record and header == h
    got, header, _seconds = aot.load(KEY, str(tmp_path))
    assert got == record
    assert aot.load(KEY[:-1] + ("other",), str(tmp_path)) is None
    assert [x["digest"] for x in aot.list_artifacts(str(tmp_path))] == [
        aot.key_digest(KEY)]
    # the stamp names this runtime and the kernels that decide the bits
    stamp = aot.compat_stamp()
    assert stamp["backend"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
    assert stamp["torch"] == torch.__version__
    assert len(stamp["kernels"]) == 16


def test_reference_and_port_read_each_others_headers(tmp_path):
    import jax
    import jax.numpy as jnp

    from libskylark_tpu.engine import aot as ref_aot

    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    compiled = jax.jit(lambda x: 2.0 * x).lower(jnp.ones(3)).compile()
    ref_path = ref_aot.save(("ref", 1), compiled, name="ref.double",
                            dirpath=str(ref_dir))
    assert ref_path is not None
    port_path = aot.save(KEY, {"name": "x"}, name="serve.sketch_apply",
                         dirpath=str(port_dir))

    # the port reads the reference's header and refuses its payload on
    # the compat probe, keeping the file
    h = aot.read_header(ref_path)
    assert h["name"] == "ref.double" and "jax" in h["compat"]
    ok, why = aot.compat_probe(h["compat"])
    assert not ok and why.startswith("torch-mismatch")
    with pytest.raises(aot.AotLoadError) as e:
        aot.load_file(ref_path)
    assert e.value.reason == "compat" and os.path.exists(ref_path)
    assert [x["name"] for x in aot.list_artifacts(str(ref_dir))] == [
        "ref.double"]

    # and the reverse
    h = ref_aot.read_header(port_path)
    assert h["name"] == "serve.sketch_apply" and h["key_repr"] == repr(KEY)
    assert not ref_aot.compat_probe(h["compat"])[0]
    with pytest.raises(ref_aot.AotLoadError) as e:
        ref_aot.load_file(port_path)
    assert e.value.reason == "compat" and os.path.exists(port_path)
    assert [x["digest"] for x in ref_aot.list_artifacts(str(port_dir))] == [
        aot.key_digest(KEY)]


def _rewrite_header(path, header):
    with open(path, "rb") as fh:
        blob = fh.read()
    (hlen,) = __import__("struct").unpack(">Q", blob[8:16])
    hdr = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as fh:
        fh.write(blob[:8] + __import__("struct").pack(">Q", len(hdr)) + hdr
                 + blob[16 + hlen:])


def test_compat_mismatch_keeps_the_file_and_a_torn_one_goes_to_bad(
        tmp_path):
    d = str(tmp_path)
    path = aot.save(KEY, {"name": "x"}, name="x", dirpath=d)
    h = aot.read_header(path)
    h["compat"] = dict(h["compat"], device_kind="another card")
    _rewrite_header(path, h)
    with pytest.raises(aot.AotLoadError) as e:
        aot.load(KEY, d)
    assert e.value.reason == "compat"
    assert os.path.exists(path) and not os.path.exists(path + ".bad")

    # a payload torn mid-write: quarantined, and the next load is a miss
    path = aot.save(KEY, {"name": "x"}, name="x", dirpath=d)
    with open(path, "rb+") as fh:
        fh.truncate(os.path.getsize(path) - 5)
    with pytest.raises(aot.AotLoadError) as e:
        aot.load(KEY, d)
    assert e.value.reason == "deserialize"
    assert not os.path.exists(path) and os.path.exists(path + ".bad")
    assert aot.load(KEY, d) is None

    # a header torn mid-write, through load_file (a pack's entries)
    path = aot.save(KEY, {"name": "x"}, name="x", dirpath=d)
    with open(path, "rb+") as fh:
        fh.truncate(20)
    with pytest.raises(aot.AotLoadError) as e:
        aot.load_file(path)
    assert e.value.reason == "unreadable-header"
    assert os.path.exists(path + ".bad") and not os.path.exists(path)


def _dead_pid() -> int:
    p = subprocess.Popen(["true"])
    p.wait()
    return p.pid


def test_file_lock_takes_over_a_dead_holder_and_an_aged_one(tmp_path):
    path = str(tmp_path / "x.lock")
    with open(path, "w") as fh:
        json.dump({"pid": _dead_pid(), "host": socket.gethostname(),
                   "t": time.time()}, fh)
    lock = aot.FileLock(path, stale_seconds=600)
    t0 = time.monotonic()
    assert lock.acquire(timeout=5)
    assert time.monotonic() - t0 < 2
    with open(path) as fh:
        assert json.load(fh)["pid"] == os.getpid()
    lock.release()
    assert not os.path.exists(path)

    # a live holder (the parent process) blocks ...
    with open(path, "w") as fh:
        json.dump({"pid": os.getppid(), "host": socket.gethostname(),
                   "t": time.time()}, fh)
    assert not aot.FileLock(path, stale_seconds=600).acquire(timeout=0.2)
    # ... until its lock outlives stale_seconds
    old = time.time() - 120
    os.utime(path, (old, old))
    lock = aot.FileLock(path, stale_seconds=60)
    assert lock.acquire(timeout=5)
    lock.release()


def test_store_location_and_its_deprecated_alias(tmp_path, monkeypatch):
    assert aot.aot_dir() is None and not aot.enabled()
    monkeypatch.setenv("SKYLARK_EXEC_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(aot, "_alias_warned", False)
    with pytest.warns(DeprecationWarning, match="SKYLARK_AOT_DIR"):
        assert aot.aot_dir() == os.path.join(str(tmp_path), "aot")
    monkeypatch.setenv("SKYLARK_AOT_DIR", "off")
    assert aot.aot_dir() is None
    monkeypatch.setenv("SKYLARK_AOT_DIR", str(tmp_path / "store"))
    assert aot.aot_dir() == str(tmp_path / "store")
    with aot.override_dir(str(tmp_path / "pack")):
        assert aot.aot_dir() == str(tmp_path / "pack")
    assert aot.aot_dir() == str(tmp_path / "store")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        monkeypatch.setattr(compiled_mod, "_persist_warned", False)
        assert not engine.enable_persistent_cache(str(tmp_path))
    assert any("SKYLARK_AOT_DIR" in str(w.message) for w in caught)


def test_each_capture_writes_its_record_once(tmp_path, monkeypatch):
    store = tmp_path / "store"
    monkeypatch.setenv("SKYLARK_AOT_DIR", str(store))

    def body(A, B):
        return A @ B

    f = engine.compiled(body, name="test.matmul")
    A = torch.ones(4, 3)
    B = torch.ones(3, 2)
    f(A, B)
    f(A, B)
    files = sorted(os.listdir(store))
    assert len(files) == 1 and files[0].endswith(".skyaot")
    h = aot.read_header(str(store / files[0]))
    assert h["name"] == "test.matmul"
    key, rec, _ = aot.load_file(str(store / files[0]))
    assert rec["args"] == [((4, 3), "torch.float32", "cpu"),
                           ((3, 2), "torch.float32", "cpu")]
    assert key in engine.cache().keys()
    mtime = os.stat(store / files[0]).st_mtime_ns
    engine.reset()
    f(A, B)               # captured again: the record is there, kept
    assert os.stat(store / files[0]).st_mtime_ns == mtime
    assert sorted(os.listdir(store)) == files     # no .lock, no .tmp left


def test_a_capture_inside_loading_counts_as_a_load(tmp_path):
    f = engine.compiled(lambda A: A + 1, name="test.inc")
    A = torch.zeros(3)
    f(A)
    (key,) = engine.cache().keys()
    engine.reset()
    with compiled_mod.loading([key]):
        f(A)
    s = engine.stats()
    assert (s.aot_loads, s.misses, s.compiles, s.hits) == (1, 0, 0, 0)
    assert engine.cache().snapshot()[0]["loaded"]
    f(A)
    assert (engine.stats().hits, engine.stats().misses) == (1, 0)


# -- the kernel build's file locks: racing processes compile once ------------

_STUB = """#!/bin/sh
# a stand-in compiler: log the call, take a while, write the output
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  last="$1"
  shift
done
echo "$(basename "$last") $$" >> "{log}"
sleep 0.3
echo stub > "$out"
"""


def _race(csrc, build_dir, barrier):
    from pathlib import Path

    from libskylark_tpu_torch.kernels import build

    build.CSRC = Path(csrc)
    build.BUILD_DIR = Path(build_dir) / "torch_kernels"
    build.HOST_BUILD_DIR = Path(build_dir) / "torch_host"
    barrier.wait(timeout=30)
    build.build(["alpha", "beta"])
    build.build_host("gamma")


def test_racing_cold_processes_run_the_compiler_once_per_library(
        tmp_path, monkeypatch):
    csrc, bdir, bin_dir = (tmp_path / "csrc", tmp_path / "build",
                           tmp_path / "cuda" / "bin")
    for d in (csrc, bin_dir):
        d.mkdir(parents=True)
    for name in ("alpha.cu", "beta.cu", "gamma.cpp", "shared.cuh"):
        (csrc / name).write_text("// source\n")
    log = tmp_path / "calls.log"
    for exe in ("nvcc", "g++"):
        stub = bin_dir / exe
        stub.write_text(_STUB.format(log=log))
        stub.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    ctx = multiprocessing.get_context("fork")
    barrier = ctx.Barrier(3)
    with warnings.catch_warnings():
        # forking a threaded test process: the children run only the
        # build's file and subprocess calls
        warnings.simplefilter("ignore", DeprecationWarning)
        procs = [ctx.Process(target=_race, args=(csrc, bdir, barrier))
                 for _ in range(3)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    calls = sorted(line.split()[0] for line in log.read_text().splitlines())
    assert calls == ["alpha.cu", "beta.cu", "gamma.cpp"]
    for lib in ("torch_kernels/libalpha.so", "torch_kernels/libbeta.so",
                "torch_host/libgamma.so"):
        assert (bdir / lib).read_text() == "stub\n"
    assert not list(bdir.rglob("*.lock"))
