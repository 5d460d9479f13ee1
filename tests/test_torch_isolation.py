"""The port stands alone: importing ``libskylark_tpu_torch`` and every one
of its modules, or the chip scripts, loads neither ``jax`` nor the JAX
package ``libskylark_tpu``. Checked in a fresh interpreter, since this
test process itself imports both."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import libskylark_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke, chip_profile
print(json.dumps({{"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "libskylark_tpu"))}}))
"""


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_no_jax():
    out = _run(["-c", _IMPORT_ALL.format(root=str(ROOT))], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    for mod in ("base.threefry", "base.randgen", "base.context",
                "sketch.cuda_dense", "sketch.dense", "sketch.cuda_hash",
                "sketch.hash", "sketch.cuda_fwht", "sketch.fjlt", "sketch.fut",
                "kernels.build", "kernels.launch", "nla.svd",
                "nla.least_squares", "algorithms.regression",
                "algorithms.krylov", "algorithms.precond", "interop",
                "sketch.rft", "sketch.frft", "sketch.cuda_fastfood",
                "sketch.qrft", "sketch.ppt", "sketch.ust", "base.quasirand",
                "base.distance", "ml.kernels", "base.sparse", "io.libsvm",
                "engine.bucket", "engine.serve", "sketch.sparse_serve",
                "sketch.cuda_sparse", "base.sprand", "nla.condest",
                "io.native", "io.arclist", "algorithms.prox", "ml.coding",
                "ml.metrics", "ml.krr", "ml.rlsc", "ml.model", "ml.admm",
                "ml.nonlinear", "ml.modeling", "nla.lowrank",
                "telemetry.metrics", "utility.timer", "base.env",
                "base.locks", "telemetry.names", "telemetry.trace",
                "resilience", "resilience.policy", "resilience.faults",
                "resilience.health", "resilience.preemption", "qos",
                "qos.tenants", "qos.scheduler", "qos.controller",
                "engine.resultcache", "engine.cache", "engine.compiled",
                "telemetry.export", "utility.checkpoint", "io.chunked",
                "io.webhdfs", "io.streaming", "sessions",
                "sessions.journal", "sessions.state", "sessions.registry"):
        assert f"libskylark_tpu_torch.{mod}" in report["modules"]


def test_no_port_source_names_jax():
    for path in [*(ROOT / "libskylark_tpu_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]:
        for line in path.read_text().splitlines():
            words = line.replace(".", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1] not in ("jax", "libskylark_tpu"), (
                    f"{path}: {line}")


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
