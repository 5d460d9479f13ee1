"""Environment knobs the reference reads (ROADMAP C25, C26), each in a
fresh process with the variable set, on the CPU.

- C25: ``SKYLARK_AUTO_MATERIALIZE=0`` is read at import, as the reference
  reads it: both packages' ``get_auto_materialize()`` are False, and the
  port's third plain-route apply of a CWT (``get_auto_materialize_after()``
  = 3) pins no operator, where it pins one with the knob unset.
- C26: ``SKYLARK_FWHT_MIN_N``, ``SKYLARK_HASH_KERNEL``,
  ``SKYLARK_FASTFOOD_PRECISION`` and ``SKYLARK_MATMUL_PRECISION`` are
  recorded departures: set to values that route the reference off its
  kernels or change its precision, they change nothing in the port. An
  SRHT bucket of n = 4096 still qualifies for B5, float32 matmuls stay
  true f32 with TF32 off, and a CWT, an SRHT-sketched FJLT and a Fastfood
  map give the same bits as in a process without the knobs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env: dict) -> dict:
    """The last stdout line of ``code`` run in a fresh interpreter, as
    JSON; ``env`` sets variables, and a value of None unsets one."""
    full = dict(os.environ, JAX_PLATFORMS="cpu")
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_C25 = """
import json, torch
import libskylark_tpu.sketch.params as rp
from libskylark_tpu_torch.sketch import params as pp
from libskylark_tpu_torch.base.context import Context
from libskylark_tpu_torch.sketch import JLT, ROWWISE
A = torch.arange(32 * 64, dtype=torch.float64).reshape(32, 64) / 100
T = JLT(64, 16, Context(seed=1))
for _ in range(pp.get_auto_materialize_after()):
    T.apply(A, ROWWISE, device="cpu")
print(json.dumps({"ref": rp.get_auto_materialize(),
                  "port": pp.get_auto_materialize(),
                  "after": pp.get_auto_materialize_after(),
                  "pinned": T._op_cache is not None}))
"""


def test_c25_auto_materialize_is_read_at_import():
    """A float64 JLT takes the plain route, whose third apply pins the
    operator unless the knob is 0; this process runs with the knob
    unset."""
    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.sketch import JLT, ROWWISE
    from libskylark_tpu_torch.sketch import params as pp

    off = _run(_C25, {"SKYLARK_AUTO_MATERIALIZE": "0"})
    assert off == {"ref": False, "port": False, "after": 3, "pinned": False}
    assert os.environ.get("SKYLARK_AUTO_MATERIALIZE") is None
    assert pp.get_auto_materialize() and pp.get_auto_materialize_after() == 3
    A = torch.arange(32 * 64, dtype=torch.float64).reshape(32, 64) / 100
    T = JLT(64, 16, Context(seed=1))
    for _ in range(3):
        T.apply(A, ROWWISE, device="cpu")
    assert T._op_cache is not None


def _c26_facts() -> dict:
    """What the C26 knobs would move in the reference: the SRHT serve
    route at n = 4096, the float32 matmul precision and TF32, and the
    bits of a CWT, an FJLT (wht) and a Fastfood map on the CPU."""
    import hashlib

    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.engine.serve import qualify
    from libskylark_tpu_torch.sketch import CWT, FJLT, ROWWISE
    from libskylark_tpu_torch.sketch.frft import FastGaussianRFT

    A = (torch.arange(16 * 256, dtype=torch.float32).reshape(16, 256)
         % 7) / 4
    outs = [CWT(256, 32, Context(seed=2)).apply(A, ROWWISE, device="cpu"),
            FJLT(256, 32, Context(seed=3), fut="wht").apply(
                A, ROWWISE, device="cpu"),
            FastGaussianRFT(256, 256, Context(seed=4), 8.0).apply(
                A, ROWWISE, device="cpu")]
    ok, _ = qualify({"dtype": "float32", "s_dim": 256,
                     "endpoint": "sketch_apply", "family": "SRHT",
                     "padded": (16, 4096), "rowwise": True})
    return {"srht_4096": ok,
            "precision": torch.get_float32_matmul_precision(),
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "bits": hashlib.sha256(b"".join(
                o.numpy().tobytes() for o in outs)).hexdigest()}


def test_c26_the_reference_knobs_change_nothing_in_the_port():
    """The knobs set in a fresh process; this process, with them unset,
    computes the same."""
    knobs = {"SKYLARK_FWHT_MIN_N": "8192", "SKYLARK_HASH_KERNEL": "xla",
             "SKYLARK_FASTFOOD_PRECISION": "bf16",
             "SKYLARK_MATMUL_PRECISION": "default"}
    assert not [k for k in knobs if os.environ.get(k) is not None]
    got = _run("import json, sys; sys.path.insert(0, 'tests'); "
               "from test_torch_env_knobs import _c26_facts; "
               "print(json.dumps(_c26_facts()))", knobs)
    base = _c26_facts()
    assert got["srht_4096"] is True and base["srht_4096"] is True
    assert got["precision"] == base["precision"] == "highest"
    assert got["tf32"] is False and base["tf32"] is False
    assert got["bits"] == base["bits"]
