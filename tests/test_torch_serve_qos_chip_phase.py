"""chip_smoke.py's serve-qos phase rehearsed on the CPU at a small size:
the same cache storm, residency, deadline, DEGRADED, QoS, controller and
profiled-flush steps and checks as on the card, with every kernel on its
plain version (CPU tensors), so the phase launches nothing. The checks
that name the card's launches take the CPU's (none).

Small size: the solve bucket at 2,048 × 16 (s = 64), a storm of 24 from
4 threads, 4 submits by reference, the dense-rw bucket at 33–64 × 256 →
32 on 4 operands, a deadline of 0.5 ms, 16 requests a tenant queued
behind a flush held 0.3 s at its fault site (a CPU flush is short), and
16 under the controller.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import libskylark_tpu_torch as P
from libskylark_tpu_torch.base import locks


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serve_qos_phase_holds_on_the_cpu(chip_smoke):
    size = dict(chip_smoke.QOS_FULL, ls_rows=2048, ls_cols=16, ls_s=64,
                storm=24, storm_threads=4, ref_requests=4, rw_rows=(33, 65),
                rw_n=256, rw_s=32, rw_operands=4, deadline_s=0.0005,
                qos_requests=16, adaptive_requests=16, hold_s=0.3)
    out = chip_smoke.serve_qos_phase(torch, P, np, size=size, device="cpu")
    storm = out["storm"]
    assert storm["flushes"] == 1 and storm["completed"] == size["storm"]
    assert storm["hits"] + storm["coalesced"] == size["storm"] - 1
    assert out["residency"]["a_bytes_shipped"] == 0
    assert out["deadlines"]["expired"] == size["deadline_requests"]
    assert [tuple(t) for t in out["degraded"]["transitions"]] == [
        ("SERVING", "DEGRADED"), ("DEGRADED", "SERVING")]
    assert out["degraded"]["shed"] == 2
    waits = out["qos"]["by_class"]
    assert (waits["interactive"]["queue_wait_mean_ms"]
            <= waits["best_effort"]["queue_wait_mean_ms"])
    assert out["qos"]["rate_limited"] == size["rate_requests"] - size["burst"]
    assert out["adaptive"]["controller"]["ticks"] >= 1
    assert "aten::mm" in out["profiled_flush"]["enclosed"]
    assert not any(out["launches"].values())
    assert not locks.witness_enabled()


def _small(cs):
    return dict(cs.QOS_FULL, ls_rows=1024, ls_cols=8, ls_s=32, storm=8,
                storm_threads=2, ref_requests=2, rw_rows=(9, 17), rw_n=64,
                rw_s=16, rw_operands=2, deadline_s=0.0005, qos_requests=8,
                rate_requests=6, adaptive_requests=8, hold_s=0.1)


def test_the_phase_fails_on_a_lock_inversion(chip_smoke, monkeypatch):
    """Two of the phase's locks taken in both orders while the witness is
    on: the phase's closing check_witness raises, and the witness is off
    again after."""
    flush_checks = chip_smoke.profiled_flush_checks

    def with_inversion(*args):
        a, b = locks.make_lock("x.a"), locks.make_lock("x.b")
        with a, b:
            pass
        with b, a:
            pass
        return flush_checks(*args)

    monkeypatch.setattr(chip_smoke, "profiled_flush_checks", with_inversion)
    with pytest.raises(locks.LockOrderError):
        chip_smoke.serve_qos_phase(torch, P, np, size=_small(chip_smoke),
                                   device="cpu")
    assert not locks.witness_enabled()


def test_the_phase_fails_when_a_storm_flushes_twice(chip_smoke,
                                                    monkeypatch):
    """With single-flight defeated (every claim leads), the storm's one-
    flush check fails the phase."""
    from libskylark_tpu_torch.engine import resultcache

    def always_lead(self, key, cls, leader):
        return "lead", self.lead_flight(key, cls, leader)

    monkeypatch.setattr(resultcache.ResultCache, "claim", always_lead)
    with pytest.raises(RuntimeError, match="cache storm"):
        chip_smoke.serve_qos_phase(torch, P, np, size=_small(chip_smoke),
                                   device="cpu")


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device, start, end, id=0):
        self.name, self.device_type, self.id = name, device, id
        self.time_range = _Range(start, end)


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _card_trace(launch_at, kernels=True):
    """A profiled flush's trace on the card: the host's serve.flush range
    [100, 900] µs, one launch record at ``launch_at``, and its kernel at
    device timestamps past the host range (the two clocks are never
    compared), inside the device-side annotation."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("serve.flush", cpu, 100.0, 900.0),
              _Event("cudaLaunchKernel", cpu, launch_at, launch_at + 5.0,
                     id=7)]
    if kernels:
        events += [_Event("serve.flush", gpu, 2000.0, 2600.0),
                   _Event("dense_tc_kernel", gpu, 2100.0, 2500.0, id=7)]
    return _Trace(events)


def test_profiled_flush_checks_match_kernels_to_their_launches(chip_smoke):
    out = chip_smoke.profiled_flush_checks(torch, _card_trace(400.0), "cuda")
    assert out["enclosed"] == ["dense_tc_kernel"]
    assert out["range_us"] == 800.0 and out["device_range_us"] == 600.0


def test_profiled_flush_checks_match_a_replays_kernels_to_its_graph(
        chip_smoke):
    """A replayed flush: both kernels carry the graph launch's correlation
    id, each inside its own device-side annotation."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    trace = _Trace([_Event("serve.flush", cpu, 100.0, 900.0),
                    _Event("cudaGraphLaunch", cpu, 400.0, 420.0, id=9),
                    _Event("serve.flush", gpu, 2000.0, 2100.0),
                    _Event("dense_gen_kernel", gpu, 2010.0, 2090.0, id=9),
                    _Event("serve.flush", gpu, 2150.0, 2600.0),
                    _Event("dense_tc_kernel", gpu, 2160.0, 2590.0, id=9)])
    out = chip_smoke.profiled_flush_checks(torch, trace, "cuda")
    assert out["enclosed"] == ["dense_gen_kernel", "dense_tc_kernel"]
    assert out["launch_records"] == ["cudaGraphLaunch"]
    assert out["device_annotations"] == 2
    assert out["device_range_us"] == 600.0


@pytest.mark.parametrize("launch_at, kernels, match", [
    (950.0, True, "encloses the launches of 0 of the flush's 1"),
    (400.0, False, "holds 0 B1 kernels"),
])
def test_profiled_flush_checks_fail_on_the_card(chip_smoke, launch_at,
                                                kernels, match):
    """A launch outside the host's range, or a trace without the flush's
    kernels, fails the check."""
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.profiled_flush_checks(
            torch, _card_trace(launch_at, kernels), "cuda")
