"""The reader of the port's spans (``bench_port/portspans.py``) and its four
metrics, on a synthetic trace: the trace of the trace reader's own test with
the port's ``madt.*`` ranges added, then on a CPU profile of a small solve.
The accepted readers read the same with and without the port's ranges."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port import devtrace, drive, harness, portspans, spec
from multigridanisotropicdiffusion_tpu_torch.models.mad import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.utils import profiling as P

NEW = ("mad.cast_ms", "mad.hi_cycles", "mad.loop_idle_ms", "ved.pipeline_idle_ms")
OLD = ("ved.pipeline_ms", "mad.setup_ms", "mad.cycles", "kernels.solve_roofline",
       "device.idle_pct")


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


def _bench_trace():
    """``test_the_trace_reader_attributes_device_time_to_the_launching_range``'s
    trace: busy [10, 30], [40, 50], [62, 75]; gaps [0, 10], [30, 40],
    [50, 62], [75, 100]."""
    return [
        _x("user_annotation", "bench.window", 0, 100),
        _x("user_annotation", "bench.call", 0, 100),
        _x("user_annotation", "bench.pipeline", 0, 30),
        _x("user_annotation", "bench.solve", 30, 70),
        _x("user_annotation", "bench.setup", 30, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=4),
        _x("cpu_op", "aten::item", 75, 20),
        {**_x("kernel", "fd_vesselness_kernel", 10, 20, correlation=1), "tid": 7},
        {**_x("kernel", "assemble_kernel", 40, 10, correlation=2), "tid": 7},
        {**_x("kernel", "stencil_kernel", 62, 10, correlation=3), "tid": 7},
        {**_x("kernel", "stencil_kernel", 65, 10, correlation=4), "tid": 8},  # a side stream
    ]


def _port_ranges(hi=True):
    """The port's ranges over that call; the pipeline's end (32) and the
    cycles' boundary (60.5) split the gaps [30, 40] and [50, 62]."""
    cycles = ([_x("user_annotation", P.MAD_CYCLE_LO, 59, 1.5),
               _x("user_annotation", P.MAD_CYCLE_HI, 60.5, 1.5)] if hi
              else [_x("user_annotation", P.MAD_CYCLE_LO, 59, 3)])
    return [
        _x("user_annotation", P.VED, 0, 100),
        _x("user_annotation", P.VED_PIPELINE, 0, 32),
        _x("user_annotation", P.MAD, 32.5, 67),
        _x("user_annotation", P.MAD_SETUP, 33, 19),
        _x("user_annotation", P.MAD_STEP, 55, 43),
        _x("user_annotation", P.MAD_CAST, 56, 2),
        *cycles,
        _x("user_annotation", P.MAD_SYNC, 74, 22),
    ]


def _ctx(window, calls=((3,),)):
    cell = spec.load_cell("ved512")
    cfg = drive.Port(cell.config, cell.traffic, "cpu").mad_config
    hist = [5.7e-3, 4.1e-5, 5.3e-7] + [0.0] * 97
    return harness.Context(cell=cell, mad_config=cfg, times=[], setup_s=1.0, peak_bytes=0,
                           calls=[{"num_cycles": list(c), "histories": [hist] * len(c)}
                                  for c in calls], window=window)


def _fake_profiler(monkeypatch, events):
    """A profiler that was never started, whose events are ``events``."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(portspans, "trace_events", lambda p: events if p is prof else [])
    return prof


def test_the_port_ranges_leave_every_accepted_reading_as_it_was():
    before = devtrace.summarize(_bench_trace())
    after = devtrace.summarize(_bench_trace() + _port_ranges())
    for field in ("busy_s", "window_s", "device_s", "wall_s", "device_ops"):
        assert getattr(after, field) == getattr(before, field), field
    # the idle gaps are the same; the host range named for each may now be
    # one of the port's
    assert sum(s for _, s in after.idle_gaps) == pytest.approx(
        sum(s for _, s in before.idle_gaps))
    for name in OLD:
        read = spec.metric_reader(name)
        assert read(_ctx(after)) == read(_ctx(before)), name


def test_the_spans_device_idle_and_counts():
    (call,) = portspans.summarize(_bench_trace() + _port_ranges())
    us = 1e-6
    expect = {  # name: (count, host, device, idle), in us
        P.VED: (1, 100, 43, 57),
        P.VED_PIPELINE: (1, 32, 20, 12),  # the gap [30, 40] split at 32
        P.MAD: (1, 67, 23, 44),
        P.MAD_SETUP: (1, 19, 10, 9),
        P.MAD_STEP: (1, 43, 13, 30),  # launches 60 and 61: [62, 72] u [65, 75]
        P.MAD_CAST: (1, 2, 0, 2),
        P.MAD_CYCLE_LO: (1, 1.5, 10, 1.5),
        P.MAD_CYCLE_HI: (1, 1.5, 10, 1.5),  # the gap [50, 62] split at 60.5
        P.MAD_SYNC: (1, 22, 0, 21),
    }
    assert set(call) == set(expect)
    for name, (count, host, device, idle) in expect.items():
        got = call[name]
        assert got.count == count, name
        assert (got.host_s, got.device_s, got.idle_s) == pytest.approx(
            (host * us, device * us, idle * us)), name


def test_the_readers_read_the_profiler_that_traced_the_window(monkeypatch):
    events = _bench_trace() + _port_ranges()
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841 (found in this frame)
    ctx = _ctx(devtrace.summarize(events))
    got = {name: spec.metric_reader(name)(ctx) for name in NEW}
    assert got == pytest.approx({"mad.cast_ms": 0.0, "mad.hi_cycles": 1.0,
                                 "mad.loop_idle_ms": 30e-3, "ved.pipeline_idle_ms": 12e-3})


def test_the_readers_find_nothing_without_the_ports_spans_or_a_trace(monkeypatch):
    ctx = _ctx(devtrace.summarize(_bench_trace()))
    for name in NEW:  # no profiler among the callers
        assert spec.metric_reader(name)(ctx) is None, name
    prof = _fake_profiler(monkeypatch, _bench_trace())  # noqa: F841 (a port without spans)
    for name in NEW:
        assert spec.metric_reader(name)(ctx) is None, name
        assert spec.metric_reader(name)(dataclasses.replace(ctx, window=None)) is None, name


def test_all_cycles_in_the_defect_dtype_read_zero_hi_cycles(monkeypatch):
    events = _bench_trace() + _port_ranges(hi=False)
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841
    assert spec.metric_reader("mad.hi_cycles")(_ctx(devtrace.summarize(events))) == 0.0


def test_a_cpu_profile_of_a_solve_is_read_after_the_harness_exported_it(tmp_path):
    g = np.random.default_rng(0)
    shape = (16, 16, 16)
    tensor = np.stack([np.full(shape, v) for v in (3.0, 0.5, 0.2, 2.5, 0.1, 2.0)])
    cfg = MADConfig(time_step=0.1, tolerance=1e-6, operator_repr="compressed",
                    defect_dtype="bfloat16", number_of_steps=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with drive.record_range(drive.WINDOW, True), drive.record_range(drive.CALL, True):
            res = mad_diffusion(g.uniform(0, 255, shape), tensor, config=cfg, device="cpu")
    prof.export_chrome_trace(str(tmp_path / "harness.json"))  # the harness's own export
    ctx = SimpleNamespace(window=devtrace.read(str(tmp_path / "harness.json")))
    # the events behind the export: the same ranges, on a clock shifted by a constant
    exported = sorted((e["ts"], e["dur"], e["name"]) for e in json.loads(
        (tmp_path / "harness.json").read_text())["traceEvents"]
        if e.get("cat") == "user_annotation")
    read = sorted((e["ts"], e["dur"], e["name"]) for e in portspans.trace_events(prof)
                  if e["cat"] == "user_annotation")
    assert [(d, n) for _, d, n in read] == pytest.approx([(d, n) for _, d, n in exported],
                                                         abs=1e-3)
    shift = {round(a[0] - b[0], 3) for a, b in zip(exported, read)}
    assert max(shift) - min(shift) <= 2e-3
    (call,) = portspans.per_call(ctx)
    assert call[P.MAD_STEP].count == 2 and call[P.MAD_CAST].count == 2
    cycles = call[P.MAD_CYCLE_LO].count + (call[P.MAD_CYCLE_HI].count
                                           if P.MAD_CYCLE_HI in call else 0)
    assert cycles == int(res.num_cycles.sum()) == call[P.MAD_SYNC].count
    assert all(s.device_s == 0.0 for s in call.values())  # no card, no device operations
    assert portspans.per_call(ctx) is portspans.per_call(ctx)  # exported once
