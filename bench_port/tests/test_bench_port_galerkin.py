"""The ``galerkin512`` cell: found from its own files, run end to end on the
CPU at a small size, and its three readers on a synthetic trace (with and
without the port's ``madt.mad.setup.galerkin`` span)."""

import dataclasses
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench_port import devtrace, drive, harness, portspans, spec, workcount, workcount_stored
from multigridanisotropicdiffusion_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[2]
CELL = "galerkin512"
NEW = ("galerkin.setup_ms", "galerkin.setup_idle_ms", "kernels.stored_roofline")
B12 = "void mad::tile::tile_kernel<__nv_bfloat16, 1, 1, false, true, mad::stored::Taps<__nv_bfloat16, 26> >(...)"
B1 = "void mad::tile::tile_kernel<__nv_bfloat16, 1, 1, false, true, (anonymous namespace)::Compressed<__nv_bfloat16, false> >(...)"


def test_the_cell_is_found_from_its_own_files(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = {"configs": [c for c in bench["configs"] if c["name"] == "mad-galerkin"],
            "workloads": [w for w in bench["workloads"] if w["name"] == CELL],
            "per_layer": [m for m in bench["per_layer"] if m["name"] in NEW]}
    assert [len(v) for v in mine.values()] == [1, 1, 3]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({**bench, **mine}))
    for rel in ["bench_port/configs/mad-galerkin.json", f"bench_port/workloads/{CELL}.json",
                *(f"bench_port/metrics/{m}.py" for m in NEW)]:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, tmp_path / rel)
    cell = spec.load_cell(CELL, tmp_path)
    assert cell.chips == 1 and cell.traffic["shape"] == [512, 512, 512]
    assert cell.config["entry"] == "mad_diffusion" and cell.config["reduced"] == []
    assert {k: cell.config["settings"][k] for k in ("coarse_operator", "galerkin_variant")} == {
        "coarse_operator": "galerkin", "galerkin_variant": "collapsed"}
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    assert {m["name"] for m in cell.end_to_end} == {"call_ms", "peak_gib", "setup_s"}
    assert all(callable(spec.metric_reader(m, tmp_path)) for m in NEW)
    cfg = drive.Port(cell.config, cell.traffic, "cpu").mad_config
    assert (cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels, cfg.defect_dtype) == (
        "galerkin", "compressed", True, "bfloat16")


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    cell = spec.load_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, shape=[24, 24, 20],
                                                  warmup_calls=1))
    result = harness.run(cell, 2**33 + 11, 60.0 if trace else 0.2, trace, "cpu",
                         time.perf_counter())
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"output_rel_l2", "output_relres"}
    if not trace:  # no card here: no allocator peak
        assert set(result["metrics"]) == {"call_ms", "setup_s"}
    else:  # nor a device trace: the readers find nothing and say so
        assert result["attempted"] == cell.traffic["trace_calls"] and not result["metrics"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


def _trace(spans=True):
    """One call [0, 100]: two Galerkin products [10, 30] and [30, 40] (their
    device work [12, 28] and [34, 40]), then B12 [50, 60], B1 [60, 70] and
    B12 again [80, 85] in the solve."""
    events = [
        _x("user_annotation", "bench.window", 0, 100),
        _x("user_annotation", "bench.call", 0, 100),
        _x("user_annotation", "bench.solve", 0, 100),
        _x("user_annotation", "bench.setup", 5, 40),
    ]
    if spans:
        events += [_x("user_annotation", P.MAD_SETUP, 6, 38),
                   _x("user_annotation", P.MAD_GALERKIN, 10, 20),
                   _x("user_annotation", P.MAD_GALERKIN, 30, 10)]
    for k, (t, name, a, d) in enumerate([(11, "mul", 12, 16), (31, "add", 34, 6),
                                         (49, B12, 50, 10), (59, B1, 60, 10),
                                         (79, B12, 80, 5)]):
        events += [_x("cuda_runtime", "cudaLaunchKernel", t, 0.5, correlation=k),
                   {**_x("kernel", name, a, d, correlation=k), "tid": 7}]
    return events


def _ctx(events):
    cell = spec.load_cell(CELL)
    cfg = drive.Port(cell.config, cell.traffic, "cpu").mad_config
    hist = [5.7e-3, 4.1e-5, 5.3e-7] + [0.0] * 97
    return harness.Context(cell=cell, mad_config=cfg, times=[], setup_s=1.0, peak_bytes=0,
                           calls=[{"num_cycles": [3], "histories": [hist]}],
                           window=devtrace.summarize(events))


def _fake_profiler(monkeypatch, events):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(portspans, "trace_events", lambda p: events if p is prof else [])
    return prof


def test_the_readers_read_the_span_and_b12(monkeypatch):
    events = _trace()
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841 (found in this frame)
    got = {name: spec.metric_reader(name)(_ctx(events)) for name in NEW}
    least = workcount_stored.step_seconds((512,) * 3, 2, 27, workcount.cycle_bytes(
        [5.7e-3, 4.1e-5, 5.3e-7], 3, 1e-6, 2000.0, 4, 2))
    assert got == pytest.approx({
        "galerkin.setup_ms": 22e-3,  # [12, 28] and [34, 40]
        "galerkin.setup_idle_ms": 8e-3,  # [10, 12], [28, 30] and [30, 34]
        "kernels.stored_roofline": 100.0 * least / 15e-6})  # B12 alone: 10 + 5 us


def test_the_readers_find_nothing_without_the_span_or_a_trace(monkeypatch):
    events = _trace(spans=False)
    ctx = _ctx(events)
    for name in NEW:  # no profiler among the callers
        assert spec.metric_reader(name)(ctx) is None, name
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841 (a port without the span)
    assert spec.metric_reader("galerkin.setup_ms")(ctx) is None
    assert spec.metric_reader("galerkin.setup_idle_ms")(ctx) is None
    assert spec.metric_reader("kernels.stored_roofline")(ctx) > 0  # B12 needs no span
    for name in NEW:
        assert spec.metric_reader(name)(dataclasses.replace(ctx, window=None)) is None, name


def test_the_roofline_reads_nothing_for_dca_levels(monkeypatch):
    events = _trace()
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841
    ctx = _ctx(events)
    dca = dataclasses.replace(ctx, mad_config=dataclasses.replace(ctx.mad_config,
                                                                  coarse_operator="dca"))
    assert spec.metric_reader("kernels.stored_roofline")(dca) is None
