"""The ``galerkin512-exact`` cell: found from its own files, run end to end
on the CPU at a small size, and its two readers on a synthetic trace."""

import dataclasses
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench_port import devtrace, drive, harness, portspans, spec, workcount
from bench_port import workcount_galerkin as wg

ROOT = Path(__file__).resolve().parents[2]
CELL = "galerkin512-exact"
NEW = ("kernels.galerkin_roofline", "kernels.exact_stored_roofline")
B16 = ("void (anonymous namespace)::galerkin_product_kernel<float, 5, 5, 1, 4, 0>"
       "(float const*, float*, int, int, int, int, int, int, int const*, float const*, int, "
       "(anonymous namespace)::Params)")
B12 = ("void mad::tile::tile_kernel<__nv_bfloat16, 1, 1, false, true, "
       "mad::stored::Taps<__nv_bfloat16, 124> >(...)")
B1 = ("void mad::tile::tile_kernel<__nv_bfloat16, 1, 1, false, true, "
      "(anonymous namespace)::Compressed<__nv_bfloat16, false> >(...)")


def test_the_cell_is_found_from_its_own_files(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = {"configs": [c for c in bench["configs"] if c["name"] == "mad-galerkin-exact"],
            "workloads": [w for w in bench["workloads"] if w["name"] == CELL],
            "per_layer": [m for m in bench["per_layer"] if m["name"] in NEW]}
    assert [len(v) for v in mine.values()] == [1, 1, 2]
    assert all(m["workloads"] == [CELL] for m in mine["per_layer"])
    # no accepted entry lists the new cell
    assert all(CELL not in m.get("workloads", []) for m in bench["per_layer"] + bench["end_to_end"]
               if m["name"] not in NEW)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({**bench, **mine}))
    for rel in ["bench_port/configs/mad-galerkin-exact.json", f"bench_port/workloads/{CELL}.json",
                *(f"bench_port/metrics/{m}.py" for m in NEW)]:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, tmp_path / rel)
    cell = spec.load_cell(CELL, tmp_path)
    assert cell.chips == 1 and cell.traffic["shape"] == [512, 512, 512]
    assert cell.traffic["inputs"] == {"kind": "spd_tensor", "rhs_high": 255.0}
    assert (cell.traffic["warmup_calls"], cell.traffic["trace_calls"]) == (2, 4)
    assert cell.config["entry"] == "mad_diffusion" and cell.config["reduced"] == []
    assert cell.config["control"]["reference_dtype"] == "bfloat16"
    assert {k: cell.config["settings"][k] for k in (
        "coarse_operator", "galerkin_variant", "galerkin_prune_tol")} == {
        "coarse_operator": "galerkin", "galerkin_variant": "exact", "galerkin_prune_tol": 0.0}
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    assert {m["name"] for m in cell.end_to_end} == {"call_ms", "peak_gib", "setup_s"}
    assert all(callable(spec.metric_reader(m, tmp_path)) for m in NEW)
    cfg = drive.Port(cell.config, cell.traffic, "cpu").mad_config
    assert (cfg.coarse_operator, cfg.galerkin_variant, cfg.operator_repr, cfg.use_kernels,
            cfg.defect_dtype) == ("galerkin", "exact", "compressed", True, "bfloat16")


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    cell = spec.load_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, shape=[24, 24, 20],
                                                  warmup_calls=1))
    result = harness.run(cell, 2**33 + 13, 60.0 if trace else 0.2, trace, "cpu",
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


def _trace():
    """Two calls [0, 100] and [100, 200]: each with B16 [10, 30] and [30, 35],
    then B12 [50, 60], B1 [60, 70] and B12 again [80, 85]."""
    events = [_x("user_annotation", "bench.window", 0, 200)]
    k = 0
    for c in (0, 100):
        events += [_x("user_annotation", "bench.call", c, 100),
                   _x("user_annotation", "bench.solve", c, 100)]
        for t, name, a, d in [(9, B16, 10, 20), (29, B16, 30, 5), (49, B12, 50, 10),
                              (59, B1, 60, 10), (79, B12, 80, 5)]:
            events += [_x("cuda_runtime", "cudaLaunchKernel", c + t, 0.5, correlation=k),
                       {**_x("kernel", name, c + a, d, correlation=k), "tid": 7}]
            k += 1
    return events


HIST = [5.7e-3, 4.1e-5, 5.3e-7] + [0.0] * 97


def _ctx(events, **config):
    cell = spec.load_cell(CELL)
    cfg = drive.Port(cell.config, cell.traffic, "cpu", config).mad_config
    return harness.Context(cell=cell, mad_config=cfg, times=[], setup_s=1.0, peak_bytes=0,
                           calls=[{"num_cycles": [3], "histories": [HIST]}] * 2,
                           window=devtrace.summarize(events))


def _fake_profiler(monkeypatch, events):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(portspans, "trace_events", lambda p: events if p is prof else [])
    return prof


def test_the_readers_read_b16_and_b12(monkeypatch):
    events = _trace()
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841 (found in this frame)
    got = {name: spec.metric_reader(name)(_ctx(events)) for name in NEW}
    shape = (512,) * 3
    setup = wg.setup_seconds(shape, "exact", 4)
    solve = wg.exact_step_seconds(shape, 2, workcount.cycle_bytes(HIST, 3, 1e-6, 2000.0, 4, 2))
    assert got == pytest.approx({
        "kernels.galerkin_roofline": 100.0 * 2 * setup / 50e-6,  # B16: 2 x (20 + 5) us
        "kernels.exact_stored_roofline": 100.0 * 2 * solve / 30e-6})  # B12: 2 x (10 + 5) us


def test_the_readers_find_nothing_without_a_trace_or_elsewhere(monkeypatch):
    events = _trace()
    ctx = _ctx(events)
    for name in NEW:  # no profiler among the callers
        assert spec.metric_reader(name)(ctx) is None, name
    prof = _fake_profiler(monkeypatch, events)  # noqa: F841
    for name in NEW:
        assert spec.metric_reader(name)(dataclasses.replace(ctx, window=None)) is None, name
        assert spec.metric_reader(name)(_ctx(events, coarse_operator="dca")) is None, name
        assert spec.metric_reader(name)(_ctx(events, use_kernels=False)) is None, name
    # radius-2 counts hold for unpruned exact levels alone
    read = spec.metric_reader("kernels.exact_stored_roofline")
    assert read(_ctx(events, galerkin_variant="collapsed")) is None
    assert read(_ctx(events, galerkin_prune_tol=1e-3)) is None
    # B16's count follows the variant: a later cell may list galerkin512 too
    collapsed = spec.metric_reader("kernels.galerkin_roofline")(
        _ctx(events, galerkin_variant="collapsed"))
    assert collapsed == pytest.approx(
        100.0 * 2 * wg.setup_seconds((512,) * 3, "collapsed", 4) / 50e-6)
    odd = dataclasses.replace(ctx, cell=dataclasses.replace(
        ctx.cell, traffic=dict(ctx.cell.traffic, shape=[513, 512, 512])))
    for name in NEW:  # a vertex-centred level: not counted
        assert spec.metric_reader(name)(odd) is None, name
