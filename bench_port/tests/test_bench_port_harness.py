"""The harness end to end on the CPU at small sizes (the card's look
skipped), with the port broken underneath, the data-driven lookup, the
trace reader and the import guard."""

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench_port import devtrace, harness, spec
from bench_port.run import forbidden_modules
from multigridanisotropicdiffusion_tpu_torch.models import ved as ved_mod

ROOT = Path(__file__).resolve().parents[2]
SMALL = [24, 20, 18]


def _small(name, root=ROOT, **traffic):
    cell = spec.load_cell(name, root)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, shape=SMALL, warmup_calls=1,
                                                  **traffic))


def _run(cell, trace=False, seed=2**33 + 7):
    # a traced window stops at its trace_calls well before 60 s
    return harness.run(cell, seed, 60.0 if trace else 0.2, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", ["mad512", "ved512", "ved512-gd"])
def test_a_sound_run_is_correct(workload):
    result = _run(_small(workload))
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    # no card here, so no allocator peak: every other end-to-end metric reads
    assert set(result["metrics"]) == {m["name"] for m in spec.load_cell(workload).end_to_end
                                      if m["name"] != "peak_gib"}
    assert all(v["value"] > 0 for k, v in result["metrics"].items() if k != "peak_gib")
    # set-up's parts add up to setup_s
    phases = result["setup_phases"]
    assert all(v >= 0 for v in phases.values()) and "warmup0" in phases
    assert abs(sum(phases.values()) - result["metrics"]["setup_s"]["value"]) < 1e-3


def test_benchmark_json_keeps_the_contracts_shape():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {c["name"]: c for c in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert name.match(c["name"]) and (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
    for c in cells.values():
        assert name.match(c["name"]) and name.match(c["traffic"]) and c["chips"] == 1
        assert 0 < len(c["why"]) <= 200
        cell = spec.load_cell(c["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in bench["end_to_end"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_the_same_seed_makes_the_same_inputs():
    from bench_port.inputs import WINDOW, Inputs

    cell = _small("mad512")
    a, b = Inputs(cell.traffic, "cpu"), Inputs(cell.traffic, "cpu")
    x, y = a.make(2**40 + 3, WINDOW, 5), b.make(2**40 + 3, WINDOW, 5)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(x["image"], a.make(2**40 + 3, WINDOW, 6)["image"])


def _unchanged_solve(image, tensor, *args, **kwargs):
    import multigridanisotropicdiffusion_tpu_torch as madt

    res = madt.models.mad.mad_diffusion(image, tensor, *args, **kwargs)
    return res._replace(output=torch.as_tensor(image).to(res.output))


def test_a_solve_that_returns_its_state_unchanged_is_caught(monkeypatch):
    import multigridanisotropicdiffusion_tpu_torch as madt

    monkeypatch.setattr(madt, "mad_diffusion", _unchanged_solve)
    assert not _run(_small("mad512"))["correct"]
    monkeypatch.setattr(ved_mod, "mad_diffusion", _unchanged_solve)
    assert not _run(_small("ved512"))["correct"]


@pytest.mark.parametrize("workload", ["mad512", "ved512"])
def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch, workload):
    import multigridanisotropicdiffusion_tpu_torch as madt

    entry = "ved" if workload.startswith("ved") else "mad_diffusion"
    real = getattr(madt, entry)

    def shifted(*args, **kwargs):  # an off-by-one in the output's x index
        res = real(*args, **kwargs)
        return res._replace(output=torch.roll(res.output, 1, dims=-1))

    monkeypatch.setattr(madt, entry, shifted)
    assert not _run(_small(workload))["correct"]


def test_a_pipeline_that_drops_the_tensor_is_caught(monkeypatch):
    real = ved_mod.fused_vesselness_tensor

    def identity_tensor(*args, **kwargs):
        resp, t = real(*args, **kwargs)
        t = torch.zeros_like(t)
        t[0] = t[3] = t[5] = 1.0
        return resp, t

    monkeypatch.setattr(ved_mod, "fused_vesselness_tensor", identity_tensor)
    assert not _run(_small("ved512"))["correct"]


def test_a_traced_run_on_the_cpu_reads_the_cycles_and_restores_the_port():
    before = ved_mod.fused_vesselness_tensor
    result = _run(_small("ved512", trace_calls=2), trace=True)
    assert ved_mod.fused_vesselness_tensor is before
    assert result["correct"] and result["attempted"] == 2
    assert result["metrics"]["mad.cycles"]["value"] >= 1
    # no device here: the readers of device time find nothing and are left out
    assert "device.idle_pct" not in result["metrics"]


def test_a_new_cell_and_metric_are_found_from_added_files(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*") if p.is_file()}
    traffic = json.loads((tmp_path / "bench_port/workloads/mad512.json").read_text())
    traffic.update(shape=[20, 22, 24], trace_calls=2)
    (tmp_path / "bench_port/workloads/mad-small.json").write_text(json.dumps(traffic))
    (tmp_path / "bench_port/metrics/mad.steps.py").write_text(
        "def read(ctx):\n    return sum(len(c['num_cycles']) for c in ctx.calls)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mad-small", "config": "mad-dca", "traffic": "mad-small",
                               "chips": 1, "why": "a small cell added by files alone"})
    bench["per_layer"].append({"name": "mad.steps", "unit": "steps", "better": "lower",
                               "source": "program_counter", "layer": "solve loop",
                               "moves": "call_ms", "workloads": ["mad-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("mad-small", tmp_path)
    assert cell.traffic["shape"] == [20, 22, 24]
    assert [m["name"] for m in cell.per_layer] == ["mad.steps"]
    result = harness.run(dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_calls=1)),
                         5, 60.0, True, "cpu", time.perf_counter())
    assert result["correct"]
    assert result["metrics"] == {"mad.steps": {"value": 2.0, "unit": "steps"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed


def test_the_import_guard_compares_whole_top_level_names():
    assert forbidden_modules({"jax.numpy": 1, "numpy": 1}) == ["jax"]
    assert forbidden_modules({"multigridanisotropicdiffusion_tpu.core.grids": 1}) == [
        "multigridanisotropicdiffusion_tpu"]
    assert forbidden_modules({"multigridanisotropicdiffusion_tpu_torch.models": 1,
                              "jaxtyping": 1, "flax_like": 1}) == []


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import bench_port.harness, bench_port.calibrate;"
            " from bench_port.run import forbidden_modules;"
            " import torch; sys.exit(1 if forbidden_modules() else 0)" % str(ROOT))
    assert subprocess.run([sys.executable, "-c", code], timeout=120).returncode == 0


@pytest.mark.parametrize("with_port", [True, False])
def test_no_result_without_a_card(tmp_path, with_port):
    """Here there is no card: the run exits non-zero and prints no result,
    also from a directory holding only the benchmark's files."""
    root = ROOT
    if not with_port:
        shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        root = tmp_path
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "mad512",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


def test_the_trace_reader_attributes_device_time_to_the_launching_range():
    ev = [
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
    w = devtrace.summarize(ev)
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s == pytest.approx((20 + 10 + 13) * 1e-6)  # the union, not the sum 50
    assert w.device_s == [pytest.approx({"bench.pipeline": 20e-6, "bench.setup": 10e-6,
                                         "bench.solve": 13e-6})]
    assert w.wall_s == [pytest.approx({"bench.pipeline": 30e-6, "bench.solve": 70e-6,
                                       "bench.setup": 20e-6})]
    assert dict(w.device_ops) == pytest.approx({"stencil_kernel": 20e-6,
                                                "fd_vesselness_kernel": 20e-6,
                                                "assemble_kernel": 10e-6})
    gaps = dict(w.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(25e-6)  # 75 .. 100
    assert sum(gaps.values()) == pytest.approx((100 - 43) * 1e-6)


def test_the_roofline_reader_stays_under_its_bound():
    from types import SimpleNamespace

    read = spec.metric_reader("kernels.solve_roofline")
    cell = spec.load_cell("mad512")
    cfg = harness.drive.Port(cell.config, cell.traffic, "cpu").mad_config
    calls = [{"num_cycles": [3], "histories": [[5.7e-3, 4.1e-5, 5.3e-7] + [0.0] * 97]}]
    from bench_port import workcount as wc

    least = wc.step_seconds((512,) * 3, 2, wc.PLANES_3D, [2, 2, 2], 4)
    win = SimpleNamespace(device_s=[{"bench.solve": least * 5}], wall_s=[], busy_s=1, window_s=2)
    ctx = harness.Context(cell=cell, mad_config=cfg, times=[], setup_s=1.0, peak_bytes=0,
                          calls=calls, window=win)
    assert read(ctx) == pytest.approx(20.0)
    assert read(dataclasses.replace(ctx, window=None)) is None
