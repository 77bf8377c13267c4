"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the output check.

Closed loop, one caller: call after call, each on fresh inputs made from
``(seed, call index)`` (:mod:`.inputs`) before its clock starts; a call's
clock runs from the entry to the synchronisation after it returns.  Set-up
is the process start to the first measured call: imports, the card's
context, the inputs' fixed part, the port's import and ``warmup_calls``
calls at the cell's shape (the first loads the kernels' library, built on
the first run in a checkout); ``setup_phases`` in the result gives each
part's seconds.  The window makes calls until
``seconds`` have passed (a traced window: until ``trace_calls`` calls or
``seconds``), and at least as many as the output check samples from.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import tempfile
import time
from typing import Callable, Dict, List

import torch

from . import check, devtrace, drive
from .inputs import WARMUP, WINDOW, Inputs
from .spec import Cell, metric_reader


@dataclasses.dataclass
class Context:
    """What a metric's reader (``bench_port/metrics/<name>.py``) reads."""

    cell: Cell
    #: the port's solver settings as it ran them (``MADConfig``)
    mad_config: object
    #: seconds of each call in the window
    times: List[float]
    setup_s: float
    #: the allocator's peak over the window, less the harness's resident
    #: inputs (:attr:`.inputs.Inputs.resident_bytes`)
    peak_bytes: int
    #: traced runs, per call: ``num_cycles`` (per step) and ``histories``
    #: (per step, the relative residual after each cycle)
    calls: List[Dict]
    #: traced runs on a card: the trace's window
    window: devtrace.Window | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_indices(seed: int, traffic: Dict, calls: int | None = None) -> List[int]:
    """The calls the output check compares, drawn from the seed among the
    window's first ``check.from_first`` (at most ``calls``)."""
    chk = traffic["check"]
    pool = int(chk["from_first"]) if calls is None else min(int(chk["from_first"]), calls)
    return sorted(random.Random(seed).sample(range(pool), int(chk["calls"])))


def _solve_info(res) -> Dict:
    return {"num_cycles": [int(k) for k in res.num_cycles.tolist()],
            "histories": res.residual_history.detach().cpu().tolist()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        marks: List | None = None) -> Dict:
    """The result line's object and the compared numbers with their limits.
    ``marks``: ``(name, time.perf_counter())`` pairs of the process's set-up
    before the call, after ``t_start``; with the harness's own they give
    ``setup_phases``, each phase's seconds."""
    device = torch.device(device)
    traffic = cell.traffic
    marks = [("start", t_start), *(marks or [])]
    _sync(device)
    marks.append(("context", time.perf_counter()))
    inputs = Inputs(traffic, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    port = drive.Port(cell.config, traffic, device)
    marks.append(("port", time.perf_counter()))
    for i in range(int(traffic["warmup_calls"])):
        out = port(inputs.make(seed, WARMUP, i))
        _sync(device)
        del out
        marks.append((f"warmup{i}", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    max_calls = int(traffic["trace_calls"]) if trace else None
    wanted = check_indices(seed, traffic, max_calls)
    kept, times, infos = {}, [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with contextlib.ExitStack() as stack:
        if trace:
            profiler = stack.enter_context(torch.profiler.profile(activities=_activities(device)))
            stack.enter_context(drive.spans(port))
        stack.enter_context(drive.record_range(drive.WINDOW, trace))
        t0 = time.perf_counter()
        idx = 0
        while (max_calls is None or idx < max_calls) and (
                time.perf_counter() - t0 < seconds or idx <= wanted[-1]):
            inp = inputs.make(seed, WINDOW, idx)
            _sync(device)
            c0 = time.perf_counter()
            out, res = port(inp)
            _sync(device)
            times.append(time.perf_counter() - c0)
            if trace:
                infos.append(_solve_info(res))
            if idx in wanted:  # a traced run moves them to the host after its trace
                kept[idx] = {k: v.detach() if trace else v.detach().cpu() for k, v in out.items()}
            del inp, out, res
            idx += 1
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the harness's own resident inputs (the tube field) are not the port's
    port_peak = max(0, peak - inputs.resident_bytes) if peak else 0

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    win, breakdown = None, None
    if trace:
        win = _read_trace(profiler, device)
        kept = {i: {k: v.cpu() for k, v in o.items()} for i, o in kept.items()}
        if win is not None:
            device_info.update(busy_s=win.busy_s, window_s=win.window_s)
            breakdown = {"device_ops": [list(x) for x in win.device_ops],
                         "idle_gaps": [list(x) for x in win.idle_gaps]}
    ctx = Context(cell=cell, mad_config=port.mad_config, times=times, setup_s=setup_s,
                  peak_bytes=int(port_peak), calls=infos, window=win)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    del port
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = compare_calls(cell, inputs, seed, kept)
    limits = {k: float(v) for k, v in traffic["check"]["limits"].items()}
    correct = check.verdict(values, limits)
    result = {"correct": correct, "attempted": len(times),
              "failed": 0 if correct else len(kept), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_phases"] = {name: t - marks[k - 1][1] for k, (name, t) in enumerate(marks) if k}
    result["check"] = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    return result


def compare_calls(cell: Cell, inputs: Inputs, seed: int, kept: Dict,
                  reference: Callable = check.reference_outputs) -> Dict[str, float]:
    """Per compared number, the largest over the kept calls."""
    values: Dict[str, float] = {}
    for idx, outputs in sorted(kept.items()):
        ref = reference(cell.config, cell.traffic, inputs.make(seed, WINDOW, idx))
        for k, v in check.numbers(outputs, ref).items():
            values[k] = max(values.get(k, v), v) if v == v else float("nan")
        del ref
    return values


def _activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _read_trace(profiler, device: torch.device) -> devtrace.Window | None:
    """The stopped profiler's window, read from its Chrome export (written
    under ``TMPDIR``, deleted after reading); ``None`` without a device."""
    if device.type != "cuda":
        return None
    path = os.path.join(tempfile.gettempdir(), "bench_port_trace.json")
    try:
        profiler.export_chrome_trace(path)
        return devtrace.read(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
