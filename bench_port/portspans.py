"""Reads the port's own spans from a traced window.

The port marks its layers with ``torch.profiler`` ranges named ``madt.*``
(``multigridanisotropicdiffusion_tpu_torch.utils.profiling``: the VED
pipeline, the solver's setup, each implicit step, the per-step cast, each
cycle by precision, the per-cycle residual and host read).  Per call (the
``bench.call`` ranges, as :mod:`.devtrace` takes them) and per span name,
:func:`summarize` gives the ranges' count, their host seconds, the device
seconds of the operations launched inside them (the union of their
intervals, child spans included) and the idle seconds inside them: the
part of the device's gaps (:mod:`.devtrace`'s union of the calls'
operations, cut by the calls) that lies within the ranges' host intervals.
Host and device share one clock in the trace.

The harness reads its trace into a :class:`.devtrace.Window` and keeps the
stopped profiler until its readers have run.  A profiler saves its Chrome
trace once, so :func:`per_call` finds that profiler among its callers'
locals and reads the events behind the export (``kineto_results``): the
port's ranges, the device operations and the CUDA calls that launched them,
matched by correlation id as in the export.  It keeps the summary for the
next reader of the same run.  A port without spans gives no ranges, and its
readers find nothing to read.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import weakref
from typing import Dict, List

from .devtrace import DEVICE_CATS, LAUNCH_CATS, _find, union
from .drive import CALL

PREFIX = "madt."
#: profiler -> its summary, kept while the harness holds the profiler
_SUMMARIES = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(events: List[Dict]) -> List[Dict[str, SpanStats]]:
    """Per call, span name -> its :class:`SpanStats` (seconds), from a
    trace's ``traceEvents`` (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"] == CALL)
    # per call, per span name: its host intervals
    ranges = [collections.defaultdict(list) for _ in calls]
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            a = float(e["ts"])
            c = _find(calls, a)
            if c is not None:
                ranges[c][e["name"]].append((a, a + float(e["dur"])))
    out = [{name: SpanStats(count=len(rs), host_s=sum(b - a for a, b in rs) / 1e6)
            for name, rs in rc.items()} for rc in ranges]
    spans = [{name: union(rs) for name, rs in rc.items()} for rc in ranges]

    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    in_calls = []
    launched = [collections.defaultdict(list) for _ in calls]
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        c = None if t is None else _find(calls, t)
        if c is None:  # not the port's: launched outside its calls
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        in_calls.append((a, b))
        for name, u in spans[c].items():
            if _find(u, t) is not None:
                launched[c][name].append((a, b))

    busy = union(in_calls)
    for c, (c0, c1) in enumerate(calls):
        # the device's gaps inside this call
        inside = [(max(a, c0), min(b, c1)) for a, b in busy if b > c0 and a < c1]
        gaps, t = [], c0
        for a, b in inside:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < c1:
            gaps.append((t, c1))
        for name, u in spans[c].items():
            out[c][name].device_s = sum(b - a for a, b in union(launched[c][name])) / 1e6
            out[c][name].idle_s = _overlap(gaps, u) / 1e6
    return out


def _caller_profiler():
    """The ``torch.profiler.profile`` held in a local of a calling frame."""
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


def trace_events(prof) -> List[Dict]:
    """A stopped profiler's events as its Chrome export gives those that
    :func:`summarize` reads (times in microseconds from the trace's start):
    host ranges (``user_annotation``), device operations (``kernel``) and the
    CUDA calls (``cuda_runtime``, by their ``cu`` names), the last two with
    their correlation id."""
    import torch

    results = prof.profiler.kineto_results
    raw = results.events()
    base = (results.trace_start_ns() if hasattr(results, "trace_start_ns")
            else min((e.start_ns() for e in raw), default=0))
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in raw:
        on_device = e.device_type() == cuda
        if e.is_user_annotation():
            if on_device:  # the range's device-side copy
                continue
            cat = "user_annotation"
        elif on_device:
            cat = "kernel"
        elif e.name().startswith("cu"):
            cat = "cuda_runtime"
        else:
            continue
        out.append({"ph": "X", "cat": cat, "name": e.name(),
                    "ts": (e.start_ns() - base) / 1e3, "dur": e.duration_ns() / 1e3,
                    "args": {"correlation": e.correlation_id()}})
    return out


def per_call(ctx) -> List[Dict[str, SpanStats]] | None:
    """The traced window's spans per call; ``None`` without a window (an
    untraced run, or no card) or without the profiler that traced it."""
    if ctx.window is None:
        return None
    prof = _caller_profiler()
    if prof is None:
        return None
    if prof not in _SUMMARIES:
        _SUMMARIES[prof] = summarize(trace_events(prof))
    return _SUMMARIES[prof]


def port_span(attr: str) -> str | None:
    """The port's span name ``utils.profiling.<attr>``; ``None`` for a port
    that has no such span."""
    from multigridanisotropicdiffusion_tpu_torch.utils import profiling

    return getattr(profiling, attr, None)


def mean_ms(ctx, attr: str, field: str) -> float | None:
    """``field`` (``device_s`` or ``idle_s``) of the span ``attr`` in ms per
    call of the window; ``None`` where no call has the span."""
    name = port_span(attr)
    calls = per_call(ctx) if name is not None else None
    if not calls or not any(name in c for c in calls):
        return None
    return 1e3 * sum(getattr(c[name], field) for c in calls if name in c) / len(calls)
