"""Reads a traced window from the profiler's Chrome trace.

Device operations (kernels, copies, fills) are attributed to the host range
that launched them: the CUDA runtime or driver call with the same
correlation id gives the launch time, and the innermost ``bench.*`` range
of the port's call (:mod:`.drive`) open at that time takes the operation;
an operation launched outside the calls is not the port's.
A span's device time is the union of its operations' intervals; the device
is busy in the union of all operations' intervals, not in their sum (a side
stream may overlap the main one).  The traced window is the port's calls
(the ``bench.call`` ranges, each closed by a synchronisation), not the
harness's input generation between them.  Host and device share one clock
in the trace.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Dict, List, Tuple

from .drive import CALL, PIPELINE, SETUP, SOLVE, WINDOW

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: the call's ranges, innermost last where they nest
SPANS = (PIPELINE, SOLVE, SETUP)
TOP = 10


@dataclasses.dataclass
class Window:
    busy_s: float
    window_s: float
    #: per call: span name -> device seconds of the operations it launched
    #: (innermost range); ``"call"`` -> those the call launched outside them
    device_s: List[Dict[str, float]]
    #: per call: span name -> host seconds inside it
    wall_s: List[Dict[str, float]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def union(intervals) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _find(intervals, t):
    """Index of the interval of a sorted disjoint list that holds ``t``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i if i >= 0 and intervals[i][0] <= t <= intervals[i][1] else None


def summarize(events: List[Dict]) -> Window:
    """The window of a trace's ``traceEvents``; times in microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ann = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith("bench."):
            ann[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    main_tid = next(e["tid"] for e in xs if e.get("cat") == "user_annotation"
                    and e["name"] == WINDOW)
    calls = sorted(ann[CALL])
    spans = {name: sorted(ann[name]) for name in SPANS}
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [e for e in xs if e.get("cat") in DEVICE_CATS]

    per_call = [collections.defaultdict(list) for _ in calls]
    totals = collections.Counter()
    in_calls = []
    for e in ops:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        t = launch.get(e.get("args", {}).get("correlation"))
        c = None if t is None else _find(calls, t)
        if c is None:  # not the port's: launched outside its calls
            continue
        totals[e["name"]] += b - a
        in_calls.append((a, b))
        owner = "call"
        for name in SPANS:  # later names nest inside earlier ones
            if _find(spans[name], t) is not None:
                owner = name
        per_call[c][owner].append((a, b))
    device_s = [{k: _length(union(v)) / 1e6 for k, v in pc.items()} for pc in per_call]
    wall_s = []
    for c0, c1 in calls:
        wall_s.append({name: sum(b - a for a, b in spans[name] if a >= c0 and b <= c1) / 1e6
                       for name in SPANS})

    busy = union(in_calls)
    gaps, i = [], 0
    for c0, c1 in calls:
        t = c0
        while i < len(busy) and busy[i][0] < c1:
            if busy[i][0] > t:
                gaps.append((t, busy[i][0]))
            t = max(t, busy[i][1])
            i += 1
        if t < c1:
            gaps.append((t, c1))

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e["tid"] == main_tid
                  and e["name"] != WINDOW)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host outside any range"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 5000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += b - a
    return Window(
        busy_s=_length(busy) / 1e6, window_s=_length(calls) / 1e6, device_s=device_s,
        wall_s=wall_s,
        device_ops=[(n, s / 1e6) for n, s in totals.most_common(TOP)],
        idle_gaps=[(n, s / 1e6) for n, s in idle.most_common(TOP)])


def read(path: str) -> Window:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
