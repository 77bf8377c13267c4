"""Profiling hooks: a ``torch.profiler`` trace and a wall-clock timer.

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.profiling`` (which
wraps ``jax.profiler``).  The reference's only instrumentation is the
``#ifdef BENCHMARK`` wall-clock logging (:mod:`.benchlog`).  Wrap a solve in
:func:`trace` to capture a Chrome trace (``chrome://tracing`` or Perfetto:
host ops, CUDA kernels and their device times), and in :func:`timed` for its
wall time.  ``utils/profile_solve.py`` and ``utils/profile_ved.py`` read the
profiler's tables directly.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str = "madt_profile") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA when a card is present) and
    write its Chrome trace to ``log_dir/trace.json``; yields the profiler,
    whose ``key_averages()`` sums the time by op and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, sink=print) -> Iterator[None]:
    """Wall-clock a block.  With a CUDA card the device is synchronized
    before and after, so the time covers the work the block launched."""
    sync = torch.cuda.is_available()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize()
        sink(f"[{label}] {time.perf_counter() - t0:.3f}s")
