"""Profiling hooks: the port's spans, a ``torch.profiler`` trace and a
wall-clock timer.

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.profiling`` (which
wraps ``jax.profiler``).  The reference's only instrumentation is the
``#ifdef BENCHMARK`` wall-clock logging (:mod:`.benchlog`).  Wrap a solve in
:func:`trace` to capture a Chrome trace (``chrome://tracing`` or Perfetto:
host ops, CUDA kernels and their device times), and in :func:`timed` for its
wall time.  ``utils/profile_solve.py`` and ``utils/profile_ved.py`` read the
profiler's tables directly.

The entries and the solve loop mark their layers with :func:`span`, named
by the constants below.  A span is a ``torch.profiler.record_function``
range while a profiler runs, so it lands in the Chrome trace on the clock of
the CUDA kernels it launched (and, under
``torch.autograd.profiler.emit_nvtx()``, becomes an NVTX range for Nsight
Systems); with no profiler running it costs one flag check.  Per VED call
(one outer iteration): ``VED`` > ``VED_PIPELINE``, then ``MAD`` >
``MAD_SETUP`` (> ``MAD_ASSEMBLE`` per level, ``MAD_RESTRICT`` per coarser
level, ``MAD_COARSE``) and one ``MAD_STEP`` per implicit step (>
``MAD_CAST``, and per cycle ``MAD_CYCLE_LO`` or ``MAD_CYCLE_HI``,
``MAD_RESIDUAL``, ``MAD_SYNC``).  No span lies inside the V-cycle's level
recursion or a kernel wrapper.  The distributed path adds ``EXCHANGE`` (face
exchanges) and ``GATHER`` (gathers and global sums).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List

import torch

#: the body of ``models.ved.ved``
VED = "madt.ved"
#: the vesselness pipeline (Hessian, eigenvalues, vesselness, tensor)
VED_PIPELINE = "madt.ved.pipeline"
#: the body of ``models.mad.mad_diffusion``
MAD = "madt.mad"
#: the hierarchy's build (and pruning) in ``mad_diffusion``
MAD_SETUP = "madt.mad.setup"
#: one level's operator assembly in ``build_hierarchy``
MAD_ASSEMBLE = "madt.mad.setup.assemble"
#: one tensor restriction in ``build_hierarchy``
MAD_RESTRICT = "madt.mad.setup.restrict"
#: the coarsest level's direct solver (its stored operator, the dense LU and
#: inverse, the host read of the conditioning check)
MAD_COARSE = "madt.mad.setup.coarse"
#: one implicit time step
MAD_STEP = "madt.mad.step"
#: the low-precision copy of the hierarchy made in each defect-correction step
MAD_CAST = "madt.mad.cast"
#: one cycle in the defect dtype, with its casts of the defect and correction
MAD_CYCLE_LO = "madt.mad.cycle.lo"
#: one cycle in the solve's own precision
MAD_CYCLE_HI = "madt.mad.cycle.hi"
#: the outer update and relative residual after a cycle
MAD_RESIDUAL = "madt.mad.residual"
#: the host's read of that residual (the per-cycle synchronisation)
MAD_SYNC = "madt.mad.sync"
#: one halo-face exchange of the distributed solve
EXCHANGE = "madt.exchange"
#: one gather (or global sum) of the distributed solve
GATHER = "madt.gather"
#: every span name starts so
PREFIX = "madt."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs, else a shared no-op context (a flag check; entering
    ``record_function`` costs far more even with no profiler running)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def device_us(event) -> float:
    """A ``key_averages()`` row's own device time in us, under the
    profiler's newer or older attribute name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def span_table(prof) -> List[str]:
    """The spans of a stopped profiler, one line each: calls, host ms, and
    self device span ms, the profiler's device-side copy of each range: from
    the first to the last device operation launched in it outside its child
    spans (the gaps between them included), summed over the calls.  For a
    span with children, the benchmark's readers (``bench_port/portspans.py``)
    give the device and idle time of everything launched inside."""
    host, device = {}, {}
    for e in prof.key_averages():
        if not e.key.startswith(PREFIX):
            continue
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = e
        else:
            device[e.key] = device.get(e.key, 0.0) + device_us(e)
    lines = [f"  {'calls':>6} {'host ms':>10} {'self device span ms':>19}  span"]
    for key in sorted(host):
        lines.append(f"  {host[key].count:6d} {host[key].cpu_time_total / 1e3:10.3f} "
                     f"{device.get(key, 0.0) / 1e3:19.3f}  {key}")
    return lines


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
