"""Residual-vs-wallclock logging (the reference's ``benchmark.txt`` contract).

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.benchlog``, a copy
that reads the port's :class:`~..models.mad.MADResult` (torch tensors on any
device).

The reference, compiled with ``-DBENCHMARK``, appends
``<relativeResidual>_<seconds>`` lines to ``benchmark.txt`` after every
level-0 smoother iteration and V-cycle stage, timed with CPU ``clock()``
(itkMultigridAnisotropicDiffusionImageFilter.hxx:147-151, 222-227, 401-409,
450-458, 477-485).  :class:`ResidualTraceLogger` collects (relative_residual,
seconds) pairs and writes them in the same ``residual_seconds`` line format
(:func:`..models.trace.mad_diffusion_verbose` feeds it), and
:func:`trace_from_result` turns a :class:`~..models.mad.MADResult`, which
records one residual per outer cycle, into a trace after the fact.
"""

from __future__ import annotations

import time
from typing import List, Tuple


class ResidualTraceLogger:
    """Collects ``(relative_residual, seconds_since_start)`` samples and
    writes them in the reference's ``benchmark.txt`` line format."""

    def __init__(self):
        self.samples: List[Tuple[float, float]] = []
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        """Restart the clock (the reference stamps ``clock()`` at each time
        step, .hxx:161-165)."""
        self._t0 = time.perf_counter()

    def log(self, relative_residual: float) -> None:
        self.samples.append(
            (float(relative_residual), time.perf_counter() - self._t0)
        )

    def write(self, path: str = "benchmark.txt") -> None:
        with open(path, "w") as f:
            for res, sec in self.samples:
                f.write(f"{res}_{sec}\n")


def trace_from_result(result, wall_seconds: float) -> List[Tuple[float, float]]:
    """Approximate a residual-vs-time trace from a MADResult: the solve
    records one relative residual per cycle; distribute the measured wall time
    uniformly over the executed cycles (every cycle runs the same work)."""
    samples = []
    hist = result.residual_history.cpu().numpy()
    counts = result.num_cycles.cpu().numpy()
    total = int(counts.sum())
    if total == 0:
        return samples
    per_cycle = wall_seconds / total
    t = 0.0
    for step in range(hist.shape[0]):
        for k in range(int(counts[step])):
            t += per_cycle
            samples.append((float(hist[step, k]), t))
    return samples
