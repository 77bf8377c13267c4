"""The port's spans (``utils.profiling.span``): free with no profiler
running, and under ``torch.profiler`` named, nested and counted as the
layers of a VED call and a MAD solve."""

import collections
import json
from typing import NamedTuple

import numpy as np
import torch

from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.models.mad import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.models.ved import VEDConfig, ved
from multigridanisotropicdiffusion_tpu_torch.utils import profiling as P
from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_phantom

#: each span's enclosing span (``MAD``'s: ``VED`` in a VED call, else none)
PARENT = {
    P.VED_PIPELINE: P.VED,
    P.MAD_SETUP: P.MAD,
    P.MAD_ASSEMBLE: P.MAD_SETUP,
    P.MAD_RESTRICT: P.MAD_SETUP,
    P.MAD_COARSE: P.MAD_SETUP,
    P.MAD_STEP: P.MAD,
    P.MAD_CAST: P.MAD_STEP,
    P.MAD_CYCLE_LO: P.MAD_STEP,
    P.MAD_CYCLE_HI: P.MAD_STEP,
    P.MAD_RESIDUAL: P.MAD_STEP,
    P.MAD_SYNC: P.MAD_STEP,
}
CYCLES = (P.MAD_CYCLE_LO, P.MAD_CYCLE_HI)


def _spd_inputs(shape, seed=0):
    g = np.random.default_rng(seed)
    rows = g.normal(size=(3, 3) + shape)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    tensor = np.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0)
                       for i, j in pairs])
    return g.uniform(0.0, 255.0, shape), tensor


class Span(NamedTuple):
    name: str
    start: float
    end: float


def _profiled(fn, path):
    """``fn()`` and its ``madt.*`` ranges as ``(span, enclosing span or
    None)``, read from the profiler's Chrome export (faster to read than
    ``prof.events()``)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("madt.")), key=lambda s: (s.start, -s.end))
    stack, nested = [], []
    for sp in spans:
        while stack and not (stack[-1].start <= sp.start and sp.end <= stack[-1].end):
            stack.pop()
        nested.append((sp, stack[-1] if stack else None))
        stack.append(sp)
    return out, nested


def _check_solve(spans, result, shape):
    """Nesting as in ``PARENT``; one assembly per level and one restriction
    per coarser level; per step, its cycles by precision add up to
    ``num_cycles``, with one residual and one sync per cycle."""
    for e, p in spans:
        if e.name in PARENT:
            assert p is not None and p.name == PARENT[e.name], e.name
        assert p is None or p.name not in CYCLES  # nothing inside a cycle's recursion
    counts = collections.Counter(e.name for e, _ in spans)
    levels = len(build_level_descriptors(shape))
    assert counts[P.MAD_SETUP] == 1 and counts[P.MAD_COARSE] == 1
    assert counts[P.MAD_ASSEMBLE] == levels and counts[P.MAD_RESTRICT] == levels - 1
    steps = [e for e, _ in spans if e.name == P.MAD_STEP]
    assert len(steps) == len(result.num_cycles)
    per_step = []
    for step, cycles in zip(steps, result.num_cycles.tolist()):
        inside = collections.Counter(e.name for e, p in spans if p is step)
        assert inside[P.MAD_CYCLE_LO] + inside[P.MAD_CYCLE_HI] == cycles
        assert inside[P.MAD_RESIDUAL] == inside[P.MAD_SYNC] == cycles
        per_step.append(inside)
    return per_step


def test_span_never_enters_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with P.span(P.MAD_STEP) as a, P.span(P.MAD_SYNC) as b:
        assert a is None and b is None
    assert P.span(P.VED) is P.span(P.MAD)  # one shared no-op context


def test_a_tiny_mad_solve_records_its_layers(tmp_path):
    b, tensor = _spd_inputs((16, 16, 16))
    cfg = MADConfig(time_step=0.1, tolerance=1e-6, operator_repr="compressed",
                    defect_dtype="bfloat16", number_of_steps=2)
    res, spans = _profiled(lambda: mad_diffusion(b, tensor, config=cfg, device="cpu"),
                           tmp_path / "trace.json")
    assert {e.name for e, _ in spans} == set(PARENT) - {P.VED_PIPELINE} | {P.MAD}
    assert [p for e, p in spans if e.name == P.MAD] == [None]
    per_step = _check_solve(spans, res, b.shape)
    assert [s[P.MAD_CAST] for s in per_step] == [1, 1]  # one cast per implicit step
    # the second step's residual 1.7e-3 opens the full-precision window
    assert sum(s[P.MAD_CYCLE_HI] for s in per_step) >= 1
    assert sum(s[P.MAD_CYCLE_LO] for s in per_step) >= 1


def test_the_full_precision_solve_runs_only_hi_cycles(tmp_path):
    b, tensor = _spd_inputs((16, 12, 16), seed=1)
    cfg = MADConfig(time_step=0.1, tolerance=1e-6, operator_repr="compressed")
    res, spans = _profiled(lambda: mad_diffusion(b, tensor, config=cfg, device="cpu"),
                           tmp_path / "trace.json")
    per_step = _check_solve(spans, res, b.shape)
    assert per_step[0][P.MAD_CAST] == per_step[0][P.MAD_CYCLE_LO] == 0
    assert per_step[0][P.MAD_CYCLE_HI] == int(res.num_cycles[0]) > 0


def test_a_tiny_ved_call_records_the_pipeline_and_its_solve(tmp_path):
    vol = tube_phantom((24, 24, 24), torch.Generator().manual_seed(3))
    cfg = VEDConfig.cuda(use_kernels=False, scales=(1.0, 2.0))
    res, spans = _profiled(lambda: ved(vol, config=cfg, device="cpu"),
                           tmp_path / "trace.json")
    roots = [e for e, p in spans if p is None]
    assert [e.name for e in roots] == [P.VED]
    assert [e.name for e, p in spans if p is roots[0]] == [P.VED_PIPELINE, P.MAD]
    per_step = _check_solve(spans, res.diffusion, tuple(vol.shape))
    assert len(per_step) == cfg.diffusion_iterations
    assert all(s[P.MAD_CAST] == 1 for s in per_step)


def test_the_span_table_lists_each_span_with_its_calls():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span(P.MAD_STEP), P.span(P.MAD_SYNC):
                torch.ones(4).sum()
    rows = {line.split()[-1]: int(line.split()[0]) for line in P.span_table(prof)[1:]}
    assert rows == {P.MAD_STEP: 3, P.MAD_SYNC: 3}
