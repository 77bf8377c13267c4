"""Port parity, the verbose per-level trace (``models/trace.py``) and the
``benchmark.txt`` logger (``utils/benchlog.py``): the same lines as the JAX
package's ``mad_diffusion_verbose``, text for text, and numbers within
rtol 1e-9 and atol 1e-15 (the float64 round-off floor of a relative
residual near 1e-10, as in ``tests/test_torch_mad.py``).  A direct-solver
line reports the residual of an exact solve, which is round-off alone
(~1e-16 times the condition of the coarsest matrix): there both packages
must stay below 1e-13."""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models import mad as jmad
from multigridanisotropicdiffusion_tpu.models.trace import (
    mad_diffusion_verbose as jverbose,
)
from multigridanisotropicdiffusion_tpu.utils import benchlog as jbenchlog
from multigridanisotropicdiffusion_tpu_torch.models.mad import (
    FMG,
    SMOOTHER,
    VCYCLE,
    MADConfig,
    mad_diffusion,
)
from multigridanisotropicdiffusion_tpu_torch.models.trace import mad_diffusion_verbose
from multigridanisotropicdiffusion_tpu_torch.utils.benchlog import (
    ResidualTraceLogger,
    trace_from_result,
)
from multigridanisotropicdiffusion_tpu_torch.utils.convert import mad_config_from_jax

from .conftest import make_spd_tensor_field


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return make_spd_tensor_field(rng, shape, len(shape), hi=2.0), rng.normal(size=shape) * 10.0


def _same_lines(lines, jlines):
    assert len(lines) == len(jlines)
    for a, b in zip(lines, jlines):
        pa, pb = a.split("= "), b.split("= ")
        assert pa[0] == pb[0]
        if "direct solver" in a:
            assert max(float(pa[1]), float(pb[1])) <= 1e-13
        elif len(pa) == 2:
            np.testing.assert_allclose(float(pa[1]), float(pb[1]), rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("shape,kw", [
    ((17, 16), dict(cycle=VCYCLE)),
    ((17, 16), dict(cycle=FMG, number_of_steps=2, time_step=0.05)),
    ((17, 16), dict(cycle=SMOOTHER, tolerance=1e-3, smoother="weighted_jacobi")),
    ((13, 12, 14), dict(cycle=VCYCLE, operator_repr="compressed", spacing=(1.0, 0.5, 2.0))),
], ids=["2d_vcycle", "2d_fmg_steps", "2d_smoother", "3d_compressed"])
def test_trace_matches_jax(shape, kw):
    tensor, image = _inputs(shape)
    spacing = kw.pop("spacing", None)
    jcfg = jmad.MADConfig(**{"time_step": 0.1, "tolerance": 1e-9, **kw})
    cfg = mad_config_from_jax(jcfg)
    lines, jlines = [], []
    out, trace = mad_diffusion_verbose(image, tensor, spacing, cfg, print_fn=lines.append,
                                       device="cpu")
    jout, jtrace = jverbose(image, tensor, spacing, jcfg, print_fn=jlines.append)
    assert trace == lines and jtrace == jlines
    assert out.dtype == torch.float64 and tuple(out.shape) == shape
    _same_lines(lines, jlines)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-10, atol=1e-10)
    if cfg.cycle != SMOOTHER:
        assert any(line.startswith(" Level 0, iteration 1") for line in lines)
        assert any("direct solver" in line for line in lines)


def test_trace_with_the_kernel_config_matches_the_solve():
    """``MADConfig.cuda(mixed_precision=False)``: the trace runs the kernel
    wrappers (their plain versions on the CPU) and ends where the solve
    ends."""
    tensor, image = _inputs((12, 13, 14), seed=1)
    cfg = MADConfig.cuda(mixed_precision=False, time_step=0.1, tolerance=1e-10)
    out, lines = mad_diffusion_verbose(image, tensor, config=cfg, print_fn=lambda s: None,
                                       device="cpu")
    res = mad_diffusion(image, tensor, config=cfg, device="cpu")
    np.testing.assert_allclose(out.numpy(), res.output.numpy(), rtol=1e-12, atol=1e-12)
    headers = [line for line in lines if line.startswith("|--- VCycle")]
    assert len(headers) == int(res.num_cycles[0])


def test_benchmark_txt_contract(tmp_path):
    tensor, image = _inputs((16, 16), seed=2)
    logger = ResidualTraceLogger()
    mad_diffusion_verbose(image, tensor, config=MADConfig(tolerance=1e-8),
                          print_fn=lambda s: None, logger=logger, device="cpu")
    path = str(tmp_path / "benchmark.txt")
    logger.write(path)
    rows = open(path).read().strip().splitlines()
    assert len(rows) >= 2 and len(rows) == len(logger.samples)
    for row in rows:
        res, sec = row.split("_")
        assert float(res) > 0 and float(sec) >= 0


def test_trace_from_result_matches_jax():
    tensor, image = _inputs((16, 16), seed=3)
    kw = dict(tolerance=1e-8, number_of_steps=2, time_step=0.05)
    res = mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")
    samples = trace_from_result(res, wall_seconds=1.0)
    jsamples = jbenchlog.trace_from_result(
        jmad.mad_diffusion(image, tensor, config=jmad.MADConfig(**kw)), wall_seconds=1.0)
    assert len(samples) == len(jsamples) == int(res.num_cycles.sum())
    np.testing.assert_allclose(np.asarray(samples), np.asarray(jsamples),
                               rtol=1e-9, atol=1e-15)
    ts = [t for _, t in samples]
    assert ts == sorted(ts) and abs(ts[-1] - 1.0) < 1e-9


def test_trace_refuses_a_mesh():
    """A mesh that is not a GridMesh is refused (the distributed trace:
    tests/test_torch_dist_ved.py)."""
    tensor, image = _inputs((8, 8))
    with pytest.raises(TypeError, match="GridMesh"):
        mad_diffusion_verbose(image, tensor, mesh=object(), device="cpu")
