"""The plain reference against the port at small sizes (float64 on the CPU),
and the comparison failing a lower-precision answer."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port import check, spec
from bench_port.reference import pipeline as ref
from bench_port.reference import solve as ref_solve
from multigridanisotropicdiffusion_tpu_torch.models.mad import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.models.ved import fused_vesselness_tensor
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import assemble_compressed_dca
from multigridanisotropicdiffusion_tpu_torch.ops.dca import assemble_dca
from multigridanisotropicdiffusion_tpu_torch.ops.eigen3 import eigh3
from multigridanisotropicdiffusion_tpu_torch.ops.hessian import gaussian_kernels_1d, hessian

SHAPE = (20, 17, 23)
SCALES = (0.3, 0.482, 0.775, 1.245, 2.0)
VED = dict(alpha=0.5, beta=0.5, gamma=5.0, epsilon=0.01, omega=5.0, sensitivity=10.0,
           scales=SCALES)


def _volume(seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(SHAPE, generator=g, dtype=torch.float64) * 10
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float64) for n in SHAPE),
                             indexing="ij")
    return u + 100 * torch.exp(-((y - 8) ** 2 + (x - 11) ** 2) / 8.0)


def _tensor(seed=1):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn((3, 3, *SHAPE), generator=g, dtype=torch.float64)
    return torch.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0)
                        for i, j in ref.PAIRS])


@pytest.mark.parametrize("sigma", SCALES)
def test_taps_are_the_ports(sigma):
    for mine, port in zip(ref.gaussian_taps(sigma), gaussian_kernels_1d(sigma, 1.0)):
        np.testing.assert_allclose(mine, port, rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", ["smooth_fd", "gaussian_derivative"])
@pytest.mark.parametrize("sigma", [0.3, 2.0])
def test_hessian_matches_the_port(mode, sigma):
    u = _volume()
    halo = ref.radius(sigma) + 1
    idx = torch.arange(-halo, SHAPE[0] + halo).clamp(0, SHAPE[0] - 1)
    fn = ref.hessian_smooth_fd if mode == "smooth_fd" else ref.hessian_gaussian_derivative
    mine = fn(u.index_select(0, idx), halo, sigma)
    port = hessian(u, sigma, mode=mode)
    assert torch.allclose(mine, port, rtol=0, atol=1e-11 * port.abs().max())


def test_eigenvalues_match_the_port():
    h = torch.randn((6, 4000), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    w = ref.eigenvalues(h)
    w_port, v_port = eigh3(h)
    assert torch.allclose(w, w_port, rtol=0, atol=1e-12)
    q = ref.top_eigenvector(h, w[2])
    assert torch.allclose((q * v_port[:, 2]).sum(0).abs(), torch.ones(4000, dtype=torch.float64),
                          atol=1e-9)


@pytest.mark.parametrize("mode", ["smooth_fd", "gaussian_derivative"])
def test_pipeline_matches_the_port(mode):
    u = _volume()
    resp, t = ref.vesselness_tensor(u, VED, mode, torch.float64, slab=8)
    p = dict(VED)
    p_resp, p_t = fused_vesselness_tensor(u, SCALES, (1.0,) * 3, p["alpha"], p["beta"],
                                          p["gamma"], p["epsilon"], p["omega"],
                                          p["sensitivity"], hessian_mode=mode)
    assert check.rel_l2(p_resp, resp) < 1e-10
    assert check.rel_l2(p_t, t) < 1e-9


def test_operator_matches_the_ports_stored_and_compressed_forms():
    t = _tensor()
    c = ref_solve.assemble(t, 0.1)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    mine = ref_solve.apply(c, x)
    for op in (assemble_dca(t, (1.0,) * 3, 0.1), assemble_compressed_dca(t, (1.0,) * 3, 0.1)):
        assert torch.allclose(mine, op.apply(x), rtol=0, atol=1e-12)


def test_steps_match_the_ports_solve():
    t = _tensor()
    b = torch.rand(SHAPE, generator=torch.Generator().manual_seed(5), dtype=torch.float64) * 255
    mine, rhs, c = ref_solve.implicit_steps(b, t, {"time_step": 0.1}, 2, tol=1e-13)
    port = mad_diffusion(b, t, config=MADConfig(time_step=0.1, number_of_steps=2,
                                                tolerance=1e-13), device="cpu").output
    assert check.rel_l2(port, mine) < 1e-11
    assert ref_solve.relative_residual(c, port, rhs) < 1e-12


def test_bicgstab_in_bfloat16_stalls_and_answers():
    t = _tensor()
    b = torch.rand(SHAPE, generator=torch.Generator().manual_seed(6), dtype=torch.float64) * 255
    c = ref_solve.assemble(t.to(torch.bfloat16), 0.1)
    x, relres = ref_solve.bicgstab(c, b.to(torch.bfloat16), b.to(torch.bfloat16), 1e-10, 30)
    assert x.dtype == torch.bfloat16 and torch.isfinite(x).all()
    assert 1e-4 < relres < 0.1


@pytest.mark.parametrize("workload", ["mad512", "ved512", "ved512-gd"])
def test_the_control_fails_the_comparison(workload):
    """The configuration's control (the port's bf16 pipeline for VED, the
    reference's bf16 solve for MAD) reads above a limit."""
    from bench_port import calibrate

    cell = spec.load_cell(workload)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, shape=[24, 20, 18]))
    (values,) = calibrate.readings(cell, [31], True, torch.device("cpu"), lambda line: None)
    limits = cell.traffic["check"]["limits"]
    assert not check.verdict(values, limits), values
