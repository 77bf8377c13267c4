"""Port parity, the vesselness kernels' plain versions (B8 ``fd_vesselness``,
B9 ``tensor_assembly``) against the JAX package's Pallas kernels in
interpret mode (float64 on the CPU), as ``tests/test_pallas_vesselness.py``
runs them, and the vesselness formulas against ``models/ved.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models import ved as jved
from multigridanisotropicdiffusion_tpu.ops import hessian as jhessian
from multigridanisotropicdiffusion_tpu.ops.eigen3 import acos_poly
from multigridanisotropicdiffusion_tpu.ops.pallas_vesselness import (
    pallas_fd_vesselness,
    pallas_tensor_assembly,
)
from multigridanisotropicdiffusion_tpu_torch.models import ved
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_vesselness
from multigridanisotropicdiffusion_tpu_torch.ops.hessian import fd_factors
from multigridanisotropicdiffusion_tpu_torch.utils.convert import best_from_numpy

PARAMS = (0.5, 0.5, 5.0)
TENSOR = (0.01, 5.0, 10.0)
SPACING = (1.0, 0.9, 1.1)
SHAPE = (12, 16, 128)  # a shape the Pallas kernels' gates accept


def _smoothed(sigma, seed):
    """A valid-z smoothed tube phantom with noise, (Z + 2, Y, X)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=float) for n in SHAPE), indexing="ij")
    vol = 60.0 * np.exp(-((y - 8) ** 2 + (x - 40) ** 2) / 4.0)
    vol += 40.0 * np.exp(-((z - 6) ** 2 + (y - 5) ** 2) / 9.0)
    vol += rng.normal(size=SHAPE)
    return np.array(jhessian.smoothed_field_valid_z(jnp.asarray(vol), sigma, SPACING))


def _close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _jax_first(us, sigma, acos_fn=jnp.arccos):
    return pallas_fd_vesselness(jnp.asarray(us), jhessian.fd_factors(sigma, SPACING),
                                PARAMS, None, measure_fn=jved.vesselness_measure,
                                acos_fn=acos_fn, interpret=True)


@pytest.fixture(scope="module")
def scales():
    """The smoothed fields of two scales and the JAX kernel's first-scale
    running best."""
    us1, us2 = _smoothed(1.245, 0), _smoothed(2.0, 1)
    return us1, us2, _jax_first(us1, 1.245)


def test_fd_vesselness_first_matches_the_pallas_kernel(scales):
    us1, _, (jresp, jh) = scales
    resp, h = cuda_vesselness.fd_vesselness(torch.as_tensor(us1), fd_factors(1.245, SPACING),
                                            PARAMS, measure_fn=ved.vesselness_measure)
    assert resp.dtype == h.dtype == torch.float64
    _close(resp, jresp)
    _close(h, np.stack(jh))
    assert np.asarray(jresp).max() > 0.1  # the tubes respond


def test_fd_vesselness_select_matches_the_pallas_kernel(scales):
    us1, us2, jbest = scales
    want = pallas_fd_vesselness(jnp.asarray(us2), jhessian.fd_factors(2.0, SPACING),
                                PARAMS, jbest, measure_fn=jved.vesselness_measure,
                                acos_fn=jnp.arccos, interpret=True)
    best = best_from_numpy(np.asarray(jbest[0]), [np.asarray(p) for p in jbest[1]])
    ptr = best[0].data_ptr()
    got = cuda_vesselness.fd_vesselness(torch.as_tensor(us2), fd_factors(2.0, SPACING),
                                        PARAMS, best, measure_fn=ved.vesselness_measure)
    assert got[0].data_ptr() == ptr  # the running best is updated in place
    _close(got[0], want[0])
    _close(got[1], np.stack(want[1]))
    # both scales win somewhere
    changed = np.asarray(want[0]) != np.asarray(jbest[0])
    assert 0 < changed.sum() < changed.size


def test_tensor_assembly_matches_the_pallas_kernel(scales):
    _, _, (jresp, jh) = scales
    want = pallas_tensor_assembly(jresp, jh, jved._make_assemble_fn(*TENSOR),
                                  acos_fn=jnp.arccos, interpret=True)
    resp, h = best_from_numpy(np.asarray(jresp), [np.asarray(p) for p in jh])
    got = cuda_vesselness.tensor_assembly(resp, h, *TENSOR,
                                          assemble_fn=ved._make_assemble_fn(*TENSOR))
    assert got.shape == (6, *SHAPE)
    _close(got, np.stack(want))


def test_polynomial_arccos_gap(scales):
    """The TPU kernels' default ``acos_poly`` differs from acos by ~2e-8: the
    port (acos) and the JAX kernel as it runs on the TPU agree to 1e-6."""
    us1, _, (jresp, jh) = scales
    presp, ph = _jax_first(us1, 1.245, acos_fn=acos_poly)
    gap = np.abs(np.asarray(presp) - np.asarray(jresp)).max()
    assert 0 < gap < 1e-6
    _close(jresp, presp, rel=1e-6)
    tp = pallas_tensor_assembly(jresp, jh, jved._make_assemble_fn(*TENSOR),
                                interpret=True)
    resp, h = best_from_numpy(np.asarray(jresp), [np.asarray(p) for p in jh])
    got = cuda_vesselness.tensor_assembly(resp, h, *TENSOR,
                                          assemble_fn=ved._make_assemble_fn(*TENSOR))
    _close(got, np.stack(tp), rel=1e-6)


def test_wrappers_need_the_formulas_on_the_cpu():
    us = torch.zeros((3, 4, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="measure_fn"):
        cuda_vesselness.fd_vesselness(us, fd_factors(1.0, SPACING), PARAMS)
    with pytest.raises(ValueError, match="assemble_fn"):
        cuda_vesselness.tensor_assembly(us[0], torch.zeros((6, 4, 5)), *TENSOR)
    with pytest.raises(ValueError, match="measure_fn"):
        cuda_vesselness.hessian_vesselness(torch.zeros((6, 3, 4, 5)), PARAMS)


def test_vesselness_formulas_match_jax():
    rng = np.random.default_rng(4)
    lam = np.sort(rng.normal(size=(3, 400)) * 3.0, axis=0)
    lam[:, :40] = [[-0.01], [-2.0], [-2.1]]  # bright tubes
    got = ved.vesselness_measure(torch.as_tensor(lam), *PARAMS)
    want = jved.vesselness_measure(tuple(jnp.asarray(p) for p in lam), *PARAMS)
    _close(got, want)
    assert float(got[0]) == pytest.approx(0.1297, abs=0.01)
    resp = rng.uniform(-0.1, 1.0, size=400)
    q, _ = np.linalg.qr(rng.normal(size=(400, 3, 3)))
    qp = np.moveaxis(q, 0, -1)  # q[i, j]: component i of eigenvector j
    got = ved.generate_diffusion_tensor(torch.as_tensor(resp), torch.as_tensor(qp), *TENSOR)
    want = jved.generate_diffusion_tensor(
        jnp.asarray(resp), tuple(tuple(jnp.asarray(qp[i, j]) for j in range(3))
                                 for i in range(3)), *TENSOR)
    _close(got, np.stack(want))


def test_max_vesselness_over_scales_matches_jax():
    """The two-stage form (best response and eigenframe per scale, then the
    tensor) against JAX, compared through the tensor."""
    rng = np.random.default_rng(5)
    z, y, x = np.meshgrid(*(np.arange(14, dtype=float),) * 3, indexing="ij")
    vol = 80.0 * np.exp(-((y - 6.5) ** 2 + (x - 7.2) ** 2) / 4.0)
    vol += rng.uniform(0.0, 5.0, size=vol.shape)
    resp, q = ved.max_vesselness_over_scales(torch.as_tensor(vol), (0.775, 1.245),
                                             SPACING, *PARAMS)
    jresp, jq = jved.max_vesselness_over_scales(jnp.asarray(vol), (0.775, 1.245),
                                                SPACING, *PARAMS)
    _close(resp, jresp)
    assert float(resp[7, 6, 7]) > 0.1
    _close(ved.generate_diffusion_tensor(resp, q, *TENSOR),
           np.stack(jved.generate_diffusion_tensor(jresp, jq, *TENSOR)), rel=1e-9)


def test_compare_counts_flips_and_degenerate_tops():
    """utils.compare, which the kernel checks on the card use: a flip at a
    near-tie passes and is masked out, one far from the tie fails; a
    degenerate top eigenvalue is masked out, and a tensor that differs in
    its trace there fails."""
    from multigridanisotropicdiffusion_tpu_torch.utils.compare import (
        degenerate_tops,
        select_flips,
    )

    best = torch.full((2, 3, 4), 0.5, dtype=torch.float64)
    new_p = best.clone()
    new_p[0, 1, 2] += 1e-7
    sel = select_flips(best - 1e-7, new_p, best, 1.0)
    assert sel.ok and sel.n_flip == 1 and not bool(sel.keep[0, 1, 2])
    new_p[0, 1, 2] += 1e-3
    assert not select_flips(best - 1e-7, new_p, best, 1.0).ok

    h = torch.zeros((6, 2, 3, 4), dtype=torch.float64)
    h[0], h[3], h[5] = -1.0, -2.0, -3.0  # top |value| gap of 1
    h[:, 1, 2, 3] = torch.tensor([-1.0, 0.0, 0.0, -1.0, 0.0, -3.0])  # w_hi = w_mid
    resp = torch.ones(h.shape[1:], dtype=torch.float64)
    want = cuda_vesselness.tensor_assembly_plain(resp, h, ved._make_assemble_fn(*TENSOR))
    got = want.clone()
    got[[0, 3], 1, 2, 3] = want[[3, 0], 1, 2, 3]  # another frame, same trace
    deg = degenerate_tops(got, want, resp, h, 1e-12)
    assert deg.ok and deg.n_degenerate == 1 and deg.n_differ == 1
    assert int(deg.keep.sum()) == resp.numel() - 1
    got[0, 1, 2, 3] += 1.0
    assert not degenerate_tops(got, want, resp, h, 1e-12).trace_ok
