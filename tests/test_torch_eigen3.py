"""Port parity, ``ops/eigen3.py``: the analytic 3x3 eigensolver against the
JAX package's (float64 on the CPU).  Inputs are made with numpy from a seed:
random SPD and indefinite fields, and exactly degenerate matrices, where the
eigenvectors are arbitrary and the rank-1 VED tensor is compared instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models.ved import (
    _make_assemble_fn as jassemble,
)
from multigridanisotropicdiffusion_tpu.ops import eigen3 as jeigen
from multigridanisotropicdiffusion_tpu_torch.models.ved import _make_assemble_fn
from multigridanisotropicdiffusion_tpu_torch.ops import eigen3

PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _planes(mats):
    """(n, 3, 3) symmetric matrices -> the (6, n) symfield stack."""
    return np.stack([mats[:, i, j] for i, j in PAIRS])


def _field(kind, n=500, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    if kind == "spd":
        return _planes(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3))
    if kind == "indefinite":
        return _planes(a + a.transpose(0, 2, 1))
    # exactly degenerate: Q diag(l, l, m) Q^T and multiples of the identity
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.normal(size=(n, 2))
    d = np.stack([lam[:, 0], lam[:, 0], lam[:, 1]], axis=1)
    d[: n // 10] = lam[: n // 10, :1]  # triple
    d[n // 10: n // 5] = d[n // 10: n // 5, ::-1]  # top pair degenerate
    m = np.einsum("nij,nj,nkj->nik", q, d, q)
    return _planes(0.5 * (m + m.transpose(0, 2, 1)))


def _jax(planes, **kw):
    return jeigen.eigh3(tuple(jnp.asarray(p) for p in planes), **kw)


@pytest.mark.parametrize("kind", ["spd", "indefinite", "degenerate"])
def test_eigenvalues_match_jax(kind):
    # at an exact degeneracy p is rounding noise and the trigonometric formula
    # is good to ~sqrt(eps) of the scale in either package: 1e-7 there
    tol = 1e-7 if kind == "degenerate" else 1e-12
    planes = _field(kind)
    w = eigen3.eigvalsh3(torch.as_tensor(planes))
    jw = jeigen.eigvalsh3(tuple(jnp.asarray(p) for p in planes))
    np.testing.assert_allclose(w.numpy(), np.stack(jw), rtol=0, atol=tol)
    s = eigen3.sort_by_abs3(w)
    js = jeigen.sort_by_abs3(jw)
    np.testing.assert_allclose(s.numpy(), np.stack(js), rtol=0, atol=tol)
    assert np.all(np.abs(s.numpy()[:-1]) <= np.abs(s.numpy()[1:]))


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("mode", ["full", "largest"])
def test_eigenvectors_match_jax(kind, mode):
    planes = _field(kind, seed=1)
    w, v = eigen3.eigh3(torch.as_tensor(planes), vectors_mode=mode)
    jw, jv = _jax(planes, vectors_mode=mode)
    np.testing.assert_allclose(w.numpy(), np.stack(jw), rtol=0, atol=1e-12)
    want = np.stack(jv) if mode == "largest" else np.array(
        [[np.asarray(c) for c in row] for row in jv])
    assert v.shape == want.shape
    np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-9)


def test_degenerate_matrices_give_the_jax_tensor():
    """At a degenerate eigenvalue the eigenvectors are arbitrary: compare the
    rank-1 VED tensor (exact where the top pair is degenerate only through
    the eigenvector's choice within its eigenspace)."""
    planes = _field("degenerate", seed=2)
    resp = np.random.default_rng(3).uniform(0.0, 1.0, size=planes.shape[1])
    got = _make_assemble_fn(0.01, 5.0, 10.0)(torch.as_tensor(resp),
                                             torch.as_tensor(planes))
    want = jassemble(0.01, 5.0, 10.0)(
        jnp.asarray(resp), tuple(jnp.asarray(p) for p in planes), jnp.arccos)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-9)
    # the eigen-decomposition itself still holds, A v3 = w_hi v3, to the
    # ~sqrt(eps) accuracy of a degenerate eigenvalue
    w, v3 = eigen3.eigh3(torch.as_tensor(planes), vectors_mode="largest")
    mats = np.zeros((planes.shape[1], 3, 3))
    for k, (i, j) in enumerate(PAIRS):
        mats[:, i, j] = mats[:, j, i] = planes[k]
    av = np.einsum("nij,jn->in", mats, v3.numpy())
    np.testing.assert_allclose(av, w.numpy()[2] * v3.numpy(), rtol=0, atol=1e-6)


def test_nan_propagates_like_jax():
    """A tiny nonzero off-diagonal on a multiple of the identity gives
    r = 0 * inf in float32 (ADVICE r5 #1): both packages return NaN
    eigenvalues there, and the same finite rank-1 tensor.  (1e-18 keeps
    a01^2 a normal float: XLA on the CPU flushes subnormals to zero.)"""
    planes = np.array([[-1.0], [1e-18], [0.0], [-1.0], [0.0], [-1.0]], np.float32)
    w = eigen3.eigvalsh3(torch.as_tensor(planes))
    jw = jeigen.eigvalsh3(tuple(jnp.asarray(p) for p in planes))
    assert np.isnan(w.numpy()).all() and np.isnan(np.stack(jw)).all()
    resp = np.array([0.5], np.float32)
    got = _make_assemble_fn(0.01, 5.0, 10.0)(torch.as_tensor(resp),
                                             torch.as_tensor(planes))
    want = jassemble(0.01, 5.0, 10.0)(
        jnp.asarray(resp), tuple(jnp.asarray(p) for p in planes), jnp.arccos)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-6)
