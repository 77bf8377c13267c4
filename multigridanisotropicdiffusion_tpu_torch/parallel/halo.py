"""Halo-exchange smoothers and residuals on the blocks of a distributed solve.

Counterpart of ``multigridanisotropicdiffusion_tpu.parallel.halo``.  Each
rank holds one block of a level (:mod:`.sharding`); faces as thick as the
operator's radius move between neighbours (:func:`exchange_halos`, one
``batch_isend_irecv`` per split dimension), and the smoother runs on the
local block with its halo ring.  Ghost values outside the *global* domain
are zero, the contract of the boundary-folded operators.  Red-black parity
comes from *global* coordinates, so the colouring does not depend on the
partition.  Every split dimension must divide evenly (see :mod:`.padding`).

There is one path: exchange, then contract.  The JAX package's
``overlap=True`` contracts against zero halos while the exchange is in
flight and then recomputes the boundary slabs; here the exchange holds the
host (under gloo the faces' copies to the host wait for the stream, and
NCCL's point-to-point operations wait for it too), so that split would
overlap nothing and only add the slab recompute.  ``MADConfig.halo``
accepts both names, and both take this path.

The kernel path (:func:`make_halo_kernel_rbgs_sweep`,
:func:`make_halo_kernel_residual`, the JAX package's
``make_halo_pallas_*``) runs the shard-local kernel B14 on each 3D block of a
radius-1 operator (``ops.cuda_smoothers.halfsweep_local`` for the compressed
operator, ``ops.cuda_stencil_stored.halfsweep_local`` for a stored one): it
drops every term that crosses the block's border, the boundary slabs are
then recomputed here in plain PyTorch from the exchanged halos
(:func:`_halfsweep_slab_fix`), and the colour is flipped on blocks whose
global origin is odd (the kernel's parity is the local index sum).  On a CPU
tensor the wrappers take their plain versions.

Arithmetic follows the port's rule: 16-bit storage computes in float32 and
rounds once per half-sweep, Jacobi sweep, Chebyshev call or residual.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..core.stencil import StencilOperator, compute_dtype
from ..ops.compressed import CompressedDCAOperator
from ..ops.smoothers import CHEBYSHEV_DEGREE, CHEBYSHEV_EIG_RATIO, DEFAULT_JACOBI_WEIGHT, parity_mask
from .sharding import GridMesh, Spec, exchange_faces, sharded_dims, _staged


def _offdiag_terms(op):
    """The off-diagonal part of ``op`` as ``(offset, plane, sign)`` triples:
    one plane per non-centre offset of a stored operator; the face planes of
    the compressed operator and four signed copies of each mixed plane."""
    if isinstance(op, CompressedDCAOperator):
        ndim = op.ndim
        terms = []
        for d in range(ndim):
            e = [0] * ndim
            e[d] = 1
            terms.append((tuple(e), op.planes[2 * d], 1.0))
            e[d] = -1
            terms.append((tuple(e), op.planes[2 * d + 1], 1.0))
        k = 0
        for d in range(ndim):
            for d2 in range(d + 1, ndim):
                for s1 in (1, -1):
                    for s2 in (1, -1):
                        off = [0] * ndim
                        off[d] = s1
                        off[d2] = s2
                        terms.append((tuple(off), op.planes[2 * ndim + k], float(s1 * s2)))
                k += 1
        return tuple(terms)
    c = op.center_index
    return tuple((off, op.coeffs[k], 1.0) for k, off in enumerate(op.offsets) if k != c)


def _op_radii(op) -> Tuple[int, ...]:
    """Per-dimension stencil radius: 1 for the compressed form, the largest
    |offset| per dimension for a stored operator (2 on exact Galerkin
    levels: the halo thickness follows)."""
    if isinstance(op, CompressedDCAOperator):
        return (1,) * op.ndim
    return tuple(max(abs(off[d]) for off in op.offsets) for d in range(op.ndim))


def exchange_halos(x: torch.Tensor, mesh: GridMesh, spec: Spec,
                   radii: Tuple[int, ...] | None = None) -> torch.Tensor:
    """The local block padded by ``radii[d]`` in every dimension: neighbour
    faces along split dimensions, zeros at the global borders and along
    replicated dimensions.  Dimension by dimension, each face carrying the
    halos already received in earlier dimensions (the corners), as the JAX
    package's concatenations do.  One hop: each split block must be at least
    as thick as the radius."""
    ndim = x.dim()
    if radii is None:
        radii = (1,) * ndim
    shape = tuple(x.shape)
    x_pad = x.new_zeros([s + 2 * r for s, r in zip(shape, radii)])
    interior = tuple(slice(r, r + s) for r, s in zip(radii, shape))
    x_pad[interior] = x
    for d in sharded_dims(mesh, spec):
        r = radii[d]
        if shape[d] < r:
            raise ValueError(f"local block dim {d} ({shape[d]}) smaller than the stencil "
                             f"radius {r}: raise min_local")

        def at(rows):
            idx = [slice(None) if dd < d else interior[dd] for dd in range(ndim)]
            idx[d] = rows
            return tuple(idx)

        face = x_pad[at(slice(r, 2 * r))]
        from_lo, from_hi = exchange_faces(
            mesh, d, face, x_pad[at(slice(shape[d], shape[d] + r))],
            face.shape, face.shape, x.dtype, x.device)
        if from_lo is not None:
            x_pad[at(slice(0, r))] = from_lo
        if from_hi is not None:
            x_pad[at(slice(r + shape[d], 2 * r + shape[d]))] = from_hi
    return x_pad


def _local_offdiag(op, x_pad: torch.Tensor, radii: Tuple[int, ...]) -> torch.Tensor:
    """Off-diagonal contraction on a halo-padded local block (compute
    dtype)."""
    shape = op.shape
    cd = compute_dtype(x_pad.dtype)
    x_pad = x_pad.to(cd)
    out = None
    for off, plane, sign in _offdiag_terms(op):
        sl = tuple(slice(r + o, r + o + s) for r, o, s in zip(radii, off, shape))
        plane = plane.to(cd)
        term = (sign * plane) * x_pad[sl] if sign != 1.0 else plane * x_pad[sl]
        out = term if out is None else out + term
    return out


def _slab_slice(shape, d: int, lo: bool):
    """Index of the 1-voxel boundary slab of dimension d, and its start."""
    pos = 0 if lo else shape[d] - 1
    return tuple(slice(pos, pos + 1) if dd == d else slice(None)
                 for dd in range(len(shape))), pos


def _local_offdiag_slab(op, x_pad: torch.Tensor, d: int, lo: bool) -> torch.Tensor:
    """Off-diagonal contraction of the 1-voxel boundary slab of dimension d
    of a radius-1 operator, read from the block padded by one halo voxel:
    the complete value there, the corner terms through other dimensions'
    halos included."""
    shape = op.shape
    coeff_sl, pos = _slab_slice(shape, d, lo)
    cd = compute_dtype(x_pad.dtype)
    out = None
    for off, plane, sign in _offdiag_terms(op):
        sl = tuple(slice(1 + pos + o, 2 + pos + o) if dd == d else slice(1 + o, 1 + o + s)
                   for dd, (o, s) in enumerate(zip(off, shape)))
        term = sign * plane[coeff_sl].to(cd) * x_pad[sl].to(cd)
        out = term if out is None else out + term
    return out


def _offdiag_exchange(op, x: torch.Tensor, mesh: GridMesh, spec: Spec) -> torch.Tensor:
    """Off-diagonal contraction of the local block with the true neighbour
    halos: exchange, then one contraction over the padded block."""
    radii = _op_radii(op)
    return _local_offdiag(op, exchange_halos(x, mesh, spec, radii), radii)


def _origin_parity(shape_local: Tuple[int, ...], mesh: GridMesh, spec: Spec) -> int:
    """Parity of the block's global origin-coordinate sum."""
    return sum(mesh.coords[d] * shape_local[d] for d in sharded_dims(mesh, spec)) % 2


def _global_parity(shape_local: Tuple[int, ...], mesh: GridMesh, spec: Spec,
                   device) -> torch.Tensor:
    """Checkerboard from global coordinates: True where their sum is even."""
    red = parity_mask(shape_local, device)
    return ~red if _origin_parity(shape_local, mesh, spec) else red


def make_halo_rbgs_sweep(mesh: GridMesh, spec: Spec):
    """``sweep(op, x, b) -> x'``: a red-black Gauss-Seidel sweep on this
    rank's blocks (a stored or compressed operator).  Two exchanges per
    sweep: the black half-sweep needs the freshly updated red halos."""

    def sweep(op, x, b):
        cd = compute_dtype(x.dtype)
        red = _global_parity(tuple(x.shape), mesh, spec, x.device)
        diag, bc = op.diag.to(cd), b.to(cd)
        for color in (True, False):
            off = _offdiag_exchange(op, x, mesh, spec)
            x = torch.where(red == color, (bc - off) / diag, x.to(cd)).to(b.dtype)
        return x

    return sweep


def make_halo_jacobi_sweep(mesh: GridMesh, spec: Spec,
                           omega: float = DEFAULT_JACOBI_WEIGHT):
    """Damped-Jacobi sweep with one exchange."""

    def sweep(op, x, b):
        cd = compute_dtype(x.dtype)
        off = _offdiag_exchange(op, x, mesh, spec)
        upd = (b.to(cd) - off) / op.diag.to(cd)
        return ((1.0 - omega) * x.to(cd) + omega * upd).to(x.dtype)

    return sweep


def global_max(value: torch.Tensor) -> torch.Tensor:
    """``all_reduce(MAX)`` of a scalar over every rank (exact, so every rank
    gets the same value)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    t = value.reshape(1).clone()
    staged = _staged(t.device)
    buf = t.cpu() if staged else t
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return (buf.to(value.device) if staged else buf)[0]


def make_halo_chebyshev_smoother(mesh: GridMesh, spec: Spec, degree: int | None = None,
                                 eig_ratio: float | None = None):
    """Chebyshev smoother with one exchange per operator apply; the
    Gershgorin bound ``lmax`` is made global (``all_reduce(MAX)``) so every
    block damps the same band as the single-device smoother."""
    degree = CHEBYSHEV_DEGREE if degree is None else degree
    eig_ratio = CHEBYSHEV_EIG_RATIO if eig_ratio is None else eig_ratio

    def smooth(op, x, b):
        cd = compute_dtype(x.dtype)
        xc, bc = x.to(cd), b.to(cd)
        diag = op.diag.to(cd)
        lmax = global_max(torch.max(1.0 + op.offdiag_abs_rowsum().to(cd) / diag))
        lmin = lmax / eig_ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta

        def apply_full(v):
            return diag * v + _offdiag_exchange(op, v, mesh, spec)

        r = bc - apply_full(xc)
        d = (r / diag) / theta
        rho = 1.0 / sigma
        for _ in range(degree):
            xc = xc + d
            r = r - apply_full(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (r / diag)
            rho = rho_new
        return (xc + d).to(x.dtype)

    return smooth


def make_halo_residual(mesh: GridMesh, spec: Spec):
    """``r = b - A x`` on this rank's blocks."""

    def res(op, x, b):
        cd = compute_dtype(x.dtype)
        off = _offdiag_exchange(op, x, mesh, spec)
        return (b.to(cd) - off - op.diag.to(cd) * x.to(cd)).to(x.dtype)

    return res


# ---------------------------------------------------------------------------
# the kernel path: B14 on each block, boundary slabs fixed here
# ---------------------------------------------------------------------------


def kernel_ok(op, x: torch.Tensor) -> bool:
    """3D blocks of radius-1 operators take B14 (the shard-local kernels and
    the 1-voxel slab fix are radius 1 only; 2D has no shard-local form)."""
    if x.dim() != 3:
        return False
    if isinstance(op, CompressedDCAOperator):
        return True
    return isinstance(op, StencilOperator) and op.radius == 1


def _kernel_module(op):
    if isinstance(op, CompressedDCAOperator):
        from ..ops import cuda_smoothers as mod
    else:
        from ..ops import cuda_stencil_stored as mod
    return mod


def _halfsweep_slab_fix(op, x_new, x, x_pad, b, color: int, mesh: GridMesh,
                        spec: Spec) -> torch.Tensor:
    """Recompute the half-sweep on the 1-voxel boundary slabs of split
    dimensions from the exchanged halos and write it into the kernel's output
    (whose masked contraction dropped every cross-block term there).  Slabs
    that overlap at edges and corners write the same values."""
    assert _op_radii(op) == (1,) * x.dim(), _op_radii(op)
    cd = compute_dtype(x.dtype)
    flip = _origin_parity(tuple(x.shape), mesh, spec)
    for d in sharded_dims(mesh, spec):
        for lo in (True, False):
            off = _local_offdiag_slab(op, x_pad, d, lo)
            sl, pos = _slab_slice(x.shape, d, lo)
            upd = (b[sl].to(cd) - off) / op.diag[sl].to(cd)
            # the slab's own checkerboard from global coordinates; colour 0
            # updates the globally even cells
            red = parity_mask(tuple(upd.shape), x.device)
            if (flip + pos) % 2:
                red = ~red
            x_new[sl] = torch.where(red == (color == 0), upd, x[sl].to(cd)).to(x.dtype)
    return x_new


def make_halo_kernel_rbgs_sweep(mesh: GridMesh, spec: Spec):
    """Red-black Gauss-Seidel sweep through B14 on each block: per
    half-sweep the kernel on the block (colour flipped on odd-origin
    blocks), the halo exchange, then the boundary slabs recomputed and
    spliced in.  Blocks the kernel does not take (2D, radius 2) run the
    plain halo sweep instead, as the JAX package runs XLA there."""
    fallback = make_halo_rbgs_sweep(mesh, spec)

    def sweep(op, x, b):
        if not kernel_ok(op, x):
            return fallback(op, x, b)
        mod = _kernel_module(op)
        flip = _origin_parity(tuple(x.shape), mesh, spec)
        for color in (0, 1):
            x_new = mod.halfsweep_local(op, x, b, color ^ flip)
            x_pad = exchange_halos(x, mesh, spec)
            x = _halfsweep_slab_fix(op, x_new, x, x_pad, b, color, mesh, spec)
        return x

    return sweep


def make_halo_kernel_residual(mesh: GridMesh, spec: Spec):
    """``r = b - A x`` through B14 on each block, boundary slabs recomputed
    from the exchanged halos."""
    fallback = make_halo_residual(mesh, spec)

    def res(op, x, b):
        if not kernel_ok(op, x):
            return fallback(op, x, b)
        r = _kernel_module(op).cuda_residual_local(op, x, b)
        x_pad = exchange_halos(x, mesh, spec)
        cd = compute_dtype(x.dtype)
        for d in sharded_dims(mesh, spec):
            for lo in (True, False):
                off = _local_offdiag_slab(op, x_pad, d, lo)
                sl, _ = _slab_slice(x.shape, d, lo)
                r[sl] = (b[sl].to(cd) - off - op.diag[sl].to(cd) * x[sl].to(cd)).to(x.dtype)
        return r

    return res
