"""Halo-exchange smoothers and residuals on the blocks of a distributed solve.

Counterpart of ``multigridanisotropicdiffusion_tpu.parallel.halo``.  Each
rank holds one block of a level (:mod:`.sharding`); faces as thick as the
operator's radius move between neighbours (:func:`exchange_halos`, one
``batch_isend_irecv`` per split dimension), and the smoother runs on the
local block with its halo ring.  Ghost values outside the *global* domain
are zero, the contract of the boundary-folded operators.  Red-black parity
comes from *global* coordinates, so the colouring does not depend on the
partition.  Every split dimension must divide evenly (see :mod:`.padding`).

Two schedules, the JAX package's two modes (``MADConfig.halo``):

* ``overlap=False`` (``'shard_map'``): exchange, then contract over the
  padded block (:func:`exchange_halos`).
* ``overlap=True`` (``'overlap'``): contract against *zero* halos first,
  with no dependency on the exchange, then exchange the faces
  (:func:`.sharding.exchange_halo_shell`: on a side CUDA stream that waits
  only for the block, so the contraction already queued runs during it) and
  recompute just the radius-thick boundary slabs of the split dimensions
  from a slab-local padded piece, spliced in.  Away from those slabs the
  zero halos change nothing (the global borders' folded coefficients are
  zero), and the slabs are recomputed whole, term for term, so both
  schedules give the same bits.

The kernel path (:func:`make_halo_kernel_rbgs_sweep`,
:func:`make_halo_kernel_residual`, the JAX package's
``make_halo_pallas_*``) is overlapped in both modes, as the JAX package's
Pallas path is: the shard-local kernel B14 runs on each 3D block of a
radius-1 operator (``ops.cuda_smoothers.halfsweep_local``; the blocks
that ``x.dim() == 3 and kernel_takes(op, max_radius=1)`` admits, as the
JAX package's ``pallas_compatible(op, max_radius=1)`` does), dropping
every term that crosses the block's border, while the faces move; the
1-voxel boundary slabs are then recomputed in plain PyTorch from
slab-local pieces of the exchanged shell (:func:`_halfsweep_slab_fix`),
and the colour is flipped on blocks whose
global origin is odd (the kernel's parity is the local index sum).  It
builds no padded copy of the block.  On a CPU tensor the wrappers take
their plain versions and the exchange runs in program order.

Arithmetic follows the port's rule: 16-bit storage computes in float32 and
rounds once per half-sweep, Jacobi sweep, Chebyshev call or residual.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..core.stencil import compute_dtype
from ..ops import cuda_smoothers
from ..ops.compressed import CompressedDCAOperator
from ..ops.smoothers import CHEBYSHEV_DEGREE, CHEBYSHEV_EIG_RATIO, DEFAULT_JACOBI_WEIGHT, parity_mask
from .sharding import (
    GridMesh,
    Spec,
    _staged,
    exchange_faces,
    exchange_halo_shell,
    ready_event,
    sharded_dims,
)


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


def _slab_slice(shape, d: int, lo: bool, t: int = 1):
    """Index of the ``t``-thick boundary slab of dimension d, and its
    start."""
    pos = 0 if lo else shape[d] - t
    return tuple(slice(pos, pos + t) if dd == d else slice(None)
                 for dd in range(len(shape))), pos


def _slab_box(shape, radii, d: int, lo: bool):
    """The piece of the padded block that the ``radii[d]``-thick boundary
    slab of dimension d reads (the slab plus a halo's thickness on each side
    along d, the whole padded extent elsewhere), and its start along d."""
    t = radii[d]
    pos = 0 if lo else shape[d] - t
    box = tuple((pos, pos + t + 2 * r) if dd == d else (0, n + 2 * r)
                for dd, (n, r) in enumerate(zip(shape, radii)))
    return box, pos


def _local_offdiag_slab(op, x_pad: torch.Tensor, d: int, lo: bool,
                        radii: Tuple[int, ...], start: int) -> torch.Tensor:
    """Off-diagonal contraction of the ``radii[d]``-thick boundary slab of
    dimension d, read from the halo-padded block whose dimension d starts at
    padded row ``start`` (a :func:`_slab_box` piece starts at the slab's
    own start): the complete value there, the corner terms through other
    dimensions' halos included."""
    shape = op.shape
    t = radii[d]
    coeff_sl, pos = _slab_slice(shape, d, lo, t)
    cd = compute_dtype(x_pad.dtype)
    out = None
    for off, plane, sign in _offdiag_terms(op):
        sl = tuple(slice(r + pos + o - start, r + pos + t + o - start) if dd == d
                   else slice(r + o, r + o + s)
                   for dd, (o, s, r) in enumerate(zip(off, shape, radii)))
        term = sign * plane[coeff_sl].to(cd) * x_pad[sl].to(cd)
        out = term if out is None else out + term
    return out


def _slabs(op, region, mesh: GridMesh, spec: Spec, radii: Tuple[int, ...]):
    """Per boundary slab of every split dimension: its index and start in
    the block, and its off-diagonal contraction read from ``region(box)``
    (that box of the padded block)."""
    shape = tuple(op.shape)
    for d in sharded_dims(mesh, spec):
        for lo in (True, False):
            box, start = _slab_box(shape, radii, d, lo)
            sl, pos = _slab_slice(shape, d, lo, radii[d])
            yield sl, pos, _local_offdiag_slab(op, region(box), d, lo, radii, start)


def _offdiag_exchange(op, x: torch.Tensor, mesh: GridMesh, spec: Spec,
                      overlap: bool = False) -> torch.Tensor:
    """Off-diagonal contraction of the local block with the true neighbour
    halos.  ``overlap=False``: exchange, then one contraction over the
    padded block.  ``overlap=True``: contract against zero halos at once,
    exchange beside it, then recompute the radius-thick boundary slabs of
    the split dimensions and splice them in (the same bits)."""
    radii = _op_radii(op)
    if not overlap:
        return _local_offdiag(op, exchange_halos(x, mesh, spec, radii), radii)
    ready = ready_event(x)
    x_zero = x.new_zeros([s + 2 * r for s, r in zip(x.shape, radii)])
    x_zero[tuple(slice(r, r + s) for r, s in zip(radii, x.shape))] = x
    off = _local_offdiag(op, x_zero, radii)
    shell = exchange_halo_shell(x, mesh, spec, radii, ready)
    for sl, _, slab in _slabs(op, shell.region, mesh, spec, radii):
        off[sl] = slab
    return off


def _origin_parity(shape_local: Tuple[int, ...], mesh: GridMesh, spec: Spec) -> int:
    """Parity of the block's global origin-coordinate sum."""
    return sum(mesh.coords[d] * shape_local[d] for d in sharded_dims(mesh, spec)) % 2


def _global_parity(shape_local: Tuple[int, ...], mesh: GridMesh, spec: Spec,
                   device) -> torch.Tensor:
    """Checkerboard from global coordinates: True where their sum is even."""
    red = parity_mask(shape_local, device)
    return ~red if _origin_parity(shape_local, mesh, spec) else red


def make_halo_rbgs_sweep(mesh: GridMesh, spec: Spec, overlap: bool = False):
    """``sweep(op, x, b) -> x'``: a red-black Gauss-Seidel sweep on this
    rank's blocks (a stored or compressed operator).  Two exchanges per
    sweep: the black half-sweep needs the freshly updated red halos.  With
    ``overlap`` each half-sweep's contraction runs beside its exchange
    (:func:`_offdiag_exchange`)."""

    def sweep(op, x, b):
        cd = compute_dtype(x.dtype)
        red = _global_parity(tuple(x.shape), mesh, spec, x.device)
        diag, bc = op.diag.to(cd), b.to(cd)
        for color in (True, False):
            off = _offdiag_exchange(op, x, mesh, spec, overlap)
            x = torch.where(red == color, (bc - off) / diag, x.to(cd)).to(b.dtype)
        return x

    return sweep


def make_halo_jacobi_sweep(mesh: GridMesh, spec: Spec,
                           omega: float = DEFAULT_JACOBI_WEIGHT, overlap: bool = False):
    """Damped-Jacobi sweep with one exchange."""

    def sweep(op, x, b):
        cd = compute_dtype(x.dtype)
        off = _offdiag_exchange(op, x, mesh, spec, overlap)
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
                                 eig_ratio: float | None = None, overlap: bool = False):
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
            return diag * v + _offdiag_exchange(op, v, mesh, spec, overlap)

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


def make_halo_residual(mesh: GridMesh, spec: Spec, overlap: bool = False):
    """``r = b - A x`` on this rank's blocks."""

    def res(op, x, b):
        cd = compute_dtype(x.dtype)
        off = _offdiag_exchange(op, x, mesh, spec, overlap)
        return (b.to(cd) - off - op.diag.to(cd) * x.to(cd)).to(x.dtype)

    return res


# ---------------------------------------------------------------------------
# the kernel path: B14 on each block, boundary slabs fixed here
# ---------------------------------------------------------------------------


def _halfsweep_slab_fix(op, x_new, x, region, b, color: int, mesh: GridMesh,
                        spec: Spec) -> torch.Tensor:
    """Recompute the half-sweep on the 1-voxel boundary slabs of split
    dimensions from the exchanged halos (``region(box)``: that box of the
    padded block) and write it into the kernel's output (whose masked
    contraction dropped every cross-block term there).  Slabs that overlap
    at edges and corners write the same values."""
    radii = (1,) * x.dim()
    assert _op_radii(op) == radii, _op_radii(op)
    cd = compute_dtype(x.dtype)
    flip = _origin_parity(tuple(x.shape), mesh, spec)
    for sl, pos, off in _slabs(op, region, mesh, spec, radii):
        upd = (b[sl].to(cd) - off) / op.diag[sl].to(cd)
        # the slab's own checkerboard from global coordinates; colour 0
        # updates the globally even cells
        red = parity_mask(tuple(upd.shape), x.device)
        if (flip + pos) % 2:
            red = ~red
        x_new[sl] = torch.where(red == (color == 0), upd, x[sl].to(cd)).to(x.dtype)
    return x_new


def _residual_slab_fix(op, r, x, region, b, mesh: GridMesh, spec: Spec) -> torch.Tensor:
    """The residual's 1-voxel boundary slabs of split dimensions recomputed
    from the exchanged halos and written into the kernel's output."""
    radii = (1,) * x.dim()
    assert _op_radii(op) == radii, _op_radii(op)
    cd = compute_dtype(x.dtype)
    for sl, _, off in _slabs(op, region, mesh, spec, radii):
        r[sl] = (b[sl].to(cd) - off - op.diag[sl].to(cd) * x[sl].to(cd)).to(x.dtype)
    return r


def make_halo_kernel_rbgs_sweep(mesh: GridMesh, spec: Spec):
    """Red-black Gauss-Seidel sweep through B14 on each block, overlapped
    in both modes: per half-sweep the kernel on the block (colour flipped on
    odd-origin blocks) is queued first, the faces move beside it, then the
    boundary slabs are recomputed and spliced in.  Blocks the kernel does
    not take (2D, radius 2) run the overlapped plain halo sweep, as the JAX
    package runs XLA there."""
    fallback = make_halo_rbgs_sweep(mesh, spec, overlap=True)

    def sweep(op, x, b):
        if not (x.dim() == 3 and cuda_smoothers.kernel_takes(op, max_radius=1)):
            return fallback(op, x, b)
        radii = (1,) * x.dim()
        flip = _origin_parity(tuple(x.shape), mesh, spec)
        for color in (0, 1):
            ready = ready_event(x)
            x_new = cuda_smoothers.halfsweep_local(op, x, b, color ^ flip)
            shell = exchange_halo_shell(x, mesh, spec, radii, ready)
            x = _halfsweep_slab_fix(op, x_new, x, shell.region, b, color, mesh, spec)
        return x

    return sweep


def make_halo_kernel_residual(mesh: GridMesh, spec: Spec):
    """``r = b - A x`` through B14 on each block, the faces moving beside
    it, boundary slabs recomputed from the exchanged halos."""
    fallback = make_halo_residual(mesh, spec, overlap=True)

    def res(op, x, b):
        if not (x.dim() == 3 and cuda_smoothers.kernel_takes(op, max_radius=1)):
            return fallback(op, x, b)
        ready = ready_event(x)
        r = cuda_smoothers.cuda_residual_local(op, x, b)
        shell = exchange_halo_shell(x, mesh, spec, (1,) * x.dim(), ready)
        return _residual_slab_fix(op, r, x, shell.region, b, mesh, spec)

    return res
