"""Block distribution of the multigrid solve over ``torch.distributed`` ranks.

Counterpart of ``multigridanisotropicdiffusion_tpu.parallel.sharding``.  The
JAX package writes global-view ops and lets XLA's SPMD partitioner insert the
communication; PyTorch has no such partitioner, so here every rank owns one
device and one block of each level, and the communication is explicit code:
face exchanges between neighbours (:func:`exchange_faces`, used by
:mod:`.halo` and :mod:`.transfer`), gathers along the mesh axes
(:func:`gather_level`, :func:`gather_field`) or over every rank
(:func:`gather_ranks`, :mod:`.pipeline`) and global sums
(:func:`global_sum`).

A :class:`GridMesh` lays the ranks out in C order over a spatial mesh with
axes ``('x', 'y', 'z')[:ndim]``: mesh axis d splits array dimension d.
:func:`level_spec` decides per level which dimensions are split (the same
rule as the JAX package: divisible, and at least ``min_local`` points per
block); the others are replicated on every rank of that mesh axis, the
coarse-grid agglomeration.

Transport: with NCCL (one card per rank) tensors move device to device.
gloo's send and receive read the tensor's memory from the host, so under
gloo the faces of CUDA tensors are staged through host copies; the choice
is made from ``dist.get_backend()``.  Two gloo ranks may share one card
(NCCL refuses that), which is how one card runs a multi-rank solve.

Every decision a rank takes from data (the tolerance loop) reads a value
that all ranks computed identically: :func:`global_sum` gathers every
rank's partial sum and adds them in rank order on each rank.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import EXCHANGE, GATHER, span

#: Below this many points per axis per rank, stop splitting that axis.
DEFAULT_MIN_LOCAL = 8

Spec = Tuple[Optional[str], ...]


def factorize_devices(n: int, ndim: int) -> Tuple[int, ...]:
    """Split ``n`` ranks into an ``ndim``-dimensional mesh shape, as square
    as possible (e.g. 8 -> (4, 2) in 2D, (2, 2, 2) in 3D)."""
    dims = [1] * ndim
    factors = []
    m, d = n, 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for f in sorted(factors, reverse=True):
        i = int(np.argmin(dims))
        dims[i] *= f
    return tuple(sorted(dims, reverse=True))


@dataclasses.dataclass(frozen=True, eq=False)
class GridMesh:
    """The spatial mesh of ranks, as seen from one rank.

    ``groups[d]`` is the process group of the ranks that share every mesh
    coordinate but d (this rank's line along mesh axis d), None where the
    axis has size 1; ``device`` is where this rank's blocks live."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    coords: Tuple[int, ...]
    groups: Tuple[object, ...]
    device: torch.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def rank_of(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def neighbour(self, d: int, step: int) -> Optional[int]:
        """Global rank of the neighbour ``step`` (-1 or +1) along mesh axis
        ``d``, None at the mesh border."""
        c = list(self.coords)
        c[d] += step
        if not 0 <= c[d] < self.shape[d]:
            return None
        return self.rank_of(c)

    def __repr__(self) -> str:
        return (f"GridMesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


def require_mesh(mesh) -> GridMesh:
    """``mesh`` itself, or a TypeError when it is not a :class:`GridMesh`."""
    if not isinstance(mesh, GridMesh):
        raise TypeError(f"mesh must be a GridMesh (parallel.sharding.make_grid_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: a mesh's blocks live on the card "
                           "by default; pass device='cpu' to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_grid_mesh(ndim: int, mesh_shape: Tuple[int, ...] | None = None,
                   device=None) -> GridMesh:
    """A spatial mesh over every rank of the default process group, axes
    named 'x', 'y'[, 'z'].  Collective: every rank calls it, in the same
    order as its other group creations.  ``device`` defaults to
    ``cuda:LOCAL_RANK`` (modulo the card count, so gloo ranks may share a
    card) and raises without a card; ``device="cpu"`` asks for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid_mesh needs torch.distributed: call "
                           "initialize_multihost() first")
    n = dist.get_world_size()
    rank = dist.get_rank()
    if mesh_shape is None:
        mesh_shape = factorize_devices(n, ndim)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != ndim:
        raise ValueError(f"mesh_shape rank {len(mesh_shape)} != ndim {ndim}")
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh shape {mesh_shape} != rank count {n}")
    coords = tuple(int(c) for c in np.unravel_index(rank, mesh_shape))
    ranks = np.arange(n).reshape(mesh_shape)
    groups = []
    for d in range(ndim):
        mine = None
        if mesh_shape[d] > 1:
            # every line along axis d, in one order on every rank
            lines = np.moveaxis(ranks, d, -1).reshape(-1, mesh_shape[d])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = g
        groups.append(mine)
    device = torch.device(device) if device is not None else _default_device(rank)
    return GridMesh(mesh_shape, ("x", "y", "z")[:ndim], rank, coords, tuple(groups),
                    device)


def initialize_multihost(init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None,
                         backend: str | None = None) -> None:
    """Start ``torch.distributed`` for a multi-process run; a no-op when the
    default group is already up.

    Under ``torchrun`` the environment names everything (``env://``).
    Elsewhere pass ``init_method`` (``'tcp://host0:port'`` or
    ``'file:///shared/path'``), ``world_size`` and ``rank``.  With neither,
    a single process starts a world of one, so a one-rank mesh works.
    ``backend`` defaults to NCCL when every rank of a node has a card of
    its own, else gloo (NCCL refuses two ranks on one card)."""
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size or 1))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if cards >= local else "gloo"
    if init_method is None and world_size is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return
    if init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def make_multihost_grid_mesh(ndim: int, device=None) -> GridMesh:
    """Mesh for several nodes: nodes split the FIRST spatial axis, so each
    node owns a contiguous slab and only one face pair per node boundary
    crosses the network.  The ranks of a node (``LOCAL_WORLD_SIZE``, as
    ``torchrun`` sets it) are contiguous, so with C-order ranks the mesh
    ``(nodes * a, b, c)``, ``(a, b, c)`` the node's own factorization,
    gives exactly that layout.  One node: :func:`make_grid_mesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local >= world:
        return make_grid_mesh(ndim, device=device)
    if world % local:
        raise ValueError(f"{world} ranks do not split into nodes of {local}")
    node = factorize_devices(local, ndim)
    return make_grid_mesh(ndim, ((world // local) * node[0],) + node[1:], device)


def level_spec(mesh: GridMesh, shape: Tuple[int, ...],
               min_local: int = DEFAULT_MIN_LOCAL) -> Spec:
    """Which dimensions of a level of ``shape`` are split: dimension d over
    mesh axis d while the size divides evenly and the block keeps at least
    ``min_local`` points; otherwise None (replicated, agglomeration)."""
    spec = []
    for d, s in enumerate(shape):
        if d < mesh.ndim:
            per = mesh.shape[d]
            if per > 1 and s % per == 0 and s // per >= min_local:
                spec.append(mesh.axis_names[d])
                continue
        spec.append(None)
    return tuple(spec)


def sharded_dims(mesh: GridMesh, spec: Spec) -> Tuple[int, ...]:
    """The dimensions whose blocks actually cross rank boundaries."""
    return tuple(d for d, a in enumerate(spec) if a is not None and mesh.shape[d] > 1)


def block_range(mesh: GridMesh, spec: Spec, shape: Tuple[int, ...], d: int,
                coord: int | None = None) -> Tuple[int, int]:
    """``[start, stop)`` of dimension d held by the rank at mesh coordinate
    ``coord`` (this rank's by default)."""
    if spec[d] is None:
        return 0, shape[d]
    c = mesh.coords[d] if coord is None else coord
    q = shape[d] // mesh.shape[d]
    return c * q, (c + 1) * q


def shard_field(x: torch.Tensor, mesh: GridMesh, min_local: int = DEFAULT_MIN_LOCAL,
                spec: Spec | None = None) -> torch.Tensor:
    """This rank's block of the full field ``x`` (the trailing
    ``mesh.ndim`` dimensions are spatial; a leading stack dimension stays
    whole), contiguous, under ``spec`` or :func:`level_spec`."""
    shape = tuple(x.shape[-mesh.ndim:])
    if spec is None:
        spec = level_spec(mesh, shape, min_local)
    lead = (slice(None),) * (x.dim() - mesh.ndim)
    block = tuple(slice(*block_range(mesh, spec, shape, d)) for d in range(len(shape)))
    return x[lead + block].contiguous()


def shard_operator(op, mesh: GridMesh, min_local: int = DEFAULT_MIN_LOCAL,
                   spec: Spec | None = None):
    """This rank's block of a stored or compressed operator (its planes cut
    like the fields they multiply; the shape is read off the operator, which
    may be a padded embedding)."""
    from ..core.stencil import StencilOperator
    from ..ops.compressed import CompressedDCAOperator

    if isinstance(op, CompressedDCAOperator):
        return CompressedDCAOperator(shard_field(op.planes, mesh, min_local, spec), op.ndim)
    if isinstance(op, StencilOperator):
        return StencilOperator(shard_field(op.coeffs, mesh, min_local, spec), op.offsets)
    raise TypeError(f"no block form for {type(op).__name__}: the distributed solve "
                    "takes stored or compressed operators")


def shard_hierarchy(hierarchy, mesh: GridMesh, min_local: int = DEFAULT_MIN_LOCAL):
    """Every level's operator cut to this rank's block; the coarsest
    level's direct solver stays whole (it runs replicated)."""
    from ..models.mad import Hierarchy

    ops = tuple(shard_operator(op, mesh, min_local) for op in hierarchy.operators)
    return Hierarchy(operators=ops, solver=hierarchy.solver)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _staged(device: torch.device) -> bool:
    """Whether tensors of ``device`` go through the host: gloo reads the
    memory of what it sends from the host."""
    return device.type == "cuda" and dist.get_backend() != "nccl"


def exchange_faces(mesh: GridMesh, d: int, to_lo: torch.Tensor | None,
                   to_hi: torch.Tensor | None, from_lo_shape, from_hi_shape,
                   dtype: torch.dtype, device: torch.device):
    """One exchange along mesh axis ``d``: ``to_lo`` goes to the lower
    neighbour, ``to_hi`` to the upper one, and what they send back arrives
    as ``(from_lo, from_hi)`` of the given shapes (None at the mesh border or
    where a shape is empty).  Both sides derive the shapes from the same
    global layout, so every send meets its receive.  All of it one
    ``batch_isend_irecv``, waited on before returning (a ``madt.exchange``
    range in a profiler trace)."""
    with span(EXCHANGE):
        return _exchange(mesh.neighbour(d, -1), mesh.neighbour(d, 1), to_lo, to_hi,
                         from_lo_shape, from_hi_shape, dtype, device)


# ---------------------------------------------------------------------------
# the halo shell: faces exchanged beside the contraction
# ---------------------------------------------------------------------------

#: a box of the block padded by its halos: ``(start, stop)`` per dimension
Box = Tuple[Tuple[int, int], ...]


def halo_boxes(shape, radii, d: int) -> Tuple[Box, Box]:
    """The low and high halo of dimension ``d`` in the padded block: whole
    (corners included) along the dimensions before d, the interior along
    those after it, the order in which the halos are exchanged."""
    r, s = radii[d], shape[d]
    return tuple(tuple((0, n + 2 * q) if dd < d else rows if dd == d else (q, q + n)
                       for dd, (n, q) in enumerate(zip(shape, radii)))
                 for rows in ((0, r), (s + r, s + 2 * r)))


def assemble(box: Box, pieces, dtype: torch.dtype, device, pin: bool = False) -> torch.Tensor:
    """``box`` of the padded block from ``pieces`` (``(box, tensor)`` pairs
    in the same coordinates, on ``device``), zero where none reaches: a
    piece that is the box itself, or a new tensor (``pin``: page-locked
    host memory, whose cached blocks a large host face needs, where fresh
    pages would each fault in)."""
    for pbox, t in pieces:
        if pbox == box:
            return t
    out = torch.zeros([b - a for a, b in box], dtype=dtype, device=device, pin_memory=pin)
    for pbox, t in pieces:
        lo = [max(a, pa) for (a, _), (pa, _) in zip(box, pbox)]
        hi = [min(b, pb) for (_, b), (_, pb) in zip(box, pbox)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        out[tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, box))] = \
            t[tuple(slice(l - pa, h - pa) for l, h, (pa, _) in zip(lo, hi, pbox))]
    return out


@dataclasses.dataclass(frozen=True)
class HaloShell:
    """A block and the halos received around it: ``halos[d] = (lo, hi)``
    per split dimension, in the shapes of :func:`halo_boxes` (None at the
    mesh border: zeros)."""

    x: torch.Tensor
    radii: Tuple[int, ...]
    halos: dict

    def pieces(self) -> list:
        shape = tuple(self.x.shape)
        out = [(tuple((r, r + n) for n, r in zip(shape, self.radii)), self.x)]
        for d, pair in self.halos.items():
            out += [(box, t) for box, t in zip(halo_boxes(shape, self.radii, d), pair)
                    if t is not None]
        return out

    def region(self, box: Box) -> torch.Tensor:
        """``box`` of the padded block, the halos' corners included."""
        return assemble(box, self.pieces(), self.x.dtype, self.x.device)


_SIDE_STREAMS: dict = {}


def ready_event(x: torch.Tensor):
    """An event on the current stream after ``x`` was last written (None on
    the CPU): pass it to :func:`exchange_halo_shell` and queue the
    contraction between the two."""
    if x.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return event


def exchange_halo_shell(x: torch.Tensor, mesh: GridMesh, spec: Spec,
                        radii: Tuple[int, ...], ready) -> HaloShell:
    """The halos of ``x`` (as thick as ``radii``) from its neighbours along
    the split dimensions, dimension by dimension, each face carrying the
    halos already received (the corners), as :func:`..halo.exchange_halos`
    does, but without a padded copy of the block.

    On a CUDA tensor the faces move on a side stream that first waits on
    ``ready`` (:func:`ready_event`), so work queued on the current stream
    since then (the contraction) runs during the exchange; the current
    stream waits for the received halos at the end.  Under gloo the host
    blocks on the side stream's copies of the faces only, and the corners
    of later dimensions are built from host tensors; under NCCL the
    point-to-point operations are issued with the side stream current.  On
    the CPU the same steps run in program order.  A ``madt.exchange`` range
    in a profiler trace."""
    shape = tuple(x.shape)
    dims = sharded_dims(mesh, spec)
    for d in dims:
        if shape[d] < radii[d]:
            raise ValueError(f"local block dim {d} ({shape[d]}) smaller than the stencil "
                             f"radius {radii[d]}: raise min_local")
    if not dims:
        return HaloShell(x, tuple(radii), {})
    slabs = {d: (x.narrow(d, 0, radii[d]), x.narrow(d, shape[d] - radii[d], radii[d]))
             for d in dims}
    with span(EXCHANGE):
        if x.device.type != "cuda":
            return HaloShell(x, tuple(radii), _shell(slabs, mesh, radii, shape, x.dtype,
                                                     x.device, False))
        main = torch.cuda.current_stream(x.device)
        side = _SIDE_STREAMS.get(x.device)
        if side is None:
            side = _SIDE_STREAMS[x.device] = torch.cuda.Stream(x.device)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            x.record_stream(side)
            if _staged(x.device):
                # the boundary slabs to page-locked host memory, then the
                # host waits for these copies alone
                slabs = {d: tuple(torch.empty(f.shape, dtype=x.dtype, pin_memory=True)
                                  .copy_(f, non_blocking=True) for f in pair)
                         for d, pair in slabs.items()}
                side.synchronize()
                halos = _shell(slabs, mesh, radii, shape, x.dtype, torch.device("cpu"), True)
                halos = {d: tuple(None if t is None else t.to(x.device, non_blocking=True)
                                  for t in pair) for d, pair in halos.items()}
            else:
                halos = _shell(slabs, mesh, radii, shape, x.dtype, x.device, False)
            done = torch.cuda.Event()
            done.record(side)
        main.wait_event(done)
        for pair in halos.values():
            for t in pair:
                if t is not None:
                    t.record_stream(main)
        return HaloShell(x, tuple(radii), halos)


def _shell(slabs: dict, mesh: GridMesh, radii, shape, dtype, device, pin: bool) -> dict:
    """The exchange of :func:`exchange_halo_shell` on ``device`` from
    ``slabs = {d: (lo, hi)}``, the block's boundary slabs along every split
    dimension there (views of the block, or its host copies under gloo);
    ``pin``: page-locked faces and receive buffers."""
    interior = tuple((r, r + n) for n, r in zip(shape, radii))
    halos, received = {}, []
    for d, pair in slabs.items():
        r, s = radii[d], shape[d]
        rows = ((r, 2 * r), (s, s + r))
        pieces = [(interior[:d] + (rw,) + interior[d + 1:], slab)
                  for rw, slab in zip(rows, pair)] + received
        boxes = halo_boxes(shape, radii, d)
        # the faces sent: the rows of the padded block just inside each halo
        faces = [assemble(box[:d] + (rw,) + box[d + 1:], pieces, dtype, device, pin)
                 for box, rw in zip(boxes, rows)]
        halos[d] = _transfer(mesh.neighbour(d, -1), mesh.neighbour(d, 1), *faces,
                             faces[0].shape, faces[1].shape, dtype, device, pin)
        received += [(box, t) for box, t in zip(boxes, halos[d]) if t is not None]
    return halos


def _exchange(lo_peer, hi_peer, to_lo, to_hi, from_lo_shape, from_hi_shape, dtype, device):
    staged = _staged(device)
    comm = torch.device("cpu") if staged else device
    if staged:
        to_lo, to_hi = (None if t is None else t.to(comm) for t in (to_lo, to_hi))
    recvs = _transfer(lo_peer, hi_peer, to_lo, to_hi, from_lo_shape, from_hi_shape, dtype,
                      comm)
    return tuple(None if r is None else r.to(device) for r in recvs)


def _transfer(lo_peer, hi_peer, to_lo, to_hi, from_lo_shape, from_hi_shape, dtype, comm,
              pin: bool = False):
    """Send ``to_lo``/``to_hi`` and receive ``(from_lo, from_hi)``, every
    tensor on ``comm`` (the host under gloo; ``pin``: page-locked receive
    buffers), as one ``batch_isend_irecv`` waited on before returning (under
    NCCL the wait is the current stream's, not the host's)."""
    ops, recvs = [], [None, None]
    for side, peer, send, shape in ((0, lo_peer, to_lo, from_lo_shape),
                                    (1, hi_peer, to_hi, from_hi_shape)):
        if peer is None:
            continue
        # moved as bytes, so every dtype goes through every backend
        if send is not None and send.numel():
            ops.append(dist.P2POp(dist.isend, send.contiguous().reshape(-1).view(torch.uint8),
                                  peer))
        if shape is not None and math.prod(shape):
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            recvs[side] = torch.empty(nbytes, dtype=torch.uint8, device=comm, pin_memory=pin)
            ops.append(dist.P2POp(dist.irecv, recvs[side], peer))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    shapes = (from_lo_shape, from_hi_shape)
    return tuple(None if r is None else r.view(dtype).reshape(tuple(shp))
                 for r, shp in zip(recvs, shapes))


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (equal shapes) along ``group``, in group order;
    moved as bytes, so any dtype goes through any backend (a
    ``madt.gather`` range in a profiler trace)."""
    with span(GATHER):
        staged = _staged(t.device)
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        if staged:
            flat = flat.cpu()
        out = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, flat, group=group)
        return [o.to(t.device).view(t.dtype).reshape(t.shape) for o in out]


def gather_ranks(x: torch.Tensor, mesh: GridMesh, dim: int) -> torch.Tensor:
    """Concatenate the equal tensors of every rank of the mesh, in rank
    order, along ``dim``."""
    if mesh.size == 1:
        return x
    return torch.cat(_all_gather(x, None), dim=dim)


def gather_axis(x: torch.Tensor, mesh: GridMesh, d: int, dim: int | None = None) -> torch.Tensor:
    """Concatenate the equal blocks of the ranks along mesh axis ``d``
    (tensor dimension ``dim``, d by default)."""
    if mesh.shape[d] == 1:
        return x
    return torch.cat(_all_gather(x, mesh.groups[d]), dim=d if dim is None else dim)


def gather_level(x: torch.Tensor, mesh: GridMesh, spec: Spec) -> torch.Tensor:
    """The whole level from this rank's block under ``spec`` (trailing
    spatial dimensions)."""
    lead = x.dim() - mesh.ndim
    for d in sharded_dims(mesh, spec):
        x = gather_axis(x, mesh, d, lead + d)
    return x


def global_sum(value: torch.Tensor, mesh: GridMesh, spec: Spec) -> torch.Tensor:
    """The sum over the whole level of per-rank partial sums ``value`` (a
    scalar): every rank gathers every partial and adds those of the ranks
    that own distinct blocks (coordinate 0 along the replicated axes) in
    rank order, so all ranks get the same bits."""
    if mesh.size == 1:
        return value
    parts = _all_gather(value.reshape(1), None)
    split = set(sharded_dims(mesh, spec))
    total = None
    for r, p in enumerate(parts):
        c = np.unravel_index(r, mesh.shape)
        if any(c[d] != 0 for d in range(mesh.ndim) if d not in split):
            continue
        total = p[0] if total is None else total + p[0]
    return total


def output_range(mesh: GridMesh, n: int, d: int) -> Tuple[int, int]:
    """``[start, stop)`` of dimension d (``n`` points) held by this rank in
    the output layout of a distributed call: blocks of ``ceil(n / p)`` along
    every mesh axis, the last ones cut at ``n`` (possibly empty)."""
    c = mesh.coords[d]
    q = -(-n // mesh.shape[d])
    return min(c * q, n), min((c + 1) * q, n)


def output_block(x: torch.Tensor, mesh: GridMesh, shape: Tuple[int, ...],
                 spec: Spec, level_shape: Tuple[int, ...]) -> torch.Tensor:
    """This rank's block of the output layout (:func:`output_range`) of a
    true ``shape``, cut from its block of a level of ``level_shape`` (the
    true shape or a padded embedding) held under ``spec``."""
    lead = x.dim() - mesh.ndim
    idx = [slice(None)] * lead
    for d, n in enumerate(shape):
        lo, hi = output_range(mesh, n, d)
        off = block_range(mesh, spec, level_shape, d)[0]
        # an empty range may start before a padded block's origin
        idx.append(slice(max(lo - off, 0), max(hi - off, 0)))
    return x[tuple(idx)].contiguous()


def gather_field(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The whole field from every rank's block of a distributed call's
    output (:func:`output_range`; trailing spatial dimensions, blocks of
    unequal size allowed), on every rank: the counterpart of
    ``multihost_utils.process_allgather(..., tiled=True)``."""
    lead = x.dim() - mesh.ndim
    for d in range(mesh.ndim):
        if mesh.shape[d] == 1:
            continue
        dim = lead + d
        sizes = [int(s) for s in _all_gather(
            torch.tensor([x.shape[dim]], dtype=torch.int64, device=x.device),
            mesh.groups[d])]
        q = max(sizes)
        pad_shape = list(x.shape)
        pad_shape[dim] = q - x.shape[dim]
        padded = torch.cat([x, x.new_zeros(pad_shape)], dim=dim) if pad_shape[dim] else x
        parts = _all_gather(padded, mesh.groups[d])
        x = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
    return x
