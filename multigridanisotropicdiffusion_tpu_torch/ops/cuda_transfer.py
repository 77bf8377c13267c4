"""The 3D transfer kernels: restriction and prolongation for every centring
(``csrc/transfer.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_transfer``
(``pallas_restrict3d``, ``pallas_prolong3d``), without their all-cell,
X % 256 gate.  The kernels read per-axis tap tables built on the host from
the 1-D transfer matrices (:func:`.transfer.restrict_taps`,
:func:`.transfer.prolong_taps`) and cached on the device per shape.  A
leading batch axis is allowed: ``(B, Z, Y, X)`` restricts B fields in one
launch.  :func:`cuda_prolong_add` is the prolongation's add form, ``x + P
e`` in one pass (the V-cycle's correction), bit for bit ``x +
cuda_prolong(e)``.  Each wrapper takes the plain version for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.

The block form (:func:`restrict_block`, :func:`prolong_block`) serves the
distributed solve (:mod:`..parallel.transfer`): the same kernels on one
rank's halo-extended block, with per-axis tables the caller gives (rows of
the global tables, starts shifted into the block) as a :class:`BlockTables`,
whose device copies it keeps.  Their plain version is
:func:`.transfer.apply_taps_plain`.

``cuda_restrict.launches`` and ``cuda_prolong.launches`` count launches,
the block form's included; ``cuda_prolong.launches`` counts the add form's
too (one kernel, B4).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .transfer import (
    apply_taps_plain,
    coarse_size,
    fine_size,
    prolong_add_plain,
    prolong_plain,
    prolong_taps,
    restrict_plain,
    restrict_taps,
)


@functools.lru_cache(maxsize=128)
def _device_tables(kind: str, fine_shape: Tuple[int, ...],
                   centering: Tuple[str, ...], weight_dtype: torch.dtype,
                   device: torch.device):
    """Per-axis (start, weights) tables on ``device``, as two flat tensors
    plus each axis's offset into them."""
    taps = restrict_taps if kind == "restrict" else prolong_taps
    tables = [taps(n, c) for n, c in zip(fine_shape, centering)]
    starts = torch.as_tensor(np.concatenate([s for s, _ in tables]),
                             dtype=torch.int32, device=device)
    weights = torch.as_tensor(np.concatenate([w.ravel() for _, w in tables]),
                              dtype=weight_dtype, device=device)
    s_off = np.cumsum([0] + [len(s) for s, _ in tables[:-1]]).tolist()
    w_off = np.cumsum([0] + [w.size for _, w in tables[:-1]]).tolist()
    return starts, weights, s_off, w_off


def _table_pointers(kind, fine_shape, centering, dtype, device):
    starts, weights, s_off, w_off = _device_tables(
        kind, tuple(fine_shape), tuple(centering), compute_dtype(dtype), device
    )
    sp = [starts.data_ptr() + o * starts.element_size() for o in s_off]
    wp = [weights.data_ptr() + o * weights.element_size() for o in w_off]
    return sp + wp


def _check(name: str, x: torch.Tensor, centering) -> None:
    require_cuda(name, x)
    if len(centering) != 3 or x.dim() not in (3, 4):
        raise ValueError(
            f"{name}: the kernel takes (Z, Y, X) or (B, Z, Y, X) fields with 3 "
            f"centerings, got shape {tuple(x.shape)}, centering {centering}"
        )


def cuda_restrict(x: torch.Tensor, centering: Tuple[str, ...]) -> torch.Tensor:
    """Full-weighting restriction over the trailing three axes."""
    if x.device.type == "cpu":
        return restrict_plain(x, centering)
    _check("cuda_restrict", x, centering)
    fine = tuple(x.shape[-3:])
    coarse = tuple(coarse_size(n, c) for n, c in zip(fine, centering))
    batch = math.prod(x.shape[:-3])
    if batch * coarse[0] > 65535:
        raise ValueError(f"cuda_restrict: batch * Z of {tuple(x.shape)} too large")
    out = torch.empty((*x.shape[:-3], *coarse), dtype=x.dtype, device=x.device)
    err = kernel("mad_restrict3d", x.dtype)(
        x.data_ptr(), out.data_ptr(), batch, *fine, *coarse,
        *_table_pointers("restrict", fine, centering, x.dtype, x.device),
        stream_of(x),
    )
    check_launch(err, "cuda_restrict")
    cuda_restrict.launches += 1
    return out


cuda_restrict.launches = 0


#: the fewest fine planes a prolongation block runs (``kPZ`` in
#: ``csrc/transfer.cu``: 16, 64 in bf16): bounds the launch's z extent
PROLONG_PLANES = 16


def _prolong_shapes(name, e, centering):
    coarse = tuple(e.shape[-3:])
    fine = tuple(fine_size(n, c) for n, c in zip(coarse, centering))
    batch = math.prod(e.shape[:-3])
    if batch * -(-fine[0] // PROLONG_PLANES) > 65535:
        raise ValueError(f"{name}: batch * Z of the fine field too large")
    return coarse, fine, batch


def cuda_prolong(x: torch.Tensor, centering: Tuple[str, ...]) -> torch.Tensor:
    """Linear prolongation ``P e`` over the trailing three axes."""
    if x.device.type == "cpu":
        return prolong_plain(x, centering)
    _check("cuda_prolong", x, centering)
    coarse, fine, batch = _prolong_shapes("cuda_prolong", x, centering)
    out = torch.empty((*x.shape[:-3], *fine), dtype=x.dtype, device=x.device)
    err = kernel("mad_prolong3d", x.dtype)(
        x.data_ptr(), out.data_ptr(), batch, *coarse, *fine,
        *_table_pointers("prolong", fine, centering, x.dtype, x.device),
        stream_of(x),
    )
    check_launch(err, "cuda_prolong")
    cuda_prolong.launches += 1
    return out


cuda_prolong.launches = 0


def cuda_prolong_add(x: torch.Tensor, e: torch.Tensor,
                     centering: Tuple[str, ...]) -> torch.Tensor:
    """``x + P e`` over the trailing three axes in one pass, into a new
    tensor (``x`` is left as it is): ``P e`` is summed as in
    :func:`cuda_prolong` and rounded to the storage dtype, the add runs in the
    compute dtype and rounds once, so the result is bit for bit ``x +
    cuda_prolong(e)``.  Counts on ``cuda_prolong.launches``."""
    if x.device.type == "cpu" and e.device.type == "cpu":
        return prolong_add_plain(x, e, centering)
    _check("cuda_prolong_add", e, centering)
    require_cuda("cuda_prolong_add", e, x)
    coarse, fine, batch = _prolong_shapes("cuda_prolong_add", e, centering)
    if tuple(x.shape) != (*e.shape[:-3], *fine):
        raise ValueError(f"cuda_prolong_add: x of shape {tuple(x.shape)} is not the "
                         f"prolongation of {tuple(e.shape)} ({fine})")
    out = torch.empty_like(x)
    err = kernel("mad_prolong_add3d", x.dtype)(
        e.data_ptr(), x.data_ptr(), out.data_ptr(), batch, *coarse, *fine,
        *_table_pointers("prolong", fine, centering, x.dtype, x.device),
        stream_of(x),
    )
    check_launch(err, "cuda_prolong_add")
    cuda_prolong.launches += 1
    return out


# ---------------------------------------------------------------------------
# the block form: explicit tables
# ---------------------------------------------------------------------------


class BlockTables:
    """Per-axis ``(start, weights)`` tables of one block transfer (int32
    starts into the block, ``taps`` weights per output row), with their
    copies on ``device`` in the compute dtype of ``dtype`` and the six axis
    pointers the kernels take, made once: the caller keeps it for every
    transfer of that level."""

    def __init__(self, tables, taps: int, dtype: torch.dtype, device):
        self.tables = tuple((np.asarray(s, np.int32), np.asarray(w)) for s, w in tables)
        if len(self.tables) != 3 or any(w.shape != (len(s), taps) for s, w in self.tables):
            raise ValueError(f"block tables: 3 axes of {taps} weights per row")
        self.out_shape = tuple(len(s) for s, _ in self.tables)
        self.weight_dtype = compute_dtype(dtype)
        self.device = torch.device(device)
        self.ptrs = None
        if self.device.type == "cuda":
            self.starts = torch.as_tensor(np.concatenate([s for s, _ in self.tables]),
                                          dtype=torch.int32, device=self.device)
            self.weights = torch.as_tensor(
                np.concatenate([w.ravel() for _, w in self.tables]),
                dtype=self.weight_dtype, device=self.device)
            s_off = np.cumsum([0] + [len(s) for s, _ in self.tables[:-1]]).tolist()
            w_off = np.cumsum([0] + [w.size for _, w in self.tables[:-1]]).tolist()
            self.ptrs = ([self.starts.data_ptr() + o * self.starts.element_size()
                          for o in s_off]
                         + [self.weights.data_ptr() + o * self.weights.element_size()
                            for o in w_off])


def _block(name, entry, counter, x, bt: BlockTables, order):
    if x.device.type == "cpu":
        return apply_taps_plain(x, bt.tables, order)
    require_cuda(name, x)
    if x.dim() != 3:
        raise ValueError(f"{name}: takes a (Z, Y, X) block")
    if bt.device != x.device or bt.weight_dtype != compute_dtype(x.dtype):
        raise ValueError(f"{name}: tables made for {bt.device} / {bt.weight_dtype}, "
                         f"block on {x.device} / {x.dtype}")
    out = torch.empty(bt.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = kernel(entry, x.dtype)(
        x.data_ptr(), out.data_ptr(), 1, *x.shape, *bt.out_shape, *bt.ptrs, stream_of(x),
    )
    check_launch(err, name)
    counter.launches += 1
    return out


def restrict_block(x: torch.Tensor, tables: BlockTables) -> torch.Tensor:
    """The restriction kernel on a block (tables of 4 weights per row)."""
    return _block("restrict_block", "mad_restrict3d", cuda_restrict, x, tables, (0, 1, 2))


def prolong_block(x: torch.Tensor, tables: BlockTables) -> torch.Tensor:
    """The prolongation kernel on a block (2 weights per row)."""
    return _block("prolong_block", "mad_prolong3d", cuda_prolong, x, tables, (2, 1, 0))
