"""Where B8 and B9 may rightly part from their plain versions.

Two correct implementations can disagree in two places, and the checks of
the kernels (``chip_smoke.py`` and ``tests/test_torch_cuda_ved.py``) count
those places with these functions instead of comparing there:

* B8's select variant at a near-tie: ``new > best`` may come out either way
  when the new response is within rounding of the incoming best, and the
  Hessian planes then come from different scales;
* B9 at a degenerate top eigenvalue (gap below 1e-4 of the matrix scale):
  the eigenvector is arbitrary there, and only the trace ``2 d1 + d3`` of
  the tensor is fixed.  bf16 storage makes exact ties a property of the
  input, so what is bounded is the number of degenerate voxels where the
  two versions differ, not the number of ties.

Each check returns the mask of the voxels to compare as usual, and whether
the places where the two may part stay few enough.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.eigen3 import eigvalsh3

#: near-tie width: 1e-5 of the largest response
NEAR_TIE = 1e-5
#: flips may be at most this share of the voxels (and one always)
FLIP_SHARE = 1e-6
#: degenerate top eigenvalue: gap below this share of max |h|
DEGENERATE_GAP = 1e-4
#: differing degenerate voxels may be at most this share (and one always)
DEGENERATE_SHARE = 1e-5


def _allowed(share: float, n: int) -> int:
    return max(1, int(share * n))


class SelectCheck(NamedTuple):
    keep: torch.Tensor  # voxels where both took the same decision
    n_flip: int
    near_ties_only: bool
    ok: bool


def select_flips(new_k: torch.Tensor, new_p: torch.Tensor, best: torch.Tensor,
                 scale: float) -> SelectCheck:
    """The voxels where the kernel's (``new_k``) and the plain version's
    (``new_p``) new responses took different decisions against the incoming
    ``best``.  ok: every flip sits at a near-tie (both new responses within
    NEAR_TIE * ``scale`` of ``best``) and there are at most FLIP_SHARE of
    the voxels."""
    flip = (new_k > best) != (new_p > best)
    n_flip = int(flip.sum())
    near = bool(((new_k - best).abs()[flip] <= NEAR_TIE * scale).all()) and bool(
        ((new_p - best).abs()[flip] <= NEAR_TIE * scale).all())
    return SelectCheck(~flip, n_flip, near,
                       near and n_flip <= _allowed(FLIP_SHARE, flip.numel()))


class TensorCheck(NamedTuple):
    keep: torch.Tensor  # voxels whose top eigenvalue is not degenerate
    n_degenerate: int
    n_differ: int  # degenerate voxels where the two tensors differ
    trace_ok: bool
    ok: bool


def degenerate_tops(got: torch.Tensor, want: torch.Tensor, resp: torch.Tensor,
                    h: torch.Tensor, rel: float) -> TensorCheck:
    """B9's tensors ``got`` (kernel) and ``want`` (plain) of the winning
    Hessian ``h``: the voxels whose top eigenvalue is degenerate, and among
    them those where the two differ by more than ``rel`` * max |want|.
    ok: at most DEGENERATE_SHARE of the voxels differ, and the traces agree
    to 1e-5 of the largest trace at every degenerate voxel."""
    hm = h.to(resp.dtype)
    w = eigvalsh3(hm)
    degenerate = (w[2] - w[1]) < DEGENERATE_GAP * hm.abs().amax(0)
    del w, hm
    scale = want.abs().max().item()
    n_diff = int((degenerate & ((got - want).abs() > rel * scale).any(0)).sum())
    trace_k = got[0] + got[3] + got[5]
    trace_p = want[0] + want[3] + want[5]
    trace_ok = bool(((trace_k - trace_p).abs()[degenerate]
                     <= 1e-5 * trace_p.abs().max()).all())
    ok = trace_ok and n_diff <= _allowed(DEGENERATE_SHARE, degenerate.numel())
    return TensorCheck(~degenerate, int(degenerate.sum()), n_diff, trace_ok, ok)
