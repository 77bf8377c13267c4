"""Seeded inputs built on the device: a tube phantom for the VED pipeline
and a field of diffusion tensors for the solve.

No JAX counterpart: the JAX package's tests build their inputs in numpy.
``chip_smoke.py``, :mod:`.profile_ved` and :mod:`.ab_outputs` drive the
512^3 main paths with them.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: (point as fractions of the shape, axis, radius in voxels) of each
#: Gaussian-profile tube: axis-aligned and diagonal, radius 1.5 to 6
TUBES = (
    ((0.5, 0.25, 0.25), (1, 0, 0), 1.5),
    ((0.5, 0.5, 0.75), (0, 1, 0), 3.0),
    ((0.75, 0.5, 0.5), (0, 0, 1), 6.0),
    ((0.25, 0.5, 0.5), (0, 1, 1), 2.0),
    ((0.5, 0.75, 0.5), (1, 0, 1), 4.0),
    ((0.5, 0.5, 0.5), (1, 1, 1), 2.5),
)
#: the tubes' peak value, and the top of the uniform noise under them
AMPLITUDE = 100.0
NOISE = 10.0


def tube_phantom(shape: Tuple[int, int, int], generator: torch.Generator) -> torch.Tensor:
    """float32 volume on the generator's device: the TUBES (the brightest
    where they cross) at AMPLITUDE on uniform noise in [0, NOISE), built in
    z chunks of 32 planes."""
    device = generator.device
    vol = torch.rand(shape, generator=generator, device=device) * NOISE
    y = torch.arange(shape[1], device=device, dtype=torch.float32)[:, None]
    x = torch.arange(shape[2], device=device, dtype=torch.float32)[None, :]
    for z0 in range(0, shape[0], 32):
        z = torch.arange(z0, min(shape[0], z0 + 32), device=device,
                         dtype=torch.float32)[:, None, None]
        tubes = torch.zeros((len(z), *shape[1:]), device=device)
        for point, axis, radius in TUBES:
            norm = sum(a * a for a in axis) ** 0.5
            d = [a / norm for a in axis]
            rz, ry, rx = (z - point[0] * shape[0], y - point[1] * shape[1],
                          x - point[2] * shape[2])
            along = rz * d[0] + ry * d[1] + rx * d[2]
            dist2 = rz * rz + ry * ry + rx * rx - along * along
            tubes = torch.maximum(
                tubes, AMPLITUDE * torch.exp(-dist2 / (2 * radius ** 2)))
        vol[z0:z0 + len(z)] += tubes
    return vol


def tube_centre(shape: Tuple[int, int, int]) -> Tuple[int, ...]:
    """The voxel at the point of the first, thinnest tube (along z)."""
    return tuple(int(p * n) for p, n in zip(TUBES[0][0], shape))


def spd_tensor_field(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Per voxel G G^T + 2 I with G normal (D x D for a D-dimensional grid),
    as a symfield-order stack on the generator's device (the JAX package's
    bench.py construction)."""
    nd = len(shape)
    rows = torch.randn((nd, nd, *shape), generator=generator, device=generator.device)
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    t = torch.empty((len(pairs), *shape), device=generator.device)
    for k, (i, j) in enumerate(pairs):
        torch.sum(rows[i] * rows[j], dim=0, out=t[k])
        if i == j:
            t[k] += 2.0
    return t
