"""The general input generator: each call's inputs, made on the device from
``(seed, stream, call index)`` by the parameters of a traffic file's
``inputs`` object.

Kinds:

* ``tube_phantom``: a volume of Gaussian-profile tubes (:data:`TUBES`, made
  once per process: they do not depend on the seed) at ``amplitude`` on
  uniform noise in ``[0, noise)``, the noise redrawn for every call.  Yields
  ``{"volume": ...}``.
* ``spd_tensor``: ``b`` uniform in ``[0, rhs_high)`` and, per voxel, the
  tensor ``G G^T + 2 I`` with ``G`` standard normal, both drawn for every
  call.  Yields ``{"image": ..., "tensor": (6, Z, Y, X)}``, the tensor in
  (zz, zy, zx, yy, yx, xx) order.

The tubes and the tensor construction are a frozen copy of the port's
``utils/phantom.py`` (the volumes ``chip_smoke.py`` and the profilers drive),
so that a change there does not move this yardstick.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

#: (point as fractions of the shape, axis, radius in voxels) of each tube:
#: axis-aligned and diagonal, radius 1.5 to 6
TUBES = (
    ((0.5, 0.25, 0.25), (1, 0, 0), 1.5),
    ((0.5, 0.5, 0.75), (0, 1, 0), 3.0),
    ((0.75, 0.5, 0.5), (0, 0, 1), 6.0),
    ((0.25, 0.5, 0.5), (0, 1, 1), 2.0),
    ((0.5, 0.75, 0.5), (1, 0, 1), 4.0),
    ((0.5, 0.5, 0.5), (1, 1, 1), 2.5),
)

#: streams of one seed: the measured calls and the warm-up calls
WINDOW, WARMUP = 0, 1


def call_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for one call (any whole ``seed``, also one
    beyond 32 bits)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), seed < 0, stream, index])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def tube_field(shape: Tuple[int, int, int], amplitude: float, device) -> torch.Tensor:
    """float32 volume of the TUBES (the brightest where they cross), built in
    z chunks of 32 planes."""
    vol = torch.zeros(shape, dtype=torch.float32, device=device)
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
            tubes = torch.maximum(tubes, amplitude * torch.exp(-dist2 / (2 * radius ** 2)))
        vol[z0:z0 + len(z)] = tubes
    return vol


def spd_tensor(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """Per voxel ``G G^T + 2 I``, G standard normal, as a (zz, zy, zx, yy, yx,
    xx) stack (2D: (yy, yx, xx))."""
    nd = len(shape)
    rows = torch.randn((nd, nd, *shape), generator=generator, device=generator.device)
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    t = torch.empty((len(pairs), *shape), device=generator.device)
    for k, (i, j) in enumerate(pairs):
        torch.sum(rows[i] * rows[j], dim=0, out=t[k])
        if i == j:
            t[k] += 2.0
    return t


class Inputs:
    """Makes the inputs of call ``index`` of a traffic mix: the same
    ``(seed, stream, index)`` and device give the same values."""

    def __init__(self, traffic: Dict, device):
        self.shape = tuple(int(n) for n in traffic["shape"])
        self.params = dict(traffic["inputs"])
        self.kind = self.params.pop("kind")
        self.device = torch.device(device)
        if self.kind == "tube_phantom":
            self.tubes = tube_field(self.shape, float(self.params["amplitude"]), self.device)
        elif self.kind != "spd_tensor":
            raise ValueError(f"unknown input kind: {self.kind!r}")

    @property
    def resident_bytes(self) -> int:
        """Device bytes the generator holds across calls (the tube field)."""
        tubes = getattr(self, "tubes", None)
        return 0 if tubes is None else tubes.numel() * tubes.element_size()

    def make(self, seed: int, stream: int, index: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(call_seed(seed, stream, index))
        if self.kind == "tube_phantom":
            noise = torch.rand(self.shape, generator=gen, device=self.device)
            return {"volume": noise.mul_(float(self.params["noise"])).add_(self.tubes)}
        tensor = spd_tensor(self.shape, gen)
        image = torch.rand(self.shape, generator=gen, device=self.device)
        return {"image": image.mul_(float(self.params["rhs_high"])), "tensor": tensor}
