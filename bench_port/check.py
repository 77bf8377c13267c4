"""The output check that decides ``correct``: the port's outputs of a call,
against the plain reference (:mod:`.reference`) run on the same inputs.

The numbers, with the reference in float64 (a relative L2 distance is
``||port - ref|| / ||ref||`` over the whole field):

* ``vesselness_rel_l2``, ``tensor_rel_l2`` (the ``ved`` entry): the pipeline's
  response and diffusion tensor (the tensor's six planes as one field);
* ``output_rel_l2``: the filtered volume, after the reference's own implicit
  steps under its own tensor;
* ``output_relres`` (the ``mad_diffusion`` entry): the relative residual
  ``||b - A x|| / ||b||`` of the port's output ``x`` under the reference's
  operator and the last step's right-hand side, which the configuration's
  ``tolerance`` bounds.

A traffic file's ``check.limits`` gives each number its limit; a number
above it, or not finite, makes the run not correct.  The reference runs
after the measured window, once the port's state is freed, in z slabs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import pipeline as ref_pipeline
from .reference import solve as ref_solve

SLAB = 64


def rel_l2(port: torch.Tensor, ref: torch.Tensor) -> float:
    """``||port - ref|| / ||ref||`` in float64, in slabs along z (the third
    axis from the end); ``port`` on any device, ``ref`` where it is."""
    num = torch.zeros((), dtype=torch.float64, device=ref.device)
    den = torch.zeros((), dtype=torch.float64, device=ref.device)
    nz = ref.shape[-3]
    for z0 in range(0, nz, SLAB):
        r = ref[..., z0:z0 + SLAB, :, :].to(torch.float64)
        p = port[..., z0:z0 + SLAB, :, :].to(device=ref.device, dtype=torch.float64)
        num += torch.sum((p - r) ** 2)
        den += torch.sum(r * r)
    return math.sqrt(float(num)) / math.sqrt(float(den))


def _settings(config: Dict, traffic: Dict) -> Dict:
    return {**config["settings"], **traffic.get("call", {})}


def reference_outputs(config: Dict, traffic: Dict, inputs: Dict[str, torch.Tensor],
                      dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """What the reference computes from a call's inputs, in ``dtype``."""
    s = _settings(config, traffic)
    if config["entry"] == "ved":
        u = inputs["volume"].to(dtype)
        for _ in range(int(s["iterations"])):
            resp, tensor = ref_pipeline.vesselness_tensor(
                u, s, s.get("hessian_mode", "smooth_fd"), dtype, SLAB)
            u = ref_solve.implicit_steps(u, tensor, s, int(s["diffusion_iterations"]), dtype)[0]
        return {"output": u, "vesselness": resp, "tensor": tensor}
    out, rhs, operator = ref_solve.implicit_steps(inputs["image"], inputs["tensor"], s,
                                                  int(s["number_of_steps"]), dtype)
    return {"output": out, "rhs": rhs, "operator": operator}


def numbers(outputs: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each compared number, by name."""
    values = {f"{name}_rel_l2": rel_l2(outputs[name], reference[name])
              for name in ("output", "vesselness", "tensor") if name in reference}
    if "operator" in reference:
        c = reference["operator"]
        x = outputs["output"].to(device=c.device, dtype=c.dtype)
        values["output_relres"] = ref_solve.relative_residual(c, x, reference["rhs"])
    return values


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return set(values) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in values.items())
