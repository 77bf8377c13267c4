"""Calls into the port, through its public entries only: ``ved`` with a
``VEDConfig`` and ``mad_diffusion`` with a ``MADConfig``.

A configuration file's ``settings`` (the upstream constructor's defaults)
and a traffic file's ``call`` options go to ``VEDConfig.cuda(...)`` or
``MADConfig.cuda(...)``, the port's fast path on the card.

In a traced run, :func:`spans` wraps the functions that ``ved`` and
``mad_diffusion`` look up by module name in ``torch.profiler`` ranges (the
port has no ranges of its own): ``bench.pipeline`` around
``models.ved.fused_vesselness_tensor``, ``bench.solve`` around
``models.ved.mad_diffusion`` (and around the call itself for the
``mad_diffusion`` entry), and ``bench.setup`` around
``models.mad.build_hierarchy``, which synchronises the card on entry and
exit so that its wall time is its own.  ``bench.call`` spans each call.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

CALL, PIPELINE, SOLVE, SETUP, WINDOW = (
    "bench.call", "bench.pipeline", "bench.solve", "bench.setup", "bench.window")


def _tuples(settings: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in settings.items()}


class Port:
    """One configured entry of the port.  ``options`` override settings (the
    lower-precision paths the output check's control switches on)."""

    def __init__(self, config: Dict, traffic: Dict, device, options: Dict | None = None):
        import multigridanisotropicdiffusion_tpu_torch as madt

        self.madt = madt
        self.entry = config["entry"]
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        settings = _tuples({**config["settings"], **traffic.get("call", {}), **(options or {})})
        if self.entry == "ved":
            self.config = madt.VEDConfig.cuda(**settings)
            self.mad_config = self.config.mad_config()
        elif self.entry == "mad_diffusion":
            self.config = madt.MADConfig.cuda(**settings)
            self.mad_config = self.config
        else:
            raise ValueError(f"unknown entry: {self.entry!r}")
        self.traced = False

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], object]:
        """The entry's outputs by name, and the last solve's ``MADResult``."""
        with record_range(CALL, self.traced):
            if self.entry == "ved":
                res = self.madt.ved(inputs["volume"], config=self.config, dtype=self.dtype,
                                    device=self.device)
                return ({"output": res.output, "vesselness": res.vesselness,
                         "tensor": res.tensor}, res.diffusion)
            with record_range(SOLVE, self.traced):
                res = self.madt.mad_diffusion(inputs["image"], inputs["tensor"],
                                              config=self.config, dtype=self.dtype,
                                              device=self.device)
            return {"output": res.output}, res


def record_range(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _wrap(fn, name: str, sync: bool):
    def wrapped(*args, **kwargs):
        if sync:
            torch.cuda.synchronize()
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
        return out

    return wrapped


@contextlib.contextmanager
def spans(port: Port):
    """The traced run's ranges, installed for the ``with`` block."""
    from multigridanisotropicdiffusion_tpu_torch.models import mad as mad_mod
    from multigridanisotropicdiffusion_tpu_torch.models import ved as ved_mod

    sync = port.device.type == "cuda"
    patches = [(mad_mod, "build_hierarchy", SETUP, sync)]
    if port.entry == "ved":
        patches += [(ved_mod, "fused_vesselness_tensor", PIPELINE, False),
                    (ved_mod, "mad_diffusion", SOLVE, False)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in patches]
    for mod, attr, name, s in patches:
        setattr(mod, attr, _wrap(getattr(mod, attr), name, s))
    port.traced = True
    try:
        yield
    finally:
        port.traced = False
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
