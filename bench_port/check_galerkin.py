"""Holds the port's Galerkin coarse operators of one call of a cell to the
plain reference (:mod:`.reference.galerkin`), plane by plane.

    python3 bench_port/check_galerkin.py [--workload galerkin512] [--seed N]

from the root of a checkout, on the CUDA card (``--device cpu --shape Z Y X``
runs it small on the CPU).  It takes the inputs of the first call that the
cell's output check samples for ``--seed``, builds the port's hierarchy as
``mad_diffusion`` does (``build_hierarchy`` under the cell's
``MADConfig.cuda(...)``, in the cell's dtype), keeps its levels 1 and 2 and
frees the rest.  Then the reference computes the same levels in float64 from
the same tensor by comb probing, with each level's scale: the same product
over the magnitudes of every term, ``R |S| P`` collapsed, plus the identity's
1 on the centre.

Each level reads :func:`operator_error`, the largest ``|port - reference|``
of any coefficient over its scale, against :data:`LIMIT`; the port's planes
rounded to bfloat16 read the same and must lie above it.  One JSON line:
per level its shape, planes, ``error``, ``bf16_error`` and ``limit``, and
``ok`` (each level within the limit, its bfloat16 control beyond it).  Exits
non-zero unless ``ok``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

ROOT = Path(__file__).resolve().parent.parent

#: A float32 sum of ``n`` terms is off by at most ``n u`` (``u = 2**-24``)
#: times the sum of the terms' magnitudes; a coefficient of level 2 sums
#: 27 fine planes times 4**3 restriction taps, n = 1728: ``1728 u = 1.03e-4``.
#: Sound float32 readings sit near 1e-7, bfloat16 rounding alone near 2e-3.
LIMIT = 1e-4
LEVELS = (1, 2)


def operator_error(port: Dict, ref: Dict, scale: Dict) -> float:
    """``max |port - ref| / scale`` over every offset and coefficient; an
    offset the port lacks is a zero plane there, one the reference lacks is
    infinitely far, and so is a coefficient off a zero scale."""
    if set(port) - set(ref):
        return math.inf
    worst = 0.0
    for off, r in ref.items():
        p = port.get(off)
        diff = r.abs() if p is None else (p.to(r.device, torch.float64) - r).abs()
        s = scale[off]
        ratio = torch.where(s > 0, diff / s, torch.where(diff > 0, math.inf, 0.0))
        worst = max(worst, float(ratio.max()))
    return worst


def scale_of(d: Dict) -> Dict:
    """The scale of ``A = I - S`` from the magnitudes' product ``d`` of ``S``."""
    from bench_port.reference import galerkin as ref

    out = dict(d)
    out[ref.CENTRE] = d[ref.CENTRE] + 1.0
    return out


def port_levels(config: Dict, traffic: Dict, inputs: Dict, device) -> List[Dict]:
    """The port's Galerkin levels :data:`LEVELS` (operators as dicts of
    planes, on the CPU), built as ``mad_diffusion`` builds them; the rest is
    freed."""
    from bench_port import drive
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy

    cfg = drive.Port(config, traffic, device).mad_config
    dtype = getattr(torch, config["dtype"])
    shape = tuple(inputs["image"].shape)
    planes = as_sym_planes(inputs["tensor"], shape, dtype=dtype, device=device)
    hier = build_hierarchy(planes, build_level_descriptors(shape), cfg.time_step,
                           cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels,
                           cfg.galerkin_variant)
    out = []
    for lvl in LEVELS:
        op = hier.operators[lvl]
        out.append({tuple(off): op.coeffs[k].cpu() for k, off in enumerate(op.offsets)})
    del hier, planes
    return out


def reference_levels(tensor: torch.Tensor, time_step: float, depth: int,
                     batch: int = 4) -> List[Tuple[Dict, Dict]]:
    """Levels ``1 .. depth`` of the reference's collapsed chain in float64,
    each as ``(A, scale)``; level 0's planes are freed once level 1 stands."""
    from bench_port.reference import galerkin as ref
    from bench_port.reference import solve

    shapes = ref.level_shapes(tensor.shape[1:], depth)
    c = solve.assemble(tensor.to(torch.float64), time_step)
    c.neg_()
    c[solve.CENTRE] += 1.0  # S = I - A, in place
    s, d = ref.from_planes(c), None
    del c
    out = []
    for fine in shapes[:-1]:
        # both products of a level stand before the level above goes
        s, d = (ref.coarsen(s, fine, True, batch),
                ref.coarsen(s if d is None else d, fine, True, batch, absolute=d is None))
        out.append((ref.parabolic(s), scale_of(d)))
    return out


def check(config: Dict, traffic: Dict, inputs: Dict, device) -> Dict:
    port = port_levels(config, traffic, inputs, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tensor = inputs["tensor"]
    refs = reference_levels(tensor, float(config["settings"]["time_step"]), max(LEVELS))
    out = {}
    for lvl, p in zip(LEVELS, port):
        a, scale = refs[lvl - 1]
        bf16 = {k: v.to(torch.bfloat16) for k, v in p.items()}
        out[str(lvl)] = {"shape": list(next(iter(a.values())).shape), "planes": len(p),
                         "error": operator_error(p, a, scale),
                         "bf16_error": operator_error(bf16, a, scale), "limit": LIMIT}
    ok = all(v["error"] <= LIMIT < v["bf16_error"] for v in out.values())
    return {"levels": out, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="galerkin512")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port import harness, spec
    from bench_port.inputs import WINDOW, Inputs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    traffic = dict(cell.traffic, shape=args.shape) if args.shape else cell.traffic
    idx = harness.check_indices(args.seed, traffic)[0]
    inputs = Inputs(traffic, device).make(args.seed, WINDOW, idx)
    result = {"workload": cell.name, "seed": args.seed, "call": idx,
              **check(cell.config, traffic, inputs, device)}
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
