"""Holds the port's exact Galerkin coarse operators of one call of a cell to
the plain reference's uncollapsed chain (:mod:`.reference.galerkin`), plane
by plane.

    python3 bench_port/check_galerkin_exact.py [--workload galerkin512-exact] [--seed N]

from the root of a checkout, on the CUDA card (``--device cpu --shape Z Y X``
runs it small on the CPU).  As :mod:`.check_galerkin` does for the collapsed
levels: the inputs of the first call that the cell's output check samples
for ``--seed``, the port's hierarchy built as ``mad_diffusion`` builds it
(:func:`.check_galerkin.port_levels`: levels 1 and 2 kept on the host, the
rest freed), then the reference's exact chain in float64 from the same
tensor by comb probing, every offset of the 5^3 box, with each level's
scale (the product over the magnitudes of every term, plus the identity's 1
on the centre).  The reference computes a level, is compared and drops it
before the next.

Each level reads :func:`.check_galerkin.operator_error` against
:data:`LIMIT`; the port's planes rounded to bfloat16 read the same and must
lie above it.  One JSON line: per level its shape, the port's planes,
``error``, ``bf16_error`` and ``limit``; the reference's device and its
peak memory there (``reference_peak_gib``, on a card); and ``ok`` (each
level within the limit, its bfloat16 control beyond it).  Exits non-zero
unless ``ok``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterator, Tuple

import torch

ROOT = Path(__file__).resolve().parent.parent

#: A float32 sum of ``n`` terms is off by at most ``n u`` (``u = 2**-24``)
#: times the sum of the terms' magnitudes; a coefficient of exact level 2
#: sums 117 fine planes times 4**3 restriction taps, n = 7488: ``7488 u =
#: 4.46e-4`` (level 1: 19 * 64 = 1216 terms, 7.2e-5).  bfloat16 rounding
#: alone reads near 2e-3.
LIMIT = 5e-4
#: probes per batch of the reference's comb probing: at 512^3 a probe's
#: fine-grid workspace is a few float64 volumes of 1 GiB
BATCH = 2


def reference_levels(tensor: torch.Tensor, time_step: float, depth: int,
                     batch: int = BATCH) -> Iterator[Tuple[Dict, Dict]]:
    """Levels ``1 .. depth`` of the reference's exact chain in float64, each
    as ``(A, scale)``, one at a time; level 0's planes are freed once level
    1 stands, and a level once the next stands."""
    from bench_port.check_galerkin import scale_of
    from bench_port.reference import galerkin as ref
    from bench_port.reference import solve

    shapes = ref.level_shapes(tensor.shape[1:], depth)
    c = solve.assemble(tensor.to(torch.float64), time_step)
    c.neg_()
    c[solve.CENTRE] += 1.0  # S = I - A, in place
    s, d = ref.from_planes(c), None
    del c
    for fine in shapes[:-1]:
        # both products of a level stand before the level above goes
        s, d = (ref.coarsen(s, fine, False, batch),
                ref.coarsen(s if d is None else d, fine, False, batch, absolute=d is None))
        yield ref.parabolic(s), scale_of(d)


def check(config: Dict, traffic: Dict, inputs: Dict, device) -> Dict:
    from bench_port.check_galerkin import LEVELS, operator_error, port_levels

    port = port_levels(config, traffic, inputs, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    refs = reference_levels(inputs["tensor"], float(config["settings"]["time_step"]),
                            max(LEVELS))
    out = {}
    for lvl, p, (a, scale) in zip(LEVELS, port, refs):
        bf16 = {k: v.to(torch.bfloat16) for k, v in p.items()}
        out[str(lvl)] = {"shape": list(next(iter(a.values())).shape), "planes": len(p),
                         "error": operator_error(p, a, scale),
                         "bf16_error": operator_error(bf16, a, scale), "limit": LIMIT}
        del a, scale, bf16
    ok = all(v["error"] <= LIMIT < v["bf16_error"] for v in out.values())
    result = {"levels": out, "reference_device": str(device)}
    if device.type == "cuda":
        result["reference_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return {**result, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="galerkin512-exact")
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
