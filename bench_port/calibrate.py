"""Readings that the output check's limits are set from, for one cell.

    python bench_port/calibrate.py --workload <name> --seeds 11 12 ... \\
        --control-seeds 21 22 23 [--out FILE]

For each seed, the call the benchmark's check samples (its inputs, its entry,
at the cell's size) through the port, compared with the reference as a run
compares it: the lower readings.  For each control seed, the same with the
configuration's control in the port's place (``control`` in its
configuration file: the port with a lower-precision option switched on, or
the reference computed in a lower precision): the upper readings.  One JSON
line per reading, then a summary line with the largest program reading and
the smallest control reading of each number.  Needs a CUDA card, as the
benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, control: bool, device, emit):
    import torch

    from bench_port import check, drive, harness
    from bench_port.inputs import WARMUP, WINDOW, Inputs

    inputs = Inputs(cell.traffic, device)
    spec = cell.config.get("control", {}) if control else {}
    port = drive.Port(cell.config, cell.traffic, device, spec.get("options"))
    ref_dtype = spec.get("reference_dtype")
    if ref_dtype is None:
        port(inputs.make(0, WARMUP, 0))
    out = []
    for seed in seeds:
        kept = {}
        for idx in harness.check_indices(seed, cell.traffic):
            inp = inputs.make(seed, WINDOW, idx)
            if ref_dtype is None:
                outputs = port(inp)[0]
            else:
                outputs = check.reference_outputs(cell.config, cell.traffic, inp,
                                                  getattr(torch, ref_dtype))
            kept[idx] = {k: outputs[k].detach().cpu() for k in ("output", "vesselness", "tensor")
                         if k in outputs}
            del inp, outputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
        values = harness.compare_calls(cell, inputs, seed, kept)
        line = {"workload": cell.name, "seed": seed, "kind": "control" if control else "program",
                "numbers": values}
        emit(line)
        out.append(values)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()

    device = torch.device("cuda")
    program = readings(cell, args.seeds, False, device, emit)
    control = readings(cell, args.control_seeds, True, device, emit)
    summary = {"workload": cell.name, "kind": "summary",
               "lower": {k: max(v[k] for v in program) for k in program[0]},
               "upper": ({k: min(v[k] for v in control) for k in control[0]} if control
                         else None)}
    emit(summary)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
