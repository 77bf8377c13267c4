"""Runs one cell of the port's benchmark once, on this machine's CUDA card.

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics), ``device``
and, traced, ``breakdown``; ``setup_phases``, the seconds of each part of
set-up (also on standard error); last, ``check``: each compared number with its
limit, which also close standard error.  Exits non-zero and prints no
result without enough CUDA cards, or if JAX or the JAX package got loaded.
Build and kernel caches stay inside the checkout (``.bench_cache/``; the
port builds its kernels into its own ``_build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "multigridanisotropicdiffusion_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)  # this folder's module names must not shadow others
    sys.path.insert(0, str(ROOT))

    import torch

    t_torch = time.perf_counter()
    from bench_port import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                         [("torch", t_torch)])
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in the run: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("setup_phases " + " ".join(f"{k}={v:.3f}" for k, v in result["setup_phases"].items()),
          file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
