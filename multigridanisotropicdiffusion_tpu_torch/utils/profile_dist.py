"""Where the time of one warm distributed solve goes, on one CUDA card.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.profile_dist
        [--cards 2] [--backend nccl]

Spawns 2 gloo ranks that share cuda:0 (mesh (2, 1, 1), faces staged through
the host; ``--cards 2``: rank r on cuda:r; ``--backend nccl``: faces device
to device, a card per rank), each with ``chip_smoke.py``'s seeded 512^3 inputs, runs the
``MADConfig.cuda()`` solve to 1e-6 once to warm up, then once more on a
prebuilt hierarchy with rank 0 under ``torch.profiler``, and prints for
rank 0: the wall time, its own kernels' device time (the other rank's
kernels run on the same card and are not in this process's trace), the
host time inside the port's communication ranges (``madt.exchange``: face
exchanges; ``madt.gather``: gathers and the global sums) with their counts,
the device time by kernel group, and how much of rank 0's B14 device time
ran while its host was inside a ``madt.exchange`` range: in all, and the
part of it outside the host's CUDA runtime calls, i.e. while the host
moved faces rather than waited for the card (a blocking exchange waits
there for B14 to finish; an overlapped one sends its faces while B14 runs).
Read from the trace's Chrome export (kernels and host ranges share one
clock).  The card's name and power limit come first.  Needs a CUDA device.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from .profile_ved import _device_us

SHAPE = (512, 512, 512)
GROUPS = {
    "B14 shard-local stencil": ("Compressed<float, true>",
                                "Compressed<__nv_bfloat16, true>"),
    "B1/B2 whole-domain stencil": ("Compressed<",),
    "B3/B4 3D transfers": ("restrict_kernel", "prolong_kernel"),
}


def _overlap_us(trace_path: str, frags) -> tuple:
    """From a Chrome trace: the device time of the kernels whose names hold
    one of ``frags``, the part of it inside ``madt.exchange`` host ranges,
    and the part of that outside the host's CUDA runtime calls (us)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]

    def spans(pred):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if "dur" in e and pred(e))

    def cut(segs, holes):
        """``segs`` minus ``holes`` (both sorted lists of intervals)."""
        out = []
        for a, b in segs:
            for h0, h1 in holes:
                if h1 <= a or h0 >= b:
                    continue
                if h0 > a:
                    out.append((a, h0))
                a = max(a, h1)
                if a >= b:
                    break
            if a < b:
                out.append((a, b))
        return out

    def inside(segs, ranges):
        return sum(max(0.0, min(b, r1) - max(a, r0)) for a, b in segs for r0, r1 in ranges
                   if r0 < b and r1 > a)

    kernels = spans(lambda e: e.get("cat") == "kernel" and any(f in e["name"] for f in frags))
    exchange = spans(lambda e: e.get("cat") == "user_annotation"
                     and e.get("name") == "madt.exchange")
    runtime = spans(lambda e: e.get("cat") in ("cuda_runtime", "cuda_driver"))
    free = cut(exchange, runtime)
    # host calls inside the exchange ranges, by name (nested calls each
    # count their whole span)
    starts = [r0 for r0, _ in exchange]
    calls = {}
    for e in events:
        if "dur" in e and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"):
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] + e["dur"] <= exchange[i][1]:
                n, t = calls.get(e["name"], (0, 0.0))
                calls[e["name"]] = (n + 1, t + e["dur"])
    return (sum(b - a for a, b in kernels), inside(kernels, exchange), inside(kernels, free),
            calls)


def _rank(rank, world, store, out, cards, backend):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ..core.grids import build_level_descriptors
    from ..models.mad import MADConfig, build_hierarchy, mad_diffusion
    from ..parallel.sharding import initialize_multihost, make_grid_mesh

    device = torch.device("cuda", rank % cards)
    torch.cuda.set_device(device)
    initialize_multihost(f"file://{store}", world, rank, backend=backend)
    mesh = make_grid_mesh(3, (world, 1, 1), device=device)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn((3, 3, *SHAPE), generator=gen, device="cuda")
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    t = torch.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0) for i, j in pairs])
    del rows
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    cfg = MADConfig.cuda(time_step=0.1, tolerance=1e-6)
    hier = build_hierarchy(t, build_level_descriptors(SHAPE), cfg.time_step,
                           cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels)
    mad_diffusion(b, t, config=cfg, mesh=mesh, hierarchy=hier)
    torch.cuda.synchronize()
    dist.barrier()
    tracer = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if rank == 0 else contextlib.nullcontext())
    with tracer as prof:
        t0 = time.perf_counter()
        res = mad_diffusion(b, t, config=cfg, mesh=mesh, hierarchy=hier)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rank == 0:
        trace = os.path.join(os.path.dirname(out), "trace.json")
        prof.export_chrome_trace(trace)
        b14, in_exchange, in_transfer, calls = _overlap_us(trace,
                                                           GROUPS["B14 shard-local stencil"])
        lines = []
        events = prof.key_averages()
        # the madt.* ranges also carry a device-side span (first to last
        # device operation inside them): reported below, not summed here
        kernels = [e for e in events if _device_us(e) > 0 and not e.key.startswith("madt.")
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(_device_us(e) for e in kernels) / 1e6
        lines.append(f"rank 0 of {world} ({backend}, {cards} card(s)), 512^3 "
                     f"MADConfig.cuda(): {int(res.num_cycles[0])} "
                     f"cycles, wall {wall:.4f} s, its kernels {device:.4f} s "
                     f"({device / wall:.1%} of the wall)")
        for name in ("madt.exchange", "madt.gather"):
            ev = [e for e in events if e.key == name]
            host_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU]
            host = sum(e.cpu_time_total for e in host_ev) / 1e6
            span = sum(_device_us(e) for e in ev if e not in host_ev) / 1e6
            lines.append(f"  {name}: {sum(e.count for e in host_ev)} calls, {host:.4f} s "
                         f"host ({host / wall:.1%} of the wall), device-side span {span:.4f} s")
        lines.append(f"  B14 device time {b14 / 1e3:.2f} ms; inside madt.exchange host ranges "
                     f"{in_exchange / 1e3:.2f} ms ({in_exchange / max(b14, 1e-9):.1%}); "
                     f"there outside CUDA runtime calls (overlapped with the face transfer) "
                     f"{in_transfer / 1e3:.2f} ms ({in_transfer / max(b14, 1e-9):.1%})")
        lines.append("  host calls inside madt.exchange, by their summed span (ms, calls):")
        for name, (n, t) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:12]:
            lines.append(f"  {t / 1e3:10.3f} {n:6d}  {name[:90]}")
        grouped = {g: 0.0 for g in (*GROUPS, "other")}
        for e in kernels:
            group = next((g for g, frags in GROUPS.items()
                          if any(f in e.key for f in frags)), "other")
            grouped[group] += _device_us(e) / 1e6
        for g, s in grouped.items():
            lines.append(f"  {g}: {s * 1e3:.2f} ms, {s / max(device, 1e-12):.1%} of its "
                         "device time")
        launches = sum(e.count for e in kernels)
        lines.append(f"  {launches} device operations; the largest:")
        lines.append(f"  {'device ms':>10} {'share':>6} {'calls':>6}  kernel")
        for e in sorted(kernels, key=_device_us, reverse=True)[:15]:
            lines.append(f"  {_device_us(e) / 1e3:10.3f} {_device_us(e) / 1e6 / device:6.1%} "
                         f"{e.count:6d}  {e.key[:100]}")
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 2))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"needs {args.cards} CUDA device(s)", file=sys.stderr)
        return 1
    if args.backend == "nccl" and args.cards < 2:
        print("NCCL needs a card per rank: pass --cards 2", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "report.txt")
        mp.start_processes(_rank, args=(2, os.path.join(d, "store"), out, args.cards,
                                        args.backend),
                           nprocs=2, start_method="spawn")
        print(open(out).read(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
