"""Where the time of one warm 512^3 VED call goes, on one CUDA card.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.profile_ved

For each Hessian mode, ``smooth_fd`` (``VEDConfig.cuda()``) and then the
reference-faithful ``gaussian_derivative``, runs ``ved(vol,
config=VEDConfig.cuda(hessian_mode=...), device="cuda")`` on the seeded
512^3 tube phantom (``utils.phantom``) once to warm up, then once under
``torch.profiler``, and prints the card's name and power limit, the wall
time, the device time (the sum of the kernels' times), the port's spans
(``utils.profiling``: calls, host ms, self device span ms each), and the
device time by kernel, grouped into the vesselness pipeline, the diffusion
solves and the rest.  The benchmark's ``device.idle_pct`` (``bench_port/``)
is the idle share: the union of the device's intervals, which a sum over
kernels over-reads once streams overlap.  Needs a CUDA device.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

import torch

from .profiling import PREFIX, device_us, span_table

SHAPE = (512, 512, 512)
#: the convolution kernels (B6, B7, B10) all start so; each is also summed
#: on its own
CONV_PREFIX = "conv_"
#: kernel-name fragments of each group
GROUPS = {
    "pipeline kernels (B6-B11)": (CONV_PREFIX, "fd_vesselness_kernel",
                                  "tensor_assembly_kernel", "fd_hessian_kernel"),
    "solve (B1-B5)": ("Compressed<", "stencil_kernel", "restrict_kernel", "prolong_kernel",
                      "assemble_kernel"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ..models.ved import VEDConfig, ved
    from .phantom import tube_phantom

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip())
    vol = tube_phantom(SHAPE, torch.Generator(device="cuda").manual_seed(0))
    for mode in ("smooth_fd", "gaussian_derivative"):
        if profile_one(vol, VEDConfig.cuda(hessian_mode=mode), ved):
            return 1
    return 0


def profile_one(vol, cfg, ved) -> int:
    """One warm-up call, one profiled call and its breakdown; 1 if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    ved(vol, config=cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ved(vol, config=cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages() if device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(PREFIX)]
    device = sum(device_us(e) for e in kernels) / 1e6
    if device == 0:
        print("the profiler saw no device time: time with CUDA events instead",
              file=sys.stderr)
        return 1
    print(f"VED {SHAPE} float32, VEDConfig.cuda(hessian_mode={cfg.hessian_mode!r}): "
          f"wall {wall:.4f} s, device {device:.4f} s")
    print("\n".join(span_table(prof)))
    grouped = {g: 0.0 for g in (*GROUPS, "other")}
    for e in kernels:
        group = next((g for g, frags in GROUPS.items()
                      if any(f in e.key for f in frags)), "other")
        grouped[group] += device_us(e) / 1e6
    for g, s in grouped.items():
        print(f"  {g}: {s * 1e3:.2f} ms, {s / device:.1%} of device time")
    families = {}
    for e in kernels:
        fam = re.search(rf"\b{CONV_PREFIX}\w+_kernel", e.key)
        if fam:
            families.setdefault(fam.group(0), []).append(e)
    for fam, hits in sorted(families.items()):
        print(f"  {fam}: {sum(device_us(e) for e in hits) / 1e3:.2f} ms in "
              f"{sum(e.count for e in hits)} launches")
    print(f"  {'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(kernels, key=device_us, reverse=True)[:20]:
        print(f"  {device_us(e) / 1e3:10.3f} {device_us(e) / 1e6 / device:6.1%} "
              f"{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
