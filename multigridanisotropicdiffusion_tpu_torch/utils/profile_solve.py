"""Where the time of one warm solve goes, on one CUDA card.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.profile_solve

For each configuration below, builds the hierarchy on ``chip_smoke.py``'s
seeded inputs (per cell ``G G^T + 2 I`` with G normal, b uniform in [0,
255)), runs one warm-up solve, then one solve on that hierarchy under
``torch.profiler``, and prints the wall time, the device time (the sum of
the kernels' times; one stream), the device's idle share and the device
time by kernel, grouped by the port's kernels.  The card's name and power
limit come first.  Needs a CUDA device.

* the 512^3 solve to 1e-6, ``MADConfig.cuda()`` (compressed DCA levels,
  the main path);
* the 512^3 solve to 1e-6 with collapsed Galerkin levels,
  ``MADConfig.cuda(coarse_operator='galerkin')``;
* the 8192^2 2D solve to 1e-6, ``MADConfig.cuda()``.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from .profile_ved import _device_us

CASES = (
    ("dca 512^3", (512, 512, 512), {}),
    ("galerkin collapsed 512^3", (512, 512, 512), dict(coarse_operator="galerkin")),
    ("dca 8192^2", (8192, 8192), {}),
)
#: kernel-name fragments of each group (the tile kernel's contraction names
#: the stencil; the older trees' kernel names too, so that a copy of this
#: script in such a tree groups alike)
GROUPS = {
    "B1/B2 compressed 3D stencil": ("Compressed<", "stencil_kernel"),
    "B12 stored 3D stencil (and B13's stored form)": ("Taps<", "stored_kernel"),
    "B13 2D compressed stencil": ("compressed2d_kernel",),
    "B3/B4 3D transfers": ("restrict_kernel", "prolong_kernel"),
}


def _inputs(shape):
    gen = torch.Generator(device="cuda").manual_seed(0)
    nd = len(shape)
    rows = torch.randn((nd, nd, *shape), generator=gen, device="cuda")
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    t = torch.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0)
                     for i, j in pairs])
    b = torch.rand(shape, generator=gen, device="cuda") * 255.0
    return t, b


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from ..core.grids import build_level_descriptors
    from ..models.mad import MADConfig, build_hierarchy, mad_diffusion

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip())
    for title, shape, kw in CASES:
        t, b = _inputs(shape)
        cfg = MADConfig.cuda(time_step=0.1, tolerance=1e-6, **kw)
        hier = build_hierarchy(t, build_level_descriptors(shape), cfg.time_step,
                               cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels,
                               cfg.galerkin_variant)
        mad_diffusion(b, t, config=cfg, device="cuda", hierarchy=hier)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = mad_diffusion(b, t, config=cfg, device="cuda", hierarchy=hier)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if _device_us(e) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        device = sum(_device_us(e) for e in kernels) / 1e6
        if device == 0:
            print("the profiler saw no device time: time with CUDA events instead",
                  file=sys.stderr)
            return 1
        print(f"{title}, MADConfig.cuda({kw}): {int(res.num_cycles[0])} cycles, wall "
              f"{wall:.4f} s, device {device:.4f} s, device idle "
              f"{max(0.0, 1 - device / wall):.1%}")
        grouped = {g: 0.0 for g in (*GROUPS, "other")}
        for e in kernels:
            group = next((g for g, frags in GROUPS.items()
                          if any(f in e.key for f in frags)), "other")
            grouped[group] += _device_us(e) / 1e6
        for g, s in grouped.items():
            print(f"  {g}: {s * 1e3:.2f} ms, {s / device:.1%} of device time")
        print(f"  {'device ms':>10} {'share':>6} {'calls':>6}  kernel")
        for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
            print(f"  {_device_us(e) / 1e3:10.3f} {_device_us(e) / 1e6 / device:6.1%} "
                  f"{e.count:6d}  {e.key[:90]}")
        del t, b, hier, res, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
