#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 flags;
2. build: compiles the kernels from ``multigridanisotropicdiffusion_tpu_torch/
   csrc`` and loads them;
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   device inputs (512^3 level 0, the 256^3 -> 128^3 all-cell pair, every
   level of a (69, 77, 69) vertex-centred hierarchy), float32 and, for the
   stencil and transfer kernels, bfloat16; median times by CUDA events;
4. reference: a small float64 solve through the kernels against a dense
   direct solve, and the float32 + bf16 path on the same input;
5. main path: ``mad_diffusion`` at 512^3 with ``MADConfig.cuda()`` to a
   relative residual of 1e-6, with every kernel's launch count read from
   that run; then the same inputs with ``use_kernels=False``, which must
   agree to 1e-4 relative L2.

The line before the last is ``{"kernels": [...]}`` (name, source, the TPU
kernel it replaces, launches in the main-path run, max abs error, kernel and
plain milliseconds at 512^3 float32); the last line is
``{"ok": true, "device": {...}}``.

Tolerances: float32 max |kernel - plain| <= 1e-5 max |plain| (the sums run
in another order); bfloat16 |kernel - plain| <= one bf16 ulp of each plain
value (both compute in float32 and round once), with the float32 bound as a
floor for values near zero, where cancellation makes the float32 sums
themselves differ.
"""

import json
import statistics
import subprocess
import sys
import time

SHAPE = (512, 512, 512)
DT = 0.1
KERNELS = {
    # name: (source, replaced Pallas kernel, phase-3 case reported)
    "stencil_halfsweep": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stencil_halfsweep0 f32",
    ),
    "stencil_residual": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stencil_residual f32",
    ),
    "restrict3d": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/transfer.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_transfer.py:239",
        "restrict3d f32",
    ),
    "prolong3d": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/transfer.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_transfer.py:466",
        "prolong3d f32",
    ),
    "assemble_compressed": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/assemble_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_assemble.py:245",
        "assemble_compressed f32",
    ),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def check(name, got, want):
    """Compare a kernel's output with its plain version; returns max abs err.
    Works through the tensors in chunks to bound the float64 temporaries."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g_all, w_all = got.reshape(-1), want.reshape(-1)
    scale = w_all.abs().max().double().item()
    tiny = torch.finfo(torch.float32).tiny
    max_err, ok, finite = 0.0, True, True
    for start in range(0, g_all.numel(), 1 << 26):
        g = g_all[start:start + (1 << 26)].double()
        w = w_all[start:start + (1 << 26)].double()
        finite = finite and bool(torch.isfinite(g).all())
        err = (g - w).abs()
        max_err = max(max_err, err.max().item())
        if want.dtype == torch.bfloat16:
            bound = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(tiny))) - 7)
            ok = ok and bool((err <= bound.clamp_min(1e-5 * scale)).all())
    if want.dtype == torch.bfloat16:
        tol = "1 bf16 ulp"
    else:
        tol_rel = 1e-12 if want.dtype == torch.float64 else 1e-5
        ok = max_err <= tol_rel * scale
        tol = f"{tol_rel:g} x max|ref|"
    ok = ok and finite
    log(f"  {name}: max_abs_err={max_err:.3e} max|ref|={scale:.3e} tol={tol} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain version (or is not finite)")
    return max_err


def median_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bench_tensor(shape, gen):
    """bench.py's construction: per voxel G G^T + 2 I with G normal."""
    import torch

    rows = torch.randn((3, 3, *shape), generator=gen, device="cuda")
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    t = torch.empty((6, *shape), device="cuda")
    for k, (i, j) in enumerate(pairs):
        torch.sum(rows[i] * rows[j], dim=0, out=t[k])
        if i == j:
            t[k] += 2.0
    return t


def phase_device():
    import torch

    log("== phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    from multigridanisotropicdiffusion_tpu_torch.utils import build

    log("== phase 2: build")
    t0 = time.perf_counter()
    build.load_library()
    log(f"built and loaded {build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    regs = [ln.strip() for ln in (build.BUILD_DIR / "build.log").read_text().splitlines()
            if "registers" in ln]
    log(f"ptxas: {len(regs)} kernels; " + "; ".join(sorted(set(regs))))


def check_level(tag, shape, spacing, next_centering, gen, errs, timings):
    """All kernels at one level: assembly (f32), stencil (f32, bf16) and,
    with ``next_centering``, the transfers to and from the next level.
    Records ``errs[(case, tag)]`` and ``timings[(case, tag)]`` (kernel ms,
    plain ms)."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.ops import (
        compressed,
        cuda_assemble,
        cuda_smoothers,
        cuda_transfer,
        transfer,
    )

    def timed(name, kernel, plain):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        errs[(name, tag)] = check(f"{name} {tag}", got, want)
        del got, want
        ms = timings[(name, tag)] = (median_ms(kernel, 10), median_ms(plain, 3))
        log(f"    {name} {tag}: kernel {ms[0]:.3f} ms, plain {ms[1]:.3f} ms")

    t = bench_tensor(shape, gen)
    timed("assemble_compressed f32",
          lambda: cuda_assemble.cuda_assemble_compressed_dca(t, spacing, DT).planes,
          lambda: compressed.assemble_compressed_dca(t, spacing, DT).planes)
    op32 = compressed.assemble_compressed_dca(t, spacing, DT)
    x32 = torch.randn(shape, generator=gen, device="cuda") * 10.0
    b32 = torch.rand(shape, generator=gen, device="cuda") * 255.0
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        op, x, b = op32.astype(dtype), x32.to(dtype), b32.to(dtype)
        for color in (0, 1):
            timed(f"stencil_halfsweep{color} {suffix}",
                  lambda: cuda_smoothers.halfsweep(op, x, b, color),
                  lambda: cuda_smoothers.halfsweep_plain(op, x, b, color))
        timed(f"stencil_residual {suffix}",
              lambda: cuda_smoothers.cuda_residual(op, x, b),
              lambda: cuda_smoothers.residual_plain(op, x, b))
        if next_centering is not None:
            cent = next_centering
            e = transfer.restrict_plain(x, cent)
            timed(f"restrict3d {suffix}",
                  lambda: cuda_transfer.cuda_restrict(x, cent),
                  lambda: transfer.restrict_plain(x, cent))
            timed(f"prolong3d {suffix}",
                  lambda: cuda_transfer.cuda_prolong(e, cent),
                  lambda: transfer.prolong_plain(e, cent))
            if dtype == torch.float32:
                timed("restrict3d batch6 f32",
                      lambda: cuda_transfer.cuda_restrict(t, cent),
                      lambda: transfer.restrict_plain(t, cent))
            del e
        del op, x, b
    del t, op32, x32, b32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_kernels(gen):
    from multigridanisotropicdiffusion_tpu_torch.core.grids import (
        CELL,
        build_level_descriptors,
    )

    log("== phase 3: kernels against their plain versions")
    errs, timings = {}, {}
    check_level("512^3", SHAPE, (1.0,) * 3, (CELL,) * 3, gen, errs, timings)
    check_level("256^3", (256,) * 3, (1.0,) * 3, (CELL,) * 3, gen, errs, timings)
    levels = build_level_descriptors((69, 77, 69))
    for i, lvl in enumerate(levels):
        nxt = levels[i + 1].centering if i + 1 < len(levels) else None
        check_level(f"{lvl.shape}", lvl.shape, lvl.spacing, nxt, gen, errs, timings)
    return errs, timings


def phase_reference(gen):
    import numpy as np
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.stencil import densify
    from multigridanisotropicdiffusion_tpu_torch.ops.dca import assemble_dca

    log("== phase 4: small reference solve against a dense direct solve")
    shape, spacing = (14, 13, 12), (1.0, 0.5, 2.0)
    t = bench_tensor(shape, gen).double()
    b = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64) * 255.0
    a = densify(assemble_dca(t, spacing, DT))
    want = torch.linalg.solve(a, b.reshape(-1)).reshape(shape)
    for cfg, dtype, tol, bound in (
        (MADConfig.cuda(False, time_step=DT, tolerance=1e-10), torch.float64, 1e-10, 1e-7),
        (MADConfig.cuda(time_step=DT, tolerance=1e-6), torch.float32, 1e-6, 1e-4),
    ):
        res = mad_diffusion(b, t, spacing, cfg, dtype=dtype, device="cuda")
        rel = ((res.output.double() - want).norm() / want.norm()).item()
        fin = float(res.final_residual[0])
        log(f"  {dtype}: cycles={int(res.num_cycles[0])} relres={fin:.3e} "
            f"rel_l2_vs_dense={rel:.3e} (bound {bound:g})")
        if not (fin <= tol and rel <= bound and np.isfinite(rel)):
            fail(f"reference solve in {dtype} is off")


def phase_main(gen):
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
    from multigridanisotropicdiffusion_tpu_torch.ops import (
        cuda_assemble,
        cuda_smoothers,
        cuda_transfer,
    )

    log("== phase 5: main path, mad_diffusion at 512^3 to 1e-6")
    counters = {
        "stencil_halfsweep": cuda_smoothers.halfsweep,
        "stencil_residual": cuda_smoothers.cuda_residual,
        "restrict3d": cuda_transfer.cuda_restrict,
        "prolong3d": cuda_transfer.cuda_prolong,
        "assemble_compressed": cuda_assemble.cuda_assemble_compressed_dca,
    }
    tensor = bench_tensor(SHAPE, gen)
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    levels = build_level_descriptors(SHAPE)
    log(f"  levels: {[lvl.shape for lvl in levels]}")
    kw = dict(time_step=DT, tolerance=1e-6, max_cycles=50)
    outputs, launches = {}, None
    for label, cfg in (("kernels", MADConfig.cuda(**kw)),
                       ("plain", MADConfig.cuda(use_kernels=False, **kw))):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mad_diffusion(b, tensor, config=cfg, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {k: f.launches for k, f in counters.items()}
        if label == "kernels":
            launches = counts
            missing = [k for k, n in counts.items() if n == 0]
            if missing:
                fail(f"kernels not launched on the main path: {missing}")
        elif any(counts.values()):
            fail(f"use_kernels=False launched kernels: {counts}")
        n = int(res.num_cycles[0])
        fin = float(res.final_residual[0])
        hist = [f"{v:.3e}" for v in res.residual_history[0, :n].tolist()]
        if tuple(res.output.shape) != SHAPE or not bool(torch.isfinite(res.output).all()):
            fail(f"{label}: output not finite or of the wrong shape")
        if not (fin <= 1e-6 and n < 50):
            fail(f"{label}: did not converge (cycles {n}, relres {fin:.3e})")
        outputs[label] = res.output
        del res
        # setup alone, then a warm solve on that hierarchy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hier = build_hierarchy(tensor, levels, DT, operator_repr="compressed",
                               use_kernels=cfg.use_kernels)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = mad_diffusion(b, tensor, config=cfg, device="cuda", hierarchy=hier)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        del res, hier
        torch.cuda.empty_cache()
        log(f"  {label}: first call {first_s:.3f} s, setup {setup_s:.3f} s, "
            f"warm solve {solve_s:.3f} s, cycles {n}, relres {fin:.3e}, "
            f"history {hist}")
        if label == "kernels":
            log(f"  launches in the first kernels call: {launches}")
        log(f"  peak device memory so far {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    rel = ((outputs["kernels"] - outputs["plain"]).norm()
           / outputs["plain"].norm()).item()
    log(f"  kernels vs plain output: rel_l2={rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail("the kernel path and the plain path disagree")
    return launches


def main():
    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")
    import torch

    smi = phase_device()
    try:
        import multigridanisotropicdiffusion_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, timings = phase_kernels(gen)
    phase_reference(gen)
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches = phase_main(gen)

    rows = []
    for name, (source, replaces, case) in KERNELS.items():
        ms, plain_ms = timings[(case, "512^3")]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[(case, "512^3")],
            "ms": ms, "plain_ms": plain_ms, "shape": list(SHAPE), "dtype": "float32",
        })
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
