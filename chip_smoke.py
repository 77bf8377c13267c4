#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 flags;
2. build: compiles the kernels from ``multigridanisotropicdiffusion_tpu_torch/
   csrc`` and loads them;
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   device inputs.  The solve's kernels at 512^3 level 0, the 256^3 -> 128^3
   all-cell pair and every level of a (69, 77, 69) vertex-centred hierarchy,
   float32 and, for the stencil and transfer kernels, bfloat16.  The VED
   kernels on a tube phantom: 512^3 float32 and bfloat16 storage with
   sigma = 2 taps (r = 8), an odd (37, 45, 51) volume, and r = 32 (sigma = 2
   at z spacing 0.25) on a small volume; B8 in its first and select
   variants.  Median times by CUDA events, beside the library call that
   computes the same function where there is one;
4. reference: a small float64 solve through the kernels against a dense
   direct solve, and the float32 + bf16 path on the same input;
5. MAD main path: ``mad_diffusion`` at 512^3 with ``MADConfig.cuda()`` to a
   relative residual of 1e-6, with the solve kernels' launch counts read
   from that run; then the same inputs with ``use_kernels=False``, which
   must agree to 1e-4 relative L2;
6. VED main path: ``ved(vol, config=VEDConfig.cuda(), device="cuda")`` on a
   512^3 float32 tube phantom (5 scales, 8 z slabs, 5 diffusion steps), with
   all nine kernels' launch counts read from that run; every step must
   converge, the vesselness at a tube centre must exceed 0.1 with the
   tensor's principal axis along the tube, and ``use_kernels=False`` must
   agree to 1e-4 relative L2;
7. Galerkin main path: ``mad_diffusion`` on phase 5's 512^3 inputs with
   ``MADConfig.cuda(coarse_operator='galerkin')`` (collapsed levels, the
   stored-operator kernel B12 from level 1 down), then
   ``galerkin_variant='exact'`` (radius-2 levels; at 256^3 if the 512^3
   setup's peak device memory passes 60 GB), each to 1e-6 in < 100 cycles,
   each with ``use_kernels=False`` (within one cycle, 1e-4 relative L2);
8. 2D main path: lena from ``tests/goldens/lena_gs_v.npz`` in float64
   through the 2D kernel B13 (relative residual 1e-10, within 1e-8 relative
   L2 of the golden), then a seeded 8192^2 float32 solve under
   ``MADConfig.cuda()`` with the compressed DCA operator and with collapsed
   Galerkin levels, each against ``use_kernels=False``;
9. reference-faithful VED: phase 6's 512^3 phantom through
   ``VEDMultigridImageFilter(device="cuda").set_config(VEDConfig.cuda(
   hessian_mode="gaussian_derivative"))`` (B6 and B10 in every Hessian), with
   the conv_z / conv_y / conv_x launch counts read from that run (120 / 240 /
   240), the phase-6 convergence and tube checks, and the same filter with
   ``use_kernels=False`` within 1e-4 relative L2; warm pipeline and warm
   solve seconds apart; then ``hessian(vol, 2.0, mode="smooth_fd",
   use_kernels=True)``, which must launch B11 once and match its plain path;
10. the modules without kernels on the card, at 256^3 on phase 5's
   construction: ``MADConfig.cuda(operator_repr="matrix_free")``,
   ``MADConfig.cuda(smoother="chebyshev")`` and ``mad_diffusion_verbose``
   with ``MADConfig.cuda(mixed_precision=False)``, each to 1e-6 and within
   1e-4 relative L2 of the compressed DCA solve; the trace's line count.
   The compressed solve and the two kernel-less ones are each timed as a
   first call, the setup alone and a warm solve; the trace as a first and a
   second call, setup included.

Phase 3 also holds B10 (``conv_y``, ``conv_x``: 512^3 float32 and bfloat16,
(37, 45, 51), and r = 64 on (12, 150, 150)) and B11 (``fd_hessian``: the
valid-z smoothed 512^3 field of 514 planes, float32 and bfloat16, and
(39, 45, 51)) against their plain versions, and B12 and B13: B12 on the
512^3 19-plane stored DCA operator, on level 1 (256^3) of the 512^3
collapsed and exact Galerkin hierarchies and on every level of (69, 77, 69)
vertex-centred Galerkin hierarchies; B13 on 8192^2 compressed and stored
operators and on a (1531, 997) grid.

The line before the last is ``{"kernels": [...]}``, 16 rows (name, route, source, the
TPU kernel it replaces, launches in its main-path run, max abs error, kernel,
plain and library milliseconds, and the bound: the larger of the bytes the
function must move over 3.35 TB/s and its float operations over 67 TFLOP/s,
float32 at the shape in the row); the last line is ``{"ok": true,
"device": {...}}``.

Tolerances: float32 max |kernel - plain| <= 1e-5 max |plain| (the sums run
in another order); bfloat16 |kernel - plain| <= one bf16 ulp of each plain
value (both compute in float32 and round once), with the float32 bound as a
floor for values near zero, where cancellation makes the float32 sums
themselves differ.  B8's Hessian planes are compared where both versions
took the same select decision (a flip at a near-tie with the incoming best
is counted and must stay under 1e-6 of the voxels); B9's tensors where the
top eigenvalue is not degenerate (gap >= 1e-4 of the matrix scale; there
only the trace is compared, and the voxels where the two versions differ
are counted and must stay under 1e-5 of the voxels); both counts come from
``multigridanisotropicdiffusion_tpu_torch/utils/compare.py``, which the GPU
tests share.  The small volumes allow one such voxel.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (512, 512, 512)
SHAPE_2D = (8192, 8192)
DT = 0.1
LENA = Path(__file__).resolve().parent / "tests" / "goldens" / "lena_gs_v.npz"
#: the exact Galerkin variant falls back to 256^3 above this setup peak
EXACT_PEAK_LIMIT_GIB = 60e9 / 2**30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PARAMS = (0.5, 0.5, 5.0)  # VEDConfig's alpha, beta, gamma
TENSOR_PARAMS = (0.01, 5.0, 10.0)  # epsilon, omega, sensitivity
#: float operations per output voxel, counted from the kernels' sources
#: (every add, multiply, compare-select and math-library call as one)
OPS_FD_VESSELNESS = 170
OPS_TENSOR_ASSEMBLY = 265
OPS_FD_HESSIAN = 24
#: phase 9's expected B6/B10 launches: 8 z slabs x 5 scales x (3 z, 6 y, 6 x)
GD_LAUNCHES = {"conv_z": 120, "conv_y": 240, "conv_x": 240}
KERNELS = {
    # name: (source, replaced Pallas kernel, phase-3 case reported[, its
    # tag when not the 512^3 level])
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
    "conv_z": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/conv.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_conv.py:115",
        "conv_z f32",
    ),
    "conv_yx": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/conv.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_conv.py:391",
        "conv_yx f32",
    ),
    "fd_vesselness": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/vesselness.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_vesselness.py:130",
        "fd_vesselness select f32",
    ),
    "tensor_assembly": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/vesselness.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_vesselness.py:217",
        "tensor_assembly f32",
    ),
    "stencil_stored_halfsweep": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_stored.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stored_halfsweep0 f32", "256^3 collapsed",
    ),
    "stencil_stored_residual": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_stored.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stored_residual f32", "256^3 collapsed",
    ),
    "stencil_2d_halfsweep": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_2d.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:537",
        "2d_halfsweep0 f32", "8192^2 compressed",
    ),
    "stencil_2d_residual": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_2d.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:537",
        "2d_residual f32", "8192^2 compressed",
    ),
    "conv_y": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/conv.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_conv.py:220",
        "conv_y f32",
    ),
    "conv_x": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/conv.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_conv.py:309",
        "conv_x f32",
    ),
    "fd_hessian": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/vesselness.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_conv.py:581",
        "fd_hessian f32",
    ),
}
#: the kernels of the 3D compressed solve and of the VED call
STENCIL_3D = ("stencil_halfsweep", "stencil_residual", "restrict3d", "prolong3d",
              "assemble_compressed")
VED_KERNELS = STENCIL_3D + ("conv_z", "conv_yx", "fd_vesselness", "tensor_assembly")
#: the kernels of the gaussian_derivative VED call
GD_KERNELS = STENCIL_3D + ("conv_z", "conv_y", "conv_x")
#: B12/B13 cases reported beside the row's own (phase-3 tags)
EXTRA_CASES = {
    "stencil_stored_halfsweep": ("512^3 stored DCA", "256^3 exact"),
    "stencil_stored_residual": ("512^3 stored DCA", "256^3 exact"),
    "stencil_2d_halfsweep": ("8192^2 stored",),
    "stencil_2d_residual": ("8192^2 stored",),
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


def median_ms(fn, reps, setup=None):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up;
    ``setup`` runs before each launch, outside the timed window."""
    import torch

    if setup:
        setup()
    fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, ops):
    """The least time for the work: bytes over the memory rate or float
    operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_tensor(shape, gen):
    """bench.py's construction: per voxel G G^T + 2 I with G normal (D x D
    for a D-dimensional grid), as a symfield-order stack."""
    import torch

    nd = len(shape)
    rows = torch.randn((nd, nd, *shape), generator=gen, device="cuda")
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    t = torch.empty((len(pairs), *shape), device="cuda")
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


def check_stencil(prefix, tag, module, op32, gen, errs, timings, work, timed_runs):
    """B12 (``module`` = ``ops.cuda_stencil_stored``) or B13
    (``ops.cuda_stencil2d``) on one float32 operator: both half-sweeps and
    the residual in float32 and bfloat16 against the plain versions.  With
    ``timed_runs``: CUDA-event medians and each call's work, (K + 3) values
    per cell and 2 K float operations."""
    import torch

    shape = op32.shape
    planes = op32.planes if hasattr(op32, "planes") else op32.coeffs
    k = planes.shape[0]
    cells = math.prod(shape)
    x32 = torch.randn(shape, generator=gen, device="cuda") * 10.0
    b32 = torch.rand(shape, generator=gen, device="cuda") * 255.0
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        op, x, b = op32.astype(dtype), x32.to(dtype), b32.to(dtype)
        cases = [(f"{prefix}_halfsweep{c} {suffix}",
                  lambda c=c: module.halfsweep(op, x, b, c),
                  lambda c=c: module.halfsweep_plain(op, x, b, c)) for c in (0, 1)]
        cases.append((f"{prefix}_residual {suffix}",
                      lambda: module.cuda_residual(op, x, b),
                      lambda: module.residual_plain(op, x, b)))
        for name, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs[(name, tag)] = check(f"{name} {tag} (K={k})", got, want)
            del got, want
            if timed_runs:
                ms = timings[(name, tag)] = (median_ms(kernel, 10), median_ms(plain, 3))
                work[(name, tag)] = ((k + 3) * cells * x.element_size(), 2 * k * cells,
                                     shape, str(dtype).replace("torch.", ""))
                log(f"    {name} {tag}: kernel {ms[0]:.3f} ms, plain {ms[1]:.3f} ms, "
                    f"bound {bound_ms(*work[(name, tag)][:2])[0]:.3f} ms")
        del op, x, b
    del x32, b32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_stored_and_2d(gen, errs, timings, work):
    """B12 and B13 on the operators of the Galerkin, stored and 2D paths."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.core.grids import (
        CELL,
        build_level_descriptors,
    )
    from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
    from multigridanisotropicdiffusion_tpu_torch.ops import (
        compressed,
        cuda_stencil2d,
        cuda_stencil_stored,
        dca,
        galerkin,
    )

    log("  stored-operator kernel (B12)")
    t = bench_tensor(SHAPE, gen)
    stored = dca.assemble_dca(t, (1.0,) * 3, DT)
    check_stencil("stored", "512^3 stored DCA", cuda_stencil_stored, stored, gen, errs,
                  timings, work, True)
    del stored
    torch.cuda.empty_cache()
    # level 1 of the 512^3 Galerkin hierarchies; collapsing the exact
    # parabolic level gives the collapsed one bit for bit (the identity sits
    # on the centre, which no other offset lumps onto, and negation is exact)
    op0 = compressed.assemble_compressed_dca(t, (1.0,) * 3, DT)
    del t
    exact = galerkin.assemble_galerkin_parabolic(op0, (CELL,) * 3)
    del op0
    torch.cuda.empty_cache()
    collapsed = galerkin.collapse_to_radius1(exact)
    check_stencil("stored", "256^3 collapsed", cuda_stencil_stored, collapsed, gen, errs,
                  timings, work, True)
    del collapsed
    check_stencil("stored", "256^3 exact", cuda_stencil_stored, exact, gen, errs,
                  timings, work, True)
    del exact
    torch.cuda.empty_cache()
    shape = (69, 77, 69)
    t = bench_tensor(shape, gen)
    for variant in ("collapsed", "exact"):
        hier = build_hierarchy(t, build_level_descriptors(shape), DT, "galerkin",
                               "compressed", galerkin_variant=variant)
        for op in hier.operators:
            if isinstance(op, StencilOperator):
                check_stencil("stored", f"{op.shape} {variant}", cuda_stencil_stored, op,
                              gen, errs, timings, work, False)
    del t, hier
    log("  2D kernel (B13)")
    t = bench_tensor(SHAPE_2D, gen)
    for form, assemble in (("compressed", compressed.assemble_compressed_dca),
                           ("stored", dca.assemble_dca)):
        check_stencil("2d", f"8192^2 {form}", cuda_stencil2d, assemble(t, (1.0, 1.0), DT),
                      gen, errs, timings, work, True)
    del t
    t = bench_tensor((1531, 997), gen)
    for form, assemble in (("compressed", compressed.assemble_compressed_dca),
                           ("stored", dca.assemble_dca)):
        check_stencil("2d", f"(1531, 997) {form}", cuda_stencil2d,
                      assemble(t, (1.0, 0.7), DT), gen, errs, timings, work, False)
    del t
    torch.cuda.empty_cache()


def check_select(name, got, want, new_k, new_p, best_resp):
    """B8's select variant: the response everywhere, the Hessian planes where
    both versions took the same decision (``utils.compare.select_flips``)."""
    from multigridanisotropicdiffusion_tpu_torch.utils.compare import select_flips

    err = check(f"{name} resp", got[0], want[0])
    sel = select_flips(new_k, new_p, best_resp, want[0].abs().max().item())
    log(f"  {name}: {sel.n_flip} select flips at near-ties of {sel.keep.numel()} voxels")
    if not sel.ok:
        fail(f"{name}: {sel.n_flip} select flips, near-ties only: {sel.near_ties_only}")
    return max(err, check(f"{name} h", got[1][:, sel.keep], want[1][:, sel.keep]))


def check_tensor(name, got, want, resp, h):
    """B9: the tensor wherever the top eigenvalue is not degenerate; at a
    degenerate voxel the trace, and a count of the voxels where the two
    versions differ (``utils.compare.degenerate_tops``)."""
    from multigridanisotropicdiffusion_tpu_torch.utils.compare import degenerate_tops

    deg = degenerate_tops(got, want, resp, h, 1e-5)
    log(f"  {name}: {deg.n_degenerate} voxels with a degenerate top eigenvalue of "
        f"{deg.keep.numel()}, {deg.n_differ} of them differ; traces agree there: "
        f"{deg.trace_ok}")
    if not deg.ok:
        fail(f"{name}: {deg.n_differ} degenerate voxels differ, traces agree: "
             f"{deg.trace_ok}")
    return check(name, got[:, deg.keep], want[:, deg.keep])


def recorder(tag, u, timings, timed_runs):
    """``(suffix, key, record)`` for the cases of one volume ``u``: its
    dtype's suffix; ``key(name)`` is
    ``("<kernel> <dtype>", tag)``, as the solve kernels' cases;
    ``record(name, kernel, plain, library=None, setup=None)`` stores the
    CUDA-event medians of the three (``setup`` runs before each launch,
    outside the timed window) when ``timed_runs``."""
    import torch

    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[u.dtype]

    def key(name):
        return (f"{name} {suffix}", tag)

    def record(name, kernel, plain, library=None, setup=None):
        if not timed_runs:
            return
        ms = median_ms(kernel, 10, setup)
        plain_ms = median_ms(plain, 3, setup)
        lib_ms = median_ms(library, 10) if library else None
        timings[key(name)] = (ms, plain_ms, lib_ms)
        log(f"    {name} {suffix} {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}")

    return suffix, key, record


def check_ved_kernels(tag, u, spacing, errs, timings, work, timed_runs):
    """B6-B9 on one volume ``u`` (storage dtype): B6 over the sigma = 2 halo,
    B7 on its output, B8 first (sigma = 1.245) and select (sigma = 2), B9 on
    the winner.  With ``timed_runs``: CUDA-event medians, the library
    yardsticks, and the bytes and operations of each call."""
    import torch
    import torch.nn.functional as F

    from multigridanisotropicdiffusion_tpu_torch.models.ved import (
        _make_assemble_fn,
        vesselness_measure,
    )
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness
    from multigridanisotropicdiffusion_tpu_torch.ops.cuda_conv import edge_pad
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import (
        fd_factors,
        gaussian_kernels_1d,
        kernel_radius,
        smoothed_field_valid_z,
    )

    def fdv(us, facs, params, best=None):
        # measure_fn is what the wrapper runs on a CPU tensor; the kernel has
        # the formula compiled in
        return cuda_vesselness.fd_vesselness(us, facs, params, best,
                                             measure_fn=vesselness_measure)

    s1, s2 = 1.245, 2.0
    radius = kernel_radius(s2, spacing[0]) + 1
    u_pad = edge_pad(u, radius).contiguous()
    gz, gy, gx = (gaussian_kernels_1d(s2, h)[0] for h in spacing)
    f1, f2 = fd_factors(s1, spacing), fd_factors(s2, spacing)
    item = u.element_size()
    suffix, key, record = recorder(tag, u, timings, timed_runs)

    # B6, valid mode over the halo: (Z + 2r + 2) -> (Z + 2) planes
    errs[key("conv_z")] = check(f"conv_z {suffix} {tag}", cuda_conv.conv_z(u_pad, gz, True),
                                  cuda_conv.conv_z_plain(u_pad, gz, True))
    wz = torch.as_tensor(gz, dtype=u.dtype, device="cuda").reshape(1, 1, -1, 1, 1)
    u5 = u_pad[None, None]
    record("conv_z", lambda: cuda_conv.conv_z(u_pad, gz, True),
           lambda: cuda_conv.conv_z_plain(u_pad, gz, True),
           lambda: F.conv3d(u5, wz))
    zs = u_pad.shape[0] - (len(gz) - 1)
    work[key("conv_z")] = ((u_pad.numel() + zs * u[0].numel()) * item,
                             2 * len(gz) * zs * u[0].numel())
    us2_z = cuda_conv.conv_z(u_pad, gz, True)
    errs[key("conv_edge")] = check(f"conv_z edge {suffix} {tag}", cuda_conv.conv_z(u, gz),
                                     cuda_conv.conv_z_plain(u, gz))

    # B7 on B6's output; the library form is two calls: replicate-pad, conv3d
    errs[key("conv_yx")] = check(f"conv_yx {suffix} {tag}", cuda_conv.conv_yx(us2_z, gy, gx),
                                   cuda_conv.conv_yx_plain(us2_z, gy, gx))
    ry, rx = (len(gy) - 1) // 2, (len(gx) - 1) // 2
    wyx = torch.as_tensor(gy[:, None] * gx[None, :], dtype=u.dtype,
                          device="cuda").reshape(1, 1, 1, len(gy), len(gx))
    v5 = us2_z[None, None]
    record("conv_yx", lambda: cuda_conv.conv_yx(us2_z, gy, gx),
           lambda: cuda_conv.conv_yx_plain(us2_z, gy, gx),
           lambda: F.conv3d(F.pad(v5, (rx, rx, ry, ry, 0, 0), mode="replicate"), wyx))
    work[key("conv_yx")] = (2 * us2_z.numel() * item,
                              2 * (len(gy) + len(gx)) * us2_z.numel())
    us2 = cuda_conv.conv_yx(us2_z, gy, gx)
    del us2_z, u5, v5
    us1 = smoothed_field_valid_z(u_pad, s1, spacing, radius, use_kernels=True)
    del u_pad

    # B8, first and select variants
    first = fdv(us1, f1, PARAMS)
    want = cuda_vesselness.fd_vesselness_plain(us1, f1, PARAMS, None, vesselness_measure)
    errs[key("fd_vesselness first")] = max(check(f"fd_vesselness first {suffix} {tag} resp",
                                                   first[0], want[0]),
                                             check(f"fd_vesselness first {suffix} {tag} h",
                                                   first[1], want[1]))
    del want
    record("fd_vesselness first", lambda: fdv(us1, f1, PARAMS),
           lambda: cuda_vesselness.fd_vesselness_plain(us1, f1, PARAMS, None,
                                                       vesselness_measure))
    n = first[0].numel()
    resp_item = first[0].element_size()
    work[key("fd_vesselness first")] = (us1.numel() * item + n * (resp_item + 6 * item),
                                          OPS_FD_VESSELNESS * n)
    new_k = fdv(us2, f2, PARAMS)[0]
    new_p = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, None, vesselness_measure)[0]
    incoming = (first[0].clone(), first[1].clone())
    got = fdv(us2, f2, PARAMS, first)
    want = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, incoming,
                                               vesselness_measure)
    errs[key("fd_vesselness select")] = check_select(
        f"fd_vesselness select {suffix} {tag}", got, want, new_k, new_p, incoming[0])
    winners = int((new_k > incoming[0]).sum())
    del new_k, new_p, got

    def restore():
        first[0].copy_(incoming[0])
        first[1].copy_(incoming[1])

    record("fd_vesselness select", lambda: fdv(us2, f2, PARAMS, first),
           lambda: cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, incoming,
                                                       vesselness_measure),
           setup=restore)
    # in place: read us and the best response, write the winners' 7 values
    work[key("fd_vesselness select")] = (
        us2.numel() * item + n * resp_item + winners * (resp_item + 6 * item),
        OPS_FD_VESSELNESS * n)
    if timed_runs:
        log(f"    fd_vesselness select {suffix} {tag}: {winners} of {n} voxels win")
    del first, incoming, us1, us2

    # B9 on the winner
    resp, h = want
    assemble_fn = _make_assemble_fn(*TENSOR_PARAMS)
    errs[key("tensor_assembly")] = check_tensor(
        f"tensor_assembly {suffix} {tag}", cuda_vesselness.tensor_assembly(resp, h, *TENSOR_PARAMS, assemble_fn),
        cuda_vesselness.tensor_assembly_plain(resp, h, assemble_fn), resp, h)
    record("tensor_assembly", lambda: cuda_vesselness.tensor_assembly(resp, h, *TENSOR_PARAMS, assemble_fn),
           lambda: cuda_vesselness.tensor_assembly_plain(resp, h, assemble_fn))
    work[key("tensor_assembly")] = (n * (resp_item + 6 * item + 6 * resp_item),
                                      OPS_TENSOR_ASSEMBLY * n)
    del resp, h, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def fd_weights(facs, dtype):
    """The six central-difference stencils of ``fd_planes``, scaled by
    ``facs``, as a ``(6, 1, 3, 3, 3)`` conv3d weight (offset d at index
    1 + d)."""
    import torch

    w = torch.zeros((6, 1, 3, 3, 3), dtype=torch.float64)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    for k, (f, (i, j)) in enumerate(zip(facs, pairs)):
        if i == j:
            terms = [((s, 0), c) for s, c in ((1, 1.0), (0, -2.0), (-1, 1.0))]
        else:
            terms = [((si, sj), float(si * sj)) for si in (1, -1) for sj in (1, -1)]
        for (si, sj), c in terms:
            idx = [1, 1, 1]
            idx[i] += si
            idx[j] += sj
            w[(k, 0, *idx)] += c * f
    return w.to(dtype=dtype, device="cuda")


def check_axis_kernels(tag, u, spacing, errs, timings, work, timed_runs, sigma=2.0):
    """B10 and B11 on one volume ``u`` (storage dtype): ``conv_y`` and
    ``conv_x`` with sigma's second-derivative taps (the gaussian_derivative
    Hessian's passes, each rounded at its store), and ``fd_hessian`` on the
    valid-z smoothed field (Z + 2 planes).  Library yardsticks: for B10
    replicate-pad, then ``F.conv3d`` with a one-axis kernel; for B11
    replicate-pad y and x, then ``F.conv3d`` with the six 3x3x3 stencils
    (checked against the plain version in float32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import (
        fd_factors,
        gaussian_kernels_1d,
        smoothed_field_valid_z,
    )

    item = u.element_size()
    suffix, key, record = recorder(tag, u, timings, timed_runs)
    u5 = u[None, None]
    for axis, name in ((1, "conv_y"), (2, "conv_x")):
        taps = gaussian_kernels_1d(sigma, spacing[axis])[2]
        r = (len(taps) - 1) // 2
        kernel = getattr(cuda_conv, name)
        plain = getattr(cuda_conv, f"{name}_plain")
        errs[key(name)] = check(f"{name} {suffix} {tag} (r={r})",
                                kernel(u, taps), plain(u, taps))
        w = torch.as_tensor(taps, dtype=u.dtype, device="cuda")
        w = w.reshape(1, 1, 1, -1, 1) if axis == 1 else w.reshape(1, 1, 1, 1, -1)
        pad = (0, 0, r, r, 0, 0) if axis == 1 else (r, r, 0, 0, 0, 0)
        record(name, lambda: kernel(u, taps), lambda: plain(u, taps),
               lambda: F.conv3d(F.pad(u5, pad, mode="replicate"), w))
        work[key(name)] = (2 * u.numel() * item, 2 * int(np.count_nonzero(taps)) * u.numel())
    us = smoothed_field_valid_z(u, sigma, spacing, use_kernels=True)
    facs = fd_factors(sigma, spacing)
    want = cuda_vesselness.fd_hessian_plain(us, facs)
    errs[key("fd_hessian")] = check(
        f"fd_hessian {suffix} {tag} (input {tuple(us.shape)})",
        cuda_vesselness.fd_hessian(us, facs), want)
    # library form: y and x replicate-padded, one conv3d with the six stencils
    us5, w_fd = us[None, None], fd_weights(facs, u.dtype)

    def library():
        return F.conv3d(F.pad(us5, (1, 1, 1, 1, 0, 0), mode="replicate"), w_fd)[0]

    if u.dtype == torch.float32:
        # the conv sums the scaled terms where the plain version scales the
        # sum, so its float32 error scales with the terms, not the result
        err = (library() - want).abs().max().item()
        terms = us.abs().max().item() * w_fd.abs().sum((1, 2, 3, 4)).max().item()
        log(f"  fd_hessian library form {suffix} {tag}: max_abs_err={err:.3e}, "
            f"largest sum of |terms| {terms:.3e}, tol=1e-05 x that")
        if not err <= 1e-5 * terms:
            fail(f"fd_hessian's library form {tag} is not the plain version's function")
    del want
    record("fd_hessian", lambda: cuda_vesselness.fd_hessian(us, facs),
           lambda: cuda_vesselness.fd_hessian_plain(us, facs), library)
    work[key("fd_hessian")] = ((us.numel() + 6 * u.numel()) * item, OPS_FD_HESSIAN * u.numel())
    del us, us5, u5
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_kernels(gen):
    import torch

    from multigridanisotropicdiffusion_tpu_torch.core.grids import (
        CELL,
        build_level_descriptors,
    )
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_phantom

    log("== phase 3: kernels against their plain versions")
    errs, timings, work = {}, {}, {}
    check_level("512^3", SHAPE, (1.0,) * 3, (CELL,) * 3, gen, errs, timings)
    check_level("256^3", (256,) * 3, (1.0,) * 3, (CELL,) * 3, gen, errs, timings)
    levels = build_level_descriptors((69, 77, 69))
    for i, lvl in enumerate(levels):
        nxt = levels[i + 1].centering if i + 1 < len(levels) else None
        check_level(f"{lvl.shape}", lvl.shape, lvl.spacing, nxt, gen, errs, timings)
    log("  VED kernels (B6-B9) on the tube phantom")
    vol = tube_phantom(SHAPE, gen)
    for dtype in (torch.float32, torch.bfloat16):
        check_ved_kernels("512^3", vol.to(dtype), (1.0,) * 3, errs, timings, work, True)
    log("  gaussian_derivative and smooth_fd Hessian kernels (B10, B11)")
    for dtype in (torch.float32, torch.bfloat16):
        check_axis_kernels("512^3", vol.to(dtype), (1.0,) * 3, errs, timings, work, True)
    del vol
    small = tube_phantom((37, 45, 51), gen)
    for dtype in (torch.float32, torch.bfloat16):
        check_ved_kernels("(37, 45, 51)", small.to(dtype), (1.0, 0.9, 1.1), errs,
                          timings, work, False)
        check_axis_kernels("(37, 45, 51)", small.to(dtype), (1.0, 0.9, 1.1), errs,
                           timings, work, False)
    # sigma = 16: r = 64, the cap, on every axis
    check_axis_kernels("(12, 150, 150) r=64", tube_phantom((12, 150, 150), gen),
                       (1.0,) * 3, errs, timings, work, False, sigma=16.0)
    # sigma = 2 at z spacing 0.25: r = 32 along z (and 16 on y and x)
    check_ved_kernels("(40, 48, 56) r=32", tube_phantom((40, 48, 56), gen),
                      (0.25, 0.5, 0.5), errs, timings, work, False)
    torch.cuda.empty_cache()
    check_stored_and_2d(gen, errs, timings, work)
    return errs, timings, work


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

    log("== phase 5: main path, mad_diffusion at 512^3 to 1e-6")
    tensor = bench_tensor(SHAPE, gen)
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    launches, _ = solve_pair("dca 512^3", b, tensor, dict(time_step=DT, tolerance=1e-6),
                             STENCIL_3D, max_cycles=50)
    del tensor, b
    torch.cuda.empty_cache()
    return launches


def ved_pair(vol, cfg, run, expect, exact=None):
    """``run(cfg)``, a VED call on the 512^3 phantom ``vol`` through the
    kernels, then ``run`` with ``use_kernels=False``: every step must
    converge, the vesselness at a tube centre must exceed 0.1 with the
    tensor's principal axis along the tube, the kernel run must launch every
    kernel in ``expect`` (``exact[name]`` times where given) and the plain
    run none, and the two must agree within 1e-4 relative L2.  Each also
    runs warm, the pipeline and the solves apart.  Returns the kernel run's
    launch counts."""
    import dataclasses

    import torch

    from multigridanisotropicdiffusion_tpu_torch import mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.models.ved import (
        _auto_z_slab,
        fused_vesselness_tensor,
    )
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_centre

    counters = {k: f for k, f in all_counters().items() if k in expect}
    outputs, launches = {}, None
    for label, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, use_kernels=False))):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run(c)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {k: f.launches for k, f in counters.items()}
        if label == "kernels":
            launches = counts
            log(f"  launches in the first kernels call: {launches}")
            missing = [k for k, n in counts.items() if n == 0]
            if missing:
                fail(f"kernels not launched on this VED path: {missing}")
            wrong = {k: n for k, n in (exact or {}).items() if counts[k] != n}
            if wrong:
                fail(f"launch counts {wrong}, expected {exact}")
        elif any(counts.values()):
            fail(f"use_kernels=False launched kernels: {counts}")
        d = res.diffusion
        cycles = d.num_cycles.tolist()
        finals = d.final_residual.tolist()
        if tuple(res.output.shape) != SHAPE or not bool(torch.isfinite(res.output).all()):
            fail(f"{label}: VED output not finite or of the wrong shape")
        if not all(f <= 1e-6 for f in finals) or not all(n < 100 for n in cycles):
            fail(f"{label}: a diffusion step did not converge: {cycles} {finals}")
        # the thinnest tube, along z, at its centre
        centre = tube_centre(SHAPE)
        v_c = float(res.vesselness[centre])
        t = res.tensor[(slice(None), *centre)].double().cpu()
        m = torch.stack([torch.stack([t[0], t[1], t[2]]), torch.stack([t[1], t[3], t[4]]),
                         torch.stack([t[2], t[4], t[5]])])
        axis = torch.linalg.eigh(m).eigenvectors[:, -1]
        cos = abs(float(axis[0]))
        log(f"  {label}: vesselness at tube centre {centre}: {v_c:.4f}, principal "
            f"axis |cos| to the tube {cos:.4f}")
        if not (v_c > 0.1 and cos > 0.9):
            fail(f"{label}: the tube is not enhanced along its axis")
        peak = torch.cuda.max_memory_allocated() / 2**30
        outputs[label] = res.output
        del res, d, t
        # warm: the pipeline and the diffusion solves apart
        kw = dict(z_slab=_auto_z_slab(SHAPE, c.pipeline_z_slab),
                  hessian_mode=c.hessian_mode, use_kernels=c.use_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp, tensor = fused_vesselness_tensor(
            vol, tuple(c.scales), (1.0,) * 3, c.alpha, c.beta, c.gamma,
            c.epsilon, c.omega, c.sensitivity, **kw)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        del resp
        t0 = time.perf_counter()
        d = mad_diffusion(vol, tensor, config=c.mad_config(), device="cuda")
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        del d, tensor
        torch.cuda.empty_cache()
        log(f"  {label}: first call {first_s:.3f} s; warm pipeline {pipe_s:.3f} s, "
            f"warm solves {solve_s:.3f} s; cycles per step {cycles}, final relres "
            f"{[f'{f:.2e}' for f in finals]}; peak device memory {peak:.1f} GiB")
    rel = ((outputs["kernels"] - outputs["plain"]).norm()
           / outputs["plain"].norm()).item()
    log(f"  kernels vs plain VED output: rel_l2={rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail("the VED kernel path and the plain path disagree")
    return launches


def phase_ved(gen):
    """The VED main path at 512^3 float32 through VEDConfig.cuda(), then the
    same call with use_kernels=False."""
    from multigridanisotropicdiffusion_tpu_torch import VEDConfig, ved
    from multigridanisotropicdiffusion_tpu_torch.models.ved import _auto_z_slab
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import TUBES, tube_phantom

    log("== phase 6: VED main path, ved() at 512^3 float32 with VEDConfig.cuda()")
    vol = tube_phantom(SHAPE, gen)
    log(f"  phantom: {len(TUBES)} tubes, z slabs of {_auto_z_slab(SHAPE, 0)}")
    return ved_pair(vol, VEDConfig.cuda(), lambda c: ved(vol, config=c, device="cuda"),
                    VED_KERNELS)


def phase_ved_gd(gen):
    """The reference-faithful VED at 512^3 through the ITK façade, then the
    standalone smooth_fd Hessian (B11) once."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import VEDConfig, VEDMultigridImageFilter
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_vesselness
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import hessian
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_phantom

    log("== phase 9: reference-faithful VED, VEDMultigridImageFilter at 512^3 float32 "
        "with VEDConfig.cuda(hessian_mode='gaussian_derivative')")
    vol = tube_phantom(SHAPE, gen)

    def run(cfg):
        return (VEDMultigridImageFilter(device="cuda").set_config(cfg).set_input(vol)
                .update().get_result())

    launches = ved_pair(vol, VEDConfig.cuda(hessian_mode="gaussian_derivative"), run,
                        GD_KERNELS, GD_LAUNCHES)
    log("  hessian(vol, 2.0, mode='smooth_fd', use_kernels=True) at 512^3")
    cuda_vesselness.fd_hessian.launches = 0
    got = hessian(vol, 2.0, mode="smooth_fd", use_kernels=True)
    torch.cuda.synchronize()
    launches["fd_hessian"] = cuda_vesselness.fd_hessian.launches
    if launches["fd_hessian"] != 1:
        fail(f"hessian(mode='smooth_fd') launched B11 {launches['fd_hessian']} times")
    check("hessian smooth_fd 512^3 f32", got, hessian(vol, 2.0, mode="smooth_fd"))
    del got, vol
    torch.cuda.empty_cache()
    return launches


def phase_kernel_less(gen):
    """The modules without kernels on the card at 256^3, phase 5's
    construction: the matrix-free operator, the Chebyshev smoother and the
    verbose trace, each against the compressed DCA solve.  Each solve is
    timed as in ``solve_pair``: the first call, then the setup alone and a
    warm solve on that hierarchy; the trace, which builds its own, as a
    first and a second call, setup included."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
    from multigridanisotropicdiffusion_tpu_torch.models.trace import mad_diffusion_verbose

    log("== phase 10: matrix-free operator, Chebyshev smoother and verbose trace at 256^3")
    shape = (256,) * 3
    tensor = bench_tensor(shape, gen)
    b = torch.rand(shape, generator=gen, device="cuda") * 255.0
    kw = dict(time_step=DT, tolerance=1e-6)
    summary, ref = [], None

    def seconds_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def report(case, out, cycles, relres, times):
        rel = 0.0 if ref is None else ((out - ref).norm() / ref.norm()).item()
        log(f"  {case}: {cycles} cycles, " + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
            + f", relres {relres:.3e}, rel_l2 to the compressed DCA solve {rel:.3e} "
            "(bound 1e-4)")
        if not (bool(torch.isfinite(out).all()) and relres <= 1e-6 and cycles < 100
                and rel <= 1e-4):
            fail(f"{case} is off")
        summary.append(dict(case=case, cycles=cycles, relres=relres,
                            rel_l2_vs_compressed=rel, **times))

    for case, cfg in (("compressed", MADConfig.cuda(**kw)),
                      ("matrix_free", MADConfig.cuda(operator_repr="matrix_free", **kw)),
                      ("chebyshev", MADConfig.cuda(smoother="chebyshev", **kw))):
        res, first_s = seconds_of(lambda: mad_diffusion(b, tensor, config=cfg, device="cuda"))
        hier, setup_s = seconds_of(lambda: build_hierarchy(
            as_sym_planes(tensor, shape, dtype=b.dtype, device="cuda"),
            build_level_descriptors(shape), cfg.time_step, cfg.coarse_operator,
            cfg.operator_repr, cfg.use_kernels, cfg.galerkin_variant))
        warm, solve_s = seconds_of(lambda: mad_diffusion(b, tensor, config=cfg, device="cuda",
                                                         hierarchy=hier))
        again = ((warm.output - res.output).norm() / res.output.norm()).item()
        if not (again <= 1e-6 and int(warm.num_cycles[0]) == int(res.num_cycles[0])):
            fail(f"{case}: the warm solve differs from the first call ({again:.3e})")
        report(f"MADConfig.cuda({case})", res.output, int(res.num_cycles[0]),
               float(res.final_residual[0]),
               dict(first_s=first_s, setup_s=setup_s, warm_solve_s=solve_s))
        if ref is None:
            ref = res.output
        del res, hier, warm
    lines = []

    def trace():
        lines.clear()
        return mad_diffusion_verbose(b, tensor, config=MADConfig.cuda(False, **kw),
                                     print_fn=lines.append, device="cuda")[0]

    _, first_s = seconds_of(trace)
    out, second_s = seconds_of(trace)
    cycles = sum(line.startswith("|--- VCycle") for line in lines)
    log(f"  mad_diffusion_verbose: {len(lines)} lines, the first cycle's:")
    for line in lines[:lines.index("|--- VCycle n. 2 ---|") if cycles > 1 else None]:
        log(f"    {line}")
    # the last line, level 0's last smoothing, is the solve's relative residual
    report("mad_diffusion_verbose (mixed_precision=False)", out, cycles,
           float(lines[-1].split("= ")[1]), dict(first_s=first_s, second_s=second_s))
    summary[-1]["trace_lines"] = len(lines)
    del tensor, b, ref, out
    torch.cuda.empty_cache()
    return summary


def all_counters():
    """Every kernel wrapper's launch counter, by the kernels line's names."""
    from multigridanisotropicdiffusion_tpu_torch.ops import (
        cuda_assemble,
        cuda_conv,
        cuda_smoothers,
        cuda_stencil2d,
        cuda_stencil_stored,
        cuda_transfer,
        cuda_vesselness,
    )

    return {
        "stencil_halfsweep": cuda_smoothers.halfsweep,
        "stencil_residual": cuda_smoothers.cuda_residual,
        "restrict3d": cuda_transfer.cuda_restrict,
        "prolong3d": cuda_transfer.cuda_prolong,
        "assemble_compressed": cuda_assemble.cuda_assemble_compressed_dca,
        "conv_z": cuda_conv.conv_z,
        "conv_yx": cuda_conv.conv_yx,
        "fd_vesselness": cuda_vesselness.fd_vesselness,
        "tensor_assembly": cuda_vesselness.tensor_assembly,
        "stencil_stored_halfsweep": cuda_stencil_stored.halfsweep,
        "stencil_stored_residual": cuda_stencil_stored.cuda_residual,
        "stencil_2d_halfsweep": cuda_stencil2d.halfsweep,
        "stencil_2d_residual": cuda_stencil2d.cuda_residual,
        "conv_y": cuda_conv.conv_y,
        "conv_x": cuda_conv.conv_x,
        "fd_hessian": cuda_vesselness.fd_hessian,
    }


def solve_pair(title, b, tensor, kw, expect, dtype=None, max_cycles=100):
    """``mad_diffusion`` with ``MADConfig.cuda(**kw)`` through the kernels,
    then with ``use_kernels=False``, on the same inputs: each call must
    converge to ``kw['tolerance']`` in fewer than ``max_cycles`` cycles; the
    kernel run must launch every kernel in ``expect`` and the plain run
    none; the two must agree within one cycle and 1e-4 relative L2.  Each
    also runs its setup alone and a warm solve on that hierarchy.  Returns
    the kernel run's launch counts and a summary."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy

    shape = tuple(b.shape)
    counters = all_counters()
    outputs, cycles, summary, launches = {}, {}, {"case": title}, None
    for label in ("kernels", "plain"):
        cfg = MADConfig.cuda(use_kernels=label == "kernels", max_cycles=max_cycles, **kw)
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mad_diffusion(b, tensor, config=cfg, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: f.launches for k, f in counters.items() if f.launches}
        if label == "kernels":
            launches = counts
            missing = [k for k in expect if not counts.get(k)]
            if missing:
                fail(f"{title}: kernels not launched on its main path: {missing}")
        elif counts:
            fail(f"{title}: use_kernels=False launched kernels: {counts}")
        n = int(res.num_cycles[0])
        fin = float(res.final_residual[0])
        hist = [f"{v:.3e}" for v in res.residual_history[0, :n].tolist()]
        if tuple(res.output.shape) != shape or not bool(torch.isfinite(res.output).all()):
            fail(f"{title} {label}: output not finite or of the wrong shape")
        if not (fin <= cfg.tolerance and n < max_cycles):
            fail(f"{title} {label}: did not converge (cycles {n}, relres {fin:.3e})")
        outputs[label], cycles[label] = res.output, n
        del res
        # setup alone, then a warm solve on that hierarchy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        planes = as_sym_planes(tensor, shape, dtype=b.dtype if dtype is None else dtype,
                               device="cuda")
        hier = build_hierarchy(planes, build_level_descriptors(shape), cfg.time_step,
                               cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels,
                               cfg.galerkin_variant)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() / 2**30
        planes_per_level = [len(getattr(op, "offsets", ())) or op.planes.shape[0]
                            for op in hier.operators]
        t0 = time.perf_counter()
        res = mad_diffusion(b, tensor, config=cfg, dtype=dtype, device="cuda",
                            hierarchy=hier)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        del res, hier, planes
        torch.cuda.empty_cache()
        summary[label] = dict(first_s=first_s, setup_s=setup_s, warm_solve_s=solve_s,
                              cycles=n, relres=fin, peak_gib=peak,
                              setup_peak_gib=setup_peak)
        log(f"  {title} {label}: first call {first_s:.3f} s, setup {setup_s:.3f} s "
            f"(peak {setup_peak:.1f} GiB), warm solve {solve_s:.3f} s, cycles {n}, "
            f"relres {fin:.3e}, history {hist}, peak device memory {peak:.1f} GiB, "
            f"planes per level {planes_per_level}")
        if label == "kernels":
            log(f"  {title}: launches in the first kernels call: {launches}")
    rel = ((outputs["kernels"].double() - outputs["plain"].double()).norm()
           / outputs["plain"].double().norm()).item()
    summary["rel_l2_vs_plain"] = rel
    log(f"  {title}: kernels vs plain output rel_l2={rel:.3e} (bound 1e-4), cycles "
        f"{cycles['kernels']} vs {cycles['plain']}")
    if not (rel <= 1e-4 and abs(cycles["kernels"] - cycles["plain"]) <= 1):
        fail(f"{title}: the kernel path and the plain path disagree")
    return launches, summary


def phase_galerkin(gen):
    """Galerkin levels at 512^3 on phase 5's inputs: collapsed (the default
    variant), then exact."""
    import torch

    log("== phase 7: Galerkin main path, mad_diffusion at 512^3 to 1e-6 with "
        "MADConfig.cuda(coarse_operator='galerkin')")
    tensor = bench_tensor(SHAPE, gen)
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    kw = dict(time_step=DT, tolerance=1e-6, coarse_operator="galerkin")
    expect = STENCIL_3D + ("stencil_stored_halfsweep", "stencil_stored_residual")
    launches, collapsed = solve_pair("galerkin collapsed 512^3", b, tensor, kw, expect)
    _, exact = solve_pair("galerkin exact 512^3", b, tensor,
                          dict(kw, galerkin_variant="exact"), expect)
    summaries = [collapsed, exact]
    if exact["kernels"]["setup_peak_gib"] > EXACT_PEAK_LIMIT_GIB:
        log(f"  exact setup peak {exact['kernels']['setup_peak_gib']:.1f} GiB passes "
            "60 GB: the exact variant again at 256^3")
        del tensor, b
        torch.cuda.empty_cache()
        shape = (256,) * 3
        tensor = bench_tensor(shape, gen)
        b = torch.rand(shape, generator=gen, device="cuda") * 255.0
        summaries.append(solve_pair("galerkin exact 256^3", b, tensor,
                                    dict(kw, galerkin_variant="exact"), expect)[1])
    del tensor, b
    torch.cuda.empty_cache()
    return launches, summaries


def phase_2d(gen):
    """lena in float64 against its golden, then 8192^2 float32 solves."""
    import numpy as np
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion

    log("== phase 8: 2D main path: lena (float64) and 8192^2 (float32)")
    counters = all_counters()
    g = np.load(LENA)
    img = torch.as_tensor(g["input"], dtype=torch.float64, device="cuda")
    tensor = torch.stack([torch.full_like(img, 50.0), torch.zeros_like(img),
                          torch.full_like(img, 30.0)])
    for f in counters.values():
        f.launches = 0
    res = mad_diffusion(img, tensor, config=MADConfig.cuda(
        mixed_precision=False, time_step=0.1, tolerance=1e-10),
        dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items() if f.launches}
    want = torch.as_tensor(g["output"], dtype=torch.float64, device="cuda")
    rel = ((res.output - want).norm() / want.norm()).item()
    n, fin = int(res.num_cycles[0]), float(res.final_residual[0])
    log(f"  lena {tuple(img.shape)} float64: cycles {n}, relres {fin:.3e}, rel_l2 to "
        f"the golden {rel:.3e} (bound 1e-8), launches {counts}")
    if not (fin <= 1e-10 and rel <= 1e-8 and counts.get("stencil_2d_halfsweep")
            and counts.get("stencil_2d_residual")):
        fail("lena through the 2D kernel is off")
    lena = dict(case="lena float64", cycles=n, relres=fin, rel_l2_golden=rel)
    del res, img, tensor, want
    tensor = bench_tensor(SHAPE_2D, gen)
    b = torch.rand(SHAPE_2D, generator=gen, device="cuda") * 255.0
    kw = dict(time_step=DT, tolerance=1e-6)
    expect = ("stencil_2d_halfsweep", "stencil_2d_residual")
    launches, dca_2d = solve_pair("dca 8192^2", b, tensor, kw, expect)
    _, gal_2d = solve_pair("galerkin collapsed 8192^2", b, tensor,
                           dict(kw, coarse_operator="galerkin"), expect)
    del tensor, b
    torch.cuda.empty_cache()
    return launches, [lena, dca_2d, gal_2d]


#: the solve kernels' work per 512^3 float32 call: planes moved (each read or
#: written once, in units of the 512^3 volume) and float operations per fine
#: cell, counted from their sources
SOLVE_WORK = {
    "stencil_halfsweep": (13, 29),
    "stencil_residual": (13, 30),
    "restrict3d": (1 + 1 / 8, 21),
    "prolong3d": (1 / 8 + 1, 22),
    "assemble_compressed": (16, 60),
}


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
    t_start = time.perf_counter()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs, timings, work = phase_kernels(gen)
    phase_reference(gen)
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches = phase_main(gen)
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches.update({k: n for k, n in phase_ved(gen).items()
                     if k not in launches})
    gen = torch.Generator(device="cuda").manual_seed(0)
    gal_launches, solves = phase_galerkin(gen)
    launches.update({k: n for k, n in gal_launches.items() if k.startswith("stencil_stored")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches_2d, solves_2d = phase_2d(gen)
    launches.update({k: n for k, n in launches_2d.items() if k.startswith("stencil_2d")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches.update({k: n for k, n in phase_ved_gd(gen).items()
                     if k in ("conv_y", "conv_x", "fd_hessian")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel_less = phase_kernel_less(gen)
    log(f"phases 2-10 took {time.perf_counter() - t_start:.1f} s")

    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    rows = []
    for name, (source, replaces, case, *tag) in KERNELS.items():
        tag = tag[0] if tag else "512^3"
        shape, dtype = list(SHAPE), "float32"
        if name in SOLVE_WORK:
            ms, plain_ms = timings[(case, tag)]
            lib_ms = None  # no single PyTorch call computes these functions
            planes, ops = SOLVE_WORK[name]
            nbytes, nops = planes * cells * 4, ops * cells
        elif name in EXTRA_CASES:
            (ms, plain_ms), lib_ms = timings[(case, tag)], None
            nbytes, nops, shape, dtype = work[(case, tag)]
        else:
            ms, plain_ms, lib_ms = timings[(case, tag)]
            nbytes, nops = work[(case, tag)]
        b_ms, b_by = bound_ms(nbytes, nops)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[(case, tag)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "shape": list(shape), "dtype": dtype, "case": tag,
        }
        if name == "fd_vesselness":
            first = "fd_vesselness first f32"
            row["first_ms"], row["first_plain_ms"], _ = timings[(first, "512^3")]
            row["first_bound_ms"] = bound_ms(*work[(first, "512^3")])[0]
        for extra in EXTRA_CASES.get(name, ()):
            e_ms, e_plain = timings[(case, extra)]
            e_bytes, e_ops, e_shape, _ = work[(case, extra)]
            row.setdefault("other_cases", []).append({
                "case": extra, "shape": list(e_shape), "ms": e_ms, "plain_ms": e_plain,
                "bound_ms": bound_ms(e_bytes, e_ops)[0],
                "max_abs_err": errs[(case, extra)]})
        rows.append(row)
    print(json.dumps({"solves": solves + solves_2d + kernel_less}))
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
