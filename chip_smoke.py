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
   variants; B15 in its first and select variants on the phantom's
   gaussian_derivative Hessian stacks (sigma 1.245, then 2) at 512^3 and at
   the main path's 64-plane slab, float32 and bfloat16, held to its plain
   version's bits (response and best Hessian), and on (37, 45, 51).  Median times by CUDA events (a call under 2 ms is timed in
   bursts of 10 back-to-back calls, so the wrappers' host time overlaps the
   card's work), beside the library call that
   computes the same function where there is one: on the all-cell levels
   ``F.interpolate(mode="trilinear", align_corners=False)`` for the
   prolongation and replicate padding plus a stride-2 ``F.conv3d`` with the
   ``[1, 3, 3, 1] / 8`` product kernel for the restriction (each checked
   against the plain version in float32; cuDNN's TF32 off).  The
   stencil kernel B1/B2 and the fused sweep B17 are held to their plain
   versions' bytes at every level, in float32, bfloat16 and (checked, not
   timed) float64, B17 timed beside the two half-sweep launches it
   replaces; the
   restriction bit for bit to its plain version (the single volume
   and the batch of six tensor planes), and the prolongation's add form
   ``x + P e`` bit for bit to ``x + cuda_prolong(e)``, timed beside those
   two launches;
4. reference: a small float64 solve through the kernels against a dense
   direct solve, and the float32 + bf16 path on the same input;
5. MAD main path: ``mad_diffusion`` at 512^3 with ``MADConfig.cuda()`` to a
   relative residual of 1e-6, with the solve kernels' launch counts read
   from that run (every sweep of the compressed operator one B17 launch:
   ``stencil_sweep`` counts them, ``stencil_halfsweep`` reads 0 on the main
   paths); then the same inputs with ``use_kernels=False``, which must agree
   to 1e-4 relative L2;
6. VED main path: ``ved(vol, config=VEDConfig.cuda(), device="cuda")`` on a
   512^3 float32 tube phantom (5 scales, 8 z slabs, 5 diffusion steps), with
   all nine kernels' launch counts read from that run; every step must
   converge, the vesselness at a tube centre must exceed 0.1 with the
   tensor's principal axis along the tube, and ``use_kernels=False`` must
   agree to 1e-4 relative L2;
7. Galerkin main path: ``mad_diffusion`` on phase 5's 512^3 inputs with
   ``MADConfig.cuda(coarse_operator='galerkin')`` (collapsed levels, the
   stored-operator kernel B12 from level 1 down), then
   ``galerkin_variant='exact'`` (radius-2 levels; the Galerkin product
   B16 on every coarse level of both, counted under each call's own variant
   in ``cuda_galerkin_product.launches`` and, per level, under its form in
   ``cuda_galerkin_product.forms``: exact19 x1, exact117 x1 and exact125 x4
   in the exact call, compressed19 and stored27 alone in the collapsed one;
   at 256^3 if the 512^3
   setup's peak device memory passes 60 GB), each to 1e-6 in < 100 cycles,
   each with ``use_kernels=False`` (within one cycle, 1e-4 relative L2);
8. 2D main path: lena from ``tests/goldens/lena_gs_v.npz`` in float64
   through the 2D kernel B13 (relative residual 1e-10, within 1e-8 relative
   L2 of the golden), then a seeded 8192^2 float32 solve under
   ``MADConfig.cuda()`` with the compressed DCA operator and with collapsed
   Galerkin levels, each against ``use_kernels=False``;
9. reference-faithful VED: phase 6's 512^3 phantom through
   ``VEDMultigridImageFilter(device="cuda").set_config(VEDConfig.cuda(
   hessian_mode="gaussian_derivative"))`` (B6 and B10 in every Hessian, B15
   on it, B9 once a slab), with the conv_z / conv_y / conv_x /
   hessian_vesselness / tensor_assembly launch counts read from that run
   (120 / 240 / 240 / 40 / 8), the phase-6 convergence and tube checks, and the same filter with
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
   second call, setup included;
11. distributed main path, gloo ranks spawned after phase 2 built the
   kernels and sharing cuda:0 (faces staged through the host: these numbers
   measure correctness and overheads, not NVLink scaling).  On 2 ranks, mesh
   (2, 1, 1): one B14 red-black sweep and residual on the 512^3 compressed
   operator against B1/B2 on the whole volume (1e-5 of max|ref|); phase 5's
   construction at 256^3 with ``use_kernels=False`` in both halo modes
   (``'shard_map'`` and ``'overlap'``), whose outputs must be
   ``torch.equal``, both warm times printed; phase 5's 512^3
   ``mad_diffusion`` with ``MADConfig.cuda()``; phase 6's 512^3
   ``ved(VEDConfig.cuda())``.  On 8 ranks, mesh (2, 2, 2): the (254, 256,
   256) solve (every axis split, odd-origin blocks, a padded level 1), with
   the compressed DCA operator and with collapsed Galerkin levels (B14's
   stored form).  Each run against the single-device kernel run on rank 0:
   rel L2 <= 1e-4, cycles within one, every step at relres <= 1e-6, VED's
   tube checks; B14 launched on every rank; each rank's first-call and warm
   seconds and peak device memory on its own line.

Phase 3 holds B6 and B10 to their plain versions' bytes (an integer view,
signed zeros included): beside the cases above, every form of the two on a
(37, 45, 51) phantom in float32 and bfloat16 (the five VED scales' g, g1
and g2 taps, which take the compiled radii 2, 4, 5 and 8, and the generic
form: r = 9, an interior zero; B6 in valid mode over the taps zero-padded
to radius 8, as the z-slab pipelines pass them, and in edge mode), B6 at the
main path's slab (82 -> 66 planes of 512^2, sigma 0.3's padded taps,
timed), and a field of -0.0, which every pass must keep.

Phase 3 also holds B14, the shard-local stencil kernel (compressed:
``halfsweep_local``/``cuda_residual_local`` on random planes non-zero on
every border, one rank's (256, 512, 512) block of the 512^3 level and a
(37, 45, 51) block, with ``torch.equal``; stored, through B12's kernel, on a (128, 256, 256) block
of the 512^3 collapsed level 1), B10 (``conv_y``, ``conv_x``: 512^3 float32 and bfloat16,
(37, 45, 51), and r = 64 on (12, 150, 150)) and B11 (``fd_hessian``: the
valid-z smoothed 512^3 field of 514 planes, float32 and bfloat16, and
(39, 45, 51)) against their plain versions, and B12 and B13: B12 on the
512^3 19-plane stored DCA operator, on level 1 (256^3) of the 512^3
collapsed and exact Galerkin hierarchies, that exact level pruned at 1e-3,
level 2 (128^3, 125 planes) of the exact hierarchy, and on every level of
(69, 77, 69) vertex-centred Galerkin hierarchies; B13 on 8192^2 compressed
and stored operators and on a (1531, 997) grid.  B12 and B13's stored
form are held to their plain versions' bytes, the shard-local stored form
with ``torch.equal``.

Phase 3 ends with B16, the Galerkin product: levels 1 and 2 of the 512^3
collapsed chain (the compressed level-0 operator -> 256^3, that level's 27
planes -> 128^3) and of the exact chain (-> 256^3 in 117 planes, those ->
128^3 in 125 planes; the compiled-in forms exact19 and exact117, which
``galerkin512-exact`` runs), and that 256^3 exact level pruned at 1e-3 ->
128^3 (the generic form, which pruned, odd-sized and vertex-centred exact
levels take), against the eager path on the same planes, within 1e-6 of
the largest diagonal value, all five timed, each failing unless it took
its form.
The line before the last is ``{"kernels": [...]}``, 23 rows (name, route, source, the
TPU kernel it replaces, launches in its main-path run, max abs error, kernel,
plain and library milliseconds, and the bound: the larger of the bytes the
function must move over 3.35 TB/s and its float operations over 67 TFLOP/s,
float32 at the shape in the row; ``conv_z`` also gives the main path's 82 ->
66 plane slab as ``slab``, whose bytes count the 70 input planes that
sigma 0.3's non-zero taps reach and whose library call is one
``F.conv3d``; ``hessian_vesselness`` (B15, which replaces no TPU kernel:
"none: XLA") gives its first scale as ``first_ms`` and its four cases on
a 64-plane slab, first and select in float32 and bfloat16, as ``slab``;
``stencil_sweep`` (B17) gives the two half-sweep launches it replaces as
``pair_ms``, its bound one pass of the half-sweeps' bytes);
the last line is ``{"ok": true, "device":
{...}}``.

Tolerances: B1/B2, B17, B3 (the restriction), the prolongation's add form, B6,
B10, B12, B13's stored form and B15 bit for bit, B14 with ``torch.equal``; otherwise float32 max |kernel - plain| <= 1e-5 max |plain| (the
sums may run in another order); bfloat16 |kernel - plain| <= one bf16 ulp of each plain
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
#: calls per CUDA-event timing of a call shorter than BURST_BELOW_MS
BURST = 10
BURST_BELOW_MS = 2.0
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PARAMS = (0.5, 0.5, 5.0)  # VEDConfig's alpha, beta, gamma
SCALES = (0.3, 0.482, 0.775, 1.245, 2.0)  # VEDConfig's scales
TENSOR_PARAMS = (0.01, 5.0, 10.0)  # epsilon, omega, sensitivity
#: float operations per output voxel, counted from the kernels' sources
#: (every add, multiply, compare-select and math-library call as one)
OPS_TENSOR_ASSEMBLY = 265
OPS_FD_HESSIAN = 24
#: float operations of one standalone call of each math-library function
#: that B8's formulas make, from its SASS (``utils/sass_count.py --math``,
#: sm_90a: the call's body, a fused multiply-add as two; cosf's includes its
#: inline reduction of large arguments)
MATH_OPS = {"expf": 11, "acosf": 33, "cosf": 29, "sqrtf": 6, "rcp": 5, "div": 11}
#: B8's float operations as its plain formulas need them, every add,
#: multiply, abs and compare-select as one: per voxel the FD stencil (24),
#: the eigenvalues (74, two reciprocals, two sqrtf, acosf, cosf), their
#: scaling, sort and bright test (14); per bright voxel the vesselness (23,
#: two reciprocals, four expf, three divisions); a select adds one compare
OPS_FD_EIGEN = (112 + 2 * MATH_OPS["rcp"] + 2 * MATH_OPS["sqrtf"] + MATH_OPS["acosf"]
                + MATH_OPS["cosf"])
OPS_VESSELNESS = 23 + 2 * MATH_OPS["rcp"] + 4 * MATH_OPS["expf"] + 3 * MATH_OPS["div"]
#: B15's: B8's without the FD stencil (24 per voxel), and with a product by
#: a reciprocal for each of the vesselness's three divisions
OPS_HV_EIGEN = OPS_FD_EIGEN - 24
OPS_HV_VESSELNESS = OPS_VESSELNESS - 3 * MATH_OPS["div"] + 3
#: phase 9's expected launches: 8 z slabs x 5 scales x (3 z, 6 y, 6 x; B15),
#: 8 z slabs x B9
GD_LAUNCHES = {"conv_z": 120, "conv_y": 240, "conv_x": 240, "hessian_vesselness": 40,
               "tensor_assembly": 8}
#: B16's phase-3 cases: levels 1 and 2 of the 512^3 collapsed and exact
#: chains, and the exact level 1 pruned at GALERKIN_PRUNE_TOL -> 128^3, each
#: tag with whether its product is collapsed and the form it must take
GALERKIN_LEVELS = {"512^3 -> 256^3 collapsed": (True, "compressed19"),
                   "256^3 -> 128^3 collapsed": (True, "stored27"),
                   "512^3 -> 256^3 exact": (False, "exact19"),
                   "256^3 exact pruned -> 128^3": (False, "generic"),
                   "256^3 -> 128^3 exact": (False, "exact117")}
#: the pruning of the generic-form case (``galerkin_prune_tol``), as B12's
#: "256^3 exact pruned" case
GALERKIN_PRUNE_TOL = 1e-3
#: B16's float32 tolerance, of the largest diagonal value
GALERKIN_TOL = 1e-6
#: B16's launches by form in one 512^3 Galerkin call, per variant: the exact
#: chain's three compiled-in forms (the compressed operator -> 117 planes,
#: 117 -> 125, then 125 -> 125), the collapsed chain's two
GALERKIN_FORMS_512 = {"exact": {"exact19": 1, "exact117": 1, "exact125": 4},
                      "collapsed": {"compressed19": 1, "stored27": 5}}
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
    "stencil_sweep": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stencil_sweep f32",
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
    "hessian_vesselness": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/vesselness.cu",
        "none: XLA",
        "hessian_vesselness select f32",
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
    "stencil_halfsweep_local": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "local_halfsweep0 f32", "256x512^2 block",
    ),
    "stencil_residual_local": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_compressed.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "local_residual f32", "256x512^2 block",
    ),
    "stencil_stored_halfsweep_local": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_stored.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stored_local_halfsweep0 f32", "256^3 collapsed block",
    ),
    "stencil_stored_residual_local": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/stencil_stored.cu",
        "multigridanisotropicdiffusion_tpu/ops/pallas_smoothers.py:386",
        "stored_local_residual f32", "256^3 collapsed block",
    ),
    "galerkin_product": (
        "multigridanisotropicdiffusion_tpu_torch/csrc/galerkin_product.cu",
        "none: XLA",
        "galerkin_product f32", next(iter(GALERKIN_LEVELS)),
    ),
}
#: the kernels of the 3D compressed solve and of the VED call: each sweep
#: of the compressed operator is one B17 launch
STENCIL_3D = ("stencil_sweep", "stencil_residual", "restrict3d", "prolong3d",
              "assemble_compressed")
VED_KERNELS = STENCIL_3D + ("conv_z", "conv_yx", "fd_vesselness", "tensor_assembly")
#: the kernels of the gaussian_derivative VED call
GD_KERNELS = STENCIL_3D + ("conv_z", "conv_y", "conv_x", "hessian_vesselness",
                           "tensor_assembly")
#: B12/B13 cases reported beside the row's own (phase-3 tags)
EXTRA_CASES = {
    "stencil_stored_halfsweep": ("512^3 stored DCA", "256^3 exact", "128^3 exact",
                                 "256^3 exact pruned"),
    "stencil_stored_residual": ("512^3 stored DCA", "256^3 exact", "128^3 exact",
                                "256^3 exact pruned"),
    "stencil_2d_halfsweep": ("8192^2 stored",),
    "stencil_2d_residual": ("8192^2 stored",),
    "stencil_halfsweep_local": (),
    "stencil_residual_local": (),
    "stencil_stored_halfsweep_local": (),
    "stencil_stored_residual_local": (),
    "galerkin_product": tuple(GALERKIN_LEVELS)[1:],
}
#: the shard-local kernel B14 (compressed, and stored through B12)
LOCAL_KERNELS = ("stencil_halfsweep_local", "stencil_residual_local",
                 "stencil_stored_halfsweep_local", "stencil_stored_residual_local")


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


def check_bits(name, got, want, quiet=False):
    """Hold a kernel's output to its plain version's bytes (signed zeros
    included), as integers; returns max abs err (0).  ``quiet``: log only a
    failure."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
    differ = int((got.contiguous().view(ints) != want.contiguous().view(ints)).sum())
    if differ or not quiet:
        log(f"  {name}: {differ} of {got.numel()} values differ in their bits, tol=bitwise "
            f"{'ok' if differ == 0 else 'FAILED'}")
    if differ:
        fail(f"{name} is not bit for bit its plain version")
    return 0.0


def check_equal(name, got, want):
    """Hold a kernel's output to its plain version with ``torch.equal``
    (equal values; an exact zero may differ in sign); returns max abs err
    (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    ok = bool(torch.equal(got, want))
    log(f"  {name}: torch.equal={ok} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} does not equal its plain version")
    return 0.0


def median_ms(fn, reps, setup=None):
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up call.
    A call that takes less than BURST_BELOW_MS is timed BURST times back to
    back and divided, so that the host's time between two launches (the
    wrapper's Python) does not count while the card is busy; such calls
    first run one untimed round of ``reps`` bursts, since right after a
    kernel's check its first round can read slower than every later one
    (``conv_y`` at 512^3 in float32).  ``setup`` runs before each call,
    outside the timed window, one call per timing."""
    import torch

    if setup:
        setup()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    burst = 1 if setup or start.elapsed_time(end) >= BURST_BELOW_MS else BURST
    if burst > 1:
        for _ in range(reps * burst):
            fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def bound_ms(nbytes, ops):
    """The least time for the work: bytes over the memory rate or float
    operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    lines = (build.BUILD_DIR / "build.log").read_text().splitlines()
    regs = [ln.strip() for ln in lines if "registers" in ln]
    spills = [ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    log(f"ptxas: {len(regs)} kernels; " + "; ".join(sorted(set(regs))))
    log(f"ptxas: {len(spills)} kernels spill" + "".join(f"; {ln}" for ln in spills))


def check_level(tag, shape, spacing, next_centering, gen, errs, timings):
    """All kernels at one level: assembly (f32), stencil (f32, bf16) and,
    with ``next_centering``, the transfers to and from the next level.
    Records ``errs[(case, tag)]`` and ``timings[(case, tag)]`` (kernel ms,
    plain ms)."""
    import torch
    import torch.nn.functional as F

    from multigridanisotropicdiffusion_tpu_torch.core.grids import CELL
    from multigridanisotropicdiffusion_tpu_torch.ops import (
        compressed,
        cuda_assemble,
        cuda_smoothers,
        cuda_transfer,
        transfer,
    )
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    def timed(name, kernel, plain, library=None, compare=check):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        errs[(name, tag)] = compare(f"{name} {tag}", got, want)
        if library is not None and want.dtype == torch.float32:
            check(f"{name} {tag} library form", library(), want)
        del got, want
        ms = timings[(name, tag)] = (median_ms(kernel, 10), median_ms(plain, 3),
                                     median_ms(library, 10) if library else None)
        log(f"    {name} {tag}: kernel {ms[0]:.3f} ms, plain {ms[1]:.3f} ms, library "
            f"{'none' if ms[2] is None else f'{ms[2]:.3f} ms'}")

    t = spd_tensor_field(shape, gen)
    timed("assemble_compressed f32",
          lambda: cuda_assemble.cuda_assemble_compressed_dca(t, spacing, DT).planes,
          lambda: compressed.assemble_compressed_dca(t, spacing, DT).planes)
    op32 = compressed.assemble_compressed_dca(t, spacing, DT)
    x32 = torch.randn(shape, generator=gen, device="cuda") * 10.0
    b32 = torch.rand(shape, generator=gen, device="cuda") * 255.0
    # B1/B2 round as their plain versions do: their bytes in every dtype
    # (float64 checked, not timed: no solve stores it)
    op, x, b = op32.astype(torch.float64), x32.double(), b32.double()
    for color in (0, 1):
        check_bits(f"stencil_halfsweep{color} f64 {tag}",
                   cuda_smoothers.halfsweep(op, x, b, color),
                   cuda_smoothers.halfsweep_plain(op, x, b, color))
    check_bits(f"stencil_residual f64 {tag}", cuda_smoothers.cuda_residual(op, x, b),
               cuda_smoothers.residual_plain(op, x, b))
    check_bits(f"stencil_sweep f64 {tag}", cuda_smoothers.rbgs_sweep(op, x, b),
               cuda_smoothers.rbgs_sweep_plain(op, x, b))
    del op, x, b
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        op, x, b = op32.astype(dtype), x32.to(dtype), b32.to(dtype)
        for color in (0, 1):
            timed(f"stencil_halfsweep{color} {suffix}",
                  lambda: cuda_smoothers.halfsweep(op, x, b, color),
                  lambda: cuda_smoothers.halfsweep_plain(op, x, b, color), compare=check_bits)
        timed(f"stencil_residual {suffix}",
              lambda: cuda_smoothers.cuda_residual(op, x, b),
              lambda: cuda_smoothers.residual_plain(op, x, b), compare=check_bits)
        # B17, the fused sweep, beside the two half-sweep launches it
        # replaces (timed in the library slot), whose bytes it gives
        check_bits(f"stencil_sweep {suffix} {tag} vs two half-sweeps",
                   cuda_smoothers.rbgs_sweep(op, x, b),
                   cuda_smoothers.halfsweep(op, cuda_smoothers.halfsweep(op, x, b, 0), b, 1))
        timed(f"stencil_sweep {suffix}",
              lambda: cuda_smoothers.rbgs_sweep(op, x, b),
              lambda: cuda_smoothers.rbgs_sweep_plain(op, x, b),
              lambda: cuda_smoothers.halfsweep(op, cuda_smoothers.halfsweep(op, x, b, 0), b, 1),
              compare=check_bits)
        if next_centering is not None:
            cent = next_centering
            e = transfer.restrict_plain(x, cent)
            # the library forms compute these functions on all-cell levels
            # only (tests/test_torch_transfer.py), so they are timed there
            all_cell = set(cent) == {CELL}
            w1 = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda", dtype=dtype) / 8
            w_fw = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])[None, None]
            # the restriction rounds as its plain version does: bit for bit
            if not torch.equal(cuda_transfer.cuda_restrict(x, cent),
                               transfer.restrict_plain(x, cent)):
                fail(f"restrict3d {suffix} {tag} is not restrict_plain bit for bit")
            timed(f"restrict3d {suffix}",
                  lambda: cuda_transfer.cuda_restrict(x, cent),
                  lambda: transfer.restrict_plain(x, cent),
                  (lambda: F.conv3d(F.pad(x[None, None], (1,) * 6, mode="replicate"),
                                    w_fw, stride=2)[0, 0]) if all_cell else None)
            timed(f"prolong3d {suffix}",
                  lambda: cuda_transfer.cuda_prolong(e, cent),
                  lambda: transfer.prolong_plain(e, cent),
                  (lambda: F.interpolate(e[None, None], scale_factor=2, mode="trilinear",
                                         align_corners=False)[0, 0]) if all_cell else None)
            # the add form (x + P e, the V-cycle's correction): bit for bit
            # the two launches it replaces, which are timed beside it
            pair = x + cuda_transfer.cuda_prolong(e, cent)
            if not torch.equal(cuda_transfer.cuda_prolong_add(x, e, cent), pair):
                fail(f"prolong_add {suffix} {tag} is not x + cuda_prolong(e) bit for bit")
            del pair
            timed(f"prolong_add3d {suffix}",
                  lambda: cuda_transfer.cuda_prolong_add(x, e, cent),
                  lambda: transfer.prolong_add_plain(x, e, cent),
                  lambda: x + cuda_transfer.cuda_prolong(e, cent))
            if not torch.equal(cuda_transfer.cuda_restrict(t.to(dtype), cent),
                               transfer.restrict_plain(t.to(dtype), cent)):
                fail(f"restrict3d batch6 {suffix} {tag} is not restrict_plain bit for bit")
            if dtype == torch.float32:
                timed("restrict3d batch6 f32",
                      lambda: cuda_transfer.cuda_restrict(t, cent),
                      lambda: transfer.restrict_plain(t, cent))
            del e
        del op, x, b
    del t, op32, x32, b32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_stencil(prefix, tag, op32, gen, errs, timings, work, timed_runs, local=False):
    """B12 or B13 on one float32 operator, through ``ops.cuda_smoothers``:
    both half-sweeps and the residual in float32 and bfloat16 against the
    plain versions, a stored operator's bit for bit (B12, B13 stored), a 2D
    compressed operator's within the tolerances.  With ``local``, the
    shard-local form B14 (``halfsweep_local``, ``cuda_residual_local``; of
    the compressed operator or a stored one), held with ``torch.equal``.
    With ``timed_runs``: CUDA-event medians and each call's work, (K + 3)
    values per cell and 2 K float operations."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers as cs

    shape = op32.shape
    planes = op32.planes if hasattr(op32, "planes") else op32.coeffs
    k = planes.shape[0]
    cells = math.prod(shape)
    x32 = torch.randn(shape, generator=gen, device="cuda") * 10.0
    b32 = torch.rand(shape, generator=gen, device="cuda") * 255.0
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        op, x, b = op32.astype(dtype), x32.to(dtype), b32.to(dtype)
        sfx = "_local" if local else ""
        sweep, sweep_plain = (getattr(cs, f"halfsweep{sfx}"),
                              getattr(cs, f"halfsweep{sfx}_plain"))
        resid, resid_plain = (getattr(cs, f"cuda_residual{sfx}"),
                              getattr(cs, f"residual{sfx}_plain"))
        cases = [(f"{prefix}_halfsweep{c} {suffix}",
                  lambda c=c: sweep(op, x, b, c),
                  lambda c=c: sweep_plain(op, x, b, c)) for c in (0, 1)]
        cases.append((f"{prefix}_residual {suffix}",
                      lambda: resid(op, x, b),
                      lambda: resid_plain(op, x, b)))
        stored = hasattr(op32, "offsets")
        compare = check_equal if local else check_bits if stored else check
        for name, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs[(name, tag)] = compare(f"{name} {tag} (K={k})", got, want)
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
    from multigridanisotropicdiffusion_tpu_torch.ops import compressed, dca, galerkin
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("  stored-operator kernel (B12)")
    t = spd_tensor_field(SHAPE, gen)
    stored = dca.assemble_dca(t, (1.0,) * 3, DT)
    check_stencil("stored", "512^3 stored DCA", stored, gen, errs, timings, work, True)
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
    check_stencil("stored", "256^3 collapsed", collapsed, gen, errs, timings, work, True)
    # B14 stored (the B12 kernel): one rank's block of a (2, 1, 1) mesh
    block = StencilOperator(collapsed.coeffs[:, :128].contiguous(), collapsed.offsets)
    log("  shard-local stored form (B14 through B12) on a block of the 256^3 collapsed level")
    check_stencil("stored_local", "256^3 collapsed block", block, gen, errs, timings, work,
                  True, local=True)
    del collapsed, block
    check_stencil("stored", "256^3 exact", exact, gen, errs, timings, work, True)
    # a pruned level (the generic loop), and the exact hierarchy's level 2
    # (128^3, 125 planes)
    check_stencil("stored", "256^3 exact pruned", galerkin.prune_stored_operator(exact, 1e-3),
                  gen, errs, timings, work, True)
    level2 = galerkin.assemble_galerkin_parabolic(exact, (CELL,) * 3)
    del exact
    torch.cuda.empty_cache()
    check_stencil("stored", "128^3 exact", level2, gen, errs, timings, work, True)
    del level2
    torch.cuda.empty_cache()
    shape = (69, 77, 69)
    t = spd_tensor_field(shape, gen)
    for variant in ("collapsed", "exact"):
        hier = build_hierarchy(t, build_level_descriptors(shape), DT, "galerkin",
                               "compressed", galerkin_variant=variant)
        for op in hier.operators:
            if isinstance(op, StencilOperator):
                check_stencil("stored", f"{op.shape} {variant}", op, gen, errs, timings,
                              work, False)
    del t, hier
    log("  2D kernel (B13)")
    t = spd_tensor_field(SHAPE_2D, gen)
    for form, assemble in (("compressed", compressed.assemble_compressed_dca),
                           ("stored", dca.assemble_dca)):
        check_stencil("2d", f"8192^2 {form}", assemble(t, (1.0, 1.0), DT), gen, errs,
                      timings, work, True)
    del t
    t = spd_tensor_field((1531, 997), gen)
    for form, assemble in (("compressed", compressed.assemble_compressed_dca),
                           ("stored", dca.assemble_dca)):
        check_stencil("2d", f"(1531, 997) {form}", assemble(t, (1.0, 0.7), DT), gen, errs,
                      timings, work, False)
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
    from multigridanisotropicdiffusion_tpu_torch.ops.eigen3 import eigvalsh3, sort_by_abs3
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import (
        fd_factors,
        fd_planes,
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
    errs[key("conv_z")] = check_bits(f"conv_z {suffix} {tag}", cuda_conv.conv_z(u_pad, gz, True),
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
    errs[key("conv_edge")] = check_bits(f"conv_z edge {suffix} {tag}", cuda_conv.conv_z(u, gz),
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

    def bright(us, facs):
        """Voxels whose two largest-magnitude eigenvalues are negative: those
        whose vesselness B8 computes (the others' response is 0)."""
        lam = sort_by_abs3(eigvalsh3(fd_planes(us, facs)))
        return int(((lam[1] < 0) & (lam[2] < 0)).sum())

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
    bright1 = bright(us1, f1) if timed_runs else 0
    work[key("fd_vesselness first")] = (us1.numel() * item + n * (resp_item + 6 * item),
                                          OPS_FD_EIGEN * n + OPS_VESSELNESS * bright1)
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
    bright2 = bright(us2, f2) if timed_runs else 0
    work[key("fd_vesselness select")] = (
        us2.numel() * item + n * resp_item + winners * (resp_item + 6 * item),
        (OPS_FD_EIGEN + 1) * n + OPS_VESSELNESS * bright2)
    if timed_runs:
        log(f"    fd_vesselness select {suffix} {tag}: {winners} of {n} voxels win; "
            f"bright: {bright1} of {n} (first scale), {bright2} (select scale)")
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


#: phase 3's tag of B15's cases on one z slab of the 512^3 VED call
HV_SLAB = "64-plane slab"


def check_hv_kernels(tag, u, spacing, errs, timings, work, timed_runs):
    """B15 on the gaussian_derivative Hessian stacks of one volume ``u``
    (storage dtype, B6/B10 as the main path computes them): first scale
    (sigma 1.245) and select (sigma 2, into the first scale's best), each
    held to ``hessian_vesselness_plain``'s bits, response and best Hessian;
    with ``timed_runs`` also on the stacks' first 64 planes (one z slab of
    the main path, tagged HV_SLAB), with CUDA-event medians and the bytes
    and operations of each call."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.models.ved import vesselness_measure
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_vesselness
    from multigridanisotropicdiffusion_tpu_torch.ops.eigen3 import eigvalsh3, sort_by_abs3
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import hessian

    def hv(h, best=None):
        # measure_fn is what the wrapper runs on a CPU tensor; the kernel has
        # the formula compiled in
        return cuda_vesselness.hessian_vesselness(h, PARAMS, best,
                                                  measure_fn=vesselness_measure)

    def plain(h, best=None):
        return cuda_vesselness.hessian_vesselness_plain(h, PARAMS, best, vesselness_measure)

    def bright(h):
        """Voxels whose two largest-magnitude eigenvalues are negative: those
        whose vesselness B15 computes."""
        lam = sort_by_abs3(eigvalsh3(h.float()))
        return int(((lam[1] < 0) & (lam[2] < 0)).sum())

    h1, h2 = (hessian(u, s, spacing, mode="gaussian_derivative", use_kernels=True)
              for s in (1.245, 2.0))
    item = u.element_size()
    resp_item = 4  # the response is float32 for float32 and bf16 storage
    for planes, case_tag in ((None, tag),) + (((64, HV_SLAB),) if timed_runs else ()):
        a, b = (h1, h2) if planes is None else (h1[:, :planes].clone(),
                                                 h2[:, :planes].clone())
        suffix, key, record = recorder(case_tag, u, timings, timed_runs)
        n = a[0].numel()
        first = hv(a.clone())
        want = plain(a)
        errs[key("hessian_vesselness first")] = max(
            check_bits(f"hessian_vesselness first {suffix} {case_tag} resp", first[0], want[0]),
            check_bits(f"hessian_vesselness first {suffix} {case_tag} h", first[1], want[1]))
        record("hessian_vesselness first", lambda: hv(a), lambda: plain(a))
        bright1 = bright(a) if timed_runs else 0
        work[key("hessian_vesselness first")] = (n * (6 * item + resp_item),
                                                 OPS_HV_EIGEN * n + OPS_HV_VESSELNESS * bright1)
        incoming = (first[0].clone(), first[1].clone())
        want = plain(b, incoming)
        got = hv(b, first)
        errs[key("hessian_vesselness select")] = max(
            check_bits(f"hessian_vesselness select {suffix} {case_tag} resp", got[0], want[0]),
            check_bits(f"hessian_vesselness select {suffix} {case_tag} h", got[1], want[1]))
        if got[0].data_ptr() != first[0].data_ptr() or got[1].data_ptr() != first[1].data_ptr():
            fail(f"hessian_vesselness select {suffix} {case_tag} did not update its best in place")
        winners = int((want[0] > incoming[0]).sum())
        del got, want

        def restore():
            first[0].copy_(incoming[0])
            first[1].copy_(incoming[1])

        record("hessian_vesselness select", lambda: hv(b, first), lambda: plain(b, incoming),
               setup=restore)
        # in place: read h and the best response, write the winners' 7 values
        bright2 = bright(b) if timed_runs else 0
        work[key("hessian_vesselness select")] = (
            n * (6 * item + resp_item) + winners * (resp_item + 6 * item),
            (OPS_HV_EIGEN + 1) * n + OPS_HV_VESSELNESS * bright2)
        if timed_runs:
            log(f"    hessian_vesselness select {suffix} {case_tag}: {winners} of {n} voxels "
                f"win; bright: {bright1} of {n} (first scale), {bright2} (select scale)")
        del a, b, first, incoming
    del h1, h2
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
        errs[key(name)] = check_bits(f"{name} {suffix} {tag} (r={r})",
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


def check_axis_forms(gen, errs, timings, work):
    """B6 and B10 bit for bit in every form, float32 and bfloat16, on a
    (37, 45, 51) phantom: the five VED scales' g, g1 and g2 taps (the compiled
    radii 2, 4, 5 and 8) and the generic form (sigma 2 at spacing 0.9: r = 9;
    sigma 1.245's taps with an interior zero); B6 in valid mode over the
    taps zero-padded to radius 8, as the z-slab pipelines pass them, and in
    edge mode; B10 along y and x.  Then B6 at the main path's slab, 82 -> 66
    planes of 512^2 with sigma 0.3's padded taps (timed), and a field of
    -0.0 through every pass (every output -0)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv
    from multigridanisotropicdiffusion_tpu_torch.ops.hessian import gaussian_kernels_1d
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_phantom

    forms = [(f"sigma {s}", gaussian_kernels_1d(s, 1.0)) for s in SCALES]
    forms.append(("r=9", gaussian_kernels_1d(2.0, 0.9)))
    hole = [k.copy() for k in gaussian_kernels_1d(1.245, 1.0)]
    for k in hole:
        k[2] = 0.0
    forms.append(("interior zero", hole))
    small = tube_phantom((37, 45, 51), gen)
    slab = tube_phantom((82, 512, 512), gen)
    g = gaussian_kernels_1d(0.3, 1.0)[0]
    g_slab = np.pad(g, 8 - (len(g) - 1) // 2)
    slab_plan = cuda_conv.axis_plan(g_slab)
    for dtype in (torch.float32, torch.bfloat16):
        u = small.to(dtype)
        suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        n = 0
        for name, kernels in forms:
            for o, taps in enumerate(kernels):
                r = (len(taps) - 1) // 2
                padded = np.pad(taps, max(r, 8) - r)
                up = cuda_conv.edge_pad(u, max(r, 8)).contiguous()
                plan = cuda_conv.axis_plan(taps).radius
                for what, got, want in (
                        ("conv_z valid", cuda_conv.conv_z(up, padded, True),
                         cuda_conv.conv_z_plain(up, padded, True)),
                        ("conv_z edge", cuda_conv.conv_z(u, taps), cuda_conv.conv_z_plain(u, taps)),
                        ("conv_y", cuda_conv.conv_y(u, taps), cuda_conv.conv_y_plain(u, taps)),
                        ("conv_x", cuda_conv.conv_x(u, taps), cuda_conv.conv_x_plain(u, taps))):
                    check_bits(f"{what} {suffix} (37, 45, 51) {name} g{o or ''} "
                               f"({'radius ' + str(plan) if plan else 'generic'})", got, want,
                               quiet=True)
                    n += 1
        zero = torch.full((20, 33, 64), -0.0, dtype=dtype, device="cuda")
        ints = {2: torch.int16, 4: torch.int32}[zero.element_size()]
        negzero = int(zero[0, 0, :1].view(ints))
        for sigma in (0.3, 2.0):
            gz = gaussian_kernels_1d(sigma, 1.0)[0]
            for got in (cuda_conv.conv_z(zero, gz), cuda_conv.conv_y(zero, gz),
                        cuda_conv.conv_x(zero, gz)):
                if not bool((got.view(ints) == negzero).all()):
                    fail(f"a -0.0 field through B6/B10 ({suffix}, sigma {sigma}) lost its sign")
        log(f"  B6/B10 forms {suffix} (37, 45, 51): {n} passes bit for bit (radii "
            f"{sorted({cuda_conv.axis_plan(k).radius for _, ks in forms for k in ks})}, "
            f"0 = generic); a -0.0 field keeps its sign")
        s_in = slab.to(dtype)
        tag = "82->66 slab"
        _, key, record = recorder(tag, s_in, timings, True)
        errs[key("conv_z")] = check_bits(f"conv_z {suffix} {tag} (sigma 0.3 padded to r = 8)",
                                         cuda_conv.conv_z(s_in, g_slab, True),
                                         cuda_conv.conv_z_plain(s_in, g_slab, True))
        w5 = torch.as_tensor(g_slab, dtype=dtype, device="cuda").reshape(1, 1, -1, 1, 1)
        s5 = s_in[None, None]
        record("conv_z", lambda: cuda_conv.conv_z(s_in, g_slab, True),
               lambda: cuda_conv.conv_z_plain(s_in, g_slab, True),
               lambda: F.conv3d(s5, w5))
        # the 66 outputs' non-zero taps reach 66 + 2 r input planes, not all 82
        plane = s_in[0].numel()
        work[key("conv_z")] = ((2 * 66 + 2 * slab_plan.r) * plane * s_in.element_size(),
                               2 * len(slab_plan.weights) * 66 * plane)
        del u, s_in, s5
    del small, slab
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_galerkin_product(gen, errs, timings, work):
    """B16 on levels 1 and 2 of the 512^3 collapsed and exact chains (the
    compressed level-0 operator -> 256^3, then that level's stored planes,
    27 or 117, -> 128^3), and on the exact level 1 pruned at
    GALERKIN_PRUNE_TOL -> 128^3 (the generic form), against the eager path
    (``assemble_galerkin_parabolic`` without kernels) on the same planes:
    max |kernel - eager| <= GALERKIN_TOL times the eager level's largest
    diagonal value, equal offsets, and the form GALERKIN_LEVELS names.  All
    timed; the bound counts the fine planes read once and the coarse planes
    written once.  The eager level is built first, so that its temporaries
    are gone before the kernel's planes are allocated."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.core.grids import CELL
    from multigridanisotropicdiffusion_tpu_torch.ops import compressed, cuda_galerkin, galerkin
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("  Galerkin product (B16)")
    t = spd_tensor_field(SHAPE, gen)
    level0 = compressed.assemble_compressed_dca(t, (1.0,) * 3, DT)
    del t
    cent = (CELL,) * 3
    coarse = None
    for tag, (collapse, want_form) in GALERKIN_LEVELS.items():
        # each level's fine planes: the 512^3 operator, or the level before
        # (pruned for the generic form's case, which keeps that level)
        if tag.startswith("512^3"):
            fine = level0
        elif "pruned" in tag:
            fine = galerkin.prune_stored_operator(coarse, GALERKIN_PRUNE_TOL)
        else:
            fine = coarse
        torch.cuda.empty_cache()
        want = galerkin.assemble_galerkin_parabolic(fine, cent, collapse=collapse)
        torch.cuda.empty_cache()
        before = cuda_galerkin.cuda_galerkin_product.forms.copy()
        got = cuda_galerkin.cuda_galerkin_product(fine, cent, collapse)
        (form,) = cuda_galerkin.cuda_galerkin_product.forms - before
        if got.offsets != want.offsets or got.coeffs.dtype != want.coeffs.dtype:
            fail(f"galerkin_product {tag}: offsets or dtype differ from the eager path")
        if form != want_form:
            fail(f"galerkin_product {tag}: took the form {form}, want {want_form}")
        err = max((g.double() - w.double()).abs().max().item()
                  for g, w in zip(got.coeffs, want.coeffs))
        scale = want.diag.abs().max().item()
        ok = err <= GALERKIN_TOL * scale and bool(torch.isfinite(got.coeffs).all())
        log(f"  galerkin_product f32 {tag} ({form}): {len(got.offsets)} planes, "
            f"max_abs_err={err:.3e} "
            f"max|diag|={scale:.3e} tol={GALERKIN_TOL:g} x max|diag| "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"galerkin_product {tag} disagrees with the eager path")
        key = ("galerkin_product f32", tag)
        errs[key] = err
        del got
        torch.cuda.empty_cache()
        ms = median_ms(lambda: cuda_galerkin.cuda_galerkin_product(fine, cent, collapse), 10)
        plain_ms = median_ms(
            lambda: galerkin.assemble_galerkin_parabolic(fine, cent, collapse=collapse), 3)
        timings[key] = (ms, plain_ms)
        fine_planes = galerkin.plane_table(fine)[1]
        nbytes = fine_planes.numel() * 4 + want.coeffs.numel() * 4
        work[key] = (nbytes, 0, tuple(fine_planes.shape[1:]), "float32")
        log(f"    galerkin_product f32 {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms(nbytes, 0)[0]:.3f} ms (bytes)")
        del fine, fine_planes
        if "pruned" not in tag:
            coarse = want
        del want
        torch.cuda.empty_cache()
    del coarse, level0
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
    log("  gaussian_derivative vesselness and select (B15)")
    for dtype in (torch.float32, torch.bfloat16):
        check_hv_kernels("512^3", vol.to(dtype), (1.0,) * 3, errs, timings, work, True)
    del vol
    small = tube_phantom((37, 45, 51), gen)
    for dtype in (torch.float32, torch.bfloat16):
        check_ved_kernels("(37, 45, 51)", small.to(dtype), (1.0, 0.9, 1.1), errs,
                          timings, work, False)
        check_axis_kernels("(37, 45, 51)", small.to(dtype), (1.0, 0.9, 1.1), errs,
                           timings, work, False)
        check_hv_kernels("(37, 45, 51)", small.to(dtype), (1.0, 0.9, 1.1), errs,
                         timings, work, False)
    # sigma = 16: r = 64, the cap, on every axis
    check_axis_kernels("(12, 150, 150) r=64", tube_phantom((12, 150, 150), gen),
                       (1.0,) * 3, errs, timings, work, False, sigma=16.0)
    # sigma = 2 at z spacing 0.25: r = 32 along z (and 16 on y and x)
    check_ved_kernels("(40, 48, 56) r=32", tube_phantom((40, 48, 56), gen),
                      (0.25, 0.5, 0.5), errs, timings, work, False)
    log("  B6 and B10 in every form, and at the main path's slab")
    check_axis_forms(gen, errs, timings, work)
    torch.cuda.empty_cache()
    check_local(gen, errs, timings, work)
    check_stored_and_2d(gen, errs, timings, work)
    check_galerkin_product(gen, errs, timings, work)
    return errs, timings, work


def check_local(gen, errs, timings, work):
    """B14 compressed on random planes, non-zero on every border (so the
    masking matters everywhere): one rank's (256, 512, 512) block of the
    512^3 level on a (2, 1, 1) mesh, timed, and an odd (37, 45, 51) block."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.ops.compressed import CompressedDCAOperator

    log("  shard-local compressed kernel (B14)")
    for shape, tag, timed_runs in (((256, 512, 512), "256x512^2 block", True),
                                   ((37, 45, 51), "(37, 45, 51)", False)):
        planes = torch.randn((10, *shape), generator=gen, device="cuda")
        planes[-1] = 8.0 + torch.rand(shape, generator=gen, device="cuda")
        check_stencil("local", tag, CompressedDCAOperator(planes, 3), gen, errs, timings,
                      work, timed_runs, local=True)
        del planes
    torch.cuda.empty_cache()


def phase_reference(gen):
    import numpy as np
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.stencil import densify
    from multigridanisotropicdiffusion_tpu_torch.ops.dca import assemble_dca
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("== phase 4: small reference solve against a dense direct solve")
    shape, spacing = (14, 13, 12), (1.0, 0.5, 2.0)
    t = spd_tensor_field(shape, gen).double()
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

    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("== phase 5: main path, mad_diffusion at 512^3 to 1e-6")
    tensor = spd_tensor_field(SHAPE, gen)
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

    outputs, launches = {}, None
    for label, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, use_kernels=False))):
        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run(c)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {k: n for k, n in launch_counts().items() if k in expect}
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
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("== phase 10: matrix-free operator, Chebyshev smoother and verbose trace at 256^3")
    shape = (256,) * 3
    tensor = spd_tensor_field(shape, gen)
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


#: the stencil kernels' launches by the kernels line's names: the sum of
#: these ``(form, pass)`` keys of ``ops.cuda_smoothers.launches``
STENCIL_LAUNCHES = {
    "stencil_halfsweep": (("compressed", "halfsweep"),),
    "stencil_sweep": (("compressed", "sweep"),),
    "stencil_residual": (("compressed", "residual"),),
    "stencil_stored_halfsweep": (("stored", "halfsweep"),),
    "stencil_stored_residual": (("stored", "residual"),),
    "stencil_2d_halfsweep": (("2d_compressed", "halfsweep"), ("2d_stored", "halfsweep")),
    "stencil_2d_residual": (("2d_compressed", "residual"), ("2d_stored", "residual")),
    "stencil_halfsweep_local": (("compressed", "halfsweep_local"),),
    "stencil_residual_local": (("compressed", "residual_local"),),
    "stencil_stored_halfsweep_local": (("stored", "halfsweep_local"),),
    "stencil_stored_residual_local": (("stored", "residual_local"),),
}


def wrapper_counters():
    """The other kernels' wrappers, which count their launches in
    ``.launches``, by the kernels line's names."""
    from multigridanisotropicdiffusion_tpu_torch.ops import (
        cuda_assemble,
        cuda_conv,
        cuda_transfer,
        cuda_vesselness,
    )

    return {
        "restrict3d": cuda_transfer.cuda_restrict,
        "prolong3d": cuda_transfer.cuda_prolong,
        "assemble_compressed": cuda_assemble.cuda_assemble_compressed_dca,
        "conv_z": cuda_conv.conv_z,
        "conv_yx": cuda_conv.conv_yx,
        "fd_vesselness": cuda_vesselness.fd_vesselness,
        "hessian_vesselness": cuda_vesselness.hessian_vesselness,
        "tensor_assembly": cuda_vesselness.tensor_assembly,
        "conv_y": cuda_conv.conv_y,
        "conv_x": cuda_conv.conv_x,
        "fd_hessian": cuda_vesselness.fd_hessian,
    }


def launch_counts():
    """Every kernel's launches since :func:`reset_counters`, by the kernels
    line's names; B16's also by variant, as ``galerkin_product.<variant>``,
    and by form (``ops.cuda_galerkin.FORMS``), as ``galerkin_product.<form>``."""
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_galerkin, cuda_smoothers

    counts = {name: sum(cuda_smoothers.launches[k] for k in keys)
              for name, keys in STENCIL_LAUNCHES.items()}
    counts.update({name: f.launches for name, f in wrapper_counters().items()})
    b16 = cuda_galerkin.cuda_galerkin_product.launches
    counts["galerkin_product"] = b16.total()
    counts.update({f"galerkin_product.{variant}": n for variant, n in b16.items()})
    counts.update({f"galerkin_product.{form}": n
                   for form, n in cuda_galerkin.cuda_galerkin_product.forms.items()})
    return counts


def reset_counters():
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_galerkin, cuda_smoothers

    cuda_smoothers.launches.clear()
    cuda_galerkin.cuda_galerkin_product.launches.clear()
    cuda_galerkin.cuda_galerkin_product.forms.clear()
    for f in wrapper_counters().values():
        f.launches = 0


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
    outputs, cycles, summary, launches = {}, {}, {"case": title}, None
    for label in ("kernels", "plain"):
        cfg = MADConfig.cuda(use_kernels=label == "kernels", max_cycles=max_cycles, **kw)
        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mad_diffusion(b, tensor, config=cfg, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: n for k, n in launch_counts().items() if n}
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

    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_galerkin
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("== phase 7: Galerkin main path, mad_diffusion at 512^3 to 1e-6 with "
        "MADConfig.cuda(coarse_operator='galerkin')")
    tensor = spd_tensor_field(SHAPE, gen)
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    kw = dict(time_step=DT, tolerance=1e-6, coarse_operator="galerkin")
    expect = STENCIL_3D + ("stencil_stored_halfsweep", "stencil_stored_residual",
                           "galerkin_product")
    launches, collapsed = solve_pair("galerkin collapsed 512^3", b, tensor, kw, expect)
    exact_launches, exact = solve_pair("galerkin exact 512^3", b, tensor,
                                       dict(kw, galerkin_variant="exact"), expect)
    # B16 counts each call's Galerkin levels under its own variant alone
    n = len(build_level_descriptors(SHAPE)) - 1
    for variant, other, counts in (("collapsed", "exact", launches),
                                   ("exact", "collapsed", exact_launches)):
        if (counts.get(f"galerkin_product.{variant}") != n
                or counts.get(f"galerkin_product.{other}")):
            fail(f"galerkin {variant} 512^3: B16 launches by variant {counts}, want "
                 f"{n} under {variant!r} alone")
    # and each level under its form: the exact chain's compiled-in forms, the
    # collapsed chain's untouched
    for variant, counts, want in (("collapsed", launches, GALERKIN_FORMS_512["collapsed"]),
                                  ("exact", exact_launches, GALERKIN_FORMS_512["exact"])):
        got = {form: counts.get(f"galerkin_product.{form}", 0) for form in cuda_galerkin.FORMS}
        got = {form: k for form, k in got.items() if k}
        log(f"  galerkin {variant} 512^3: B16 launches by form {got}")
        if got != want:
            fail(f"galerkin {variant} 512^3: B16 launches by form {got}, want {want}")
    summaries = [collapsed, exact]
    if exact["kernels"]["setup_peak_gib"] > EXACT_PEAK_LIMIT_GIB:
        log(f"  exact setup peak {exact['kernels']['setup_peak_gib']:.1f} GiB passes "
            "60 GB: the exact variant again at 256^3")
        del tensor, b
        torch.cuda.empty_cache()
        shape = (256,) * 3
        tensor = spd_tensor_field(shape, gen)
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
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    log("== phase 8: 2D main path: lena (float64) and 8192^2 (float32)")
    g = np.load(LENA)
    img = torch.as_tensor(g["input"], dtype=torch.float64, device="cuda")
    tensor = torch.stack([torch.full_like(img, 50.0), torch.zeros_like(img),
                          torch.full_like(img, 30.0)])
    reset_counters()
    res = mad_diffusion(img, tensor, config=MADConfig.cuda(
        mixed_precision=False, time_step=0.1, tolerance=1e-10),
        dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
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
    tensor = spd_tensor_field(SHAPE_2D, gen)
    b = torch.rand(SHAPE_2D, generator=gen, device="cuda") * 255.0
    kw = dict(time_step=DT, tolerance=1e-6)
    expect = ("stencil_2d_halfsweep", "stencil_2d_residual")
    launches, dca_2d = solve_pair("dca 8192^2", b, tensor, kw, expect)
    _, gal_2d = solve_pair("galerkin collapsed 8192^2", b, tensor,
                           dict(kw, coarse_operator="galerkin"), expect)
    del tensor, b
    torch.cuda.empty_cache()
    return launches, [lena, dca_2d, gal_2d]


# ---------------------------------------------------------------------------
# phase 11: the distributed main path, gloo ranks sharing cuda:0
# ---------------------------------------------------------------------------

#: the 8-rank solve: every axis split on a (2, 2, 2) mesh, half the blocks of
#: level 0 (127 planes on one side) with an odd origin, level 1 padded
DIST_SHAPE_8 = (254, 256, 256)
#: a group of ranks must finish within this many seconds
DIST_TIMEOUT_S = 420


def _b14_counts():
    return {k: n for k, n in launch_counts().items() if k in LOCAL_KERNELS}


def dist_sweep(mesh):
    """One distributed red-black sweep and residual through B14 on the
    512^3 compressed operator, against B1/B2 on the whole volume (rank 0)."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_assemble, cuda_smoothers
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        gather_level,
        level_spec,
        shard_field,
        shard_operator,
    )
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = spd_tensor_field(SHAPE, gen)
    op = cuda_assemble.cuda_assemble_compressed_dca(t, (1.0,) * 3, DT)
    del t
    x = torch.randn(SHAPE, generator=gen, device="cuda") * 10.0
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    spec = level_spec(mesh, SHAPE)
    op_l = shard_operator(op, mesh, spec=spec)
    x_l, b_l = shard_field(x, mesh, spec=spec), shard_field(b, mesh, spec=spec)
    reset_counters()
    y = halo.make_halo_kernel_rbgs_sweep(mesh, spec)(op_l, x_l, b_l)
    r = halo.make_halo_kernel_residual(mesh, spec)(op_l, x_l, b_l)
    torch.cuda.synchronize()
    out = {"b14_launches": _b14_counts()}
    y, r = gather_level(y, mesh, spec), gather_level(r, mesh, spec)
    if mesh.rank == 0:
        for name, got, want in (("sweep", y, cuda_smoothers.rbgs_sweep(op, x, b)),
                                ("residual", r, cuda_smoothers.cuda_residual(op, x, b))):
            scale = want.abs().max().item()
            out[f"{name}_err_rel"] = (got - want).abs().max().item() / scale
    return out


def _dist_solve_run(mesh, run, warm=None):
    """``run()`` on every rank, timed (first call, then ``warm()`` or
    ``run()`` again), with its launches and peak memory."""
    import torch
    import torch.distributed as dist

    reset_counters()
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = {"first_s": first_s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: n for k, n in launch_counts().items() if n}}
    out["b14_launches"] = _b14_counts()
    dist.barrier()
    t0 = time.perf_counter()
    (warm or run)()
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    return res, out


def dist_mad(mesh, shape, title, **kw):
    """``mad_diffusion`` with ``MADConfig.cuda(**kw)`` on phase 5's
    construction at ``shape`` across the mesh; rank 0 holds the gathered
    output against the single-device kernel solve."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, gather_field, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    gen = torch.Generator(device="cuda").manual_seed(0)
    tensor = spd_tensor_field(shape, gen)
    b = torch.rand(shape, generator=gen, device="cuda") * 255.0
    cfg = MADConfig.cuda(time_step=DT, tolerance=1e-6, max_cycles=50, **kw)
    hier = build_hierarchy(as_sym_planes(tensor, shape, dtype=b.dtype, device="cuda"),
                           build_level_descriptors(shape), cfg.time_step, cfg.coarse_operator,
                           cfg.operator_repr, cfg.use_kernels, cfg.galerkin_variant)
    res, out = _dist_solve_run(
        mesh, lambda: mad_diffusion(b, tensor, config=cfg, mesh=mesh),
        lambda: mad_diffusion(b, tensor, config=cfg, mesh=mesh, hierarchy=hier))
    del hier
    out.update(case=title, cycles=int(res.num_cycles[0]),
               relres=float(res.final_residual[0]))
    full = gather_field(res.output, mesh)
    if mesh.rank == 0:
        ref = mad_diffusion(b, tensor, config=cfg, device="cuda")
        out["rel_l2_vs_single"] = ((full.double() - ref.output.double()).norm()
                                   / ref.output.double().norm()).item()
        out["cycles_single"] = int(ref.num_cycles[0])
        out["finite"] = bool(torch.isfinite(full).all()) and tuple(full.shape) == shape
    return out


def dist_ved(mesh):
    """``ved(vol, config=VEDConfig.cuda(), mesh=mesh)`` on phase 6's 512^3
    phantom; rank 0 holds it against the single-device kernel call and runs
    phase 6's tube checks on the gathered outputs."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import VEDConfig, gather_field, ved
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import tube_centre, tube_phantom

    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = tube_phantom(SHAPE, gen)
    cfg = VEDConfig.cuda()
    res, out = _dist_solve_run(mesh, lambda: ved(vol, config=cfg, mesh=mesh))
    d = res.diffusion
    out.update(case="ved 512^3", cycles=d.num_cycles.tolist(),
               relres=d.final_residual.tolist())
    full = gather_field(res.output, mesh)
    ves = gather_field(res.vesselness, mesh)
    tensor = gather_field(res.tensor, mesh)
    del res, d
    if mesh.rank == 0:
        centre = tube_centre(SHAPE)
        t = tensor[(slice(None), *centre)].double().cpu()
        m = torch.stack([torch.stack([t[0], t[1], t[2]]), torch.stack([t[1], t[3], t[4]]),
                         torch.stack([t[2], t[4], t[5]])])
        out["vesselness_centre"] = float(ves[centre])
        out["axis_cos"] = abs(float(torch.linalg.eigh(m).eigenvectors[0, -1]))
        del tensor, ves
        ref = ved(vol, config=cfg, device="cuda")
        out["rel_l2_vs_single"] = ((full.double() - ref.output.double()).norm()
                                   / ref.output.double().norm()).item()
        out["cycles_single"] = ref.diffusion.num_cycles.tolist()
        out["finite"] = bool(torch.isfinite(full).all()) and tuple(full.shape) == SHAPE
    return out


def dist_halo_modes(mesh):
    """Phase 5's construction at 256^3 with ``use_kernels=False`` in both
    halo modes (``'shard_map'``: exchange, then contract; ``'overlap'``: the
    zero-halo contraction beside the exchange, then the slabs): rank 0
    holds the two gathered outputs ``torch.equal`` and against the
    single-device plain solve."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, gather_field, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
    from multigridanisotropicdiffusion_tpu_torch.utils.phantom import spd_tensor_field

    shape = (256, 256, 256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tensor = spd_tensor_field(shape, gen)
    b = torch.rand(shape, generator=gen, device="cuda") * 255.0
    out, fulls = {"case": "halo modes 256^3", "b14_launches": {}}, {}
    for halo in ("shard_map", "overlap"):
        cfg = MADConfig.cuda(time_step=DT, tolerance=1e-6, max_cycles=50, use_kernels=False,
                             halo=halo)
        hier = build_hierarchy(as_sym_planes(tensor, shape, dtype=b.dtype, device="cuda"),
                               build_level_descriptors(shape), cfg.time_step,
                               cfg.coarse_operator, cfg.operator_repr, cfg.use_kernels)
        res, run = _dist_solve_run(
            mesh, lambda: mad_diffusion(b, tensor, config=cfg, mesh=mesh),
            lambda: mad_diffusion(b, tensor, config=cfg, mesh=mesh, hierarchy=hier))
        del hier
        out[halo] = dict(first_s=run["first_s"], warm_s=run["warm_s"],
                         cycles=int(res.num_cycles[0]), relres=float(res.final_residual[0]))
        fulls[halo] = gather_field(res.output, mesh)
    if mesh.rank == 0:
        ref = mad_diffusion(b, tensor, config=cfg, device="cuda")
        full = fulls["overlap"]
        out["equal"] = torch.equal(fulls["shard_map"], full)
        out["rel_l2_vs_single"] = ((full.double() - ref.output.double()).norm()
                                   / ref.output.double().norm()).item()
        out["cycles_single"] = int(ref.num_cycles[0])
        out["finite"] = bool(torch.isfinite(full).all()) and tuple(full.shape) == shape
    return out


DIST_CASES = {
    "sweep 512^3": dist_sweep,
    "halo modes 256^3": dist_halo_modes,
    "dca 512^3": lambda mesh: dist_mad(mesh, SHAPE, "dca 512^3"),
    "ved 512^3": dist_ved,
    "dca (254, 256, 256)": lambda mesh: dist_mad(mesh, DIST_SHAPE_8, "dca (254, 256, 256)"),
    "galerkin collapsed (254, 256, 256)": lambda mesh: dist_mad(
        mesh, DIST_SHAPE_8, "galerkin collapsed (254, 256, 256)", coarse_operator="galerkin"),
}


def dist_rank(rank, world, store, out_dir, mesh_shape, cases):
    """One spawned rank of phase 11: gloo through a file store, its blocks on
    cuda:0, every case of ``cases``; writes ``rank<r>.json``."""
    import os

    import torch
    import torch.distributed as dist

    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        initialize_multihost,
        make_grid_mesh,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"file://{store}", world, rank, backend="gloo")
    mesh = make_grid_mesh(3, mesh_shape, device="cuda:0")
    report = {}
    for case in cases:
        report[case] = DIST_CASES[case](mesh)
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def run_dist(world, mesh_shape, cases):
    """Spawn ``world`` ranks running ``cases`` and return their reports; a
    rank that fails, or a group past DIST_TIMEOUT_S, fails the run."""
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        ctx = mp.start_processes(
            dist_rank, args=(world, os.path.join(out_dir, "store"), out_dir, mesh_shape,
                             cases), nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    fail(f"{world} ranks ran past {DIST_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        reports = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        return reports
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def halo_modes_report(case, rows, world, mesh_shape):
    """Phase 11's two halo modes: the same bits, each step at relres <=
    1e-6, the same cycles as each other and within one of one device."""
    head = rows[0]
    for r, row in enumerate(rows):
        log(f"  {case} rank {r}: warm shard_map {row['shard_map']['warm_s']:.3f} s, overlap "
            f"{row['overlap']['warm_s']:.3f} s (first calls {row['shard_map']['first_s']:.3f} "
            f"/ {row['overlap']['first_s']:.3f} s)")
    modes = [head["shard_map"], head["overlap"]]
    relres = [f"{m['relres']:.3e}" for m in modes]
    log(f"  {case} (use_kernels=False): outputs torch.equal across the modes: "
        f"{head['equal']}; cycles {[m['cycles'] for m in modes]} (single device "
        f"{head['cycles_single']}), relres {relres}, rel_l2 to the single-device plain run "
        f"{head['rel_l2_vs_single']:.3e} (bound 1e-4)")
    if not (head["equal"] and head["finite"] and head["rel_l2_vs_single"] <= 1e-4
            and all(m["relres"] <= 1e-6 for m in modes)
            and modes[0]["cycles"] == modes[1]["cycles"]
            and abs(modes[1]["cycles"] - head["cycles_single"]) <= 1):
        fail(f"{case}: the two halo modes disagree or are off")
    return dict(case=f"distributed {case}", ranks=world, mesh=list(mesh_shape),
                cycles=[m["cycles"] for m in modes], relres=[m["relres"] for m in modes],
                equal=head["equal"], rel_l2_vs_single=head["rel_l2_vs_single"],
                warm_s={k: [row[k]["warm_s"] for row in rows] for k in ("shard_map", "overlap")},
                first_s={k: [row[k]["first_s"] for row in rows]
                         for k in ("shard_map", "overlap")})


def phase_distributed():
    """The distributed main path on one card: gloo ranks sharing cuda:0 (the
    faces staged through the host), so these numbers measure the port's
    correctness and its overheads, not the scaling of NVLink."""
    import torch

    log("== phase 11: distributed main path, gloo ranks sharing cuda:0")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary, launches = [], {}
    for world, mesh_shape, cases in (
            (2, (2, 1, 1), ("sweep 512^3", "halo modes 256^3", "dca 512^3", "ved 512^3")),
            (8, (2, 2, 2), ("dca (254, 256, 256)", "galerkin collapsed (254, 256, 256)"))):
        t0 = time.perf_counter()
        reports = run_dist(world, mesh_shape, cases)
        log(f"  {world} ranks, mesh {mesh_shape}: {time.perf_counter() - t0:.1f} s with the "
            "spawn")
        for case in cases:
            rows = [rep[case] for rep in reports]
            head = rows[0]
            if case.startswith("halo modes"):
                summary.append(halo_modes_report(case, rows, world, mesh_shape))
                continue
            for r, row in enumerate(rows):
                if not all(row["b14_launches"].get(k) for k in LOCAL_KERNELS[:2]) and \
                        not all(row["b14_launches"].get(k) for k in LOCAL_KERNELS[2:]):
                    fail(f"{case}: rank {r} launched no B14: {row['b14_launches']}")
            if case.startswith("sweep"):
                log(f"  {case}: rel max err of the distributed sweep "
                    f"{head['sweep_err_rel']:.3e}, residual {head['residual_err_rel']:.3e} "
                    "(bound 1e-5); B14 launches per rank "
                    f"{[row['b14_launches'] for row in rows]}")
                if not (head["sweep_err_rel"] <= 1e-5 and head["residual_err_rel"] <= 1e-5):
                    fail(f"{case}: the distributed sweep disagrees with B1/B2")
                continue
            for r, row in enumerate(rows):
                log(f"  {case} rank {r}: first call {row['first_s']:.3f} s, warm "
                    f"{row['warm_s']:.3f} s, peak device memory {row['peak_gib']:.2f} GiB, "
                    f"B14 launches {row['b14_launches']}")
            cycles = head["cycles"] if isinstance(head["cycles"], list) else [head["cycles"]]
            single = head["cycles_single"]
            single = single if isinstance(single, list) else [single]
            relres = head["relres"] if isinstance(head["relres"], list) else [head["relres"]]
            log(f"  {case}: cycles {cycles} (single device {single}), relres "
                f"{[f'{v:.3e}' for v in relres]}, rel_l2 to the single-device kernel run "
                f"{head['rel_l2_vs_single']:.3e} (bound 1e-4)")
            ok = (head["finite"] and head["rel_l2_vs_single"] <= 1e-4
                  and all(v <= 1e-6 for v in relres)
                  and all(abs(a - c) <= 1 for a, c in zip(cycles, single)))
            if case.startswith("ved"):
                log(f"  {case}: vesselness at the tube centre {head['vesselness_centre']:.4f}, "
                    f"principal axis |cos| to the tube {head['axis_cos']:.4f}")
                ok = ok and head["vesselness_centre"] > 0.1 and head["axis_cos"] > 0.9
            if not ok:
                fail(f"{case}: the distributed run is off")
            summary.append(dict(case=f"distributed {case}", ranks=world,
                                mesh=list(mesh_shape), cycles=cycles, relres=relres,
                                rel_l2_vs_single=head["rel_l2_vs_single"],
                                first_s=[row["first_s"] for row in rows],
                                warm_s=[row["warm_s"] for row in rows],
                                peak_gib=[row["peak_gib"] for row in rows],
                                b14_launches=[row["b14_launches"] for row in rows]))
            if case == "dca 512^3":
                launches.update({k: n for k, n in head["b14_launches"].items()
                                 if k in LOCAL_KERNELS[:2]})
            if case.startswith("galerkin"):
                launches.update({k: n for k, n in head["b14_launches"].items()
                                 if k in LOCAL_KERNELS[2:]})
    missing = [k for k in LOCAL_KERNELS if not launches.get(k)]
    if missing:
        fail(f"phase 11 launched no {missing}")
    return launches, summary


#: the solve kernels' work per 512^3 float32 call: planes moved (each read or
#: written once, in units of the 512^3 volume) and float operations per fine
#: cell, counted from their sources (the prolongation: a z lerp of 3 per fine
#: cell, and the y lerp and two x lerps of each coarse plane, 9, shared by
#: two fine planes)
SOLVE_WORK = {
    "stencil_halfsweep": (13, 29),
    "stencil_sweep": (13, 29),
    "stencil_residual": (13, 30),
    "restrict3d": (1 + 1 / 8, 21),
    "prolong3d": (1 / 8 + 1, 8),
    "assemble_compressed": (16, 60),
}


#: the prolongation's add form at 512^3: reads x and e, writes x + P e
PROLONG_ADD_PLANES = 2 + 1 / 8
PROLONG_ADD_OPS = SOLVE_WORK["prolong3d"][1] + 1


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
    launches.update({k: n for k, n in gal_launches.items()
                     if k.startswith("stencil_stored") or k == "galerkin_product"})
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches_2d, solves_2d = phase_2d(gen)
    launches.update({k: n for k, n in launches_2d.items() if k.startswith("stencil_2d")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    launches.update({k: n for k, n in phase_ved_gd(gen).items()
                     if k in ("conv_y", "conv_x", "fd_hessian", "hessian_vesselness")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel_less = phase_kernel_less(gen)
    dist_launches, dist_solves = phase_distributed()
    launches.update(dist_launches)
    log(f"phases 2-11 took {time.perf_counter() - t_start:.1f} s")

    cells = SHAPE[0] * SHAPE[1] * SHAPE[2]
    rows = []
    for name, (source, replaces, case, *tag) in KERNELS.items():
        tag = tag[0] if tag else "512^3"
        shape, dtype = list(SHAPE), "float32"
        if name in SOLVE_WORK:
            # a library call only for the all-cell transfers (none computes
            # the stencil or the assembly)
            ms, plain_ms, lib_ms = timings[(case, tag)]
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
            "launches": launches.get(name, 0), "max_abs_err": errs[(case, tag)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "shape": list(shape), "dtype": dtype, "case": tag,
        }
        if name == "stencil_sweep":
            # the two half-sweep launches it replaces, in the library slot
            row["pair_ms"], row["library_ms"] = lib_ms, None
        if name == "conv_z":
            # the main path's launches: one z slab of the 512^3 VED call
            slab = ("conv_z f32", "82->66 slab")
            row["slab"] = dict(zip(("ms", "plain_ms", "library_ms"), timings[slab]),
                               case=slab[1], bound_ms=bound_ms(*work[slab])[0],
                               max_abs_err=errs[slab])
        if name in ("fd_vesselness", "hessian_vesselness"):
            first = f"{name} first f32"
            row["first_ms"], row["first_plain_ms"], _ = timings[(first, "512^3")]
            row["first_bound_ms"] = bound_ms(*work[(first, "512^3")])[0]
        if name == "hessian_vesselness":
            # the main path's launches: one 64-plane z slab of the 512^3 VED call
            for variant in ("first", "select"):
                for dt in ("f32", "bf16"):
                    slab = (f"{name} {variant} {dt}", HV_SLAB)
                    row.setdefault("slab", {"case": HV_SLAB})[f"{variant} {dt}"] = dict(
                        zip(("ms", "plain_ms"), timings[slab][:2]),
                        bound_ms=bound_ms(*work[slab])[0], max_abs_err=errs[slab])
        bf16 = (case.replace("f32", "bf16"), tag)
        if bf16 in timings:
            # the solve kernels move the same values in half the bytes
            work16 = (nbytes / 2, nops) if name in SOLVE_WORK else work[bf16][:2]
            row["bf16"] = dict(zip(("ms", "plain_ms", "library_ms"), timings[bf16]),
                               bound_ms=bound_ms(*work16)[0], max_abs_err=errs[bf16])
            if name == "stencil_sweep":
                row["bf16"]["pair_ms"] = row["bf16"].pop("library_ms")
        if name == "prolong3d":
            # the add form x + P e, the V-cycle's correction; library_ms is
            # the two launches it replaces, x + cuda_prolong(e)
            for dt, item in (("f32", 4), ("bf16", 2)):
                a_ms, a_plain, a_pair = timings[(f"prolong_add3d {dt}", tag)]
                row.setdefault("add_form", {})[dt] = {
                    "ms": a_ms, "plain_ms": a_plain, "pair_ms": a_pair,
                    "bound_ms": bound_ms(PROLONG_ADD_PLANES * cells * item,
                                         PROLONG_ADD_OPS * cells)[0],
                    "max_abs_err": errs[(f"prolong_add3d {dt}", tag)]}
        for extra in EXTRA_CASES.get(name, ()):
            e_ms, e_plain = timings[(case, extra)]
            e_bytes, e_ops, e_shape, _ = work[(case, extra)]
            other = {"case": extra, "shape": list(e_shape), "ms": e_ms, "plain_ms": e_plain,
                     "bound_ms": bound_ms(e_bytes, e_ops)[0],
                     "max_abs_err": errs[(case, extra)]}
            e16 = (case.replace("f32", "bf16"), extra)
            if e16 in timings:
                other["bf16"] = dict(zip(("ms", "plain_ms"), timings[e16]),
                                     bound_ms=bound_ms(*work[e16][:2])[0],
                                     max_abs_err=errs[e16])
            row.setdefault("other_cases", []).append(other)
        rows.append(row)
    print(json.dumps({"solves": solves + solves_2d + kernel_less + dist_solves}))
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
