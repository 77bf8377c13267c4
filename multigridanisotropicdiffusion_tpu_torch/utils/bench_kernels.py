"""Time the transfer kernels (B3, B4), the Gaussian z pass (B6), the fused
y+x Gaussian (B7), the fused FD Hessian + vesselness + select (B8), the
single-axis Gaussian-derivative passes (B10), the standalone FD Hessian
(B11), the Hessian stack's vesselness + select (B15), the
compressed-operator stencil (B1/B2, and B14's shard-local form)
and the stored-operator stencils (B12, B13's stored form) at the main path's
shapes, on one CUDA card.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.bench_kernels \\
        [--check-only] [--only PREFIX ...]

Cases, float32 and bfloat16 storage, inputs made on the device from seed 0:

* ``restrict3d``: 512^3 -> 256^3, all cell-centred (the solve's level 0),
  and the batch of six tensor planes (the DCA setup's restriction);
* ``prolong3d``: 256^3 -> 512^3, ``P e``;
* ``correction``: the V-cycle's ``x + P e`` at 512^3, as ``x +
  cuda_prolong(e)`` (two launches) and, where the package has it, as one
  launch of the add form ``cuda_prolong_add``;
* ``conv_z``: valid mode over the tube phantom, each of the VED's five
  scales' taps zero-padded to radius 8 as the z-slab pipelines pass them:
  530 -> 514 planes of 512^2 (a 512^3 volume's smooth_fd halo, unsliced)
  and the 82 -> 66 plane slab (``smooth_fd``: the Gaussian), and the 80 ->
  64 plane slab (``gaussian_derivative``: g, g1 and g2);
* ``conv_y``, ``conv_x``: each scale's g2 and g1 taps on 512^3 and on a 64
  plane slab of 512^2 (the ``gaussian_derivative`` pipeline's shape);
* ``conv_z x=510``, ``conv_y x=510``: rows of 510 values, which are not
  whole 16-byte vectors (no main-path shape has them);
* ``conv_yx``: 514 planes of 512^2 (a 512^3 volume's smoothed field with
  its two FD halo planes), the tube phantom, with each of the VED's five
  scales' Gaussian taps at unit spacing (r = 2, 2, 4, 5, 8);
* ``fd_vesselness``: B8's first scale (sigma 1.245) and a select scale
  (sigma 2, against the first scale's best, restored before each call) on
  the 512^3 phantom's smoothed fields (514 planes, the two FD halo planes
  included) and on their first 66 planes (one VED z slab of 64 planes, the
  shape the main path's 40 launches have);
* ``fd_hessian``: B11 on the sigma 2 field;
* ``hessian_vesselness``: B15's first scale (sigma 1.245) and a select
  scale (sigma 2, against the first scale's best, restored before each
  call) on the 512^3 phantom's ``gaussian_derivative`` Hessian stacks (B6
  and B10, valid z) and on their first 64 planes (one VED z slab, the shape
  the main path's 40 launches have), where the package has B15;
* ``fill_``: a plain write of a 512^3 field, what the card's memory takes
  for the bytes the prolongation writes (a yardstick, not a kernel of the
  package);
* ``compressed``: B1's half-sweeps (both colours), B17's fused sweep and
  B2's residual on the 10-plane compressed DCA operator at 512^3, 256^3 and
  128^3 (the main path's levels 0-2, each assembled from its own tensor field as
  ``chip_smoke.py``'s phase 3 does); ``compressed_local``: one rank's (256,
  512, 512) block of the 512^3 operator through the shard-local form (B14);
* ``stored``: B12's half-sweeps (both colours) and residual on the 512^3
  19-plane stored DCA operator and, built from the same 512^3 tensor field
  as ``chip_smoke.py``'s phase 3 builds them, level 1 of the exact Galerkin
  hierarchy (256^3, 117 planes), its collapse (27 planes: the collapsed
  hierarchy's level 1), that level pruned at 1e-3 (the generic loop), and
  the exact hierarchy's level 2 (128^3, 125 planes); ``stored_local``: one
  rank's (128, 256, 256) block of the collapsed level through the
  shard-local form (B14 stored);
* ``2d_stored``: B13's stored form on the 9-plane stored DCA operator at
  8192^2 and (1531, 997) (a width that is not whole 4-cell vectors).

Each case is first held against its plain version (float32 within 1e-5 of
max|plain|, bf16 within one bf16 ulp of each value, floored at that; B8's
select: the response only, since a near-tie may flip a decision; the add
form bit for bit ``x + cuda_prolong(e)``), and ``equal`` says whether the
output is bit for bit the plain version's (B1/B2, B6, B10, B12, B13's
stored form and B15 must be: a case of theirs that is not fails, and is still timed;
the shard-local forms must be ``torch.equal``, the sign of an exact zero
aside).
``sha256`` is a hash of the output's bytes (B8, B15: the response, then the six
planes), so that two trees' outputs can be compared. Then, unless
``--check-only``, the median of 20 CUDA-event timings of 10 back-to-back
calls each (per call) after a warm-up (B8's select: one call per timing,
after the restore; B1/B2, B12, B13's stored form and B14: the 10 calls
replayed from a CUDA graph, so that the (1531, 997) cases, shorter than the wrappers' host
time, are timed on the card), with the least time the card could take for
the bytes moved (each input read once, each output written once, at 3.35
TB/s; B6 reads only the planes that its non-zero taps reach; the stencils
(K + 3) values per cell, K = 10 for the compressed operator). Before the B8 cases, a line per VED scale gives the
share of the 514-plane phantom field's voxels that are bright (the two
largest-magnitude eigenvalues negative: the voxels whose vesselness is not
0), counted from the plain eigenvalues (before the B15 cases, the same for
its two Hessian stacks). Prints the card's name and power
limit, one line per case, and a last line ``{"cases": [...]}``.  Exits 1 if a check fails or there is no card.

The script imports ``ops.cuda_transfer``, ``ops.cuda_conv``,
``ops.transfer``, ``ops.hessian``, ``ops.cuda_vesselness``, ``ops.eigen3``,
``ops.cuda_smoothers``, ``ops.dca``, ``ops.compressed``, ``ops.galerkin``,
``core``, ``models.ved`` and ``utils.phantom``; the stencil cases need the
one wrapper module of every stencil form (``ops.cuda_smoothers`` with
``kernel_takes``), so a tree older than that runs its own copy of the
script.  Two trees are compared in one call by running it in each, in
turns (``--only stored --only 2d_stored``: B12 and B13 alone; ``--only
compressed``: B1/B2 and B14).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
SIGMAS = (0.3, 0.482, 0.775, 1.245, 2.0)
PARAMS = (0.5, 0.5, 5.0)  # VEDConfig's alpha, beta, gamma


def _median_ms(fn, reps=20, burst=10, setup=None, graph=False):
    """Median over ``reps`` CUDA-event timings of ``burst`` back-to-back
    calls, per call: the wrapper's host time overlaps the card's work.
    With ``setup``: one call per timing, each after ``setup()``, which is
    left to run on the card (so the call's launch overlaps it).  With
    ``graph``: the burst is captured once in a CUDA graph and each timing
    replays it, so a call shorter than its wrapper's host time is timed on
    the card, not on the host."""
    if setup:
        burst = 1
        setup()
    fn()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(burst):
                fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if graph:
            g.replay()
        else:
            for _ in range(burst):
                fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def _valid_z_bytes(taps, planes_out, plane_bytes):
    """Bytes a valid-mode z pass must move: the output planes, and the input
    planes that its non-zero taps reach (the plain version skips zero taps,
    so the zero-padded ends of the taps read nothing)."""
    nonzero = np.flatnonzero(taps)
    c = (len(taps) - 1) // 2
    r = max(c - nonzero[0], nonzero[-1] - c)
    return (2 * planes_out + 2 * r) * plane_bytes


def _max_err(got, want):
    """Max |got - want|, or None if it exceeds the tolerance."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    scale = w.abs().max().item()
    if want.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-38))) - 7)
        ok = bool((err <= ulp.clamp_min(1e-5 * scale)).all())
    else:
        ok = err.max().item() <= 1e-5 * scale
    ok = ok and bool(torch.isfinite(g).all())
    return err.max().item() if ok else None


def _same_bits(a, b):
    """Whether two tensors hold the same bytes (signed zeros included)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(ints[a.element_size()]), b.contiguous().view(ints[b.element_size()])))


def _sha256(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check-only", action="store_true",
                        help="hold each case against its plain version, time nothing")
    parser.add_argument("--only", action="append", default=[], metavar="PREFIX",
                        help="run only the cases whose name starts with PREFIX (repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ..models.ved import vesselness_measure
    from ..ops import cuda_conv, cuda_transfer, cuda_vesselness, transfer
    from ..ops.eigen3 import eigvalsh3, sort_by_abs3
    from ..ops.hessian import (
        fd_factors,
        fd_planes,
        gaussian_kernels_1d,
        hessian,
        kernel_radius,
        smoothed_field_valid_z,
    )
    from .phantom import tube_phantom

    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip())
    add_form = getattr(cuda_transfer, "cuda_prolong_add", None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cent = ("c",) * 3
    fine32 = torch.randn((512,) * 3, generator=gen, device="cuda") * 10.0
    coarse32 = torch.randn((256,) * 3, generator=gen, device="cuda") * 10.0
    vol = tube_phantom((514, 512, 512), gen)
    cases, failed = [], []

    def wanted(prefix):
        """Whether any case whose name starts with ``prefix`` may run."""
        return not args.only or any(prefix.startswith(p) or p.startswith(prefix)
                                    for p in args.only)

    def case(name, dtype, fn, want, nbytes, same=None, setup=None, parts=None,
             bitwise=False, equal_values=False, graph=False):
        """``parts(got)``: the tensors of the output that are hashed (the
        first is checked against ``want``); default the output itself.
        ``bitwise``: the output must be ``want``'s bits; ``equal_values``:
        ``torch.equal`` to it (a case that is not fails; it is still timed
        if it is within the tolerance, so that an older tree's kernel that
        rounds otherwise can be compared)."""
        if args.only and not name.startswith(tuple(args.only)):
            return
        if setup:
            setup()
        got = fn()
        outs = parts(got) if parts else (got,)
        if same is not None:
            err = 0.0 if torch.equal(got, same) else None
            equal = err == 0.0
        else:
            err = _max_err(outs[0], want)
            equal = (bool(torch.equal(outs[0], want)) if equal_values
                     else _same_bits(outs[0], want))
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "equal": equal, "sha256": _sha256(*outs),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del got, outs
        if err is None or ((bitwise or equal_values) and not equal):
            failed.append(name)
        if err is not None and not args.check_only:
            row["ms"] = _median_ms(fn, setup=setup, graph=graph)
        cases.append(row)
        print(json.dumps(row), flush=True)

    radius = kernel_radius(2.0, 1.0) + 1
    one = (1.0, 1.0, 1.0)
    ved_vol = tube_phantom((512 + 2 * radius, 512, 512), gen)

    def fdv(us, facs, best=None):
        return cuda_vesselness.fd_vesselness(us, facs, PARAMS, best,
                                             measure_fn=vesselness_measure)

    def fd_cases(dtype):
        """B8 first and select, B11, on the 514-plane fields and a 66-plane
        slab of them; the bright share per scale (float32 only)."""
        item = torch.finfo(dtype).bits // 8
        u = ved_vol.to(dtype)
        if dtype == torch.float32:
            for sigma in SIGMAS:
                us = smoothed_field_valid_z(u, sigma, one, radius, use_kernels=True)
                lam = sort_by_abs3(eigvalsh3(fd_planes(us, fd_factors(sigma, one, True))))
                share = ((lam[1] < 0) & (lam[2] < 0)).double().mean().item()
                del us, lam
                print(json.dumps({"bright_share": share, "sigma": sigma,
                                  "shape": [512 + 2, 512, 512]}), flush=True)
        us1 = smoothed_field_valid_z(u, 1.245, one, radius, use_kernels=True)
        us2 = smoothed_field_valid_z(u, 2.0, one, radius, use_kernels=True)
        del u
        f1, f2 = fd_factors(1.245, one, True), fd_factors(2.0, one, True)
        for planes in (514, 66):
            a, b = us1[:planes].contiguous(), us2[:planes].contiguous()
            n = (planes - 2) * 512 * 512
            resp_item = 4
            tag = f"{planes} planes"
            want = cuda_vesselness.fd_vesselness_plain(a, f1, PARAMS, None,
                                                       vesselness_measure)[0]
            case(f"fd_vesselness first {tag}", dtype, lambda: fdv(a, f1), want,
                 a.numel() * item + n * (resp_item + 6 * item), parts=lambda g: g)
            best = fdv(a, f1)
            incoming = (best[0].clone(), best[1].clone())
            want = cuda_vesselness.fd_vesselness_plain(b, f2, PARAMS, incoming,
                                                       vesselness_measure)[0]
            winners = int((want > incoming[0]).sum())

            def restore():
                best[0].copy_(incoming[0])
                best[1].copy_(incoming[1])

            case(f"fd_vesselness select {tag}", dtype, lambda: fdv(b, f2, best), want,
                 b.numel() * item + n * resp_item + winners * (resp_item + 6 * item),
                 setup=restore, parts=lambda g: g)
            print(json.dumps({"select_winners": winners, "of": n, "case": tag,
                              "dtype": str(dtype).replace("torch.", "")}), flush=True)
            del want, best, incoming
            if planes == 514:
                case("fd_hessian 514 planes", dtype,
                     lambda: cuda_vesselness.fd_hessian(b, f2),
                     cuda_vesselness.fd_hessian_plain(b, f2), (b.numel() + 6 * n) * item)
            del a, b
            torch.cuda.empty_cache()
        del us1, us2
        torch.cuda.empty_cache()

    hv = getattr(cuda_vesselness, "hessian_vesselness", None)

    def hv_cases(dtype):
        """B15 first and select on the 512^3 gaussian_derivative Hessian
        stacks and a 64-plane slab of them; the bright share of each stack
        (float32 only)."""
        item = torch.finfo(dtype).bits // 8
        hz = kernel_radius(2.0, 1.0)
        u = ved_vol[radius - hz:radius + 512 + hz].to(dtype)
        h1, h2 = (hessian(u, sigma, one, z_valid_radius=hz, mode="gaussian_derivative",
                          use_kernels=True) for sigma in (1.245, 2.0))
        del u
        if dtype == torch.float32:
            for sigma, h in ((1.245, h1), (2.0, h2)):
                lam = sort_by_abs3(eigvalsh3(h))
                share = ((lam[1] < 0) & (lam[2] < 0)).double().mean().item()
                del lam
                print(json.dumps({"bright_share": share, "sigma": sigma,
                                  "hessian": "gaussian_derivative",
                                  "shape": list(h.shape[1:])}), flush=True)
        for planes in (512, 64):
            a, b = h1[:, :planes].clone(), h2[:, :planes].clone()
            n = a[0].numel()
            tag = f"{planes} planes"
            want = cuda_vesselness.hessian_vesselness_plain(a, PARAMS, None,
                                                            vesselness_measure)[0]
            case(f"hessian_vesselness first {tag}", dtype, lambda: hv(a, PARAMS), want,
                 n * (6 * item + 4), parts=lambda g: g, bitwise=True)
            best = hv(a, PARAMS)  # adopts a: the select scale writes into it
            incoming = (best[0].clone(), best[1].clone())
            want = cuda_vesselness.hessian_vesselness_plain(b, PARAMS, incoming,
                                                            vesselness_measure)[0]
            winners = int((want > incoming[0]).sum())

            def restore():
                best[0].copy_(incoming[0])
                best[1].copy_(incoming[1])

            case(f"hessian_vesselness select {tag}", dtype, lambda: hv(b, PARAMS, best),
                 want, n * (6 * item + 4) + winners * (4 + 6 * item), setup=restore,
                 parts=lambda g: g, bitwise=True)
            print(json.dumps({"select_winners": winners, "of": n, "case": f"B15 {tag}",
                              "dtype": str(dtype).replace("torch.", "")}), flush=True)
            del a, b, want, best, incoming
            torch.cuda.empty_cache()
        del h1, h2
        torch.cuda.empty_cache()

    transfers = ("restrict3d", "prolong3d", "correction", "fill_", "conv_yx")
    for dtype in (torch.float32, torch.bfloat16):
        if not any(wanted(p) for p in transfers):
            break
        item = torch.finfo(dtype).bits // 8
        x, e = fine32.to(dtype), coarse32.to(dtype)
        cells = x.numel()
        case("restrict3d", dtype, lambda: cuda_transfer.cuda_restrict(x, cent),
             transfer.restrict_plain(x, cent), (1 + 1 / 8) * cells * item)
        six = torch.stack([x.roll(a, 0) for a in range(6)])
        case("restrict3d batch 6", dtype, lambda: cuda_transfer.cuda_restrict(six, cent),
             transfer.restrict_plain(six, cent), 6 * (1 + 1 / 8) * cells * item)
        del six
        case("prolong3d", dtype, lambda: cuda_transfer.cuda_prolong(e, cent),
             transfer.prolong_plain(e, cent), (1 + 1 / 8) * cells * item)
        pair = x + cuda_transfer.cuda_prolong(e, cent)
        case("correction x + cuda_prolong(e)", dtype,
             lambda: x + cuda_transfer.cuda_prolong(e, cent),
             x + transfer.prolong_plain(e, cent), (2 + 1 / 8) * cells * item)
        if add_form is not None:
            case("correction cuda_prolong_add", dtype, lambda: add_form(x, e, cent),
                 None, (2 + 1 / 8) * cells * item, same=pair)
        buf = torch.empty_like(x)
        case("fill_ 512^3", dtype, lambda: buf.fill_(1.0), None, cells * item, same=buf)
        del x, e, pair, buf
        u = vol.to(dtype)
        for sigma in SIGMAS:
            g = gaussian_kernels_1d(sigma, 1.0)[0]
            r = (len(g) - 1) // 2
            case(f"conv_yx r={r} (sigma {sigma})", dtype,
                 lambda: cuda_conv.conv_yx(u, g, g), cuda_conv.conv_yx_plain(u, g, g),
                 2 * u.numel() * item)
        del u
        torch.cuda.empty_cache()
    def axis_cases(dtype):
        """B6 on the padded taps of every scale, B10 on every scale's g2 and
        g1 taps, at the whole volume and at the slabs."""
        item = torch.finfo(dtype).bits // 8
        u = ved_vol.to(dtype)
        for planes in (530, 82, 80):
            a = u[:planes].contiguous()
            orders = (0, 1, 2) if planes == 80 else (0,)
            for sigma in SIGMAS:
                kernels = gaussian_kernels_1d(sigma, 1.0)
                for o in orders:
                    taps = np.pad(kernels[o], 8 - (len(kernels[o]) - 1) // 2)
                    case(f"conv_z {planes}->{planes - 16} g{o or ''} (sigma {sigma})", dtype,
                         lambda: cuda_conv.conv_z(a, taps, True),
                         cuda_conv.conv_z_plain(a, taps, True),
                         _valid_z_bytes(taps, planes - 16, a[0].numel() * item),
                         bitwise=True)
            del a
        # rows that are not whole 16-byte vectors (x % 4 != 0)
        a = u[:530, :, :510].contiguous()
        for sigma in (0.3, 2.0):
            g = gaussian_kernels_1d(sigma, 1.0)[0]
            taps = np.pad(g, 8 - (len(g) - 1) // 2)
            case(f"conv_z x=510 530->514 (sigma {sigma})", dtype,
                 lambda: cuda_conv.conv_z(a, taps, True), cuda_conv.conv_z_plain(a, taps, True),
                 _valid_z_bytes(taps, 514, a[0].numel() * item), bitwise=True)
        a = u[:512, :, :510].contiguous()
        g2 = gaussian_kernels_1d(2.0, 1.0)[2]
        case("conv_y x=510 512 planes g2 (sigma 2.0)", dtype, lambda: cuda_conv.conv_y(a, g2),
             cuda_conv.conv_y_plain(a, g2), 2 * a.numel() * item, bitwise=True)
        del a
        for planes in (512, 64):
            a = u[:planes].contiguous()
            for sigma in SIGMAS:
                for o in (2, 1):
                    taps = gaussian_kernels_1d(sigma, 1.0)[o]
                    for name in ("conv_y", "conv_x"):
                        fn, plain = getattr(cuda_conv, name), getattr(cuda_conv, f"{name}_plain")
                        case(f"{name} {planes} planes g{o} (sigma {sigma})", dtype,
                             lambda: fn(a, taps), plain(a, taps), 2 * a.numel() * item,
                             bitwise=True)
            del a
        del u
        torch.cuda.empty_cache()

    def stencil_cases(prefix, tag, op32, local=False):
        """B1/B2, B12 (``local``: the shard-local form of either, B14) or
        B13's stored form on one float32 operator, through
        ``ops.cuda_smoothers``: both half-sweeps and the residual in float32
        and bfloat16, bit for bit the plain versions (the local forms: equal
        values, ``torch.equal``); (K + 3) values per cell."""
        from ..ops import cuda_smoothers as cs

        k = len(op32.offsets) if hasattr(op32, "offsets") else op32.planes.shape[0]
        gen_x = torch.Generator(device="cuda").manual_seed(k)
        x32 = torch.randn(op32.shape, generator=gen_x, device="cuda") * 10.0
        b32 = torch.rand(op32.shape, generator=gen_x, device="cuda") * 255.0
        sfx = "_local" if local else ""
        sweep, sweep_plain = (getattr(cs, f"halfsweep{sfx}"),
                              getattr(cs, f"halfsweep{sfx}_plain"))
        resid, resid_plain = (getattr(cs, f"cuda_residual{sfx}"),
                              getattr(cs, f"residual{sfx}_plain"))
        for dtype in (torch.float32, torch.bfloat16):
            op, x, b = op32.astype(dtype), x32.to(dtype), b32.to(dtype)
            nbytes = (k + 3) * x.numel() * x.element_size()
            calls = [(f"halfsweep{c}", lambda c=c: sweep(op, x, b, c),
                      lambda c=c: sweep_plain(op, x, b, c)) for c in (0, 1)]
            calls.append(("residual", lambda: resid(op, x, b), lambda: resid_plain(op, x, b)))
            if prefix == "compressed":
                # B17: the whole sweep in one launch, one pass's bytes as its bound
                calls.append(("sweep", lambda: cs.rbgs_sweep(op, x, b),
                              lambda: cs.rbgs_sweep_plain(op, x, b)))
            for what, fn, plain in calls:
                name = f"{prefix} {tag} (K={k}) {what}"
                if args.only and not name.startswith(tuple(args.only)):
                    continue
                case(name, dtype, fn, plain(), nbytes, bitwise=not local,
                     equal_values=local, graph=True)
            del op, x, b
        del x32, b32
        torch.cuda.empty_cache()

    if wanted("compressed"):
        # B1/B2 on the main path's first three levels, and B14 on one rank's
        # block of the 512^3 level on a (2, 1, 1) mesh
        from ..ops import compressed
        from .phantom import spd_tensor_field

        for n in (512, 256, 128):
            t = spd_tensor_field((n,) * 3, torch.Generator(device="cuda").manual_seed(0))
            op = compressed.assemble_compressed_dca(t, (1.0,) * 3, 0.1)
            del t
            stencil_cases("compressed", f"{n}^3", op)
            if n == 512:
                block = compressed.CompressedDCAOperator(op.planes[:, :256].contiguous(), 3)
                del op
                stencil_cases("compressed_local", "(256, 512, 512) block", block, local=True)
                del block
            else:
                del op
            torch.cuda.empty_cache()
    if wanted("stored"):
        # B12 on the solves' stored operators, built as chip_smoke.py's phase 3
        # builds them from the 512^3 tensor field: the 19-plane stored DCA
        # operator, level 1 of the exact Galerkin hierarchy (117 planes) and
        # its collapse (27 planes; bit for bit the collapsed hierarchy's level
        # 1), the exact hierarchy's level 2 (125 planes at 128^3), level 1
        # pruned at 1e-3 (``galerkin_prune_tol``), and one rank's (128, 256,
        # 256) block of the collapsed level through the shard-local form
        from ..core.grids import CELL
        from ..core.stencil import StencilOperator
        from ..ops import compressed, dca, galerkin
        from .phantom import spd_tensor_field

        t = spd_tensor_field((512,) * 3, torch.Generator(device="cuda").manual_seed(0))
        stencil_cases("stored", "512^3 DCA", dca.assemble_dca(t, (1.0,) * 3, 0.1))
        op0 = compressed.assemble_compressed_dca(t, (1.0,) * 3, 0.1)
        del t
        exact = galerkin.assemble_galerkin_parabolic(op0, (CELL,) * 3)
        del op0
        torch.cuda.empty_cache()
        collapsed = galerkin.collapse_to_radius1(exact)
        stencil_cases("stored", "256^3 collapsed", collapsed)
        block = StencilOperator(collapsed.coeffs[:, :128].contiguous(), collapsed.offsets)
        del collapsed
        stencil_cases("stored_local", "(128, 256, 256) block", block, local=True)
        del block
        stencil_cases("stored", "256^3 exact", exact)
        stencil_cases("stored", "256^3 exact pruned 1e-3",
                      galerkin.prune_stored_operator(exact, 1e-3))
        level2 = galerkin.assemble_galerkin_parabolic(exact, (CELL,) * 3)
        del exact
        torch.cuda.empty_cache()
        stencil_cases("stored", "128^3 exact", level2)
        del level2
        torch.cuda.empty_cache()
    if wanted("2d_stored"):
        # B13's stored form: the 9-plane stored DCA operator
        from ..ops import dca
        from .phantom import spd_tensor_field

        for shape, spacing in (((8192, 8192), (1.0, 1.0)), ((1531, 997), (1.0, 0.7))):
            t = spd_tensor_field(shape, torch.Generator(device="cuda").manual_seed(1))
            stencil_cases("2d_stored", f"{shape[0]}x{shape[1]}", dca.assemble_dca(t, spacing, 0.1))
            del t
    for dtype in (torch.float32, torch.bfloat16):
        if wanted("conv_z") or wanted("conv_y") or wanted("conv_x"):
            axis_cases(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        if wanted("fd_"):
            fd_cases(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        if hv is not None and wanted("hessian_vesselness"):
            hv_cases(dtype)
    print(json.dumps({"cases": cases}))
    if failed:
        print(f"FAILED against the plain versions: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
