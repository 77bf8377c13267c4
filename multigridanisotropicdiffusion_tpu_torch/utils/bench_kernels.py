"""Time the transfer kernels (B3, B4) and the fused y+x Gaussian (B7) at
the main path's shapes, on one CUDA card.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.bench_kernels [--check-only]

Cases, float32 and bfloat16 storage, inputs made on the device from seed 0:

* ``restrict3d``: 512^3 -> 256^3, all cell-centred (the solve's level 0);
* ``prolong3d``: 256^3 -> 512^3, ``P e``;
* ``correction``: the V-cycle's ``x + P e`` at 512^3, as ``x +
  cuda_prolong(e)`` (two launches) and, where the package has it, as one
  launch of the add form ``cuda_prolong_add``;
* ``conv_yx``: 514 planes of 512^2 (a 512^3 volume's smoothed field with
  its two FD halo planes), the tube phantom, with each of the VED's five
  scales' Gaussian taps at unit spacing (r = 2, 2, 4, 5, 8);
* ``fill_``: a plain write of a 512^3 field, what the card's memory takes
  for the bytes the prolongation writes (a yardstick, not a kernel of the
  package).

Each case is first held against its plain version (float32 within 1e-5 of
max|plain|, bf16 within one bf16 ulp of each value, floored at that; the
add form bit for bit ``x + cuda_prolong(e)``).  Then, unless
``--check-only``, the median of 20 CUDA-event timings of 10 back-to-back
calls each (per call) after a warm-up, with
the least time the card could take for the bytes moved (each input read
once, each output written once, at 3.35 TB/s).  Prints the card's name and
power limit, one line per case, and a last line ``{"cases": [...]}``.
Exits 1 if a check fails or there is no card.

The script imports only what every version of the package since the first
transfer kernels has (``ops.cuda_transfer``, ``ops.cuda_conv``,
``ops.transfer``, ``ops.hessian``, ``utils.phantom``), so a copy of it in an
older tree times that tree's kernels: two trees are compared in one call by
running it in each, in turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
SIGMAS = (0.3, 0.482, 0.775, 1.245, 2.0)


def _median_ms(fn, reps=20, burst=10):
    """Median over ``reps`` CUDA-event timings of ``burst`` back-to-back
    calls, per call: the wrapper's host time overlaps the card's work."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check-only", action="store_true",
                        help="hold each case against its plain version, time nothing")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ..ops import cuda_conv, cuda_transfer, transfer
    from ..ops.hessian import gaussian_kernels_1d
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

    def case(name, dtype, fn, want, nbytes, same=None):
        got = fn()
        err = 0.0 if same is not None and torch.equal(got, same) else (
            None if same is not None else _max_err(got, want))
        del got
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if err is None:
            failed.append(name)
        elif not args.check_only:
            row["ms"] = _median_ms(fn)
        cases.append(row)
        print(json.dumps(row), flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        item = torch.finfo(dtype).bits // 8
        x, e = fine32.to(dtype), coarse32.to(dtype)
        cells = x.numel()
        case("restrict3d", dtype, lambda: cuda_transfer.cuda_restrict(x, cent),
             transfer.restrict_plain(x, cent), (1 + 1 / 8) * cells * item)
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
    print(json.dumps({"cases": cases}))
    if failed:
        print(f"FAILED against the plain versions: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
