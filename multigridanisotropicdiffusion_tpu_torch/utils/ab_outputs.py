"""Save the main paths' outputs of one tree, and compare two trees'.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.ab_outputs run DIR
    python -m multigridanisotropicdiffusion_tpu_torch.utils.ab_outputs compare DIR_A DIR_B

``run`` drives, on one CUDA card, the MAD 512^3 solve (``MADConfig.cuda(
time_step=0.1, tolerance=1e-6)`` on ``phantom.spd_tensor_field`` and b
uniform in [0, 255), from seed 0 on the device, as ``chip_smoke.py``'s
phase 5) and the VED 512^3 call (``VEDConfig.cuda()`` on the tube phantom
from seed 1, and the same call with ``hessian_mode="gaussian_derivative"``),
and writes into DIR: the outputs (``mad.pt``, ``ved.pt``, ``ved_gd.pt``), the first outer
iteration's vesselness and tensor (``fused_vesselness_tensor`` on the input
volume: ``first_resp.pt``, ``first_tensor.pt``), the same for the
reference-faithful Hessian (``VEDConfig.cuda(hessian_mode=
"gaussian_derivative")``: ``gd_first_resp.pt``, ``gd_first_tensor.pt``),
the Galerkin solves of the MAD 512^3 inputs (``coarse_operator=
"galerkin"``, collapsed and exact: ``gal_collapsed.pt``, ``gal_exact.pt``),
the collapsed Galerkin 8192^2 solve (``spd_tensor_field`` and b from seed
0, as ``chip_smoke.py``'s phase 8: ``gal2d_collapsed.pt``), and
``summary.json`` with each solve's cycles and relative residual history,
each VED call's last solve's, and a SHA-256 of each saved tensor's bytes.
``compare`` prints, for two such directories, whether the cycle counts agree, the residual histories,
whether each hash agrees and the relative L2 difference of each tensor, as
one JSON line.  Two trees are compared by running ``run`` in each: copies
of this script and of ``utils/phantom.py`` in an older tree run that tree's
kernels (the script imports only modules the package has had since its
Galerkin levels and VED kernels).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import torch

SHAPE = (512, 512, 512)
SOLVES = ("mad", "gal_collapsed", "gal_exact", "gal2d_collapsed")
VEDS = ("ved", "ved_gd")
NAMES = SOLVES + VEDS + ("first_resp", "first_tensor", "gd_first_resp", "gd_first_tensor")


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def run(out_dir: str) -> dict:
    from .. import MADConfig, VEDConfig, mad_diffusion, ved
    from ..models.ved import _auto_z_slab, fused_vesselness_tensor
    from .phantom import spd_tensor_field, tube_phantom

    os.makedirs(out_dir, exist_ok=True)
    summary = {"device": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    tensor = spd_tensor_field(SHAPE, gen)
    b = torch.rand(SHAPE, generator=gen, device="cuda") * 255.0
    outs = {}

    def solve(key, b, tensor, **kw):
        res = mad_diffusion(b, tensor, config=MADConfig.cuda(time_step=0.1, tolerance=1e-6,
                                                             **kw), device="cuda")
        n = int(res.num_cycles[0])
        summary[key] = {"cycles": res.num_cycles.tolist(),
                        "history": res.residual_history[0, :n].tolist()}
        outs[key] = res.output

    solve("mad", b, tensor)
    solve("gal_collapsed", b, tensor, coarse_operator="galerkin")
    solve("gal_exact", b, tensor, coarse_operator="galerkin", galerkin_variant="exact")
    del tensor, b
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tensor = spd_tensor_field((8192, 8192), gen)
    b = torch.rand((8192, 8192), generator=gen, device="cuda") * 255.0
    solve("gal2d_collapsed", b, tensor, coarse_operator="galerkin")
    del tensor, b
    torch.cuda.empty_cache()
    vol = tube_phantom(SHAPE, torch.Generator(device="cuda").manual_seed(1))
    cfg = VEDConfig.cuda()
    for prefix, c in (("", cfg), ("gd_", VEDConfig.cuda(hessian_mode="gaussian_derivative"))):
        resp, tens = fused_vesselness_tensor(
            vol, tuple(c.scales), (1.0,) * 3, c.alpha, c.beta, c.gamma, c.epsilon,
            c.omega, c.sensitivity, z_slab=_auto_z_slab(SHAPE, c.pipeline_z_slab),
            hessian_mode=c.hessian_mode, pipeline_dtype=c.pipeline_dtype,
            use_kernels=c.use_kernels)
        outs[f"{prefix}first_resp"], outs[f"{prefix}first_tensor"] = resp, tens
        del resp, tens
    for key, c in zip(VEDS, (cfg, VEDConfig.cuda(hessian_mode="gaussian_derivative"))):
        res = ved(vol, config=c, device="cuda")
        d = res.diffusion
        summary[f"{key}_last_solve"] = {
            "cycles": d.num_cycles.tolist(),
            "history": [d.residual_history[s, :int(n)].tolist()
                        for s, n in enumerate(d.num_cycles.tolist())]}
        outs[key] = res.output
        del res, d
    torch.cuda.synchronize()
    summary["sha256"] = {k: _sha256(v) for k, v in outs.items()}
    for k, v in outs.items():
        torch.save(v.cpu(), os.path.join(out_dir, f"{k}.pt"))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    return summary


def compare(dir_a: str, dir_b: str) -> dict:
    sums = []
    for d in (dir_a, dir_b):
        with open(os.path.join(d, "summary.json")) as f:
            sums.append(json.load(f))
    keys = SOLVES + tuple(f"{k}_last_solve" for k in VEDS)
    row = {"same_cycles": {k: sums[0][k]["cycles"] == sums[1][k]["cycles"] for k in keys},
           "history": {k: [s[k]["history"] for s in sums] for k in keys},
           "same_hash": {k: sums[0]["sha256"][k] == sums[1]["sha256"][k] for k in NAMES},
           "rel_l2": {}}
    for k in NAMES:
        a, b = (torch.load(os.path.join(d, f"{k}.pt")).double() for d in (dir_a, dir_b))
        row["rel_l2"][k] = ((a - b).norm() / b.norm()).item()
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "run":
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(run(argv[1])))
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        print(json.dumps(compare(argv[1], argv[2])))
        return 0
    print(__doc__.split("\n\n")[1], file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
