"""``utils/sass_count.py``: the SASS parser and its counts on a small dump,
and the standalone math-library kernels of ``--math`` (no toolkit needed)."""

import re

from multigridanisotropicdiffusion_tpu_torch.utils import sass_count

# cuobjdump -sass layout: a load, a loop of two float instructions, a call
# of a subroutine placed after the kernel's exit
DUMP = """
        Function : k
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;     /* 0x0000000402027981 */
        /*0010*/                   FFMA R0, R2, R2, 1 ;              /* 0x3f80000002007423 */
        /*0020*/                   FADD R0, R0, 1 ;                  /* 0x3f80000000007421 */
        /*0030*/               @P0 BRA 0x10 ;                       /* 0xfffffffffff40947 */
        /*0040*/                   CALL.REL.NOINC 0x70 ;             /* 0x0000000000087944 */
        /*0050*/                   STG.E desc[UR4][R4.64], R0 ;     /* 0x0000000004007986 */
        /*0060*/                   EXIT ;                            /* 0x000000000000794d */
        /*0070*/                   MUFU.RCP R1, R2 ;                 /* 0x0000000200017308 */
        /*0080*/                   RET.REL.NODEC R20 0x0 ;           /* 0xfffffff814dc7950 */
"""


def test_counts_the_body_and_its_loops():
    """The body stops at the subroutine; the loop is the FFMA and FADD up to
    the backward branch; an FFMA counts two operations."""
    (name, insns), = sass_count.parse(DUMP).items()
    assert name == "k" and len(insns) == 9
    got = sass_count.summarize(insns)
    assert got["all"]["total"] == 9 and got["all"]["mufu"] == 1
    body = got["body"]
    assert (body["total"], body["float"], body["ops"], body["load"], body["store"],
            body["branch"], body["mufu"]) == (7, 2, 3, 1, 1, 3, 0)
    (loop,) = got["loops"]
    assert (loop["from"], loop["to"], loop["total"], loop["ops"]) == ("0x10", "0x30", 3, 3)


def test_math_source_has_one_kernel_per_call():
    """``--math`` compiles one extern "C" kernel per entry of MATH_CALLS,
    each storing its call."""
    src = sass_count.math_source()
    names = re.findall(r'extern "C" __global__ void (\w+)\(', src)
    assert names == list(sass_count.MATH_CALLS)
    for expr in sass_count.MATH_CALLS.values():
        assert f"= {expr};" in src
