"""Count the SASS instructions of the package's kernels by class.

    python -m multigridanisotropicdiffusion_tpu_torch.utils.sass_count \\
        [--lib PATH | --sass FILE | --math] [--kernel SUBSTRING ...]

Reads ``cuobjdump -sass`` of the built kernel library (``--lib``, default
the current sources' build, built if needed; needs the CUDA toolkit) or a
saved dump of it (``--sass``), and prints one JSON line per kernel whose
mangled name contains every ``--kernel`` substring: its static instruction
count, and the counts by class of

* ``body``: the kernel's code before the first subroutine that it calls,
  i.e. without the out-of-line slow paths (the IEEE division's and
  reciprocal's) placed after it; it keeps the branches around them and
  the math library's inline code for rare arguments (cosf's reduction of
  large arguments);
* ``loops``: each loop in that body (from a backward branch's target to
  the branch), outermost first: the work of one iteration where a kernel
  marches over planes (``bar`` counts its barriers, which tell a plane
  loop of a block that shares a tile from a per-thread loop).

With ``--math`` it compiles, with the package's nvcc flags, one
standalone float kernel per math-library call that B8's formulas make
(``MATH_CALLS``: ``expf``, ``acosf``, ``cosf``, ``sqrtf``, the correctly
rounded reciprocal and the IEEE division) and counts each, so that a bound
can count each call by what it compiles to, apart from any one kernel's
build.  A standalone call's ``body`` holds its load, its store and the
call; the division's and the square root's slow paths are subroutines
outside it, cosf's reduction of large arguments is inline and counted.

Classes: ``float`` (FADD, FMUL, FFMA, FMNMX, FSEL, FSETP, FCHK, F2F and
the other F-prefixed ALU operations), ``mufu`` (MUFU: the special-function
unit's reciprocal, square root, exp2, ...), ``int`` (integer and address
arithmetic, moves, predicates and conversions), ``load`` (LDG, LDS, LDL,
LDC), ``store`` (STG, STS, STL), ``branch`` (BRA, BSSY, BSYNC, CALL, RET,
EXIT, BAR, WARPSYNC), ``other``; ``ops`` is the float operations as the
67 TFLOP/s peak counts them (FFMA twice, every other float ALU instruction
once).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys

_FUNC = re.compile(r"\s+Function : (\S+)")
_INSN = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)\s*(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")

BRANCH = {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "WARPSYNC", "BREAK", "BRX",
          "JMP", "YIELD", "NANOSLEEP"}
LOAD = {"LDG", "LDS", "LDL", "LDC", "LD", "LDSM", "ULDC"}
STORE = {"STG", "STS", "STL", "ST", "RED", "ATOM", "ATOMS", "ATOMG"}


#: kernel name -> the float expression of one standalone call on x (and y)
MATH_CALLS = {
    "math_expf": "expf(x)",
    "math_acosf": "acosf(x)",
    "math_cosf": "cosf(x)",
    "math_sqrtf": "sqrtf(x)",
    "math_rcp": "__frcp_rn(x)",
    "math_div": "__fdiv_rn(x, y)",
}


def math_source() -> str:
    return "".join(
        f'extern "C" __global__ void {name}(const float* a, float* out) {{\n'
        f"  const float x = a[threadIdx.x], y = a[threadIdx.x + blockDim.x];\n"
        f"  out[threadIdx.x] = {expr};\n}}\n"
        for name, expr in MATH_CALLS.items())


def compile_math() -> str:
    """Builds ``MATH_CALLS`` into a cubin in the package's build directory
    and returns its path."""
    from .build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, out = BUILD_DIR / "math_calls.cu", BUILD_DIR / "math_calls.cubin"
    src.write_text(math_source())
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-cubin", "-o", str(out), str(src)],
                   capture_output=True, text=True, check=True)
    return str(out)


def classify(op: str) -> str:
    if op == "MUFU":
        return "mufu"
    if op in BRANCH:
        return "branch"
    if op in LOAD:
        return "load"
    if op in STORE:
        return "store"
    if op.startswith(("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK", "FRND",
                      "F2F", "FSET", "FSWZ", "HADD2", "HMUL2", "HFMA2", "DADD", "DMUL",
                      "DFMA", "DSETP")):
        return "float"
    if op == "NOP":
        return "other"
    return "int"


def parse(text: str):
    """{kernel name: [(offset, opcode, operands)]}."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(5)))
    return kernels


def _target(args):
    m = _TARGET.search(args)
    return int(m.group(1), 16) if m else None


def _counts(insns):
    c = collections.Counter(classify(op) for _, op, _ in insns)
    ops = sum(2 if op in ("FFMA", "DFMA") else 1
              for _, op, _ in insns if classify(op) == "float")
    return {"total": len(insns), **{k: c.get(k, 0) for k in
                                    ("float", "mufu", "int", "load", "store", "branch",
                                     "other")}, "ops": ops,
            "bar": sum(op == "BAR" for _, op, _ in insns)}


def summarize(insns):
    """Static counts of a kernel: all of it, its body and each loop."""
    calls = [_target(args) for _, op, args in insns if op == "CALL"]
    first_sub = min([t for t in calls if t is not None], default=None)
    body = [i for i in insns if first_sub is None or i[0] < first_sub]
    index = {off: n for n, (off, _, _) in enumerate(body)}
    loops = []
    for n, (off, op, args) in enumerate(body):
        t = _target(args) if op == "BRA" else None
        if t is not None and t < off and t in index:
            loops.append((index[t], n + 1))
    loops.sort(key=lambda se: (se[0], -se[1]))
    return {"all": _counts(insns), "body": _counts(body),
            "loops": [{"from": hex(body[a][0]), "to": hex(body[b - 1][0]), **_counts(body[a:b])}
                      for a, b in loops]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lib", help="the kernel library (default: the current build)")
    parser.add_argument("--sass", help="a saved cuobjdump -sass dump instead")
    parser.add_argument("--math", action="store_true",
                        help="count standalone math-library calls (MATH_CALLS) instead")
    parser.add_argument("--kernel", action="append", default=[],
                        help="substring of the mangled kernel name (all must match)")
    args = parser.parse_args(argv)
    if args.sass:
        with open(args.sass) as f:
            text = f.read()
    else:
        from .build import build, find_nvcc

        lib = compile_math() if args.math else args.lib or str(build())
        cuobjdump = find_nvcc().rsplit("/", 1)[0] + "/cuobjdump"
        text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
    found = False
    for name, insns in parse(text).items():
        if all(k in name for k in args.kernel):
            found = True
            print(json.dumps({"kernel": name, **summarize(insns)}))
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
