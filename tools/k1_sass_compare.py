#!/usr/bin/env python3
"""Compare K1's compiled kernels (``csrc/epoch_scan.cu``) of two source trees.

    python3 tools/k1_sass_compare.py OTHER_SRC [SRC]

Compiles K1's sources of both trees (``SRC`` defaults to this checkout's
``src``) with the port's own ``nvcc`` flags into a scratch directory under
``build/``, and prints, per kernel instantiation of each: ptxas's registers,
stack and spill bytes, and the SASS's counts of all instructions, FMUL+FADD,
FFMA and DFMA.  An instantiation found in both trees under the same template
arguments (a tree without faults names ``epoch_scan_kernel<DTPM>``, one with
them ``epoch_scan_kernel<DTPM, FAULTS>``, built from ``epoch_scan.cu`` and
``epoch_scan_faults.cu``, one with the live window
``epoch_scan_kernel<DTPM, FAULTS, WINDOWED>``: a missing argument is false,
so ``<false>`` pairs with ``<false, false>`` and ``<false, false, false>``) is
compared instruction by instruction, addresses and encodings dropped, the
constant-bank offsets of the kernel's parameters kept; the
script prints whether the two are the same and, if not, the first lines that
differ.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no GPU.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def compile_tree(src: Path, out: Path, flags):
    """ptxas's report and the SASS of the tree's epoch_scan*.cu."""
    csrc = src / "repro_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tool = Path(nvcc).parent / "cuobjdump"
    report, sass = "", ""
    for cu in sorted(csrc.glob("epoch_scan*.cu")):
        lib = out / f"lib{cu.stem}.so"
        rep = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", str(lib), str(cu)],
                             capture_output=True, text=True, check=True)
        report += rep.stdout + rep.stderr
        sass += subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                               text=True, check=True).stdout
    return report, sass


def variant(name: str):
    """(DTPM, FAULTS, WINDOWED) of a mangled epoch_scan_kernel name, or None
    (a missing argument is false)."""
    m = re.search(r"epoch_scan_kernelILb([01])E(?:Lb([01])E)?(?:Lb([01])E)?", name)
    if not m:
        return None
    return tuple(bool(int(g or 0)) for g in m.groups())


def ptxas_usage(report: str) -> dict:
    """(DTPM, FAULTS, WINDOWED) -> registers, stack and spill bytes from
    -Xptxas -v."""
    out, current = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = variant(line)
        elif current is not None and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out.setdefault(current, {})["stack_spill_bytes"] = nums
        elif current is not None and "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def sass_kernels(sass: str) -> dict:
    """(DTPM, FAULTS, WINDOWED) -> the kernel's instructions, addresses
    dropped."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, *lines = part.splitlines()
        key = variant(name)
        if key is None:
            continue
        ins = []
        for ln in lines:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?;)", ln)
            if m:
                ins.append(re.sub(r"\s+", " ", m.group(1)).strip())
        out[key] = ins
    return out


def name(key) -> str:
    return f"<DTPM={key[0]}, FAULTS={key[1]}, WINDOWED={key[2]}>"


def opcode(ins: str) -> str:
    """The opcode of one SASS instruction (its predicate dropped)."""
    words = ins.split()
    return words[1] if words[0].startswith("@") and len(words) > 1 else words[0]


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    trees = [Path(sys.argv[1]).resolve(), Path(sys.argv[2] if len(sys.argv) > 2
                                               else ROOT / "src").resolve()]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import NVCC_FLAGS
    found = []
    for k, tree in enumerate(trees):
        report, sass = compile_tree(tree, ROOT / "build" / f"k1_sass_compare_{k}",
                                    NVCC_FLAGS)
        usage, kernels = ptxas_usage(report), sass_kernels(sass)
        found.append(kernels)
        for key in sorted(kernels):
            ops = [opcode(i) for i in kernels[key]]
            n = {op: sum(o.startswith(op) for o in ops)
                 for op in ("FMUL", "FADD", "FFMA", "DFMA")}
            print(f"{tree}: {name(key)}: {len(ops)} "
                  f"instructions, {n['FMUL'] + n['FADD']} FMUL/FADD, "
                  f"{n['FFMA']} FFMA, {n['DFMA']} DFMA; ptxas {usage.get(key, {})}")
    for key in sorted(set(found[0]) & set(found[1])):
        a, b = found[0][key], found[1][key]
        if a == b:
            print(f"{name(key)}: the same {len(a)} "
                  "instructions in both trees")
            continue
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        print(f"{name(key)}: DIFFERENT ({len(a)} vs "
              f"{len(b)} instructions; first difference at {first}: "
              f"{a[first:first + 3]} vs {b[first:first + 3]})")


if __name__ == "__main__":
    main()
