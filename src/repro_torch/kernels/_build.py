"""Builds the CUDA sources of ``csrc/`` with ``nvcc`` and loads them with ctypes.

Nothing happens at import: the first CUDA launch of any kernel calls
:func:`load`, which compiles EVERY source of ``csrc/`` that has no up-to-date
library yet (one ``nvcc`` per source, all started together) into
``build/repro_torch_kernels/`` at the root of the checkout, then opens the one
it was asked for.  The sources have a plain C interface (no PyTorch headers),
so a build takes seconds.  Libraries are named by a hash of their source, the
shared headers and the flags: an edited source is rebuilt, an unchanged one is reused.

A failed build raises with the compiler's output; nothing falls back.
``REPRO_TORCH_BUILD_DIR`` moves the build directory, ``NVCC`` names the
compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        cand = str(Path(home) / "bin" / "nvcc")
    if shutil.which(cand) is None:
        raise RuntimeError(f"nvcc not found (tried {cand!r}); the CUDA kernels "
                           "of repro_torch are built from source at first use")
    return cand


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # headers are shared
        h.update(header.read_bytes())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every stale source of ``csrc/`` in parallel; name -> library."""
    out = {src.stem: _lib_path(src) for src in sources()}
    todo = [src for src in sources() if not out[src.stem].exists()]
    if not todo:
        return out
    compiler = nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out[src.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [compiler, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out[src.stem])       # atomic: no half-written library
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built now if need be)."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build_all()[name]))
    return lib
