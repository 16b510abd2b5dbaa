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
compiler.  :func:`refuse_grad` is the check every wrapper makes before a
launch: a kernel has no backward.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise while autograd is recording and a floating input requires grad.

    A launch writes a fresh output that autograd knows nothing of, so a loss
    taken through it would backpropagate without error and give no gradient
    to what reaches it only through the kernel.  None of the kernels has a
    backward (nor has any TPU kernel they port); training runs
    ``attn_impl="blocked"``, as the reference does."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward (no TPU original has "
            "one) and an input requires grad; training runs "
            "attn_impl='blocked', as the reference does, and serving calls "
            "the kernel under torch.no_grad()")


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
