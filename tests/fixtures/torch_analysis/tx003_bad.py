"""TX003 fixtures — effects at import (all bad)."""
import os
import subprocess

import triton                                  # TX003 triton at import

from repro_torch.kernels import _build

os.environ["CUDA_LAUNCH_BLOCKING"] = "1"       # TX003 environment write
LIB = _build.load("flash_attention")           # TX003 build at import
NVCC = subprocess.run(["nvcc", "--version"])   # TX003 a process at import


def load_all(names):
    return [_build.load(n) for n in names]     # TX003 a build in a loop
