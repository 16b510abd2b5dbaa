"""Hand-written Hopper kernels for the port's compute hot spots.

Each kernel ships as
  * ``csrc/<name>.cu`` — CUDA C++ for sm_90a with a plain C interface, built
    by ``_build.py`` with nvcc at the first CUDA launch;
  * ``<name>.py``      — the wrapper (checks, output allocation, launch on the
    current stream, a ``launches`` counter) and the plain PyTorch version;
  * ``ops.py``         — the public entry the model code calls;
  * ``ref.py``         — the plain versions under the reference's oracle names.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
