"""KL001 fixtures — every path to a launch refuses grad first (clean)."""
import torch

from repro_torch.kernels import _build

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        _lib = _build.load("toy")
    return _lib.repro_toy, _lib.repro_toy_error


def _launch(x, out):
    fn, err = _kernel()
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel())
    if rc != 0:
        raise RuntimeError(err(rc))
    return out


def toy(x, out):
    if x.device.type == "cpu":
        return out.copy_(x)
    _build.refuse_grad("toy", x)
    return _launch(x, out)


@torch.no_grad()
def toy_serving(x, out):
    return _launch(x, out)                     # under no_grad: nothing to refuse


def toy_block(x, out):
    with torch.no_grad():
        return _launch(x, out)


def info():
    lib = _build.load("toy")
    return lib.repro_toy_info(0)               # a query: no data_ptr, no launch
