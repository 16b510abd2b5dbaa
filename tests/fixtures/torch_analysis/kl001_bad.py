"""KL001 fixtures — launches without refuse_grad (all bad)."""
from repro_torch.kernels import _build

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        _lib = _build.load("toy")
    return _lib.repro_toy


def _launch(x, out):
    fn = _kernel()
    return fn(x.data_ptr(), out.data_ptr(), x.numel())


def toy(x, out):                               # KL001 no refuse_grad
    return _launch(x, out)


def toy_late(x, out):                          # KL001 refuse_grad after
    rc = _launch(x, out)
    _build.refuse_grad("toy", x)
    return rc


def toy_direct(x, out):                        # KL001 a launch of its own
    lib = _build.load("toy")
    return lib.repro_toy(x.data_ptr(), out.data_ptr())
