"""setup_s: the process's start to the first timed call: imports, the CUDA
context, the epoch-scan library built or loaded, the inputs made, one warm
call (host clock)."""


def read(run):
    return run.setup_s
