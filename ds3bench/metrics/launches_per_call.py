"""launches_per_call: kernels the device ran in the traced window, per call
(profiler trace)."""


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.kernels:
        return None
    return len(t.kernels) / t.calls
