"""other_kernels_ms_per_call: device time of every kernel and copy but the
epoch scan (K1), per call: the epilogue, the thermal grid, the stacking and
the copies (profiler trace)."""
from ds3bench.harness.profile import K1_NAME


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    other = [s for n, s in t.kernels if K1_NAME not in n]
    other += [s for _, s in t.copies]
    if not other:
        return None
    return 1e3 * sum(other) / t.calls
