"""k1_ms_per_call: device time of the epoch-scan kernel (K1, every
instantiation of ``epoch_scan_kernel``), per call (profiler trace)."""


def read(run):
    t = run.trace
    k1 = [] if t is None else t.k1_seconds()
    if not k1 or not t.calls:
        return None
    return 1e3 * sum(k1) / t.calls
