"""k1_roofline: the least time of the traced calls' epoch-scan launches
(their bytes at the H100's 3.35 TB/s, ``harness/k1bytes.py``, from the
cell's shapes) over K1's device time, in percent (profiler trace)."""


def read(run):
    t = run.trace
    k1 = [] if t is None else t.k1_seconds()
    launches = [l for c in run.calls for l in c.launches]
    if not k1 or len(k1) != len(launches):
        return None
    return 100.0 * sum(l.bound_s for l in launches) / sum(k1)
