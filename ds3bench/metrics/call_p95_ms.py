"""call_p95_ms: the 95th percentile (linear between order statistics) of
the wall time of every call in the window, from the call to its answers as
numpy arrays on the host after a device synchronise (host clock)."""
import numpy as np


def read(run):
    if not run.calls:
        return None
    return 1e3 * float(np.percentile([c.seconds for c in run.calls], 95))
