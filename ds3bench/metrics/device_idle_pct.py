"""device_idle_pct: the share of the traced window in which no kernel or
copy ran on the card, in percent (profiler trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
