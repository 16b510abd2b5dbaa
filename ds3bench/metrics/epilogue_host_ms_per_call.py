"""epilogue_host_ms_per_call: host time of the program's span
``repro_torch.epilogue`` (latency, energy and per-PE busy time from K1's
schedules, ``core/simkernel_torch.py`` ``_epilogue``), per call (profiler
trace; the span is live only while the profiler records)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("repro_torch.epilogue", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
