"""thermal_host_ms_per_call: host time of the program's span
``repro_torch.thermal`` (the thermal grid's host loop, ``dse/thermal_torch.py``
``peak_temperature_grid``), per call (profiler trace; the span is live only
while the profiler records)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("repro_torch.thermal", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
