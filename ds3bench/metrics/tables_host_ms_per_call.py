"""tables_host_ms_per_call: host time of the program's span
``repro_torch.tables`` (the designs' tables built, stacked and moved to the
card: ``sweep``'s ``_design_lanes`` and ``dse.build_design_batch``), per call
(profiler trace; the span is live only while the profiler records)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("repro_torch.tables", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
