"""tables_ms_per_call: host time of the benchmark's span around its call of
``repro_torch.dse.build_design_batch`` (the designs' tables built, stacked
and copied to the card), per call (profiler trace)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("ds3bench.tables", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
