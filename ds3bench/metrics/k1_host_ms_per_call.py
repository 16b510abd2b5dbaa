"""k1_host_ms_per_call: host time of the program's span ``repro_torch.k1``
(K1's wrapper, ``kernels/epoch_scan.py`` ``epoch_scan``: its checks, host
reads, table preparation and the launch), per call (profiler trace; the span
is live only while the profiler records)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("repro_torch.k1", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
