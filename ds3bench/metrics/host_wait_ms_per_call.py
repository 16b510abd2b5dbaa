"""host_wait_ms_per_call: host time of the program's span ``repro_torch.wait``
(the host blocked on the card before the answers are copied to it), per call
(profiler trace; the span is live only while the profiler records)."""


def read(run):
    t = run.trace
    spans = [] if t is None else t.spans.get("repro_torch.wait", [])
    if not spans or not t.calls:
        return None
    return 1e3 * sum(spans) / t.calls
