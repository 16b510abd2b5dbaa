"""entry_self_ms_per_call: host time of the program's outermost public calls
(span ``repro_torch.entry``: ``sweep``, ``evaluate``, ``build_design_batch``)
less the five layer spans inside them (tables, K1's wrapper, the epilogue,
the thermal grid, the wait on the card): the entry's own time, per call
(profiler trace; the spans are live only while the profiler records)."""

LAYERS = ("repro_torch.tables", "repro_torch.k1", "repro_torch.epilogue",
          "repro_torch.thermal", "repro_torch.wait")


def read(run):
    t = run.trace
    entry = [] if t is None else t.spans.get("repro_torch.entry", [])
    if not entry or not t.calls:
        return None
    inner = sum(sum(t.spans.get(n, [])) for n in LAYERS)
    return 1e3 * (sum(entry) - inner) / t.calls
