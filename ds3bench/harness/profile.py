"""Reduces a ``torch.profiler`` trace (its Chrome JSON export) to what the
per-layer metrics read: the device's kernels and copies, the benchmark's
own host spans, the device's busy time over the traced window and the idle
gaps labelled by what the host was doing.

Device operations are the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the window runs from the start of the first call span
(``ds3bench.call``) to the end of the last.  An idle gap is a stretch of the
window in which no device operation runs; it is labelled by the innermost
host event (an operator, a runtime call or a span) in flight at its middle.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import json
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
CALL_SPAN = "ds3bench.call"
K1_NAME = "epoch_scan_kernel"


@dataclasses.dataclass
class Summary:
    calls: int                              # call spans in the window
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]        # (name, seconds), in order
    copies: List[Tuple[str, float]]         # memcpy and memset
    spans: Dict[str, List[float]]           # host span name -> seconds each
    idle_gaps: List[Tuple[str, float]]      # (host label, seconds) each

    def device_ops(self, top: int = 10) -> List[List]:
        by = collections.Counter()
        for name, s in self.kernels + self.copies:
            by[name] += s
        return [[n, s] for n, s in by.most_common(top)]

    def gaps_by_label(self, top: int = 10) -> List[List]:
        by = collections.Counter()
        for name, s in self.idle_gaps:
            by[name] += s
        return [[n, s] for n, s in by.most_common(top)]

    def k1_seconds(self) -> List[float]:
        return [s for n, s in self.kernels if K1_NAME in n]


def _union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _labels(host: List[Tuple[float, float, str]],
            times: Sequence[float]) -> List[str]:
    """For each of the ascending ``times``, the host event in flight that
    started last (the innermost of nested events), by a sweep over the
    events in order of start."""
    host = sorted(host)
    active: List[Tuple[float, float, str]] = []     # (-start, end, name)
    out, i = [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else "host: no operator")
    return out


def summarize(events: Sequence[dict]) -> Summary:
    """``events``: the ``traceEvents`` of a Chrome trace (times in us)."""
    dev, host, spans = [], [], collections.defaultdict(list)
    calls = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], cat))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
            if cat == "user_annotation":
                spans[e["name"]].append(dur * 1e-6)
                if e["name"] == CALL_SPAN:
                    calls.append((ts, ts + dur))
    if not calls:
        return Summary(0, 0.0, 0.0, [], [], dict(spans), [])
    w0, w1 = min(a for a, _ in calls), max(b for _, b in calls)
    inside = sorted(d for d in dev if d[1] > w0 and d[0] < w1)
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in inside])
    holes, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            holes.append((t, a))
        t = max(t, b)
    labels = _labels(host, [(a + b) / 2 for a, b in holes])
    gaps = [(n, (b - a) * 1e-6) for n, (a, b) in zip(labels, holes)]
    return Summary(
        calls=len(calls), window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels=[(n, (b - a) * 1e-6) for a, b, n, c in inside if c == "kernel"],
        copies=[(n, (b - a) * 1e-6) for a, b, n, c in inside if c != "kernel"],
        spans=dict(spans), idle_gaps=gaps)


def read_trace(path) -> Summary:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize(events)
