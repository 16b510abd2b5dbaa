"""Chrome trace-event JSON (Perfetto-loadable) schedule traces, on the port.

The twin of ``src/repro/obs/trace.py`` (JAX-free there too, re-homed here).
:func:`chrome_trace` serialises an event-heap :class:`SimResult`
(``core.simkernel_ref``, the ``backend="ref"`` kernel) to the Chrome
trace-event format (https://ui.perfetto.dev loads it directly); only that
kernel keeps per-task records, so a trace is a host tool in both packages:

* one *thread* track per PE (``tid`` = PE id) carrying matched ``B``/``E``
  duration events per committed task — args record the decision epoch
  (ready), job/task ids and the DVFS frequency latched at dispatch — plus an
  instant (``ph: "i"``) marker at each task's ready time;
* *counter* tracks (``ph: "C"``) per sampling window from an optional
  :class:`~repro_torch.obs.telemetry.Telemetry`: per-cluster frequency (GHz),
  per-cluster utilisation, per-node temperature (°C).

All timestamps are microseconds (the simulator's native unit — trace-event
``ts`` is defined in µs).  :func:`validate_chrome_trace` checks the schema
invariants the tests pin: required keys, non-decreasing ``ts``, matched
``B``/``E`` pairs per track.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

TRACE_PID = 0
_PH_ORDER = {"E": 0, "B": 1, "i": 2, "C": 3}   # equal-ts tie-break: close
                                               # the previous slice first


def chrome_trace(db, result, apps: Optional[Sequence] = None,
                 trace=None, telemetry=None, failures=None,
                 label: str = "repro-soc") -> Dict:
    """Build the trace-event dict for one reference run.

    ``apps``/``trace`` (the Application list and JobTrace) are optional and
    only used to resolve human-readable task names; without them tasks are
    labelled ``j<job>.t<task>``.  ``telemetry`` adds the counter tracks.
    ``failures`` (the scenario's fail-stop specs, DESIGN.md §14) adds a
    process-scoped instant marker on each dying PE's track at its fail time,
    so the rollback gap and the survivors' pile-up line up visually.
    """
    meta: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": TRACE_PID, "tid": 0,
        "args": {"name": label},
    }]
    for j, pe in enumerate(db.pes):
        meta.append({"name": "thread_name", "ph": "M", "pid": TRACE_PID,
                     "tid": j, "args": {"name": f"PE{j} {pe.name}"}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": TRACE_PID,
                     "tid": j, "args": {"sort_index": j}})

    def task_name(jid: int, tid: int) -> str:
        if apps is not None and trace is not None:
            app = apps[int(trace.app_index[jid])]
            return f"{app.name}.{app.tasks[tid].name}"
        return f"j{jid}.t{tid}"

    events: List[Dict] = []
    for r in result.records:
        name = task_name(r.job_id, r.task_id)
        args = {"job": r.job_id, "task": r.task_id,
                "ready_us": r.ready_us, "freq_ghz": r.freq_ghz}
        events.append({"name": name, "ph": "B", "pid": TRACE_PID,
                       "tid": r.pe_id, "ts": r.start_us, "args": args})
        events.append({"name": name, "ph": "E", "pid": TRACE_PID,
                       "tid": r.pe_id, "ts": r.finish_us})
        events.append({"name": f"ready {name}", "ph": "i", "s": "t",
                       "pid": TRACE_PID, "tid": r.pe_id, "ts": r.ready_us})

    if failures:
        # lazy import: obs must stay importable without the scenario facade
        from ..scenario.faults import normalize_failures
        for f in normalize_failures(failures):
            if f.is_noop:
                continue
            events.append({
                "name": f"FAIL-STOP PE{f.pe_id}", "ph": "i", "s": "p",
                "pid": TRACE_PID, "tid": f.pe_id,
                "ts": float(f.fail_time_us),
                "args": {"pe": f.pe_id, "kind": f.kind}})

    if telemetry is not None and telemetry.num_windows:
        t_us = telemetry.time_us
        C = telemetry.num_domains
        for w in range(telemetry.num_windows):
            ts = float(t_us[w])
            events.append({
                "name": "freq_ghz", "ph": "C", "pid": TRACE_PID, "ts": ts,
                "args": {f"cl{c}": float(telemetry.freq_ghz[w, c])
                         for c in range(C)}})
            events.append({
                "name": "util", "ph": "C", "pid": TRACE_PID, "ts": ts,
                "args": {f"cl{c}": float(telemetry.util[w, c])
                         for c in range(C)}})
            events.append({
                "name": "temp_c", "ph": "C", "pid": TRACE_PID, "ts": ts,
                "args": {n: float(telemetry.temps_c[w, i])
                         for i, n in enumerate(("big", "little", "accel",
                                                "board"))}})

    events.sort(key=lambda e: (e["ts"], _PH_ORDER.get(e["ph"], 9)))
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


def write_chrome_trace(path, trace_obj: Dict) -> None:
    with open(path, "w") as fh:
        json.dump(trace_obj, fh)


def validate_chrome_trace(trace_obj: Dict) -> List[str]:
    """Schema check; returns the list of violations (empty = valid).

    Invariants: a ``traceEvents`` list whose entries carry the required keys
    (``name``/``ph``/``pid``, ``ts`` for non-metadata, ``tid`` for thread
    events), non-decreasing ``ts`` in serialised order, and balanced
    ``B``/``E`` pairs per ``(pid, tid)`` with ``E.ts ≥ B.ts``.
    """
    errs: List[str] = []
    events = trace_obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    last_ts = None
    stacks: Dict = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        for key in ("name", "ph", "pid"):
            if key not in e:
                errs.append(f"event {i}: missing key {key!r}")
        if ph == "M":
            continue
        if "ts" not in e:
            errs.append(f"event {i}: missing key 'ts'")
            continue
        ts = e["ts"]
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} < previous {last_ts} "
                        "(non-monotonic)")
        last_ts = ts
        if ph in ("B", "E", "i"):
            if "tid" not in e:
                errs.append(f"event {i}: thread event missing 'tid'")
                continue
            key = (e.get("pid"), e["tid"])
            if ph == "B":
                stacks.setdefault(key, []).append((e.get("name"), ts, i))
            elif ph == "E":
                stack = stacks.get(key) or []
                if not stack:
                    errs.append(f"event {i}: 'E' with no open 'B' on "
                                f"track {key}")
                    continue
                _, b_ts, _ = stack.pop()
                if ts < b_ts:
                    errs.append(f"event {i}: 'E' ts {ts} precedes its "
                                f"'B' ts {b_ts}")
    for key, stack in stacks.items():
        for name, _, i in stack:
            errs.append(f"event {i}: unmatched 'B' ({name!r}) on track {key}")
    return errs
