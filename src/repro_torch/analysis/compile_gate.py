"""CC001 — the counter gate, the twin of the reference's compile-count gate.

Where the reference counts jit compiles (``*.compile_count``), the port
counts launches: ``kernels.epoch_scan.variant_launches`` (K1's launches by
instantiation) and ``scenario.sweep.scan_calls`` (the grid scans ``sweep``
started).  Every ``BENCH_*.json`` that ``obs.bench.rows_payload`` writes
carries both in its run manifest (``manifest.k1_launches`` and
``manifest.scan_calls``, each keyed by instantiation name), so the gate is
pure bookkeeping, as the reference's:

* ``contracts.json`` (checked in) records, per benchmark, the maximum
  allowed value of each counter, named ``k1_launches.<instantiation>`` or
  ``scan_calls.<instantiation>`` (for example ``k1_launches.epoch_scan``);
* :func:`check_compile_gate` loads one or more ``BENCH_*.json`` artifacts
  and emits a CC001 finding for every counter above its contract, for every
  counter the contract does not name that counted anything, and for any
  benchmark that has *no* contract entry, so a new benchmark must register
  a budget rather than silently escaping the gate.

A sweep that launched K1 once per lane instead of once per grid, or
restarted its scan per chunk, shows first as a counter over budget.  Raising
a contract is a reviewed diff of ``contracts.json``, justified in the commit
like a changed golden file.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

from .findings import Finding

CONTRACTS_SCHEMA = "repro_torch.analysis/contracts/v1"
#: the manifest's counter groups (``obs/metrics.py`` ``run_manifest``)
COUNTER_GROUPS = ("k1_launches", "scan_calls")


def load_contracts(path: Path) -> Dict[str, Dict[str, int]]:
    data = json.loads(Path(path).read_text())
    if data.get("schema") != CONTRACTS_SCHEMA:
        raise ValueError(f"{path}: expected schema {CONTRACTS_SCHEMA!r}, "
                         f"got {data.get('schema')!r}")
    return data["contracts"]


def bench_counters(payload: Dict) -> Dict[str, float]:
    """``group.name`` -> count of a bench payload's manifest."""
    manifest = payload.get("manifest", {})
    return {f"{group}.{name}": v for group in COUNTER_GROUPS
            for name, v in (manifest.get(group) or {}).items()}


def check_compile_gate(contracts_path: Path,
                       bench_paths: Sequence[Path]) -> List[Finding]:
    contracts = load_contracts(contracts_path)
    out: List[Finding] = []
    cpath = Path(contracts_path).as_posix()
    for bp in bench_paths:
        bp = Path(bp)
        try:
            payload = json.loads(bp.read_text())
        except (OSError, json.JSONDecodeError) as exc:
            out.append(Finding(code="CC001", path=bp.as_posix(), line=1,
                               message=f"unreadable bench artifact: {exc}"))
            continue
        bench = payload.get("manifest", {}).get("bench")
        if not bench:
            out.append(Finding(code="CC001", path=bp.as_posix(), line=1,
                               message="bench artifact has no "
                                       "manifest.bench name"))
            continue
        contract = contracts.get(bench)
        if contract is None:
            out.append(Finding(
                code="CC001", path=cpath, line=1,
                message=f"benchmark `{bench}` has no launch-count "
                        f"contract; add an entry before it lands in CI"))
            continue
        counters = bench_counters(payload)
        for name, limit in sorted(contract.items()):
            actual = counters.get(name, 0)
            if actual > limit:
                out.append(Finding(
                    code="CC001", path=cpath, line=1,
                    message=f"benchmark `{bench}`: counter `{name}` hit "
                            f"{actual:g} launches, contract allows "
                            f"{limit} (+{actual - limit:g} over budget) — "
                            f"a grid or chunk now launches more often (or "
                            f"raise the contract with justification)"))
        stray = sorted(set(counters) - set(contract))
        for name in stray:
            if counters[name] > 0:
                out.append(Finding(
                    code="CC001", path=cpath, line=1,
                    message=f"`{bench}`: counter `{name}` "
                            f"({counters[name]:g} launches) is not in the "
                            f"contract; budget it explicitly"))
    return out
