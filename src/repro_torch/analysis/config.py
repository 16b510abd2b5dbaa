"""Repo-root configuration for ``repro_torch.analysis`` (``pyproject.toml``).

The twin of ``src/repro/analysis/config.py``.  A ``[tool.repro_torch.analysis]``
block, when ``pyproject.toml`` has one, selects rules, lint paths, per-rule
severity, the UN001 unit vocabulary and the hot set's roots::

    [tool.repro_torch.analysis]
    paths = ["src/repro_torch", "tools", "chip_smoke.py"]
    disable = []                      # rule codes switched off repo-wide
    severity = ["SH001=warn"]         # per-rule level: error | warn | info
    unit-suffixes = ["_j", "_w", ...] # accepted unit suffixes (UN001)
    unit-structs = ["EnergyReport"]   # dataclasses UN001 audits
    unit-allow = ["util*", "*_idx"]   # dimensionless names (fnmatch)
    hot-roots = ["repro_torch.models.model:Model.decode_step"]
    hot-exclude = ["*_plain"]         # qualnames the hot set never enters
    contracts = "src/repro_torch/analysis/contracts.json"

Without the block every key takes the default below: the defaults are the
port's configuration.  Severity semantics are the reference's: ``error``
findings gate (CLI exit 1), ``warn`` findings gate only under ``--strict``,
``info`` findings never gate.  ``severity`` takes the ``["CODE=level", …]``
list form or a sub-table when ``tomllib`` is available; without ``tomllib``
or ``tomli`` a minimal single-section parser reads the subset this block
uses (strings, string lists, booleans).

A hot-set root is ``module:qualname``: ``Class.method`` for a method,
``outer.<locals>.inner`` for a closure (Python's own ``__qualname__``).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ALL_RULES: Tuple[str, ...] = ("TX001", "TX002", "TX003", "TD001", "UN001",
                              "SC001", "DN001", "SH001", "KL001", "CC001")

SEVERITY_LEVELS: Tuple[str, ...] = ("error", "warn", "info")

#: default per-rule severity; SH001's placement checks are heuristics over
#: conventions, so they warn by default (and gate only under --strict), as
#: the reference's do
DEFAULT_SEVERITY: Dict[str, str] = {
    "TX001": "error", "TX002": "error", "TX003": "error",
    "TD001": "error", "UN001": "error",
    "SC001": "error", "DN001": "error", "SH001": "warn",
    "KL001": "error", "CC001": "error", "WV001": "error",
}

#: one-line rule summaries (CLI --list-rules, SARIF rule metadata)
RULE_DOCS: Dict[str, str] = {
    "TX001": "host-sync: .item()/.tolist()/.cpu()/.numpy(), bool()/int()/"
             "float() or if/while on tensor values, torch.cuda.synchronize() "
             "in the hot set",
    "TX002": "host-numpy: np.* calls fed tensor values in the hot set (an "
             "implicit copy and sync; raises on a CUDA tensor)",
    "TX003": "import-time effects: kernel build, subprocess, nvcc, "
             "`import triton` or an os.environ write at module level; a "
             "build inside a loop body",
    "TD001": "tensor-dataclass: a dataclass with a torch.Tensor field is "
             "frozen=True and eq=False (or its tensor fields compare=False)",
    "UN001": "unit-suffix: numeric fields and payload keys on result "
             "structs carry _us/_j/_w/_c/_hz/... suffixes",
    "SC001": "loop-step carry: `a, b = step(a, b)` in a for/while body keeps "
             "the carry's arity, order and integer dtype",
    "DN001": "in-place alias: no in-place write to a value made by .to()/"
             ".float()/.type()/.detach()/torch.as_tensor without a copy",
    "SH001": "lane-sharding: 'lanes' leads a sharding.P; no lane_mesh/Mesh/"
             "launch.mesh construction in the hot set",
    "KL001": "launch-without-refuse-grad: every path to a ctypes launch of a "
             "_build.load library first calls _build.refuse_grad",
    "CC001": "counter gate: BENCH_*.json k1_launches/scan_calls within "
             "contracts.json budgets",
    "WV001": "(strict only) waiver comment missing its -- justification",
}

DEFAULT_PATHS = ("src/repro_torch", "tools", "chip_smoke.py",
                 "examples/autotune_sharding_torch.py",
                 "examples/dse_pareto_torch.py",
                 "examples/quickstart_torch.py",
                 "examples/serve_decode_torch.py",
                 "examples/train_lm_torch.py")
# the reference's UN001 vocabulary (src/repro/analysis/config.py)
DEFAULT_SUFFIXES = ("_j", "_w", "_s", "_us", "_ms", "_c", "_hz", "_ghz")
DEFAULT_UNIT_STRUCTS = ("EnergyReport", "EvalResult", "Telemetry",
                        "GovernorPolicy", "Result", "SweepResult",
                        "TraceSpec", "ThermalSpec")
DEFAULT_UNIT_ALLOW = ("util*", "utilization", "*_idx", "*_count", "num_*",
                      "*_frac", "*_ratio", "up_threshold", "mix", "seed",
                      "bins", "repeats", "points", "schema", "kind",
                      "value", "axes", "telemetry")
#: the twins of the reference's jit roots; every kernel wrapper that launches
#: a ``_build.load`` library is a root as well (found, not listed)
DEFAULT_HOT_ROOTS = (
    "repro_torch.launch.steps:make_train_step.<locals>.train_step",
    "repro_torch.launch.steps:make_prefill_step.<locals>.prefill_step",
    "repro_torch.launch.steps:make_serve_step.<locals>.serve_step",
    "repro_torch.models.model:Model.decode_step",
    "repro_torch.serving.engine:ServeEngine.step",
    "repro_torch.core.simkernel_torch:simulate_batch",
    "repro_torch.core.simkernel_torch:simulate_batch_dtpm",
    "repro_torch.dse.batch:simulate_grid",
    "repro_torch.scenario.shardexec:grid_program",
    "repro_torch.dse.thermal_torch:peak_temperature_grid",
)
#: a kernel's plain version takes only CPU tensors (K1's ``_Windows`` is the
#: plain scan's DTPM carry): the hot set never enters them
DEFAULT_HOT_EXCLUDE = ("*_plain", "repro_torch.kernels.epoch_scan:_Windows*")
DEFAULT_CONTRACTS = "src/repro_torch/analysis/contracts.json"
SECTION = "tool.repro_torch.analysis"


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    root: Path
    paths: Tuple[str, ...] = DEFAULT_PATHS
    disable: Tuple[str, ...] = ()
    severity: Tuple[Tuple[str, str], ...] = ()   # per-rule overrides
    unit_suffixes: Tuple[str, ...] = DEFAULT_SUFFIXES
    unit_structs: Tuple[str, ...] = DEFAULT_UNIT_STRUCTS
    unit_allow: Tuple[str, ...] = DEFAULT_UNIT_ALLOW
    hot_roots: Tuple[str, ...] = DEFAULT_HOT_ROOTS
    hot_exclude: Tuple[str, ...] = DEFAULT_HOT_EXCLUDE
    contracts: str = DEFAULT_CONTRACTS

    def enabled_rules(self, select: Optional[List[str]] = None,
                      ignore: Optional[List[str]] = None) -> Tuple[str, ...]:
        rules = list(select) if select else [r for r in ALL_RULES
                                             if r not in self.disable]
        if ignore:
            rules = [r for r in rules if r not in ignore]
        unknown = [r for r in rules if r not in ALL_RULES]
        if unknown:
            raise ValueError(f"unknown rule code(s) {unknown}; "
                             f"known: {list(ALL_RULES)}")
        return tuple(rules)

    def severity_for(self, code: str) -> str:
        for rule, level in self.severity:
            if rule == code:
                return level
        return DEFAULT_SEVERITY.get(code, "error")


def _parse_toml(text: str, section: str = SECTION) -> Dict:
    try:
        import tomllib                                   # py311+
        return tomllib.loads(text)
    except ImportError:
        pass
    try:
        import tomli
        return tomli.loads(text)
    except ImportError:
        return _parse_section(text, section)


def _parse_section(text: str, section: str) -> Dict:
    """Tiny TOML-subset fallback: one named table of scalars/string lists."""
    table: Dict = {}
    in_section = False
    buf = ""
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("["):
            in_section = line == f"[{section}]"
            continue
        if not in_section or not line or line.startswith("#"):
            continue
        buf += " " + line
        if buf.count("[") > buf.count("]"):
            continue                                     # multi-line list
        m = re.match(r'\s*([\w.-]+)\s*=\s*(.+)$', buf)
        buf = ""
        if not m:
            continue
        table[m.group(1)] = _parse_value(m.group(2).strip())
    # re-nest under the dotted section path so both parsers look alike
    out: Dict = {}
    node = out
    for part in section.split("."):
        node[part] = {}
        node = node[part]
    node.update(table)
    return out


def _parse_value(v: str):
    v = v.split("#", 1)[0].strip() if not v.startswith(("'", '"', "[")) else v
    if v.startswith("["):
        inner = v.strip()[1:-1]
        items = [s.strip() for s in inner.split(",") if s.strip()]
        return [_parse_value(s) for s in items]
    if v.startswith(("'", '"')):
        return v.strip()[1:-1]
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def find_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor holding a ``pyproject.toml`` (else ``start``)."""
    p = (start or Path.cwd()).resolve()
    for cand in (p, *p.parents):
        if (cand / "pyproject.toml").is_file():
            return cand
    return p


def load_config(root: Optional[Path] = None) -> AnalysisConfig:
    # an explicit root is authoritative (fixture trees have no pyproject);
    # otherwise walk up from cwd to the nearest pyproject.toml
    root = Path(root).resolve() if root is not None else find_root()
    pyproject = root / "pyproject.toml"
    block: Dict = {}
    if pyproject.is_file():
        node = _parse_toml(pyproject.read_text())
        for part in SECTION.split("."):
            node = node.get(part, {}) if isinstance(node, dict) else {}
        block = node

    def tup(key: str, default: Tuple[str, ...]) -> Tuple[str, ...]:
        val = block.get(key, block.get(key.replace("-", "_")))
        return tuple(val) if val is not None else default

    return AnalysisConfig(
        root=root,
        paths=tup("paths", DEFAULT_PATHS),
        disable=tup("disable", ()),
        severity=_parse_severity(block.get("severity")),
        unit_suffixes=tup("unit-suffixes", DEFAULT_SUFFIXES),
        unit_structs=tup("unit-structs", DEFAULT_UNIT_STRUCTS),
        unit_allow=tup("unit-allow", DEFAULT_UNIT_ALLOW),
        hot_roots=tup("hot-roots", DEFAULT_HOT_ROOTS),
        hot_exclude=tup("hot-exclude", DEFAULT_HOT_EXCLUDE),
        contracts=str(block.get("contracts", DEFAULT_CONTRACTS)),
    )


def _parse_severity(val) -> Tuple[Tuple[str, str], ...]:
    """Per-rule severity overrides: a ``{"SH001": "warn"}`` sub-table (full
    TOML parsers) or the ``["SH001=warn"]`` list form (fallback parser)."""
    if val is None:
        return ()
    if isinstance(val, dict):
        pairs = [(str(k), str(v)) for k, v in val.items()]
    else:
        pairs = []
        for item in val:
            code, _, level = str(item).partition("=")
            pairs.append((code.strip(), level.strip()))
    for code, level in pairs:
        if code not in ALL_RULES and code != "WV001":
            raise ValueError(f"severity override for unknown rule {code!r}")
        if level not in SEVERITY_LEVELS:
            raise ValueError(f"severity for {code} must be one of "
                             f"{list(SEVERITY_LEVELS)}, got {level!r}")
    return tuple(pairs)
