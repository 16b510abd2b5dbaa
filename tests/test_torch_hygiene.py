"""The port stands alone: it imports torch and numpy, never jax and nothing of
the ``repro`` package; its entry points refuse to run without a CUDA device
unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)(\.|\s|,|$)"
    r"|from\s+(jax|repro|ml_dtypes)(\.\S*)?\s+import)",
    re.MULTILINE)

CPU_SERVE = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises ImportError
import numpy as np, torch
torch.set_num_threads(1)
import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.core import poisson_trace
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine
from repro_torch.kernels import ops, ref
for arch in ("gemma2-2b", "mamba2-130m", "recurrentgemma-2b",
             "deepseek-moe-16b"):
    cfg = reduced(get_config(arch)).replace(window_size=32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, num_slots=2, max_len=64, device="cpu")
    trace = poisson_trace(0.5, 3, ["chat"], seed=0)
    reqs = [Request(rid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new_tokens=3, arrival_s=float(t) * 1e-6)
            for i, t in enumerate(trace.arrival_us)]
    eng.run(reqs)
    assert all(len(r.output) == 3 for r in reqs)
from repro_torch.scenario import Scenario, run, shardexec
for backend in ("torch", "ref"):
    res = run(Scenario(governor="ondemand"), backend=backend, device="cpu",
              telemetry=True)
    assert res.makespan_us > 0 and res.telemetry.num_windows > 0
    assert res.manifest["device_platform"] == "cpu"
from repro_torch.obs import chrome_trace, metrics, report, validate_chrome_trace
assert validate_chrome_trace(chrome_trace(Scenario().soc(), res.raw,
                                          telemetry=res.telemetry)) == []
from repro_torch.dse import DesignSpace, evaluate, reports, search
from repro_torch.core import reports as core_reports
pts = DesignSpace().sample_lhs(3, seed=0)
ev = evaluate(pts, Scenario().applications(), [Scenario().job_trace()],
              device="cpu", chunk=2)
assert ev.front_mask().any() and metrics.counter("scenario.sweep.chunks").value == 2
import tempfile
from repro_torch.launch.train import train_with_retries
with tempfile.TemporaryDirectory() as d:
    _, losses, _ = train_with_retries(steps=3, batch=2, seq=16, ckpt_dir=d,
                                      ckpt_every=2, fail_at=2, device="cpu")
assert len(losses) == 1 and all(np.isfinite(losses))
bad = sorted(m for m in sys.modules
             if sys.modules[m] is not None
             and (m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "repro" or m.startswith("repro.")))
print("LOADED", bad)
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=300, **kw)


def test_port_imports_and_serves_without_jax_or_repro():
    proc = _run(["-c", CPU_SERVE])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-500:]


def test_importing_the_port_builds_nothing(tmp_path):
    """Import every module with the build directory pointed at an empty
    place: nothing may appear there (kernels build at the first CUDA launch)."""
    code = ("import importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "build"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert not (tmp_path / "build").exists()


def test_importing_the_port_sets_no_environment_variable():
    """Every module of the port, the examples' twins and ``chip_smoke.py``'s
    imports leave ``os.environ`` as they found it (the reference's dry-run
    sets ``XLA_FLAGS`` at import; the port's does not)."""
    code = ("import importlib, os, pkgutil, sys, repro_torch\n"
            "before = dict(os.environ)\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import autotune_sharding_torch, dse_pareto_torch\n"
            "assert dict(os.environ) == before, set(os.environ) ^ set(before)\n"
            "print('ENV UNCHANGED')\n")
    proc = _run(["-c", code, str(ROOT / "examples")])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ENV UNCHANGED" in proc.stdout


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_port_sources(path):
    found = FORBIDDEN.findall(path.read_text())
    assert not found, f"{path}: {found}"


def test_source_scan_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.configs import base", "    import repro",
                 "from repro import core", "import jax, numpy",
                 "import ml_dtypes", "from ml_dtypes import bfloat16"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.configs import base",
                 "from .. import resolve_device", "# import jax would break",
                 "bf16 arrives as ml_dtypes.bfloat16"):
        assert not FORBIDDEN.search(line), line


def test_chip_smoke_refuses_to_run_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the refusal cannot be shown")
    proc = _run([str(ROOT / "chip_smoke.py")], cwd=str(ROOT))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout and '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the refusal cannot be shown")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention, build_model, transformer
    from repro_torch.serving import ServeEngine
    cfg = reduced(get_config("gemma2-2b"))
    assert resolve_device("cpu") == torch.device("cpu")
    for call in (lambda: resolve_device(), lambda: build_model(cfg),
                 lambda: attention.init_cache(cfg, 1, 8, None),
                 lambda: transformer.init_stack_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = build_model(cfg, device="cpu")
    params = model.init_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, num_slots=1, max_len=8)
    proc = _run(["-m", "repro_torch.serving", "--reduced"])
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr

    from repro_torch.core import make_soc_table2, wifi_tx
    from repro_torch.core.simkernel_torch import (ARRAY_FIELDS, build_tables,
                                                  simulate_torch,
                                                  tables_from_numpy)
    from repro_torch.scenario import Scenario, run
    db, apps = make_soc_table2(), [wifi_tx()]
    host = build_tables(db, apps, device="cpu")
    fields = {k: getattr(host, k).numpy() for k in ARRAY_FIELDS
              if getattr(host, k) is not None}
    arrival, app_idx = [10.0, 20.0], [0, 0]
    for call in (lambda: run(Scenario()),
                 lambda: build_tables(db, apps),
                 lambda: simulate_torch(
                     tables_from_numpy(fields, host.t_max, host.num_pes),
                     "etf", arrival, app_idx)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

    from repro_torch.core import poisson_trace
    from repro_torch.dse import DesignSpace, evaluate, pareto_search, reports
    from repro_torch.dse.thermal_torch import rc_state_matrix, transient_trace
    traces = [poisson_trace(20.0, 4, ["wifi_tx"], seed=0)]
    pts = DesignSpace().sample_lhs(2, seed=0)
    for call in (lambda: evaluate(pts, apps, traces),
                 lambda: evaluate(pts, apps, traces, chunk=1),
                 lambda: pareto_search(DesignSpace(), apps, traces, rounds=1,
                                       batch_size=2),
                 lambda: reports.main(["--designs", "2", "--traces", "1"]),
                 lambda: transient_trace([[1.0, 1.0, 1.0]], 0.01),
                 lambda: rc_state_matrix()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    proc = _run(["-m", "repro_torch.dse.reports", "--designs", "2"])
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr

    from repro_torch.launch.train import train, train_with_retries
    for call in (lambda: train(steps=1),
                 lambda: train_with_retries(steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for args in (["-m", "repro_torch.launch.train", "--preset", "tiny"],
                 ["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
                  "--shape", "long_500k"],
                 ["-m", "repro_torch.launch.hillclimb", "--cell", "long"],
                 [str(ROOT / "examples" / "autotune_sharding_torch.py")],
                 [str(ROOT / "examples" / "train_lm_torch.py")],
                 [str(ROOT / "examples" / "serve_decode_torch.py")]):
        proc = _run(args)
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr, args
        assert "retry" not in proc.stdout, args


def test_cuda_sources_ship_with_the_package_and_are_the_only_kernels():
    from repro_torch.kernels import _build
    names = [p.name for p in _build.sources()]
    assert names == ["decode_attention.cu", "epoch_scan.cu",
                     "epoch_scan_faults.cu", "flash_attention.cu", "rg_lru.cu",
                     "ssd_scan.cu", "thermal_grid.cu"]
    for src in _build.sources():
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "-use_fast_math" not in _build.NVCC_FLAGS
