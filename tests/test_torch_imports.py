"""The port stands alone: it imports neither JAX nor the reference
package, builds nothing at import, and its entry points default to CUDA."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (every port test file imports both frameworks)
import pytest
import torch

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=PKG.parent,
                         env={"PATH": "", "PYTHONPATH": str(PKG.parent)})
    return json.loads(out.stdout.splitlines()[-1])


def test_every_module_imports_without_jax_or_reference():
    got = _run(
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))")
    assert len(MODULES) > 20
    assert got == []


def test_no_source_file_imports_jax_or_reference():
    bad = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_importing_the_kernel_module_builds_nothing():
    got = _run(
        "import json, subprocess\n"
        "calls = []\n"
        "subprocess.run = lambda *a, **k: calls.append(a)\n"
        "from repro_torch.kernels import flash_attention, gp_forecast, gp_gram, ops\n"
        "from repro_torch.kernels import arima_forecast, fma, leap, sched, shaper\n"
        "print(json.dumps([len(calls), gp_gram._LIB is None,\n"
        "                  gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches,\n"
        "                  gp_forecast._LIB is None, gp_forecast.gp_fit_forecast.launches,\n"
        "                  flash_attention._LIB is None,\n"
        "                  flash_attention._LIB_SM90 is None,\n"
        "                  flash_attention.flash_attention.launches,\n"
        "                  flash_attention.flash_attention.route_launches,\n"
        "                  shaper._LIB is None, shaper.pessimistic_pass.launches,\n"
        "                  sched._LIB is None, sched.resolve_oom.launches,\n"
        "                  sched.admit_queued.launches,\n"
        "                  sched.place_missing_elastic.launches,\n"
        "                  fma._LIB is None, fma.fma_f32.launches,\n"
        "                  leap._LIB is None, leap.leap_skip.launches,\n"
        "                  arima_forecast._LIB is None,\n"
        "                  arima_forecast.arima_forecast.launches]))")
    assert got == [0, True, 0, 0, True, 0, True, True, 0, {"sm90": 0, "simt": 0},
                   True, 0, True, 0, 0, 0, True, 0, True, 0, True, 0]


def test_run_sim_without_device_raises_on_a_cpu_only_machine(monkeypatch):
    from repro_torch.sim import SimConfig, run_sim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sim(SimConfig())


def test_forecasters_without_device_raise_on_a_cpu_only_machine(monkeypatch):
    from repro_torch.core.forecast import ARIMAForecaster, GPForecaster, OracleForecaster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = torch.zeros((2, 24))
    for model in (ARIMAForecaster(), GPForecaster(), OracleForecaster()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.forecast_batch(w, 3)
    oracle = OracleForecaster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.forecast(w[0], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.forecast_from_future(w)


def test_whisper_entry_points_without_device_raise_on_a_cpu_only_machine(monkeypatch):
    from repro_torch.models import get_config
    from repro_torch.models import whisper as W
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("whisper-large-v3", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.init_whisper(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        W.init_dec_caches(cfg, 1, 4)
