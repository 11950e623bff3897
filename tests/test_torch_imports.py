"""The port stands alone: no JAX, nothing of ``repro``, and no quiet CPU.

* every ``repro_torch`` module, and ``chip_smoke.py``'s imports, load in a
  process where ``import jax`` fails;
* an AST scan finds no ``import jax`` and no import of ``repro`` (other than
  ``repro_torch``) in ``src/repro_torch/`` or ``chip_smoke.py``;
* entry points default to CUDA and raise where no GPU is present, instead
  of running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'repro' or "
            "m.startswith(('repro.', 'jax.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _banned(tree: ast.AST) -> list[str]:
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                found.append(f"line {node.lineno}: {name}")
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _banned(ast.parse(path.read_text())), path


@pytest.mark.parametrize("module", [
    "repro_torch.launch.dryrun", "repro_torch.core.cost",
    "repro_torch.serve.metrics", "repro_torch.serve"])
def test_dryrun_and_metrics_are_covered(module):
    """The dry-run, its work counter and the serving metrics are among the
    modules imported with JAX blocked and scanned for banned imports."""
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    assert (path / "__init__.py" if path.is_dir()
            else path.with_suffix(".py")) in FILES


@pytest.mark.parametrize("module", [
    "repro_torch.plan", "repro_torch.plan.builder", "repro_torch.plan.plan",
    "repro_torch.plan.store", "repro_torch.plan.tiles", "repro_torch.mapper",
    "repro_torch.mapper.search", "repro_torch.mapper.space",
    "repro_torch.mapper.schedule", "repro_torch.analysis",
    "repro_torch.analysis.verify", "repro_torch.analysis.findings",
    "repro_torch.exec.pool", "repro_torch.core.noc.traffic",
    "repro_torch.core.ops", "repro_torch.core.ina_model"])
def test_plan_layer_is_covered(module):
    """The plan layer's modules are among those imported with JAX blocked
    and scanned for banned imports."""
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    assert (path / "__init__.py" if path.is_dir()
            else path.with_suffix(".py")) in FILES


@pytest.mark.parametrize("module", [
    "repro_torch.experiments", "repro_torch.experiments.__main__",
    "repro_torch.experiments.sweeps", "repro_torch.experiments.report",
    "repro_torch.core.workloads", "repro_torch.core.noc.power",
    "repro_torch.serve.traffic", "repro_torch.serve.costs",
    "repro_torch.serve.cluster", "repro_torch.serve.__main__"])
def test_evaluation_and_capacity_planner_are_covered(module):
    """The paper's evaluation and the capacity planner are among the
    modules imported with JAX blocked and scanned for banned imports."""
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    assert (path / "__init__.py" if path.is_dir()
            else path.with_suffix(".py")) in FILES


@pytest.mark.parametrize("module", [
    "repro_torch.core.noc.faults", "repro_torch.core.noc.compiled",
    "repro_torch.core.noc.vectorized", "repro_torch.analysis.corpus"])
def test_fault_layer_and_executors_are_covered(module):
    """The NoC fault layer, the compiled and vectorized executors and the
    artifact corpora are among the modules imported with JAX blocked and
    scanned for banned imports."""
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    assert path.with_suffix(".py") in FILES


def test_scan_catches_banned_imports():
    src = ("import jax.numpy as jnp\nfrom repro.configs import ARCHS\n"
           "import repro\nfrom repro_torch import convert\nimport torch\n")
    assert len(_banned(ast.parse(src))) == 3


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")


def _cfg(name="qwen2-1.5b"):
    from repro_torch.configs import ARCHS
    return ARCHS[name].reduced()


@pytest.mark.parametrize("entry", ["init", "init_cache", "engine", "kvcache",
                                   "convert", "launcher", "rwkv_init",
                                   "rwkv_init_cache", "rwkv_engine",
                                   "rwkv_launcher", "build_prefill",
                                   "hybrid_engine", "vlm_launcher",
                                   "encdec_init", "capacity_planner"])
def test_entry_points_default_to_cuda(no_gpu, entry):
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import serve
    from repro_torch.models.api import get_model
    from repro_torch.parallel.steps import build_prefill
    from repro_torch.serve import __main__ as planner
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.kvcache import PagedKVCache

    cfg, rwkv = _cfg(), _cfg("rwkv6-7b")
    hybrid, encdec = _cfg("zamba2-2.7b"), _cfg("whisper-medium")
    calls = {
        "init": lambda: get_model(cfg).init(),
        "init_cache": lambda: get_model(cfg).init_cache(1, 8),
        "engine": lambda: ServingEngine(cfg, slots=1, max_seq=8,
                                        block_size=4),
        "kvcache": lambda: PagedKVCache(cfg, 8, 4, 2),
        "convert": lambda: params_from_jax({"ln_f": [1.0]}, cfg),
        "launcher": lambda: serve.main(["--arch", "qwen2-1.5b", "--reduced"]),
        "rwkv_init": lambda: get_model(rwkv).init(),
        "rwkv_init_cache": lambda: get_model(rwkv).init_cache(1, 8),
        "rwkv_engine": lambda: ServingEngine(rwkv, slots=1, max_seq=8,
                                             block_size=4),
        "rwkv_launcher": lambda: serve.main(["--arch", "rwkv6-7b", "--reduced",
                                             "--legacy-loop"]),
        # the forward pass's caller: weights and tokens on the default device
        "build_prefill": lambda: build_prefill(get_model(rwkv)).fn(
            get_model(rwkv).init(), {"tokens": torch.zeros(1, 4, dtype=torch.long)}),
        "hybrid_engine": lambda: ServingEngine(hybrid, slots=1, max_seq=8,
                                               block_size=4),
        "vlm_launcher": lambda: serve.main(["--arch", "llama-3.2-vision-11b",
                                            "--reduced"]),
        "encdec_init": lambda: get_model(encdec).init(),
        # the engine demo's device is checked before any plan or simulation
        "capacity_planner": lambda: planner.main(["--no-plan"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
