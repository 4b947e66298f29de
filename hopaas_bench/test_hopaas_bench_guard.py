"""The run's guards: JAX and the JAX package blocked and refused, no
result without a card or without the port, and the harness's own
sources free of both."""
import ast
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from hopaas_bench import harness

BENCH = harness.BENCH


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert not any(n.startswith(("repro_torch", "jaxtyping"))
                   for n in harness.banned_modules())
    monkeypatch.setitem(sys.modules, "repro.models.fake",
                        types.ModuleType("repro.models.fake"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    found = harness.banned_modules()
    assert "repro.models.fake" in found and "flax" in found


def test_run_blocks_jax_and_the_jax_package_before_any_import():
    code = ("import hopaas_bench.run, importlib\n"
            "for name in ('jax', 'jaxlib', 'flax', 'repro', 'repro.core'):\n"
            "    try:\n"
            "        importlib.import_module(name)\n"
            "    except ImportError:\n"
            "        continue\n"
            "    raise SystemExit(name + ' imported')\n"
            "import repro_torch\n")
    env = {**os.environ, "PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _run(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "hopaas_bench/run.py", "--workload",
         "deepseek-7b.prefill_mix", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = _run(harness.ROOT, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""


def test_no_result_beside_only_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "hopaas_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run(tmp_path, env)
    assert res.returncode != 0 and res.stdout == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(harness.BANNED)
    assert "benchmarks" not in tops
    assert "benchmarks" + "/" not in path.read_text()
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_importing_the_benchmark_blocks_nothing():
    """Only ``run.py`` run as a script blocks the JAX package: importing
    the benchmark's modules (as the tests do, in every worker) must not
    hide it from other tests."""
    import importlib
    for name in ("hopaas_bench.control", "hopaas_bench.harness",
                 "hopaas_bench.drivers.hpo_train",
                 "hopaas_bench.drivers.prefill", "hopaas_bench.testing"):
        importlib.import_module(name)
    assert all(sys.modules.get(n, "absent") is not None
               for n in harness.BANNED)
