"""Nothing the benchmark runs imports JAX, Flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
references import nothing of the program, and a run without a card or
without the program prints no result and exits non-zero."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from gpubench import run

HERE = run.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "invesalius3_tpu"}
PLAIN = {"torch", "numpy", "math", "contextlib", "typing", "__future__", "statistics"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_names_jax():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in imported(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in imported(path)}
        assert tops <= PLAIN, (path, tops - PLAIN)


def test_a_run_loads_no_jax():
    code = ("import time, json; from gpubench.tests.tiny import run_tiny; "
            "from gpubench import run; r = run_tiny('unet3d_f8.brain_segment', 3, trace=True); "
            "print(json.dumps(run.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compared_whole():
    sys.modules["invesalius3_tpu_torch_probe"] = sys.modules[__name__]
    try:
        assert "invesalius3_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["invesalius3_tpu_torch_probe"]


def _bench(cwd: Path, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "gpubench", "--workload", "head_ct512.watershed",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _bench(run.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
