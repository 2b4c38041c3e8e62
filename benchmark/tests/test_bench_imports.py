"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names: usdm_tpu_torch is not usdm_tpu), and the plain reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.lib import registry
from benchmark.lib.env import FORBIDDEN

ROOT = registry.BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    for py in registry.BENCH.rglob("*.py"):
        names = set(_imports(py))
        assert not names & set(FORBIDDEN), (py, names & set(FORBIDDEN))
        if "reference" in py.parts:
            assert "usdm_tpu_torch" not in names, py


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    got = _run("import sys; sys.path.insert(0, '.');"
               "import benchmark.reference.mistral, benchmark.calibrate;"
               "print(sorted({m.split('.')[0] for m in sys.modules} & "
               "{'usdm_tpu_torch', 'usdm_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert got == "['usdm_tpu_torch']" or got == "[]"
    got = _run("import sys; sys.path.insert(0, '.'); import benchmark.reference.mistral;"
               "print(sorted({m.split('.')[0] for m in sys.modules} & "
               "{'usdm_tpu_torch', 'usdm_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert got == "[]"


def test_a_whole_small_run_loads_no_jax():
    got = _run("import sys; sys.path.insert(0, '.');"
               "from benchmark.lib import env; env.prepare_process();"
               "import torch; torch.set_num_threads(2);"
               "from benchmark import run as R; from benchmark.tests import tiny;"
               "R.run_cell(tiny.cell('lm.lora-8k'), 3, 0.5, False, 'cpu');"
               "R.run_cell(tiny.cell('s2s.dialog-c32'), 3, 1.0, False, 'cpu');"
               "print(env.forbidden_modules())")
    assert got == "[]"
