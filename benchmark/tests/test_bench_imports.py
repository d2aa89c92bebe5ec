"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package (compared by whole top-level names: `dimo_tpu_torch` is the
program), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dimo_tpu"}


def imports(path: str) -> set:
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.partition(".")[0])
    return out


def py_files(folder: str):
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_no_file_imports_jax_or_the_jax_package():
    for path in py_files(BENCH):
        assert not imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in py_files(os.path.join(BENCH, "reference")):
        found = imports(path)
        assert not {"dimo_tpu_torch", "harness", "drivers"} & found, path
        assert found <= {"__future__", "dataclasses", "math", "random",
                         "typing", "numpy", "torch", "scipy"}, (path, found)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, BENCH)
    import run
    monkeypatch.setitem(sys.modules, "dimo_tpu_torch_fake",
                        types.ModuleType("dimo_tpu_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A tiny training cell end to end on the CPU, then the process's
    modules."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{os.path.join(BENCH, 'tests')!r}]\n"
        f"sys.argv = ['run.py']\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "import run\n"
        "from conftest import tiny_cell\n"
        "from harness import spec\n"
        "cell = tiny_cell('s2-train-lpips', {'loss_gap': 1, 'grad_gap': 1, "
        "'change_gap': 1})\n"
        "spec.load_module('drivers', 'train_loop').run(cell, 5, 0.1, False,"
        " 'cpu', sys.argv[0] + '.out', time.perf_counter())\n"
        "print('FOUND', run.forbidden_modules())\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout
