"""The harness leaves no module of JAX or of the JAX package loaded, and the
reference none of the program either; names are compared whole."""
import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    names = loaded_after(
        "from portbench import reference\n"
        "from portbench.generators import graph_matching\n"
        "m = graph_matching.make({'n_left': 6, 'n_right': 6, 'candidates': 2, 'nr_quadratic': 4}, 1)\n"
        "reference.solve(reference.build_layout(m, 'bfs'), 3)")
    assert not names & {"bdd_tpu_torch", "bdd_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_not_the_jax_package():
    names = loaded_after(
        "import time\nfrom portbench import harness\n"
        "harness.run('gm50k.dual', 5, 0.0, False, time.monotonic(), device='cpu', instance="
        "{'n_left': 6, 'n_right': 6, 'candidates': 2, 'nr_quadratic': 4})\n"
        "assert harness.forbidden_modules() == []")
    assert "bdd_tpu_torch" in names
    assert not names & {"bdd_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name,bad", [("bdd_tpu_torch.api", False), ("bdd_tpu.api", True),
                                      ("jax", True), ("jaxlib.xla", True), ("jax_utils", False)])
def test_forbidden_names_are_whole(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_modules()) == bad


def test_no_source_of_the_benchmark_imports_jax_and_the_reference_not_the_program():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
            tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
            assert not tops & {"jax", "jaxlib", "flax", "bdd_tpu"}, f
            if f in ("reference.py", "model.py", "work.py") or "generators" in dirpath:
                assert "bdd_tpu_torch" not in tops, f


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mknap.t25.dual", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
