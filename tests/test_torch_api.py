"""bdd_tpu_torch.api.BddSolver — the whole slice — vs bdd_tpu.api.BddSolver.

float64 with JAX's rounding draws injected: the result is identical (status,
iterations, solution dict, objective) and the bounds agree to 1e-8. float32:
the JAX package's sort-based exchange sums in another order than the port's
segment sum, so the bounds agree to rel 1e-4 and the port's solution is
checked for feasibility on its own.
"""
import json
import math
import subprocess
import sys

import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from bdd_tpu import api as jax_api
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch import api
from bdd_tpu_torch.utils.problems import grid_mrf as port_grid_mrf
from bdd_tpu_torch.solver import sweep_kernels as sk
from tests import fixtures
from tests.test_torch_rounding import jax_draws


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards: the CPU solver of native/ sizes its per-thread
    scratch by omp_get_max_threads() of the thread that creates it, so a
    count lowered for good would break other modules' solvers that run
    parallel regions from other threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = {
    "mrf_chain": fixtures.SHORT_MRF_CHAIN,
    "two_simplex": fixtures.TWO_SIMPLEX,
    "covering": fixtures.COVERING,
    "matching": fixtures.MATCHING_3x3,
    "grid": grid_mrf(3, 3, 3, seed=2).write_lp(),
}


def solve_both(lp, config):
    ref = jax_api.BddSolver(dict(config))
    ref.read_ilp(lp_string=lp)
    want = ref.solve(verbose=False)
    port = api.BddSolver(dict(config), device="cpu").read_ilp(lp_string=lp)
    got = port.solve(verbose=False, draws=jax_draws(0))
    return got, want


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax_f64(name):
    got, want = solve_both(CASES[name], {"precision": "double"})
    assert got["status"] == want["status"] == "solved"
    assert got["iterations"] == want["iterations"]
    assert got["initial_lower_bound"] == pytest.approx(want["initial_lower_bound"], abs=1e-8)
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["solution"] == want["solution"]
    assert got["objective"] == pytest.approx(want["objective"], abs=1e-9)
    assert got["objective"] >= got["lower_bound"] - 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_solve_f32_bound_and_feasible(name):
    got, want = solve_both(CASES[name], {"precision": "float"})
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], rel=1e-4, abs=1e-4)
    ilp = parse_lp_string(CASES[name])
    x = [got["solution"][ilp.get_var_name(i)] for i in range(ilp.nr_variables())]
    assert ilp.feasible(x)
    assert got["objective"] == pytest.approx(ilp.evaluate(x))
    assert got["objective"] >= got["lower_bound"] - 1e-4


@pytest.mark.parametrize("precision", ["double", "float"])
def test_dual_only_and_infeasible(precision):
    cfg = {"precision": precision, "perturbation rounding": False,
           "termination criteria": {"maximum iterations": 50}}
    got, want = solve_both(fixtures.MATCHING_3x3, cfg)
    assert "solution" not in got and "solution" not in want
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-5)
    got, want = solve_both(fixtures.INFEASIBLE, cfg)
    assert got == want == {"status": "infeasible", "lower_bound": math.inf}


def test_ilp_object_input_and_variable_order():
    ilp = grid_mrf(3, 3, 2, seed=5)
    cfg = {"precision": "double", "variable order": "bfs"}
    want = jax_api.BddSolver(dict(cfg))
    want.read_ilp(ilp=ilp)
    want = want.solve(verbose=False)
    s = api.BddSolver(dict(cfg), device="cpu").read_ilp(ilp=port_grid_mrf(3, 3, 2, seed=5))
    got = s.solve(verbose=False, draws=jax_draws(0))
    assert s.var_perm is not None
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["solution"] == want["solution"]


def test_cli(tmp_path):
    lp = tmp_path / "inst.lp"
    lp.write_text(fixtures.MATCHING_3x3)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"input": str(lp), "precision": "double"}))
    assert api.main([str(cfg), "--device", "cpu"]) == 0
    assert api.main([str(lp), "--device", "cpu"]) == 0


@pytest.mark.parametrize(
    "config,waits",
    [
        ({"relaxation solver": "lbfgs parallel mma"}, None),
        ({"relaxation solver": "hybrid mma"}, False),
        ({"relaxation solver": "sharded mma"}, False),
        ({"relaxation solver": "dense mma"}, False),
        ({"tighten": {"cliques": True}}, False),
        ({"split chunk size": 4}, False),
        ({"split bdds": {}}, False),
        ({"export lp": "out.lp"}, False),
        ({"perturbation rounding": {"method": "wedelin"}}, False),
        ({"use native preprocessing": False}, False),
    ],
    ids=["lbfgs", "hybrid", "sharded", "dense", "tighten", "split", "split_bdds", "export",
         "wedelin", "python"],
)
def test_unported_configs_raise(config, waits, tmp_path, monkeypatch):
    """No name waits any more: the keys that the Python pipeline brought
    solve, with the JAX package's bound (float64, abs 1e-8), and so do the
    dense backend ("dense mma"), the tightening phase and the hybrid solve
    (all on the device at the automatic threshold: the JAX package's native
    solver would overrun its scratch under this module's thread cap;
    tests/test_torch_hybrid.py splits it) and the sharded solve (one shard:
    no process group; the JAX package's over its 8 CPU devices; the ranks
    are tested in tests/test_torch_sharded.py); the outer loops construct
    (``waits`` None; their solves are held to the JAX package's in
    tests/test_torch_outer.py)."""
    if waits is None:
        from bdd_tpu_torch.solver.lbfgs import LbfgsSolver

        s = api.BddSolver({**config, "lbfgs": {"history size": 3}}, device="cpu")
        s.read_ilp(lp_string=CASES["grid"]).process_ilp().transform_to_bdds().construct_solver()
        assert isinstance(s.solver, LbfgsSolver) and s.solver.m == 3
        assert s._python_pipeline_reason() is not None  # as bdd_tpu: the Python pipeline
        return
    monkeypatch.chdir(tmp_path)  # "export lp" writes a relative path
    cfg = {"precision": "double", "termination criteria": {"maximum iterations": 100}}
    cfg = api._merge(cfg, config)
    got = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=CASES["grid"]).solve(
        verbose=False)
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=CASES["grid"])
    want = ref.solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["solution"] == want["solution"]


def test_native_unsupported_input_raises():
    """An input the host library refuses goes to the Python pipeline, which
    raises what the JAX package raises for it."""
    from bdd_tpu.ilp.lp_parser import LpParseError as JaxLpParseError
    from bdd_tpu_torch.ilp.lp_parser import LpParseError

    lp = "Minimize\nx + y\nSubject To\n0.5 x + y <= 1\nEnd"
    s = api.BddSolver({}, device="cpu").read_ilp(lp_string=lp)
    with pytest.raises(LpParseError, match="must be integral") as got:
        s.solve(verbose=False)
    ref = jax_api.BddSolver({})
    ref.read_ilp(lp_string=lp)
    with pytest.raises(JaxLpParseError) as want:
        ref.solve(verbose=False)
    assert str(got.value) == str(want.value)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        api.BddSolver({}, device="cuda")


def test_cpu_solve_launches_no_kernel():
    sk.reset_launch_counts()
    api.BddSolver({"precision": "float"}, device="cpu").read_ilp(
        lp_string=fixtures.MATCHING_3x3
    ).solve(verbose=False)
    assert not any(sk.LAUNCHES.values())


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke (not run), imported in a fresh
    process: neither JAX nor any module of the JAX package may come along."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import bdd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(bdd_tpu_torch.__path__, 'bdd_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "for name in ('api', 'serve', 'native', 'solver.run', 'solver.rounding',\n"
        "             'solver.lbfgs', 'solver.subgradient', 'solver.dense',\n"
        "             'solver.dense_wrapper', 'solver.prefix',\n"
        "             'solver.sweep_kernels', 'solver.extras', 'solver.flatten',\n"
        "             'solver.ref_solver', 'solver.sequential', 'utils.logging',\n"
        "             'utils.problems', 'utils.batching', 'ilp.lp_parser', 'ilp.mps_parser',\n"
        "             'ilp.opb_parser', 'ilp.__main__', 'bdd.collection', 'bdd.manager',\n"
        "             'bdd.lineq', 'bdd.preprocessor', 'frontends.graph_matching',\n"
        "             'frontends.mrf_uai', 'frontends.multi_graph_matching'):\n"
        "    assert 'bdd_tpu_torch.' + name in mods, name\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'bdd_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35
