"""The port's own copies of the JAX-free modules against the originals.

``bdd_tpu_torch`` imports nothing of ``bdd_tpu``; it carries copies of the
host library and its bindings, the run loop, the host rounding helpers, the
ILP model with the LP parser, the graph-matching frontend and the problem
generators. Each copy must give what its original gives on the same seeded
inputs. The copy of the C++ host library also repairs the CPU solver's
per-thread scratch, which the original sizes by the creating thread's OpenMP
count: a solver created on one thread and iterated from a thread with a
higher count must not fault there.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from bdd_tpu import native as jnative
from bdd_tpu.frontends import graph_matching as jgm
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.solver import rounding as jrounding
from bdd_tpu.solver import run as jrun
from bdd_tpu.utils import problems as jproblems
from bdd_tpu_torch import _build
from bdd_tpu_torch import native as tnative
from bdd_tpu_torch.frontends import graph_matching as tgm
from bdd_tpu_torch.ilp import parse_lp_string as t_parse_lp_string
from bdd_tpu_torch.solver import rounding as trounding
from bdd_tpu_torch.solver import run as trun
from bdd_tpu_torch.utils import logging as tlogging
from bdd_tpu_torch.utils import problems as tproblems
from tests import fixtures

ROOT = Path(__file__).resolve().parents[1]

# modules of the port that are the JAX package's JAX-free modules under the
# same relative name, with only their import lines renamed (solver/run.py,
# utils/problems.py, utils/logging.py and native.py are copies with edits of
# their own and are held to the originals by what they compute, below)
COPIED = [
    "bdd/__init__.py", "bdd/collection.py", "bdd/manager.py", "bdd/lineq.py",
    "bdd/preprocessor.py", "ilp/__init__.py", "ilp/__main__.py", "ilp/model.py",
    "ilp/lp_parser.py", "ilp/mps_parser.py", "ilp/opb_parser.py", "frontends/__init__.py",
    "frontends/graph_matching.py", "frontends/mrf_uai.py",
    "frontends/multi_graph_matching.py", "solver/flatten.py", "solver/ref_solver.py",
    "solver/sequential.py", "solver/rounding.py", "utils/batching.py", "learn/configs.py",
]


def _is_import_line(line: str) -> bool:
    return line.lstrip().startswith(("from bdd_tpu", "import bdd_tpu"))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_differs_only_in_import_lines(rel):
    ours = (ROOT / "bdd_tpu_torch" / rel).read_text().splitlines()
    theirs = (ROOT / "bdd_tpu" / rel).read_text().splitlines()
    assert len(ours) == len(theirs)
    for n, (a, b) in enumerate(zip(ours, theirs), 1):
        if a != b:
            assert _is_import_line(a) and _is_import_line(b), f"{rel}:{n}: {a!r} vs {b!r}"
            assert "bdd_tpu_torch." in a and "bdd_tpu_torch" not in b
            # the same module under the port's name; PACK_* live in the port's layout
            assert a.replace("bdd_tpu_torch.", "bdd_tpu.") == b or "PACK_H_CAP" in a


def test_tighten_copy_differs_only_in_the_listed_lines():
    """``solver/tighten.py`` is a copy of the JAX package's. Its differences:
    the import lines (the port's modules), the port's constructor of a
    solver from a collection (``UniformSolver.from_collection``), and the
    meld-disjointness guard, which raises ValueError where the original
    asserts."""
    import difflib

    ours = (ROOT / "bdd_tpu_torch/solver/tighten.py").read_text().splitlines()
    theirs = (ROOT / "bdd_tpu/solver/tighten.py").read_text().splitlines()
    guard = (['    assert len(_all) == len(set(_all)), "meld groups must be disjoint"'],
             ["    if len(_all) != len(set(_all)):",
              '        raise ValueError("meld groups must be disjoint")'])
    diffs = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(a=theirs, b=ours,
                                                       autojunk=False).get_opcodes():
        if op == "equal":
            continue
        a, b = theirs[i1:i2], ours[j1:j2]
        if (a, b) == guard:
            diffs.append("guard")
            continue
        assert op == "replace" and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            if _is_import_line(x):
                assert y == x.replace("bdd_tpu.", "bdd_tpu_torch."), (x, y)
                diffs.append("import")
            else:
                assert y == x.replace("UniformSolver(", "UniformSolver.from_collection("), (x, y)
                diffs.append("constructor")
    assert sorted(diffs) == ["constructor"] * 2 + ["guard"] + ["import"] * 3


# functions of the port that are copies of the JAX package's, under the same
# name in the module of the same relative name, with only their import lines
# renamed
COPIED_FUNCTIONS = [
    ("solver/extras.py", "lagrange_constraint_matrix"),
    ("solver/extras.py", "exact_min_via_meld"),
    ("solver/extras.py", "exact_min_bruteforce"),
    ("solver/hybrid.py", "split_bdds"),
    ("solver/hybrid.py", "_subset_flat"),
    ("solver/hybrid.py", "_JointLayerView"),
    ("solver/sharding.py", "partition_bdds"),
    ("solver/sharding.py", "shared_width"),
    ("solver/sharding.py", "partition_cost"),
    ("solver/sharding.py", "refine_partition_mincut"),
    ("solver/sharding.py", "_subcollection"),
]


def _top_level_source(path: Path, name: str) -> list:
    import ast

    text = path.read_text()
    for node in ast.parse(text).body:
        if getattr(node, "name", None) == name:
            return ast.get_source_segment(text, node).splitlines()
    raise AssertionError(f"{path} has no top-level {name}")


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS, ids=[n for _, n in COPIED_FUNCTIONS])
def test_copied_function_differs_only_in_import_lines(rel, name):
    ours = _top_level_source(ROOT / "bdd_tpu_torch" / rel, name)
    theirs = _top_level_source(ROOT / "bdd_tpu" / rel, name)
    assert len(ours) == len(theirs)
    for n, (a, b) in enumerate(zip(ours, theirs), 1):
        if a != b:
            assert _is_import_line(a) and _is_import_line(b), f"{rel}:{name}:{n}: {a!r} vs {b!r}"
            assert a.replace("bdd_tpu_torch.", "bdd_tpu.") == b


def test_importing_the_whole_port_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import bdd_tpu_torch\n"
        "for m in pkgutil.walk_packages(bdd_tpu_torch.__path__, 'bdd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'bdd_tpu', 'flax', 'optax', 'msgpack'))\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules if m.startswith('bdd_tpu_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    for mod in ("serve", "api", "bdd.preprocessor", "solver.extras", "utils.batching",
                "solver.tighten", "solver.smooth", "solver.smooth_mma", "solver.hybrid",
                "solver.learned", "learn.features", "learn.model", "learn.checkpoint",
                "learn.train", "learn.configs", "learn.data", "solver.sharding",
                "solver.uniform_sharded", "utils.multihost", "learn.sharded",
                "solver.dense", "solver.dense_wrapper", "solver.prefix"):
        assert f"'bdd_tpu_torch.{mod}'" in out.stdout

GENERATORS = {
    "grid_mrf": lambda m: m.grid_mrf(5, 4, 3, seed=2),
    "grid_mrf_big": lambda m: m.grid_mrf(7, 7, 4, seed=5),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_give_the_same_lp_text(name):
    assert GENERATORS[name](tproblems).write_lp() == GENERATORS[name](jproblems).write_lp()


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_matching_frontend_gives_the_same_lp_text(seed):
    kw = dict(seed=seed, candidates=3, nr_quadratic=20)
    a = tgm.construct_graph_matching_ilp(tproblems.graph_matching(8, 9, **kw))[0]
    b = jgm.construct_graph_matching_ilp(jproblems.graph_matching(8, 9, **kw))[0]
    assert a.write_lp() == b.write_lp()
    assert a.nr_variables() == b.nr_variables()


@pytest.mark.parametrize("name", ["MATCHING_3x3", "SHORT_MRF_CHAIN", "TWO_SIMPLEX"])
def test_lp_parser_round_trips_like_the_original(name):
    text = getattr(fixtures, name)
    a, b = t_parse_lp_string(text), j_parse_lp_string(text)
    assert a.write_lp() == b.write_lp()
    x = [i % 2 for i in range(a.nr_variables())]
    assert a.feasible(x) == b.feasible(x)
    assert a.evaluate(x) == b.evaluate(x)


LPS = {
    "matching": fixtures.MATCHING_3x3,
    "grid": jproblems.grid_mrf(4, 4, 3, seed=0).write_lp(),
}


@pytest.mark.parametrize("order", ["input", "bfs", "cuthill", "minimum degree"])
@pytest.mark.parametrize("name", list(LPS))
def test_native_host_equals_the_original_array_for_array(name, order):
    a, b = tnative.NativeHost(LPS[name], order), jnative.NativeHost(LPS[name], order)
    assert (a.nr_vars(), a.nr_bdds(), a.nr_buckets()) == (b.nr_vars(), b.nr_bdds(), b.nr_buckets())
    assert a.constant() == b.constant() and a.var_names() == b.var_names()
    assert a.var_perm() == b.var_perm()
    np.testing.assert_array_equal(a.objective(), b.objective())
    for k in range(a.nr_buckets()):
        x, y = a.bucket_arrays(k), b.bucket_arrays(k)
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=f"bucket {k} {key}")


def test_native_cpu_solver_equals_the_original():
    a = tnative.NativeHost(LPS["grid"], "bfs").cpu_solver()
    b = jnative.NativeHost(LPS["grid"], "bfs").cpu_solver()
    a.iterations(20, 0.5)
    b.iterations(20, 0.5)
    assert a.lower_bound_with_deferred() == pytest.approx(b.lower_bound_with_deferred(), rel=1e-12)
    for x, y in zip(a.costs(), b.costs()):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)


def test_host_library_is_the_ports_own_build():
    path = _build.build_host()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert _build.HOST_SOURCE.endswith("bdd_tpu_torch/csrc/bdd_host.cpp")
    assert "-fopenmp" in _build.HOST_FLAGS and "-std=c++17" in _build.HOST_FLAGS


def test_unsupported_input_raises_native_unsupported():
    with pytest.raises(tnative.NativeUnsupported):
        tnative.NativeHost("Minimize\nx + y\nSubject To\n0.5 x + y <= 1\nEnd", "input")
    with pytest.raises(tnative.NativeUnsupported):
        tnative.NativeHost(LPS["matching"], "no such order")


class StubSolver:
    """A solver whose bound climbs by a fixed law; counts what is called."""

    default_block_size = 5

    def __init__(self, law, blocks=True):
        self.law, self.it, self.calls = law, 0, []
        if blocks:
            self.iteration_block = self._block

    def iteration(self):
        self.it += 1
        self.calls.append(1)

    def _block(self, n):
        self.it += n
        self.calls.append(n)

    def lower_bound(self):
        return self.law(self.it)


LAWS = {
    "geometric": lambda it: 10.0 * (1.0 - 0.5 ** it),
    "linear": lambda it: 0.25 * it,
    "infeasible": lambda it: float("inf") if it >= 10 else float(it),
    "flat": lambda it: 3.0,
}


@pytest.mark.parametrize("blocks", [True, False])
@pytest.mark.parametrize("law", list(LAWS))
def test_run_solver_copy_stops_where_the_original_stops(law, blocks):
    kw = dict(max_iter=63, tolerance=1e-6, improvement_slope=1e-3, time_limit=1e9,
              verbose=False, block_size=5 if blocks else 1)
    a, b = StubSolver(LAWS[law], blocks), StubSolver(LAWS[law], blocks)
    sa, sb = {}, {}
    lb_a = trun.run_solver(a, stats=sa, **kw)
    lb_b = jrun.run_solver(b, stats=sb, **kw)
    assert lb_a == lb_b and a.calls == b.calls and a.it == b.it
    assert sa["iterations"] == sb["iterations"]
    assert sa["initial_lower_bound"] == sb["initial_lower_bound"]


class LayerView:
    def __init__(self, layer_var, valid, nr_vars):
        self.layer_var, self._valid, self.nr_vars = layer_var, valid, nr_vars
        self.num_bdds_per_var = np.bincount(layer_var[valid], minlength=nr_vars)

    def valid_layer_mask(self):
        return self._valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounding_helpers_equal_the_originals(seed):
    rng = np.random.RandomState(seed)
    V, L = 17, 120
    view = LayerView(rng.randint(0, V, size=L).astype(np.int32), rng.rand(L) < 0.85, V)
    m0, m1 = rng.randn(L), rng.randn(L)
    m0[rng.rand(L) < 0.05] = np.inf
    assert trounding.compute_initial_delta(view, m0, m1) == jrounding.compute_initial_delta(
        view, m0, m1)
    obj = rng.randn(V)
    obj[::5] = 0.0
    np.testing.assert_array_equal(trounding.objective_tilt(obj, V),
                                  jrounding.objective_tilt(obj, V))


def test_device_trace_without_a_directory_only_times(monkeypatch):
    monkeypatch.delenv("BDD_TPU_TRACE", raising=False)
    with tlogging.device_trace(label="standalone-test"):
        pass
    assert "standalone-test" in tlogging.timing_report()


def test_device_trace_writes_a_torch_profiler_trace(tmp_path):
    import torch

    with tlogging.device_trace(str(tmp_path), label="solve"):
        torch.ones(8).sum()
    assert (tmp_path / "solve.json").stat().st_size > 0


# A solver created on a thread with ONE OpenMP thread, iterated from a
# thread whose count is higher. OpenMP keeps the count per calling thread, so
# the main thread lowers its own with omp_set_num_threads(1) and a fresh
# thread still has the default.
_THREADS_SCRIPT = textwrap.dedent("""
    import ctypes, os, sys, threading
    os.environ["OMP_NUM_THREADS"] = "4"
    sys.path.insert(0, {root!r})
    from bdd_tpu_torch.native import NativeHost, load_library
    from bdd_tpu_torch.utils.problems import grid_mrf
    import bdd_tpu_torch._build as b
    lp = grid_mrf(6, 6, 3, seed=1).write_lp()
    load_library()
    omp = ctypes.CDLL(b.host_library_path(), mode=ctypes.RTLD_GLOBAL)
    omp.omp_set_num_threads(1)
    assert omp.omp_get_max_threads() == 1
    nh = NativeHost(lp, "bfs")
    single = nh.cpu_solver()
    single.iterations(30, 0.5)
    assert single.nr_threads() == 1
    cs = nh.cpu_solver()           # created under a count of 1
    out = {{}}
    def work():
        out["max"] = omp.omp_get_max_threads()
        cs.iterations(30, 0.5)     # runs a team of 4
        out["lb"] = cs.lower_bound_with_deferred()
        out["team"] = cs.nr_threads()
    t = threading.Thread(target=work); t.start(); t.join()
    print(out["max"], out["team"], repr(single.lower_bound_with_deferred()), repr(out["lb"]))
""")


def test_cpu_solver_survives_a_higher_thread_count_than_its_creator():
    out = subprocess.run(
        [sys.executable, "-c", _THREADS_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    max_threads, team, lb_single, lb_multi = out.stdout.split()
    assert int(max_threads) == 4 and int(team) == 4
    # the sums over threads round in another order than one thread's
    assert float(lb_multi) == pytest.approx(float(lb_single), rel=1e-9)
