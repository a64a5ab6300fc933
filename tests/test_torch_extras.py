"""bdd_tpu_torch.solver.extras (checkpoints, the Lagrange constraint matrix,
the float64 transfer to the native solver, the exact solves) and
``NativeHost.collection`` against bdd_tpu's, on the instances of
tests/test_extras.py.

Checkpoints are the JAX package's file format, so one written by either
package loads in the other; the next iterations then agree to atol 1e-12
(float64). The transfer of a carried float32 state gives the native bound
of the JAX package's transfer of the same state, to the last bit.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu import native as jnative
from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as jparse
from bdd_tpu.solver import RefSolver as JaxRefSolver
from bdd_tpu.solver import extras as jextras
from bdd_tpu.solver import flatten_collection as jflatten
from bdd_tpu.solver.uniform_wrapper import UniformSolver as JaxUniformSolver
from bdd_tpu.solver.wrapper import JaxSolver
from bdd_tpu.utils.problems import grid_mrf, set_cover
from bdd_tpu_torch import native as tnative
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor as PortPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string as pparse
from bdd_tpu_torch.ilp.model import ILPInput, Ineq
from bdd_tpu_torch.solver import extras
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
from bdd_tpu_torch.solver.flatten import flatten_collection as pflatten
from bdd_tpu_torch.solver.hybrid import HybridSolver, _subset_flat
from bdd_tpu_torch.solver.ref_solver import RefSolver as PortRefSolver
from bdd_tpu_torch.solver.smooth_mma import SmoothSolver
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from tests import fixtures

# a row wider than 32 slots: the port stores its frontier [H, B, P]
WIDE_COEFFICIENTS = [11 + 5 * i + (i * i) % 7 for i in range(12)]
WIDE_ROW = ("Minimize\n" + " + ".join(f"{1 + i % 3} x{i}" for i in range(12))
            + "\nSubject To\nc: " + " + ".join(f"{c} x{i}" for i, c in enumerate(WIDE_COEFFICIENTS))
            + f" >= {sum(WIDE_COEFFICIENTS) // 2}\nEnd")


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def build(lp, backend, side):
    """A float64 solver of ``backend`` ("ref", "uniform" or "dense") over
    ``lp`` from ``side``'s package ("port" or "jax")."""
    if side == "jax":
        pre = JaxPreprocessor(jparse(lp))
        if backend in ("ref", "dense"):
            flat = jflatten(pre.collection, pre.total_nr_variables(), pre.nr_primal_variables)
            if backend == "dense":
                return JaxSolver(flat, pre.objective_vector(), dtype=jnp.float64)
            return JaxRefSolver(flat, pre.objective_vector())
        return JaxUniformSolver(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                                nr_primal_vars=pre.nr_primal_variables, dtype=jnp.float64)
    pre = PortPreprocessor(pparse(lp))
    if backend in ("ref", "dense"):
        flat = pflatten(pre.collection, pre.total_nr_variables(), pre.nr_primal_variables)
        if backend == "dense":
            return DenseSolver(flat, pre.objective_vector(), dtype=torch.float64, device="cpu")
        return PortRefSolver(flat, pre.objective_vector())
    return UniformSolver.from_collection(pre.collection, pre.total_nr_variables(),
                                         pre.objective_vector(),
                                         nr_primal_vars=pre.nr_primal_variables,
                                         dtype=torch.float64, device="cpu")


CHECKPOINT_LPS = {"two_simplex": fixtures.TWO_SIMPLEX, "matching": fixtures.MATCHING_3x3,
                  "grid": grid_mrf(3, 3, 2, seed=1).write_lp(), "wide": WIDE_ROW}


@pytest.mark.parametrize("backend", ["ref", "uniform", "dense"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", list(CHECKPOINT_LPS))
def test_checkpoint_crosses_between_packages(tmp_path, name, writer, backend):
    """A checkpoint written by one package loads into a fresh solver of the
    other; the bound and the next iterations equal the writer's."""
    lp = CHECKPOINT_LPS[name]
    reader = "jax" if writer == "port" else "port"
    save = (jextras if writer == "jax" else extras).save_state
    load = (jextras if reader == "jax" else extras).load_state
    s = build(lp, backend, writer)
    for _ in range(5):
        s.iteration()
    path = str(tmp_path / "state.pkl")
    save(s, path)
    s2 = build(lp, backend, reader)
    load(s2, path)
    assert s2.lower_bound_with_deferred() == pytest.approx(s.lower_bound_with_deferred(),
                                                           abs=1e-12)
    for _ in range(3):
        s.iteration()
        s2.iteration()
        assert s2.lower_bound_with_deferred() == pytest.approx(s.lower_bound_with_deferred(),
                                                               abs=1e-12)
    if backend == "uniform" and writer == "port":
        # the JAX pytree's leaves: lo, hi, def_mm per bucket [H, B], cft [H, P, B]
        shapes = [tuple(np.shape(x)) for x in jax.tree.leaves(s2.state)]
        assert shapes == [tuple(x.shape) for x in (*s.state.lo, *s.state.hi, *s.state.def_mm,
                                                   *s.state.cft)]
        if name == "wide":
            assert max(g.P for g in s.geom.buckets) > layout.NARROW_P
    if backend == "dense" and writer == "port":
        # the JAX SolverState's leaves: lo, hi, def_mm [H, L], cft [H, W]
        assert [tuple(np.shape(x)) for x in jax.tree.leaves(s2.state)] == [
            tuple(x.shape) for x in s.state]


def test_dense_checkpoint_resumes_bit_for_bit_and_refuses_other_layouts(tmp_path):
    """A DenseSolver's checkpoint ({"kind": "DenseSolver", "state": [lo, hi,
    def_mm, cft]}) loaded into a fresh solver iterates on to the same bits;
    one of another instance or backend raises ValueError."""
    import pickle

    lp = CHECKPOINT_LPS["grid"]
    a = build(lp, "dense", "port")
    a.iteration_block(4)
    path = str(tmp_path / "dense.pkl")
    extras.save_state(a, path)
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    assert blob["kind"] == "DenseSolver" and len(blob["state"]) == 4
    b = build(lp, "dense", "port")
    extras.load_state(b, path)
    a.iteration_block(3)
    b.iteration_block(3)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    for other in (build(CHECKPOINT_LPS["matching"], "dense", "port"), build(lp, "uniform", "port")):
        with pytest.raises(ValueError, match="state structure"):
            extras.load_state(other, path)
    extras.save_state(build(lp, "uniform", "port"), path)
    with pytest.raises(ValueError, match="state structure"):
        extras.load_state(a, path)


def test_checkpoint_roundtrip_of_smooth_and_hybrid_and_the_iteration_after(tmp_path):
    """SmoothSolver (a UniformSolver) and HybridSolver's device state; the
    state loaded into a fresh solver iterates on to the same bits."""
    lp = grid_mrf(3, 3, 2, seed=1).write_lp()
    pre = PortPreprocessor(pparse(lp))
    args = (pre.collection, pre.total_nr_variables(), pre.objective_vector())
    for make in (
        lambda: SmoothSolver.from_collection(*args, dtype=torch.float64, device="cpu",
                                             smoothing=0.3, smoothing_decay=1.0),
        lambda: HybridSolver(*args, dtype=torch.float64, device="cpu", hop_threshold=10**6),
        lambda: build(lp, "uniform", "port"),
    ):
        a = make()
        a.iteration_block(4)
        path = str(tmp_path / f"{type(a).__name__}.pkl")
        extras.save_state(a, path)
        b = make()
        extras.load_state(b, path)
        a.iteration_block(3)
        b.iteration_block(3)
        for x, y in zip(a.state.flat, b.state.flat):
            assert torch.equal(x, y)


def test_checkpoint_mismatch_raises(tmp_path):
    s = build(fixtures.TWO_SIMPLEX, "uniform", "port")
    path = str(tmp_path / "state.pkl")
    extras.save_state(s, path)
    for other in (build(CHECKPOINT_LPS["grid"], "uniform", "port"),
                  build(fixtures.TWO_SIMPLEX, "ref", "port")):
        with pytest.raises(ValueError):
            extras.load_state(other, path)
    jextras.save_state(build(CHECKPOINT_LPS["grid"], "uniform", "jax"), path)
    with pytest.raises(ValueError):
        extras.load_state(s, path)
    extras.save_state(build(fixtures.TWO_SIMPLEX, "ref", "port"), path)
    with pytest.raises(ValueError):
        extras.load_state(s, path)


@pytest.mark.parametrize("backend", ["ref", "uniform", "hybrid"])
def test_lagrange_constraint_matrix_equals_jax(backend):
    from bdd_tpu.solver.hybrid import HybridSolver as JaxHybridSolver

    lp = grid_mrf(3, 3, 2, seed=1).write_lp() if backend == "hybrid" else fixtures.TWO_SIMPLEX
    if backend == "hybrid":
        jp, tp = JaxPreprocessor(jparse(lp)), PortPreprocessor(pparse(lp))
        force = list(range(0, tp.collection.nr_bdds(), 2))
        mine = HybridSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                            dtype=torch.float64, device="cpu", force_host_bdds=force)
        theirs = JaxHybridSolver(jp.collection, jp.total_nr_variables(), jp.objective_vector(),
                                 dtype=jnp.float64, force_host_bdds=force, mode="callback")
    else:
        mine, theirs = build(lp, backend, "port"), build(lp, backend, "jax")
    a = extras.lagrange_constraint_matrix(mine)
    b = jextras.lagrange_constraint_matrix(theirs)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.toarray(), b.toarray())
    assert (np.asarray(a.sum(axis=0)).ravel() == 1).all()
    if backend == "hybrid":
        mine.close()
        theirs.close()


@pytest.mark.parametrize("name", ["matching", "grid"])
def test_transfer_costs_to_native_equals_jax(name):
    """A float32 JAX state after 30 iterations, carried to the port; each
    package moves it into its own float64 native solver over the same
    collection: equal bounds, now and after 5 native iterations."""
    lp = {"matching": fixtures.MATCHING_3x3, "grid": grid_mrf(3, 3, 3, seed=2).write_lp()}[name]
    pre = JaxPreprocessor(jparse(lp))
    V = pre.total_nr_variables()
    js = JaxUniformSolver(pre.collection, V, pre.objective_vector(), dtype=jnp.float32)
    js.iteration_block(30)
    host, state = layout.from_jax_arrays(js.host, js.state, dtype=torch.float32)
    tpre = PortPreprocessor(pparse(lp))
    mine = tnative.cpu_solver_from_collection(tpre.collection, V, np.zeros(V))
    theirs = jnative.cpu_solver_from_collection(pre.collection, V, np.zeros(V))
    extras.transfer_costs_to_native(host, state, mine)
    jextras.transfer_costs_to_native(js.host, js.state, theirs)
    # native/bdd_host.cpp sums its bound in an order that changes between
    # runs (an OpenMP reduction): one ulp of spread; the port's sums in BDD
    # order, the same bits on every read
    assert mine.lower_bound_with_deferred() == pytest.approx(
        theirs.lower_bound_with_deferred(), rel=1e-12)
    assert mine.lower_bound_with_deferred() == pytest.approx(
        js.lower_bound_with_deferred(), rel=1e-5)
    mine.iterations(5, 0.5)
    theirs.iterations(5, 0.5)
    assert mine.lower_bound_with_deferred() == pytest.approx(
        theirs.lower_bound_with_deferred(), rel=1e-12)
    assert len({mine.lower_bound_with_deferred().hex() for _ in range(5)}) == 1
    nb = tpre.collection.nr_bdds()  # the BDDs numbered backwards: other keys
    other = tnative.cpu_solver_from_flat(
        *_subset_flat(tpre.collection, list(range(nb))[::-1]), V, np.zeros(V))
    with pytest.raises(ValueError, match="layer sets differ"):
        extras.transfer_costs_to_native(host, state, other)


def random_ilp(seed: int, model):
    """tests/test_extras.py's random small ILPs, in ``model``'s package."""
    rng = np.random.RandomState(seed)
    ilp = model.ILPInput()
    nv = 9
    for v in range(nv):
        ilp.add_to_objective(float(rng.randn()), f"x_{v}")
    for _ in range(5):
        k = int(rng.randint(2, 5))
        vs = sorted(rng.choice(nv, size=k, replace=False).tolist())
        coeffs = rng.randint(-3, 4, size=k).tolist()
        if all(c == 0 for c in coeffs):
            coeffs[0] = 1
        ineq = [model.Ineq.LEQ, model.Ineq.GEQ, model.Ineq.EQ][rng.randint(3)]
        lo = sum(min(c, 0) for c in coeffs)
        hi = sum(max(c, 0) for c in coeffs)
        rhs = int(rng.randint(lo, hi + 1))
        ilp.add_linear_constraint(coeffs, [ilp.get_var_index(f"x_{v}") for v in vs], ineq, rhs)
    ilp.normalize()
    return ilp


def outcome(fn, *args, **kwargs):
    """(result, None) or (None, the exception's type)."""
    try:
        return fn(*args, **kwargs), None
    except ValueError as exc:
        return None, type(exc)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_exact_solves_equal_jax(seed):
    """exact_min_via_meld and exact_min_bruteforce: the same optimum and
    assignment as the JAX package's, or the same ValueError (infeasible)."""
    from bdd_tpu.ilp import model as jmodel
    from bdd_tpu_torch.ilp import model as tmodel

    jilp, tilp = random_ilp(seed, jmodel), random_ilp(seed, tmodel)
    assert tilp.write_lp() == jilp.write_lp()
    got, got_err = outcome(extras.exact_min_bruteforce, tilp)
    want, want_err = outcome(jextras.exact_min_bruteforce, jilp)
    assert got_err == want_err
    if want is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    try:
        jpre, tpre = JaxPreprocessor(jilp), PortPreprocessor(tilp)
    except Exception:
        return  # infeasible at preprocessing in both, as test_extras.py skips it
    got, got_err = outcome(extras.exact_min_via_meld, tpre.collection, tpre.objective_vector())
    want, want_err = outcome(jextras.exact_min_via_meld, jpre.collection,
                             jpre.objective_vector())
    assert got_err == want_err
    if want is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert tilp.feasible([int(v) for v in got[1][: tilp.nr_variables()]])


def test_exact_solves_infeasible_and_caps_equal_jax():
    from bdd_tpu_torch.utils.problems import set_cover as port_set_cover

    ilp = set_cover(18, 30, density=0.25, seed=5)
    ilp.normalize()
    tilp = port_set_cover(18, 30, density=0.25, seed=5)
    tilp.normalize()
    jpre, tpre = JaxPreprocessor(ilp), PortPreprocessor(tilp)
    assert extras.exact_min_via_meld(tpre.collection, tpre.objective_vector(), max_nodes=5) is None
    assert jextras.exact_min_via_meld(jpre.collection, jpre.objective_vector(), max_nodes=5) is None
    assert extras.exact_min_bruteforce(tilp) is None  # 30 variables > 24
    bad = ("Minimize\nx + y\nSubject To\nc1: x + y >= 2\nc2: x + y <= 0\n"
           "Binaries\nx y\nEnd\n")
    tpre2 = PortPreprocessor(pparse(bad))
    with pytest.raises(ValueError):
        extras.exact_min_via_meld(tpre2.collection, tpre2.objective_vector())
    with pytest.raises(ValueError):
        extras.exact_min_bruteforce(pparse(bad))
    quad = ILPInput()  # a monomial of two variables: no brute force
    quad.add_to_objective(1.0, "a")
    quad.add_to_objective(1.0, "b")
    quad.add_constraint([1], [[quad.get_var_index("a"), quad.get_var_index("b")]], Ineq.LEQ, 1)
    assert extras.exact_min_bruteforce(quad) is None
    opt = extras.exact_min_bruteforce(pparse(fixtures.MATCHING_3x3))
    assert opt[0] == jextras.exact_min_bruteforce(jparse(fixtures.MATCHING_3x3))[0] == -6


@pytest.mark.parametrize("name", ["grid12", "knapsack"])
def test_native_collection_equals_jax(name):
    """NativeHost.collection() exports the BDDs the host library built as the
    port's own BddCollection, field for field equal to the JAX package's."""
    from bdd_tpu_torch.bdd.collection import BddCollection

    if name == "grid12":
        lp = grid_mrf(12, 12, 4, seed=0).write_lp()
    else:
        rng = np.random.RandomState(0)
        rows = []
        for r in range(6):
            vs = rng.choice(30, size=10, replace=False)
            co = rng.randint(1, 20, size=10)
            rows.append(f"r{r}: " + " + ".join(f"{a} x{v}" for a, v in zip(co, vs))
                        + f" >= {int(co.sum()) // 2}")
        lp = ("Minimize\n" + " + ".join(f"{1 + i % 7} x{i}" for i in range(30))
              + "\nSubject To\n" + "\n".join(rows) + "\nEnd")
    mine = tnative.NativeHost(lp, "bfs").collection()
    theirs = jnative.NativeHost(lp, "bfs").collection()
    assert isinstance(mine, BddCollection)
    assert mine.nr_bdds() == theirs.nr_bdds() > 1
    for field in ("var", "lo", "hi", "delim"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert [mine.level_variables(b) for b in range(mine.nr_bdds())] == [
        theirs.level_variables(b) for b in range(theirs.nr_bdds())]
