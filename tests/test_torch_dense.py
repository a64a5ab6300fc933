"""The dense backend of the port (``bdd_tpu_torch/solver/dense.py``,
``dense_wrapper.py``) against the JAX package's (``bdd_tpu/solver/
jax_solver.py``, ``wrapper.py``) and the numpy oracle ``RefSolver``.

Both packages build each instance through their own pipelines (copies of one
another; the dense arrays are held equal first). Perturbed states are made
from a numpy seed on the JAX side and carried across with
``dense_wrapper.from_jax_arrays``, so both sides compute on identical inputs.

Tolerances: float64 atol 1e-12 with equal ±inf patterns (the per-variable
sums run over the layers sorted by variable, JAX's over the flat order);
float32 rel 1e-5. ``bdds_solution`` equal exactly. Against ``RefSolver``
the tolerances of tests/test_jax_solver.py (1e-9 bounds and marginals, 1e-8
after iterations).
"""
import functools
import math

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as jparse
from bdd_tpu.solver import RefSolver as JaxRefSolver
from bdd_tpu.solver import flatten_collection as jflatten
from bdd_tpu.solver import jax_solver as js
from bdd_tpu.solver.flatten import densify as jdensify
from bdd_tpu.solver.wrapper import JaxSolver
from bdd_tpu.utils.problems import grid_mrf, set_cover
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver import dense as dn
from bdd_tpu_torch.solver import dense_wrapper as dw
from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
from bdd_tpu_torch.solver.flatten import densify, flatten_collection
from tests import fixtures


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _deep():
    """The set-cover rows of tests/test_prefix.py's "deep bucket" (13 hops)."""
    ilp = set_cover(60, 80, density=0.1, seed=2)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp.write_lp()


CASES = {
    "chain": lambda: fixtures.SHORT_MRF_CHAIN,
    "matching": lambda: fixtures.MATCHING_3x3,
    "two_simplex": lambda: fixtures.TWO_SIMPLEX,
    "covering": lambda: fixtures.COVERING,
    "grid": lambda: grid_mrf(3, 3, 2, seed=1).write_lp(),
    "infeasible": lambda: fixtures.INFEASIBLE,
    "deep": _deep,
}
NAMES = list(CASES)
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@functools.lru_cache(maxsize=None)
def both(name):
    """(JAX flat, JAX dense, objective, port flat, port dense) of an instance."""
    lp = CASES[name]()
    jp, tp = JaxPreprocessor(jparse(lp)), BddPreprocessor(parse_lp_string(lp))
    jf = jflatten(jp.collection, jp.total_nr_variables(), jp.nr_primal_variables)
    tf = flatten_collection(tp.collection, tp.total_nr_variables(), tp.nr_primal_variables)
    np.testing.assert_array_equal(jp.objective_vector(), tp.objective_vector())
    return jf, jdensify(jf), np.asarray(jp.objective_vector()), tf, densify(tf)


def setup(name, dtype=torch.float64):
    jf, jd, obj, tf, td = both(name)
    jg = js.geom_from_dense(jd, dtype=JDT[dtype])
    jst = js.init_state(jg, jd, obj, dtype=JDT[dtype])
    tg = dn.geom_from_dense(td, dtype=dtype, device="cpu")
    return jd, jg, jst, td, tg, dn.init_state(tg, td, obj), obj


def perturbed(jd, jg, jst, dtype, seed=0, force=True):
    """The JAX state after 3 iterations with seeded noise on the costs and
    deferred marginals; ``force``: one valid layer's deferred marginal +inf
    and another's -inf (forcing). Returns the JAX state and the port's."""
    st = js.iterations(jg, jst, 3, 0.5)
    rng = np.random.RandomState(seed)
    valid = np.asarray(jd.layer_valid)
    lo, hi, mm = (np.array(x, dtype=np.float64) for x in (st.lo, st.hi, st.def_mm))
    lo[valid] += rng.randn(int(valid.sum()))
    hi[valid] += rng.randn(int(valid.sum()))
    mm[valid] = rng.randn(int(valid.sum()))
    if force:
        h, l = np.nonzero(valid)
        mm[h[0], l[0]] = np.inf
        mm[h[-1], l[-1]] = -np.inf
    jdt = JDT[dtype]
    st = st._replace(lo=jnp.asarray(lo, jdt), hi=jnp.asarray(hi, jdt), def_mm=jnp.asarray(mm, jdt))
    st = st._replace(cft=js.backward_run(jg, st.lo, st.hi))
    return st, dw.from_jax_arrays(jd, jax.tree.map(np.asarray, st), dtype=dtype)


def assert_same(got, want, dtype=torch.float64):
    """Equal ±inf (and NaN) patterns; float64 atol 1e-12, float32 rel 1e-5."""
    a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(want)
    assert a.shape == b.shape
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(a[~fa], b[~fb])
    if dtype == torch.float64:
        np.testing.assert_allclose(a[fa], b[fb], rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(a[fa], b[fb], rtol=1e-5, atol=1e-5)


def assert_state(got, want, dtype=torch.float64):
    for f in dn.SolverState._fields:
        assert_same(getattr(got, f), getattr(want, f), dtype)


# ------------------------------------------------------------------ geometry
@pytest.mark.parametrize("name", NAMES)
def test_geom_from_dense_equals_jax(name):
    jd, jg, _, td, tg, _, _ = setup(name)
    for f in ("H", "W", "L"):
        assert getattr(td, f) == getattr(jd, f)
    for f in js.DenseGeom._fields:
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=f)
    assert (tg.H, tg.W, tg.L, tg.V) == (jg.H, jg.W, jg.L, jg.V)
    assert tg.dtype == torch.float64 and tg.device.type == "cpu"


# --------------------------------------------------- init, runs, marginals
@pytest.mark.parametrize("name", NAMES)
def test_init_runs_and_min_marginals_equal_jax(name):
    jd, jg, jst, td, tg, tst, _ = setup(name)
    assert_state(tst, jst)
    st, ps = perturbed(jd, jg, jst, torch.float64)
    assert_same(dn.forward_run(tg, ps.lo, ps.hi), js.forward_run(jg, st.lo, st.hi))
    assert_same(dn.backward_run(tg, ps.lo, ps.hi), js.backward_run(jg, st.lo, st.hi))
    want = js.min_marginals(jg, st.lo, st.hi)
    for cft in (None, ps.cft):
        for a, b in zip(dn.min_marginals(tg, ps.lo, ps.hi, cft), want):
            assert_same(a, b)
    assert_same(dn.lower_bound(tg, ps), js.lower_bound(jg, st))
    assert_same(dn.lower_bound_from_cft(tg, ps.cft), js.lower_bound_from_cft(jg, st.cft))
    assert_same(dn.lower_bound_per_root_slot(tg, ps.cft), js.lower_bound_per_root_slot(jg, st.cft))


@pytest.mark.parametrize("name", NAMES)
def test_compute_delta_with_forcing_equals_jax(name):
    jd, jg, jst, _, tg, _, _ = setup(name)
    st, ps = perturbed(jd, jg, jst, torch.float64)
    got, want = dn.compute_delta(tg, ps.def_mm), js.compute_delta(jg, st.def_mm)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert bool(torch.isinf(got[0]).any() or torch.isinf(got[1]).any())  # the forcing shows
    assert float(got[0][-1]) == float(got[1][-1]) == 0.0  # the padding slot V


# ----------------------------------------------------------------- sweeps
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_half_sweeps_from_a_perturbed_state_equal_jax(name, dtype):
    jd, jg, jst, _, tg, _, _ = setup(name, dtype)
    st, ps = perturbed(jd, jg, jst, dtype, seed=1)
    st_f, cfr = js.forward_iteration(jg, st, 0.5)
    ps_f, tcfr = dn.forward_iteration(tg, ps, 0.5)
    assert_state(ps_f, st_f, dtype)
    assert_same(tcfr, cfr, dtype)
    assert_state(dn.backward_iteration(tg, ps_f, 0.5, tcfr),
                 js.backward_iteration(jg, st_f, 0.5, cfr), dtype)
    # a precomputed delta pair (what the sharded solve passes) gives the same
    delta = dn.compute_delta(tg, ps.def_mm)
    got, _ = dn.forward_iteration(tg, ps, 0.5, delta=delta)
    for a, b in zip(got, ps_f):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_fifteen_iterations_equal_jax(name, dtype):
    jd, jg, jst, _, tg, tst, _ = setup(name, dtype)
    want = js.iterations(jg, jst, 15, 0.5)
    got = tst
    for _ in range(15):
        got = dn.iteration(tg, got, 0.5)
    assert_state(got, want, dtype)
    block = dn.iterations(tg, tst, 15, 0.5)
    for a, b in zip(block, got):  # iterations(n) is n calls of iteration
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert_same(dn.distribute_delta(tg, got).lo, js.distribute_delta(jg, want).lo, dtype)
    assert_same(dn.lower_bound_with_deferred(tg, got), js.lower_bound_with_deferred(jg, want),
                dtype)
    assert_same(dn.lower_bound(tg, got), js.lower_bound(jg, want), dtype)


@pytest.mark.parametrize("name", NAMES)
def test_distribute_delta_equals_jax(name):
    jd, jg, jst, _, tg, _, _ = setup(name)
    st, ps = perturbed(jd, jg, jst, torch.float64, seed=2, force=False)
    got, want = dn.distribute_delta(tg, ps), js.distribute_delta(jg, st)
    assert_state(got, want)
    assert not got.def_mm.any()


# --------------------------------------------------- solutions, dual algebra
@pytest.mark.parametrize("name", NAMES)
def test_bdds_solution_equals_jax_exactly(name):
    jd, jg, jst, _, tg, _, _ = setup(name)
    for seed in (3, 4):
        st, ps = perturbed(jd, jg, jst, torch.float64, seed=seed, force=False)
        got = dn.bdds_solution(tg, ps.lo, ps.hi)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(js.bdds_solution(jg, st.lo, st.hi)))


@pytest.mark.parametrize("name", NAMES)
def test_dual_algebra_equals_jax(name):
    jd, jg, jst, _, tg, _, _ = setup(name)
    st, ps = perturbed(jd, jg, jst, torch.float64, seed=5, force=False)
    assert_same(dn.net_solver_costs(tg, ps), js.net_solver_costs(jg, st))
    rng = np.random.RandomState(6)
    g = rng.randn(jd.H, jd.L)
    proj = dn.make_dual_feasible(tg, torch.from_numpy(g))
    assert_same(proj, js.make_dual_feasible(jg, jnp.asarray(g)))
    assert float(dn.var_sums(tg, proj).abs().max()) < 1e-12
    assert_state(dn.gradient_step(tg, ps, torch.from_numpy(g), 0.37),
                 js.gradient_step(jg, st, jnp.asarray(g), 0.37))


@pytest.mark.parametrize("name", ["chain", "matching", "grid", "deep"])
def test_net_costs_guard_the_infinite_cases(name):
    """jax_solver.py:524-531: a variable forced one way gives ±inf, one
    forced both ways (dl = dh = +inf) a share of 0, not NaN."""
    jd, jg, jst, _, tg, _, _ = setup(name)
    st, _ = perturbed(jd, jg, jst, torch.float64, seed=7, force=False)
    lv = np.asarray(jd.layer_var)
    valid = np.asarray(jd.layer_valid)
    shared = np.nonzero(np.bincount(lv[valid]) >= 2)[0]
    assert shared.size >= 2
    mm = np.array(st.def_mm)
    h, l = np.nonzero(valid & (lv == shared[0]))  # forced both ways
    mm[h[0], l[0]], mm[h[1], l[1]] = np.inf, -np.inf
    h, l = np.nonzero(valid & (lv == shared[1]))  # forced one way
    mm[h[0], l[0]] = np.inf
    st = st._replace(def_mm=jnp.asarray(mm))
    ps = dw.from_jax_arrays(jd, jax.tree.map(np.asarray, st), dtype=torch.float64)
    got = dn.net_solver_costs(tg, ps)
    assert not torch.isnan(got).any() and bool(torch.isinf(got).any())
    assert_same(got, js.net_solver_costs(jg, st))


# ------------------------------------------------------------- DenseSolver
def solvers(name, dtype=torch.float64):
    jf, jd, obj, tf, td = both(name)
    return (JaxSolver(jf, obj, dtype=JDT[dtype], dense=jd),
            DenseSolver(tf, obj, dtype=dtype, device="cpu", dense=td), jf, obj)


@pytest.mark.parametrize("name", NAMES)
def test_dense_solver_equals_jax_solver(name):
    j, t, _, _ = solvers(name)
    assert t.default_block_size == j.default_block_size == 10
    t.iteration_block(4)
    j.iteration_block(4)
    t.iteration()
    j.iteration()
    for a, b in ((t.lower_bound(), j.lower_bound()),
                 (t.lower_bound_with_deferred(), j.lower_bound_with_deferred())):
        assert a == b or a == pytest.approx(b, abs=1e-12)
    assert_same(t.lower_bound_per_bdd(), j.lower_bound_per_bdd())
    for a, b in zip(t.min_marginals(), j.min_marginals()):
        assert a.shape == (t.f.nr_layers,)
        assert_same(a, b)
    for a, b in zip(t.get_flat_costs(), j.get_flat_costs()):
        assert_same(a, b)
    V = t.f.nr_vars
    rng = np.random.RandomState(8)
    lo_u, hi_u = rng.randn(V), rng.randn(V)
    hi_u[0] = np.inf  # the rounding's forcing
    t.update_costs(lo_u, hi_u)
    j.update_costs(lo_u, hi_u)
    assert_state(t.state, j.state)
    t.distribute_delta()
    j.distribute_delta()
    assert_state(t.state, j.state)
    lo, hi, mm = j.get_flat_costs()
    t.set_flat_costs(lo, hi + 0.25, mm)
    j.set_flat_costs(lo, hi + 0.25, mm)
    assert_state(t.state, j.state)
    t.set_flat_costs(lo, hi)
    assert not t.state.def_mm.any()


@pytest.mark.parametrize("name", ["chain", "matching", "two_simplex", "covering", "grid"])
def test_dense_solver_matches_the_numpy_oracle(name):
    """As tests/test_jax_solver.py: initial bound and min marginals 1e-9, ten
    iterations' costs 1e-8, the bound with deferred deltas 1e-8."""
    _, t, jf, obj = solvers(name)
    ref = JaxRefSolver(jf, obj, dtype=np.float64)
    assert t.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-9)
    for a, b in zip(t.min_marginals(), ref.min_marginals()):
        both_inf = np.isinf(a) & np.isinf(b)
        np.testing.assert_allclose(a[~both_inf], b[~both_inf], atol=1e-9)
    for _ in range(10):
        t.iteration()
        ref.iteration(0.5)
    for a, b in zip(t.get_flat_costs(), (ref.lo_cost, ref.hi_cost, ref.def_mm)):
        valid = jf.valid_layer_mask()
        a, b = a[valid], b[valid]
        same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        np.testing.assert_allclose(a[~same_inf], b[~same_inf], atol=1e-8)
    assert t.lower_bound_with_deferred() == pytest.approx(ref.lower_bound_with_deferred(),
                                                          abs=1e-8)


def test_infeasible_bound_goes_to_infinity():
    _, t, _, _ = solvers("infeasible")
    t.iteration_block(50)
    assert t.lower_bound_with_deferred() == math.inf


@pytest.mark.parametrize("name", ["matching", "grid", "deep"])
def test_float32_runs_are_bit_identical_and_near_jax(name):
    runs = []
    for _ in range(2):
        j, t, _, _ = solvers(name, torch.float32)
        t.iteration_block(30)
        runs.append((t.lower_bound_with_deferred(), [x.clone() for x in t.state]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    j.iteration_block(30)
    assert runs[0][0] == pytest.approx(j.lower_bound_with_deferred(), rel=1e-5, abs=1e-5)


def test_matching_converges_to_the_optimum_f32():
    """As tests/test_jax_solver.py's test_convergence_f32."""
    _, t, _, _ = solvers("matching", torch.float32)
    t.iteration_block(200)
    opt, _ = fixtures.brute_force_ilp_optimum(parse_lp_string(fixtures.MATCHING_3x3))
    assert t.lower_bound_with_deferred() == pytest.approx(opt, abs=1e-3)


def test_from_jax_arrays_refuses_other_shapes():
    jf, jd, obj, tf, td = both("matching")
    jg = js.geom_from_dense(jd, dtype=jnp.float64)
    st = js.init_state(jg, jd, obj, dtype=jnp.float64)
    ps = dw.from_jax_arrays(jd, jax.tree.map(np.asarray, st))
    assert [tuple(x.shape) for x in ps] == [(jd.H, jd.L)] * 3 + [(jd.H, jd.W)]
    with pytest.raises(ValueError, match="do not match"):
        dw.from_jax_arrays(both("chain")[1], jax.tree.map(np.asarray, st))
    with pytest.raises(ValueError, match="do not match"):
        dw.from_jax_arrays(jd, [np.asarray(st.lo)] * 3)


def test_dense_solver_defaults_to_the_card():
    _, _, obj, tf, _ = both("matching")
    if torch.cuda.is_available():
        assert DenseSolver(tf, obj).state.lo.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DenseSolver(tf, obj)
