"""bdd_tpu_torch on-device rounding vs bdd_tpu.solver.rounding_device.

The random streams of jax.random and torch differ, so the port takes the
uniform draws through its ``draws`` hook: fed JAX's own draws (the key chain
of ``incremental_mm_rounding_device``), the port must follow the JAX
rounding trajectory exactly (float64).
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.solver import rounding_device as jrd
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.rounding import incremental_mm_rounding
from bdd_tpu.solver.uniform_wrapper import UniformSolver as JaxUniformSolver
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import rounding_device as trd
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from tests import fixtures


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


def jax_draws(seed=0):
    """The draws JAX's device rounding makes, round by round."""
    key = jax.random.PRNGKey(seed)
    uniform = jax.jit(
        lambda k, d, n: jax.random.uniform(k, (n,), minval=-d, maxval=d),
        static_argnums=2,
    )

    def draw(V, delta):
        nonlocal key
        key, sub = jax.random.split(key)
        return np.asarray(uniform(sub, delta, V))

    return draw


def build(lp=None, ilp=None, precision="double"):
    if ilp is None:
        ilp = parse_lp_string(lp)
    pre = BddPreprocessor(ilp)
    jdt, tdt = {"double": (jnp.float64, torch.float64),
                "float": (jnp.float32, torch.float32)}[precision]
    jhost = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables, dtype=jdt
    )
    s = UniformSolver(layout.from_jax_arrays(jhost, dtype=tdt), pre.objective_vector())
    js = JaxUniformSolver.from_host(jhost, pre.objective_vector(), dtype=jdt)
    return ilp, s, js


def jax_draws_for_key(key, delta, V):
    return np.asarray(jax.jit(
        lambda k, d: jax.random.uniform(k, (V,), minval=-d, maxval=d)
    )(key, delta))


def _state_close(a, b, atol=1e-12):
    for f in ("lo", "hi", "def_mm", "cft"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            x, y = x.numpy(), np.asarray(y)
            np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
            fin = np.isfinite(x)
            np.testing.assert_array_equal(x[~fin], y[~fin])
            np.testing.assert_allclose(x[fin], y[fin], atol=atol)


@pytest.mark.parametrize(
    "lp", [fixtures.TWO_SIMPLEX, fixtures.MATCHING_3x3, grid_mrf(3, 3, 3, seed=1)],
    ids=["two_simplex", "matching", "grid"],
)
def test_classify_and_perturb_match_jax(lp):
    ilp, s, js = build(lp) if isinstance(lp, str) else build(ilp=lp)
    s.iteration_block(20)
    js.iteration_block(20)
    _state_close(s.state, js.state, atol=1e-10)
    # carry JAX's state over so both classify identical inputs
    _, state = layout.from_jax_arrays(js.host, jax.tree.map(np.asarray, js.state))
    types, sum0, sum1, stats, sol = trd._classify(s.geom, state)
    jtypes, jsum0, jsum1, jstats, jsol = jrd._classify(js.geom, js.state)
    np.testing.assert_array_equal(types.numpy(), np.asarray(jtypes))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    np.testing.assert_array_equal(sol.numpy(), np.asarray(jsol))
    np.testing.assert_allclose(sum0.numpy(), np.asarray(jsum0), atol=1e-9)
    np.testing.assert_allclose(sum1.numpy(), np.asarray(jsum1), atol=1e-9)
    key = jax.random.PRNGKey(3)
    delta = 0.37
    r = jax_draws_for_key(key, delta, js.geom.V)
    V = js.geom.V
    tilt = np.zeros(V, dtype=np.float32)
    jnew = jrd._perturb(js.geom, js.state, jtypes, jsum0, jsum1, key, delta, jnp.asarray(tilt))
    new = trd._perturb(s.geom, state, types, sum0, sum1, r, delta, torch.zeros(V, dtype=torch.float64))
    _state_close(new, jnew)


def test_rounding_trajectory_matches_jax_with_injected_draws():
    """TWO_SIMPLEX needs perturbation rounds (ties): with JAX's draws the
    port lands on JAX's solution."""
    ilp, s, js = build(fixtures.TWO_SIMPLEX)
    s.iteration_block(100)
    js.iteration_block(100)
    sol = trd.incremental_mm_rounding_device(s, verbose=False, draws=jax_draws(0))
    jsol = jrd.incremental_mm_rounding_device(js, verbose=False, seed=0)
    assert sol is not None and jsol is not None
    np.testing.assert_array_equal(sol, np.asarray(jsol))


def test_device_rounding_matches_host_rounding():
    ilp, s, _ = build(fixtures.MATCHING_3x3)
    s.iteration_block(200)
    sol_dev = trd.incremental_mm_rounding_device(s, verbose=False)
    assert sol_dev is not None
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    x = [int(v) for v in sol_dev[: ilp.nr_variables()]]
    assert ilp.evaluate(x) == pytest.approx(opt)

    _, s2, _ = build(fixtures.MATCHING_3x3)
    s2.iteration_block(200)
    sol_host = incremental_mm_rounding(s2, verbose=False)
    x2 = [int(v) for v in sol_host[: ilp.nr_variables()]]
    assert ilp.evaluate(x2) == pytest.approx(opt)


@pytest.mark.parametrize("precision", ["double", "float"])
def test_device_rounding_perturbation_progress(precision):
    """On an instance with ties, device rounding must perturb (torch
    generator draws) and still land on a feasible solution."""
    ilp, s, _ = build(fixtures.TWO_SIMPLEX, precision=precision)
    s.iteration_block(100)
    sol = trd.incremental_mm_rounding_device(s, verbose=False)
    assert sol is not None
    x = [int(v) for v in sol[: ilp.nr_variables()]]
    assert ilp.feasible(x)


def test_default_draws_are_seeded():
    """Without a hook the draws come from a torch.Generator seeded by
    ``seed``: one seed, one trajectory; another seed, another."""
    runs = []
    for seed in (5, 5, 6):
        _, s, _ = build(fixtures.TWO_SIMPLEX)
        s.iteration_block(100)
        sol = trd.incremental_mm_rounding_device(s, verbose=False, seed=seed)
        runs.append((sol, torch.cat([x.reshape(-1) for x in s.state.hi])))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], runs[2][1])
