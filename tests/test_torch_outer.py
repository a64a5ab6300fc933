"""The outer loops of the port (L-BFGS, subgradient) vs the JAX package.

Inputs come from numpy seeds and cross to the port through
``layout.from_jax_arrays``, so both sides compute on identical arrays.

- float64: ``bdds_solution`` equal; ``net_solver_costs``,
  ``make_dual_feasible`` and ``gradient_step`` atol 1e-12 (the per-variable
  sums run in another order), on packed and unpacked layouts, a layout with a
  wide bucket (P = 128), and a state whose deferred marginals force one
  variable both ways (the inf - inf guard).
- bound trajectories of ``LbfgsSolver`` and ``SubgradientSolver`` over 40
  iterations: rel 1e-9 in float64 against the JAX package's host-driven path
  and its jitted path. In float32 rel 5e-6: the per-variable sums and the
  inner products run in another order, which float32 shows at some 1e-7
  relative per bound (observed 1.3e-7 at most); a step-search branch taken
  differently on the two sides would show as far more than the tolerance.
- ``BddSolver.solve`` with each of the four solver names against
  ``bdd_tpu.api`` (float64: bound rel 1e-9, same status and iteration count).
- the same loops over the dense backend (``DenseSolver``) against the JAX
  package's over ``JaxSolver`` (float64, abs 1e-9, its jitted and its
  host-driven path), the dense ``bdds_solution`` against the uniform one,
  and ``"dense mma"`` through ``BddSolver`` and the server.
"""
import math
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu import api as jax_api
from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.lbfgs import LbfgsSolver as JaxLbfgs
from bdd_tpu.solver.subgradient import SubgradientSolver as JaxSubgradient
from bdd_tpu.solver import flatten_collection as jflatten
from bdd_tpu.solver.uniform_wrapper import UniformSolver as JaxUniformSolver
from bdd_tpu.solver.wrapper import JaxSolver
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch import api
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor as PortPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string as port_parse
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.solver import uniform as tuf
from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
from bdd_tpu_torch.solver.flatten import flatten_collection
from bdd_tpu_torch.solver.lbfgs import LbfgsSolver, solution_gradient
from bdd_tpu_torch.solver.subgradient import SubgradientSolver
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils.problems import grid_mrf as port_grid_mrf
from tests import fixtures
from tests.test_torch_sweep import FORCING, GRID, assert_same, jax_setup
from tests.test_torch_wide import MIXED


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# name -> (LP, packed, variable order)
LAYOUTS = {
    "grid": (GRID, False, "bfs"),
    "grid_packed": (GRID, True, "bfs"),
    "matching_packed": (fixtures.MATCHING_3x3, True, "bfs"),
    "forcing": (FORCING, False, "bfs"),
    "wide": (MIXED, False, "input"),  # one bucket of P = 128 beside narrow ones
    "wide_packed": (MIXED, True, "input"),
}


def per_bucket(geom, flat):
    return geom.per_bucket(flat)


def forced_both_ways(host, state, port):
    """The JAX state with the deferred marginals of one variable set to +inf
    in one of its BDDs and -inf in another, so that the exchange hands every
    slot of the variable an infinite delta on both sides."""
    ids = port.geom.exchange.ids.numpy()
    valid = port.geom.exchange.valid.numpy()
    counts = np.bincount(ids[valid])
    var = int(np.argmax(counts >= 2))
    first, second = np.nonzero(valid & (ids == var))[0][:2]
    mm = np.concatenate([np.asarray(m).ravel() for m in state.def_mm])
    mm[first], mm[second] = np.inf, -np.inf
    out, off = [], 0
    for g in host.geom.buckets:
        n = g.H * g.B
        out.append(jnp.asarray(mm[off:off + n].reshape(g.H, g.B)))
        off += n
    return state._replace(def_mm=tuple(out))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dual_algebra_matches_jax_f64(name):
    lp, pack, order = LAYOUTS[name]
    host, state, _, _, port, ps, _, _ = jax_setup(lp, jnp.float64, pack, order=order)
    geom = port.geom
    if name.startswith("wide"):
        assert max(g.P for g in geom.buckets) == 128
    # the argmin solutions: equal
    want = uf.bdds_solution(host.geom, state)
    got = tuf.bdds_solution(geom, ps)
    for a, b in zip(got, want):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # x = hi - lo + deferred share
    assert_same(per_bucket(geom, tuf.net_solver_costs(geom, ps)),
                uf.net_solver_costs(host.geom, state), atol=1e-12)
    # zero-sum projection of a random per-layer vector
    rng = np.random.RandomState(3)
    gs = [rng.randn(g.H, g.B) for g in geom.buckets]
    flat = layout.flatten([torch.from_numpy(x) for x in gs])
    proj = tuf.make_dual_feasible(geom, flat)
    assert_same(per_bucket(geom, proj),
                uf.make_dual_feasible(host.geom, tuple(jnp.asarray(x) for x in gs)), atol=1e-12)
    sums = tuf.segment_reduce(geom, proj, "sum", 0.0)
    assert float(sums.abs().max()) < 1e-12
    # hi += step * g with a fresh backward run
    want = uf.gradient_step(host.geom, state, tuple(jnp.asarray(x) for x in gs), 0.37)
    got = tuf.gradient_step(geom, ps, flat, 0.37)
    for f in ("lo", "hi", "def_mm", "cft"):
        assert_same(getattr(got, f), getattr(want, f), atol=1e-12)
    assert got.flat[0] is ps.flat[0] and got.flat[2] is ps.flat[2]


@pytest.mark.parametrize("name", ["grid", "matching_packed", "wide"])
def test_net_costs_guard_a_variable_forced_both_ways(name):
    lp, pack, order = LAYOUTS[name]
    host, state, _, _, port, _, _, _ = jax_setup(lp, jnp.float64, pack, order=order)
    state = forced_both_ways(host, state, port)
    port, ps = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state), dtype=torch.float64)
    dl, dh = tuf.exchange_delta_flat(port.geom, ps.flat[2])
    assert bool((torch.isinf(dl) & torch.isinf(dh)).any())  # the case is what it says
    x = tuf.net_solver_costs(port.geom, ps)
    assert not torch.isnan(x).any()
    assert_same(per_bucket(port.geom, x), uf.net_solver_costs(host.geom, state), atol=1e-12)


# --------------------------------------------------------------- trajectories
def jax_base(jdt):
    ilp = grid_mrf(4, 4, 3, seed=5)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    return JaxUniformSolver(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                            nr_primal_vars=pre.nr_primal_variables, dtype=jdt), pre


def port_base(jdt):
    """The port's solver on the JAX solver's own arrays."""
    us, pre = jax_base(jdt)
    tdt = torch.float64 if jdt == jnp.float64 else torch.float32
    host, state = layout.from_jax_arrays(us.host, jax.tree.map(np.asarray, us.state), dtype=tdt)
    base = UniformSolver(host, pre.objective_vector())
    for a, b in zip(base.state.flat, state.flat):  # the port's own init gives the same state
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6 if tdt == torch.float32 else 1e-12)
    base.state = state
    return base


def trajectory(solver, n=40):
    out = []
    for _ in range(n):
        solver.iteration()
        out.append(solver.lower_bound())
    return out


def jax_trajectory(make, jdt, host_path):
    if host_path:
        os.environ["BDD_TPU_LBFGS_HOST"] = "1"
    try:
        solver = make(jax_base(jdt)[0])
        return trajectory(solver)
    finally:
        os.environ.pop("BDD_TPU_LBFGS_HOST", None)


TRAJECTORY_TOL = {"f64": dict(rtol=1e-9, atol=0), "f32": dict(rtol=5e-6, atol=0)}


@pytest.mark.parametrize("case", ["f64-host", "f64-jit", "f32-host"])
def test_lbfgs_trajectory_matches_jax(case):
    prec, path = case.split("-")
    jdt = jnp.float64 if prec == "f64" else jnp.float32
    want = jax_trajectory(JaxLbfgs, jdt, host_path=path == "host")
    sk.reset_launch_counts()
    solver = LbfgsSolver(port_base(jdt))
    got = trajectory(solver)
    np.testing.assert_allclose(got, want, **TRAJECTORY_TOL[prec])
    assert len(solver.history) == solver.m  # the two-loop recursion did run
    assert got[-1] > got[0]
    assert not any(sk.LAUNCHES.values())  # CPU tensors: the plain versions


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_subgradient_trajectory_matches_jax(prec):
    jdt = jnp.float64 if prec == "f64" else jnp.float32
    want = jax_trajectory(JaxSubgradient, jdt, host_path=False)
    got = trajectory(SubgradientSolver(port_base(jdt)))
    np.testing.assert_allclose(got, want, **TRAJECTORY_TOL[prec])


def test_lbfgs_update_costs_flushes_history():
    solver = LbfgsSolver(port_base(jnp.float64))
    trajectory(solver, 12)
    assert len(solver.history) > 0 and solver.prev_x is not None
    solver.num_unsuccessful = 3
    hi_before = solver.base.state.flat[1].clone()
    V = solver.base.geom.V
    solver.update_costs(np.zeros(V), np.full(V, 0.25))
    assert len(solver.history) == 0 and solver.prev_x is None and solver.prev_grad is None
    assert solver.num_unsuccessful == 0
    assert not torch.equal(solver.base.state.flat[1], hi_before)  # the base took the update
    solver.iteration()  # and goes on from an empty history
    assert len(solver.history) == 0 and solver.prev_x is not None


def test_solution_gradient_is_flat_and_masked():
    base = port_base(jnp.float64)
    g = solution_gradient(base)
    assert g.shape == (base.geom.plan.E,) and g.dtype == torch.float64
    assert set(np.unique(g.numpy())) <= {0.0, 1.0}
    assert not g[~base.geom.exchange.valid].any()


# ------------------------------------------------------------------- the API
SOLVER_NAMES = ["lbfgs parallel mma", "lbfgs cuda parallel mma", "lbfgs jax mma", "subgradient"]


@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_bdd_solver_solves_like_jax(name, monkeypatch):
    """Each of the four names through both ``BddSolver``s. The JAX side runs
    its default (jitted) path for the first L-BFGS name and its host-driven
    path for the two aliases (a jitted block compiles anew for every solver
    object); both paths stop after the same 40 iterations."""
    if name in SOLVER_NAMES[1:3]:
        monkeypatch.setenv("BDD_TPU_LBFGS_HOST", "1")
    cfg = {"precision": "double", "relaxation solver": name, "perturbation rounding": False,
           "lbfgs": {"history size": 4, "initial step size": 1e-5},
           "termination criteria": {"maximum iterations": 40, "minimum improvement": 0.0,
                                    "improvement slope": 0.0}}
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=GRID)
    want = ref.solve(verbose=False)
    s = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=GRID)
    got = s.solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["iterations"] == want["iterations"] == 40
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], rel=1e-9)
    outer = s.solver
    if name == "subgradient":
        assert isinstance(outer, SubgradientSolver)
    else:
        assert isinstance(outer, LbfgsSolver) and (outer.m, outer.step_size != 1e-6) == (4, True)
    assert isinstance(outer.base, UniformSolver)


def test_lbfgs_with_rounding_finds_the_jax_solution():
    cfg = {"precision": "double", "relaxation solver": "lbfgs parallel mma",
           "termination criteria": {"maximum iterations": 100}}
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=fixtures.MATCHING_3x3)
    want = ref.solve(verbose=False)
    got = api.BddSolver(dict(cfg), device="cpu").read_ilp(
        lp_string=fixtures.MATCHING_3x3).solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], rel=1e-9)
    assert got["objective"] == pytest.approx(want["objective"], abs=1e-9)


def test_best_rounding_under_lbfgs_restores_the_base_state(monkeypatch):
    """Every heuristic of ``"best"`` starts from the converged dual state,
    which an outer-loop wrapper holds on ``.base``."""
    cfg = {"precision": "double", "relaxation solver": "lbfgs parallel mma",
           "rounding method": "best", "termination criteria": {"maximum iterations": 30}}
    s = api.BddSolver(cfg, device="cpu").read_ilp(lp_string=GRID)
    s.process_ilp().transform_to_bdds().construct_solver()
    s.solve_dual(verbose=False)
    assert isinstance(s.solver, LbfgsSolver) and not hasattr(s.solver, "state")
    converged = [t.clone() for t in s.solver.base.state.flat]
    seen = []

    def heuristic(solver, *args, **kwargs):
        seen.append([t.clone() for t in solver.base.state.flat])
        V = solver.base.geom.V
        solver.update_costs(np.full(V, 0.5), np.zeros(V))  # perturb in place, find nothing
        return None

    from bdd_tpu_torch.solver import extras

    monkeypatch.setattr(api, "incremental_mm_rounding", heuristic)
    monkeypatch.setattr(extras, "wedelin_rounding", heuristic)
    assert s.round(verbose=False) is None
    assert len(seen) == 3
    for start in seen:
        for a, b in zip(start, converged):
            assert torch.equal(a, b)


def test_cli_and_server_take_the_outer_solvers(tmp_path):
    """The same config through the CLI and through a server request."""
    import json

    from bdd_tpu_torch import serve

    lp = tmp_path / "inst.lp"
    lp.write_text(fixtures.MATCHING_3x3)
    cfg = {"input": str(lp), "precision": "double", "relaxation solver": "lbfgs jax mma",
           "lbfgs": {"history size": 3}, "termination criteria": {"maximum iterations": 30}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert api.main([str(path), "--device", "cpu"]) == 0
    direct = api.BddSolver(dict(cfg), device="cpu").solve(verbose=False)
    for name in ("lbfgs jax mma", "subgradient"):
        got = serve.handle_request({**cfg, "relaxation solver": name}, device="cpu")
        assert got["status"] == "solved" and math.isfinite(got["lower_bound"])
        if name == "lbfgs jax mma":
            assert got["lower_bound"] == direct["lower_bound"]
            assert got["solution"] == direct["solution"]
    dense = serve.handle_request({**cfg, "relaxation solver": "dense mma"}, device="cpu")
    ref = jax_api.BddSolver({**cfg, "relaxation solver": "dense mma"})
    ref.read_ilp(lp_string=fixtures.MATCHING_3x3)
    want = ref.solve(verbose=False)
    assert dense["status"] == want["status"] == "solved"
    assert dense["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert dense["solution"] == want["solution"]


def test_keys_that_still_wait_raise():
    """No solver name of the JAX package waits any more: each solves through
    ``BddSolver`` on the CPU. "dense mma" gives the JAX package's bound and
    solution; with "tighten" it keeps its bound (the dense solver exposes no
    layer costs); ``solve_batch`` refuses it as the JAX package does."""
    for name in ("hybrid mma", "multi parallel mma", "hybrid parallel mma",  # ported
                 "sharded mma", "subgradient sharded mma", "lbfgs sharded mma", "dense mma"):
        assert math.isfinite(api.BddSolver({"relaxation solver": name}, device="cpu")
                             .read_ilp(lp_string=fixtures.MATCHING_3x3)
                             .solve(verbose=False)["lower_bound"])
    assert math.isfinite(api.BddSolver({"relaxation solver": "subgradient"}, device="cpu")
                         .read_ilp(lp_string=fixtures.MATCHING_3x3).solve(verbose=False)["lower_bound"])
    cfg = {"relaxation solver": "dense mma", "precision": "double",
           "termination criteria": {"maximum iterations": 60}}
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=GRID)
    want = ref.solve(verbose=False)
    s = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=GRID)
    got = s.solve(verbose=False)
    assert isinstance(s.solver, DenseSolver)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["solution"] == want["solution"]
    tight = api.BddSolver({**cfg, "tighten": True, "perturbation rounding": False},
                          device="cpu").read_ilp(lp_string=GRID).solve(verbose=False)
    assert "tighten" not in tight
    assert tight["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    with pytest.raises(ValueError, match="uniform-mma"):
        api.BddSolver(dict(cfg), device="cpu").solve_batch(
            ilps=[port_parse(fixtures.MATCHING_3x3)], verbose=False)


# ------------------------------------------------------- the dense backend
def dense_bases(seed=5):
    """The JAX package's ``JaxSolver`` and the port's ``DenseSolver`` on the
    same grid (float64), each through its own pipeline."""
    ilp, port_ilp = grid_mrf(4, 4, 3, seed=seed), port_grid_mrf(4, 4, 3, seed=seed)
    ilp.normalize()
    port_ilp.normalize()
    pre, tpre = BddPreprocessor(ilp), PortPreprocessor(port_ilp)
    obj = pre.objective_vector()
    np.testing.assert_array_equal(obj, tpre.objective_vector())
    return (JaxSolver(jflatten(pre.collection, pre.total_nr_variables(),
                               pre.nr_primal_variables), obj, dtype=jnp.float64),
            DenseSolver(flatten_collection(tpre.collection, tpre.total_nr_variables(),
                                           tpre.nr_primal_variables),
                        obj, dtype=torch.float64, device="cpu"))


def dense_trajectory(make, host_path, n=40):
    if host_path:
        os.environ["BDD_TPU_LBFGS_HOST"] = "1"
    try:
        j, t = dense_bases()
        want = trajectory(make[0](j), n)
    finally:
        os.environ.pop("BDD_TPU_LBFGS_HOST", None)
    solver = make[1](t)
    return trajectory(solver, n), want, solver


@pytest.mark.parametrize("path", ["jit", "host"])
def test_dense_lbfgs_trajectory_matches_jax(path):
    sk.reset_launch_counts()
    got, want, solver = dense_trajectory((JaxLbfgs, LbfgsSolver), host_path=path == "host")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert solver.ops.dense and len(solver.history) == solver.m  # the two-loop recursion ran
    assert got[-1] > got[0]
    assert solver.history[0].s.shape == (solver.base.geom.H * solver.base.geom.L,)
    assert not any(sk.LAUNCHES.values())


def test_dense_subgradient_trajectory_matches_jax():
    got, want, solver = dense_trajectory((JaxSubgradient, SubgradientSolver), host_path=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert solver.ops.dense


def test_dense_solution_gradient_is_flat_and_masked():
    _, t = dense_bases()
    t.iteration_block(3)
    g = solution_gradient(t)
    geom = t.geom
    assert g.shape == (geom.H * geom.L,) and g.dtype == torch.float64
    assert set(np.unique(g.numpy())) <= {0.0, 1.0}
    assert not g[~geom.layer_valid.reshape(-1)].any()


def test_dense_bdds_solution_equals_the_uniform_one():
    """As tests/test_outer_solvers.py's uniform-vs-dense test: the per-(BDD,
    variable) choices of the dense and the uniform backend on the same
    collection and costs agree exactly."""
    pre = PortPreprocessor(port_parse(fixtures.MATCHING_3x3))
    flat = flatten_collection(pre.collection, pre.total_nr_variables(), pre.nr_primal_variables)
    d = DenseSolver(flat, pre.objective_vector(), dtype=torch.float64, device="cpu")
    us = UniformSolver.from_collection(pre.collection, pre.total_nr_variables(),
                                       pre.objective_vector(),
                                       nr_primal_vars=pre.nr_primal_variables,
                                       dtype=torch.float64, device="cpu")
    for solver in (d, us):
        solver.iteration_block(2)
    votes_d = {}
    sol = d.bdds_solution().numpy()
    lvar, lbdd = d.dense.layer_var, d.dense.layer_bdd
    for h, l in zip(*np.nonzero(d.dense.layer_valid)):
        votes_d[(int(lbdd[h, l]), int(lvar[h, l]))] = int(sol[h, l])
    votes_u = {}
    for g, s_, lb in zip(us.geom.buckets, tuf.bdds_solution(us.geom, us.state), us.host.layer_bdd):
        lv, valid = g.layer_var.numpy(), g.layer_valid.numpy()
        for h, b in zip(*np.nonzero(valid)):
            votes_u[(int(lb[h, b]), int(lv[h, b]))] = int(s_[h, b])
    assert len(votes_d) == int(flat.valid_layer_mask().sum())
    assert votes_d == votes_u


@pytest.mark.parametrize("method", ["incremental", "wedelin", "biased", "best"])
def test_dense_mma_rounds_like_jax(method):
    """The host roundings over the dense backend (``min_marginals`` /
    ``update_costs``; "best" restores the dense state between heuristics):
    the JAX package's bound and solution (float64)."""
    cfg = {"relaxation solver": "dense mma", "precision": "double", "rounding method": method,
           "termination criteria": {"maximum iterations": 40}}
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=fixtures.MATCHING_3x3)
    want = ref.solve(verbose=False)
    got = api.BddSolver(dict(cfg), device="cpu").read_ilp(
        lp_string=fixtures.MATCHING_3x3).solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert "solution" in got and got["solution"] == want["solution"]
    assert got["objective"] == pytest.approx(want["objective"], abs=1e-9)
