"""The smooth solvers of the port (``solver/smooth.py``, ``solver/smooth_mma.py``)
against the JAX package's.

The same LP goes through both packages' Python pipelines (the port's
``BddPreprocessor`` and ``flatten_uniform`` are copies, so both build the same
layout); states are carried across with ``layout.from_jax_arrays`` so that
both sides sweep identical inputs. Smooth runs, sum marginals, the smooth
bound, soft solutions and whole ``SmoothSolver`` trajectories, with and
without annealing, packed and unpacked, with a scalar and a per-column
temperature: float64 within rel 1e-9, float32 within 1e-4 (the port's
frontier relaxation sums the same terms in another order than the JAX
package's dense candidate matrix).
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.solver import smooth as jsm
from bdd_tpu.solver import smooth_mma as jsmma
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils.problems import set_cover as j_set_cover
from bdd_tpu_torch import api
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import smooth as sm
from bdd_tpu_torch.solver import smooth_mma as smma
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.utils.problems import set_cover
from tests import fixtures
from tests.test_torch_wide import MIXED

TOL = {jnp.float64: dict(rtol=1e-9, atol=1e-9), jnp.float32: dict(rtol=1e-4, atol=1e-4)}
TDT = {jnp.float64: torch.float64, jnp.float32: torch.float32}
LPS = {"two_simplex": fixtures.TWO_SIMPLEX, "covering": fixtures.COVERING,
       "matching": fixtures.MATCHING_3x3, "mixed_wide": MIXED}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def preprocessors(lp=None, ilps=None):
    """(JAX, port) preprocessors of the same normalized ILP."""
    a, b = ilps if ilps else (j_parse_lp_string(lp), parse_lp_string(lp))
    a.normalize()
    b.normalize()
    return JaxPreprocessor(a), BddPreprocessor(b)


def setup(lp, jdt, pack, iters=5):
    """A JAX host and a state after a few hard iterations, and the same
    carried over to the port."""
    jpre, _ = preprocessors(lp)
    host = juf.flatten_uniform(jpre.collection, jpre.total_nr_variables(),
                               jpre.nr_primal_variables, dtype=jdt, pack=pack)
    state = juf.init_uniform_state(host, jpre.objective_vector(), dtype=jdt)
    state = juf.iterations(host.geom, state, iters, 0.5)
    port, ps = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state), dtype=TDT[jdt])
    return host, state, port, ps


def close(got, want, jdt):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    fg, fw = np.isfinite(got), np.isfinite(want)
    np.testing.assert_array_equal(fg, fw)
    np.testing.assert_array_equal(got[~fg], want[~fw])
    np.testing.assert_allclose(got[fg], want[fw], **TOL[jdt])


CASES = [("two_simplex", jnp.float64, False), ("covering", jnp.float64, True),
         ("matching", jnp.float64, False), ("matching", jnp.float32, True),
         ("mixed_wide", jnp.float64, False)]
IDS = [f"{n}-{'f64' if d == jnp.float64 else 'f32'}-{'packed' if p else 'unpacked'}"
       for n, d, p in CASES]


@pytest.mark.parametrize("name,jdt,pack", CASES, ids=IDS)
def test_smooth_runs_marginals_bound_and_solution_match_jax(name, jdt, pack):
    host, state, port, ps = setup(LPS[name], jdt, pack)
    for T in (1.0, 0.3) if name != "mixed_wide" else (0.3,):
        for k, g in enumerate(host.geom.buckets):
            pg = port.geom.buckets[k]
            close(sm.bucket_smooth_backward_run(pg, ps.lo[k], ps.hi[k], T),
                  jsm.bucket_smooth_backward_run(g, state.lo[k], state.hi[k], T), jdt)
            close(sm.bucket_smooth_forward_run(pg, ps.lo[k], ps.hi[k], T),
                  jsm.bucket_smooth_forward_run(g, state.lo[k], state.hi[k], T), jdt)
            for a, b in zip(sm.bucket_sum_marginals(pg, ps.lo[k], ps.hi[k], T),
                            jsm.bucket_sum_marginals(g, state.lo[k], state.hi[k], T)):
                close(a, b, jdt)
        close(sm.smooth_lower_bound(port.geom, ps, T),
              jsm.smooth_lower_bound(host.geom, state, T), jdt)
        for a, b in zip(sm.smooth_solution(port.geom, ps, T),
                        jsm.smooth_solution(host.geom, state, T)):
            close(a, b, jdt)
    # the smooth bound lies below the hard bound of the same costs
    assert float(sm.smooth_lower_bound(port.geom, ps, 0.3)) <= float(
        uf.lower_bound(port.geom, ps)) + 1e-6


def test_per_column_temperature_matches_jax():
    """A temperature per column (an unpacked single bucket: a BDD a column)."""
    host, state, port, ps = setup(fixtures.MATCHING_3x3, jnp.float64, False)
    assert len(host.geom.buckets) == 1
    B = host.geom.buckets[0].B
    T = np.random.RandomState(0).uniform(0.05, 2.0, size=B)
    g, pg = host.geom.buckets[0], port.geom.buckets[0]
    close(sm.bucket_smooth_backward_run(pg, ps.lo[0], ps.hi[0], torch.from_numpy(T)),
          jsm.bucket_smooth_backward_run(g, state.lo[0], state.hi[0], jnp.asarray(T)),
          jnp.float64)
    close(sm.smooth_lower_bound(port.geom, ps, torch.from_numpy(T)),
          jsm.smooth_lower_bound(host.geom, state, jnp.asarray(T)), jnp.float64)
    for a, b in zip(sm.smooth_solution(port.geom, ps, torch.from_numpy(T)),
                    jsm.smooth_solution(host.geom, state, jnp.asarray(T))):
        close(a, b, jnp.float64)


@pytest.mark.parametrize("name,jdt,pack", CASES, ids=IDS)
def test_smooth_half_sweeps_match_jax(name, jdt, pack):
    host, state, port, ps = setup(LPS[name], jdt, pack)
    T = 0.4
    lo, hi, mm, _ = ps.flat
    scft = smma.smooth_backward_all(port.geom, lo, hi, T)
    jcft = jsmma.smooth_backward_all(host.geom, state.lo, state.hi, jnp.asarray(T, jdt))
    for a, b in zip(port.geom.per_bucket_nodes(scft), jcft):
        close(a, b, jdt)
    dl, dh = (port.geom.per_bucket(d) for d in uf.exchange_delta_flat(port.geom, mm))
    jdl, jdh = juf.exchange_delta(host.geom, state.def_mm)
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        pc = port.geom.per_bucket_nodes(scft)[k]
        f = smma.bucket_smooth_forward_iteration(pg, ps.lo[k], ps.hi[k], pc, 0.5, dl[k], dh[k], T)
        jf = jsmma.bucket_smooth_forward_iteration(g, state.lo[k], state.hi[k], jcft[k], 0.5,
                                                   jdl[k], jdh[k], T)
        for a, b in zip(f, jf):
            close(a, b, jdt)
        bw = smma.bucket_smooth_backward_iteration(pg, f[0], f[1], f[3], 0.5, dl[k], dh[k], T)
        jb = jsmma.bucket_smooth_backward_iteration(g, jf[0], jf[1], jf[3], 0.5, jdl[k], jdh[k],
                                                    T)
        for a, b in zip(bw, jb):
            close(a, b, jdt)


def solvers(lp, jdt, **kw):
    """(JAX, port) SmoothSolvers of the same LP."""
    jpre, pre = preprocessors(lp)
    a = jsmma.SmoothSolver(jpre.collection, jpre.total_nr_variables(), jpre.objective_vector(),
                           nr_primal_vars=jpre.nr_primal_variables, dtype=jdt, **kw)
    b = smma.SmoothSolver.from_collection(pre.collection, pre.total_nr_variables(),
                                          pre.objective_vector(),
                                          nr_primal_vars=pre.nr_primal_variables,
                                          dtype=TDT[jdt], device="cpu", **kw)
    return a, b


TRAJECTORIES = [("covering", jnp.float64, False), ("covering", jnp.float64, True),
                ("matching", jnp.float64, True), ("matching", jnp.float32, False),
                ("matching", jnp.float32, True), ("mixed_wide", jnp.float64, True)]


@pytest.mark.parametrize("name,jdt,anneal", TRAJECTORIES, ids=[
    f"{n}-{'f64' if d == jnp.float64 else 'f32'}-{'annealed' if a else 'fixed'}"
    for n, d, a in TRAJECTORIES])
def test_smooth_solver_trajectory_matches_jax(name, jdt, anneal):
    kw = dict(smoothing=0.5, smoothing_decay=0.5 if anneal else 1.0, min_smoothing=0.01)
    a, b = solvers(LPS[name], jdt, **kw)
    for block in range(4):
        assert b.smoothing == a.smoothing
        close(np.float64(b.smooth_bound()), np.float64(a.smooth_bound()), jdt)
        close(np.float64(b.lower_bound_with_deferred()),
              np.float64(a.lower_bound_with_deferred()), jdt)
        for x, y in zip(b.sum_marginals(), a.sum_marginals()):
            close(x, y, jdt)
        a.iteration_block(5)
        b.iteration_block(5)
    for x, y in zip(b.min_marginals(), a.min_marginals()):
        close(x, y, jdt)
    close(np.float64(b.lower_bound()), np.float64(a.lower_bound()), jdt)
    np.testing.assert_allclose(b.lower_bound_per_bdd(), a.lower_bound_per_bdd(), **TOL[jdt])


def test_smooth_solver_cost_updates_match_jax():
    """update_layer_costs, update_costs and distribute_delta keep the smooth
    cft in step, as in the JAX package."""
    a, b = solvers(fixtures.COVERING, jnp.float64, smoothing=0.3, smoothing_decay=1.0)
    for s in (a, b):
        s.iteration_block(3)
    n = len(a.f.layer_var)
    rng = np.random.RandomState(2)
    dl, dh = rng.randn(n) * a.f.valid_layer_mask(), rng.randn(n) * a.f.valid_layer_mask()
    per_var = rng.randn(a.f.nr_vars)
    for s in (a, b):
        s.update_layer_costs(dl, dh)
        s.update_costs(np.zeros(s.f.nr_vars), per_var)
    close(np.float64(b.smooth_bound()), np.float64(a.smooth_bound()), jnp.float64)
    for s in (a, b):
        s.distribute_delta()
        s.iteration()
    close(np.float64(b.smooth_bound()), np.float64(a.smooth_bound()), jnp.float64)
    close(np.float64(b.lower_bound_with_deferred()), np.float64(a.lower_bound_with_deferred()),
          jnp.float64)


def test_smooth_bound_ascends_and_packed_matches_unpacked():
    """set_cover(30, 60): multi-segment packed columns (root restarts). The
    port's smooth bound equals the JAX package's on both layouts and does not
    fall at a fixed temperature; packed and unpacked agree."""
    jpre, pre = preprocessors(ilps=(j_set_cover(30, 60, seed=3), set_cover(30, 60, seed=3)))
    bounds = {}
    for pack in (True, False):
        host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                      pre.nr_primal_variables, dtype=torch.float64,
                                      device="cpu", pack=pack)
        if pack:
            assert any(bool(g.roots[1:].any()) for g in host.geom.buckets)
        s = smma.SmoothSolver(host, pre.objective_vector(), smoothing=0.3,
                              smoothing_decay=1.0)
        prev = s.smooth_bound()
        for _ in range(8):
            s.iteration()
            cur = s.smooth_bound()
            assert cur >= prev - 1e-9
            prev = cur
        assert prev <= s.lower_bound_with_deferred() + 1e-9
        bounds[pack] = prev
        jhost = juf.flatten_uniform(jpre.collection, jpre.total_nr_variables(),
                                    jpre.nr_primal_variables, dtype=jnp.float64, pack=pack)
        js = jsmma.SmoothSolver.__new__(jsmma.SmoothSolver)
        jstate = juf.init_uniform_state(jhost, jpre.objective_vector(), dtype=jnp.float64)
        T = jnp.asarray(0.3, jnp.float64)
        js.geom, js.state = jhost.geom, jstate._replace(
            cft=jsmma.smooth_backward_all(jhost.geom, jstate.lo, jstate.hi, T))
        js = jsmma.smooth_iterations(js.geom, js.state, 8, 0.5, T)
        close(np.float64(prev),
              np.float64(jsmma.smooth_lower_bound_with_deferred(jhost.geom, js, T)), jnp.float64)
    assert bounds[True] == pytest.approx(bounds[False], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name", ["smooth mma", "mma smooth", "parallel mma smooth"])
def test_json_config_smooth_names_match_jax(name):
    """The MATCHING_3x3 config of tests/test_smooth_mma.py under each name:
    bound -6.0 as in the JAX package's test, and equal to its bound."""
    from bdd_tpu.api import BddSolver as JaxSolver

    cfg = {"relaxation solver": name, "smoothing": 0.2, "smoothing decay factor": 0.5,
           "precision": "double", "termination criteria": {"maximum iterations": 150}}
    s = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=fixtures.MATCHING_3x3)
    got = s.solve(verbose=False)
    assert isinstance(s.solver, smma.SmoothSolver)
    ref = JaxSolver(dict(cfg))
    ref.read_ilp(lp_string=fixtures.MATCHING_3x3)
    want = ref.solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(-6.0, abs=1e-3)
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], rel=1e-9, abs=1e-9)
    assert got["iterations"] == want["iterations"]
    assert got["objective"] == pytest.approx(-6.0, abs=1e-6)


def test_bare_smoothing_key_selects_smooth_solver():
    s = api.BddSolver({"smoothing": 0.5, "precision": "double"}, device="cpu")
    assert s.config["relaxation solver"] == "smooth mma"
    s.read_ilp(lp_string=fixtures.COVERING)
    res = s.solve(verbose=False)
    assert res["status"] == "solved" and isinstance(s.solver, smma.SmoothSolver)
    assert s.solver.smoothing < 0.5  # annealed once per block
    assert api.BddSolver({"smoothing": 0.5, "relaxation solver": "mma smooth"},
                         device="cpu").config["relaxation solver"] == "mma smooth"
