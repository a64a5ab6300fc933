"""bdd_tpu_torch uniform solver vs the numpy oracle (float64) and the JAX
package (float32). Copies of tests/test_uniform.py:46-124 for the port,
plus the exchange and state ops against ``bdd_tpu.solver.uniform``.

float32 tolerances: the JAX package's float32 exchange is the sort-based
permutation path, which sums each variable's deltas in another order than
the port's segment sum, so float32 trajectories agree to rounding
(rel/abs 1e-5 over 15 iterations), not bit for bit.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.solver import RefSolver, flatten_collection
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.rounding import incremental_mm_rounding
from bdd_tpu.solver.uniform_wrapper import UniformSolver as JaxUniformSolver
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch.native import NativeHost as PortNativeHost
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import uniform as tuf
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


FIXTURE_LPS = [
    fixtures.SHORT_MRF_CHAIN,
    fixtures.TWO_SIMPLEX,
    fixtures.COVERING,
    fixtures.MATCHING_3x3,
]
LP_IDS = ["mrf_chain", "two_simplex", "covering", "matching"]


def build(lp=None, ilp=None, precision="double"):
    """(ilp, pre, port solver, oracle, JAX solver) on one python-built
    layout, carried across to the port with ``from_jax_arrays``."""
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
    flat = flatten_collection(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables
    )
    ref = RefSolver(flat, pre.objective_vector())
    return ilp, pre, s, ref, js


@pytest.mark.parametrize("lp", FIXTURE_LPS, ids=LP_IDS)
def test_initial_lower_bound_parity(lp):
    ilp, pre, s, ref, _ = build(lp)
    assert s.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-9)


@pytest.mark.parametrize("lp", FIXTURE_LPS, ids=LP_IDS)
def test_initial_lower_bound_f32_matches_jax(lp):
    ilp, pre, s, ref, js = build(lp, precision="float")
    assert s.geom.buckets[0].root_mask is not None  # float32 layouts are packed
    assert s.lower_bound() == pytest.approx(js.lower_bound(), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("lp", FIXTURE_LPS, ids=LP_IDS)
def test_iteration_parity(lp):
    ilp, pre, s, ref, _ = build(lp)
    for it in range(15):
        s.iteration()
        ref.iteration(0.5)
        assert s.lower_bound_with_deferred() == pytest.approx(
            ref.lower_bound_with_deferred(), abs=1e-8
        ), f"iter {it}"


def _small_gm():
    """Graph matching: heavy-tailed BDDs per variable, so JAX's float32
    exchange runs its class-block folds against the port's segment sum."""
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu.utils.problems import graph_matching

    return construct_graph_matching_ilp(
        graph_matching(12, 12, seed=3, candidates=4, nr_quadratic=80)
    )[0]


@pytest.mark.parametrize("lp", FIXTURE_LPS + ["gm"], ids=LP_IDS + ["gm"])
def test_iteration_f32_matches_jax(lp):
    if lp == "gm":
        ilp, pre, s, ref, js = build(ilp=_small_gm(), precision="float")
        assert len(js.geom.exchange.classes) >= 3
    else:
        ilp, pre, s, ref, js = build(lp, precision="float")
    for it in range(15):
        s.iteration()
        js.iteration()
        assert s.lower_bound_with_deferred() == pytest.approx(
            js.lower_bound_with_deferred(), rel=1e-5, abs=1e-5
        ), f"iter {it}"


@pytest.mark.parametrize("lp", FIXTURE_LPS, ids=LP_IDS)
def test_min_marginals_parity(lp):
    """Per-variable aggregated mm statistics must match the oracle."""
    ilp, pre, s, ref, _ = build(lp)
    for _ in range(3):
        s.iteration()
        ref.iteration(0.5)
    s.distribute_delta()
    ref.distribute_delta()
    m0u, m1u = s.min_marginals()
    m0r, m1r = ref.min_marginals()

    def agg(view, m0, m1):
        valid = view.valid_layer_mask()
        v = view.layer_var[valid]
        V = view.nr_vars
        lo_min = np.full(V, np.inf)
        hi_min = np.full(V, np.inf)
        lo_sum = np.zeros(V)
        np.minimum.at(lo_min, v, m0[valid])
        np.minimum.at(hi_min, v, m1[valid])
        with np.errstate(invalid="ignore"):
            d = np.where(np.isfinite(m1[valid] - m0[valid]), m1[valid] - m0[valid], 0)
        np.add.at(lo_sum, v, d)
        return lo_min, hi_min, lo_sum

    for x, y in zip(agg(s.f, m0u, m1u), agg(ref.f, m0r, m1r)):
        fin = np.isfinite(x) & np.isfinite(y)
        assert np.allclose(x[fin], y[fin], atol=1e-8)
        assert np.array_equal(np.isfinite(x), np.isfinite(y))


def test_uniform_convergence_and_rounding():
    ilp, pre, s, ref, _ = build(fixtures.MATCHING_3x3)
    s.iteration_block(200)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    assert s.lower_bound_with_deferred() == pytest.approx(opt, abs=1e-6)
    sol = incremental_mm_rounding(s, verbose=False)
    assert sol is not None
    assert ilp.evaluate(list(sol[: ilp.nr_variables()])) == pytest.approx(opt)


def test_uniform_grid_mrf_matches_ref():
    ilp = grid_mrf(3, 3, 3, seed=2)
    ilp.reorder_bfs()
    ilp.normalize()
    _, pre, s, ref, _ = build(ilp=ilp)
    s.iteration_block(30)
    for _ in range(30):
        ref.iteration(0.5)
    assert s.lower_bound_with_deferred() == pytest.approx(
        ref.lower_bound_with_deferred(), abs=1e-7
    )


@pytest.mark.parametrize("precision", ["double", "float"])
def test_uniform_infeasible(precision):
    ilp, pre, s, ref, _ = build(fixtures.INFEASIBLE, precision=precision)
    s.iteration_block(50)
    assert s.lower_bound_with_deferred() == np.inf


def _jax_and_port_state(lp, iters=4):
    ilp = parse_lp_string(lp) if isinstance(lp, str) else lp
    pre = BddPreprocessor(ilp)
    jhost = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables,
        dtype=jnp.float64, pack=True,
    )
    st = uf.init_uniform_state(jhost, pre.objective_vector(), dtype=jnp.float64)
    st = uf.iterations(jhost.geom, st, iters, 0.5)
    port, pst = layout.from_jax_arrays(jhost, jax.tree.map(np.asarray, st))
    return jhost, st, port, pst, pre


def _close(a, b, atol=1e-12):
    a, b = a.numpy(), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    np.testing.assert_allclose(a[fin], b[fin], atol=atol)


def test_exchange_delta_matches_jax_segment_path():
    """float64 (JAX's segment-sum default), with ±inf forcing injected."""
    jhost, st, port, pst, _ = _jax_and_port_state(grid_mrf(3, 3, 3, seed=4))
    mm = [np.asarray(m).copy() for m in st.def_mm]
    mm[0][0, 0] = np.inf
    mm[0][1, 0] = -np.inf
    jl, jh = uf.exchange_delta(jhost.geom, tuple(jnp.asarray(m) for m in mm))
    tl, th = (port.geom.per_bucket(d) for d in tuf.exchange_delta_flat(
        port.geom, layout.flatten([torch.from_numpy(m) for m in mm])))
    for g, a, b, c, d in zip(port.geom.buckets, tl, jl, th, jh):
        m = g.layer_valid.numpy()
        _close(a[m], np.asarray(b)[m])
        _close(c[m], np.asarray(d)[m])
        assert (a[~g.layer_valid] == 0).all() and (c[~g.layer_valid] == 0).all()
    assert any(bool(torch.isinf(x).any()) for x in tl)


def test_state_ops_match_jax_f64():
    jhost, st, port, pst, pre = _jax_and_port_state(fixtures.MATCHING_3x3)
    init = tuf.init_uniform_state(port, pre.objective_vector())
    jinit = uf.init_uniform_state(jhost, pre.objective_vector(), dtype=jnp.float64)
    for f in ("lo", "hi", "def_mm", "cft"):
        for a, b in zip(getattr(init, f), getattr(jinit, f)):
            _close(a, b, atol=0.0)
    assert float(tuf.lower_bound(port.geom, pst)) == pytest.approx(
        float(uf.lower_bound(jhost.geom, st)), abs=1e-12)
    assert float(tuf.lower_bound_with_deferred(port.geom, pst)) == pytest.approx(
        float(uf.lower_bound_with_deferred(jhost.geom, st)), abs=1e-12)
    d, jd = tuf.distribute_delta(port.geom, pst), uf.distribute_delta(jhost.geom, st)
    for f in ("lo", "hi", "def_mm", "cft"):
        for a, b in zip(getattr(d, f), getattr(jd, f)):
            _close(a, b)
    rng = np.random.RandomState(1)
    V = jhost.nr_vars
    lo_u = np.append(rng.uniform(-1, 1, V), 0.0)
    hi_u = np.append(rng.uniform(-1, 1, V), 0.0)
    u = tuf.update_costs_per_var(port.geom, pst, torch.from_numpy(lo_u), torch.from_numpy(hi_u))
    ju = uf.update_costs_per_var(jhost.geom, st, jnp.asarray(lo_u), jnp.asarray(hi_u))
    for f in ("lo", "hi", "cft"):
        for a, b in zip(getattr(u, f), getattr(ju, f)):
            _close(a, b)
    mm = tuf.min_marginals_all(port.geom, pst)
    jmm = uf.min_marginals_all(jhost.geom, st)
    for (a0, a1), (b0, b1) in zip(mm, jmm):
        _close(a0, b0)
        _close(a1, b1)


# ------------------------------------------------- flat state, one launch
def _wide_host(precision, pack):
    from tests.test_torch_kernels import wide_lp

    nh = PortNativeHost(wide_lp(), "input")
    dtype = torch.float64 if precision == "double" else torch.float32
    return nh, layout.from_native_host(nh, dtype=dtype, device="cpu", pack=pack)


@pytest.mark.parametrize("pack", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("precision", ["double", "float"])
def test_flat_iteration_equals_per_bucket_iteration_bitwise(precision, pack):
    """The iteration on flat tensors (one sweep call per half-sweep) against
    the iteration that calls a sweep per bucket on tensors of its own."""
    from bdd_tpu_torch.solver import sweep_kernels as sk

    nh, host = _wide_host(precision, pack)
    geom = host.geom
    assert len(geom.buckets) >= 3
    st0 = tuf.init_uniform_state(host, nh.objective())
    flat = tuf.iterations(geom, st0, 5, 0.5)
    per_bucket = tuf.iterations(
        geom, st0, 5, 0.5,
        sweeps=(sk.bucket_forward_iteration_cuda, sk.bucket_backward_iteration_cuda))
    assert flat.flat[0].shape == per_bucket.flat[0].shape == (geom.plan.E,)
    for field in ("lo", "hi", "def_mm", "cft"):
        for a, b in zip(getattr(flat, field), getattr(per_bucket, field)):
            assert a.shape == b.shape and torch.equal(a, b), field
    assert float(tuf.lower_bound_with_deferred(geom, flat)) == float(
        tuf.lower_bound_with_deferred(geom, per_bucket))


def test_flat_state_views_alias_the_flat_tensors():
    nh, host = _wide_host("double", False)
    st = tuf.iterations(host.geom, tuf.init_uniform_state(host, nh.objective()), 1, 0.5)
    lo, hi, mm, cft = st.flat
    assert lo.numel() == sum(host.geom.sizes) == host.geom.plan.E
    assert cft.numel() == host.geom.plan.N
    off = 0
    for g, view in zip(host.geom.buckets, st.lo):
        assert view.data_ptr() == lo.data_ptr() + off * lo.element_size()
        off += g.H * g.B
    rebuilt = layout.state_from_buckets(host.geom, st.lo, st.hi, st.def_mm, st.cft)
    for a, b in zip(rebuilt.flat, st.flat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["double", "float"])
def test_exchange_delta_flat_equals_rows_gathered_and_numpy(precision):
    """The exchange on flat tensors against the formulation that gathers
    [E, 2] rows (bit for bit) and a numpy scatter-add (to rounding)."""
    nh, host = _wide_host(precision, True)
    geom, ex = host.geom, host.geom.exchange
    st = tuf.iterations(geom, tuf.init_uniform_state(host, nh.objective()), 3, 0.5)
    mm = st.flat[2]
    din_lo, din_hi = tuf.exchange_delta_flat(geom, mm)
    contrib = torch.stack([torch.clamp_min(-mm, 0.0), torch.clamp_min(mm, 0.0)], dim=1)
    dsum = torch.segment_reduce(contrib[ex.order], "sum", lengths=ex.lengths, axis=0, initial=0.0)
    dsum = torch.cat([dsum.t(), dsum.new_zeros((2, 1))], dim=1)[:, ex.ids]
    assert torch.equal(din_lo, dsum[0]) and torch.equal(din_hi, dsum[1])
    ids, valid = ex.ids.numpy(), ex.valid.numpy()
    ref = np.zeros((2, geom.V + 1))
    np.add.at(ref[0], ids[valid], np.maximum(-mm.numpy()[valid].astype(np.float64), 0.0))
    np.add.at(ref[1], ids[valid], np.maximum(mm.numpy()[valid].astype(np.float64), 0.0))
    tol = 1e-12 if precision == "double" else 1e-5
    np.testing.assert_allclose(din_lo.numpy(), ref[0][ids], atol=tol, rtol=tol)
    np.testing.assert_allclose(din_hi.numpy(), ref[1][ids], atol=tol, rtol=tol)
    for g, lo_b, hi_b in zip(geom.buckets, geom.per_bucket(din_lo), geom.per_bucket(din_hi)):
        assert (lo_b[~g.layer_valid] == 0).all() and (hi_b[~g.layer_valid] == 0).all()


@pytest.mark.parametrize("reduce,initial", [("sum", 0.0), ("max", -np.inf), ("min", np.inf)])
def test_segment_reduce_unchecked_equals_checked(reduce, initial):
    nh, host = _wide_host("double", False)
    geom, ex = host.geom, host.geom.exchange
    x = torch.from_numpy(np.random.RandomState(0).randn(sum(geom.sizes)))
    checked = torch.segment_reduce(x[ex.order], reduce, lengths=ex.lengths, axis=0,
                                   unsafe=False, initial=initial)
    assert torch.equal(tuf.segment_reduce(geom, x, reduce, initial), checked)
    assert checked.shape == (geom.V,)


@pytest.mark.parametrize("lengths,slots", [([2, -1, 3], 4), ([2, 2], 5), ([], 1)])
def test_bad_segment_lengths_raise_when_the_layout_is_built(lengths, slots):
    with pytest.raises(ValueError, match="exchange index"):
        layout.check_lengths(np.asarray(lengths, dtype=np.int64), slots)


def test_exchange_index_is_checked_at_build(monkeypatch):
    """``_exchange_index`` runs the check on what it builds: a layout whose
    lengths were corrupted on the way never reaches the solver."""
    nh, _ = _wide_host("double", False)
    real = np.bincount
    monkeypatch.setattr(layout.np, "bincount", lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(ValueError, match="exchange index"):
        layout.from_native_host(nh, dtype=torch.float64, device="cpu")
