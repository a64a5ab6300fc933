"""bdd_tpu_torch.solver.hybrid (the CPU + GPU consensus, here on the CPU)
against bdd_tpu.solver.hybrid and the numpy oracle on the whole collection.

The same LP text goes through both packages' preprocessors, so both split
the same collection. float64: the port's HybridSolver equals the RefSolver
oracle and the JAX package's HybridSolver (its "callback" form, the one the
port carries) to atol 1e-12, bound and per-layer costs, in every split case
of tests/test_hybrid.py. float32: the JAX package's device side sums the
exchange through its permutation plan, in another order than the port's
segment sum: rel 1e-4. The layout of a BDD subset with global counts
(``flatten_uniform(keep_bdds=, counts_override=)``) is held to the JAX
package's array for array, and the exchange hook to the iteration without
it, bit for bit. The card against the CPU is ``test_hybrid_card_equals_cpu``
in tests/test_torch_kernels.py (``-m cuda``, no JAX on the card machine).
"""
import threading
import time

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as jparse
from bdd_tpu.solver import RefSolver, flatten_collection
from bdd_tpu.solver import hybrid as jhybrid
from bdd_tpu.solver.rounding import incremental_mm_rounding as jax_incremental_mm_rounding
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils.problems import grid_mrf, independent_set
from bdd_tpu_torch import api
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor as PortPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string as pparse
from bdd_tpu_torch.solver import hybrid
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.rounding import incremental_mm_rounding
from tests import fixtures
from tests.test_torch_layout import assert_host_equal

DTYPES = {"double": (torch.float64, jnp.float64), "float": (torch.float32, jnp.float32)}


# No cap on torch's threads here, unlike the other port modules: the JAX
# package's native solver sizes its per-thread scratch by the OpenMP count of
# the thread that creates it (this one), and its hybrid runs it from XLA's
# callback thread, at the default count; a lower count here overruns it.


def grid_lp(seed: int) -> str:
    ilp = grid_mrf(3, 3, 2, seed=seed)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp.write_lp()


def preprocess(lp):
    return JaxPreprocessor(jparse(lp)), PortPreprocessor(pparse(lp))


def median_depth(pre) -> int:
    d = sorted(len(pre.collection.level_variables(b)) for b in range(pre.collection.nr_bdds()))
    return d[len(d) // 2]


def make(lp, precision="double", **split):
    """(port HybridSolver on the CPU, JAX HybridSolver, RefSolver oracle over
    the whole collection), split alike."""
    tdt, jdt = DTYPES[precision]
    jp, tp = preprocess(lp)
    port = hybrid.HybridSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                               nr_primal_vars=tp.nr_primal_variables, dtype=tdt, device="cpu",
                               **split)
    ref = jhybrid.HybridSolver(jp.collection, jp.total_nr_variables(), jp.objective_vector(),
                               nr_primal_vars=jp.nr_primal_variables, dtype=jdt, mode="callback",
                               **split)
    flat = flatten_collection(jp.collection, jp.total_nr_variables(), jp.nr_primal_variables)
    return port, ref, RefSolver(flat, jp.objective_vector())


def assert_costs_equal(port, ref, atol):
    """Per-layer costs of both sides: the device state bucket by bucket and
    the host solver's (lo, hi, deferred mm)."""
    assert (port.host is None) == (ref.host is None)
    if port.host is not None:
        for mine, theirs in ((port.state.lo, ref.state.lo), (port.state.hi, ref.state.hi),
                             (port.state.def_mm, ref.state.def_mm)):
            for a, b in zip(mine, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
    assert (port._cs is None) == (ref._cs is None)
    if port._cs is not None:
        for a, b in zip(port._cs.costs(), ref._cs.costs()):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("precision", ["double", "float"])
@pytest.mark.parametrize("lp", [fixtures.MATCHING_3x3, grid_lp(4)], ids=["matching", "grid"])
def test_flatten_subset_with_global_counts_equals_jax(lp, precision):
    """``keep_bdds`` lays out a BDD subset whose ``layer_bdd`` keeps the
    global numbers; ``counts_override`` sets alpha = 1 / global count and
    turns packing off by default; the variables with no slot get empty
    segments, so the exchange's sums still come out with V + 1 rows."""
    tdt, jdt = DTYPES[precision]
    jp, tp = preprocess(lp)
    V = tp.total_nr_variables()
    nb = tp.collection.nr_bdds()
    keep = list(range(1, nb, 2))
    counts = np.zeros(V, dtype=np.int32)
    for b in range(nb):
        for v in tp.collection.level_variables(b):
            counts[v] += 1
    ref = juf.flatten_uniform(jp.collection, V, jp.nr_primal_variables, dtype=jdt,
                              counts_override=counts, keep_bdds=keep)
    port = layout.flatten_uniform(tp.collection, V, tp.nr_primal_variables, dtype=tdt,
                                  device="cpu", counts_override=counts, keep_bdds=keep)
    assert not port.geom.buckets[0].packed and port.nr_bdds == len(keep)
    assert_host_equal(port, ref, tdt)
    assert_host_equal(layout.from_jax_arrays(ref, dtype=tdt), ref, tdt)
    lbdd = np.concatenate([np.asarray(b).ravel() for b in port.layer_bdd])
    assert set(lbdd[lbdd >= 0]) == set(keep)
    ex = port.geom.exchange
    assert ex.segments.shape == (V + 1,)
    seen = np.zeros(V, dtype=bool)
    for b in keep:
        seen[list(tp.collection.level_variables(b))] = True
    assert (~seen).any()  # the split leaves variables without a slot here
    np.testing.assert_array_equal(ex.lengths.numpy() == 0, ~seen)
    mm = torch.randn(port.geom.plan.E, dtype=tdt)
    rows = []
    dl, dh = uf.exchange_delta_flat(port.geom, mm, lambda d: rows.append(d.shape) or d)
    assert rows == [(V + 1, 2)] and dl.shape == mm.shape


@pytest.mark.parametrize("precision", ["double", "float"])
def test_delta_reduce_none_is_bit_identical(precision):
    """With no hook nothing changes; an identity hook sees every exchange of
    the iteration, the folding and the bound, and changes no bit either."""
    tdt, _ = DTYPES[precision]
    _, tp = preprocess(grid_lp(2))
    host = layout.flatten_uniform(tp.collection, tp.total_nr_variables(), dtype=tdt,
                                  device="cpu")
    state = uf.init_uniform_state(host, tp.objective_vector())
    seen = []

    def identity(d):
        seen.append(d.shape)
        return d

    plain = uf.iterations(host.geom, state, 3)
    hooked = uf.iterations(host.geom, state, 3, delta_reduce=identity)
    paired = uf.iterations(host.geom, state, 3, delta_reduce=(identity, identity))
    assert len(seen) == 12
    for a, b, c in zip(plain.flat, hooked.flat, paired.flat):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(uf.lower_bound_with_deferred(host.geom, plain),
                       uf.lower_bound_with_deferred(host.geom, plain, identity))
    for a, b in zip(uf.distribute_delta(host.geom, plain).flat,
                    uf.distribute_delta(host.geom, plain, delta_reduce=identity).flat):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("lp", [fixtures.SHORT_MRF_CHAIN, fixtures.MATCHING_3x3],
                         ids=["mrf_chain", "matching"])
def test_hybrid_parity(lp):
    """Half the BDDs forced to the host (depth-uniform collections cannot
    split by depth): every iteration's bound equals the oracle's on the whole
    collection and the JAX package's hybrid, and so do the per-layer costs."""
    _, tp = preprocess(lp)
    nb = tp.collection.nr_bdds()
    port, ref, oracle = make(lp, force_host_bdds=list(range(nb // 2)))
    assert port.host_bdds and port.device_bdds and port.host_bdds == ref.host_bdds
    for it in range(20):
        port.iteration_block(1)
        ref.iteration_block(1)
        oracle.iteration(0.5)
        lb = port.lower_bound_with_deferred()
        assert lb == pytest.approx(oracle.lower_bound_with_deferred(), abs=1e-12), it
        assert lb == pytest.approx(ref.lower_bound_with_deferred(), abs=1e-12), it
    assert_costs_equal(port, ref, 1e-12)
    port.close()
    ref.close()


def test_hybrid_parity_grid_blocks():
    """A split by depth at the median, blocks of 25 iterations."""
    lp = grid_lp(4)
    jp, _ = preprocess(lp)
    port, ref, oracle = make(lp, hop_threshold=median_depth(jp))
    assert port.host_bdds and port.device_bdds and port.device_bdds == ref.device_bdds
    port.iteration_block(25)
    ref.iteration_block(25)
    for _ in range(25):
        oracle.iteration(0.5)
    lb = port.lower_bound_with_deferred()
    assert lb == pytest.approx(oracle.lower_bound_with_deferred(), abs=1e-12)
    assert lb == pytest.approx(ref.lower_bound_with_deferred(), abs=1e-12)
    assert port.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-12)
    assert port.lower_bound() <= lb + 1e-9
    assert_costs_equal(port, ref, 1e-12)
    m0, m1 = port.min_marginals()
    r0, r1 = ref.min_marginals()
    np.testing.assert_allclose(m0, r0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m1, r1, rtol=0, atol=1e-12)
    port.close()
    ref.close()


@pytest.mark.parametrize("where", ["device", "host"])
def test_hybrid_degenerate_splits(where):
    """Everything on the card (no host solver, no hook) or everything on the
    host (no device layout: the native solver alone)."""
    port, ref, oracle = make(fixtures.SHORT_MRF_CHAIN,
                             hop_threshold=10**6 if where == "device" else 0)
    assert bool(port.device_bdds) == (where == "device")
    assert bool(port.host_bdds) == (where == "host")
    port.iteration_block(8)
    ref.iteration_block(8)
    for _ in range(8):
        oracle.iteration(0.5)
    lb = port.lower_bound_with_deferred()
    assert lb == pytest.approx(oracle.lower_bound_with_deferred(), abs=1e-12)
    assert lb == pytest.approx(ref.lower_bound_with_deferred(), abs=1e-12)
    assert_costs_equal(port, ref, 1e-12)
    port.distribute_delta()
    ref.distribute_delta()
    assert port.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-12)
    port.close()
    ref.close()


def test_hybrid_to_native_full_continues_the_trajectory():
    lp = grid_lp(1)
    jp, _ = preprocess(lp)
    port, ref, oracle = make(lp, hop_threshold=median_depth(jp))
    assert port.host_bdds and port.device_bdds
    port.iteration_block(6)
    for _ in range(6):
        oracle.iteration(0.5)
    cs = port.to_native_full()
    assert cs.lower_bound_with_deferred() == pytest.approx(port.lower_bound_with_deferred(),
                                                           abs=1e-12)
    assert cs.lower_bound_with_deferred() == pytest.approx(oracle.lower_bound_with_deferred(),
                                                           abs=1e-12)
    cs.iterations(5, 0.5)
    for _ in range(5):
        oracle.iteration(0.5)
    assert cs.lower_bound_with_deferred() == pytest.approx(oracle.lower_bound_with_deferred(),
                                                           abs=1e-12)
    port.close()
    ref.close()


def test_hybrid_f32_against_jax():
    """float32 on the device side, the host side in float64 (the combined
    delta is cast to float32 on its way to the device): rel 1e-4 against the
    JAX package's float32 hybrid, whose exchange sums in another order."""
    lp = grid_lp(2)
    _, tp = preprocess(lp)
    nb = tp.collection.nr_bdds()
    port, ref, oracle = make(lp, "float", force_host_bdds=list(range(nb // 3)))
    assert port.state.flat[0].dtype == torch.float32
    port.iteration_block(20)
    ref.iteration_block(20)
    for _ in range(20):
        oracle.iteration(0.5)
    lb = port.lower_bound_with_deferred()
    assert lb == pytest.approx(ref.lower_bound_with_deferred(), rel=1e-4)
    assert lb == pytest.approx(oracle.lower_bound_with_deferred(), rel=2e-4, abs=2e-4)
    port.close()
    ref.close()


# --------------------------------------------------------------- pipelines
def test_hybrid_rounding_end_to_end():
    """The host rounding on the hybrid (the duck interface across both
    sides): the JAX package's solution, feasible, objective >= bound."""
    lp = grid_lp(3)
    _, tp = preprocess(lp)
    nb = tp.collection.nr_bdds()
    port, ref, _ = make(lp, force_host_bdds=list(range(nb // 2)))
    port.iteration_block(30)
    ref.iteration_block(30)
    lb = port.lower_bound_with_deferred()
    sol = incremental_mm_rounding(port, num_itr_lb=10, verbose=False)
    want = jax_incremental_mm_rounding(ref, num_itr_lb=10, verbose=False)
    assert sol is not None and want is not None
    np.testing.assert_array_equal(sol, want)
    ilp = pparse(lp)
    x = [int(v) for v in sol[: ilp.nr_variables()]]
    assert ilp.feasible(x)
    assert ilp.evaluate(x) >= lb - 1e-6
    port.close()
    ref.close()


@pytest.mark.parametrize("name,threshold,split", [
    ("hybrid mma", None, "device"),
    ("multi parallel mma", "median", "both"),
    ("hybrid parallel mma", 0, "host"),
], ids=["hybrid_auto", "multi_median", "hybrid_parallel_all_host"])
def test_hybrid_through_bdd_solver_equals_jax(name, threshold, split):
    """The three names and the "hybrid hop threshold" key through the whole
    pipeline (dual, host rounding, close): the JAX package's result, and a
    feasible solution. The automatic threshold keeps this small grid on the
    card; the median depth splits it."""
    from bdd_tpu.api import BddSolver as JaxBddSolver

    lp = grid_lp(3)
    if threshold == "median":
        threshold = median_depth(preprocess(lp)[0])
    cfg = {"relaxation solver": name, "hybrid hop threshold": threshold,
           "precision": "double", "variable order": "bfs",
           "termination criteria": {"maximum iterations": 300}}
    before = threading.active_count()
    port = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=lp)
    got = port.solve(verbose=False)
    solver = port.solver
    assert isinstance(solver, hybrid.HybridSolver)
    assert (bool(solver.host_bdds), bool(solver.device_bdds)) == (
        split != "device", split != "host")
    assert solver._pool is None  # closed after rounding
    assert threading.active_count() == before
    ref = JaxBddSolver(dict(cfg))
    ref.read_ilp(lp_string=lp)
    want = ref.solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["iterations"] == want["iterations"]
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-9)
    assert got["solution"] == want["solution"]
    ilp = pparse(lp)
    x = [got["solution"][ilp.get_var_name(i)] for i in range(ilp.nr_variables())]
    assert ilp.feasible(x)
    assert got["objective"] == pytest.approx(ilp.evaluate(x))
    assert got["objective"] >= got["lower_bound"] - 1e-6


@pytest.mark.parametrize("min_nodes", [3, 3072])
def test_split_bdds_auto_threshold_equals_jax(min_nodes):
    ilp = independent_set(40, edge_prob=0.1, seed=0)
    lp = ilp.write_lp()
    jp, tp = preprocess(lp)
    got = hybrid.split_bdds(tp.collection, min_nodes_per_hop=min_nodes)
    assert got == jhybrid.split_bdds(jp.collection, min_nodes_per_hop=min_nodes)
    host_b, dev_b, th = got
    assert sorted(host_b + dev_b) == list(range(tp.collection.nr_bdds()))
    for b in host_b:
        assert len(tp.collection.level_variables(b)) > th
    for b in dev_b:
        assert len(tp.collection.level_variables(b)) <= th


# ------------------------------------------------------------- the worker
class _GuardedNative:
    """The host solver behind a flag: a half-sweep holds it (and sleeps, so
    that the main thread runs ahead if it does not join); any other call
    while it is held is recorded as a fault."""

    def __init__(self, cs):
        self._cs = cs
        self._busy = threading.Lock()
        self.faults = []
        self.sweeps = 0

    def half_iteration_ext(self, omega, direction, delta):
        with self._busy:
            time.sleep(0.002)
            self._cs.half_iteration_ext(omega, direction, delta)
            self.sweeps += 1

    def __getattr__(self, name):
        fn = getattr(self._cs, name)

        def call(*args):
            if self._busy.locked():
                self.faults.append(name)
            return fn(*args)

        return call


def test_host_solver_is_never_read_while_its_half_sweep_runs():
    """Every read of the host solver comes after the join of its half-sweep
    (partial_delta, bounds, marginals, costs, folding), the worker sweeps
    twice an iteration, and close() ends the worker thread (twice is fine)."""
    before = threading.active_count()
    lp = grid_lp(4)
    _, tp = preprocess(lp)
    port = hybrid.HybridSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                               dtype=torch.float64, device="cpu",
                               force_host_bdds=list(range(0, tp.collection.nr_bdds(), 2)))
    guard = port._cs = _GuardedNative(port._cs)
    port.iteration_block(5)
    port.lower_bound_with_deferred()
    port.lower_bound()
    port.min_marginals()
    port.update_costs(np.full(port.nr_vars, 0.1), np.zeros(port.nr_vars))
    port.iteration()
    port.distribute_delta()
    port.to_native_full()
    assert guard.faults == [] and guard.sweeps == 12
    assert threading.active_count() == before + 1
    port.close()
    port.close()
    assert threading.active_count() == before


def test_dropping_the_solver_ends_its_worker():
    """The solver holds no reference to itself: dropping the last outside
    reference runs ``__del__``, which closes the pool and joins its thread."""
    before = threading.active_count()
    _, tp = preprocess(grid_lp(4))
    port = hybrid.HybridSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                               dtype=torch.float64, device="cpu",
                               force_host_bdds=list(range(0, tp.collection.nr_bdds(), 2)))
    port.iteration_block(2)
    port.lower_bound_with_deferred()
    assert threading.active_count() == before + 1
    del port
    assert threading.active_count() == before
