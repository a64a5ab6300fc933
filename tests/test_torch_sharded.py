"""The sharded solve of the port (``bdd_tpu_torch/solver/uniform_sharded.py``,
``solver/sharding.py``, the sharded branch of the outer loops, the sharded
DOGE trainer) against the JAX package's ``ShardedUniformSolver`` on virtual
CPU devices and against the port's one-device solve.

In process: the partitions, and every shard's layout array for array
against ``bdd_tpu.solver.uniform_sharded.build_shard_geoms`` (D = 2 and 4,
float32 packed, float64 unpacked). Then D = 2 and D = 4 gloo ranks (one torch
thread each, ``tests/torch_sharded_ranks.py``), started once per D for the
module, solve through the port alone; their bounds are held here to JAX's
and the one-device port's within abs 1e-9 in float64 (JAX's own limit,
tests/test_uniform_sharded.py:47): the ranks sum the per-variable deltas in
the backend's order, the one-device solve in slot order.

The dense sharded solve (``solver/sharding.py``'s ``ShardedSolver``):
``shard_collection``'s arrays against the JAX package's array for array
(D = 2 and 4), and D = 2 and D = 4 gloo ranks of the "dense" scenario (one
start per D for the module) whose float64 bounds after 15 iterations equal
the JAX ``ShardedSolver``'s on its virtual CPU devices and the one-device
``DenseSolver``'s (abs 1e-12); TWO_SIMPLEX at D = 4 leaves a shard empty.
"""
import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import Mesh

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as jparse
from bdd_tpu.solver import flatten_collection as jflatten
from bdd_tpu.solver import sharding as jsharding
from bdd_tpu.solver import uniform as juf
from bdd_tpu.solver import uniform_sharded as jus
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.frontends.graph_matching import construct_graph_matching_ilp
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import sharding
from bdd_tpu_torch.solver import uniform_sharded as us
from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
from bdd_tpu_torch.solver.flatten import flatten_collection
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils.problems import graph_matching, grid_mrf, set_cover
from tests import fixtures
from tests import torch_sharded_ranks as ranks

LPS = {
    "grid": grid_mrf(6, 6, 3, seed=1).write_lp(),
    "cover": set_cover(40, 80, seed=11).write_lp(),
    "gm": construct_graph_matching_ilp(
        graph_matching(12, 12, seed=3, candidates=4, nr_quadratic=80))[0].write_lp(),
    "matching": fixtures.MATCHING_3x3,
}


def both(lp):
    return JaxPreprocessor(jparse(lp)), BddPreprocessor(parse_lp_string(lp))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", list(LPS))
def test_partitions_equal_jax(name, D):
    jp, tp = both(LPS[name])
    block = sharding.partition_bdds(tp.collection, D)
    assert block == jsharding.partition_bdds(jp.collection, D)
    refined = sharding.refine_partition_mincut(tp.collection, block)
    assert refined == jsharding.refine_partition_mincut(jp.collection, block)
    for parts in (block, refined):
        assert sharding.shared_width(tp.collection, parts) == jsharding.shared_width(
            jp.collection, parts)
        assert sharding.partition_cost(tp.collection, parts) == jsharding.partition_cost(
            jp.collection, parts)
    assert sorted(b for p in refined for b in p) == list(range(tp.collection.nr_bdds()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", list(LPS))
def test_shard_layouts_equal_jax(name, D, dtype):
    """Every shard's buckets in JAX's order and shapes (padded columns and
    rows, empty buckets, pooled pack heights), arc arrays, masks, variables,
    alpha, roots and BDD numbers equal; float32 packs, float64 does not."""
    jp, tp = both(LPS[name])
    geoms, _, lbd, counts = jus.build_shard_geoms(
        jp.collection, jp.total_nr_variables(), D, dtype=getattr(jnp, dtype),
        nr_primal_vars=jp.nr_primal_variables)
    lay = us.build_shard_geoms(tp.collection, tp.total_nr_variables(), D,
                               dtype=getattr(torch, dtype),
                               nr_primal_vars=tp.nr_primal_variables, device="cpu")
    np.testing.assert_array_equal(lay.counts, counts)
    assert lay.packed == (dtype == "float32")
    for d in range(D):
        jg, host = geoms[d], lay.hosts[d]
        assert len(jg.buckets) == len(host.geom.buckets)
        for k, (a, b) in enumerate(zip(jg.buckets, host.geom.buckets)):
            assert tuple(a.node_valid.shape) == (b.H, b.P, b.B), (d, k)
            for key in ("node_valid", "lo_kind", "lo_slot", "hi_kind", "hi_slot",
                        "layer_valid", "layer_var", "alpha"):
                want = np.asarray(getattr(a, key))
                np.testing.assert_array_equal(getattr(b, key).numpy().astype(want.dtype), want,
                                              err_msg=f"shard {d} bucket {k} {key}")
            assert (a.root_mask is not None) == b.packed
            if b.packed:
                np.testing.assert_array_equal(b.roots.numpy(), np.asarray(a.root_mask))
            np.testing.assert_array_equal(host.layer_bdd[k], lbd[d][k])


def test_choose_pack_caps_equals_jax():
    rng = np.random.RandomState(3)
    pooled = {2: rng.randint(1, 40, size=500), 8: rng.randint(1, 300, size=200),
              64: np.array([3, 5, 260, 7])}
    assert layout.choose_pack_caps(pooled) == juf.choose_pack_caps(pooled)


def test_shared_rows_are_the_variables_of_two_shards():
    _, tp = both(LPS["gm"])
    lay = us.build_shard_geoms(tp.collection, tp.total_nr_variables(), 4, dtype=torch.float64,
                               device="cpu", shards=[])
    assert all(h is None for h in lay.hosts)
    V = tp.total_nr_variables()
    where = np.zeros((4, V), bool)
    for d, p in enumerate(lay.parts):
        for b in p:
            where[d, tp.collection.level_variables(b)] = True
    np.testing.assert_array_equal(lay.shared, np.nonzero(where.sum(0) >= 2)[0])


def test_a_layout_like_another_takes_its_partition_and_arrays():
    """The float64 layout built from the float32 one's partition and
    unpacked arrays equals a fresh float64 build, shard for shard."""
    _, tp = both(LPS["gm"])
    args = (tp.collection, tp.total_nr_variables(), 2)
    f32 = us.build_shard_geoms(*args, dtype=torch.float32, device="cpu")
    like = us.build_shard_geoms(*args, dtype=torch.float64, device="cpu", like=f32)
    fresh = us.build_shard_geoms(*args, dtype=torch.float64, device="cpu")
    assert like.parts == fresh.parts and not like.packed
    for a, b in zip(like.hosts, fresh.hosts):
        assert torch.equal(a.geom.arcs, b.geom.arcs) and torch.equal(a.geom.alpha, b.geom.alpha)
    with pytest.raises(ValueError, match="shards"):
        us.build_shard_geoms(tp.collection, tp.total_nr_variables(), 4, device="cpu", like=f32)


def test_unknown_partition_and_plan_family_raise():
    """The JAX package takes an unknown partition silently as 'auto'
    (uniform_sharded.py:104); the port refuses it, in the solver and in the
    api's config."""
    from bdd_tpu_torch import api

    _, tp = both(fixtures.MATCHING_3x3)
    for kw in ({"partition": "bogus"}, {"plan_family": "windows"}):
        with pytest.raises(ValueError, match="unknown"):
            us.ShardedUniformSolver(tp.collection, tp.total_nr_variables(),
                                    tp.objective_vector(), device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown partition"):
        api.BddSolver({"relaxation solver": "sharded mma", "partition": "bogus"}, device="cpu")


def test_one_shard_without_a_group_equals_the_uniform_solver():
    _, tp = both(LPS["grid"])
    args = (tp.collection, tp.total_nr_variables(), tp.objective_vector())
    s = us.ShardedUniformSolver(*args, nr_primal_vars=tp.nr_primal_variables,
                                dtype=torch.float64, device="cpu")
    u = UniformSolver.from_collection(*args, nr_primal_vars=tp.nr_primal_variables,
                                      dtype=torch.float64, device="cpu")
    assert s.comm.size == 1 and s.delta_reduce(torch.ones(3, 2)).sum() == 6
    s.iteration_block(15)
    u.iteration_block(15)
    assert s.lower_bound() == u.lower_bound_with_deferred()
    m0, m1 = s.min_marginals()
    w0, w1 = u.min_marginals()
    np.testing.assert_array_equal(m0, w0)
    np.testing.assert_array_equal(m1, w1)


def test_world_size_without_a_group_raises(monkeypatch):
    """No silent fallback to one shard when the launcher asked for more."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    _, tp = both(fixtures.MATCHING_3x3)
    with pytest.raises(RuntimeError, match="no process group"):
        us.ShardedUniformSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                                device="cpu")


# ------------------------------------------------------------ D gloo ranks
@pytest.fixture(scope="module")
def results():
    started = {D: ranks.start(D, "solve") for D in (2, 4)}  # side by side
    return {D: ranks.wait(procs) for D, procs in started.items()}


def lb(res, key):
    return float.fromhex(res[key])


def jax_sharded_bound(lp: str, D: int, n: int) -> float:
    pre = JaxPreprocessor(jparse(lp))
    s = jus.ShardedUniformSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        mesh=Mesh(np.array(jax.devices()[:D]), ("b",)), nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64)
    s.iteration_block(n)
    return s.lower_bound()


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_agree_and_import_no_jax(results, D):
    """Every rank returns the same bounds, solutions and losses (the ranks
    exit non-zero had they imported JAX or the JAX package)."""
    res = results[D]
    assert all(r["size"] == D for r in res)
    for r in res[1:]:
        assert {k: v for k, v in r.items() if k != "rank"} == {
            k: v for k, v in res[0].items() if k != "rank"}


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_bounds_equal_jax_and_one_device(results, D):
    res = results[D][0]
    for name, (lp, n) in ranks.INSTANCES.items():
        _, tp = both(lp())
        u = UniformSolver.from_collection(tp.collection, tp.total_nr_variables(),
                                          tp.objective_vector(),
                                          nr_primal_vars=tp.nr_primal_variables,
                                          dtype=torch.float64, device="cpu")
        u.iteration_block(n)
        assert lb(res, f"lb {name}") == pytest.approx(u.lower_bound_with_deferred(), abs=1e-9)
        if name in ("matching", "grid"):
            assert lb(res, f"lb {name}") == pytest.approx(jax_sharded_bound(lp(), D, n),
                                                          abs=1e-9)


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_split_rows_equal_all_rows(results, D):
    """Only the variables of two or more shards cross the ranks ('split',
    the default), at the same bound as every row ('global'); equal bits: a
    variable of one shard has its whole sum on that shard."""
    res = results[D][0]
    assert res["lb split"] == res["lb global"]
    assert res["split calls"] == res["global calls"] == 20
    assert 0 < res["split bytes"] < res["global bytes"] / 4


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_outer_loops_through_the_api(results, D):
    """As tests/test_uniform_sharded.py's test_sharded_lbfgs and
    test_sharded_subgradient_via_api."""
    res = results[D][0]
    assert np.isfinite(lb(res, "lb lbfgs sharded mma"))
    assert lb(res, "lb lbfgs sharded mma") >= lb(res, "lb sharded mma") - 1e-6
    assert lb(res, "lb subgradient") == pytest.approx(-6.0, abs=1e-3)


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_round_to_the_same_optimal_solution(results, D):
    """As tests/test_uniform_sharded.py:69: dual solve and rounding; every
    rank returns the same solution (test_ranks_agree), the optimum."""
    rnd = results[D][0]["rounding"]
    ilp = parse_lp_string(fixtures.MATCHING_3x3)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    x = [rnd["solution"][ilp.get_var_name(i)] for i in range(ilp.nr_variables())]
    assert ilp.feasible(x)
    assert rnd["objective"] == pytest.approx(opt)
    assert ilp.evaluate(x) == pytest.approx(opt)


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_refuse_unknown_partition(results, D):
    res = results[D][0]
    assert "unknown partition" in res["bogus partition"]
    assert "unknown plan_family" in res["bogus plan_family"]


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_learned_iterations_and_gradient_equal_one_device(results, D):
    """The learned iterations' bound and its gradient in a per-variable
    omega vector, over the ranks, equal the one-device port's (abs 1e-9, as
    tests/test_uniform_sharded.py's learned parity test)."""
    from bdd_tpu_torch.solver import learned as ln
    from bdd_tpu_torch.solver import uniform as uf

    res = results[D][0]
    _, tp = both(ranks._grid(3, 3, 2, 7))
    host = layout.flatten_uniform(tp.collection, tp.total_nr_variables(),
                                  tp.nr_primal_variables, dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(0)
    ov = torch.tensor(0.2 + 0.6 * rng.rand(tp.total_nr_variables() + 1), requires_grad=True)
    ex = host.geom.exchange
    st = ln.learned_iterations(host.geom, uf.init_uniform_state(host, tp.objective_vector()),
                               host.geom.alpha, torch.where(ex.valid, ov[ex.ids], 0.0), 6)
    bound = uf.lower_bound_from_cft(host.geom, uf.distribute_delta(host.geom, st).cft)
    bound.backward()
    assert lb(res, "learned lb") == pytest.approx(bound.item(), abs=1e-9)
    assert lb(res, "learned block lb") == pytest.approx(bound.item(), abs=1e-9)
    np.testing.assert_allclose([float.fromhex(x) for x in res["learned grad"]],
                               ov.grad.numpy(), atol=1e-9)


@pytest.mark.parametrize("D", [2, 4])
def test_ranks_doge_step_equals_one_process(results, D):
    """One sharded DOGE epoch: loss and gradients equal the one-process
    trainer's on the same instance (atol 1e-5, as JAX's
    test_sharded_doge_training), and after the Adam step every rank holds the
    same parameters."""
    res = results[D][0]
    assert lb(res, "doge loss") == pytest.approx(lb(res, "doge loss one process"), abs=1e-5)
    assert res["doge grad diff"] <= 1e-5 and res["doge grad max"] > 1e-3
    assert res["doge params spread"] == 0.0
    assert all(np.isfinite(float.fromhex(x)) for x in res["doge rounds"])


# ------------------------------------------------------- the dense sharding
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", ["grid", "matching", "two_simplex"])
def test_dense_shard_collection_equals_jax(name, D):
    """Every shard's padded arrays (the ten ``DenseGeom`` fields, common H, W
    and L, the placeholder BDD of an empty shard) and its initial state equal
    the JAX package's stacked ones; each shard built on the device gives the
    same arrays."""
    lp = fixtures.TWO_SIMPLEX if name == "two_simplex" else LPS[name]
    jp, tp = both(lp)
    want = jsharding.shard_collection(jp.collection, jp.total_nr_variables(), D,
                                      jp.nr_primal_variables, dtype=jnp.float64)
    got = sharding.shard_collection(tp.collection, tp.total_nr_variables(), D,
                                    tp.nr_primal_variables, dtype=torch.float64, device="cpu")
    assert got.parts == want.parts
    np.testing.assert_array_equal(got.num_bdds_per_var_global, want.num_bdds_per_var_global)
    jstate = jsharding.init_sharded_state(want, jp.objective_vector(), dtype=jnp.float64)
    for d in range(D):
        for key in sharding._GEOM_KEYS:
            ref = np.asarray(getattr(want.geom, key))[d]
            np.testing.assert_array_equal(got.arrays[d][key], ref, err_msg=f"{d} {key}")
            np.testing.assert_array_equal(getattr(got.geoms[d], key).numpy().astype(ref.dtype),
                                          ref, err_msg=f"{d} {key}")
        st = sharding.init_sharded_state(got, tp.objective_vector(), d)
        for f in st._fields:
            a, b = getattr(st, f).numpy(), np.asarray(getattr(jstate, f))[d]
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            np.testing.assert_allclose(a[~np.isinf(a)], b[~np.isinf(b)], rtol=0, atol=1e-12)
    if name == "two_simplex" and D == 4:
        assert any(len(p) == 0 for p in got.parts)  # the placeholder shard
    only = sharding.shard_collection(tp.collection, tp.total_nr_variables(), D,
                                     tp.nr_primal_variables, dtype=torch.float64, device="cpu",
                                     shards=[1])
    assert only.geoms[0] is None and only.geoms[1] is not None


def one_device_dense(lp: str, n: int, dtype=torch.float64) -> float:
    _, tp = both(lp)
    flat = flatten_collection(tp.collection, tp.total_nr_variables(), tp.nr_primal_variables)
    s = DenseSolver(flat, tp.objective_vector(), dtype=dtype, device="cpu")
    s.iteration_block(n)
    return s.lower_bound_with_deferred()


def test_dense_sharded_solver_without_a_group_is_one_shard():
    _, tp = both(LPS["grid"])
    s = sharding.ShardedSolver(tp.collection, tp.total_nr_variables(), tp.objective_vector(),
                               nr_primal_vars=tp.nr_primal_variables, dtype=torch.float64,
                               device="cpu")
    assert s.comm.size == 1 and s.default_block_size == 10
    s.iteration_block(15)
    assert s.lower_bound() == s.lower_bound_with_deferred()
    assert s.lower_bound() == pytest.approx(one_device_dense(LPS["grid"], 15), abs=1e-12)
    # float32 from the float64 solver's arrays: the same as a fresh build
    args = (tp.collection, tp.total_nr_variables(), tp.objective_vector())
    like = sharding.ShardedSolver(*args, dtype=torch.float32, device="cpu", like=s.sharded)
    fresh = sharding.ShardedSolver(*args, dtype=torch.float32, device="cpu")
    assert like.sharded.parts == fresh.sharded.parts
    for a, b in zip(like.state, fresh.state):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="variables"):
        sharding.ShardedSolver(tp.collection, tp.total_nr_variables() + 1,
                               np.append(tp.objective_vector(), 0.0), device="cpu",
                               like=s.sharded)


@pytest.fixture(scope="module")
def dense_results():
    started = {D: ranks.start(D, "dense") for D in (2, 4)}  # side by side
    return {D: ranks.wait(procs) for D, procs in started.items()}


def jax_dense_sharded_bound(lp: str, D: int, n: int) -> float:
    pre = JaxPreprocessor(jparse(lp))
    s = jsharding.ShardedSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        mesh=Mesh(np.array(jax.devices()[:D]), ("b",)), nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64)
    s.iteration_block(n)
    return s.lower_bound()


@pytest.mark.parametrize("D", [2, 4])
def test_dense_ranks_agree_and_import_no_jax(dense_results, D):
    res = dense_results[D]
    assert all(r["size"] == D for r in res)
    for r in res[1:]:
        assert {k: v for k, v in r.items() if k != "rank" and not k.startswith("dense bdds")} == {
            k: v for k, v in res[0].items() if k != "rank" and not k.startswith("dense bdds")}
    for name, lp in ranks.DENSE_INSTANCES.items():  # every BDD on one rank
        parts = [r[f"dense bdds {name}"] for r in res]
        nr_bdds = both(lp())[1].collection.nr_bdds()
        assert sorted(b for p in parts for b in p) == list(range(nr_bdds))
    # two all_reduces an iteration, one for the bound
    assert res[0]["dense calls grid"] == 2 * ranks.DENSE_ITERS + 2


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", list(ranks.DENSE_INSTANCES))
def test_dense_ranks_bounds_equal_jax_and_one_device(dense_results, D, name):
    res = dense_results[D][0]
    lp = ranks.DENSE_INSTANCES[name]()
    n = ranks.DENSE_ITERS
    got = lb(res, f"dense lb {name}")
    assert got == pytest.approx(jax_dense_sharded_bound(lp, D, n), abs=1e-12)
    assert got == pytest.approx(one_device_dense(lp, n), abs=1e-12)
    assert lb(res, f"dense lb {name} f32") == pytest.approx(got, rel=1e-5, abs=1e-5)
    if name == "two_simplex" and D == 4:
        assert [] in [r[f"dense bdds {name}"] for r in dense_results[D]]  # an empty shard
