"""Cut tightening in the port (``solver/tighten.py``, the layer-cost warm start,
``export_layer_costs`` and the ``"tighten"`` phase of ``api.BddSolver``)
against the JAX package, on the instances of tests/test_tighten.py.

- The host logic (tight variables, conflict cuts, melding, cost transfer) is
  held exactly: both sides get the SAME min-marginals and layer costs (the
  JAX package's), so ``tight_variables``, which thresholds at ``eps``, cannot
  tip one way on one side and the other way on the other, and must give the
  same groups and the same melded collection with the same costs.
- Separately, the port's own min-marginals and exported layer costs after a
  float64 solve equal the JAX package's (atol 1e-10).
- The ``"tighten"`` pipeline bound equals the JAX package's within abs 1e-8.
"""
import json

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu import api as jax_api
from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.solver import tighten as jt
from bdd_tpu.solver.run import run_solver as j_run_solver
from bdd_tpu.solver.uniform_wrapper import UniformSolver as JaxUniformSolver
from bdd_tpu_torch import api, serve
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import tighten as tt
from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils.problems import independent_set
from tests.test_tighten import TRIANGLE

PENTAGON = ("Minimize\n" + " ".join(f"- x{v}" for v in range(5)) + "\nSubject To\n"
            + "\n".join(f"x{min(a, (a + 1) % 5)} + x{max(a, (a + 1) % 5)} <= 1" for a in range(5))
            + "\nEnd")


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mis_lp(n, p, seed):
    return independent_set(n, edge_prob=p, seed=seed).write_lp()


INSTANCES = {
    "triangle": TRIANGLE,
    "pentagon": PENTAGON,
    "mis30": mis_lp(30, 0.3, 2),
    "mis40": mis_lp(40, 0.25, 1),
}


def preprocessors(lp):
    """(JAX, port) preprocessors of the same bfs-ordered, normalized ILP."""
    out = []
    for parse, pre in ((j_parse_lp_string, JaxPreprocessor), (parse_lp_string, BddPreprocessor)):
        ilp = parse(lp)
        ilp.reorder_bfs()
        ilp.normalize()
        out.append(pre(ilp))
    return out


def converged(lp, iters=500):
    """Both packages' float64 uniform solvers after the same solve, with the
    deferred ledger distributed (what the tightening phase reads)."""
    jpre, pre = preprocessors(lp)
    a = JaxUniformSolver(jpre.collection, jpre.total_nr_variables(), jpre.objective_vector(),
                         nr_primal_vars=jpre.nr_primal_variables, dtype=jnp.float64)
    b = UniformSolver.from_collection(pre.collection, pre.total_nr_variables(),
                                      pre.objective_vector(),
                                      nr_primal_vars=pre.nr_primal_variables,
                                      dtype=torch.float64, device="cpu")
    kw = dict(max_iter=iters, verbose=False, block_size=25)
    j_run_solver(a, **kw)
    run_solver(b, **kw)
    a.distribute_delta()
    b.distribute_delta()
    return jpre, pre, a, b


def collections_equal(x, y):
    assert x.nr_bdds() == y.nr_bdds()
    for b in range(x.nr_bdds()):
        assert x.local_nodes(b) == y.local_nodes(b), b
        assert x.level_variables(b) == y.level_variables(b), b


@pytest.mark.parametrize("cliques", [False, True], ids=["clusters", "cliques"])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_same_marginals_give_the_same_melded_collection(name, cliques):
    jpre, pre, a, b = converged(INSTANCES[name])
    collections_equal(jpre.collection, pre.collection)
    m0, m1 = a.min_marginals()
    costs = a.export_layer_costs()
    tv_j = jt.tight_variables(a.f, m0, m1, 1e-4)
    tv_p = tt.tight_variables(b.f, m0, m1, 1e-4)
    np.testing.assert_array_equal(tv_p, tv_j)
    cuts_j = jt.conflict_cuts(jpre.collection, tv_j) if cliques else None
    cuts_p = tt.conflict_cuts(pre.collection, tv_p) if cliques else None
    assert cuts_p == cuts_j
    col_j, costs_j, groups_j = jt.tighten_collection(jpre.collection, tv_j, layer_costs=costs,
                                                     explicit_groups=cuts_j or None)
    col_p, costs_p, groups_p = tt.tighten_collection(pre.collection, tv_p, layer_costs=costs,
                                                     explicit_groups=cuts_p or None)
    assert groups_p == groups_j
    collections_equal(col_j, col_p)
    assert costs_p == costs_j
    # the warm start on the melded collection: the port's state equals the
    # JAX package's, so its bound does
    ws_j = JaxUniformSolver(col_j, jpre.total_nr_variables(), jpre.objective_vector(),
                            nr_primal_vars=jpre.nr_primal_variables, dtype=jnp.float64,
                            layer_costs=costs_j)
    ws_p = UniformSolver.from_collection(col_p, pre.total_nr_variables(), pre.objective_vector(),
                                         nr_primal_vars=pre.nr_primal_variables,
                                         dtype=torch.float64, device="cpu", layer_costs=costs_p)
    assert ws_p.lower_bound_with_deferred() == pytest.approx(ws_j.lower_bound_with_deferred(),
                                                             abs=1e-10)
    for x, y in zip(ws_p.state.flat[:2], (np.concatenate([np.ravel(v) for v in ws_j.state.lo]),
                                          np.concatenate([np.ravel(v) for v in ws_j.state.hi]))):
        np.testing.assert_allclose(x.numpy(), y, atol=1e-12)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_marginals_and_exported_costs_match_jax(name):
    _, _, a, b = converged(INSTANCES[name])
    for x, y in zip(b.min_marginals(), a.min_marginals()):
        np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
        np.testing.assert_allclose(x[np.isfinite(x)], y[np.isfinite(y)], atol=1e-10)
    cb, ca = b.export_layer_costs(), a.export_layer_costs()
    assert list(cb) == list(ca)
    np.testing.assert_allclose(np.array(list(cb.values())), np.array(list(ca.values())),
                               atol=1e-10)


def test_layer_costs_warm_start_on_packed_wide_and_huge_layouts():
    """``init_uniform_state_from_layer_costs`` places each (bdd, var) cost by
    ``layer_bdd``, exact per slot: on a packed layout (several BDDs a column),
    and on a synthetic layout of wide and huge buckets; triples carry the
    deferred marginal; a missing layer gets (0, 0)."""
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.utils.problems import set_cover
    from tests.test_torch_kernels import random_bucket

    ilp = set_cover(30, 60, seed=3)  # depths that pack several BDDs into a column
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    args = (pre.collection, pre.total_nr_variables(), pre.nr_primal_variables)
    packed = layout.flatten_uniform(*args, dtype=torch.float32, device="cpu")
    assert any(bool(g.roots[1:].any()) for g in packed.geom.buckets)
    rng = np.random.RandomState(0)
    buckets = []
    for k, (P, H, B) in enumerate(((64, 3, 4), (8200, 2, 3))):
        bk = random_bucket(P, H, B, rng, packed=False)
        bk["layer_bdd"] = np.where(bk["layer_valid"], k * 10 + np.arange(B)[None, :], -1)
        buckets.append(bk)
    synthetic = layout._build_host(buckets, np.ones(4, np.int64), 4, 4, 20, torch.float64, "cpu")
    for host in (packed, synthetic):
        lvar = np.concatenate([g.layer_var.numpy().ravel() for g in host.geom.buckets])
        lbdd = np.concatenate([np.ravel(x) for x in host.layer_bdd])
        valid = host.geom.exchange.valid.numpy() & (lbdd >= 0)
        keys = sorted({(int(lbdd[e]), int(lvar[e])) for e in np.nonzero(valid)[0]})
        costs = {k: (rng.randn(), rng.randn(), rng.randn()) for k in keys[1:]}
        st = uf.init_uniform_state_from_layer_costs(host, costs)
        lo, hi, mm, cft = (x.to(torch.float64).numpy() for x in st.flat)
        for e in np.nonzero(valid)[0]:
            want = costs.get((int(lbdd[e]), int(lvar[e])), (0.0, 0.0, 0.0))
            np.testing.assert_allclose((lo[e], hi[e], mm[e]), want, rtol=1e-6)
        assert (lo[~valid] == 0).all() and (hi[~valid] == 0).all()
        ref = uf.backward_run(host.geom, *st.flat[:2])
        assert torch.equal(st.flat[3], ref)


def test_meld_guard_raises_value_error():
    """The one intended difference of the copy: groups that share a BDD are
    refused with ValueError (a bare assert in the original)."""
    _, pre = preprocessors(TRIANGLE)
    with pytest.raises(ValueError, match="disjoint"):
        tt.tighten_collection(pre.collection, [0, 1, 2], explicit_groups=[[0, 1], [1, 2]])


@pytest.mark.parametrize("cliques", [False, True], ids=["clusters", "cliques"])
def test_tighten_and_resolve_matches_jax(cliques):
    """``tighten_and_resolve`` builds the port's UniformSolver warm from the
    transferred duals: its initial bound keeps the converged one and equals
    the JAX package's; the triangle closes to the ILP optimum -1."""
    for name in ("triangle", "mis40"):
        jpre, pre = preprocessors(INSTANCES[name])
        ts_j, g_j = jt.tighten_and_resolve(jpre, {"dtype": jnp.float64}, cliques=cliques)
        ts_p, g_p = tt.tighten_and_resolve(pre, {"dtype": torch.float64, "device": "cpu"},
                                           cliques=cliques)
        assert isinstance(ts_p, UniformSolver)
        assert g_p == g_j and any(len(g) > 1 for g in g_p.values())
        assert ts_p.lower_bound_with_deferred() == pytest.approx(
            ts_j.lower_bound_with_deferred(), abs=1e-8)
        if name == "triangle":
            run_solver(ts_p, max_iter=300, verbose=False, block_size=25)
            assert ts_p.lower_bound_with_deferred() == pytest.approx(-1.0, abs=1e-6)


TIGHTEN_CONFIGS = {"true": True, "cliques": {"cliques": True},
                   "clusters": {"cliques": False, "odd cycles": False}}


@pytest.mark.parametrize("mode", list(TIGHTEN_CONFIGS))
@pytest.mark.parametrize("name", ["mis30", "pentagon"])
def test_tighten_phase_matches_jax(name, mode):
    cfg = {"relaxation solver": "uniform mma", "precision": "double", "variable order": "bfs",
           "termination criteria": {"maximum iterations": 500},
           "tighten": TIGHTEN_CONFIGS[mode], "perturbation rounding": False}
    s = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=INSTANCES[name])
    got = s.solve(verbose=False)
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=INSTANCES[name])
    want = ref.solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["tighten"] == pytest.approx(want["tighten"], abs=1e-8)
    assert got["tighten"]["post_lower_bound"] >= got["tighten"]["pre_lower_bound"] - 1e-9
    st = s.tighten_stats
    assert st["bdds_before"] == s.pre.collection.nr_bdds() and st["groups_melded"] > 0
    assert all(st[k] >= 0 for k in ("min_marginals_s", "meld_s", "rebuild_s", "resolve_s"))
    assert s._python_pipeline_reason() == "the tightening phase melds BDDs of the python collection"
    if name == "mis30" and mode != "clusters":
        base = api.BddSolver({**cfg, "tighten": False}, device="cpu")
        untightened = base.read_ilp(lp_string=INSTANCES[name]).solve(verbose=False)
        assert got["lower_bound"] >= untightened["lower_bound"] + 0.2
    if name == "pentagon" and mode != "clusters":
        assert got["lower_bound"] == pytest.approx(-2.0, abs=1e-6)  # the odd-cycle facet


def test_tighten_through_the_cli_and_the_server(tmp_path):
    lp = tmp_path / "pentagon.lp"
    lp.write_text(INSTANCES["pentagon"])
    cfg = {"input": str(lp), "precision": "double", "tighten": {"cliques": True},
           "termination criteria": {"maximum iterations": 200}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert api.main([str(path), "--device", "cpu"]) == 0
    res = serve.handle_request(dict(cfg), device="cpu")
    assert res["status"] == "solved" and "solution" in res
    assert res["tighten"]["post_lower_bound"] >= res["tighten"]["pre_lower_bound"]
