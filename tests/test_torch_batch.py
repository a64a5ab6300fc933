"""``BddSolver.solve_batch`` of the port against ``bdd_tpu``'s and against the
instances solved alone (counterparts of tests/test_api_extra.py:173-273).

float64: the batched layout is the same on both sides and the device rounding
is fed the JAX package's draws, so bounds agree to 1e-8 and solutions are
equal. float32: per-instance bounds equal each instance solved alone to rel
2e-5 (abs 2e-4), the tolerance of the JAX package's own test: the packed and
the single layouts sum the exchange in another order.
"""
import math

import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from bdd_tpu import api as jax_api
from bdd_tpu.ilp import parse_lp_string as jax_parse
from bdd_tpu.utils.problems import independent_set as jax_independent_set
from bdd_tpu.utils.problems import set_cover as jax_set_cover
from bdd_tpu_torch import api
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.utils.problems import independent_set, set_cover
from tests import fixtures
from tests.test_torch_rounding import jax_draws


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LP_INFEASIBLE = """Minimize
x + y
Subject To
x + y >= 1
x + y <= 0
End"""
ITER300 = {"termination criteria": {"maximum iterations": 300}}


def test_solve_batch_serving():
    """K independent ILPs as one program with per-instance bounds and
    solutions; infeasible members flagged."""
    texts = (fixtures.COVERING, fixtures.MATCHING_3x3, LP_INFEASIBLE)
    ilps = [parse_lp_string(t) for t in texts]
    opts = [fixtures.brute_force_ilp_optimum(jax_parse(t))[0] for t in texts[:2]]
    sk.reset_launch_counts()
    res = api.BddSolver(ITER300, device="cpu").solve_batch(ilps=ilps, verbose=False)
    assert len(res) == 3
    assert res[2] == {"status": "infeasible", "lower_bound": math.inf}
    for k in (0, 1):
        assert res[k]["status"] == "solved"
        assert res[k]["lower_bound"] <= opts[k] + 1e-4  # weak duality
    assert not any(sk.LAUNCHES.values())  # CPU: the twins


def test_solve_batch_rounds_feasible():
    texts = (fixtures.COVERING, fixtures.MATCHING_3x3)
    ilps = [parse_lp_string(t) for t in texts]
    opts = [fixtures.brute_force_ilp_optimum(jax_parse(t))[0] for t in texts]
    res = api.BddSolver(ITER300, device="cpu").solve_batch(ilps=ilps, verbose=False)
    for k in (0, 1):
        assert res[k]["status"] == "solved"
        assert res[k]["objective"] == pytest.approx(opts[k], abs=1e-6)
        x = [res[k]["solution"][ilps[k].get_var_name(j)] for j in range(ilps[k].nr_variables())]
        assert ilps[k].feasible(x)


def _instances(mis, cover):
    return [mis(25, edge_prob=0.15, seed=3), cover(15, 30, density=0.2, seed=4),
            mis(20, edge_prob=0.2, seed=5)]


@pytest.mark.parametrize("precision,tol", [("float", dict(rel=2e-5, abs=2e-4)),
                                           ("double", dict(abs=1e-8))])
def test_solve_batch_matches_individual_bounds(precision, tol):
    """Batching is exact: the exchange never mixes instances."""
    cfg = {"termination criteria": {"maximum iterations": 120}, "precision": precision,
           "perturbation rounding": False}
    alone = []
    for ilp in _instances(independent_set, set_cover):
        s = api.BddSolver({**cfg, "use native preprocessing": False}, device="cpu")
        alone.append(s.read_ilp(lp_string=ilp.write_lp()).solve(verbose=False)["lower_bound"])
    res = api.BddSolver(cfg, device="cpu").solve_batch(
        ilps=_instances(independent_set, set_cover), verbose=False)
    for k in range(3):
        assert res[k]["lower_bound"] == pytest.approx(alone[k], **tol)


def _fixture_ilps(parse):
    return [parse(t) for t in (fixtures.COVERING, fixtures.MATCHING_3x3, fixtures.TWO_SIMPLEX)]


@pytest.mark.parametrize("case", ["generators_dual", "fixtures_rounded"])
def test_solve_batch_matches_jax_f64(case):
    rounding = case == "fixtures_rounded"
    cfg = {"termination criteria": {"maximum iterations": 120}, "precision": "double"}
    if rounding:
        jilps, pilps = _fixture_ilps(jax_parse), _fixture_ilps(parse_lp_string)
    else:
        cfg["perturbation rounding"] = False
        jilps = _instances(jax_independent_set, jax_set_cover)
        pilps = _instances(independent_set, set_cover)
    want = jax_api.BddSolver(dict(cfg)).solve_batch(ilps=jilps, verbose=False)
    s = api.BddSolver(dict(cfg), device="cpu")
    got = s.solve_batch(ilps=pilps, verbose=False, draws=jax_draws(0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["status"] == w["status"] == "solved"
        assert g["lower_bound"] == pytest.approx(w["lower_bound"], abs=1e-8)
        assert ("solution" in g) == ("solution" in w) == rounding
        if rounding:
            assert g["solution"] == w["solution"]
            assert g["objective"] == pytest.approx(w["objective"], abs=1e-9)


def test_solve_batch_reads_paths_and_orders_variables(tmp_path):
    paths = []
    for k, text in enumerate((fixtures.COVERING, fixtures.SHORT_MRF_CHAIN)):
        p = tmp_path / f"{k}.lp"
        p.write_text(text)
        paths.append(str(p))
    cfg = {**ITER300, "precision": "double", "variable order": "bfs"}
    want = jax_api.BddSolver(dict(cfg)).solve_batch(paths=paths, verbose=False)
    got = api.BddSolver(dict(cfg), device="cpu").solve_batch(paths=paths, verbose=False,
                                                             draws=jax_draws(0))
    for g, w in zip(got, want):
        assert g["lower_bound"] == pytest.approx(w["lower_bound"], abs=1e-8)
        assert g["solution"] == w["solution"]


def test_solve_batch_refuses_host_solvers_and_says_what_rounding_it_runs(capsys):
    with pytest.raises(ValueError, match="uniform-mma"):
        api.BddSolver({"relaxation solver": "parallel mma"}, device="cpu").solve_batch(
            ilps=[parse_lp_string(fixtures.COVERING)])
    s = api.BddSolver({**ITER300, "rounding method": "wedelin"}, device="cpu")
    res = s.solve_batch(ilps=[parse_lp_string(fixtures.COVERING)], verbose=False)
    assert "no batched device variant" in capsys.readouterr().out
    assert res[0]["status"] == "solved" and "solution" in res[0]


def test_lower_bound_per_bdd_sums_to_the_bound():
    s = api.BddSolver({**ITER300, "precision": "double", "perturbation rounding": False},
                      device="cpu")
    s.solve_batch(ilps=_instances(independent_set, set_cover), verbose=False)
    per_bdd = s.solver.lower_bound_per_bdd()
    assert per_bdd.shape == (s.solver.host.nr_bdds,)
    assert per_bdd.sum() == pytest.approx(s.solver.lower_bound(), abs=1e-9)
