"""The log-depth prefix sweeps of the port (``bdd_tpu_torch/solver/
prefix.py``) against the JAX package's (``bdd_tpu/solver/prefix.py``) and
against the port's plain hop-loop runs, on the instances of
tests/test_prefix.py: float64, atol 1e-9 with equal ±inf patterns (the
scans associate in another order than ``jax.lax.associative_scan``). The
JAX layout and its state after 5 iterations cross to the port through
``layout.from_jax_arrays``; a packed bucket raises ValueError.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.solver import prefix as jpx
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils.problems import set_cover
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import prefix as px
from bdd_tpu_torch.solver import uniform as uf
from tests import fixtures


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _deep():
    ilp = set_cover(60, 80, density=0.1, seed=2)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp


CASES = {
    "matching": lambda: parse_lp_string(fixtures.MATCHING_3x3),
    "covering": lambda: parse_lp_string(fixtures.COVERING),
    "chain": lambda: parse_lp_string(fixtures.SHORT_MRF_CHAIN),
    "infeasible": lambda: parse_lp_string(fixtures.INFEASIBLE),
    "deep": _deep,
}


def build(name, pack=False, ilp=None):
    """The JAX host and state after 5 iterations, and the same in the port."""
    pre = BddPreprocessor(CASES[name]() if ilp is None else ilp)
    host = juf.flatten_uniform(pre.collection, pre.total_nr_variables(),
                               pre.nr_primal_variables, dtype=jnp.float64, pack=pack)
    state = juf.init_uniform_state(host, pre.objective_vector(), dtype=jnp.float64)
    state = juf.iterations(host.geom, state, 5, 0.5)
    port, ps = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state), dtype=torch.float64)
    return host, state, port, ps


def assert_close_inf(a, b, atol=1e-9):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_array_equal(a[np.isinf(a)], b[np.isinf(b)])
    fin = ~np.isinf(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_transfer_matrices_equal_jax(name):
    host, state, port, ps = build(name)
    for jg, g, jlo, jhi, lo, hi in zip(host.geom.buckets, port.geom.buckets, state.lo,
                                       state.hi, ps.lo, ps.hi):
        got = px._transfer_matrices(g, lo, hi)
        assert got.shape == (g.H, g.P + 1, g.P + 1, g.B)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpx._transfer_matrices(jg, jlo, jhi)))


@pytest.mark.parametrize("name", list(CASES))
def test_prefix_runs_equal_jax_and_the_plain_runs(name):
    host, state, port, ps = build(name)
    for jg, g, jlo, jhi, lo, hi, cft in zip(host.geom.buckets, port.geom.buckets, state.lo,
                                            state.hi, ps.lo, ps.hi, ps.cft):
        back = px.bucket_backward_run_prefix(g, lo, hi)
        assert_close_inf(back, jpx.bucket_backward_run_prefix(jg, jlo, jhi))
        assert_close_inf(back, uf.bucket_backward_run(g, lo, hi))
        assert_close_inf(back, cft)
        fwd = px.bucket_forward_run_prefix(g, lo, hi)
        assert_close_inf(fwd, jpx.bucket_forward_run_prefix(jg, jlo, jhi))
        assert_close_inf(fwd, uf.bucket_forward_run(g, lo, hi))
        M = px._transfer_matrices(g, lo, hi)
        assert torch.equal(px.bucket_backward_run_prefix(g, lo, hi, M=M), back)


@pytest.mark.parametrize("name", list(CASES))
def test_prefix_min_marginals_and_bound_equal_jax(name):
    host, state, port, ps = build(name)
    for jg, g, jlo, jhi, lo, hi in zip(host.geom.buckets, port.geom.buckets, state.lo,
                                       state.hi, ps.lo, ps.hi):
        got = px.bucket_min_marginals_prefix(g, lo, hi)
        for a, b, c in zip(got, jpx.bucket_min_marginals_prefix(jg, jlo, jhi),
                           uf.bucket_min_marginals(g, lo, hi)):
            assert_close_inf(a, b)
            assert_close_inf(a, c)
    lb = px.lower_bound_prefix(port.geom, ps)
    assert lb.dtype == torch.float64 and lb.dim() == 0
    want = float(jpx.lower_bound_prefix(host.geom, state))
    plain = float(uf.lower_bound(port.geom, ps))
    if np.isinf(want):
        assert float(lb) == want == plain
    else:
        assert float(lb) == pytest.approx(want, abs=1e-9)
        assert float(lb) == pytest.approx(plain, abs=1e-9)


def test_a_bucket_of_many_hops():
    """Set-cover rows over about 36 of 60 sets (H > 32: six doubling steps of
    the scan), both runs against the plain ones, and the bound."""
    ilp = set_cover(60, 40, density=0.6, seed=2)
    ilp.reorder_bfs()
    ilp.normalize()
    host, state, port, ps = build(None, ilp=ilp)
    assert max(g.H for g in port.geom.buckets) > 32
    for g, lo, hi in zip(port.geom.buckets, ps.lo, ps.hi):
        assert_close_inf(px.bucket_backward_run_prefix(g, lo, hi),
                         uf.bucket_backward_run(g, lo, hi))
        assert_close_inf(px.bucket_forward_run_prefix(g, lo, hi),
                         uf.bucket_forward_run(g, lo, hi))
    assert float(px.lower_bound_prefix(port.geom, ps)) == pytest.approx(
        float(uf.lower_bound(port.geom, ps)), abs=1e-9)


def test_float32_prefix_runs_match_the_plain_runs():
    host, state, port, ps = build("deep")
    p32, s32 = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state), dtype=torch.float32)
    for g, lo, hi in zip(p32.geom.buckets, s32.lo, s32.hi):
        a = px.bucket_backward_run_prefix(g, lo, hi).numpy()
        b = uf.bucket_backward_run(g, lo, hi).numpy()
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = ~np.isinf(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-5)


def test_packed_bucket_raises():
    """prefix.py:47 of the JAX package asserts an unpacked layout; the port
    raises ValueError."""
    host, state, port, ps = build("matching", pack=True)
    assert any(g.packed for g in port.geom.buckets)
    g = next(g for g in port.geom.buckets if g.packed)
    k = port.geom.buckets.index(g)
    with pytest.raises(ValueError, match="unpacked"):
        px.bucket_backward_run_prefix(g, ps.lo[k], ps.hi[k])
    with pytest.raises(ValueError, match="unpacked"):
        px.lower_bound_prefix(port.geom, ps)
