"""The learned solver's iterations (``solver/learned.py``) against the JAX
package's, values and gradients.

Both packages build the same layout from the same LP (the port's Python
pipeline is a copy) and the state is carried across, so both sides iterate
identical inputs; alpha and omega are drawn with numpy from a seed. Values in
float64 within atol 1e-12. Gradients of the dual loss with respect to alpha
and omega against ``jax.grad`` within rtol 1e-9, atol 1e-10, on instances
with integer costs, where minima tie and deferred marginals are 0 (the tie
rule of ``jnp.maximum``: half the gradient at 0; a chain MRF with isotropic
weights is the case where ``clamp_min``'s rule would differ), on packed
layouts and on one with a wide bucket (P > 32). The port's autograd Functions (kernel
forward, twin recomputation backward; twins both ways on the CPU) are also
held to plain autograd through the twins.
"""
import functools

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.solver import learned as jln
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils.problems import grid_mrf, independent_set
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import learned as ln
from bdd_tpu_torch.solver import uniform as uf
from tests import fixtures
from tests.test_torch_wide import MIXED

ATOL = 1e-12
GRAD_TOL = dict(rtol=1e-9, atol=1e-10)

# an equality forces x1 = x2 = 1: infinite min-marginals and ±inf deferred
# marginals after a few iterations (tests/test_learn.py)
FORCED = """Minimize
x1 + x2 - 2 x3 + x4
Subject To
x1 + x2 = 2
x1 + x3 + x4 <= 2
x3 + x4 >= 1
End"""



def wide_lp(seed: int, n: int = 16) -> str:
    """A knapsack row over n variables (a bucket of P = 64) and n / 2 random
    three-variable rows, integer costs in [-4, 4]."""
    rng = np.random.RandomState(seed)
    obj = " ".join(f"{rng.randint(-4, 5):+d} x{i}" for i in range(n))
    rows = [" + ".join(f"{(7 * i) % 11 + 2} x{i}" for i in range(n)) + f" <= {4 * n}"]
    for _ in range(n // 2):
        a, b, c = rng.choice(n, 3, replace=False)
        rows.append(f"x{a} + x{b} + x{c} {'<=' if rng.rand() < .5 else '>='} 1")
    return "Minimize\n" + obj + "\nSubject To\n" + "\n".join(rows) + "\nEnd"


# name -> (LP, pack, MMA iterations before the learned ones)
CASES = {
    "matching": (fixtures.MATCHING_3x3, False, 0),
    "grid_packed": (grid_mrf(3, 3, 3, seed=1).write_lp(), True, 0),
    "mis": (independent_set(12, 0.3, seed=2).write_lp(), False, 1),
    "wide": (wide_lp(1), False, 1),
    "mixed_wide": (MIXED, False, 0),
    "forced": (FORCED, False, 3),
    "chain_packed": (fixtures.SHORT_MRF_CHAIN, True, 0),
}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers; see tests/test_torch_sweep.py), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def setup(name):
    """A JAX host and state (float64) and the same carried to the port (the
    tests only read them)."""
    lp, pack, iters = CASES[name]
    ilp = j_parse_lp_string(lp)
    ilp.normalize()
    pre = JaxPreprocessor(ilp)
    host = juf.flatten_uniform(pre.collection, pre.total_nr_variables(),
                               pre.nr_primal_variables, dtype=jnp.float64, pack=pack)
    state = juf.init_uniform_state(host, pre.objective_vector(), dtype=jnp.float64)
    if iters:
        state = juf.iterations(host.geom, state, iters, 0.5)
    port, ps = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state))
    return host, state, port, ps


def jsplit(host, x):
    """A flat [E] array as the JAX package's per-bucket [H, B] tuple."""
    out, off = [], 0
    for g in host.geom.buckets:
        n = g.H * g.B
        out.append(jnp.asarray(np.asarray(x)[off:off + n].reshape(g.H, g.B)))
        off += n
    return tuple(out)


def jflat(xs):
    return np.concatenate([np.asarray(x).ravel() for x in xs])


def params(host, port, seed, isotropic=False):
    """Random raw weights and damping, the weights normalized by each package
    (JAX per-bucket, port flat); ``isotropic``: the isotropic weights and
    omega 0.5, which keep the ties of integer costs."""
    rng = np.random.RandomState(seed)
    E = port.geom.plan.E
    raw, omega = rng.rand(E) + 0.05, rng.uniform(0.1, 0.95, E)
    if isotropic:
        raw, omega = port.geom.alpha.numpy(), np.full(E, 0.5)
    ja = jln.normalize_alpha(host.geom, jsplit(host, raw))
    ta = ln.normalize_alpha(port.geom, torch.from_numpy(raw))
    return ja, jsplit(host, omega), ta, torch.from_numpy(omega)


def assert_state_close(js, ts):
    for a, b in zip((js.lo, js.hi, js.def_mm), ts.flat[:3]):
        np.testing.assert_allclose(b.numpy(), jflat(a), rtol=0, atol=ATOL)
    for a, b in zip(js.cft, ts.cft):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)


def test_cases_cover_packing_wide_buckets_and_forcing():
    _, _, port, ps = setup("grid_packed")
    assert any(g.packed for g in port.geom.buckets)
    for name in ("wide", "mixed_wide"):
        _, _, port, _ = setup(name)
        assert max(g.P for g in port.geom.buckets) > layout.NARROW_P
    _, js, _, ps = setup("forced")
    assert np.isinf(jflat(js.def_mm)).any() and torch.isinf(ps.flat[2]).any()


@pytest.mark.parametrize("name", list(CASES))
def test_normalize_alpha_matches_jax(name):
    host, _, port, _ = setup(name)
    ja, _, ta, _ = params(host, port, 0)
    np.testing.assert_allclose(ta.numpy(), jflat(ja), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ln.isotropic_alpha(port.geom).numpy(),
                                  jflat(jln.isotropic_alpha(host.geom)))


@pytest.mark.parametrize("name", list(CASES))
def test_iterations_distribution_bound_and_marginal_differences_match_jax(name):
    host, js, port, ps = setup(name)
    ja, jo, ta, to = params(host, port, 1)
    js = jln.learned_iterations(host.geom, js, ja, jo, 3)
    ps = ln.learned_iterations(port.geom, ps, ta, to, 3)
    assert_state_close(js, ps)
    jd = jln.distribute_delta_learned(host.geom, js, ja)
    td = ln.distribute_delta_learned(port.geom, ps, ta)
    assert_state_close(jd, td)
    for a, b in ((js, ps), (jd, td)):
        np.testing.assert_allclose(ln.per_bdd_lower_bound(port.geom, b).numpy(),
                                   jflat(jln.per_bdd_lower_bound(host.geom, a)), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(ln.all_min_marginal_differences(port.geom, ps).numpy(),
                               jflat(jln.all_min_marginal_differences(host.geom, js)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,n,history", [("grid_packed", 5, 5), ("forced", 6, 3),
                                            ("wide", 4, 4), ("mis", 3, 0)])
def test_iterations_with_stats_match_jax(name, n, history):
    host, js, port, ps = setup(name)
    ja, jo, ta, to = params(host, port, 3)
    jout = jln.learned_iterations_with_stats(host.geom, js, ja, jo, n, history_itr=history,
                                             beta=0.8)
    tout = ln.learned_iterations_with_stats(port.geom, ps, ta, to, n, history_itr=history,
                                            beta=0.8)
    assert_state_close(jout[0], tout[0])
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_allclose(b.numpy(), jflat(a), rtol=0, atol=ATOL)
    if history:
        assert tout[1].abs().max() > 0  # the argmin average is not vacuous


def tie_counting(monkeypatch, factor=0.5):
    """Count the ties of max(x, 0) that backward passes meet; ``factor``: the
    share of the gradient a tie takes (``clamp_min``'s rule is 1)."""
    ties = []

    def counted(ctx, g):
        (x,) = ctx.saved_tensors
        ties.append(int((x == 0).sum()))
        return torch.where(x > 0, g, torch.where(x == 0, factor * g, 0.0))

    monkeypatch.setattr(uf._Relu, "backward", staticmethod(counted))
    return ties


def port_grads(port, ps, ta, to, n):
    a, o = ta.clone().requires_grad_(), to.clone().requires_grad_()
    loss = ln.dual_loss(port.geom, ps, a, o, n)
    loss.backward()
    return loss.item(), a.grad.numpy(), o.grad.numpy()


GRAD_CASES = [("matching", 1, False), ("grid_packed", 1, False), ("grid_packed", 3, False),
              ("mis", 2, False), ("wide", 2, False), ("forced", 2, False),
              ("chain_packed", 3, True)]


@pytest.mark.parametrize("name,n,isotropic", GRAD_CASES)
def test_dual_loss_gradients_match_jax_grad(name, n, isotropic, monkeypatch):
    host, js, port, ps = setup(name)
    ja, jo, ta, to = params(host, port, 4 + n, isotropic)
    jloss, (jga, jgo) = jax.jit(jax.value_and_grad(
        lambda a, o: jln.dual_loss(host.geom, js, a, o, n), argnums=(0, 1)))(ja, jo)
    ties = tie_counting(monkeypatch)
    loss, ga, go = port_grads(port, ps, ta, to, n)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-12, atol=ATOL)
    np.testing.assert_allclose(ga, jflat(jga), **GRAD_TOL)
    np.testing.assert_allclose(go, jflat(jgo), **GRAD_TOL)
    assert sum(ties) > 0
    if name == "chain_packed":
        # the witness of the tie rule: clamp_min's gradient (1 at a tie)
        # moves both gradients off jax.grad's
        tie_counting(monkeypatch, factor=1.0)
        _, ga1, go1 = port_grads(port, ps, ta, to, n)
        assert np.abs(ga1 - jflat(jga)).max() > 1e-4
        assert np.abs(go1 - jflat(jgo)).max() > 1e-4


def test_gradients_are_not_vacuous():
    """The loss moves with alpha and with omega on the grid, MIS and wide
    cases."""
    for name in ("grid_packed", "mis", "wide"):
        host, _, port, ps = setup(name)
        _, ga, go = port_grads(port, ps, *params(host, port, 5)[2:], 2)
        assert np.abs(ga).max() > 1e-2 and np.abs(go).max() > 1e-2, name


@pytest.mark.parametrize("name", ["grid_packed", "wide", "forced"])
def test_functions_equal_plain_autograd_through_the_twins(name):
    """LearnedIteration and BackwardRun (forward through the wrappers,
    backward a recomputation through the twins) give the gradient of plain
    autograd through the twins, with respect to alpha, omega and the
    incoming costs."""
    host, _, port, ps = setup(name)
    _, _, ta, to = params(host, port, 6)
    grads = []
    for sweeps in (None, uf.TWIN_SWEEPS):
        lo, hi, mm, cft = (t.clone().requires_grad_() for t in ps.flat)
        a, o = ta.clone().requires_grad_(), to.clone().requires_grad_()
        state = layout.state_from_flat(port.geom, lo, hi, mm, ln.backward_run(
            port.geom, lo, hi, sweeps))
        loss = ln.dual_loss(port.geom, state, a, o, 3, sweeps)
        grads.append(torch.autograd.grad(loss, (a, o, lo, hi, mm)))
    for x, y in zip(*grads):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=1e-14)


def test_relu_tie_rule_is_jax_maximum():
    x = torch.tensor([-1.0, -0.0, 0.0, 2.0], dtype=torch.float64, requires_grad=True)
    y = uf.relu(x)
    np.testing.assert_array_equal(np.signbit(y.detach().numpy()),
                                  np.signbit(x.detach().clamp_min(0.0).numpy()))
    (g,) = torch.autograd.grad(y.sum(), x)
    (jg,) = jax.grad(lambda v: jnp.maximum(v, 0.0).sum(), argnums=(0,))(
        jnp.asarray([-1.0, -0.0, 0.0, 2.0]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_relax_next_gradient_with_unreached_slots_matches_jax():
    """The scatter-min of the frontier relaxation against the JAX package's
    masked min, gradients included, on a row where some slots receive no
    arc or only +inf: the finite outputs' gradients agree (an infinite
    frontier entry never reaches a finite bound: it feeds only minima that
    take a finite value and where-branches that drop it)."""
    P, B = 4, 3
    rng = np.random.RandomState(7)
    kind = np.zeros((P, B), np.int32)
    kind[3, 0] = 1  # TOP: no internal arc
    slot = np.array([[0, 0, 1], [0, 2, 1], [2, 2, 3], [2, 0, 3]], np.int32)
    valid = np.ones((P, B), bool)
    valid[1, 2] = False
    vals = rng.randint(0, 3, (P, B)).astype(np.float64)
    vals[2, 0] = np.inf
    vals[0, 2] = vals[2, 2] = np.inf

    def jf(v):
        out = juf._relax_next(v, jnp.asarray(kind), jnp.asarray(slot), jnp.asarray(valid), P)
        return jnp.sum(jnp.where(jnp.isfinite(out), out * jnp.arange(1.0, P * B + 1).reshape(P, B),
                                 0.0)), out

    (jval, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    out = uf._relax_next(v, torch.from_numpy(kind), torch.from_numpy(slot),
                         torch.from_numpy(valid), P)
    weights = torch.arange(1.0, P * B + 1, dtype=torch.float64).reshape(P, B)
    total = torch.where(torch.isfinite(out), out * weights, 0.0).sum()
    (g,) = torch.autograd.grad(total, v)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert np.isinf(np.asarray(jout)).any()
    assert total.item() == float(jval)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
