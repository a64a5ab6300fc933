"""Differentiable learned-MMA iterations (the DOGE solver core).

Port of bdd_tpu/solver/learned.py. MMA iterations with per-layer weights
alpha (how a variable's deferred delta is split among its BDDs; normalized
per variable) and per-layer damping omega, both flat [E] tensors in the slot
order of the flat state (``UniformGeom.per_bucket`` gives the [H, B] view of
a bucket).

Forward, an iteration runs the CUDA sweep kernels of ``sweep_kernels`` with
the learned alpha and omega: the kernels read one alpha and one omega per
layer, so the learned path is a new argument of the same launch. The JAX
package differentiates its XLA scans with ``jax.grad`` under
``jax.checkpoint`` per iteration; here the gradient of an iteration is the
recomputation of that iteration through the plain versions ("twins") of the
kernels under autograd (:class:`LearnedIteration`, and :class:`BackwardRun`
for the costs-to-terminal of given costs). The twins equal the kernels bit
for bit, so the recomputed forward is the forward that ran, and one saved
state per iteration bounds the memory as the JAX package's checkpoint does.
On CPU tensors both directions run the twins.

The twins' gradient follows the JAX package's rules: a min that ties splits
its gradient evenly (``amin``, ``torch.minimum`` and the scatter-min do so,
as ``jnp.min`` and ``jnp.minimum``), and max(x, 0) at x == 0 takes half of
it, as ``jnp.maximum`` does (``uniform.relu``). ``sweeps`` =
``uniform.TWIN_SWEEPS`` runs the twins forward and differentiates them
directly (plain autograd, no recomputation): the reference the functions
are held to.
"""
from __future__ import annotations

import torch

from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import UniformGeom, UniformState, flatten, state_from_flat


def _records(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on any of xs."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _iteration_flat(geom: UniformGeom, lo, hi, mm, cft, alpha, omega, sweeps=None,
                    delta_reduce=None):
    state = uf.iteration(geom, state_from_flat(geom, lo, hi, mm, cft), omega, sweeps,
                         delta_reduce=delta_reduce, alpha=alpha)
    return state.flat


class LearnedIteration(torch.autograd.Function):
    """One learned iteration on the flat state (lo, hi, def_mm [E], cft [N])
    with flat alpha and omega [E]: exchange, forward kernel, exchange,
    backward kernel. Backward recomputes the iteration from its saved inputs
    through the twins and differentiates that. ``delta_reduce``: the
    exchange's hook (:func:`uniform.exchange_delta_flat`), run again in the
    recomputation; a sharded solve passes a sum across its ranks whose own
    backward sums the gradients across them."""

    @staticmethod
    def forward(ctx, geom, delta_reduce, lo, hi, mm, cft, alpha, omega):
        ctx.geom = geom
        ctx.delta_reduce = delta_reduce
        ctx.save_for_backward(lo, hi, mm, cft, alpha, omega)
        return _iteration_flat(geom, lo, hi, mm, cft, alpha, omega, delta_reduce=delta_reduce)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _iteration_flat(ctx.geom, *inputs, sweeps=uf.TWIN_SWEEPS,
                                   delta_reduce=ctx.delta_reduce)
        return (None, None, *torch.autograd.grad(outs, inputs, grads, allow_unused=True))


def _plain_run(geom: UniformGeom, lo, hi) -> torch.Tensor:
    return geom.flatten_nodes([
        uf.bucket_backward_run(g, l, h)
        for g, l, h in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))
    ])


class BackwardRun(torch.autograd.Function):
    """Costs-to-terminal cft [N] of flat costs (lo, hi [E]): the run-only
    entry of the backward kernel forward, the plain run recomputed under
    autograd backward."""

    @staticmethod
    def forward(ctx, geom, lo, hi):
        ctx.geom = geom
        ctx.save_for_backward(lo, hi)
        return sk.backward_run_cuda(geom, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            cft = _plain_run(ctx.geom, *inputs)
        return (None, *torch.autograd.grad(cft, inputs, grad, allow_unused=True))


def backward_run(geom: UniformGeom, lo, hi, sweeps=None) -> torch.Tensor:
    """Differentiable costs-to-terminal of flat costs: :class:`BackwardRun`
    (the kernel's run-only entry on the card), or the plain run bucket by
    bucket when ``sweeps`` asks for the twins."""
    if sweeps is not None:
        return _plain_run(geom, lo, hi)
    if _records(lo, hi):
        return BackwardRun.apply(geom, lo, hi)
    return sk.backward_run_cuda(geom, lo, hi)


def isotropic_alpha(geom: UniformGeom) -> torch.Tensor:
    """1 / #BDDs of the variable per layer: the non-learned weights."""
    return geom.alpha


def normalize_alpha(geom: UniformGeom, raw: torch.Tensor) -> torch.Tensor:
    """Nonnegative per-layer weights [E] scaled to sum to 1 over each
    variable's layers (learned.py:33-50); 0 at invalid slots. The sums run
    over the exchange's segments, in slot order."""
    ex = geom.exchange
    total = torch.segment_reduce(raw[ex.order], "sum", lengths=ex.segments, axis=0, unsafe=True,
                                 initial=0.0)
    return torch.where(ex.valid, raw / torch.clamp_min(total, 1e-30)[ex.ids], 0.0)


def learned_iteration(geom: UniformGeom, state: UniformState, alpha: torch.Tensor,
                      omega: torch.Tensor, sweeps=None, delta_reduce=None) -> UniformState:
    """One dual iteration with per-layer (alpha, omega) (learned.py:53-95).
    ``sweeps``: ``uniform.TWIN_SWEEPS`` to run the twins under plain autograd
    in place of :class:`LearnedIteration`; ``delta_reduce``: the exchange's
    hook (the sharded solve's sum across ranks)."""
    lo, hi, mm, cft = state.flat
    if sweeps is not None:
        out = _iteration_flat(geom, lo, hi, mm, cft, alpha, omega, sweeps, delta_reduce)
    elif _records(lo, hi, mm, cft, alpha, omega):
        out = LearnedIteration.apply(geom, delta_reduce, lo, hi, mm, cft, alpha, omega)
    else:
        out = _iteration_flat(geom, lo, hi, mm, cft, alpha, omega, delta_reduce=delta_reduce)
    return state_from_flat(geom, *out)


def learned_iterations(geom: UniformGeom, state: UniformState, alpha, omega, n: int,
                       sweeps=None, delta_reduce=None) -> UniformState:
    """n differentiable iterations (learned.py:98-115): autograd keeps one
    saved state per iteration."""
    for _ in range(n):
        state = learned_iteration(geom, state, alpha, omega, sweeps, delta_reduce)
    return state


def per_bdd_lower_bound(geom: UniformGeom, state: UniformState) -> torch.Tensor:
    """Per-BDD root costs of the state's cft, flat [E]: the root slot's cost at
    every row where a BDD starts, 0 elsewhere (learned.py:220-229)."""
    return flatten([torch.where(g.roots, c[:, 0, :], 0.0)
                    for g, c in zip(geom.buckets, state.cft)])


def learned_iterations_with_stats(geom: UniformGeom, state: UniformState, alpha, omega,
                                  n: int, history_itr: int = 0, beta: float = 0.9,
                                  sweeps=None, delta_reduce=None):
    """n iterations that also keep the exponential moving averages of the
    last ``history_itr`` iterations (learned.py:118-187): per layer the
    argmin solution (``sol_avg``), per BDD root the first and second
    differences of its bound. Returns (state, sol_avg, lb_fo_avg, lb_so_avg),
    the averages flat [E]. The statistics are torch ops on the iterations'
    outputs, so a gradient through a later round reaches them (the solution
    is an integer choice and carries none)."""
    k0 = n - min(history_itr, n)
    z = torch.zeros_like(state.flat[0])
    sol_avg, fo_avg, so_avg, fo_prev = z, z, z, z
    lb_prev = per_bdd_lower_bound(geom, state)
    count = 0

    def ema(avg, new):
        return new if count == 0 else beta * avg + (1.0 - beta) * new

    for i in range(n):
        state = learned_iteration(geom, state, alpha, omega, sweeps, delta_reduce)
        lb = per_bdd_lower_bound(geom, state)
        if i >= k0:
            sol = flatten(uf.bdds_solution(geom, state)).to(z.dtype)
            fo = lb - lb_prev
            so = fo - fo_prev
            sol_avg, fo_avg, so_avg = ema(sol_avg, sol), ema(fo_avg, fo), ema(so_avg, so)
            fo_prev = fo
            count += 1
        lb_prev = lb
    return state, sol_avg, fo_avg, so_avg


def distribute_delta_learned(geom: UniformGeom, state: UniformState, alpha,
                             sweeps=None, delta_reduce=None) -> UniformState:
    """Fold the deferred deltas into the costs with the learned weights
    (learned.py:190-217). The double where keeps an infinite delta (a forced
    variable) out of the product with alpha, whose gradient would be
    0 x inf = NaN; the infinity is added back unscaled. ``delta_reduce``:
    the exchange's hook."""
    lo, hi, mm, _ = state.flat
    din_lo, din_hi = uf.exchange_delta_flat(geom, mm, delta_reduce)
    valid = geom.exchange.valid

    def scaled(d):
        fin = torch.isfinite(d)
        return alpha * torch.where(fin, d, 0.0) + torch.where(fin, 0.0, d)

    nl = torch.where(valid, lo + scaled(din_lo), 0.0)
    nh = torch.where(valid, hi + scaled(din_hi), 0.0)
    return state_from_flat(geom, nl, nh, torch.zeros_like(nl), backward_run(geom, nl, nh, sweeps))


def dual_loss(geom: UniformGeom, state: UniformState, alpha, omega, n: int,
              sweeps=None, delta_reduce=None) -> torch.Tensor:
    """-lower bound after n learned iterations and the learned delta
    distribution: the DOGE training loss (learned.py:232-246); on a shard,
    its share of it (``delta_reduce``: the exchange's hook)."""
    out = learned_iterations(geom, state, alpha, omega, n, sweeps, delta_reduce)
    out = distribute_delta_learned(geom, out, alpha, sweeps, delta_reduce)
    return -per_bdd_lower_bound(geom, out).sum()


def all_min_marginal_differences(geom: UniformGeom, state: UniformState,
                                 sweeps=None) -> torch.Tensor:
    """Per-layer min-marginal differences m1 - m0, flat [E] (a GNN feature;
    learned.py:249-256): +-1e9 where a side is infinite, 0 at invalid slots.
    The costs-to-terminal are a fresh run of the state's costs, as in the JAX
    package (one launch of the run entry on the card)."""
    lo, hi, _, _ = state.flat
    cft = geom.per_bucket_nodes(backward_run(geom, lo, hi, sweeps))
    out = []
    for g, l, h, c in zip(geom.buckets, state.lo, state.hi, cft):
        m0, m1 = uf.bucket_min_marginals(g, l, h, c)
        f0, f1 = torch.isfinite(m0), torch.isfinite(m1)
        d = torch.where(f0 & f1, m1 - m0, torch.where(f0, 1e9, -1e9))
        out.append(torch.where(g.layer_valid, d, 0.0))
    return flatten(out)
