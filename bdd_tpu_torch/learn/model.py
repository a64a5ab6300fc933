"""Bipartite variable-subproblem GNN predicting per-layer MMA parameters.

Port of bdd_tpu/learn/model.py (flax) to ``torch.nn``: rounds of message
passing between variable and BDD nodes through the layer (edge) set, then
heads for per-layer distribution-weight logits, damping logits and, with
``free_update``, a direct zero-sum dual step.

The modules keep flax's names and parameter shapes, so that a flax parameter
tree and a ``state_dict`` are the same leaves under the same paths
(``learn.checkpoint``): a submodule is named as flax names it in order of
creation (``Dense_0``, ``MLP_0``, ``MessagePassingLayer_1``, ...), a
``Dense`` keeps its kernel [in, out] and computes x @ kernel + bias as flax
does, ``LayerNorm`` keeps ``scale``/``bias`` with flax's epsilon (1e-6) and
its one-pass variance, and the LSTM cell keeps flax's eight gate kernels
(input kernels ``ii if ig io`` without bias, hidden kernels ``hi hf hg ho``
with bias). Input widths are given at construction (flax infers them at
``init``). Parameters start float32, as flax's do, and are initialized as
flax initializes them (LeCun-normal kernels, orthogonal hidden kernels, zero
biases, unit scales) from a ``torch.Generator``: the same distributions, not
flax's numbers.

Aggregations are segment sums in slot order (``features.Segments``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from bdd_tpu_torch.learn.features import GraphSpec

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: variance 1 / fan_in, truncated at 2 sd."""
    std = math.sqrt(1.0 / w.shape[0]) / _LECUN_TRUNC
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _activation(name: str):
    return nn.functional.celu if name == "celu" else nn.functional.relu


class Dense(nn.Module):
    """flax ``nn.Dense``: x @ kernel [in, out] + bias."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal_(torch.empty(d_in, d_out), gen))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, variance as
    max(0, mean(x^2) - mean(x)^2), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias."""

    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min(torch.square(x).mean(-1, keepdim=True) - torch.square(mean), 0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class MLP(nn.Module):
    """Dense layers; between two, optional layer norm and the activation
    (model.py:23-41)."""

    def __init__(self, d_in: int, widths: Sequence[int], gen: torch.Generator,
                 layer_norm: bool = False, activation: str = "relu"):
        super().__init__()
        self.widths = tuple(widths)
        self.layer_norm = layer_norm
        self.act = _activation(activation)
        for i, w in enumerate(self.widths):
            setattr(self, f"Dense_{i}", Dense(d_in, w, gen))
            if layer_norm and i + 1 < len(self.widths):
                setattr(self, f"LayerNorm_{i}", LayerNorm(w))
            d_in = w

    def forward(self, x):
        for i in range(len(self.widths)):
            x = getattr(self, f"Dense_{i}")(x)
            if i + 1 < len(self.widths):
                if self.layer_norm:
                    x = getattr(self, f"LayerNorm_{i}")(x)
                x = self.act(x)
        return x


class MessagePassingLayer(nn.Module):
    """One var <-> BDD round through the edges (model.py:44-82): an edge MLP
    on [var, bdd, edge] embeddings, segment means of its output per variable
    and per BDD, and a node MLP each."""

    def __init__(self, dim: int, gen: torch.Generator, layer_norm: bool = False,
                 activation: str = "relu"):
        super().__init__()
        self.act = _activation(activation)

        def mlp(d_in):
            return MLP(d_in, (dim, dim), gen, layer_norm, activation)

        self.MLP_0 = mlp(3 * dim)  # edges
        self.MLP_1 = mlp(2 * dim)  # variables
        self.MLP_2 = mlp(2 * dim)  # BDDs

    def forward(self, spec: GraphSpec, var_e, bdd_e, edge_e):
        msg_in = torch.cat([var_e[spec.layer_var], bdd_e[spec.layer_bdd], edge_e], dim=-1)
        edge_new = torch.where(spec.layer_valid[:, None], self.MLP_0(msg_in), 0.0)

        def mean(segments):
            count = segments.lengths.to(edge_new.dtype).clamp_min(1.0)
            return segments.sum(edge_new) / count[:, None]

        var_new = self.MLP_1(torch.cat([var_e, mean(spec.var_segments)], dim=-1))
        bdd_new = self.MLP_2(torch.cat([bdd_e, mean(spec.bdd_segments)], dim=-1))
        return self.act(var_new), self.act(bdd_new), self.act(edge_new)


class OptimizedLSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``: carry (c, h); gates i, f, o sigmoid and
    g tanh of x @ kernel_x + h @ kernel_h + bias; c' = f c + i g, h' = o
    tanh(c'). The input kernels are LeCun-normal, the hidden ones orthogonal."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, d_in: int, dim: int, gen: torch.Generator):
        super().__init__()
        for gate in self.GATES:
            self.add_module("i" + gate, Dense(d_in, dim, gen, bias=False))
            hidden = Dense(dim, dim, gen)
            with torch.no_grad():
                nn.init.orthogonal_(hidden.kernel, generator=gen)
            self.add_module("h" + gate, hidden)

    def forward(self, carry, x):
        c, h = carry
        pre = {g: getattr(self, "i" + g)(x) + getattr(self, "h" + g)(h) for g in self.GATES}
        new_c = torch.sigmoid(pre["f"]) * c + torch.sigmoid(pre["i"]) * torch.tanh(pre["g"])
        new_h = torch.sigmoid(pre["o"]) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class DogePredictor(nn.Module):
    """Predicts per-layer (alpha logits, omega logits) and, with
    ``free_update``, a zero-sum dual step per layer (model.py:85-159).
    ``nr_rounds`` is the number of message-passing layers. ``use_lstm_var``:
    an LSTM cell over the learned variable features whose state the caller
    carries across dual rounds; ``forward`` then also returns the new state.
    ``var_in``, ``bdd_in``, ``edge_in``: the feature widths."""

    def __init__(self, var_in: int, bdd_in: int, edge_in: int, dim: int = 32,
                 nr_rounds: int = 2, use_lstm_var: bool = False, free_update: bool = False,
                 layer_norm: bool = False, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dim, self.nr_rounds = dim, nr_rounds
        self.use_lstm_var, self.free_update = use_lstm_var, free_update
        self.act = _activation(activation)
        self.Dense_0 = Dense(var_in, dim, gen)
        self.Dense_1 = Dense(bdd_in, dim, gen)
        self.Dense_2 = Dense(edge_in, dim, gen)
        for r in range(nr_rounds):
            setattr(self, f"MessagePassingLayer_{r}",
                    MessagePassingLayer(dim, gen, layer_norm, activation))
        if use_lstm_var:
            self.OptimizedLSTMCell_0 = OptimizedLSTMCell(dim, dim, gen)
        head_in = 3 * dim + (dim if use_lstm_var else 0)
        self.MLP_0 = MLP(head_in, (dim, 2 + int(free_update)), gen, layer_norm, activation)
        if free_update:
            self.free_update_step = nn.Parameter(torch.full((1,), 1e-3))

    def zero_lstm_state(self, nr_vars: int, dtype=torch.float32, device="cpu"):
        z = torch.zeros((nr_vars + 1, self.dim), dtype=dtype, device=device)
        return (z, z)

    def forward(self, spec: GraphSpec, var_f, bdd_f, edge_f, lstm_state=None):
        var_e = self.act(self.Dense_0(var_f))
        bdd_e = self.act(self.Dense_1(bdd_f))
        edge_e = self.act(self.Dense_2(edge_f))
        for r in range(self.nr_rounds):
            var_e, bdd_e, edge_e = getattr(self, f"MessagePassingLayer_{r}")(
                spec, var_e, bdd_e, edge_e)
        var_head = var_e
        new_lstm_state = None
        if self.use_lstm_var:
            if lstm_state is None:
                raise ValueError("use_lstm_var needs a carried state")
            new_lstm_state, h = self.OptimizedLSTMCell_0(lstm_state, var_e)
            var_head = torch.cat([var_e, h], dim=-1)
        head_in = torch.cat([edge_e, var_head[spec.layer_var], bdd_e[spec.layer_bdd]], dim=-1)
        out = self.MLP_0(head_in)
        rets = [out[:, 0], out[:, 1]]
        if self.free_update:
            # a step on the hi costs, scaled by a learned step size and made
            # zero-mean per variable, so the dual stays feasible
            valid = spec.layer_valid
            u = torch.where(valid, out[:, 2] * torch.abs(self.free_update_step[0]), 0.0)
            count = spec.var_segments.lengths.to(u.dtype).clamp_min(1.0)
            mean = spec.var_segments.sum(u) / count
            rets.append(torch.where(valid, u - mean[spec.layer_var], 0.0))
        if self.use_lstm_var:
            rets.append(new_lstm_state)
        return tuple(rets)
