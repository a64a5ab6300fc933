"""DOGE training over the ranks of a sharded solve (counterpart of
bdd_tpu/learn/sharded.py).

The GNN is small and runs replicated on every rank over the GLOBAL VIEW of
the sharded layout (``ShardedUniformSolver.global_view``: every shard's
bucket columns side by side; features and predictions are per column, per
variable or per BDD, so the view gives what the whole collection would).
The learned rollout runs sharded: each rank's learned iterations run on its
own shard through ``solver.learned``, with the exchange's sum across the
ranks as its ``delta_reduce`` hook, whose gradient is the sum of the ranks'
gradients.

Per round:
    view state  <- every rank's shard gathered       (all_gather)
    features    <- compute_features(view)            (replicated)
    alpha/omega <- DogePredictor(features)           (replicated)
    normalize   <- per variable over all shards      (the view)
    own block   <- this rank's columns of the view
    rollout     <- learned iterations on the shard   (sum across ranks)
The loss is the negated global bound after the last ``grad_rounds`` rounds
(deferred deltas distributed with the learned alpha). Each rank
backpropagates its own share of it; the sums across the ranks inside the
rollout carry the gradients between the shards, and the replicated
parameters' gradients are summed across the ranks before Adam, so that every
rank holds the same parameters after a step.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bdd_tpu_torch.learn import features as ft
from bdd_tpu_torch.learn.model import DogePredictor
from bdd_tpu_torch.learn.train import TrainConfig
from bdd_tpu_torch.solver import learned as ln
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import state_from_flat
from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver, all_reduce


class ShardedDogeTrainer:
    """Trains a DOGE policy with sharded rollouts; ``solver``: every rank's
    ``ShardedUniformSolver`` of the training instance. Every method is called
    by every rank in the same order."""

    def __init__(self, solver: ShardedUniformSolver, objective, config: TrainConfig) -> None:
        if config.history_features:
            # the JAX package's sharded trainer leaves them out without a word
            raise ValueError("the sharded trainer computes no history features "
                             "(TrainConfig.history_features)")
        self.solver = solver
        self.cfg = config
        self.view_host = solver.global_view()
        geom = self.view_host.geom
        self.objective = torch.from_numpy(np.asarray(objective, dtype=np.float64)).to(
            geom.device, geom.dtype)
        self.spec = ft.graph_spec(self.view_host)
        self.model: Optional[DogePredictor] = None
        self.opt: Optional[torch.optim.Adam] = None
        self.state0 = solver.state

    # ----------------------------------------------------------------- setup
    def _zero_lstm(self):
        if not self.cfg.use_lstm_var:
            return None
        geom = self.view_host.geom
        return self.model.zero_lstm_state(self.spec.nr_vars, geom.dtype, geom.device)

    def init(self) -> None:
        """The model from ``cfg.seed`` (the same on every rank) and Adam."""
        with torch.no_grad():
            var_f, bdd_f, edge_f = self._features(self.state0)
        cfg = self.cfg
        geom = self.view_host.geom
        self.model = DogePredictor(
            var_f.shape[1], bdd_f.shape[1], edge_f.shape[1], dim=cfg.dim,
            use_lstm_var=cfg.use_lstm_var, free_update=cfg.free_update,
            layer_norm=cfg.layer_norm, activation=cfg.activation,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(geom.device, geom.dtype)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    # ------------------------------------------------------------- internals
    def _features(self, state):
        # the previous round's bounds are not threaded through the sharded
        # rollout (as in the JAX package): a zero column keeps the feature
        # layout of the one-device trainer, so configs and models transfer
        geom = self.view_host.geom
        prev_lb = (torch.zeros(self.view_host.nr_bdds + 1, dtype=geom.dtype, device=geom.device)
                   if self.cfg.prev_lb_features else None)
        return ft.compute_features(
            self.view_host, self.spec, self.solver.view_state(state), self.objective,
            self.cfg.smoothing, smooth_temps=self.cfg.smooth_temps, prev_lb_per_bdd=prev_lb)

    def _predict(self, state, lstm=None):
        """This shard's (alpha [E], omega [E], free update [E] or None) and
        the LSTM state."""
        var_f, bdd_f, edge_f = self._features(state)
        out = self.model(self.spec, var_f, bdd_f, edge_f, lstm_state=lstm)
        raw = torch.where(self.spec.layer_valid, torch.exp(torch.clamp(out[0], -10, 10)), 0.0)
        own = self.solver.stack_layers
        alpha = own(ln.normalize_alpha(self.view_host.geom, raw))
        omega = own(torch.sigmoid(out[1]))
        update = own(out[2]) if self.cfg.free_update else None
        if self.cfg.use_lstm_var:
            lstm = out[-1]
        return alpha, omega, update, lstm

    def _round(self, state, lstm=None):
        """Predict, free update (hi += the zero-sum step, with a fresh
        backward run), the learned iterations. Returns (state, lstm,
        alpha)."""
        geom = self.solver.geom
        alpha, omega, update, lstm = self._predict(state, lstm)
        if update is not None:
            lo, hi, mm, _ = state.flat
            nh = hi + update
            state = state_from_flat(geom, lo, nh, mm, ln.backward_run(geom, lo, nh))
        state = ln.learned_iterations(geom, state, alpha, omega, self.cfg.iters_per_round,
                                      delta_reduce=self.solver.delta_reduce)
        return state, lstm, alpha

    def _local_loss(self, state, lstm=None):
        """This shard's share of the round's loss: its BDDs' bounds, negated,
        after the deltas are distributed with the learned alpha."""
        state, lstm, alpha = self._round(state, lstm)
        dist = ln.distribute_delta_learned(self.solver.geom, state, alpha,
                                           delta_reduce=self.solver.delta_reduce)
        return -ln.per_bdd_lower_bound(self.solver.geom, dist).sum(), state, lstm

    # ---------------------------------------------------------------- training
    def loss_and_grads(self):
        """One epoch's rounds from the initial state: the rounds without
        gradients, then the gradient rounds; the parameters' ``.grad`` hold
        the gradient of the global loss on every rank (accumulated; zero them
        first). Returns the global loss (0-dim tensor)."""
        cfg = self.cfg
        state, lstm = self.state0, self._zero_lstm()
        with torch.no_grad():
            for _ in range(cfg.nr_rounds - cfg.grad_rounds):
                state, lstm, _ = self._round(state, lstm)
        total = 0.0
        for _ in range(cfg.grad_rounds):
            loss, state, lstm = self._local_loss(state, lstm)
            total = total + loss
        total.backward()
        comm = self.solver.comm
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            comm.all_reduce_(p.grad)
        return all_reduce(comm, total.detach())

    def train_step(self) -> Dict[str, float]:
        """One epoch on the instance and one Adam step (the same on every
        rank)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_and_grads()
        self.opt.step()
        return {"loss": float(loss)}

    @torch.no_grad()
    def run_learned_rounds(self, nr_rounds: Optional[int] = None) -> List[float]:
        """The global bound after each round of a rollout with the trained
        policy (deferred deltas distributed isotropically, as the JAX
        package's sharded rollout reads it)."""
        n = nr_rounds if nr_rounds is not None else self.cfg.nr_rounds
        state, lstm = self.state0, self._zero_lstm()
        lbs = []
        for _ in range(n):
            state, lstm, _ = self._round(state, lstm)
            dist = uf.distribute_delta(self.solver.geom, state,
                                       delta_reduce=self.solver.delta_reduce)
            lbs.append(float(self.solver._bound(dist)))
        return lbs
