"""DOGE training and inference: learn per-layer MMA parameters with a GNN.

Port of bdd_tpu/learn/train.py. For each dual round the GNN reads features of
the solver state and predicts per-layer (alpha, omega) and, with
``free_update``, a direct dual step; the solver runs ``iters_per_round``
learned iterations on the CUDA sweep kernels; the loss is the negated sum of
per-BDD lower bounds after the learned delta distribution. The first
``nr_rounds - grad_rounds`` rounds run without gradients, the last
``grad_rounds`` with them (train.py:286-318); a gradient recomputes each
iteration through the kernels' plain versions (``solver.learned``). optax's
adam becomes ``torch.optim.Adam`` with the same rate, betas and epsilon.

The JAX package jits a round and scans the rounds of a rollout
(train.py:345-363) to keep the host out of the loop; PyTorch runs eagerly,
and ``run_learned_rounds(fused=True)`` keeps the per-round bounds on the
device and reads them with one host sync per rollout.

An instance lives where its layout lives: ``Instance.from_ilp`` builds on
the card unless ``device="cpu"`` is passed, and the trainer's model and
optimizer follow the instance they are initialized on. The model's
parameters take the instance's float type (the JAX package keeps float32
parameters and promotes the products to float64 on a float64 instance; the
values are the same).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.learn import checkpoint
from bdd_tpu_torch.learn import features as ft
from bdd_tpu_torch.learn.model import DogePredictor
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import learned as ln
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import UniformHost, UniformState, state_from_flat
from bdd_tpu_torch.utils.logging import span


# spans of a round, recorded while a profiler records (BDD_TPU_TRACE): the
# features, the GNN with its heads, the free update with the learned
# iterations, the delta distribution with the bound
SPANS = ("doge.features", "doge.gnn", "doge.iterations", "doge.bound")


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters (train.py:28-49; ref: DOGE/configs/defaults.py)."""

    dim: int = 32
    nr_rounds: int = 3  # dual rounds per instance per epoch
    iters_per_round: int = 5  # learned iterations per round
    grad_rounds: int = 1  # rounds (from the end) with gradients
    lr: float = 1e-3
    epochs: int = 5
    smoothing: float = 1.0
    seed: int = 0
    use_lstm_var: bool = False  # per-variable LSTM over rounds
    free_update: bool = False  # direct zero-sum dual step head
    use_replay: bool = False  # resume epochs from replayed states
    history_features: bool = False  # moving-average history features
    history_beta: float = 0.9
    layer_norm: bool = False  # LayerNorm in the GNN's MLPs
    activation: str = "relu"  # or "celu"
    smooth_temps: Tuple[float, ...] = ()  # smooth_sol@T edge features
    prev_lb_features: bool = True  # 'prev_lb' / 'lb_change' BDD features


def _detached(state: UniformState, geom) -> UniformState:
    return state_from_flat(geom, *(t.detach() for t in state.flat))


def _on_layout(host: UniformHost, objective) -> torch.Tensor:
    """The objective [V] in the layout's float type on its device."""
    geom = host.geom
    return torch.from_numpy(np.asarray(objective, dtype=np.float64)).to(geom.device, geom.dtype)


class Instance:
    """A preprocessed training instance: the layout, the objective on the
    layout's device, the graph and the initial state."""

    def __init__(self, host: UniformHost, objective, pre=None):
        self.host = host
        self.objective = _on_layout(host, objective)
        self.spec = ft.graph_spec(host, pre)
        self.state0 = uf.init_uniform_state(host, objective)

    @classmethod
    def from_ilp(cls, ilp, dtype=torch.float32, device="cuda"):
        from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor

        ilp.normalize()
        pre = BddPreprocessor(ilp)
        host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                      pre.nr_primal_variables, dtype=dtype,
                                      device=layout.resolve_device(device))
        return cls(host, pre.objective_vector(), pre=pre)

    @classmethod
    def from_cached(cls, host, objective, spec, layer_costs=None):
        """From a cached layout and graph; ``layer_costs`` ({(bdd, var): (lo,
        hi[, mm])}, the converged duals) replaces the objective-split
        initial state."""
        self = cls.__new__(cls)
        self.host = host
        self.objective = _on_layout(host, objective)
        self.spec = spec
        if layer_costs is not None:
            self.state0 = uf.init_uniform_state_from_layer_costs(host, layer_costs)
        else:
            self.state0 = uf.init_uniform_state(host, objective)
        return self

    @classmethod
    def from_ilps(cls, ilps, dtype=torch.float32, device="cuda"):
        """Several ILPs as ONE instance over disjoint variable spaces: message
        passing and the exchange never mix them, and the loss is the sum of
        their losses."""
        from bdd_tpu_torch.utils.batching import BatchedInstances

        for ilp in ilps:
            ilp.normalize()
        bi = BatchedInstances(ilps)
        host = layout.flatten_uniform(bi.collection, bi.nr_vars, bi.nr_vars, dtype=dtype,
                                      device=layout.resolve_device(device))
        return cls(host, bi.objective, pre=bi)


class ReplayBuffer:
    """Solver states per (instance, round), so that a later epoch can resume
    mid-trajectory (ref: DOGE/data/replay_buffer.py)."""

    def __init__(self, capacity_per_key: int = 4) -> None:
        self.capacity = capacity_per_key
        self._store: Dict[Tuple[int, int], List[Any]] = {}

    def add(self, instance_id: int, round_nr: int, state) -> None:
        lst = self._store.setdefault((instance_id, round_nr), [])
        lst.append(state)
        if len(lst) > self.capacity:
            lst.pop(0)

    def sample(self, instance_id: int, round_nr: int, rng: np.random.RandomState):
        lst = self._store.get((instance_id, round_nr))
        if not lst:
            return None
        return lst[rng.randint(len(lst))]


class DogeTrainer:
    """``sweeps``: None runs the learned iterations on the kernels (the
    twins on CPU tensors); ``uniform.TWIN_SWEEPS`` runs every iteration and
    run through the twins under plain autograd (the reference the kernel
    path is held to)."""

    def __init__(self, config: Optional[TrainConfig] = None):
        self.cfg = config if config is not None else TrainConfig()
        self.model: Optional[DogePredictor] = None
        self.opt: Optional[torch.optim.Adam] = None
        self.replay = ReplayBuffer()
        self._replay_rng = np.random.RandomState(self.cfg.seed)
        self.sweeps = None

    # ----------------------------------------------------------------- setup
    def _zero_lstm(self, instance: Instance):
        if not self.cfg.use_lstm_var:
            return None
        geom = instance.host.geom
        return self.model.zero_lstm_state(instance.spec.nr_vars, geom.dtype, geom.device)

    def _zero_prev_lb(self, instance: Instance):
        if not self.cfg.prev_lb_features:
            return None
        geom = instance.host.geom
        return torch.zeros(instance.host.nr_bdds + 1, dtype=geom.dtype, device=geom.device)

    def _zero_history(self, instance: Instance):
        if not self.cfg.history_features:
            return None
        z = torch.zeros_like(instance.state0.flat[0])
        return (z, z, z)

    def _features(self, instance: Instance, state, history, prev_lb):
        return ft.compute_features(
            instance.host, instance.spec, state, instance.objective, self.cfg.smoothing,
            history=history, smooth_temps=self.cfg.smooth_temps, prev_lb_per_bdd=prev_lb)

    def init(self, instance: Instance) -> None:
        """A freshly initialized model (from ``cfg.seed``) and optimizer, in
        the instance's float type on its device."""
        with torch.no_grad():
            var_f, bdd_f, edge_f = self._features(
                instance, instance.state0, self._zero_history(instance),
                self._zero_prev_lb(instance))
        cfg = self.cfg
        geom = instance.host.geom
        self.model = DogePredictor(
            var_f.shape[1], bdd_f.shape[1], edge_f.shape[1], dim=cfg.dim,
            use_lstm_var=cfg.use_lstm_var, free_update=cfg.free_update,
            layer_norm=cfg.layer_norm, activation=cfg.activation,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(geom.device, geom.dtype)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    # ------------------------------------------------------------- internals
    def _predict(self, instance: Instance, state, lstm=None, history=None, prev_lb=None):
        """(alpha [E], omega [E], free update [E] or None, LSTM state)."""
        if prev_lb is None:
            prev_lb = self._zero_prev_lb(instance)
        with span(SPANS[0]):
            var_f, bdd_f, edge_f = self._features(instance, state, history, prev_lb)
        with span(SPANS[1]):
            out = self.model(instance.spec, var_f, bdd_f, edge_f, lstm_state=lstm)
            geom = instance.host.geom
            valid = instance.spec.layer_valid
            raw = torch.where(valid, torch.exp(torch.clamp(out[0], -10, 10)), 0.0)
            alpha = ln.normalize_alpha(geom, raw)
            omega = torch.sigmoid(out[1])
        update = out[2] if self.cfg.free_update else None
        if self.cfg.use_lstm_var:
            lstm = out[-1]
        return alpha, omega, update, lstm

    def _apply_free_update(self, geom, state, update):
        """hi += the zero-sum step, with a fresh backward run (train.py:229-243):
        the net cost of every variable is unchanged."""
        if update is None:
            return state
        lo, hi, mm, _ = state.flat
        nh = hi + update
        return state_from_flat(geom, lo, nh, mm, ln.backward_run(geom, lo, nh, self.sweeps))

    def _round(self, instance: Instance, state, lstm=None, history=None, prev_lb=None):
        """One round (train.py:245-276): predict, free update, the learned
        iterations, the learned delta distribution. Returns (distributed
        state, new state, lstm, history, prev_lb)."""
        cfg = self.cfg
        geom = instance.host.geom
        alpha, omega, update, lstm = self._predict(instance, state, lstm, history, prev_lb)
        with span(SPANS[2]):
            if cfg.prev_lb_features:
                prev_lb = ft.per_bdd_lb_vector(instance.host, instance.spec, state)
            state = self._apply_free_update(geom, state, update)
            if cfg.history_features:
                state, sol_avg, fo, so = ln.learned_iterations_with_stats(
                    geom, state, alpha, omega, cfg.iters_per_round,
                    history_itr=cfg.iters_per_round, beta=cfg.history_beta, sweeps=self.sweeps)
                history = (sol_avg, fo, so)
            else:
                state = ln.learned_iterations(geom, state, alpha, omega, cfg.iters_per_round,
                                              self.sweeps)
        with span(SPANS[3]):
            dist = ln.distribute_delta_learned(geom, state, alpha, self.sweeps)
        return dist, state, lstm, history, prev_lb

    def _round_loss(self, instance: Instance, state, lstm=None, history=None, prev_lb=None):
        dist, state, lstm, history, prev_lb = self._round(instance, state, lstm, history,
                                                          prev_lb)
        loss = -ln.per_bdd_lower_bound(instance.host.geom, dist).sum()
        return loss, state, lstm, history, prev_lb

    # ---------------------------------------------------------------- training
    def loss_and_grads(self, instance: Instance, state0=None):
        """The rounds of one epoch from ``state0`` (default the instance's):
        the pre-rounds without gradients, then the gradient rounds, whose
        summed loss is backpropagated into the parameters' ``.grad``
        (accumulated; zero them first). Returns (loss tensor, end state)."""
        cfg = self.cfg
        geom = instance.host.geom
        state = instance.state0 if state0 is None else state0
        lstm, hist, plb = (self._zero_lstm(instance), self._zero_history(instance),
                           self._zero_prev_lb(instance))
        with torch.no_grad():
            for _ in range(cfg.nr_rounds - cfg.grad_rounds):
                _, state, lstm, hist, plb = self._round_loss(instance, state, lstm, hist, plb)
        total = 0.0
        for _ in range(cfg.grad_rounds):
            loss, state, lstm, hist, plb = self._round_loss(instance, state, lstm, hist, plb)
            total = total + loss
        total.backward()
        return total.detach(), _detached(state, geom)

    def train_step(self, instance: Instance) -> Dict[str, float]:
        """One epoch on one instance and one optimizer step. With
        ``use_replay`` an epoch may resume from a replayed end state of an
        earlier one (train.py:320-337)."""
        state0 = instance.state0
        if self.cfg.use_replay and self._replay_rng.rand() < 0.5:
            replayed = self.replay.sample(id(instance), 0, self._replay_rng)
            if replayed is not None:
                state0 = replayed
        self.opt.zero_grad(set_to_none=True)
        loss, end_state = self.loss_and_grads(instance, state0)
        self.opt.step()
        if self.cfg.use_replay:
            self.replay.add(id(instance), 0, end_state)
        return {"loss": float(loss)}

    # --------------------------------------------------------------- inference
    @torch.no_grad()
    def run_learned_rounds(self, instance: Instance, nr_rounds: Optional[int] = None,
                           fused: bool = True) -> List[float]:
        """The lower bound after each round of a rollout with the trained
        policy (train.py:339-398): the bound the loss optimizes, deferred
        deltas distributed with the learned alpha. Every round's bound is a
        valid bound; ``best_bound`` takes the largest. ``fused`` keeps the
        bounds on the device and reads them once, at the end (one host sync
        per rollout); False reads each round's bound as it comes."""
        geom = instance.host.geom
        state = instance.state0
        lstm, hist, plb = (self._zero_lstm(instance), self._zero_history(instance),
                           self._zero_prev_lb(instance))
        n = nr_rounds if nr_rounds is not None else self.cfg.nr_rounds
        lbs = []
        for _ in range(n):
            dist, state, lstm, hist, plb = self._round(instance, state, lstm, hist, plb)
            with span(SPANS[3]):
                lb = uf.lower_bound_from_cft(geom, dist.cft)
            lbs.append(lb if fused else float(lb))
        if fused and lbs:
            return torch.stack(lbs).tolist()
        return lbs

    def best_bound(self, instance: Instance, nr_rounds: Optional[int] = None) -> float:
        """The largest bound over a learned rollout (each round is valid)."""
        return max(self.run_learned_rounds(instance, nr_rounds))

    # ------------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """A checkpoint in the JAX package's format (``learn.checkpoint``)."""
        checkpoint.save(path, dataclasses.asdict(self.cfg), self.model.state_dict())

    def load(self, path: str, example_instance: Instance) -> None:
        """Config and parameters of a checkpoint of this package or of the
        JAX package; keys a checkpoint predates take ``TrainConfig``'s
        defaults. The model is built on ``example_instance`` (its feature
        widths, device and float type)."""
        cfg_d, params = checkpoint.load(path)
        if "smooth_temps" in cfg_d:
            cfg_d["smooth_temps"] = tuple(cfg_d["smooth_temps"])
        self.cfg = TrainConfig(**cfg_d)
        self.init(example_instance)
        geom = example_instance.host.geom
        self.model.load_state_dict({k: v.to(geom.device, geom.dtype) for k, v in params.items()})


def dual_metrics(lbs: List[float], reference_lb: float) -> Dict[str, Any]:
    """Per-round relative dual gap against a reference bound
    (ref: DOGE/metrics/dual_metrics.py)."""
    gaps = [abs(reference_lb - lb) / max(abs(reference_lb), 1e-9) for lb in lbs]
    return {"lb_per_round": lbs, "rel_gap_per_round": gaps, "final_gap": gaps[-1],
            "best_gap": min(gaps)}
