"""Per-dataset DOGE training presets (ref: DOGE/configs/config_{ct,gm,mis,
qaplib}.py over defaults.py). The reference's knobs map as:

  TRAIN.NUM_ROUNDS            -> nr_rounds
  TRAIN.NUM_DUAL_ITERATIONS   -> iters_per_round
  TRAIN.NUM_ROUNDS_WITH_GRAD  -> grad_rounds
  MODEL.FREE_UPDATE           -> free_update (all reference datasets use True)
  MODEL.USE_LSTM_VAR          -> use_lstm_var
  TRAIN.BATCH_SIZE            -> batch instances with ``Instance.from_ilps``

Reference round counts are for full-scale training runs; scale ``nr_rounds``
down for quick experiments.
"""
from __future__ import annotations

from bdd_tpu_torch.learn.train import TrainConfig


def config_mis(**overrides) -> TrainConfig:
    """Maximum independent set (ref config_mis.py: 20 rounds x 20 iters,
    batch 8, free update on)."""
    base = dict(nr_rounds=20, iters_per_round=20, grad_rounds=1,
                free_update=True, layer_norm=True, history_features=True,
                smooth_temps=(0.1, 1.0, 10.0, 100.0, 1000.0))
    base.update(overrides)
    return TrainConfig(**base)


def config_gm(**overrides) -> TrainConfig:
    """Graph matching (ref config_gm.py: 20 rounds x 20 iters, batch 2)."""
    base = dict(nr_rounds=20, iters_per_round=20, grad_rounds=1,
                free_update=True, layer_norm=True, history_features=True,
                smooth_temps=(0.1, 1.0, 10.0, 100.0))
    base.update(overrides)
    return TrainConfig(**base)


def config_qaplib(**overrides) -> TrainConfig:
    """QAPLib (ref config_qaplib.py: 500 rounds x 5 iters, batch 4)."""
    base = dict(nr_rounds=500, iters_per_round=5, grad_rounds=1,
                free_update=True, layer_norm=True, history_features=True,
                smooth_temps=(0.1, 1.0, 10.0, 100.0))
    base.update(overrides)
    return TrainConfig(**base)


def config_ct(**overrides) -> TrainConfig:
    """Cell tracking (ref config_ct.py: 400 rounds x 1 iter, free-update-only
    model — no dist-weight/omega prediction in the reference; here the heads
    coexist, the free update dominating at 1 iteration/round)."""
    base = dict(nr_rounds=400, iters_per_round=1, grad_rounds=1,
                free_update=True, layer_norm=True,
                smooth_temps=(1.0, 10.0, 100.0, 1000.0))
    base.update(overrides)
    return TrainConfig(**base)
