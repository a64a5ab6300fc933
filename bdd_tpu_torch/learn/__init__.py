"""The learned solver (DOGE): solver-state features, the GNN, training and
inference, and checkpoints in the JAX package's format (port of
bdd_tpu/learn/, without its multi-device trainer ``sharded.py``)."""
from bdd_tpu_torch.learn.model import DogePredictor
from bdd_tpu_torch.learn.train import DogeTrainer, TrainConfig

__all__ = ["DogePredictor", "DogeTrainer", "TrainConfig"]
from bdd_tpu_torch.learn.configs import config_ct, config_gm, config_mis, config_qaplib
