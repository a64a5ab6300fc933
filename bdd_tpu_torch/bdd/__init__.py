from bdd_tpu_torch.bdd.collection import BddCollection, TOP, BOT
from bdd_tpu_torch.bdd.lineq import bdd_from_inequality
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor

__all__ = ["BddCollection", "TOP", "BOT", "bdd_from_inequality", "BddPreprocessor"]
