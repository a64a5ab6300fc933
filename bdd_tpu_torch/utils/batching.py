"""Instance batching: concatenate several ILP instances into one solver.

The reference's DOGE batches multiple ILP instances by concatenating layer
ranges of several pickled CUDA solvers (bdd_cuda_torch.py:102-133). Here
batching is structural: variables of instance k are offset into a shared
index space and the BDD collections are appended — the uniform bucketed
layout then batches everything into the same tensors for free, and the delta
exchange never mixes instances (disjoint variables).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from bdd_tpu_torch.bdd.collection import BddCollection
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor


class BatchedInstances:
    def __init__(self, ilps: Sequence[object], pres=None) -> None:
        """``pres``: optional prebuilt BddPreprocessor per ILP (otherwise
        built here)."""
        self.pres: List[BddPreprocessor] = []
        self.var_offsets: List[int] = []
        self.bdd_offsets: List[int] = []
        self.collection = BddCollection()
        objective: List[float] = []
        var_off = 0
        for idx, ilp in enumerate(ilps):
            pre = pres[idx] if pres is not None else BddPreprocessor(ilp)
            self.pres.append(pre)
            self.var_offsets.append(var_off)
            self.bdd_offsets.append(self.collection.nr_bdds())
            self.collection.append_collection(pre.collection, var_offset=var_off)
            objective.extend(pre.objective_vector())
            var_off += pre.total_nr_variables()
        self.nr_vars = var_off
        self.objective = np.asarray(objective)

    def slice_solution(self, x: np.ndarray, k: int) -> np.ndarray:
        start = self.var_offsets[k]
        end = (
            self.var_offsets[k + 1]
            if k + 1 < len(self.var_offsets)
            else self.nr_vars
        )
        return x[start:end]
