"""bdd_tpu_torch — the PyTorch and CUDA port of bdd_tpu.

The JAX package ``bdd_tpu`` stays the reference; this package mirrors its
module names so every port module has an obvious counterpart:

  bdd_tpu_torch.solver.layout          — byte geometry, flat buffers, launch plan, host
                                          builders (bdd_tpu.solver.uniform,
                                          native.make_uniform_host)
  bdd_tpu_torch.solver.uniform         — sweep twins, delta exchange, iteration
  bdd_tpu_torch.solver.sweep_kernels   — CUDA sweep kernel wrappers
                                          (bdd_tpu.solver.pallas_uniform)
  bdd_tpu_torch.solver.uniform_wrapper — UniformSolver duck interface
  bdd_tpu_torch.solver.rounding_device — on-device incremental rounding
  bdd_tpu_torch.api                    — BddSolver for the native main path + CLI
  bdd_tpu_torch.solver.dense           — the dense hop-scan backend
                                          (bdd_tpu.solver.jax_solver)
  bdd_tpu_torch.solver.dense_wrapper   — DenseSolver duck interface
                                          (bdd_tpu.solver.wrapper, JaxSolver)
  bdd_tpu_torch.solver.prefix          — log-depth (min,+) prefix sweeps
                                          (bdd_tpu.solver.prefix)
  bdd_tpu_torch.solver.sharding        — partitions and the dense sharded solve
                                          on torch.distributed
                                          (bdd_tpu.solver.sharding)
  bdd_tpu_torch.solver.learned         — learned MMA iterations and their gradients
  bdd_tpu_torch.learn                  — the learned solver (DOGE): features, GNN,
                                          training, dataset, checkpoints

The port stands alone: it imports neither JAX nor any module of ``bdd_tpu``.
What it needs of the JAX-free modules there it keeps as copies of its own,
under the same relative names: ``native`` with ``csrc/bdd_host.cpp`` (the C++
host library), ``solver.run``, ``solver.rounding``, ``utils.logging``,
``utils.problems``, ``ilp`` (model and LP parser) and
``frontends.graph_matching``. Only the tests import both packages.
"""

__version__ = "0.2.0"
