"""One rank of the sharded solve's CPU tests (tests/test_torch_sharded.py and
tests/test_torch_multihost.py start D of these as gloo processes).

Usage: python -m tests.torch_sharded_ranks RANK D PORT SCENARIO [CHECKPOINT_DIR]

Runs the scenario's solves through bdd_tpu_torch only, on the CPU with one
torch thread, and prints one line ``RESULT <json>`` for the test process to
hold against the JAX package and the one-device port. Floats go as
``float.hex`` strings (every bit). Exits non-zero on any failure, and if any
module of JAX or of the JAX package was imported.
"""
import json
import os
import sys

import numpy as np
import torch

from tests import fixtures

# the instances the ranks solve: name -> (LP text builder, iterations)
INSTANCES = {
    "chain": (lambda: fixtures.SHORT_MRF_CHAIN, 12),
    "matching": (lambda: fixtures.MATCHING_3x3, 12),
    "covering": (lambda: fixtures.COVERING, 10),
    "grid": (lambda: _grid(3, 3, 2, 4), 40),
}


def _grid(n, m, k, seed):
    from bdd_tpu_torch.utils.problems import grid_mrf

    ilp = grid_mrf(n, m, k, seed=seed)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp.write_lp()


def preprocess(lp: str):
    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
    from bdd_tpu_torch.ilp import parse_lp_string

    return BddPreprocessor(parse_lp_string(lp))


def sharded(pre, dtype=torch.float64, **kw):
    from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver

    return ShardedUniformSolver(pre.collection, pre.total_nr_variables(),
                                pre.objective_vector(), nr_primal_vars=pre.nr_primal_variables,
                                dtype=dtype, device="cpu", **kw)


def solve(config: dict, lp: str) -> dict:
    from bdd_tpu_torch.api import BddSolver

    cfg = {"precision": "double", "use native preprocessing": False, **config}
    return BddSolver(cfg, device="cpu").read_ilp(lp_string=lp).solve(verbose=False)


def hexed(x) -> str:
    return float(x).hex()


def scenario_solve(out: dict) -> None:
    """Bounds after N iterations, split against global, the outer loops and
    rounding through the api, unknown partitions, one DOGE step."""
    for name, (lp, n) in INSTANCES.items():
        s = sharded(preprocess(lp()))
        s.iteration_block(n)
        out[f"lb {name}"] = hexed(s.lower_bound())
    pre = preprocess(_grid(8, 8, 3, 3))
    for family in ("split", "global"):
        s = sharded(pre, plan_family=family)
        s.comm.calls = s.comm.bytes = 0
        s.iteration_block(10)
        out[f"{family} calls"], out[f"{family} bytes"] = s.comm.calls, s.comm.bytes
        out[f"lb {family}"] = hexed(s.lower_bound())
    stop = {"minimum improvement": 0.0, "improvement slope": 0.0}
    grid9 = _grid(3, 3, 2, 9)
    for name in ("lbfgs sharded mma", "sharded mma"):
        res = solve({"relaxation solver": name, "perturbation rounding": False,
                     "termination criteria": {"maximum iterations": 30, **stop}}, grid9)
        out[f"lb {name}"] = hexed(res["lower_bound"])
        out[f"iterations {name}"] = res["iterations"]
    res = solve({"relaxation solver": "subgradient sharded mma", "perturbation rounding": False,
                 "termination criteria": {"maximum iterations": 80}}, fixtures.MATCHING_3x3)
    out["lb subgradient"] = hexed(res["lower_bound"])
    res = solve({"relaxation solver": "sharded mma",
                 "termination criteria": {"maximum iterations": 150}}, fixtures.MATCHING_3x3)
    out["rounding"] = {"lb": hexed(res["lower_bound"]), "objective": res.get("objective"),
                       "solution": res.get("solution")}
    scenario_learned(out)
    for kw in ({"partition": "bogus"}, {"plan_family": "bogus"}):
        try:
            sharded(preprocess(fixtures.MATCHING_3x3), **kw)
            out[f"bogus {list(kw)[0]}"] = "accepted"
        except ValueError as exc:
            out[f"bogus {list(kw)[0]}"] = str(exc)
    scenario_doge(out)


def scenario_learned(out: dict) -> None:
    """Learned iterations over the ranks (tests/test_uniform_sharded.py's
    test_sharded_learned_iterations_parity_and_grad): isotropic alpha, omega
    from a per-variable vector; the bound after 6 iterations and its gradient
    in that vector. Each rank backpropagates its own BDDs' share; the sum of
    the ranks' gradients is the whole bound's."""
    from bdd_tpu_torch.solver import learned as ln
    from bdd_tpu_torch.solver import uniform as uf

    pre = preprocess(_grid(3, 3, 2, 7))
    s = sharded(pre)
    rng = np.random.RandomState(0)
    ov = torch.tensor(0.2 + 0.6 * rng.rand(pre.total_nr_variables() + 1), requires_grad=True)
    st = ln.learned_iterations(s.geom, s.state, s.isotropic_alphas(), s.omega_from_per_var(ov),
                               6, delta_reduce=s.delta_reduce)
    st = uf.distribute_delta(s.geom, st, delta_reduce=s.delta_reduce)
    ln.per_bdd_lower_bound(s.geom, st).sum().backward()
    out["learned lb"] = hexed(s._bound(st))
    out["learned grad"] = [hexed(x) for x in s.sum_reduce(ov.grad).tolist()]
    with torch.no_grad():
        s.learned_iteration_block(s.isotropic_alphas(), s.omega_from_per_var(ov), 6)
    out["learned block lb"] = hexed(s.lower_bound())


def scenario_doge(out: dict) -> None:
    """One sharded DOGE training step against the one-process trainer on the
    same instance (float64): loss, gradients, and the parameters after the
    step on every rank."""
    from bdd_tpu_torch.learn.sharded import ShardedDogeTrainer
    from bdd_tpu_torch.learn.train import DogeTrainer, Instance, TrainConfig
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.utils.problems import independent_set

    ilp = independent_set(25, edge_prob=0.15, seed=6)
    ilp.normalize()
    pre = preprocess(ilp.write_lp())
    cfg = TrainConfig(dim=8, nr_rounds=2, iters_per_round=3, grad_rounds=1, free_update=True,
                      prev_lb_features=False)
    tr = ShardedDogeTrainer(sharded(pre), pre.objective_vector(), cfg)
    tr.init()
    tr.opt.zero_grad()
    loss = tr.loss_and_grads()
    host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                  pre.nr_primal_variables, dtype=torch.float64, device="cpu")
    inst = Instance(host, pre.objective_vector())
    one = DogeTrainer(cfg)
    one.init(inst)
    one.opt.zero_grad()
    want, _ = one.loss_and_grads(inst)
    out["doge loss"], out["doge loss one process"] = hexed(loss), hexed(want)
    out["doge grad diff"] = max(float((p.grad - q.grad).abs().max()) for p, q in
                                zip(tr.model.parameters(), one.model.parameters()))
    out["doge grad max"] = max(float(q.grad.abs().max()) for q in one.model.parameters())
    tr.opt.step()
    flat = torch.cat([p.detach().reshape(-1) for p in tr.model.parameters()])
    every = tr.solver.comm.all_gather(flat)
    out["doge params spread"] = float((every - every[0]).abs().max())
    out["doge rounds"] = [hexed(x) for x in tr.run_learned_rounds(2)]


# the dense sharded solve's instances: name -> LP text builder (15 iterations)
DENSE_INSTANCES = {
    "chain": lambda: fixtures.SHORT_MRF_CHAIN,
    "matching": lambda: fixtures.MATCHING_3x3,
    "covering": lambda: fixtures.COVERING,
    "two_simplex": lambda: fixtures.TWO_SIMPLEX,
    "grid": lambda: _grid(3, 3, 2, 4),
}
DENSE_ITERS = 15


def scenario_dense(out: dict) -> None:
    """The dense sharded solve (``sharding.ShardedSolver``): the bound after
    DENSE_ITERS iterations in float64 per instance, the collectives it took,
    this rank's shard (its BDDs, whether it holds only the placeholder),
    and a float32 bound."""
    from bdd_tpu_torch.solver.sharding import ShardedSolver

    for name, lp in DENSE_INSTANCES.items():
        pre = preprocess(lp())
        for dtype in (torch.float64, torch.float32):
            s = ShardedSolver(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                              nr_primal_vars=pre.nr_primal_variables, dtype=dtype, device="cpu")
            s.comm.calls = 0
            s.iteration_block(DENSE_ITERS)
            key = "" if dtype == torch.float64 else " f32"
            out[f"dense lb {name}{key}"] = hexed(s.lower_bound())
            out[f"dense calls {name}{key}"] = s.comm.calls
        out[f"dense bdds {name}"] = list(s.sharded.parts[s.comm.rank])


def scenario_checkpoint(out: dict, ckpt_dir: str, phase: str) -> None:
    """Kill and resume: 'start' runs 8 iterations and writes the checkpoint
    (and runs 16 uninterrupted on a second solver), 'resume' is a fresh set
    of processes that loads it and runs 8 more. Both phases also load the
    JAX package's checkpoint (written by the test beforehand) and write the
    port's for the JAX package to load."""
    from bdd_tpu_torch.utils import multihost as mh

    pre = preprocess(_grid(4, 4, 3, 0))
    s = sharded(pre)
    path = os.path.join(ckpt_dir, "port.ckpt")
    if phase == "start":
        s.iteration_block(8)
        out["lb start"] = hexed(s.lower_bound_with_deferred())
        mh.save_sharded(s, path)
        u = sharded(pre)
        u.iteration_block(16)
        out["lb uninterrupted"] = hexed(u.lower_bound_with_deferred())
        j = sharded(pre)
        mh.load_sharded(j, os.path.join(ckpt_dir, "jax.ckpt"))
        out["lb jax checkpoint"] = hexed(j.lower_bound_with_deferred())
        try:
            mh.load_sharded(sharded(preprocess(_grid(3, 3, 3, 0))), path)
            out["other instance"] = "loaded"
        except ValueError as exc:
            out["other instance"] = str(exc)
    else:
        mh.load_sharded(s, path)
        out["lb loaded"] = hexed(s.lower_bound_with_deferred())
        s.iteration_block(8)
        out["lb resumed"] = hexed(s.lower_bound_with_deferred())


def start(D: int, scenario: str, ckpt_dir: str = "") -> list:
    """Start D ranks of ``scenario`` on a free local port; ``wait`` collects
    them."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_sharded_ranks", str(r), str(D), str(port), scenario,
         ckpt_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root)
        for r in range(D)]


def wait(procs: list, timeout: float = 240.0) -> list:
    """The RESULT dicts of the ranks ``start`` started, by rank; a rank that
    fails fails the test, and one that hangs is killed at ``timeout``."""
    import subprocess

    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"a rank hung for {timeout} s") from None
            assert p.returncode == 0, f"rank failed ({p.returncode}):\n{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = [json.loads(line[len("RESULT "):]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    assert [r["rank"] for r in results] == list(range(len(procs))), outs
    return results


def main() -> None:
    rank, D, port, scenario = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from bdd_tpu_torch.utils import multihost as mh

    mh.initialize(f"localhost:{port}", D, rank, platform="cpu", timeout_s=300)
    out = {"rank": rank, "size": mh.process_count()}
    if scenario == "solve":
        scenario_solve(out)
    elif scenario == "dense":
        scenario_dense(out)
    else:
        scenario_checkpoint(out, sys.argv[5], scenario)
    mh.shutdown()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bdd_tpu"))
    if foreign:
        raise SystemExit(f"a rank imported JAX or the JAX package: {foreign[:5]}")
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
