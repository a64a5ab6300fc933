"""``bdd_tpu_torch/utils/multihost.py``: the process group and the sharded
checkpoints, against ``bdd_tpu.utils.multihost``.

As tests/test_multihost.py does for the JAX package, two gloo ranks
(``tests/torch_sharded_ranks.py``) solve 8 iterations, write a checkpoint
and exit (the "kill"); two fresh ranks load it and solve 8 more, which must
equal 16 uninterrupted iterations (abs 1e-9 in float64, as there). A file
written by the JAX package's ``save_sharded`` over 2 virtual CPU devices
loads in the port's ranks, and the ranks' file loads in the JAX package.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import Mesh

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as jparse
from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver as JaxSharded
from bdd_tpu.utils import multihost as jmh
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver
from bdd_tpu_torch.utils import multihost as mh
from tests import fixtures
from tests import torch_sharded_ranks as ranks


def test_initialize_refuses_what_it_cannot_do():
    with pytest.raises(ValueError, match="platform"):
        mh.initialize(platform="tpu")
    with pytest.raises(ValueError, match="num_processes"):
        mh.initialize("localhost:1234", platform="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mh.initialize(platform="cuda")


def test_process_index_and_count_without_a_group():
    assert mh.process_index() == 0 and mh.process_count() == 1
    mh.shutdown()  # a no-op without a group


def port_solver(lp, dtype=torch.float64):
    pre = BddPreprocessor(parse_lp_string(lp))
    return ShardedUniformSolver(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                                nr_primal_vars=pre.nr_primal_variables, dtype=dtype,
                                device="cpu")


def jax_solver(lp, D):
    pre = JaxPreprocessor(jparse(lp))
    return JaxSharded(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                      mesh=Mesh(np.array(jax.devices()[:D]), ("b",)),
                      nr_primal_vars=pre.nr_primal_variables, dtype=jnp.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_save_load_single_process_roundtrip(tmp_path, dtype):
    """One rank (no group): a loaded state continues bit for bit; the file is
    the JAX package's format, each leaf stacked over the one shard."""
    lp = ranks._grid(3, 3, 2, 1)
    s = port_solver(lp, dtype)
    s.iteration_block(5)
    path = str(tmp_path / "ck.pkl")
    mh.save_sharded(s, path)
    lb5 = s.lower_bound_with_deferred()
    s.iteration_block(5)
    lb10 = s.lower_bound_with_deferred()
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    assert blob["kind"] == "ShardedUniformSolver"
    assert [a.shape for a in blob["state"]] == [
        (1, *t.shape) for t in (*s.state.lo, *s.state.hi, *s.state.def_mm, *s.state.cft)]
    r = port_solver(lp, dtype)
    mh.load_sharded(r, path)
    assert r.lower_bound_with_deferred() == lb5
    r.iteration_block(5)
    assert r.lower_bound_with_deferred() == lb10
    with pytest.raises(ValueError, match="does not match"):
        mh.load_sharded(port_solver(ranks._grid(3, 4, 2, 1), dtype), path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The JAX package's checkpoint after 8 iterations on 2 devices, then the
    ranks' start phase (8 iterations, save, exit) and resume phase."""
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    lp = ranks._grid(4, 4, 3, 0)
    js = jax_solver(lp, 2)
    js.iteration_block(8)
    jmh.save_sharded(js, os.path.join(ckpt_dir, "jax.ckpt"))
    lb_jax = js.lower_bound_with_deferred()
    start = ranks.wait(ranks.start(2, "start", ckpt_dir))
    resume = ranks.wait(ranks.start(2, "resume", ckpt_dir))
    return {"dir": ckpt_dir, "lp": lp, "lb jax": lb_jax, "start": start, "resume": resume}


def hexed(res, key):
    return float.fromhex(res[key])


def test_two_process_restart_from_checkpoint(checkpoints):
    start, resume = checkpoints["start"], checkpoints["resume"]
    for phase in (start, resume):
        assert [r["size"] for r in phase] == [2, 2]
        assert all({k: v for k, v in r.items() if k != "rank"}
                   == {k: v for k, v in phase[0].items() if k != "rank"} for r in phase)
    s, r = start[0], resume[0]
    assert hexed(r, "lb loaded") == hexed(s, "lb start")
    assert hexed(r, "lb resumed") == pytest.approx(hexed(s, "lb uninterrupted"), abs=1e-9)
    assert "does not match" in s["other instance"]


def test_checkpoints_cross_between_the_packages(checkpoints):
    """JAX's file in the port's ranks, and the ranks' file in JAX: the same
    bound after 8 iterations as the writer's (abs 1e-9, float64)."""
    s = checkpoints["start"][0]
    assert hexed(s, "lb jax checkpoint") == pytest.approx(checkpoints["lb jax"], abs=1e-9)
    assert hexed(s, "lb start") == pytest.approx(checkpoints["lb jax"], abs=1e-9)
    js = jax_solver(checkpoints["lp"], 2)
    jmh.load_sharded(js, os.path.join(checkpoints["dir"], "port.ckpt"))
    assert js.lower_bound_with_deferred() == pytest.approx(hexed(s, "lb start"), abs=1e-9)
    with open(os.path.join(checkpoints["dir"], "port.ckpt"), "rb") as fh:
        ours = pickle.load(fh)
    with open(os.path.join(checkpoints["dir"], "jax.ckpt"), "rb") as fh:
        theirs = pickle.load(fh)
    assert [np.shape(a) for a in ours["state"]] == [np.shape(a) for a in theirs["state"]]


def test_cli_joins_the_launchers_group(tmp_path):
    """``python -m bdd_tpu_torch.api cfg.json`` under a launcher's env://
    variables (as torchrun sets them) joins its gloo group: both ranks
    solve, rank 0 alone prints the result."""
    (tmp_path / "inst.lp").write_text(fixtures.MATCHING_3x3)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"input": str(tmp_path / "inst.lp"), "precision": "double",
                               "relaxation solver": "sharded mma"}))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bdd_tpu_torch.api", str(cfg), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1"))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
            assert p.returncode == 0, outs[-1][1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    printed = ['"lower_bound"' in out + err for out, err in outs]
    assert printed == [True, False]
