"""The learned solver's disk dataset (``bdd_tpu_torch/learn/data.py``): the
behaviour tests of ``tests/test_data_pipeline.py`` on the port, on the CPU,
and the converged duals and ground truth against the JAX package's (both
packages run copies of the same native solver; the port's copy sums its bound
in a fixed order, the JAX package's in an order that changes between runs)."""
import os

import numpy as np
import pytest
import torch

from bdd_tpu.bdd.preprocessor import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.learn import data as jdata
from bdd_tpu_torch import native
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.learn import data
from bdd_tpu_torch.learn.train import DogeTrainer, TrainConfig
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils.problems import grid_mrf, set_cover


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers; see tests/test_torch_sweep.py), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_instances(root):
    os.makedirs(root, exist_ok=True)
    paths = []
    ilps = [grid_mrf(3, 3, 2, seed=s) for s in (0, 1)] + [set_cover(12, 30, density=0.2, seed=3)]
    for i, ilp in enumerate(ilps):
        p = os.path.join(root, f"inst_{i}.lp")
        with open(p, "w") as fh:
            fh.write(ilp.write_lp())
        paths.append(p)
    return paths


def dataset(root, **kw):
    return data.IlpDiskDataset(root, verbose=False, device="cpu", **kw)


def fresh_bound(path):
    ilp = data.read_any_ilp(path)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                  pre.nr_primal_variables, device="cpu")
    return UniformSolver(host, pre.objective_vector())


def test_dataset_scan_cache_and_reload(tmp_path):
    root = str(tmp_path / "instances")
    write_instances(root)
    with open(os.path.join(root, "bad_too_easy.lp"), "w") as fh:
        fh.write("Minimize\nx\nSubject To\nc: x >= 1\nEnd\n")
    with open(os.path.join(root, "notes.txt"), "w") as fh:
        fh.write("not an instance")
    ds = dataset(root)
    assert len(ds) == 3
    assert all(os.path.exists(e["bdd_repr_path"]) and os.path.exists(e["sol_path"])
               for e in ds.file_list)
    sizes = [e["lp_size"] for e in ds.file_list]
    assert sizes == sorted(sizes)
    inst, gt_info, path = ds.get(0)
    assert gt_info["lp_stats"]["obj"] is None
    got = float(uf.lower_bound_with_deferred(inst.host.geom, inst.state0))
    assert got == pytest.approx(fresh_bound(path).lower_bound_with_deferred(), abs=1e-5)
    assert inst.spec.coeff is not None and inst.spec.E == inst.host.geom.plan.E
    mtimes = {e["bdd_repr_path"]: os.path.getmtime(e["bdd_repr_path"]) for e in ds.file_list}
    ds2 = dataset(root, load_in_memory=True)
    assert len(ds2) == 3 and all(os.path.getmtime(p) == t for p, t in mtimes.items())
    inst2, _, _ = ds2.get(1)
    assert inst2.spec.nr_vars == ds.get(1)[0].spec.nr_vars
    # the cached layout is the layout the instance had when it was built
    a, b = inst2.host.geom, ds[1][0].host.geom
    assert torch.equal(a.arcs, b.arcs) and torch.equal(a.alpha, b.alpha)
    assert torch.equal(ds[1][0].spec.coeff, inst2.spec.coeff)


def test_host_arrays_round_trip():
    ilp = grid_mrf(3, 4, 3, seed=2)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                  pre.nr_primal_variables, device="cpu")
    back = layout.host_from_arrays(layout.host_to_arrays(host), host.geom.dtype, "cpu")
    assert torch.equal(back.geom.arcs, host.geom.arcs)
    assert torch.equal(back.geom.alpha, host.geom.alpha)
    assert [g.packed for g in back.geom.buckets] == [g.packed for g in host.geom.buckets]
    for x, y in zip(back.layer_bdd, host.layer_bdd):
        np.testing.assert_array_equal(x, y)


def test_converged_duals_equal_the_jax_packages_and_transfer_exactly():
    """The converged per-layer duals equal the JAX package's (the same native
    solver), and the uniform state built from them reproduces the native
    bound in float64."""
    lp = grid_mrf(4, 4, 2, seed=5).write_lp()
    ilp, jilp = parse_lp_string(lp), j_parse_lp_string(lp)
    ilp.normalize()
    jilp.normalize()
    pre = BddPreprocessor(ilp)
    costs = data.converged_layer_costs(pre, improvement=1e-12, max_iterations=3000)
    assert costs == jdata.converged_layer_costs(JaxPreprocessor(jilp), improvement=1e-12,
                                                max_iterations=3000)
    cs = native.cpu_solver_from_collection(pre.collection, pre.total_nr_variables(),
                                           pre.objective_vector())
    cs.iterations(3000, 0.5)
    host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                  pre.nr_primal_variables, dtype=torch.float64, device="cpu")
    st = uf.init_uniform_state_from_layer_costs(host, costs)
    got = float(uf.lower_bound_with_deferred(host.geom, st))
    assert got == pytest.approx(cs.lower_bound_with_deferred(), abs=1e-9)


def test_dataset_read_dual_converged_and_trainer(tmp_path):
    root = str(tmp_path / "instances")
    write_instances(root)
    ds = dataset(root, read_dual_converged=True)
    inst, _, path = ds.get(0)
    cold = fresh_bound(path)
    warm_lb = float(uf.lower_bound_with_deferred(inst.host.geom, inst.state0))
    assert warm_lb > cold.lower_bound_with_deferred() - 1e-6
    cold.iteration_block(500)
    assert warm_lb >= cold.lower_bound_with_deferred() - 1e-3
    t = DogeTrainer(TrainConfig(nr_rounds=2, iters_per_round=3, dim=8, epochs=1))
    t.init(inst)
    lbs = t.run_learned_rounds(inst, nr_rounds=2)
    assert len(lbs) == 2 and all(np.isfinite(lbs))


def test_generate_gt_schema_bounds_and_the_jax_packages_bound(tmp_path):
    paths = write_instances(str(tmp_path / "instances"))
    lp_stats, ilp_stats = data.generate_gt(paths[0], need_ilp_gt=True, max_dual_iterations=2000,
                                           device="cpu")
    assert set(lp_stats) >= {"time", "obj", "sol_dict"} and np.isfinite(lp_stats["obj"])
    want, _ = jdata.generate_gt(paths[0], need_ilp_gt=False, max_dual_iterations=2000)
    # native/bdd_host.cpp reduces the same sum in an order that changes
    # between runs (an OpenMP reduction, partial sums combined as the threads
    # arrive): its bound moves in the last bit (-3.2822916238875206 against
    # -3.282291623887521, one ulp). The port's order is fixed: the test
    # below holds it to one bit pattern.
    assert lp_stats["obj"] == pytest.approx(want["obj"], rel=1e-12)
    if ilp_stats is not None:  # rounding may fail on tiny instances
        assert ilp_stats["obj"] >= lp_stats["obj"] - 1e-6
        assert isinstance(ilp_stats["sol_dict"], dict)


def test_generate_gt_and_the_native_bound_are_deterministic(tmp_path):
    """The port's native bound sums the BDDs' root costs in BDD order: three
    ground truths of one instance, and twenty reads of one solver state's
    bounds, each give one bit pattern."""
    paths = write_instances(str(tmp_path / "instances"))
    objs = {data.generate_gt(paths[0], need_ilp_gt=False, max_dual_iterations=2000,
                             device="cpu")[0]["obj"].hex() for _ in range(3)}
    assert len(objs) == 1
    ilp = grid_mrf(8, 8, 3, seed=4)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    cs = native.cpu_solver_from_collection(pre.collection, pre.total_nr_variables(),
                                           pre.objective_vector())
    cs.iterations(50, 0.5)
    assert len({cs.lower_bound_with_deferred().hex() for _ in range(20)}) == 1
    assert len({cs.lower_bound().hex() for _ in range(20)}) == 1


def test_dataset_files_to_load_and_error_rename(tmp_path):
    root = str(tmp_path / "instances")
    names = [os.path.basename(p) for p in write_instances(root)]
    assert len(dataset(root, files_to_load=names[:1])) == 1
    with open(os.path.join(root, "broken.lp"), "w") as fh:
        fh.write("this is not an lp file at all {{{")
    assert len(dataset(root)) == 3
    assert os.path.exists(os.path.join(root, "broken_error_bdd.lp"))
    dataset(root)  # retried under its clean name, renamed again
    assert os.path.exists(os.path.join(root, "broken_error_bdd.lp"))


def test_cli_prepares_a_directory(tmp_path, capsys):
    root = str(tmp_path / "instances")
    write_instances(root)
    assert data.main([root, "--device", "cpu"]) == 0
    assert "3 instances prepared" in capsys.readouterr().out
