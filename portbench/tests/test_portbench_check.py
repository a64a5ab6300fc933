"""The check that decides ``correct``: sound runs pass it, and its control and
the faults a cell can have fail it. The harness runs on the CPU here (the
program's plain sweeps), at small sizes of each cell's family, with each cell's
own limits."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, spec

SMALL = {
    "mknap.t50.dual": {"rows": 2, "items": 12},
    "mknap.t25.dual": {"rows": 2, "items": 12},
}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_every_cell_has_a_small_size():
    assert sorted(SMALL) == sorted(CELLS)


def run(cell, seed, fault=None):
    return harness.run(cell, seed, 0.0, False, time.monotonic(), device="cpu",
                       instance=SMALL[cell], fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run(cell, 2**31 + 3)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    bench = spec.benchmark()
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics_of(bench, cell, "end_to_end")}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(cell, seed):
    """The reference in bfloat16, the precision below float32, in the program's place."""
    c = harness.Cell(cell, seed, "cpu", SMALL[cell])
    layout = c.layout()
    ref = c.reference()
    ctl = harness.reference_outputs(c.reference(torch.bfloat16), layout)
    gaps = harness.compare(ctl, ref, layout)
    assert any(gaps[k] > v for k, v in c.workload["check"].items()), gaps


def unchanged(cell):
    cell.api.solver.iteration_block = lambda n: None


def half_left_out(cell):
    """The slots of every other BDD keep their costs: half of the BDDs are not swept."""
    s = cell.api.solver
    real = s.iteration_block
    bdd = torch.as_tensor(np.concatenate([np.asarray(b).ravel() for b in cell.host.layer_bdd]))
    left = (bdd % 2 == 1) & (bdd >= 0)

    def block(n):
        before = [x.clone() for x in s.state.flat[:3]]
        real(n)
        for new, old in zip(s.state.flat[:3], before):
            new[left] = old[left]

    s.iteration_block = block


def altered(cell):
    """One cost of the answer altered where the sweep produces it, by a tenth of
    the largest cost."""
    s = cell.api.solver
    real = s.iteration_block
    valid = cell.host.geom.exchange.valid
    first = int(np.nonzero(valid.cpu().numpy())[0][0])

    def block(n):
        real(n)
        hi = s.state.flat[1]
        hi[first] += 0.1 * float(hi[valid].abs().max())

    s.iteration_block = block


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(cell, fault):
    r = run(cell, 11, fault)
    assert not r["correct"], r["checks"]
