"""The generalized assignment configuration (``gap_d60900``): the benchmark
validates with its cell, the reference and the program's CPU float64 path
agree on a small draw of the class, the cell's check passes a sound run and
fails the control and the faults of ``test_portbench_check.py`` at that
size, and ``huge_barrier_wait_pct`` reads the program's counter of the
shared-memory huge body."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, reference, spec
from portbench.generators import yagiura_gap
from portbench.tests.test_portbench_check import altered, half_left_out, unchanged
from portbench.tests.test_portbench_reference import program_solve

CELL = "gap_d60900.dual"
SMALL = {"agents": 4, "jobs": 30}
HUGE_WAIT = spec.metric_reader("huge_barrier_wait_pct")


def test_the_benchmark_validates_with_the_gap_cell():
    bench = spec.benchmark()
    spec.validate(bench)
    assert spec.cell(bench, "gap_d60900.dual")["config"] == "gap_d60900"
    per_layer = {m["name"] for m in spec.metrics_of(bench, "gap_d60900.dual", "per_layer")}
    assert "huge_barrier_wait_pct" in per_layer and "l2_barrier_wait_pct" not in per_layer
    assert "huge_barrier_wait_pct" not in {
        m["name"] for w in ("mknap.t50.dual", "mknap.t25.dual")
        for m in spec.metrics_of(bench, w, "per_layer")}


@pytest.mark.parametrize("iterations", [0, 1, 20])
def test_solve_is_the_programs_in_float64(iterations):
    m = yagiura_gap.make(SMALL, 5)
    L = reference.build_layout(m, "input")
    assert L.nr_bdds == SMALL["agents"] + SMALL["jobs"]
    nh, host, sol = program_solve(m, "input", torch.float64, iterations)
    cell = type("C", (), {})()
    cell.api = type("A", (), {"solver": sol})()
    cell.host, cell.native, cell.model = host, nh, m
    out = harness.Cell.outputs(cell, sol.lower_bound())
    gaps = harness.compare(out, reference.solve(L, iterations), L)
    assert max(gaps.values()) < 1e-12


def test_huge_wait_reads_the_programs_counter(monkeypatch):
    from bdd_tpu_torch.solver import sweep_kernels as sk

    monkeypatch.setattr(sk, "HUGE_WAIT", {torch.device("cpu"): torch.tensor(
        [[100, 1000], [300, 1000], [50, 500]])})
    monkeypatch.setattr(sk, "L2_WAIT", {torch.device("cpu"): torch.tensor(
        [[900, 1000], [900, 1000], [0, 0]])})
    assert HUGE_WAIT({}) == pytest.approx(100.0 * 450 / 2500)


def test_huge_wait_without_a_counted_launch_reads_nothing(monkeypatch):
    from bdd_tpu_torch.solver import sweep_kernels as sk

    monkeypatch.setattr(sk, "HUGE_WAIT", {torch.device("cpu"): torch.zeros(3, 2, dtype=torch.int64)})
    assert HUGE_WAIT({}) is None
    monkeypatch.setattr(sk, "HUGE_WAIT", {})
    assert HUGE_WAIT({}) is None


def test_huge_wait_on_a_program_without_the_counter_reads_nothing(monkeypatch):
    from bdd_tpu_torch.solver import sweep_kernels as sk

    monkeypatch.delattr(sk, "huge_wait_cycles")
    assert HUGE_WAIT({}) is None


def test_model_costs_are_the_lp_texts():
    m = yagiura_gap.make(SMALL, 9)
    _, c, _ = yagiura_gap.draw(SMALL["agents"], SMALL["jobs"], 9)
    assert np.array_equal(m.costs(), c.ravel().astype(np.float64))


def run(seed, fault=None):
    return harness.run(CELL, seed, 0.0, False, time.monotonic(), device="cpu",
                       instance=SMALL, fault=fault)


def test_a_sound_run_is_correct():
    r = run(2**31 + 3)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"dual_it_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(seed):
    """The reference in bfloat16, the precision below float32, in the program's place."""
    c = harness.Cell(CELL, seed, "cpu", SMALL)
    layout = c.layout()
    ref = c.reference()
    ctl = harness.reference_outputs(c.reference(torch.bfloat16), layout)
    gaps = harness.compare(ctl, ref, layout)
    assert any(gaps[k] > v for k, v in c.workload["check"].items()), gaps


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(fault):
    r = run(11, fault)
    assert not r["correct"], r["checks"]
