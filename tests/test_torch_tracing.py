"""The port's spans and counters: ``utils.logging.span`` ranges at the layer
boundaries of the dual loop, ``bdd.sync`` around the host's reads of the
card's values, and the L2 sweep body's hop-barrier wait
(``sweep_kernels.L2_WAIT``).

This file imports no JAX and nothing of bdd_tpu. The CPU tests record under
a CPU ``torch.profiler``; the ``cuda`` tests skip without a card and run on
one with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdd_tpu_torch import api
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.learn import train as tr
from bdd_tpu_torch.native import NativeHost
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils import logging as tlogging
from tests import fixtures
from tests.test_torch_kernels import _Recorder, assert_same_bits, synthetic_host

ITERATIONS, BLOCK = 100, 25
SPAN_NAMES = ("bdd.solve_dual", "bdd.block", "bdd.exchange", "bdd.init", "bdd.bound", "bdd.sync")


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards (as in test_torch_kernels.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def knapsack_lp(seed: int = 0, rows: int = 2, items: int = 8) -> str:
    """A small multidimensional knapsack of the benchmark's kind: weights
    U{0..100}, capacity half of a row's sum, profits maximised."""
    rng = np.random.RandomState(seed)
    w = rng.randint(0, 101, size=(rows, items))
    profit = w.sum(axis=0) / rows + 50 * rng.rand(items)
    obj = " ".join(f"- {p:.3f} x{i}" for i, p in enumerate(profit))
    cons = [" + ".join(f"{w[r, i]} x{i}" for i in range(items)) + f" <= {w[r].sum() // 2}"
            for r in range(rows)]
    return ("Minimize\n" + obj + "\nSubject To\n" + "\n".join(cons) + "\nBinaries\n"
            + " ".join(f"x{i}" for i in range(items)) + "\nEnd")


class Cell:
    """The benchmark's solve on a small instance: a UniformSolver behind
    BddSolver.solve_dual, ITERATIONS iterations in blocks of BLOCK, no
    stopping rule; each solve starts from the initial dual state."""

    def __init__(self, device: str, dtype: str = "float") -> None:
        lp = knapsack_lp()
        config = {"precision": dtype, "termination criteria": {
            "maximum iterations": ITERATIONS, "minimum improvement": 0.0,
            "improvement slope": 0.0, "time limit": 1e9}}
        self.api = api.BddSolver(config, device=device).read_ilp(lp_string=lp)
        nh = NativeHost(lp, self.api.config["variable order"])
        self.host = layout.from_native_host(nh, dtype=self.api.dtype, device=self.api.device)
        self.objective = nh.objective()
        self.api.solver = UniformSolver(self.host, self.objective)
        assert self.api.solver.default_block_size == BLOCK

    def solve(self) -> float:
        self.api.solver.state = uf.init_uniform_state(self.host, self.objective)
        return self.api.solve_dual(verbose=False)


def host_ranges(prof):
    """(name, start ns, end ns) of the host events of a profile."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]


def inside(inner, outers) -> bool:
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def by_name(events, name):
    return [e for e in events if e[0] == name]


class _CountingRecordFunction:
    """Stands in for the profiler range that ``span`` enters and counts its
    entries."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tlogging._RANGE

        def counted(name, *args):
            self.calls += 1
            return real(name, *args)

        monkeypatch.setattr(tlogging, "_RANGE", counted)


# ------------------------------------------------------------------ spans
def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    rf = _CountingRecordFunction(monkeypatch)
    assert not torch._C._autograd._profiler_enabled()
    first, second = tlogging.span("bdd.block"), tlogging.span("bdd.sync")
    assert first is second is tlogging._NO_SPAN
    with first:
        with second:  # the shared context nests in itself
            pass
    assert rf.calls == 0


def test_span_under_a_profiler_is_a_record_function_range(monkeypatch):
    rf = _CountingRecordFunction(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlogging.span("bdd.test"):
            torch.ones(4).sum()
    assert rf.calls == 1
    (test_span,) = by_name(host_ranges(prof), "bdd.test")
    sums = by_name(host_ranges(prof), "aten::sum")
    assert sums and all(inside(s, [test_span]) for s in sums)


def test_solve_dual_records_the_dual_loops_spans():
    cell = Cell("cpu")
    cell.solve()  # warm
    solves = 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(solves):
            cell.solve()
    ev = host_ranges(prof)
    assert cell.api.dual_stats["iterations"] == ITERATIONS
    count = {name: len(by_name(ev, name)) for name in SPAN_NAMES}
    # checks after 25, 75 and 100 iterations (periods 1, 2, 4) and one before the loop
    assert count == {"bdd.solve_dual": solves, "bdd.block": solves * ITERATIONS // BLOCK,
                     "bdd.exchange": solves * 2 * ITERATIONS, "bdd.init": solves,
                     "bdd.bound": solves * 4, "bdd.sync": solves * 4}
    bounds, solve = by_name(ev, "bdd.bound"), by_name(ev, "bdd.solve_dual")
    assert all(inside(s, bounds) for s in by_name(ev, "bdd.sync"))
    assert all(inside(b, solve) for b in by_name(ev, "bdd.block") + bounds)
    assert all(inside(x, by_name(ev, "bdd.block")) for x in by_name(ev, "bdd.exchange"))
    assert not any(inside(i, solve) for i in by_name(ev, "bdd.init"))


def test_solve_dual_without_a_profiler_enters_no_range(monkeypatch):
    cell = Cell("cpu")
    rf = _CountingRecordFunction(monkeypatch)
    lb = cell.solve()
    assert rf.calls == 0 and np.isfinite(lb)


def test_device_trace_capture_names_the_spans(tmp_path):
    cell = Cell("cpu")
    with tlogging.device_trace(str(tmp_path), label="capture"):
        cell.solve()
    with open(tmp_path / "capture.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert set(SPAN_NAMES) <= names


def test_learned_round_spans_record_under_a_profiler_and_not_without(monkeypatch):
    inst = tr.Instance.from_ilp(parse_lp_string(fixtures.MATCHING_3x3), dtype=torch.float32,
                                device="cpu")
    trainer = tr.DogeTrainer(tr.TrainConfig(dim=8, nr_rounds=2, iters_per_round=2))
    trainer.init(inst)
    rf = _CountingRecordFunction(monkeypatch)
    plain = trainer.run_learned_rounds(inst)
    assert rf.calls == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = trainer.run_learned_rounds(inst)
    assert traced == plain
    ev = host_ranges(prof)
    # a round: features, GNN, iterations, the distribution; the rollout's bound
    assert [len(by_name(ev, name)) for name in tr.SPANS] == [2, 2, 2, 4]


# ------------------------------------------------ the L2 body's wait counter
def _l2_launcher(rec, monkeypatch, kernel, split=None):
    monkeypatch.setattr(sk._build, "load", lambda: rec)

    class _Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    host, (lo, hi, fr, dl, dh) = synthetic_host([(320000, 2, 2)], torch.float32, "cpu")
    geom = host.geom
    plan = layout.launch_plan(geom.plan.shapes, torch.float32, "cpu", l2_split=split)
    _, _, total = layout.plan_scratch_bytes(plan, 4)
    scratch = torch.empty(total, dtype=torch.uint8)
    run = kernel == sk.RUN
    outs = (None, None, None, torch.empty_like(fr)) if run else (
        torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(fr))
    return sk._launcher(kernel, plan, geom.arcs, lo, hi, None if run else dl,
                        None if run else dh, geom.alpha, 0.5, None if run else fr, outs,
                        scratch)


@pytest.mark.parametrize("kernel", sk.L2_ENTRIES)
def test_l2_launch_counts_only_while_a_profiler_records(monkeypatch, kernel):
    """The library replaced by a recorder: outside a profiler the L2 entry,
    under one its counting form with the same arguments and, before the
    stream, the address of the entry's row of the device's L2_WAIT."""
    rec = _Recorder()
    launch = _l2_launcher(rec, monkeypatch, kernel)
    monkeypatch.setattr(sk, "L2_COUNTED", {k: 0 for k in sk.L2_ENTRIES})
    launch()
    plain_name, plain_args = rec.calls[-1]
    assert plain_name == kernel + sk.HUGE_L2 + "_f32" and plain_args[-1] == 7
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    name, args = rec.calls[-1]
    acc = sk.L2_WAIT[torch.device("cpu")]
    assert name == kernel + sk.HUGE_L2 + "_count_f32"
    assert args == plain_args[:-1] + (acc[sk.L2_ENTRIES.index(kernel)].data_ptr(), 7)
    assert launch.counts == (kernel + sk.HUGE_L2,)
    assert sk.L2_COUNTED == {k: int(k == kernel) for k in sk.L2_ENTRIES}
    launch()
    assert rec.calls[-1] == (plain_name, plain_args)
    assert sk.L2_COUNTED[kernel] == 1


def test_l2_launch_stays_uncounted_where_the_counting_form_holds_fewer_blocks(monkeypatch):
    def occupancy(itemsize, threads, device, counting=False):
        return 1 if counting else 2

    monkeypatch.setattr(sk, "l2_occupancy", occupancy)
    monkeypatch.setattr(sk, "_COUNTING_FITS", {})
    rec = _Recorder()
    launch = _l2_launcher(rec, monkeypatch, "uniform_forward")
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    assert rec.calls[-1][0] == "uniform_forward" + sk.HUGE_L2 + "_f32"


def test_l2_wait_cycles_sum_the_devices_and_reset_zeroes_them(monkeypatch):
    monkeypatch.setattr(sk, "L2_WAIT", {
        torch.device("cpu"): torch.tensor([[1, 10], [2, 20], [0, 5]]),
        torch.device("cuda", 1): torch.tensor([[3, 30], [0, 0], [0, 0]])})
    assert sk.l2_wait_cycles() == {"uniform_forward": (4, 40), "uniform_backward": (2, 20),
                                   sk.RUN: (0, 5)}
    monkeypatch.setattr(sk, "L2_COUNTED", {k: 3 for k in sk.L2_ENTRIES})
    sk.reset_launch_counts()
    assert sk.l2_wait_cycles() == {k: (0, 0) for k in sk.L2_ENTRIES}
    assert sk.L2_COUNTED == {k: 0 for k in sk.L2_ENTRIES}


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sweep kernels run only on the card")
    return torch.device("cuda")


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float", "double"])
def test_every_host_sync_of_a_solve_is_a_sync_span(cuda_device, dtype):
    """Every call that waits for the card in a solve (the benchmark's: the
    initial state, then solve_dual) lies inside a ``bdd.sync`` span, and the
    solve has five: the objective's copy from pageable memory and the four
    bounds read on the host."""
    cell = Cell("cuda", dtype)
    cell.solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("test.solve"):  # not the profiler's own sync
            cell.solve()
    ev = host_ranges(prof)
    syncs = [e for e in ev if e[0] in SYNCS and inside(e, by_name(ev, "test.solve"))]
    spans = by_name(ev, "bdd.sync")
    assert syncs and all(inside(s, spans) for s in syncs), syncs
    assert len(spans) == 5 and all(any(inside(s, [sp]) for s in syncs) for sp in spans)


def _counted(launch):
    """Run ``launch`` under a profiler; the (wait, cycles) it added by entry."""
    before = sk.l2_wait_cycles()
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
        torch.cuda.synchronize()
    after = sk.l2_wait_cycles()
    return {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("split", [1, 2, None])
def test_l2_wait_counter_on_forced_plans(cuda_device, precision, split):
    """At G = 1 a block never spins: wait 0 and its cycles counted. At G > 1
    the blocks wait at their hop barriers for part of their time. Counted
    and uncounted launches give the same outputs bit for bit."""
    dtype = torch.float32 if precision == "float" else torch.float64
    itemsize = 4 if precision == "float" else 8
    host, (lo, hi, fr, dl, dh) = synthetic_host([(320000, 8, 2)], dtype, cuda_device, seed=37)
    geom = host.geom
    plan = layout.launch_plan(geom.plan.shapes, dtype, cuda_device, huge_body="huge_l2",
                              l2_split=split)
    assert plan.l2_blocks and (plan.l2_split == split if split else plan.l2_split > 2)
    assert layout.l2_occupancy(itemsize, plan.l2_threads, cuda_device, counting=True) >= \
        layout.l2_occupancy(itemsize, plan.l2_threads, cuda_device)
    for kernel, (launch, out) in (
            ("uniform_forward", sk.prepare_fused_launch("uniform_forward", geom, lo, hi, fr, 0.5,
                                                        dl, dh, plan)),
            ("uniform_backward", sk.prepare_fused_launch("uniform_backward", geom, lo, hi, fr,
                                                         0.5, dl, dh, plan)),
            (sk.RUN, sk.prepare_run_launch(geom, lo, hi, plan))):
        outs = [out] if kernel == sk.RUN else list(out)  # the run's is one tensor
        launch()
        torch.cuda.synchronize()
        plain = [o.clone() for o in outs]
        launched = sk.L2_COUNTED[kernel]
        counts = _counted(launch)
        assert sk.L2_COUNTED[kernel] == launched + 1
        assert_same_bits(outs, plain)
        wait, cycles = counts[kernel]
        assert all(v == (0, 0) for k, v in counts.items() if k != kernel)
        assert cycles > 0
        if plan.l2_split == 1:
            assert wait == 0
        else:
            assert 0 < wait < cycles
        before = sk.l2_wait_cycles()
        launch()  # no profiler: nothing counted
        torch.cuda.synchronize()
        assert sk.l2_wait_cycles() == before
