"""The port's spans and counters: ``utils.logging.span`` ranges at the layer
boundaries of the dual loop, ``bdd.sync`` around the host's reads of the
card's values, the L2 sweep body's hop-barrier wait
(``sweep_kernels.L2_WAIT``) and the shared-memory huge body's block-barrier
wait (``sweep_kernels.HUGE_WAIT``).

This file imports no JAX and nothing of bdd_tpu. The CPU tests record under
a CPU ``torch.profiler``; the ``cuda`` tests skip without a card and run on
one with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""
import dataclasses
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


# ------------------------------------- the L2 and the huge body's wait counters
def _recorded_launcher(rec, monkeypatch, kernel, shapes, bodies=None, **tunables):
    """``sk._launcher`` of ``kernel`` over synthetic float32 buckets of
    ``shapes`` on the CPU, by the layout's plan or one built on ``bodies``
    with ``tunables``, with the library replaced by the recorder ``rec``
    (stream 7)."""
    monkeypatch.setattr(sk._build, "load", lambda: rec)

    class _Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, torch.float32, "cpu")
    geom = host.geom
    plan = geom.plan if bodies is None else layout.build_plan(
        geom.plan.shapes, torch.float32, "cpu", bodies, **tunables)
    scratch = torch.empty(plan.scratch_bytes[2], dtype=torch.uint8)
    run = kernel == sk.RUN
    outs = (None, None, None, torch.empty_like(fr)) if run else (
        torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(fr))
    return plan, sk._launcher(kernel, plan, geom.arcs, lo, hi, None if run else dl,
                              None if run else dh, geom.alpha, 0.5, None if run else fr, outs,
                              scratch)


# by body with a counting form: a layout of one such bucket and the sums
# its counting form adds into (the L2 body: 320,000 slots over two columns;
# the huge body beside a narrow bucket: 1,024 slots, the ring form)
COUNTING = {sk.HUGE_L2: ([(320000, 2, 2)], "L2_WAIT"),
            sk.HUGE: ([(2, 3, 8), (1024, 4, 8)], "HUGE_WAIT")}


def _wait_row(body, kernel):
    acc = getattr(sk, COUNTING[body][1])[torch.device("cpu")]
    return acc[sk.L2_ENTRIES.index(kernel)].data_ptr()


@pytest.fixture
def counters(monkeypatch):
    """Fresh counters and sums of the counting forms for one test."""
    for name in ("L2_WAIT", "HUGE_WAIT"):
        monkeypatch.setattr(sk, name, {})
    for name in ("PROFILED", "COUNTED"):
        monkeypatch.setattr(sk, name, dict.fromkeys(sk.PROFILED, 0))


@pytest.mark.parametrize("kernel", sk.L2_ENTRIES)
@pytest.mark.parametrize("body", list(COUNTING))
def test_launch_counts_only_while_a_profiler_records(monkeypatch, counters, body, kernel):
    """The library replaced by a recorder: outside a profiler every record
    as the plan made it, no accumulator; under one the body's record takes
    the address of the entry's row of the device's sums (``L2_WAIT``,
    ``HUGE_WAIT``), its other fields and the narrow launch's unchanged;
    PROFILED and COUNTED count it by (body, entry); after the profiler the
    plain records again."""
    rec = _Recorder()
    shapes, _ = COUNTING[body]
    _, launch = _recorded_launcher(rec, monkeypatch, kernel, shapes)
    launch()
    name, plain, _, stream = rec.calls[-1]
    assert (name, stream) == (kernel + "_f32", 7)
    assert [r.body for r in plain] == [r for r in ("", body) if kernel + r in launch.counts]
    assert launch.counts == tuple(kernel + r.body for r in plain)
    assert all(r.acc is None for r in plain)
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    counted = rec.calls[-1][1]
    assert counted[:-1] == plain[:-1]
    assert counted[-1] == dataclasses.replace(plain[-1], acc=_wait_row(body, kernel))
    want = {k: int(k == (body, kernel)) for k in sk.PROFILED}
    assert sk.PROFILED == sk.COUNTED == want
    launch()
    assert rec.calls[-1][1] == plain
    assert sk.COUNTED == want


@pytest.mark.parametrize("body", list(COUNTING))
def test_launch_counts_as_count_every_says_under_a_profiler(monkeypatch, counters, body):
    """Under a profiler a launch takes its body's counting form at the first
    profiled launch of its entry and then once in every COUNT_EVERY of that
    body (the L2 body's 1, every launch; the huge body's HUGE_COUNT_EVERY,
    here 3); launches outside a profiler are not seen; reset_launch_counts
    starts over."""
    assert sk.COUNT_EVERY == {sk.HUGE_L2: 1, sk.HUGE: sk.HUGE_COUNT_EVERY}
    monkeypatch.setitem(sk.COUNT_EVERY, sk.HUGE, 3)
    every = sk.COUNT_EVERY[body]
    rec = _Recorder()
    _, launch = _recorded_launcher(rec, monkeypatch, "uniform_forward", COUNTING[body][0])

    def counted(n):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                launch()
        return [call[1][-1].acc is not None for call in rec.calls[-n:]]

    assert counted(4) == [k % every == 0 for k in range(4)]
    launch()  # no profiler: neither counted nor seen
    assert counted(3) == [k % every == 0 for k in range(4, 7)]
    assert sk.PROFILED[body, "uniform_forward"] == 7
    assert sk.COUNTED[body, "uniform_forward"] == sum(k % every == 0 for k in range(7))
    sk.reset_launch_counts()
    assert set(sk.PROFILED.values()) == set(sk.COUNTED.values()) == {0}
    assert counted(2) == [True, every == 1]


@pytest.mark.parametrize("body", list(COUNTING))
def test_launch_stays_uncounted_where_the_counting_form_does_not_fit(monkeypatch, counters,
                                                                     body):
    """Where the card holds fewer blocks an SM of the counting entries than
    of the body's own (the L2 body: one against two; the huge body: rows
    whose shared memory leaves no room for the counting form's static
    tallies, none at all), the launch keeps its own entry under a profiler
    and adds into no sums."""
    def occupancy(itemsize, which, threads, device, smem=0, own=(0, 0), counting=False):
        assert which == body
        return (0 if body == sk.HUGE else 1) if counting else (1 if body == sk.HUGE else 2)

    monkeypatch.setattr(sk, "block_occupancy", occupancy)
    monkeypatch.setattr(sk, "_COUNTING_FITS", {})
    rec = _Recorder()
    shapes, bodies = ([(29016, 2, 1)], ["huge"]) if body == sk.HUGE else ([(320000, 2, 2)], None)
    _, launch = _recorded_launcher(rec, monkeypatch, "uniform_forward", shapes, bodies)
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    (record,) = rec.calls[-1][1]
    assert (record.body, record.acc) == (body, None)
    assert getattr(sk, COUNTING[body][1]) == {}


@pytest.mark.parametrize("body", list(COUNTING))
def test_wait_cycles_sum_the_devices_and_reset_zeroes_them(monkeypatch, counters, body):
    name = COUNTING[body][1]
    cycles = sk.l2_wait_cycles if body == sk.HUGE_L2 else sk.huge_wait_cycles
    monkeypatch.setattr(sk, name, {
        torch.device("cpu"): torch.tensor([[1, 10], [2, 20], [0, 5]]),
        torch.device("cuda", 1): torch.tensor([[3, 30], [0, 0], [0, 0]])})
    assert cycles() == {"uniform_forward": (4, 40), "uniform_backward": (2, 20), sk.RUN: (0, 5)}
    assert sk.l2_wait_cycles() != sk.huge_wait_cycles()
    monkeypatch.setattr(sk, "COUNTED", dict.fromkeys(sk.COUNTED, 3))
    sk.reset_launch_counts()
    assert cycles() == {k: (0, 0) for k in sk.L2_ENTRIES}
    assert set(sk.COUNTED.values()) == {0}


def test_huge_and_l2_launches_both_count_under_a_profiler(monkeypatch, counters):
    """A layout with a huge and an L2 bucket: under a profiler both take
    their counting forms, each into its own accumulators, in one call."""
    rec = _Recorder()
    kernel = "uniform_backward"
    plan, launch = _recorded_launcher(rec, monkeypatch, kernel, [(1024, 4, 8), (320000, 2, 2)])
    assert [r.body for r in plan.sweeps] == [sk.HUGE, sk.HUGE_L2]
    launch()
    plain = rec.calls[-1][1]
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    assert len(rec.calls) == 2
    huge, l2 = rec.calls[-1][1]
    assert huge == dataclasses.replace(plain[0], acc=_wait_row(sk.HUGE, kernel))
    assert l2 == dataclasses.replace(plain[1], acc=_wait_row(sk.HUGE_L2, kernel))
    assert sk.COUNTED == {k: int(k[1] == kernel) for k in sk.COUNTED}


@pytest.mark.parametrize("kernel", sk.L2_ENTRIES)
def test_huge_ring_counts_the_ring_forms_launches_by_entry(monkeypatch, kernel):
    """HUGE_RING counts by entry the counted launches that take the huge
    body's ring form (1,024 slots at 1,024 threads), whose record holds its
    hops, and none of the grouped body's (the same table built with
    ``ring_hops=0``; 16,384 slots); both count under ``_huge`` in LAUNCHES,
    and reset_launch_counts clears HUGE_RING with the other counters."""
    rec = _Recorder()
    monkeypatch.setattr(sk, "HUGE_RING", {k: 0 for k in sk.L2_ENTRIES})
    monkeypatch.setattr(sk, "LAUNCHES", dict.fromkeys(sk.LAUNCHES, 0))
    for shapes, bodies, ring, hops in (
            ([(2, 3, 8), (1024, 4, 8)], None, None, layout.HUGE_RING_HOPS),
            ([(2, 3, 8), (1024, 4, 8)], ["narrow", "huge"], 0, 0),
            ([(16384, 2, 2)], ["huge"], None, 0)):
        plan, launch = _recorded_launcher(rec, monkeypatch, kernel, shapes, bodies,
                                          ring_hops=ring)
        sk._launch_counted(launch)
        record = rec.calls[-1][1][-1]
        huge = plan.launch("huge", run=kernel == sk.RUN)
        assert record.body == sk.HUGE and record.own == huge.own == (huge.own[0], hops)
        assert record.smem == (huge.smem_forward, huge.smem_backward)
    assert sk.HUGE_RING == {k: int(k == kernel) for k in sk.L2_ENTRIES}
    assert sk.LAUNCHES[kernel + sk.HUGE] == 3
    sk.reset_launch_counts()
    assert sk.HUGE_RING == {k: 0 for k in sk.L2_ENTRIES}


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
    plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["huge_l2"], l2_split=split)
    l2 = plan.launch("huge_l2")
    assert l2.own[0] == split if split else l2.own[0] > 2
    assert layout.block_occupancy(itemsize, sk.HUGE_L2, l2.threads, cuda_device,
                                  counting=True) >= \
        layout.block_occupancy(itemsize, sk.HUGE_L2, l2.threads, cuda_device)
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
        launched = sk.COUNTED[sk.HUGE_L2, kernel]
        counts = _counted(launch)
        assert sk.COUNTED[sk.HUGE_L2, kernel] == launched + 1
        assert_same_bits(outs, plain)
        wait, cycles = counts[kernel]
        assert all(v == (0, 0) for k, v in counts.items() if k != kernel)
        assert cycles > 0
        if l2.own[0] == 1:
            assert wait == 0
        else:
            assert 0 < wait < cycles
        before = sk.l2_wait_cycles()
        launch()  # no profiler: nothing counted
        torch.cuda.synchronize()
        assert sk.l2_wait_cycles() == before


def _huge_counted(launch):
    """Run ``launch`` under a profiler; the (wait, cycles) it added to the
    huge body's counter by entry."""
    before = sk.huge_wait_cycles()
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
        torch.cuda.synchronize()
    after = sk.huge_wait_cycles()
    return {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,fits", [
    ((1024, 900, 64), torch.float32, True),     # d60900's capacity rows
    ((16384, 4, 132), torch.float64, True),     # knapsack48's rows, one block an SM
    ((8192, 2, 256), torch.float32, True),      # two blocks an SM
    ((19316, 2, 3), torch.float64, False),      # the widest float64 rows: 16 B left
    ((29016, 2, 3), torch.float32, False)])     # the widest float32 rows: no room left
def test_huge_counting_fits_beside_the_plans_blocks(cuda_device, shape, dtype, fits):
    """The card's answer: the counting entries, with their static tallies,
    hold as many blocks an SM as the body's own, except where the plan's
    blocks leave less shared memory than the tallies take."""
    huge = layout.build_plan([shape], dtype, cuda_device, ["huge"]).launch("huge")
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert huge.blocks == shape[2]
    assert sk._counting_fits(huge, itemsize, cuda_device) == fits


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_huge_wait_counter_equals_the_uncounted_body(cuda_device, precision, monkeypatch):
    """The shared-memory huge body's counting entries (all three) give the
    outputs of its own entries bit for bit, on rows of 1,024 slots (two rows
    in the backward's shared memory) and 16,384 (one in float64), and count
    a wait at the block barriers below the blocks' cycles; without a
    profiler nothing is counted."""
    monkeypatch.setitem(sk.COUNT_EVERY, sk.HUGE, 1)  # every profiled launch counts
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host([(1024, 12, 8), (16384, 6, 3)], dtype,
                                                cuda_device, seed=41)
    geom = host.geom
    plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["huge"] * 2)
    assert [(r.body, r.nr_buckets, r.blocks) for r in plan.sweeps] == [(sk.HUGE, 2, 11)]
    for kernel, (launch, out) in (
            ("uniform_forward", sk.prepare_fused_launch("uniform_forward", geom, lo, hi, fr, 0.5,
                                                        dl, dh, plan)),
            ("uniform_backward", sk.prepare_fused_launch("uniform_backward", geom, lo, hi, fr,
                                                         0.5, dl, dh, plan)),
            (sk.RUN, sk.prepare_run_launch(geom, lo, hi, plan))):
        assert launch.counts == (kernel + sk.HUGE,)
        outs = [out] if kernel == sk.RUN else list(out)
        launch()
        torch.cuda.synchronize()
        plain = [o.clone() for o in outs]
        for o in outs:
            o.fill_(7.0)
        counts = _huge_counted(launch)
        assert_same_bits(outs, plain)
        wait, cycles = counts[kernel]
        assert all(v == (0, 0) for k, v in counts.items() if k != kernel)
        assert 0 < wait < cycles
        before = sk.huge_wait_cycles()
        launch()  # no profiler: nothing counted
        torch.cuda.synchronize()
        assert sk.huge_wait_cycles() == before
