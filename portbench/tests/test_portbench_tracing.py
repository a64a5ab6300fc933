"""The readers of the program's spans and counters on hand-made summaries:
``host_syncs_per_it``, ``sync_idle_pct`` and ``l2_barrier_wait_pct``."""
import pytest
import torch

from portbench import spec
from bdd_tpu_torch.solver import sweep_kernels as sk

SYNCS = spec.metric_reader("host_syncs_per_it")
SYNC_IDLE = spec.metric_reader("sync_idle_pct")
IDLE = spec.metric_reader("device_idle_pct")
L2_WAIT = spec.metric_reader("l2_barrier_wait_pct")


def summary(host, device, lo=0, hi=1000, iterations=10):
    busy = sum(e - s for _, s, e in device)  # the tests' intervals do not overlap
    return {"host": host, "device": device, "window_ns": (lo, hi), "iterations": iterations,
            "window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9}


# the device busy over [0, 100], [300, 400], [600, 700] and [900, 1000]: idle
# gaps (100, 300), (400, 600) and (700, 900)
DEVICE = [("k", 0, 100), ("k", 300, 400), ("k", 600, 700), ("k", 900, 1000)]
SOLVE = ("bdd.solve_dual", 0, 1000)


def test_syncs_are_the_sync_spans_per_iteration():
    host = [SOLVE, ("bdd.sync", 50, 110), ("aten::item", 55, 108), ("bdd.sync", 500, 520)]
    assert SYNCS(summary(host, DEVICE, iterations=50)) == 2 / 50


def test_a_program_without_spans_reads_nothing():
    host = [("aten::item", 50, 110), ("cudaStreamSynchronize", 60, 108)]
    assert SYNCS(summary(host, DEVICE)) is None
    assert SYNC_IDLE(summary(host, DEVICE)) is None


def test_a_program_with_spans_and_no_sync_reads_zero():
    assert SYNCS(summary([SOLVE], DEVICE)) == 0
    assert SYNC_IDLE(summary([SOLVE], DEVICE)) == 0


@pytest.mark.parametrize("sync,caused", [
    (("bdd.sync", 50, 110), (100, 300)),   # the gap opens inside the span: the sync's
    (("bdd.sync", 450, 520), None),        # the gap was open before the span: dispatch's
    (("bdd.sync", 610, 690), None),        # the span ends with the device busy
    (("bdd.sync", 20, 80), None),          # the gap opens after the span: dispatch's
    (("bdd.sync", 250, 320), None),        # the span ends after its gap closed
])
def test_sync_idle_counts_the_gap_a_sync_opened(sync, caused):
    s = summary([SOLVE, sync], DEVICE)
    want = 0.0 if caused is None else 100.0 * (caused[1] - caused[0]) / 1000
    assert SYNC_IDLE(s) == pytest.approx(want)
    assert SYNC_IDLE(s) <= IDLE(s)


def test_sync_idle_counts_a_gap_once_and_each_gap_it_caused():
    host = [SOLVE, ("bdd.bound", 40, 120), ("bdd.sync", 50, 110), ("bdd.sync", 60, 115),
            ("bdd.sync", 350, 420), ("bdd.sync", 650, 760)]
    s = summary(host, DEVICE)
    assert SYNC_IDLE(s) == pytest.approx(100.0 * (200 + 200 + 200) / 1000)
    assert SYNC_IDLE(s) == pytest.approx(IDLE(s))


def test_sync_idle_gaps_at_the_slices_edges_and_overlapping_intervals():
    device = [("k", -50, 100), ("copy", 80, 150), ("k", 700, 1200)]
    host = [SOLVE, ("bdd.sync", 120, 200)]
    s = summary(host, device)
    assert SYNC_IDLE(s) == pytest.approx(100.0 * (700 - 150) / 1000)
    tail = summary([SOLVE, ("bdd.sync", 880, 950)], [("k", 0, 900)])
    assert SYNC_IDLE(tail) == pytest.approx(100.0 * 100 / 1000)


def test_l2_wait_reads_the_programs_counter(monkeypatch):
    monkeypatch.setattr(sk, "L2_WAIT", {torch.device("cpu"): torch.tensor(
        [[300, 1000], [500, 1000], [0, 0]])})
    assert L2_WAIT(summary([SOLVE], DEVICE)) == pytest.approx(40.0)


def test_l2_wait_without_a_counted_launch_reads_nothing(monkeypatch):
    monkeypatch.setattr(sk, "L2_WAIT", {torch.device("cpu"): torch.zeros(3, 2, dtype=torch.int64)})
    assert L2_WAIT(summary([SOLVE], DEVICE)) is None
    monkeypatch.setattr(sk, "L2_WAIT", {})
    assert L2_WAIT(summary([SOLVE], DEVICE)) is None


def test_l2_wait_on_a_program_without_the_counter_reads_nothing(monkeypatch):
    monkeypatch.delattr(sk, "l2_wait_cycles")
    assert L2_WAIT(summary([SOLVE], DEVICE)) is None
