"""Generalized assignment of type D (the benchmark's ``gap_d60900`` class) on
the port: the instance generator's rule, the port's dual solve against the
benchmark's plain reference on a small draw of the class, and the plan of
the d60900 layout.

A small draw (m = 5 agents, n = 80 jobs) keeps both row kinds of the class:
capacity rows of up to 1,024 slots over 80 hops, which the plan sends to the
shared-memory huge body, beside assignment rows of 2 slots over 5 hops on
the narrow body. On the CPU the wrappers run the torch twins. This file
imports no JAX and nothing of bdd_tpu."""
import math

import numpy as np
import pytest
import torch

from bdd_tpu_torch.solver import layout
from portbench import harness
from portbench.generators import yagiura_gap

SMALL = {"agents": 5, "jobs": 80}
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]
ITERATIONS = 10
# float32 against the float64 reference after ITERATIONS iterations: the
# gaps of harness.compare (relative to the reference's scale) read at most
# 4.4e-8 (bound), 3.9e-7 (per-BDD bounds) and 3.1e-7 (state) over seeds 0,
# 3, 7 and 2**31 + 11; the limits are about 20 times those
FLOAT_LIMITS = {"bound_gap": 1e-6, "bdd_bound_gap": 1e-5, "state_gap": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_keeps_the_type_d_rule_and_repeats_per_seed(seed):
    m_, n_ = SMALL["agents"], SMALL["jobs"]
    w, c, cap = yagiura_gap.draw(m_, n_, seed)
    assert w.shape == c.shape == (m_, n_) and cap.shape == (m_,)
    assert w.min() >= 1 and w.max() <= 100
    noise = c - (111 - w)
    assert noise.min() >= -10 and noise.max() <= 10
    assert (cap == [math.floor(0.8 * int(s) / m_) for s in w.sum(1)]).all()
    again = yagiura_gap.draw(m_, n_, seed)
    assert all(np.array_equal(a, b) for a, b in zip((w, c, cap), again))

    model = yagiura_gap.make(SMALL, seed)
    assert model.var_names == [f"x_{i}_{j}" for i in range(m_) for j in range(n_)]
    assert np.array_equal(model.costs(), c.ravel().astype(np.float64))
    assert model.lp_text() == yagiura_gap.make(SMALL, seed).lp_text()
    caps, jobs = model.rows[:m_], model.rows[m_:]
    assert len(jobs) == n_
    for i, r in enumerate(caps):
        assert (r.sense, r.rhs, r.coeffs) == ("<=", cap[i], w[i].tolist())
        assert r.vars == list(range(i * n_, (i + 1) * n_))
    for j, r in enumerate(jobs):
        assert (r.sense, r.rhs, r.coeffs) == ("=", 1, [1] * m_)
        assert r.vars == [i * n_ + j for i in range(m_)]


def test_generator_draws_type_d_alone():
    with pytest.raises(ValueError):
        yagiura_gap.make({**SMALL, "type": "C"}, 1)


def _port_against_reference(seed: int, precision: str) -> dict:
    """The benchmark's solve of the cell at the small size on the CPU, in
    ``precision``, ITERATIONS iterations through ``BddSolver.solve_dual``:
    the gaps of harness.compare against the float64 reference."""
    cell = harness.Cell("gap_d60900.dual", seed, "cpu", SMALL)
    cell.config = {**cell.config, "solver": {**cell.config["solver"], "precision": precision}}
    cell.iterations = ITERATIONS
    cell.set_up()
    plan = cell.host.geom.plan
    assert plan.shapes == ((2, SMALL["agents"], SMALL["jobs"]), (1024, SMALL["jobs"], 8))
    assert [r.body for r in plan.sweeps] == [r.body for r in plan.runs] == ["", "_huge"]
    lb, n = cell.solve()
    assert n == ITERATIONS and math.isfinite(lb)
    out = cell.outputs(lb)
    cell.release()
    return harness.compare(out, cell.reference(), cell.layout())


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_port_equals_the_reference_in_float64(seed):
    gaps = _port_against_reference(seed, "double")
    assert max(gaps.values()) < 1e-9, gaps


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_port_in_float32_is_near_the_reference(seed):
    gaps = _port_against_reference(seed, "float")
    assert all(gaps[k] < FLOAT_LIMITS[k] for k in FLOAT_LIMITS), gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_d60900_plans_huge_and_narrow_blocks_alone(dtype):
    """d60900's buckets: the 900 assignment rows (2 slots, 60 hops, padded to
    1,024 columns) and the 60 capacity rows (1,024 slots, 900 hops, padded to
    64 columns). 32 narrow blocks and 64 blocks of the shared-memory huge
    body, 1,024 threads each; no wide, cluster or L2 block, nor a run on
    another body."""
    shapes = [(2, 60, 1024), (1024, 900, 64)]
    itemsize = torch.finfo(dtype).bits // 8
    assert [layout.body_of(P, itemsize, B) for P, _, B in shapes] == ["narrow", "huge"]
    assert layout.route(shapes, itemsize, "cpu") == (("narrow", "huge"), ("narrow", "huge"))
    plan = layout.launch_plan(shapes, dtype, "cpu")
    assert [(r.body, r.nr_buckets, r.blocks) for r in plan.sweeps] == [("", 1, 32), ("_huge", 1, 64)]
    assert plan.launch("huge").threads == 1024 and plan.runs == plan.sweeps
    assert layout.huge_scratch(plan, "cpu") is None


def ring_layout_bytes(P: int, itemsize: int, hops: int, forward: bool) -> int:
    """The ring form's shared memory as uniform_sweep.cu's RingLayout carves
    it: the forward's row of keys or the backward's two rows (pad16 of P
    values each), 64 values of partials, hops + 1 stages of the arc record
    (pad16(4P)), a frontier row and HUGE_SCALARS values."""
    def pad16(x):
        return -(-x // 16) * 16

    row = pad16(P * itemsize)
    stage = pad16(4 * P) + row + layout.HUGE_SCALARS * itemsize
    return (1 if forward else 2) * row + 64 * itemsize + (hops + 1) * stage


D60900 = {"d60900": [(2, 60, 1024), (1024, 900, 64)],
          "small": [(2, SMALL["agents"], SMALL["jobs"]), (1024, SMALL["jobs"], 8)]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", list(D60900))
def test_gap_capacity_rows_take_the_ring_form(size, dtype):
    """The capacity rows (1,024 slots at 1,024 threads: one slot a thread)
    take the huge body's ring form at HUGE_RING_HOPS, its shared memory the
    kernel's layout; a plan built with ``ring_hops=0`` keeps the grouped body
    on the same table, and ``ring_hops`` forces the depth (1 to
    HUGE_RING_MAX)."""
    itemsize = torch.finfo(dtype).bits // 8
    shapes = D60900[size]
    plan = layout.launch_plan(shapes, dtype, "cpu")
    S = layout.HUGE_RING_HOPS
    huge = plan.launch("huge")
    assert (huge.nr_buckets, huge.own, huge.threads) == (1, (1024, S), 1024)
    assert huge.smem_forward == ring_layout_bytes(1024, itemsize, S, True) == (
        layout.huge_smem_bytes(1024, itemsize, ring=S))
    assert huge.smem_backward == ring_layout_bytes(1024, itemsize, S, False) == (
        layout.huge_smem_bytes(1024, itemsize, two_rows=True, ring=S))

    def forced(hops):
        return layout.build_plan(shapes, dtype, "cpu", ["narrow", "huge"], ring_hops=hops)

    grouped = forced(0).launch("huge")
    assert (grouped.own, grouped.threads) == ((1024, 0), 1024)
    assert grouped.smem_forward == layout.huge_smem_bytes(1024, itemsize)
    assert grouped.smem_backward == layout.huge_smem_bytes(1024, itemsize, two_rows=True)
    assert torch.equal(grouped.table, huge.table)
    for hops in range(1, layout.HUGE_RING_MAX + 1):
        deep = forced(hops).launch("huge")
        assert deep.own == (1024, hops)
        assert deep.smem_backward == ring_layout_bytes(1024, itemsize, hops, False)
        assert deep.smem_backward <= layout.MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="ring"):
        forced(layout.HUGE_RING_MAX + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shapes,threads,hops", [
    ([(16384, 48, 132)], 1024, 0),                   # knapsack48
    ([(8192, 32, 256)], 512, 0),                     # knapsack32
    ([(16384, 48, 132), (8192, 32, 256)], 1024, 0),  # the mixed table of 388 columns
    ([(1024, 3, 8), (2048, 2, 3)], 1024, 0),         # one bucket past the threads
    ([(1056, 3, 8)], 1024, 0),
    ([(1024, 3, 8)], 1024, layout.HUGE_RING_HOPS),
    ([(544, 3, 264)], 512, 0),                       # two blocks an SM: 512 threads
    ([(512, 3, 264)], 512, layout.HUGE_RING_HOPS),
    ([(40, 2, 3), (1000, 5, 2)], 1024, layout.HUGE_RING_HOPS),
], ids=["knapsack48", "knapsack32", "mixed388", "past-threads", "P1056", "P1024", "P544-512",
        "P512-512", "ragged"])
def test_ring_form_exactly_where_no_bucket_is_wider_than_the_threads(shapes, threads, hops,
                                                                      dtype):
    """The plan gives the huge launch the ring form exactly where its
    widest bucket is no wider than its threads (huge_pmax <= huge_threads),
    the grouped body elsewhere: knapsack48, knapsack32 and their mixed table
    of 388 columns keep it. Every bucket on the huge body (a plan built so);
    the run takes the same form."""
    itemsize = torch.finfo(dtype).bits // 8
    plan = layout.build_plan(shapes, dtype, "cpu", ["huge"] * len(shapes))
    huge = plan.launch("huge")
    assert plan.runs == plan.sweeps == (huge,)
    assert huge.nr_buckets == len(shapes) and huge.threads == threads
    assert huge.own[1] == hops == (layout.HUGE_RING_HOPS if huge.own[0] <= threads else 0)
    if hops:
        widest = max(P for P, _, _ in shapes)
        assert huge.smem_forward == ring_layout_bytes(widest, itemsize, hops, True)
        # the blocks the grouped body's plan lets reside fit with the ring's stages
        resident = layout.HUGE_THREADS // threads
        assert resident * (huge.smem_backward + layout.BLOCK_SMEM_RESERVED) <= (
            layout.SM_SMEM)
