"""The CUDA sweep kernels against their torch twins, on the card.

This file imports no JAX and nothing of bdd_tpu, so it also runs on a GPU
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX). On a machine without a
card the ``cuda`` tests skip; the CPU tests check that the wrappers run the
twins there. Built with -fmad=false, the kernels must equal the twins bit for
bit: same ±inf pattern, identical finite values.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bdd_tpu_torch.native import NativeHost
from bdd_tpu_torch.utils.problems import grid_mrf
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.solver import uniform as uf


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards: the CPU solver of native/ sizes its
    per-thread scratch by omp_get_max_threads() of the thread that creates
    it, so a count lowered for good would break other modules' solvers that
    run parallel regions from other threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def wide_lp(seed: int = 0) -> str:
    """Cardinality constraints sum_{i<n} x_i = k (BDD width k+1) chosen so
    the buckets cover every instantiated slot width P = 1, 2, ..., 32, coupled
    by small cover rows so the deltas mix."""
    rng = np.random.RandomState(seed)
    groups = [(2, 2), (5, 1), (8, 3), (14, 7), (30, 15), (62, 31)]
    n = sum(size for size, _ in groups)
    obj = " ".join(f"{c:+.3f} x{i}" for i, c in enumerate(rng.uniform(-1, 1, n)))
    rows, off = [], 0
    for size, k in groups:
        rows.append(" + ".join(f"x{off + i}" for i in range(size)) + f" = {k}")
        off += size
    rows += [f"x{j} + x{j + 1} + x{j + 3} >= 1" for j in range(0, n - 3, 7)]
    return "Minimize\n" + obj + "\nSubject To\n" + "\n".join(rows) + "\nEnd"


INSTANCES = {
    "grid": lambda: grid_mrf(5, 5, 3, seed=3).write_lp(),
    "wide": wide_lp,
}


def setup(name, dtype, device, iters=3):
    nh = NativeHost(INSTANCES[name](), "input")
    host = layout.from_native_host(nh, dtype=dtype, device=device)
    st = uf.init_uniform_state(host, nh.objective())
    st = uf.iterations(host.geom, st, iters, 0.5, sweeps=uf.TWIN_SWEEPS)
    dl, dh = (host.geom.per_bucket(d) for d in uf.exchange_delta_flat(host.geom, st.flat[2]))
    dl = [d.clone() for d in dl]
    for d, g in zip(dl, host.geom.buckets):  # a forcing delta in every bucket
        idx = torch.nonzero(g.layer_valid)
        if len(idx):
            d[idx[0, 0], idx[0, 1]] = float("inf")
    return host, st, dl, dh


def launches(narrow=0, wide=0, run=0, run_wide=0, huge=0, run_huge=0, huge_l2=0, run_huge_l2=0,
             huge_cluster=0, run_huge_cluster=0):
    """``sk.LAUNCHES`` after ``narrow`` / ``wide`` / ``huge`` /
    ``huge_cluster`` / ``huge_l2`` launches of either half-sweep kernel and
    ``run`` / ``run_wide`` / ``run_huge`` / ``run_huge_cluster`` /
    ``run_huge_l2`` launches of the run-only backward entry."""
    out = {k + body: n for k in sk.KERNELS
           for body, n in (("", narrow), (sk.WIDE, wide), (sk.HUGE, huge),
                           (sk.HUGE_CLUSTER, huge_cluster), (sk.HUGE_L2, huge_l2))}
    return {**out, sk.RUN: run, sk.RUN + sk.WIDE: run_wide, sk.RUN + sk.HUGE: run_huge,
            sk.RUN + sk.HUGE_CLUSTER: run_huge_cluster, sk.RUN + sk.HUGE_L2: run_huge_l2}


def assert_identical(out, ref):
    for x, y in zip(out, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(torch.isfinite(x), torch.isfinite(y))
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def assert_same_bits(out, ref):
    """As ``assert_identical`` and also the sign of every zero: the same NaN
    pattern, and the same bit pattern everywhere else."""
    for x, y in zip(out, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        nan = torch.isnan(x)
        assert torch.equal(nan, torch.isnan(y))
        bits = torch.int32 if x.dtype == torch.float32 else torch.int64
        assert torch.equal(x.view(bits)[~nan], y.view(bits)[~nan])


def test_wide_instance_covers_every_kernel_width():
    host, *_ = setup("wide", torch.float32, "cpu", iters=0)
    assert sorted({g.P for g in host.geom.buckets}) == list(sk.SUPPORTED_P)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_wrappers_on_cpu_run_the_twins(name):
    host, st, dl, dh = setup(name, torch.float64, "cpu")
    sk.reset_launch_counts()
    for k, g in enumerate(host.geom.buckets):
        args = (g, st.lo[k], st.hi[k], st.cft[k], 0.5, dl[k], dh[k])
        fwd = sk.bucket_forward_iteration_cuda(*args)
        assert_identical(fwd, uf.bucket_forward_iteration(*args))
        bargs = (g, fwd[0], fwd[1], fwd[3], 0.5, dl[k], dh[k])
        assert_identical(sk.bucket_backward_iteration_cuda(*bargs),
                         uf.bucket_backward_iteration(*bargs))
    assert not any(sk.LAUNCHES.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sweep kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_half_sweeps_equal_twins(cuda_device, name, precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    host, st, dl, dh = setup(name, dtype, cuda_device)
    sk.reset_launch_counts()
    for k, g in enumerate(host.geom.buckets):
        args = (g, st.lo[k], st.hi[k], st.cft[k], 0.5, dl[k], dh[k])
        fwd = sk.bucket_forward_iteration_cuda(*args)
        ref = uf.bucket_forward_iteration(*args)
        torch.cuda.synchronize()
        assert_identical(fwd, ref)
        bargs = (g, ref[0], ref[1], ref[3], 0.5, dl[k], dh[k])
        bwd = sk.bucket_backward_iteration_cuda(*bargs)
        torch.cuda.synchronize()
        assert_identical(bwd, uf.bucket_backward_iteration(*bargs))
    n = len(host.geom.buckets)
    assert sk.LAUNCHES == launches(narrow=n)


@pytest.mark.cuda
def test_per_layer_omega_and_alpha_on_card(cuda_device):
    host, st, dl, dh = setup("wide", torch.float64, cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for k, g in enumerate(host.geom.buckets):
        om = torch.rand((g.H, g.B), generator=gen, dtype=torch.float64).to(cuda_device)
        al = g.alpha * torch.rand((g.H, g.B), generator=gen, dtype=torch.float64).to(cuda_device)
        args = (g, st.lo[k], st.hi[k], st.cft[k], om, dl[k], dh[k], al)
        assert_identical(sk.bucket_forward_iteration_cuda(*args),
                         uf.bucket_forward_iteration(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_iterations_through_kernels_equal_twins(cuda_device, precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    nh = NativeHost(grid_mrf(5, 5, 3, seed=3).write_lp(), "input")
    host = layout.from_native_host(nh, dtype=dtype, device=cuda_device)
    st0 = uf.init_uniform_state(host, nh.objective())
    a = uf.iterations(host.geom, st0, 10, 0.5)
    b = uf.iterations(host.geom, st0, 10, 0.5, sweeps=uf.TWIN_SWEEPS)
    for f in ("lo", "hi", "def_mm", "cft"):
        assert_identical(getattr(a, f), getattr(b, f))
    assert float(uf.lower_bound_with_deferred(host.geom, a)) == float(
        uf.lower_bound_with_deferred(host.geom, b))


def test_unsupported_width_raises_on_card():
    """No arc record refuses a width any more: a bucket past the wide body's
    8,192 slots builds with four-byte arcs and goes to the L2 body's table
    (over its 8 columns, G = 16) or, where a plan is built so, the huge
    body's. What no kernel takes is a narrow width that is no power of two
    (no layout builds one): the launch refuses it before anything runs."""
    b = random_bucket(2 * layout.WIDE_P, 2, 8, np.random.RandomState(0))
    host = layout._build_host([b], np.ones(4, np.int64), 4, 4, 8, torch.float32, "cpu")
    plan = host.geom.plan
    assert counts(plan) == (0, 0, 0, 0, 1) and plan.launch("huge_l2").blocks == 8 * 16
    forced = layout.build_plan(plan.shapes, torch.float32, "cpu", ["huge"])
    assert counts(forced) == (0, 0, 1, 0, 0) and forced.launch("huge").blocks == 8
    assert plan.arc_bytes == 2 * 8 * layout.record_bytes(2 * layout.WIDE_P) == 2 * 8 * 8 * 16384
    odd, (lo, hi, fr, dl, dh) = synthetic_host([(3, 2, 8)], torch.float32, "cpu")
    with pytest.raises(ValueError, match="P=3"):
        sk.prepare_fused_launch("uniform_forward", odd.geom, lo, hi, fr, 0.5, dl, dh)
    with pytest.raises(ValueError, match="P=3"):
        sk.prepare_run_launch(odd.geom, lo, hi)


# ------------------------------------------------- synthetic bucket shapes
def random_bucket(P, H, B, rng, packed=True, nr_vars=4):
    """A bucket of random geometry. Not a BDD: kernel and twin must agree on
    any bytes the encoding can hold."""
    lv = rng.rand(H, B) < 0.9
    node_valid = rng.rand(H, P, B) < 0.8
    node_valid[0, 1:] = False  # a column starts at a root: slot 0 of row 0
    roots = rng.rand(H, B) < 0.3
    roots[0] = node_valid[0, 0]
    return dict(
        node_valid=node_valid,
        lo_kind=rng.randint(0, 3, size=(H, P, B)).astype(np.int32),
        lo_slot=rng.randint(0, P, size=(H, P, B)).astype(np.int32),
        hi_kind=rng.randint(0, 3, size=(H, P, B)).astype(np.int32),
        hi_slot=rng.randint(0, P, size=(H, P, B)).astype(np.int32),
        layer_valid=lv,
        layer_var=np.where(lv, rng.randint(0, nr_vars, size=(H, B)), nr_vars).astype(np.int32),
        # half of the layers at alpha <= 1/3: forcing deltas must stay infinite
        alpha=np.where(lv, rng.choice([1.0, 0.5, 1 / 3, 0.25, 0.125], size=(H, B)), 0.0),
        layer_bdd=np.where(lv, 0, -1).astype(np.int64),
        root_mask=roots if packed else None,
        bdd_of_col=np.zeros(B, dtype=np.int64),
        depths=np.full(B, H, dtype=np.int32),
    )


def random_costs(geom, rng, device):
    """Flat (lo, hi, frontier, din_lo, din_hi) with infinities mixed in."""
    dt = geom.dtype

    def draw(n, p_inf):
        x = rng.randn(n)
        x[rng.rand(n) < p_inf] = np.inf
        return torch.from_numpy(x).to(device, dt)

    E, N = geom.plan.E, geom.plan.N
    return draw(E, 0.02), draw(E, 0.02), draw(N, 0.2), draw(E, 0.05), draw(E, 0.05)


def synthetic_host(shapes, dtype, device, seed=0, packed=True, padded=False):
    """A host of random buckets of ``shapes``; ``padded``: the last column of
    each packed bucket of more than one column emptied, as lane padding
    leaves a column (no valid layer, no node, depth 0)."""
    rng = np.random.RandomState(seed)
    buckets = [random_bucket(P, H, B, rng, packed) for P, H, B in shapes]
    for b in buckets if padded else ():
        if b["depths"].size > 1:
            b["layer_valid"][:, -1] = b["node_valid"][:, :, -1] = b["root_mask"][:, -1] = False
            b["layer_var"][:, -1], b["alpha"][:, -1], b["layer_bdd"][:, -1] = 4, 0.0, -1
            b["depths"][-1] = 0
    host = layout._build_host(buckets, np.ones(4, np.int64), 4, 4, len(buckets), dtype, device)
    return host, random_costs(host.geom, rng, device)


def routed_plan(shapes, dtype, device, **tunables):
    """``layout.build_plan`` on the bodies of the route, with ``tunables``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    bodies = layout.route(layout._shapes(shapes), itemsize, str(torch.device(device)))
    return layout.build_plan(shapes, dtype, device, *bodies, **tunables)


def with_threads(plan, body, threads):
    """``plan`` with ``threads`` threads a block in both entries' launches
    of ``body``, as timing variants set them; a huge launch whose widest
    bucket is wider than the threads takes the grouped body (the ring form's
    shared memory covers the grouped body's)."""
    suffix = layout.SUFFIXES[layout.BODIES.index(body)]

    def one(launch):
        if launch.body != suffix:
            return launch
        hops = launch.own[1] if body != "huge" or launch.own[0] <= threads else 0
        return dataclasses.replace(launch, threads=threads, own=(launch.own[0], hops))

    return dataclasses.replace(plan, sweeps=tuple(map(one, plan.sweeps)),
                               runs=tuple(map(one, plan.runs)))


def counts(plan, run=False):
    """The buckets of each body of ``layout.BODIES`` (narrow, wide, huge,
    cluster, L2) in ``plan``'s launches of the half-sweeps (``run``: of the
    run-only entry)."""
    return tuple(getattr(plan.launch(body, run), "nr_buckets", 0) for body in layout.BODIES)


def table_rows(launch, columns=3):
    """The first ``columns`` columns of each row of a launch's table (None:
    no rows)."""
    return [] if launch is None else [tuple(r[:columns]) for r in launch.table.tolist()]


def twins_bucket_by_bucket(twin, geom, lo, hi, frontier, omega, dl, dh, alpha=None):
    """``omega``: a scalar or flat [E]; ``alpha``: flat [E] or the layout's."""
    n = len(geom.buckets)
    omegas = geom.per_bucket(omega) if isinstance(omega, torch.Tensor) else (omega,) * n
    alphas = geom.per_bucket(alpha) if alpha is not None else (None,) * n
    outs = [
        twin(g, a, b, f, om, x, y, al)
        for g, a, b, f, om, x, y, al in zip(
            geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi),
            geom.per_bucket_nodes(frontier), omegas, geom.per_bucket(dl), geom.per_bucket(dh),
            alphas)
    ]
    return flat_outputs(geom, outs)


def flat_outputs(geom, outs):
    """Per-bucket (lo, hi, def_mm, frontier) laid flat as the fused wrappers
    return them: the frontier in the storage order of the layout."""
    new_lo, new_hi, new_mm, frontier = zip(*outs)
    return (layout.flatten(new_lo), layout.flatten(new_hi), layout.flatten(new_mm),
            geom.flatten_nodes(frontier))


# ragged B (not a multiple of either tile width), H of 1, 2 and above the
# ring depth of 8 hops, every P
SHAPES = [(P, H, B) for P in sk.SUPPORTED_P for H, B in ((1, 37), (2, 64), (11, 45), (9, 72))]
# wide buckets (two bytes an arc, the warp-a-column body): widths that are no
# multiple of four (rows that no 16-byte copy takes), B of 1, 7, 8, 9 and
# 2,048 against the 1 to 8 columns a block, H of 1 and 40 against the ring
# depths, P = 2,048 and the widest P
WIDE_SHAPES = [(64, 1, 37), (48, 7, 9), (128, 11, 13), (256, 5, 8), (512, 2, 3),
               (33, 40, 7), (33, 1, 1), (64, 40, 8), (256, 40, 9), (2048, 3, 2),
               (256, 1, 2048), (64, 40, 2048), (2048, 40, 1), (layout.WIDE_P, 3, 2),
               (layout.WIDE_P, 1, 1)]
# huge buckets (four bytes an arc, the block-a-column body, rows in shared
# memory): just past the wide records, widths no multiple of the block's
# threads, H of 1 and B of 1, the widest
HUGE_SHAPES = [(layout.WIDE_P + 1, 3, 3), (16384, 2, 2), (9000, 1, 1), (8200, 6, 4)]
# wide buckets the plan routes to the huge body on their two-byte records:
# from the crossover to the widest, odd widths among them
ROUTED_SHAPES = [(layout.HUGE_FROM, 5, 3), (layout.HUGE_FROM + 3, 2, 2), (4096, 3, 9),
                 (6001, 1, 1), (layout.WIDE_P, 4, 2)]
# rows past a block's shared memory: the cluster body, each block of a
# cluster a share of them (20,001 slots only in float64; float32 keeps them
# in one block's shared memory); ragged against every cluster size. The
# first two take four-byte slot codes; 65,536 and 70,000 slots take
# eight-byte ones (past CLUSTER_MAX_P), and only clusters of 8 and 16 hold
# them in float64
CLUSTER_SHAPES = [(30000, 3, 2), (20001, 1, 1), (65536, 2, 1), (70000, 3, 2)]
# rows past any cluster's (a cluster of 16 holds 309,312 slots in float32
# and 231,552 in float64): the L2 body, its rows in device memory
L2_SHAPES = [(320000, 2, 1)]
SHAPES += WIDE_SHAPES + HUGE_SHAPES + ROUTED_SHAPES + CLUSTER_SHAPES + L2_SHAPES


@pytest.mark.parametrize("precision", ["float", "double"])
def test_fused_wrappers_on_cpu_equal_twins_per_bucket(precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host(SHAPES[::4], dtype, "cpu")
    sk.reset_launch_counts()
    for fused, twin in ((sk.forward_iteration_cuda, uf.bucket_forward_iteration),
                        (sk.backward_iteration_cuda, uf.bucket_backward_iteration)):
        out = fused(host.geom, lo, hi, fr, 0.5, dl, dh)
        assert_identical(out, twins_bucket_by_bucket(twin, host.geom, lo, hi, fr, 0.5, dl, dh))
    assert not any(sk.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "P%d-H%d-B%d" % s)
def test_one_bucket_shapes_equal_twins(cuda_device, shape, precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host([shape], dtype, cuda_device, seed=sum(shape))
    g = host.geom.buckets[0]
    args = (g, lo.view(g.H, g.B), hi.view(g.H, g.B), host.geom.per_bucket_nodes(fr)[0], 0.5,
            dl.view(g.H, g.B), dh.view(g.H, g.B))
    for kernel, twin in ((sk.bucket_forward_iteration_cuda, uf.bucket_forward_iteration),
                         (sk.bucket_backward_iteration_cuda, uf.bucket_backward_iteration)):
        out = kernel(*args)
        torch.cuda.synchronize()
        assert_identical(out, twin(*args))
    # a wide frontier in another layout than the storage's is copied, not misread
    if g.P > layout.NARROW_P:
        other = (args[0], args[1], args[2], args[3].contiguous(), *args[4:])
        assert_identical(sk.bucket_forward_iteration_cuda(*other),
                         uf.bucket_forward_iteration(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("stages", [None, 1, 2, 4, 8])
def test_fused_launch_over_all_shapes_equals_twins(cuda_device, precision, stages):
    """One launch over the 24 narrow buckets of every width and one over the
    wide buckets, against the twins bucket by bucket; also at forced prefetch
    depths."""
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host(SHAPES, dtype, cuda_device, seed=7)
    geom = host.geom
    plan = routed_plan(geom.plan.shapes, dtype, cuda_device, stages=stages, wide_stages=stages)
    om = torch.rand(geom.plan.E, dtype=dtype, device=cuda_device)
    for omega in (0.5, om):
        for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                             ("uniform_backward", uf.bucket_backward_iteration)):
            launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, omega, dl, dh, plan)
            launch()
            torch.cuda.synchronize()
            om_b = omega if isinstance(omega, float) else None
            if om_b is None:
                ref = [
                    twin(g, a, b, f, o, x, y)
                    for g, a, b, f, o, x, y in zip(
                        geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi),
                        geom.per_bucket_nodes(fr), geom.per_bucket(omega),
                        geom.per_bucket(dl), geom.per_bucket(dh))
                ]
                ref = flat_outputs(geom, ref)
            else:
                ref = twins_bucket_by_bucket(twin, geom, lo, hi, fr, om_b, dl, dh)
            assert_identical(out, ref)


@pytest.mark.cuda
def test_fused_iteration_counts_one_launch_per_half_sweep(cuda_device):
    nh = NativeHost(wide_lp(), "input")
    host = layout.from_native_host(nh, dtype=torch.float64, device=cuda_device)
    assert len(host.geom.buckets) > 1
    st0 = uf.init_uniform_state(host, nh.objective())
    sk.reset_launch_counts()
    a = uf.iterations(host.geom, st0, 4, 0.5)
    assert sk.LAUNCHES == launches(narrow=4)
    b = uf.iterations(host.geom, st0, 4, 0.5, sweeps=uf.TWIN_SWEEPS)
    for f in ("lo", "hi", "def_mm", "cft"):
        assert_identical(getattr(a, f), getattr(b, f))


def test_plan_splits_narrow_and_wide_buckets():
    shapes = [(2, 3, 40), (128, 5, 8), (4, 2, 9), (256, 3, 7)]
    host, _ = synthetic_host(shapes, torch.float64, "cpu")
    plan = host.geom.plan
    narrow, wide = plan.sweeps
    assert plan.shapes == tuple(shapes) and plan.runs == plan.sweeps
    assert table_rows(narrow) == [shapes[0], shapes[2]]
    assert table_rows(wide) == [shapes[1], shapes[3]]
    assert (narrow.body, narrow.own[1], wide.body) == ("", 4, "_wide")
    # offsets run over all buckets in order, whichever table a bucket is in
    rows = sorted(narrow.table.tolist() + wide.table.tolist(), key=lambda r: r[4])
    e = n = 0
    for (P, H, B), r in zip(shapes, rows):
        assert (r[4], r[5]) == (e, n) and r[6] % layout.ARC_ALIGN == 0
        e, n = e + H * B, n + H * P * B
    # 15 columns in all: one warp a block, so that they spread over the SMs
    assert (wide.own[0], wide.blocks, wide.threads) == (1, 15, 32)
    assert [r[7] for r in wide.table.tolist()] == [layout.WIDE_STAGES] * 2
    assert wide.own[1] == layout.wide_warp_bytes(256, 8, layout.WIDE_STAGES)
    assert wide.smem_forward == wide.smem_backward == wide.own[0] * wide.own[1]
    # many columns: eight warps a block
    knap = layout.launch_plan([(256, 40, 2048)], torch.float32, "cpu").launch("wide")
    assert (knap.own[0], knap.blocks, knap.threads) == (layout.WIDE_WARPS, 256, 256)
    assert knap.smem_forward == 8 * (2 * 1024 + 2 * (1024 + 1024 + 32))
    # forced variants, for timing
    forced = layout.build_plan([(256, 40, 2048)], torch.float32, "cpu", ["wide"],
                               wide_stages=0, wide_warps=4).launch("wide")
    assert (forced.own, int(forced.table[0, 7])) == ((4, layout.wide_warp_bytes(256, 4, 0)), 0)
    deep = layout.build_plan([(256, 40, 2048)], torch.float32, "cpu", ["wide"],
                             wide_stages=4).launch("wide")
    assert int(deep.table[0, 7]) == 4 and deep.smem_forward <= layout.MAX_DYNAMIC_SMEM
    # the widest bucket fits a block in either precision: one warp, in
    # float64 without a ring
    for dtype, depth in ((torch.float32, 1), (torch.float64, 0)):
        widest = layout.build_plan([(layout.WIDE_P, 2, 8)], dtype, "cpu", ["wide"]).launch("wide")
        assert widest.own[0] == 1 and widest.smem_forward <= layout.MAX_DYNAMIC_SMEM
        assert int(widest.table[0, 7]) == depth
        # the route sends it to the huge body
        routed = layout.launch_plan([(layout.WIDE_P, 2, 8)], dtype, "cpu")
        assert counts(routed) == (0, 0, 1, 0, 0) and routed.launch("huge").blocks == 8

@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_mixed_layout_counts_a_narrow_and_a_wide_launch(cuda_device, precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    shapes = [(2, 9, 70), (128, 5, 9), (8, 4, 33), (64, 12, 5)]
    host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=3)
    sk.reset_launch_counts()
    calls = dict(uf.TWIN_SWEEP_CALLS)
    out_f = sk.forward_iteration_cuda(host.geom, lo, hi, fr, 0.5, dl, dh)
    out_b = sk.backward_iteration_cuda(host.geom, lo, hi, fr, 0.5, dl, dh)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == launches(narrow=1, wide=1)
    assert uf.TWIN_SWEEP_CALLS == calls  # no twin ran on the card
    assert_identical(out_f, twins_bucket_by_bucket(
        uf.bucket_forward_iteration, host.geom, lo, hi, fr, 0.5, dl, dh))
    assert_identical(out_b, twins_bucket_by_bucket(
        uf.bucket_backward_iteration, host.geom, lo, hi, fr, 0.5, dl, dh))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("zero_costs", [False, True], ids=["random", "ties-at-zero"])
@pytest.mark.parametrize("shape", [(8, 7, 40), (64, 7, 9), (256, 5, 8), (33, 40, 7),
                                   (2048, 3, 2), (8200, 5, 3), (layout.HUGE_FROM + 3, 4, 3),
                                   (20001, 3, 2), (30000, 3, 2), (65536, 3, 2), (70000, 3, 2),
                                   (320000, 3, 2), (layout.HUGE_FROM, 5, 3), (999, 4, 3)],
                         ids=lambda s: "P%d-H%d-B%d" % s)
def test_nan_and_signed_zeros_equal_twins_bit_for_bit(cuda_device, shape, zero_costs, precision):
    """Outside what a solve produces: -inf deltas (inf - inf, so NaN costs
    reach the frontier relaxation, whose minimum must keep them) and -0.0
    among the costs and deltas; with ``zero_costs`` every finite cost and
    frontier value is a zero, so every minimum is a tie of zeros. Kernel and
    twin must agree on the NaN pattern and, elsewhere, on every bit. Rows
    past WIDE_P run on the route's body (over these few columns the L2 body,
    or the cluster body for float32 rows a block holds) and on the body of
    their width forced, all three entries: the
    shared-memory huge body where a block holds them, else the cluster body
    where a cluster does. Rows of 33 to 1,024 slots (1,024 by the route) run
    on the huge body's ring form (one slot a thread) and on its grouped body
    forced on the same table, all three entries."""
    dtype = torch.float32 if precision == "float" else torch.float64
    host, costs = synthetic_host([shape], dtype, cuda_device, seed=sum(shape))
    lo, hi, fr, dl, dh = nan_and_zero_costs(costs, zero_costs)
    geom = host.geom
    g = geom.buckets[0]
    args = (g, lo.view(g.H, g.B), hi.view(g.H, g.B), fr.view(g.H, g.P, g.B), 0.5,
            dl.view(g.H, g.B), dh.view(g.H, g.B))
    seen_nan = False
    for kernel, twin in ((sk.bucket_forward_iteration_cuda, uf.bucket_forward_iteration),
                         (sk.bucket_backward_iteration_cuda, uf.bucket_backward_iteration)):
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = twin(*args)
        assert_same_bits(out, ref)
        seen_nan = seen_nan or bool(torch.isnan(ref[3]).any())
    assert seen_nan  # the case is what it says: a NaN went through a frontier
    # the run-only entry on the same costs: NaN costs reach its relaxation too
    run = sk.bucket_backward_run_cuda(g, args[1], args[2])
    torch.cuda.synchronize()
    ref_run = uf.bucket_backward_run(g, args[1], args[2])
    assert_same_bits([run], [ref_run])
    itemsize = lo.element_size()
    plans, suffix = [], sk.HUGE
    if layout.NARROW_P < g.P <= layout.HUGE_THREADS:  # the ring form, the grouped body beside it
        plans = [layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["huge"], ring_hops=ring)
                 for ring in (None, 0)]
        assert [p.launch("huge").own[1] for p in plans] == [layout.HUGE_RING_HOPS, 0]
    elif g.P > layout.WIDE_P and layout.cluster_fits(g.P, itemsize):
        force, suffix = (("huge", sk.HUGE) if layout.huge_fits(g.P, itemsize)
                         else ("huge_cluster", sk.HUGE_CLUSTER))
        plans = [layout.build_plan(geom.plan.shapes, dtype, cuda_device, [force])]
    for plan in plans:
        for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                             ("uniform_backward", uf.bucket_backward_iteration)):
            launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
            assert launch.counts == (kernel + suffix,)
            launch()
            torch.cuda.synchronize()
            assert_same_bits(out, twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh))
        launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
        assert launch.counts == (sk.RUN + suffix,)
        launch()
        torch.cuda.synchronize()
        assert_same_bits([out], [geom.flatten_nodes([ref_run])])


def nan_and_zero_costs(costs, zero_costs):
    """Copies of flat (lo, hi, frontier, din_lo, din_hi) with -0.0 at 30% of
    the costs and deltas and -inf at 10% of the deltas (so NaN costs reach
    the relaxation); with ``zero_costs`` every finite value a zero first."""
    rng = np.random.RandomState(1)
    lo, hi, fr, dl, dh = (x.clone() for x in costs)
    for x in (lo, hi, dl, dh):
        if zero_costs:
            x[torch.isfinite(x)] = 0.0
        x[torch.from_numpy(rng.rand(len(x)) < 0.3).to(x.device)] = -0.0
    if zero_costs:
        fr[torch.isfinite(fr)] = 0.0
    for x in (dl, dh):
        x[torch.from_numpy(rng.rand(len(x)) < 0.1).to(x.device)] = -float("inf")
    return lo, hi, fr, dl, dh


# ------------------------------------------------ the run-only backward entry
def test_run_wrappers_on_cpu_run_the_plain_version():
    host, (lo, hi, *_) = synthetic_host(SHAPES[::4], torch.float64, "cpu")
    geom = host.geom
    sk.reset_launch_counts()
    per_bucket = [uf.bucket_backward_run(g, a, b)
                  for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))]
    assert_same_bits([sk.backward_run_cuda(geom, lo, hi)], [geom.flatten_nodes(per_bucket)])
    for g, a, b, ref in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi), per_bucket):
        assert_same_bits([sk.bucket_backward_run_cuda(g, a, b)], [ref])
    assert not any(sk.LAUNCHES.values())
    assert uf.PLAIN_RUN_CALLS["backward_run_cuda"] == 0  # counts CUDA tensors only


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "P%d-H%d-B%d" % s)
def test_one_bucket_run_equals_plain_run(cuda_device, shape, precision):
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, *_) = synthetic_host([shape], dtype, cuda_device, seed=sum(shape))
    g = host.geom.buckets[0]
    sk.reset_launch_counts()
    out = sk.bucket_backward_run_cuda(g, lo.view(g.H, g.B), hi.view(g.H, g.B))
    torch.cuda.synchronize()
    plan = layout.launch_plan([shape], dtype, cuda_device)  # the route: by width and columns
    (run,) = plan.runs
    assert sk.LAUNCHES == {**launches(), sk.RUN + run.body: 1}
    assert_same_bits([out], [uf.bucket_backward_run(g, lo.view(g.H, g.B), hi.view(g.H, g.B))])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("stages", [None, 0, 1, 3])
def test_fused_run_over_all_shapes_equals_plain_run(cuda_device, precision, stages):
    """One launch of the run-only entry over the narrow buckets and one over
    the wide ones against the plain run bucket by bucket, also at forced ring
    depths of the wide body; no plain run on the card through the wrapper."""
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, *_) = synthetic_host(SHAPES, dtype, cuda_device, seed=7)
    geom = host.geom
    plan = routed_plan(geom.plan.shapes, dtype, cuda_device, wide_stages=stages)
    launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
    launch()
    torch.cuda.synchronize()
    ref = geom.flatten_nodes([
        uf.bucket_backward_run(g, a, b)
        for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])
    assert_same_bits([out], [ref])
    sk.reset_launch_counts()
    before = dict(uf.PLAIN_RUN_CALLS)
    assert_same_bits([sk.backward_run_cuda(geom, lo, hi)], [ref])
    # the run's route never launches the cluster body
    assert sk.LAUNCHES == launches(run=1, run_wide=1, run_huge=1, run_huge_l2=1)
    assert uf.PLAIN_RUN_CALLS == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("warps,stages", [(1, 0), (2, 1), (4, 2), (8, 4), (8, 8)])
def test_wide_body_variants_equal_twins(cuda_device, precision, warps, stages):
    """The wide body at forced warps a block and ring depths (what the plan
    may pick for other column counts), both half-sweeps, against the twins."""
    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host(WIDE_SHAPES[:10], dtype, cuda_device, seed=11)
    geom = host.geom
    plan = routed_plan(geom.plan.shapes, dtype, cuda_device, wide_stages=stages,
                       wide_warps=warps)
    wide = plan.launch("wide")
    assert wide.own[0] <= warps and max(wide.table[:, 7].tolist()) <= stages
    assert wide.smem_forward <= layout.MAX_DYNAMIC_SMEM
    for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                         ("uniform_backward", uf.bucket_backward_iteration)):
        launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
        launch()
        torch.cuda.synchronize()
        assert_identical(out, twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh))


# ------------------------------------------------------------- huge buckets
def test_plan_puts_huge_buckets_in_a_third_table():
    shapes = [(2, 3, 40), (16384, 2, 40), (128, 5, 8), (8200, 4, 40), (30000, 2, 130),
              (320000, 2, 2)]
    host, _ = synthetic_host(shapes, torch.float32, "cpu")
    plan = host.geom.plan
    huge, cluster, l2 = (plan.launch(b) for b in ("huge", "huge_cluster", "huge_l2"))
    assert table_rows(huge) == [shapes[1], shapes[3]]
    # past a block's shared memory: the 130 columns of 30,000 slots stay on
    # the cluster body (with them the L2 table's G would be 1), the rows past
    # a cluster's take the L2 body; the rows a block holds stay on the huge
    # body (with either, G would be 3)
    assert table_rows(cluster) == [shapes[4]]
    assert table_rows(l2) == [shapes[5]]
    assert counts(plan) == (1, 1, 2, 1, 1)
    # a block a column; the huge table's last column: the rows the backward
    # keeps in shared memory (two: one block an SM)
    assert huge.blocks == 80 and [r[3] for r in huge.table.tolist()] == [0, 40]
    # the L2 body: its two columns spread over the 132 SMs, 66 blocks each
    assert l2.own == (66, 2)
    assert l2.blocks == 2 * 66 and [r[3] for r in l2.table.tolist()] == [0]
    assert [r[7] for r in huge.table.tolist()] == [2, 2]
    assert huge.threads == l2.threads == layout.HUGE_THREADS == 1024
    assert huge.own == (16384, 0)  # wider than its threads: the grouped body
    # a cluster of C blocks a column (130 columns over 132 SMs: two waves of
    # the card's 66 clusters of two), two backward rows
    assert cluster.own == (2, 30000) and cluster.blocks == 2 * 130
    assert [r[3] for r in cluster.table.tolist()] == [0]
    assert [r[7] for r in cluster.table.tolist()] == [2]
    assert cluster.threads == 1024
    # the L2 table's last column: the bucket's offset into the scratch rows,
    # which only the L2 body's buckets get (not the cluster body's)
    assert [r[7] for r in l2.table.tolist()] == [0]
    assert plan.scratch_bytes[0] == 2 * 320000 * 2 * 4
    # the run-only entry: the cluster bucket on the L2 body beside the L2
    # bucket, 132 columns at one block each
    assert counts(plan, run=True) == (1, 1, 2, 0, 2)
    run = plan.launch("huge_l2", run=True)
    assert table_rows(run) == [shapes[4], shapes[5]]
    assert (run.own, run.blocks) == ((1, 132), 132)
    assert [r[3] for r in run.table.tolist()] == [0, 130]
    assert [r[7] for r in run.table.tolist()] == [0, 0]  # the run reads no key rows
    # the rows belong to the layout, allocated on the card only
    assert host.geom.huge_scratch is None
    assert layout.huge_scratch(plan, "cpu") is None
    assert layout.arc_bytes(8192) == 2 and layout.arc_bytes(8193) == 4
    assert layout.record_bytes(8193) == 8 * 8193
    # the bytes a solve works in, the number a layout too large for the card
    # names: with the L2 body's scratch as the most any plan of these buckets
    # takes, the key rows of every bucket past WIDE_P and the partials and
    # counters of all their columns, at the most blocks a column a plan takes
    E = 3 * 40 + 2 * 40 + 5 * 8 + 4 * 40 + 2 * 130 + 2 * 2
    N = (3 * 2 * 40 + 2 * 16384 * 40 + 5 * 128 * 8 + 4 * 8200 * 40 + 2 * 30000 * 130
         + 2 * 320000 * 2)
    scratch = (2 * (16384 * 40 + 8200 * 40 + 30000 * 130 + 320000 * 2) * 4
               + 2 * layout.L2_MAX_SPLIT * 212 * 4 + 212 * 4)
    assert layout.solve_bytes(plan.shapes, 4) == plan.arc_bytes + E * (9 * 4 + 24) + (
        2 * N * 4 + scratch)


# ------------------------------------------- the L2 body: G blocks a column
@pytest.mark.parametrize("columns,sms,split", [
    (1, 132, 132), (2, 132, 66), (7, 132, 18), (66, 132, 2), (132, 132, 1), (200, 132, 1),
    (2, 66, 33), (7, 114, 16), (3, 1, 1)])
def test_l2_split_follows_the_columns(columns, sms, split):
    """G, the blocks a column of the L2 body: as many as the card holds at
    once for every column together (one block of 1,024 threads an SM off the
    card), at least 1; on 132 SMs the plan's own for tables of that many
    columns of 320,000 slots, its blocks G a column."""
    assert layout.block_occupancy(8, sk.HUGE_L2, layout.HUGE_THREADS, "cpu") == 1
    assert layout.choose_l2_split(columns, 320000, layout.HUGE_THREADS, sms) == split
    if sms == layout.SM_COUNT:
        plan = layout.launch_plan([(320000, 2, columns)], torch.float64, "cpu")
        (l2,) = plan.sweeps
        assert (l2.body, l2.nr_buckets, l2.own) == (sk.HUGE_L2, 1, (split, columns))
        assert l2.blocks == split * columns and l2.threads == layout.HUGE_THREADS


def test_l2_split_is_capped_and_forced():
    """G keeps at least a thread's worth of slots a block of the widest
    bucket (ceil(pmax / threads)) and at most L2_MAX_SPLIT; a table of no
    column with a hop splits nothing; ``l2_split`` forces G (1 to
    L2_MAX_SPLIT: the card refuses more than it holds at the launch)."""
    assert layout.choose_l2_split(1, 8193, 1024, 132) == 9
    assert layout.choose_l2_split(1, 1 << 20, 32, 132 * 32) == layout.L2_MAX_SPLIT == 256
    assert layout.choose_l2_split(0, 320000, 1024, 132) == 1
    assert layout.block_occupancy(4, sk.HUGE_L2, 256, "cpu") == 4
    # on the L2 body, a bucket of 9,000 slots over 3 columns: 9 a column
    plan = layout.build_plan([(9000, 2, 3)], torch.float32, "cpu", ["huge_l2"])
    assert (plan.launch("huge_l2").own[0], plan.launch("huge_l2").blocks) == (9, 27)
    for split in (1, 2, 7, 256):
        forced = routed_plan([(320000, 2, 2)], torch.float32, "cpu", l2_split=split)
        assert (forced.launch("huge_l2").own[0], forced.launch("huge_l2").blocks) == (
            split, 2 * split)
    for split in (0, 257):
        with pytest.raises(ValueError, match="1 to 256 blocks a column"):
            routed_plan([(320000, 2, 2)], torch.float32, "cpu", l2_split=split)


@pytest.mark.parametrize("split", [None, 5, 1])
def test_l2_first_block_counts_in_units_of_the_split(split):
    """The L2 table's ``first_block`` counts blocks, G of them a column, and
    its last column the bucket's offset into the key rows; three buckets of
    different H and B in one table (6 columns: G = 22 on 132 SMs)."""
    shapes = [(320000, 2, 3), (330000, 4, 2), (400000, 3, 1)]
    plan = routed_plan(shapes, torch.float64, "cpu", l2_split=split)
    G = split or 22
    l2 = plan.launch("huge_l2")
    assert l2.own == (G, 6)
    assert [r[3] for r in l2.table.tolist()] == [0, 3 * G, 5 * G]
    assert l2.blocks == 6 * G
    assert [r[7] for r in l2.table.tolist()] == [0, 2 * 320000 * 3,
                                                2 * 320000 * 3 + 2 * 330000 * 2]
    assert plan.scratch_bytes[0] == 8 * 2 * (320000 * 3 + 330000 * 2 + 400000)


@pytest.mark.parametrize("P,G,threads", [
    (320000, 132, 1024), (262144, 66, 1024), (262144, 1, 1024), (70001, 7, 256),
    (8193, 9, 1024), (1000, 7, 64), (100, 4, 32), (33, 66, 1024), (65, 3, 32)])
def test_l2_slots_cover_every_slot_once(P, G, threads):
    """The share mapping (``layout.l2_slots``, the kernel's loops): over
    every slot of a bucket of P slots, the blocks of a column of G blocks
    own each slot exactly once, block (slot // L2_CHUNK) mod G; with P no
    multiple of G nor of a chunk, and G past P / threads (blocks with no
    slot, which still pass every barrier)."""
    seen = np.zeros(P, dtype=np.int64)
    for g in range(G):
        slots = layout.l2_slots(P, G, g, threads)
        assert len(np.unique(slots)) == len(slots)
        assert ((slots // layout.L2_CHUNK) % G == g).all()
        seen[slots] += 1
    assert (seen == 1).all()
    # one block a column walks every slot as the block-a-column body did
    one = layout.l2_slots(P, 1, 0, threads)
    assert sorted(one.tolist()) == list(range(P))


@pytest.mark.parametrize("precision", ["float", "double"])
def test_l2_scratch_holds_rows_partials_and_counters(precision):
    """The layout's L2 scratch: the forward's key rows, then, where the plan
    splits a column, the partials (G pairs of values a column) and the
    counters (four bytes a column), each part 16-byte aligned; a split of 1
    keeps only the rows. The bytes a solve works in count them at the most
    blocks a column a plan takes, which holds the plan's own on any card."""
    dtype = torch.float32 if precision == "float" else torch.float64
    itemsize = 4 if precision == "float" else 8
    rows = 2 * 320000 * 2 * itemsize
    plan = layout.launch_plan([(320000, 48, 2)], dtype, "cpu")
    assert plan.launch("huge_l2").own == (66, 2)
    parts, counters, total = plan.scratch_bytes
    assert parts == rows and counters == rows + -(-2 * 66 * 2 * itemsize // 16) * 16
    assert total == counters + 4 * 2
    one = routed_plan([(320000, 48, 2)], dtype, "cpu", l2_split=1)
    assert one.scratch_bytes == (rows, rows, rows)
    assert layout.huge_scratch(plan, "cpu") is None  # the twins need none
    E, N = 48 * 2, 48 * 320000 * 2
    base = layout.record_bytes(320000) * E + E * (9 * itemsize + 24) + 2 * N * itemsize
    most = layout.l2_scratch_bytes(2 * 320000 * 2, layout.L2_MAX_SPLIT, 2, itemsize)[2]
    assert layout.solve_bytes([(320000, 48, 2)], itemsize) == base + most >= base + total


class _Recorder:
    """A stand-in for the kernel library: every entry records its name and
    its arguments, the records of a sweep entry copied (a launch sets their
    accumulators anew each call)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(records, n, buffers, stream, failed):
            self.calls.append((name, [Record.of(r) for r in records[:n]], buffers._obj, stream))
            return 0

        return entry


@dataclasses.dataclass(frozen=True)
class Record:
    """The fields of a library record (``_build.Launch``), the body by its
    suffix."""

    body: str
    nr_buckets: int
    blocks: int
    threads: int
    smem: tuple  # forward, backward and run
    own: tuple
    scratch: tuple  # rows, partials, counters
    acc: int

    @staticmethod
    def of(r):
        return Record(sk.BODIES[r.body], r.nr_buckets, r.blocks, r.threads,
                      (r.smem_forward, r.smem_backward), tuple(r.own),
                      (r.rows, r.partials, r.counters), r.acc)


@pytest.mark.parametrize("split", [None, 1])
def test_l2_launch_hands_every_entry_its_scratch(monkeypatch, split):
    """What the wrapper hands the L2 entries (the library replaced by a
    recorder): G, the columns, the key rows, the partials and the counters
    inside the layout's scratch, the same buffer for the forward, the
    backward and the run; a launch without the scratch is refused."""
    rec = _Recorder()
    monkeypatch.setattr(sk._build, "load", lambda: rec)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    host, (lo, hi, fr, dl, dh) = synthetic_host([(320000, 2, 2)], torch.float32, "cpu")
    geom = host.geom
    plan = routed_plan(geom.plan.shapes, torch.float32, "cpu", l2_split=split)
    G = split or 66
    parts, counters, total = plan.scratch_bytes
    scratch = torch.empty(total, dtype=torch.uint8)
    base = scratch.data_ptr()
    for kernel, frontier in (("uniform_forward", fr), ("uniform_backward", fr), (sk.RUN, None)):
        outs = (None, None, None, torch.empty_like(fr)) if kernel == sk.RUN else (
            torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(fr))
        launch = sk._launcher(kernel, plan, geom.arcs, lo, hi, None if frontier is None else dl,
                              None if frontier is None else dh, geom.alpha, 0.5, frontier, outs,
                              scratch)
        assert launch.counts == (kernel + sk.HUGE_L2,)
        launch()
        name, (record,), buffers, stream = rec.calls[-1]
        assert (name, stream) == (kernel + "_f32", 0)
        assert (record.body, record.blocks, record.threads, record.own) == (
            sk.HUGE_L2, 2 * G, layout.HUGE_THREADS, (G, 2))
        assert record.scratch == (base, base + parts, base + counters) and record.acc is None
        assert (buffers.lo, buffers.frontier) == (
            lo.data_ptr(), None if frontier is None else fr.data_ptr())
        assert base + counters + (4 * 2 if G > 1 else 0) <= base + total
        with pytest.raises(ValueError, match="needs its scratch"):
            sk._launcher(kernel, plan, geom.arcs, lo, hi, None, None, None, 0.5, frontier, outs)


@pytest.mark.parametrize("P,itemsize,body", [
    (2, 8, "narrow"), (layout.NARROW_P, 8, "narrow"), (layout.NARROW_P + 1, 8, "wide"),
    (layout.HUGE_FROM - 1, 8, "wide"), (layout.HUGE_FROM, 8, "huge"), (layout.WIDE_P, 4, "huge"),
    (layout.WIDE_P + 1, 8, "huge"), (16384, 8, "huge"), (19316, 8, "huge"),
    (19317, 8, "huge_cluster"), (29016, 4, "huge"), (29017, 4, "huge_cluster"),
    (32768, 4, "huge_cluster"), (32768, 8, "huge_cluster"),
    (layout.CLUSTER_MAX_P, 4, "huge_cluster"), (layout.CLUSTER_MAX_P, 8, "huge_cluster"),
    (layout.CLUSTER_MAX_P + 1, 4, "huge_cluster"), (layout.CLUSTER_MAX_P + 1, 8, "huge_cluster"),
    (65536, 4, "huge_cluster"), (65536, 8, "huge_cluster"), (115776, 8, "huge_cluster"),
    (115777, 8, "huge_l2"), (131072, 8, "huge_l2"), (154657, 4, "huge_cluster"),
    (262144, 4, "huge_cluster"), (262144, 8, "huge_l2"), (231552, 8, "huge_l2"),
    (231553, 8, "huge_l2"), (309312, 4, "huge_cluster"), (309313, 4, "huge_l2")])
def test_plan_sends_each_width_to_its_body(P, itemsize, body):
    """narrow, wide, routed two-byte huge, huge (its rows in a block's shared
    memory), cluster (its rows in a cluster's: past a block's, up to what a
    cluster of CLUSTER_ROUTED blocks holds with eight-byte slot codes,
    309,312 slots in float32 at 16 and 115,776 in float64 at 8), L2 (the
    rest; a cluster of 16 holds float64 rows up to 231,552 slots where the
    plan is told so): one table each, and the records and padding follow
    the width alone, whichever body runs it. Past WIDE_P the columns choose
    too: over 5 columns (an L2 table's G of 9 and more) the route gives a
    width a block or a cluster holds to the L2 body (float32 rows a block
    holds to the cluster body, 5 clusters of 16), over 132 (G = 1) to the
    body of its width, where the cluster body's run takes the L2 body and
    the huge body's its own; ``body_of`` gives the width's body whatever the
    columns, and only ``route`` holds the route."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    assert layout.body_of(P, itemsize) == body
    assert layout.huge_fits(P, itemsize) == (body not in ("huge_cluster", "huge_l2"))
    assert layout.cluster_fits(P, itemsize, layout.CLUSTER_ROUTED[itemsize]) == (
        body != "huge_l2")
    held = layout.cluster_fits(P, itemsize)  # by a cluster of 16
    assert held == (body != "huge_l2" or itemsize == 8 and P <= 231552)
    routed = "huge_l2" if body == "huge_cluster" or P > layout.WIDE_P else body
    if itemsize == 4 and body == "huge" and P > layout.WIDE_P:
        routed = "huge_cluster"
    assert layout.body_of(P, itemsize, 5) == body
    plan = layout.launch_plan([(P, 3, 5)], dtype, "cpu")
    assert counts(plan) == tuple(int(routed == b) for b in layout.BODIES)
    # no bucket but the L2 body's has scratch rows
    rows = -(-2 * P * 5 * itemsize // 16) * 16
    assert plan.scratch_bytes[0] == (rows if routed == "huge_l2" else 0)
    if routed == "huge_l2":
        G = plan.launch("huge_l2").own[0]
        assert G == layout.choose_l2_split(5, P, 1024, 132) >= layout.L2_FROM_SPLIT
        assert counts(plan, run=True) == counts(plan)
        assert plan.launch("huge_l2", run=True).own == (G, 5)
    if routed == "huge_cluster":  # clusters of 16; the run on the L2 body
        assert plan.launch("huge_cluster").own[0] == 16
        assert counts(plan, run=True) == (0, 0, 0, 0, 1)
    if held and P > layout.WIDE_P:
        many = layout.launch_plan([(P, 3, 132)], dtype, "cpu")
        assert layout.body_of(P, itemsize, 132) == body
        assert counts(many) == tuple(int(body == b) for b in layout.BODIES)
        assert counts(many, run=True) == (0, 0, int(body == "huge"), 0, int(body != "huge"))
        # the cluster body where a plan is built so, over the same 5 columns
        plan = layout.build_plan([(P, 3, 5)], dtype, "cpu", ["huge_cluster"])
        cluster = plan.launch("huge_cluster")
        assert counts(plan) == counts(plan, run=True) == (0, 0, 0, 1, 0)
        C = cluster.own[0]
        assert cluster.own[1] == P and cluster.blocks == 5 * C and C in layout.CLUSTER_SIZES
        assert max(cluster.smem_forward, cluster.smem_backward) <= layout.MAX_DYNAMIC_SMEM
        # the slot codes: four bytes up to CLUSTER_MAX_P, eight past it
        code = 4 if P <= layout.CLUSTER_MAX_P else 8
        assert layout.cluster_code_bytes(P) == code
        S = -(-P // C)
        assert cluster.smem_forward == (-(-S * itemsize // 16) * 16 + -(-code * S // 16) * 16
                                        + (64 + 32 + 2 * layout.HUGE_SCALARS) * itemsize)
        # the L2 body where a plan is built so
        forced = layout.build_plan([(P, 3, 5)], dtype, "cpu", ["huge_l2"])
        assert counts(forced) == (0, 0, 0, 0, 1)
    assert layout.arc_bytes(P) == (1 if P <= layout.NARROW_P else 2 if P <= layout.WIDE_P else 4)
    assert layout.lane_pad(132, P) == (132 if P > layout.WIDE_P else 256)
    if body == "huge":  # on the huge body: over 5 columns up to WIDE_P, over 132 past it
        on = (plan if P <= layout.WIDE_P else many).launch("huge")
        assert on.own[0] == P and on.threads == layout.HUGE_THREADS
        assert max(on.smem_forward, on.smem_backward) <= layout.MAX_DYNAMIC_SMEM
        # the huge body over the 5 columns where a plan is built so, all three entries
        forced = layout.build_plan([(P, 3, 5)], dtype, "cpu", ["huge"])
        assert counts(forced) == counts(forced, run=True) == (0, 0, 1, 0, 0)
    # the wide body still takes every wide bucket where a plan is built so
    if P <= layout.WIDE_P and body == "huge":
        forced = layout.build_plan([(P, 3, 5)], dtype, "cpu", ["wide"])
        assert counts(forced) == (0, 1, 0, 0, 0)


# -------------------------------- the cluster-or-L2 route by columns
# the layouts the crossover was measured on (chip_smoke.py --huge-split
# route): (P, columns, precisions, the L2 table's G on 132 SMs)
ROUTE_LAYOUTS = ([(32768, c, (4, 8), g) for c, g in ((8, 16), (33, 4), (66, 2), (132, 1))]
                 + [(65536, c, (4, 8), g)
                    for c, g in ((1, 64), (8, 16), (16, 8), (33, 4), (66, 2), (132, 1))]
                 + [(262144, c, (4,), g) for c, g in ((1, 132), (8, 16), (33, 4), (66, 2),
                                                      (132, 1))]
                 + [(131072, c, (8,), g) for c, g in ((1, 128), (8, 16), (33, 4), (66, 2),
                                                      (132, 1))])


@pytest.mark.parametrize("P,columns,itemsizes,G", ROUTE_LAYOUTS,
                         ids=lambda v: str(v) if not isinstance(v, tuple) else None)
def test_route_sends_few_columns_to_the_l2_body(P, columns, itemsizes, G):
    """Rows past a block's shared memory that a cluster holds: the
    half-sweeps take the L2 body where its G over their columns is at least
    L2_FROM_SPLIT (1 to 33 columns here) and the cluster body where it is
    lower (66 and 132 columns), but in float64 rows that only a cluster of 16
    holds (131,072 slots) take the L2 body at any column count
    (CLUSTER_ROUTED); the run-only entry takes the L2 body either way, at the
    G of its own table, and launches no cluster."""
    assert layout.L2_FROM_SPLIT == 4
    assert layout.choose_l2_split(columns, P, layout.HUGE_THREADS, 132) == G
    for itemsize in itemsizes:
        dtype = torch.float32 if itemsize == 4 else torch.float64
        assert layout.cluster_fits(P, itemsize) and not layout.huge_fits(P, itemsize)
        routed = (P, itemsize) != (131072, 8)
        assert layout.cluster_fits(P, itemsize, layout.CLUSTER_ROUTED[itemsize]) == routed
        body = "huge_l2" if G >= layout.L2_FROM_SPLIT or not routed else "huge_cluster"
        assert layout.body_of(P, itemsize, columns) == (  # the width's
            "huge_cluster" if routed else "huge_l2")
        assert layout.route([(P, 48, columns)], itemsize, "cpu") == ((body,), ("huge_l2",))
        plan = layout.launch_plan([(P, 48, columns)], dtype, "cpu")
        assert counts(plan) == ((0, 0, 0, 0, 1) if body == "huge_l2" else (0, 0, 0, 1, 0))
        if body == "huge_l2":  # by its columns, or past the route's clusters by its width
            assert plan.launch("huge_l2").own[0] == G and (G >= layout.L2_FROM_SPLIT or not routed)
        assert counts(plan, run=True) == (0, 0, 0, 0, 1)
        run = plan.launch("huge_l2", run=True)
        assert (run.own, run.blocks) == ((G, columns), G * columns)


@pytest.mark.parametrize("itemsize,shapes,cluster,G", [
    # past a cluster's rows in float64 (320,000 slots, 2 columns) beside
    # rows a cluster holds: the widest joins first (10 columns: G = 11), then
    # the next (15: G = 8); none would leave G below 4
    (8, [(320000, 2, 2), (30000, 2, 3), (65536, 2, 10)], [], 8),
    # 20 columns each: the widest joins (G = 6), the next would take G to 3
    # at 40 columns, and so would the narrowest: it stays too, though it
    # comes first in the table (alone it would have joined)
    (4, [(40000, 2, 20), (50000, 2, 20), (45000, 2, 20)], [(40000, 2, 20), (45000, 2, 20)], 6),
    # the same widths in another table order: the same plan
    (4, [(45000, 2, 20), (40000, 2, 20), (50000, 2, 20)], [(45000, 2, 20), (40000, 2, 20)], 6),
    # the 65,536-slot rows join (G = 16); the 132 columns of 32,768 would
    # take G to 1 and keep the cluster body
    (4, [(32768, 2, 132), (65536, 2, 8)], [(32768, 2, 132)], 16),
    # a bucket with no hop (H = 0) adds no column: G stays 13
    (8, [(30000, 2, 10), (30000, 0, 200)], [], 13),
])
def test_route_moves_the_widest_first_and_keeps_g(itemsize, shapes, cluster, G):
    """The route over a whole table: buckets a cluster holds join the L2
    table widest first, each only where the table's G with it stays at least
    L2_FROM_SPLIT, so the plan does not depend on the table's order and its
    own G ends at or above the threshold; the run's L2 table takes every
    bucket past a block's shared memory."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    plan = layout.launch_plan(shapes, dtype, "cpu")
    assert table_rows(plan.launch("huge_cluster")) == cluster
    moved = [s for s in shapes if s not in cluster]
    l2 = plan.launch("huge_l2")
    assert table_rows(l2) == moved
    assert l2.own[0] == G >= layout.L2_FROM_SPLIT
    assert l2.own[0] == layout.choose_l2_split(
        l2.own[1], max(P for P, _, _ in moved), layout.HUGE_THREADS, 132)
    (run,) = plan.runs
    assert table_rows(run) == list(shapes) and run.body == sk.HUGE_L2
    assert run.own[1] == sum(B for _, H, B in shapes if H > 0)


# ------------------------------ rows a block holds, routed by their columns
# the L2 table's G on 132 SMs for rows past WIDE_P that a block holds, by
# width and columns: the layouts the threshold was measured on (chip_smoke.py
# --huge-split route: 16,384 slots in both precisions, the widest a block
# holds, 29,016 in float32 and 19,316 in float64), the narrowest such width,
# and 50 columns (a batch of ten mknap.t25 instances)
BLOCK_SPLITS = {16384: {1: 16, 5: 16, 8: 16, 16: 8, 33: 4, 50: 2, 66: 2, 132: 1},
                29016: {1: 29, 5: 26, 8: 16, 16: 8, 33: 4, 66: 2, 132: 1},
                19316: {1: 19, 5: 19, 8: 16, 16: 8, 33: 4, 66: 2, 132: 1},
                layout.WIDE_P + 1: {1: 9, 5: 9, 33: 4, 66: 2}}
BLOCK_ROUTE = [(P, itemsize, columns, G)
               for P, itemsizes in ((16384, (4, 8)), (29016, (4,)), (19316, (8,)),
                                    (layout.WIDE_P + 1, (4, 8)))
               for itemsize in itemsizes for columns, G in BLOCK_SPLITS[P].items()]


@pytest.mark.parametrize("P,itemsize,columns,G", BLOCK_ROUTE,
                         ids=lambda v: str(v))
def test_route_sends_block_held_rows_by_their_columns(P, itemsize, columns, G):
    """Rows past WIDE_P that a block's shared memory holds: the half-sweeps
    take the L2 body where its G over their columns is at least
    L2_FROM_SPLIT (33 columns and fewer) and the shared-memory huge body
    where it is lower (50 columns and more: knapsack48's 132 rows at G = 1);
    in float32 the cluster body (clusters of 16) instead of the L2 body where
    the card holds a cluster of 16 for every column at once (7 off the card:
    1 and 5 columns, mknap.t25's 5 rows of 16,384 slots among them). The
    run-only entry takes the L2 body for the L2 and the cluster body's
    buckets, at the G of its own table, and the huge body for its own.
    ``body_of`` gives the width's body whatever the columns."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    assert layout.huge_fits(P, itemsize) and P > layout.WIDE_P
    assert layout.body_of(P, itemsize, columns) == "huge"  # the width's
    assert layout.choose_l2_split(columns, P, layout.HUGE_THREADS, 132) == G
    assert layout.cluster_occupancy(itemsize, 16, layout.HUGE_THREADS,
                                    layout.cluster_smem_bytes(P, 16, itemsize), "cpu", 132, P) == 7
    plan = layout.launch_plan([(P, 48, columns)], dtype, "cpu")
    run = plan.launch("huge_l2", run=True)
    if G >= layout.L2_FROM_SPLIT and itemsize == 4 and columns <= 7:
        cluster = plan.launch("huge_cluster")
        assert counts(plan) == (0, 0, 0, 1, 0)
        assert (cluster.own[0], cluster.blocks, cluster.threads) == (
            16, 16 * columns, layout.HUGE_THREADS)
        assert plan.scratch_bytes[0] == 0
        assert counts(plan, run=True) == (0, 0, 0, 0, 1) and run.own[0] == G
    elif G >= layout.L2_FROM_SPLIT:
        l2 = plan.launch("huge_l2")
        assert counts(plan) == (0, 0, 0, 0, 1)
        assert (l2.own, l2.blocks) == ((G, columns), G * columns)
        assert plan.scratch_bytes[0] == -(-2 * P * columns * itemsize // 16) * 16
        assert counts(plan, run=True) == (0, 0, 0, 0, 1)
        assert (run.own, run.blocks) == ((G, columns), G * columns)
    else:
        huge = plan.launch("huge")
        assert counts(plan) == counts(plan, run=True) == (0, 0, 1, 0, 0)
        assert (huge.blocks, huge.own[0], huge.threads) == (columns, P, layout.HUGE_THREADS)
        assert plan.scratch_bytes[0] == 0
    # each body where a plan is built so, all three entries
    for force in ("huge", "huge_l2", "huge_cluster"):
        forced = layout.build_plan([(P, 48, columns)], dtype, "cpu", [force])
        assert counts(forced) == counts(forced, run=True) == tuple(
            int(b == force) for b in layout.BODIES)


@pytest.mark.parametrize("itemsize,shapes,bodies,G", [
    # rows a cluster holds join first (8 columns: G = 16); the rows a block
    # holds would join (13: G = 10), and take the cluster body (5 clusters of
    # 16); the 300 columns of 2,048 float32 slots keep the huge body, alone
    # in its table
    (4, [(2048, 32, 300), (16384, 48, 5), (32768, 48, 8)],
     ["huge", "huge_cluster", "huge_l2"], 16),
    # 132 columns of 32,768 slots keep the cluster body (G = 1), so the rows
    # a block holds find no room there (137 clusters) and join the L2 table
    # alone (G = 16)
    (4, [(2048, 32, 300), (16384, 48, 5), (32768, 48, 132)],
     ["huge", "huge_l2", "huge_cluster"], 16),
    # rows a block holds: the 3 columns of 20,000 slots, the wider, take the
    # cluster body first (3 clusters of 16); with the 8 columns of 16,384 it
    # would hold 11, so those join the L2 table (G = 16)
    (4, [(16384, 48, 8), (20000, 2, 3)], ["huge_l2", "huge_cluster"], 16),
    # beside them 200 columns of 1,024 float32 slots: on the huge table the
    # route leaves behind (500 columns, 4 an SM, its widest block 2,048
    # slots' less than 17 KB) they keep the huge body; with the 16,384-slot
    # rows in it (one 131 KB block an SM) they would take the wide body
    (4, [(2048, 32, 300), (16384, 48, 5), (32768, 48, 8), (1024, 32, 200)],
     ["huge", "huge_cluster", "huge_l2", "huge"], 16),
    # float64 beside rows past a cluster's (2 columns): 19,316 slots join (22
    # columns: G = 6), then 16,384 (32: G = 4)
    (8, [(320000, 2, 2), (16384, 48, 10), (19316, 3, 20), (2048, 32, 300)],
     ["huge_l2", "huge_l2", "huge_l2", "huge"], 4),
    # the rows a cluster holds join (10 columns: G = 13); the 30 columns of
    # 16,384 slots would take G to 3 and keep the huge body
    (8, [(30000, 2, 10), (16384, 4, 30), (2048, 3, 5)], ["huge_l2", "huge", "huge"], 13),
])
def test_route_by_columns_over_a_mixed_table(itemsize, shapes, bodies, G):
    """Rows a block holds and rows a cluster holds past WIDE_P join the L2
    table by one rule, widest first, each while G stays at least
    L2_FROM_SPLIT (float32 rows a block holds take the cluster body instead
    while 7 clusters of 16 hold the cluster table's columns); rows at or
    below WIDE_P (2,048 slots) keep the body of their width, and the huge
    table that is left is planned as a whole (``_route_huge_table``,
    ``_huge_plan``). The run takes the L2 body for the cluster body's
    buckets, the huge body for its own."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    plan = layout.launch_plan(shapes, dtype, "cpu")
    assert layout.route(shapes, itemsize, "cpu")[0] == tuple(bodies)
    for body in ("huge", "huge_cluster", "huge_l2", "wide"):
        assert table_rows(plan.launch(body)) == [s for s, b in zip(shapes, bodies) if b == body]
    assert plan.launch("huge_l2").own[0] == G >= layout.L2_FROM_SPLIT
    huge = [s for s, b in zip(shapes, bodies) if b == "huge"]
    if huge:
        assert plan.launch("huge").smem_forward == max(layout.huge_smem_bytes(P, itemsize)
                                                       for P, _, _ in huge)
        assert plan.launch("huge").threads == layout._huge_plan(huge, itemsize, 132)[0]
    assert table_rows(plan.launch("huge_l2", run=True)) == [
        s for s, b in zip(shapes, bodies) if b in ("huge_l2", "huge_cluster")]
    assert plan.launch("huge_cluster", run=True) is None


@pytest.mark.parametrize("itemsize", [4, 8])
def test_scratch_holds_the_runs_partials_and_counters(itemsize):
    """The layout's scratch also holds the partials and counters of the
    run's own L2 launch, whose table may have more columns and another G
    than the half-sweeps': room for whichever needs more of each, after the
    half-sweeps' key rows; the run reads no key rows. A layout whose
    half-sweeps run no L2 bucket still gets the run's scratch on the card
    (only the twins run off it). The bytes a solve works in count the most
    any plan takes."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    pad = lambda n: -(-n // 16) * 16  # noqa: E731
    # half-sweeps: 320,000 slots over 2 columns, G = 66; the 40 columns of
    # 30,000 slots stay on the cluster body (G would be 3) and join the run's
    # table: 42 columns, G = 3
    shapes = [(320000, 2, 2), (30000, 2, 40)]
    plan = layout.launch_plan(shapes, dtype, "cpu")
    assert plan.launch("huge_l2").own == (66, 2) and counts(plan)[3] == 1
    run = plan.launch("huge_l2", run=True)
    assert (run.own, run.blocks) == ((3, 42), 126)
    rows = 2 * 320000 * 2 * itemsize
    parts, counters, total = plan.scratch_bytes
    assert parts == rows  # the key rows, of the half-sweeps' L2 bucket alone
    assert counters == rows + pad(max(2 * 66 * 2, 2 * 3 * 42) * itemsize)
    assert total == counters + 4 * 42  # the run's 42 counters
    # no L2 bucket in the half-sweeps: the scratch is the run's partials and
    # counters alone (33 columns of 32,768 slots on the cluster body at 132
    # SMs would be G = 4, so 40 columns: G = 3)
    plan = layout.launch_plan([(32768, 48, 40)], dtype, "cpu")
    assert counts(plan) == (0, 0, 0, 1, 0) and plan.launch("huge_l2", run=True).own[0] == 3
    assert plan.scratch_bytes == (
        0, pad(2 * 3 * 40 * itemsize), pad(2 * 3 * 40 * itemsize) + 4 * 40)
    assert layout.huge_scratch(plan, "cpu") is None  # the twins need none
    # a G of 1 for both: nothing but the key rows (here none)
    plan = layout.launch_plan([(32768, 48, 132)], dtype, "cpu")
    assert plan.scratch_bytes == (0, 0, 0)
    # the bytes a solve works in: key rows of every bucket past a block's
    # shared memory, partials and counters of all their columns at
    # L2_MAX_SPLIT, above the plan's own
    E, N = 48 * 40, 48 * 32768 * 40
    base = layout.record_bytes(32768) * E + E * (9 * itemsize + 24) + 2 * N * itemsize
    most = layout.l2_scratch_bytes(2 * 32768 * 40, layout.L2_MAX_SPLIT, 40, itemsize)[2]
    assert layout.solve_bytes([(32768, 48, 40)], itemsize) == base + most
    plan = layout.launch_plan([(32768, 48, 40)], dtype, "cpu")
    assert most >= plan.scratch_bytes[2]


@pytest.mark.parametrize("force,sweeps,run", [
    ({}, sk.HUGE_CLUSTER, sk.HUGE_L2),
    ({"bodies": ["huge_cluster"]}, sk.HUGE_CLUSTER, sk.HUGE_CLUSTER),
    ({"bodies": ["huge_l2"]}, sk.HUGE_L2, sk.HUGE_L2),
    ({"bodies": ["huge_l2"], "l2_split": 2}, sk.HUGE_L2, sk.HUGE_L2),
    ({"l2_split": 2}, sk.HUGE_CLUSTER, sk.HUGE_L2),
])
def test_each_entry_launches_the_body_of_its_route(monkeypatch, force, sweeps, run):
    """What each entry launches (the library replaced by a recorder), on 40
    columns of 30,000 slots: by the route the half-sweeps on the cluster
    body (an L2 table's G would be 3) and the run on the L2 body at G = 3;
    the bodies a plan is built on hold for all three entries, and a forced
    ``l2_split`` for the run's L2 table too."""
    rec = _Recorder()
    monkeypatch.setattr(sk._build, "load", lambda: rec)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    host, (lo, hi, fr, dl, dh) = synthetic_host([(30000, 2, 40)], torch.float32, "cpu")
    geom = host.geom
    if "bodies" in force:
        plan = layout.build_plan(geom.plan.shapes, torch.float32, "cpu", force["bodies"],
                                 l2_split=force.get("l2_split"))
    else:
        plan = routed_plan(geom.plan.shapes, torch.float32, "cpu", l2_split=force.get("l2_split"))
    scratch = torch.empty(plan.scratch_bytes[2], dtype=torch.uint8)
    G = force.get("l2_split", 3)
    for kernel, frontier in (("uniform_forward", fr), ("uniform_backward", fr), (sk.RUN, None)):
        outs = (None, None, None, torch.empty_like(fr)) if kernel == sk.RUN else (
            torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(fr))
        launch = sk._launcher(kernel, plan, geom.arcs, lo, hi, None if frontier is None else dl,
                              None if frontier is None else dh, geom.alpha, 0.5, frontier, outs,
                              scratch)
        body = run if kernel == sk.RUN else sweeps
        assert launch.counts == (kernel + body,)
        launch()
        name, (record,), _, _ = rec.calls[-1]
        assert (name, record.body) == (kernel + "_f32", body)
        if body == sk.HUGE_L2:  # blocks, threads, G, columns
            assert (record.blocks, record.threads, record.own) == (
                40 * G, layout.HUGE_THREADS, (G, 40))
        else:  # blocks, threads, C
            cluster = plan.launch("huge_cluster")
            assert (record.blocks, record.threads, record.own) == (
                cluster.blocks, cluster.threads, cluster.own)


# rows like the benchmark's three cells in float32 (mknap.t50.dual's five
# rows of 32,768 slots, mknap.t25.dual's of 16,384, gap_d60900.dual's 900
# assignment and 60 capacity rows), and their plans as the route gave them
# when the plan kept fields of each body: the route's bodies of the
# half-sweeps and of the run, each entry's launches (body, table, blocks,
# threads, shared memory of the forward and the backward, own integers)
# and the L2 scratch's bytes
CELL_PLANS = {
    "mknap.t50.dual": (
        [(32768, 100, 5)], ("huge_l2",), ("huge_l2",),
        [(sk.HUGE_L2, [[32768, 100, 5, 0, 0, 0, 0, 0]], 130, 1024, 0, 0, (26, 5))],
        [(sk.HUGE_L2, [[32768, 100, 5, 0, 0, 0, 0, 0]], 130, 1024, 0, 0, (26, 5))],
        (1310720, 1311760, 1311780)),
    "mknap.t25.dual": (
        [(16384, 100, 5)], ("huge_cluster",), ("huge_l2",),
        [(sk.HUGE_CLUSTER, [[16384, 100, 5, 0, 0, 0, 0, 2]], 80, 1024, 8640, 12736, (16, 16384))],
        [(sk.HUGE_L2, [[16384, 100, 5, 0, 0, 0, 0, 0]], 80, 1024, 0, 0, (16, 5))],
        (0, 640, 660)),
    "gap_d60900.dual": (
        [(2, 60, 1024), (1024, 900, 64)], ("narrow", "huge"), ("narrow", "huge"),
        [("", [[2, 60, 1024, 0, 0, 0, 0, 8]], 32, 32, 10368, 10368, (32, 2)),
         (sk.HUGE, [[1024, 900, 64, 0, 61440, 122880, 245760, 2]], 64, 1024, 37248, 41344,
          (1024, layout.HUGE_RING_HOPS))],
        None, (0, 0, 0)),
}


@pytest.mark.parametrize("cell", list(CELL_PLANS))
def test_cells_rows_keep_their_plans(cell):
    """The route and the records give rows like each cell's the launches
    they had before the records: the same bodies, tables, grids, shared
    memory, own integers and scratch (the gap cell's run the same launches
    as its half-sweeps)."""
    shapes, bodies, run_bodies, sweeps, runs, scratch = CELL_PLANS[cell]
    assert layout.route(shapes, 4, "cpu") == (bodies, run_bodies)
    plan = layout.launch_plan(shapes, torch.float32, "cpu")

    def fields(launches):
        return [(r.body, r.table.tolist(), r.blocks, r.threads, r.smem_forward, r.smem_backward,
                 r.own) for r in launches]

    assert fields(plan.sweeps) == sweeps
    assert fields(plan.runs) == (sweeps if runs is None else runs)
    assert plan.scratch_bytes == scratch


@pytest.mark.cuda
def test_library_records_are_laid_out_as_their_mirrors(cuda_device):
    """The sizes and field offsets of the library's record and buffers
    structs, which it exports, are those of their ctypes mirrors."""
    import ctypes

    ours = [n for struct in (sk._build.Launch, sk._build.Buffers)
            for n in (ctypes.sizeof(struct), *(getattr(struct, f).offset
                                               for f, _ in struct._fields_))]
    theirs = (ctypes.c_longlong * len(ours)).in_dll(sk._build.load(), "uniform_record_layout")
    assert list(theirs) == ours


@pytest.mark.parametrize("P,itemsize,columns,body", [
    (layout.HUGE_FROM, 4, 4 * 132, "huge"), (layout.HUGE_FROM, 4, 4 * 132 + 1, "wide"),
    (layout.HUGE_FROM, 4, 2048, "wide"), (layout.HUGE_FROM, 8, 2048, "huge"),
    (layout.HUGE_FROM_F32_MANY - 1, 4, 1024, "wide"), (layout.HUGE_FROM_F32_MANY, 4, 2048, "huge"),
    (4096, 4, 2048, "huge"), (layout.WIDE_P, 4, 1 << 14, "huge"), (512, 4, 8, "wide")])
def test_route_follows_the_columns_in_float32(P, itemsize, columns, body):
    """float32 buckets below HUGE_FROM_F32_MANY slots take the huge body only
    while their columns are at most HUGE_F32_BLOCKS_SM an SM (more would
    give a huge block 128 threads or fewer, where the wide body is faster);
    float64 and wider buckets whatever their columns. A plan built on the
    huge body takes it whatever the route, and the route follows the card's
    SMs."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    assert layout.HUGE_F32_BLOCKS_SM == 4
    assert layout.body_of(P, itemsize, columns) == body
    plan = layout.launch_plan([(P, 2, columns)], dtype, "cpu")
    assert counts(plan) == ((0, 1, 0, 0, 0) if body == "wide" else (0, 0, 1, 0, 0))
    forced = layout.build_plan([(P, 2, columns)], dtype, "cpu", ["huge"])
    assert counts(forced) == (0, 0, 1, 0, 0)
    # on a card of fewer SMs the same columns are more an SM
    assert layout.body_of(P, itemsize, 4 * 66 + 1, sms=66) == layout.body_of(
        P, itemsize, 4 * 132 + 1, sms=132)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_huge_plan_shared_memory_is_the_kernels(itemsize):
    """The shared memory the plan gives a huge block is what
    ``uniform_sweep.cu`` carves: [row | second row (backward, two rows) | the
    slot codes, four bytes a slot | 64 values of partials | two ring slots of
    HUGE_SCALARS values], each row padded to 16 bytes. An SM holds as many
    blocks as the columns ask for and the launch's shared memory lets
    reside, and they share its 1,024 threads; the backward keeps a second
    row where that many blocks still fit with it."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    assert layout.sm_count("cpu") == layout.SM_COUNT == 132

    def carved(P, two_rows):
        row = -(-P * itemsize // 16) * 16
        return (row * (1 + two_rows) + -(-4 * P // 16) * 16 + 64 * itemsize
                + 2 * layout.HUGE_SCALARS * itemsize)

    def huge(shapes):  # the huge launch of the route's plan, and its rows
        plan = layout.launch_plan(shapes, dtype, "cpu")
        launch = plan.launch("huge")
        assert counts(plan) == (0, 0, len(shapes), 0, 0)
        return launch, [int(r[7]) for r in launch.table.tolist()]

    # knapsack48: 132 columns of 16,384 slots, one block of 1,024 threads an
    # SM; float32 keeps two backward rows, float64 one
    two = itemsize == 4
    launch, rows = huge([(16384, 48, 132)])
    assert (launch.threads, launch.blocks) == (1024, 132)
    assert launch.smem_forward == carved(16384, False) == layout.huge_smem_bytes(
        16384, itemsize)
    assert launch.smem_backward == carved(16384, two)
    assert rows == [1 + two]
    # routed rows of 8,192 slots over 256 columns: two blocks an SM of 512
    # threads each, as the SM's shared memory allows
    launch, rows = huge([(layout.WIDE_P, 32, 256)])
    assert (launch.threads, launch.blocks) == (512, 256)
    assert launch.smem_forward == carved(layout.WIDE_P, False)
    assert launch.smem_backward == carved(layout.WIDE_P, two)
    assert rows == [1 + two]
    # both in one table (388 columns, three an SM): a block of the launch
    # carves knapsack48's shared memory, so one resides an SM, at 1,024
    # threads, not at the 320 that three blocks would share
    launch, rows = huge([(16384, 48, 132), (layout.WIDE_P, 32, 256)])
    assert (launch.threads, launch.blocks) == (1024, 388)
    assert launch.smem_forward == carved(16384, False)
    assert rows == [1 + two, 2]
    assert launch.smem_backward == max(carved(16384, two), carved(layout.WIDE_P, True))
    # few columns of 4,096 slots: two rows in either precision
    launch, rows = huge([(4096, 3, 8)])
    assert rows == [2] and launch.threads == 1024
    assert launch.smem_forward == carved(4096, False)
    assert launch.smem_backward == carved(4096, True)
    # 2,048 columns of 1,024 slots (the huge body forced in float32): 16
    # blocks an SM of 64 threads; in float64 16 blocks fit only on one row
    # each
    launch = layout.build_plan([(layout.HUGE_FROM, 32, 2048)], dtype, "cpu",
                               ["huge"]).launch("huge")
    assert (launch.threads, launch.blocks, launch.own) == (64, 2048, (layout.HUGE_FROM, 0))
    assert [int(r[7]) for r in launch.table.tolist()] == [1 + two]
    assert 16 * (launch.smem_backward + layout.BLOCK_SMEM_RESERVED) <= layout.SM_SMEM


# shapes that the route sends to the huge body one by one (float32, below
# HUGE_FROM_F32_MANY slots, at most HUGE_F32_BLOCKS_SM columns an SM each)
# but whose huge table as a whole would break its rule: 2,000 columns (16 an
# SM: blocks of 64 threads), and 200 beside knapsack48's rows (whose 131 KB
# block lets one block an SM reside); and few columns, where the rows of
# 16,384 slots leave the huge table by their columns (in float32 for the
# cluster body, 2 clusters of 16; in float64 for the L2 body, G = 16) and
# the huge table left behind keeps the 1,024-slot rows. The float32 bodies,
# and the buckets the float64 route moves to the L2 body
ROUTE_TABLES = {
    "2000-columns": ([(1024, 32, 500), (1536, 40, 500), (1280, 24, 500), (1100, 36, 500)],
                     ["wide"] * 4, 0),
    "beside-knapsack48": ([(1024, 32, 200), (16384, 48, 132)], ["wide", "huge"], 0),
    "few-columns": ([(1024, 3, 5), (16384, 2, 2)], ["huge", "huge_cluster"], 1),
}


@pytest.mark.parametrize("case", list(ROUTE_TABLES))
def test_huge_table_holds_the_route_as_a_whole(case):
    """One launch runs the huge table at one thread count and one block's
    shared memory, so the route's float32 rule (HUGE_F32_BLOCKS_SM columns an
    SM) holds for the table as a whole: a routed float32 bucket below
    HUGE_FROM_F32_MANY slots goes back to the wide body where the table's
    columns are more an SM than that, or than its widest block lets reside.
    float64 buckets stay; a plan built with the huge body in place of the
    wide one takes the launch every one of these ran on before (but those
    the route by columns sends to another body)."""
    shapes, bodies, on_l2 = ROUTE_TABLES[case]
    assert all(layout.body_of(P, 4, B) == "huge" for P, _, B in shapes)
    assert layout.route(shapes, 4, "cpu")[0] == tuple(bodies)
    plan = layout.launch_plan(shapes, torch.float32, "cpu")
    for body in ("wide", "huge", "huge_cluster", "huge_l2"):
        assert table_rows(plan.launch(body)) == [s for s, b in zip(shapes, bodies) if b == body]
    cols = sum(B for _, _, B in shapes if _ < layout.HUGE_FROM_F32_MANY)
    huge = plan.launch("huge")
    if any(b == "huge" and P < layout.HUGE_FROM_F32_MANY for (P, _, _), b in zip(shapes, bodies)):
        assert huge.threads >= layout.HUGE_THREADS // layout.HUGE_F32_BLOCKS_SM
        assert -(-huge.blocks // layout.SM_COUNT) * (
            huge.smem_forward + layout.BLOCK_SMEM_RESERVED) <= layout.SM_SMEM
    if huge:  # the ring form's where one slot a thread (1,024 slots few columns)
        assert huge.smem_forward == max(layout.huge_smem_bytes(P, 4, ring=huge.own[1])
                                        for (P, _, _), b in zip(shapes, bodies) if b == "huge")
    moved = len(shapes) - bodies.count("wide") - bodies.count("huge")
    forced = layout.build_plan(shapes, torch.float32, "cpu",
                               ["huge" if b == "wide" else b for b in bodies])
    assert counts(forced)[1:3] == (0, len(shapes) - moved)
    if case == "2000-columns":  # the launch the four buckets got before
        assert cols == 2000 and forced.launch("huge").threads == 64
    f64 = layout.launch_plan(shapes, torch.float64, "cpu")
    assert counts(f64)[1:] == (0, len(shapes) - on_l2, 0, on_l2)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cluster_plan_shared_memory_is_the_kernels(itemsize):
    """The shared memory the plan gives a block of the cluster body is what
    ``uniform_sweep.cu`` carves: [row of its share S = ceil(P / C) | second
    row (backward, two rows) | the share's slot codes, four bytes a slot
    where the table's widest bucket is below CLUSTER_MAX_P and eight past it
    | 64 values of partials | 32 values of the cluster's pairs (two a block
    of the largest cluster, 16) | two ring slots of HUGE_SCALARS values],
    each row padded to 16 bytes. A column is C blocks, C of CLUSTER_SIZES;
    the threads a block follow the blocks an SM holds, and the C is the one
    of the fewest waves of clusters times slots a thread."""
    dtype = torch.float32 if itemsize == 4 else torch.float64

    def carved(P, C, two_rows, code=4):
        S = -(-P // C)
        row = -(-S * itemsize // 16) * 16
        return (row * (1 + two_rows) + -(-code * S // 16) * 16
                + (64 + 32 + 2 * layout.HUGE_SCALARS) * itemsize)

    def cluster(shapes, size=None):  # the cluster launch of a plan built on the cluster body
        plan = layout.build_plan(shapes, dtype, "cpu", ["huge_cluster"] * len(shapes),
                                 cluster_size=size)
        launch = plan.launch("huge_cluster")
        assert counts(plan) == (0, 0, 0, len(shapes), 0)
        return launch, [int(r[7]) for r in launch.table.tolist()]

    assert layout.CLUSTER_SIZES == (2, 4, 8, 16)
    # knapsack48's L2 rows (P = 32,768 over 132 columns): a block of a
    # cluster of two holds 16,384 slots, one block an SM at 1,024 threads
    routed = layout.launch_plan([(32768, 48, 132)], dtype, "cpu").launch("huge_cluster")
    launch, rows = cluster([(32768, 48, 132)])
    assert (launch.own, launch.threads, launch.blocks) == ((2, 32768), 1024, 264)
    assert (routed.own, routed.threads, routed.smem_backward) == (
        launch.own, launch.threads, launch.smem_backward)
    assert launch.smem_forward == carved(32768, 2, False) == layout.cluster_smem_bytes(
        32768, 2, itemsize)
    two = itemsize == 4  # float64: two rows of 16,384 values do not fit a block
    assert rows == [1 + two]
    assert launch.smem_backward == carved(32768, 2, two)
    # every cluster size, forced: the block's share and the blocks an SM
    for C, threads in ((2, 1024), (4, 1024 // 3 // 32 * 32 if two else 512),
                       (8, 1024 // 6 // 32 * 32 if two else 256), (16, 64 if two else 128)):
        launch, rows = cluster([(32768, 48, 132)], C)
        assert (launch.own[0], launch.blocks) == (C, 132 * C)
        assert launch.smem_forward == carved(32768, C, False)
        resident = min(C, layout.SM_SMEM // (launch.smem_forward + layout.BLOCK_SMEM_RESERVED))
        assert launch.threads == threads == 1024 // resident // 32 * 32
        assert launch.smem_backward == carved(32768, C, rows[0] == 2)
        assert resident * (launch.smem_backward + layout.BLOCK_SMEM_RESERVED) <= (
            layout.SM_SMEM)
    # one column and a ragged width: the largest cluster, its last block
    # holding fewer slots; two buckets in one table share the widest's block
    launch, rows = cluster([(30001, 2, 1), (20001, 3, 2)])
    assert (launch.nr_buckets, launch.own, launch.threads) == (2, (16, 30001), 1024)
    assert [r[3] for r in launch.table.tolist()] == [0, 16]
    assert launch.blocks == 16 * 3
    assert launch.smem_forward == carved(30001, 16, False)
    assert rows == [2, 2] and launch.smem_backward == carved(30001, 16, True)
    # rows of 65,536 slots over 8 columns (knapsack L2 wide), which the route
    # gives the L2 body, on the cluster body: eight-byte codes, clusters of 8
    # at one block an SM, two backward rows: the card holds 15 such clusters
    # at once but only 7 of 16 (two waves of 16, a tie broken to the smaller
    # C)
    assert counts(layout.launch_plan([(65536, 48, 8)], dtype, "cpu"))[3] == 0
    launch, rows = cluster([(65536, 48, 8)])
    assert (launch.own, launch.threads, launch.blocks) == ((8, 65536), 1024, 64)
    assert launch.smem_forward == carved(65536, 8, False, 8) == layout.cluster_smem_bytes(
        65536, 8, itemsize)
    assert rows == [2] and launch.smem_backward == carved(65536, 8, True, 8)
    # forced to clusters of 16 (128 blocks); of 4 only in float32 (a float64
    # block of 16,384 slots with eight-byte codes does not fit)
    launch, rows = cluster([(65536, 48, 8)], 16)
    assert (launch.own[0], launch.blocks, launch.threads) == (16, 128, 1024)
    assert launch.smem_forward == carved(65536, 16, False, 8)
    assert rows == [2] and launch.smem_backward == carved(65536, 16, True, 8)
    if two:
        launch, rows = cluster([(65536, 48, 8)], 4)
        assert launch.smem_forward == carved(65536, 4, False, 8)
        assert rows == [1] and launch.smem_backward == carved(65536, 4, False, 8)
    else:
        with pytest.raises(ValueError, match="no cluster of 4 blocks holds a bucket of 65536"):
            cluster([(65536, 48, 8)], 4)
    # a narrower bucket beside a wider one takes the widest's eight-byte codes
    launch, rows = cluster([(65536, 2, 1), (30000, 3, 2)])
    assert (launch.nr_buckets, launch.own) == (2, (16, 65536))
    assert launch.smem_forward == carved(65536, 16, False, 8)
    assert rows == [2, 2] and launch.smem_backward == carved(65536, 16, True, 8)
    assert layout.cluster_smem_bytes(30000, 16, itemsize, True, pmax=65536) == carved(
        30000, 16, True, 8)
    # a width no block of the largest cluster holds is refused
    widest = 309312 if two else 231552
    assert layout.cluster_smem_bytes(widest, 16, itemsize) <= layout.MAX_DYNAMIC_SMEM
    assert layout.cluster_smem_bytes(widest + 1, 16, itemsize) > layout.MAX_DYNAMIC_SMEM
    with pytest.raises(ValueError, match="no cluster"):
        layout._cluster_plan([(widest + 1, 2, 1)], itemsize, 132, "cpu", None)
    # off the card, the clusters held at once: the blocks an SM holds by
    # shared memory and threads, in whole clusters within each GPC (a cluster
    # is placed within one); at one block an SM what the card answers
    assert sum(layout.GPC_SMS) == layout.SM_COUNT == 132
    assert [layout.cluster_occupancy(itemsize, C, 1024, 131000, "cpu", 132, 32768)
            for C in layout.CLUSTER_SIZES] == [66, 30, 15, 7]
    assert layout.cluster_occupancy(itemsize, 4, 256, 60000, "cpu", 132, 32768) == 96
    assert layout.cluster_occupancy(itemsize, 16, 256, 30000, "cpu", 132, 65536) == 30
    assert layout.cluster_occupancy(itemsize, 16, 1024, 60000, "cpu", 64, 65536) == 4


def _cluster_block(slot, S, wide):
    """The kernel's ``Share::block`` (uniform_sweep.cu) in numpy: the high
    word of slot * magic, magic = 0xffffffff / S + 1 = ceil(2^32 / S) as the
    kernel computes it, less one where that is past the slot with
    eight-byte codes (``wide``)."""
    slot = np.asarray(slot, dtype=np.uint64)
    S = np.asarray(S, dtype=np.uint64)
    magic = (np.uint64(0xFFFFFFFF) // S + np.uint64(1)) & np.uint64(0xFFFFFFFF)
    q = (slot * magic) >> np.uint64(32)
    if wide:
        q = q - (q * S > slot).astype(np.uint64)
    return q


def test_cluster_block_formula_finds_every_slot():
    """A child's block in its cluster and its place there come from its slot
    by a multiply (``Share::block``), evaluated here as the kernel does it:
    over every slot of every (P, C) the plan can give the cluster body (every
    power-of-two width from 16,384 slots to the widest a cluster holds, the
    limits of either slot code and precision, the widths of the tests), at
    every C whose block holds its share, block = slot // S and place = slot %
    S within the cluster. Four-byte codes (a table whose widest bucket is
    below CLUSTER_MAX_P) take the multiply alone, eight-byte codes (any
    bucket of a table past it) with its correction. Then every share S the
    plan can give, at the last slot of each block, where the multiply's
    excess is largest: the correction is needed there (without it the
    multiply is one block too far at some of them)."""
    widths = {1 << k for k in range(14, 19)} | {
        19317, 20001, 29017, 30000, 30001, 40000, 65536, 70000, layout.CLUSTER_MAX_P,
        layout.CLUSTER_MAX_P + 1, 231552, 309312}
    checked = 0
    for P in sorted(widths):
        slot = np.arange(P, dtype=np.uint64)
        for itemsize in (4, 8):
            for C in layout.CLUSTER_SIZES:
                if layout.cluster_smem_bytes(P, C, itemsize) > layout.MAX_DYNAMIC_SMEM:
                    continue
                S = -(-P // C)
                for wide in ((False, True) if P <= layout.CLUSTER_MAX_P else (True,)):
                    q = _cluster_block(slot, S, wide)
                    np.testing.assert_array_equal(q, slot // np.uint64(S))
                    assert int(q.max()) < C and int((slot - q * np.uint64(S)).max()) < S
                    checked += 1
    assert checked > 60
    # every share: the last slot of each block of the largest cluster
    # (eight-byte codes: S up to 19,332, float32 at C = 16) and, for
    # four-byte codes, every block's last slot below CLUSTER_MAX_P
    S = np.arange(-(-(layout.WIDE_P + 1) // 16), 19333, dtype=np.uint64)[:, None]
    last = np.arange(1, 17, dtype=np.uint64)[None, :] * S - np.uint64(1)
    np.testing.assert_array_equal(_cluster_block(last, S, True), last // S)
    assert (_cluster_block(last, S, False) != last // S).any()
    S = np.arange(-(-(layout.WIDE_P + 1) // 16), -(-layout.CLUSTER_MAX_P // 2) + 1,
                  dtype=np.uint64)[:, None]
    last = np.arange(1, 17, dtype=np.uint64)[None, :] * S - np.uint64(1)
    below = last < np.uint64(layout.CLUSTER_MAX_P)
    np.testing.assert_array_equal(_cluster_block(last, S, False)[below], (last // S)[below])


@pytest.mark.cuda
def test_eight_byte_codes_find_every_block_on_the_card(cuda_device):
    """The kernel's correction step on the card: a float32 bucket of 264,768
    slots holds only in clusters of 16 (shares of 16,548 slots), where the
    bare multiply puts the last slot one block past the cluster. Arcs into
    that slot and into every block's last slot, from every hop, and the
    kernels against the twins bit for bit: both half-sweeps and the run."""
    P, H, B, C = 264768, 3, 1, 16
    S = P // C
    slots = np.arange(P, dtype=np.uint64)
    assert np.nonzero(_cluster_block(slots, S, False) != slots // np.uint64(S))[0].tolist() == [
        P - 1]
    rng = np.random.RandomState(21)
    b = random_bucket(P, H, B, rng)
    b["node_valid"][1:, P - 1] = True
    b["lo_kind"][0, 0], b["lo_slot"][0, 0] = layout.ARC_INTERNAL, P - 1
    b["lo_kind"][1, :1000], b["lo_slot"][1, :1000] = layout.ARC_INTERNAL, P - 1
    b["hi_kind"][1, 1000:1000 + C] = layout.ARC_INTERNAL
    b["hi_slot"][1, 1000:1000 + C, 0] = np.arange(1, C + 1) * S - 1
    host = layout._build_host([b], np.ones(4, np.int64), 4, 4, 1, torch.float32, cuda_device)
    lo, hi, fr, dl, dh = random_costs(host.geom, rng, cuda_device)
    geom = host.geom
    assert counts(geom.plan) == (0, 0, 0, 0, 1)  # one column: the route's L2 body
    plan = layout.build_plan(geom.plan.shapes, torch.float32, cuda_device, ["huge_cluster"])
    assert counts(plan) == (0, 0, 0, 1, 0) and plan.launch("huge_cluster").own[0] == C
    assert layout.cluster_code_bytes(plan.launch("huge_cluster").own[1]) == 8
    for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                         ("uniform_backward", uf.bucket_backward_iteration)):
        launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
        launch()
        torch.cuda.synchronize()
        assert_same_bits(out, twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh))
    launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
    launch()
    torch.cuda.synchronize()
    assert_same_bits([out], [geom.flatten_nodes([
        uf.bucket_backward_run(g, a, c)
        for g, a, c in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])])


def test_layout_past_the_cards_memory_is_refused_naming_the_bytes(monkeypatch):
    """The one limit left on a width is device memory: a layout that does not
    fit the card's free memory is refused before anything is uploaded, with
    the bytes it needs (``layout.solve_bytes``) in the message."""
    shapes = [(1 << 20, 40, 132)]
    need = layout.solve_bytes(shapes, 4)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (need - 1, 2 * need))
    with pytest.raises(MemoryError, match=f"needs {need} bytes .* {need - 1} of {2 * need} free"):
        layout._check_device_memory(shapes, 4, torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (need, 2 * need))
    layout._check_device_memory(shapes, 4, torch.device("cuda", 0))
    layout._check_device_memory(shapes, 4, torch.device("cpu"))  # no limit off the card


@pytest.mark.parametrize("cached", [0, 1, 1 << 30])
def test_memory_the_allocator_caches_counts_as_free(monkeypatch, cached):
    """A warm process keeps freed tensors' memory in PyTorch's caching
    allocator, which the driver's free figure leaves out: that memory counts
    as free, so a layout that fits it is not refused."""
    shapes = [(1 << 20, 40, 132)]
    need = layout.solve_bytes(shapes, 4)
    free = need - 1
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (free, 2 * need))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 7 << 30)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: (7 << 30) + cached)
    if cached:
        layout._check_device_memory(shapes, 4, torch.device("cuda", 0))
    else:
        with pytest.raises(MemoryError, match=f"{free} of {2 * need} free and 0 cached"):
            layout._check_device_memory(shapes, 4, torch.device("cuda", 0))


@pytest.mark.cuda
def test_layout_fits_memory_held_in_the_allocators_cache(cuda_device):
    """On the card: fill the allocator's cache with a freed tensor, so that
    the driver reports less free memory than the layout needs, and the check
    still passes."""
    free, _ = torch.cuda.mem_get_info(cuda_device)
    hold = torch.empty(free - (1 << 30), dtype=torch.uint8, device=cuda_device)
    del hold  # back to the cache, not to the driver
    free, _ = torch.cuda.mem_get_info(cuda_device)
    shapes = [(16384, 48, 1 + (4 << 30) // layout.solve_bytes([(16384, 48, 1)], 8))]
    assert free < layout.solve_bytes(shapes, 8) < free + torch.cuda.memory_reserved(cuda_device)
    layout._check_device_memory(shapes, 8, cuda_device)
    torch.cuda.empty_cache()


def test_huge_buckets_pad_no_columns():
    """Columns pad to TPU lanes (128) as in the JAX package, else to 8,
    except in a huge bucket, whose body runs a block a column: there not at
    all, in the flattening (``lane_pad``) and in the column packing's cost
    model alike (``csrc/bdd_host.cpp`` pads so too)."""
    assert layout.lane_pad(132, 8192) == 256 and layout.lane_pad(132, 8193) == 132
    assert layout.lane_pad(100, 2) == 104 and layout.lane_pad(100, 16384) == 100
    assert layout.lane_pad(132, 2, lanes=64) == 192 and layout.lane_pad(5, 8193, lanes=64) == 5
    deps = np.full(132, 48)
    assert layout._pack_eval(deps, 48, 8192)[4] == 256
    assert layout._pack_eval(deps, 48, 16384)[4] == 132


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_mixed_layout_counts_three_launches(cuda_device, precision):
    """Narrow, wide and huge buckets in one layout: three launches per
    half-sweep and per run, against the twins bucket by bucket (40 columns
    each past WIDE_P: with either, the L2 table's G would be 3, so the route
    keeps both on the huge body)."""
    dtype = torch.float32 if precision == "float" else torch.float64
    shapes = [(2, 9, 70), (8200, 3, 40), (128, 5, 9), (16384, 2, 40)]
    host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=4)
    geom = host.geom
    assert geom.huge_scratch is None  # both huge buckets keep their rows in shared memory
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    out_f = sk.forward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    out_b = sk.backward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    run = sk.backward_run_cuda(geom, lo, hi)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == launches(narrow=1, wide=1, huge=1, run=1, run_wide=1, run_huge=1)
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls  # no plain version on the card
    assert_same_bits(out_f, twins_bucket_by_bucket(
        uf.bucket_forward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits(out_b, twins_bucket_by_bucket(
        uf.bucket_backward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits([run], [geom.flatten_nodes([
        uf.bucket_backward_run(g, a, b)
        for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("threads", [32, 256, 512, 1024])
def test_huge_body_thread_counts_equal_twins(cuda_device, precision, threads):
    """The three huge forms at forced threads a block (one warp up to the
    largest block): both half-sweeps and the run against their plain
    versions. The shared-memory body over every wide and huge shape (the
    wide ones routed to it, on their two-byte records), the L2 body over the
    huge, cluster and L2 shapes, the cluster body over the huge shapes and
    the cluster shapes of four-byte slot codes at every cluster size (ragged
    against each), and with those of eight-byte codes (65,536 and 70,000
    slots: every bucket of the table takes them) at 8 and 16."""
    dtype = torch.float32 if precision == "float" else torch.float64
    fits = WIDE_SHAPES + HUGE_SHAPES + ROUTED_SHAPES
    four = HUGE_SHAPES + [s for s in CLUSTER_SHAPES if s[0] <= layout.CLUSTER_MAX_P]
    eight = HUGE_SHAPES + CLUSTER_SHAPES
    for shapes, body, C in ((fits, "huge", None), (eight + L2_SHAPES, "huge_l2", None),
                            *((four, "huge_cluster", C) for C in layout.CLUSTER_SIZES),
                            *((eight, "huge_cluster", C) for C in (8, 16))):
        host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=13)
        geom = host.geom
        plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, [body] * len(shapes),
                                 cluster_size=C)
        assert counts(plan) == tuple(len(shapes) * (b == body) for b in layout.BODIES)
        if body == "huge_cluster":
            assert plan.launch(body).own[0] == C
            assert layout.cluster_code_bytes(plan.launch(body).own[1]) == (
                8 if shapes is eight else 4)
        plan = with_threads(plan, body, threads)
        for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                             ("uniform_backward", uf.bucket_backward_iteration)):
            launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
            launch()
            torch.cuda.synchronize()
            assert_same_bits(out, twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh))
        launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
        launch()
        torch.cuda.synchronize()
        assert_same_bits([out], [geom.flatten_nodes([
            uf.bucket_backward_run(g, a, b)
            for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_huge_body_shared_memory_rows_equal_twins(cuda_device, precision):
    """The shared-memory huge body with its backward on one row and on two in
    one launch, as the plan's fit gives them: over the huge, routed, cluster
    and L2 shapes with the body of each width (``body_of``; the route would give
    the L2 body every one past WIDE_P: their few columns), one row where two
    do not fit a block (float32 at 20,001 slots, float64 at 16,384), and the
    cluster and the L2 body beside them.
    Then the cluster body in clusters of two, where a block's share of the
    wider bucket fits one row only and the narrower one's two (float32 40,000
    and 30,000 slots, float64 30,000 and 20,001)."""
    dtype = torch.float32 if precision == "float" else torch.float64
    two_row_shapes = [(40000, 2, 2), (30000, 3, 1)] if precision == "float" else [
        (30000, 2, 2), (20001, 3, 1)]
    itemsize = 4 if precision == "float" else 8
    for shapes, cluster in ((HUGE_SHAPES + ROUTED_SHAPES + CLUSTER_SHAPES + L2_SHAPES, None),
                            (two_row_shapes, 2)):
        host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=17)
        geom = host.geom
        bodies = ["huge_cluster"] * len(shapes) if cluster else [
            layout.body_of(P, itemsize, B) for P, _, B in shapes]
        plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, bodies,
                                 cluster_size=cluster)
        if cluster:
            assert counts(plan)[3] == 2 and plan.launch("huge_cluster").own[0] == 2
            assert [int(r[7]) for r in plan.launch("huge_cluster").table.tolist()] == [1, 2]
        else:  # float32 holds 20,001 slots in a block, float64 in a cluster
            assert sorted(set(int(r[7]) for r in plan.launch("huge").table.tolist())) == [1, 2]
            assert counts(plan)[3:] == ((3, 1) if precision == "float" else (4, 1))
        for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                             ("uniform_backward", uf.bucket_backward_iteration)):
            launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
            launch()
            torch.cuda.synchronize()
            assert_same_bits(out, twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh))
        launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
        launch()
        torch.cuda.synchronize()
        assert_same_bits([out], [geom.flatten_nodes([
            uf.bucket_backward_run(g, a, b)
            for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])])


def run_ref(geom, lo, hi):
    return geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
        geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])


# ------------------------------------ the shared-memory huge body's ring form
# Tables whose every bucket is no wider than a block's threads (one slot a
# thread: the ring form), a bucket each of H = 1, 2, S, S + 1 and 900 hops
# (S = HUGE_RING_HOPS): 1,024 slots at 1,024 threads (the gap layout's
# capacity rows); ragged widths whose records and rows no 16-byte copy takes
# (4P bytes of 4 and 8 modulo 16: the 4- and 8-byte copies); widths far below
# the threads; the same at the threads the widest asks for (64)
_S = layout.HUGE_RING_HOPS
RING_TABLES = {
    "P1024": ([(1024, 1, 2), (1024, 2, 3), (1024, _S, 1), (1024, _S + 1, 2), (1024, 900, 4)],
              None),
    "ragged": ([(999, 1, 1), (1001, 2, 2), (1022, _S, 1), (997, _S + 1, 3), (1001, 900, 2)],
               None),
    "small": ([(40, 1, 2), (33, 2, 5), (64, _S, 3), (48, _S + 1, 2), (40, 900, 2)], None),
    "small-64-threads": ([(40, 1, 2), (33, 2, 5), (64, _S, 3), (48, _S + 1, 2), (40, 900, 2)],
                         64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("weights", ["scalar", "learned"])
@pytest.mark.parametrize("table", list(RING_TABLES))
def test_ring_form_equals_twins_and_the_grouped_body(cuda_device, monkeypatch, table, weights,
                                                     precision):
    """The shared-memory huge body's ring form over RING_TABLES: both
    half-sweeps and the run, plain and counting forms (every profiled launch
    counted where the counting entries hold as many blocks an SM), bit for
    bit the twins' and the grouped body's on the same table and threads (a
    plan built with ``ring_hops=0``), with restart flags (packed
    roots) and a padding column in every bucket of more than one; with
    ``learned`` the learned path's per-layer alpha and omega arrays."""
    from torch.profiler import ProfilerActivity, profile

    dtype = torch.float32 if precision == "float" else torch.float64
    shapes, threads = RING_TABLES[table]
    host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=len(table),
                                                padded=True)
    geom = host.geom
    plans = [layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["huge"] * len(shapes),
                               ring_hops=ring) for ring in (None, 0)]
    if threads:
        plans = [with_threads(p, "huge", threads) for p in plans]
    assert [counts(p) for p in plans] == [(0, 0, len(shapes), 0, 0)] * 2
    assert [p.launch("huge").own[1] for p in plans] == [layout.HUGE_RING_HOPS, 0]
    omega, alpha = 0.5, None
    if weights == "learned":
        rng = np.random.RandomState(5)
        omega = torch.from_numpy(rng.uniform(0.1, 1.0, geom.plan.E)).to(cuda_device, dtype)
        alpha = torch.from_numpy(rng.choice([1.0, 0.5, 1 / 3, 0.25], geom.plan.E)).to(
            cuda_device, dtype)
    refs = {
        "uniform_forward": twins_bucket_by_bucket(uf.bucket_forward_iteration, geom, lo, hi, fr,
                                                  omega, dl, dh, alpha),
        "uniform_backward": twins_bucket_by_bucket(uf.bucket_backward_iteration, geom, lo, hi,
                                                   fr, omega, dl, dh, alpha),
        sk.RUN: [run_ref(geom, lo, hi)]}
    monkeypatch.setitem(sk.COUNT_EVERY, sk.HUGE, 1)
    for plan in plans:
        # the counting entries where they hold as many blocks an SM (at 1,024
        # threads always: one block an SM)
        fits = sk._counting_fits(plan.launch("huge"), lo.element_size(), cuda_device)
        assert fits or threads
        for kernel, ref in refs.items():
            if kernel == sk.RUN:
                launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
                out = [out]
            else:
                launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, omega, dl, dh,
                                                      plan, alpha=alpha)
            launch()
            torch.cuda.synchronize()
            assert_same_bits(out, ref)
            for o in out:
                o.fill_(7.0)
            counted, cycles = sk.COUNTED[sk.HUGE, kernel], sk.huge_wait_cycles()[kernel][1]
            with profile(activities=[ProfilerActivity.CPU]):
                launch()
                torch.cuda.synchronize()
            assert sk.COUNTED[sk.HUGE, kernel] == counted + fits
            assert (sk.huge_wait_cycles()[kernel][1] > cycles) == fits  # the counting form ran
            assert_same_bits(out, ref)


def test_split_variants_still_patch_the_grouped_body():
    """chip_smoke.py's ``--huge-split`` variants replace exact lines of the
    kernel source (SPLIT_PATCHES): every line they replace is there once
    (the ring form left the grouped body's source as it was), so each
    variant's source builds from this one."""
    import chip_smoke
    from bdd_tpu_torch import _build

    with open(_build.SOURCE) as fh:
        src = fh.read()
    for name, pairs in chip_smoke.SPLIT_PATCHES.items():
        assert all(src.count(old) == 1 for old, _ in pairs), name
        assert chip_smoke.split_source(name) != src


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_ring_form_refuses_a_bucket_wider_than_its_threads(cuda_device, precision):
    """The ring form refuses (code -2) a record whose widest bucket is wider
    than its threads, and (-1) less shared memory than its layout's, and the
    entry names the record that failed; a plan whose threads were cut below
    its widest bucket takes the grouped body, which then runs it bit for
    bit."""
    import ctypes

    dtype = torch.float32 if precision == "float" else torch.float64
    host, (lo, hi, fr, dl, dh) = synthetic_host([(2, 3, 8), (1024, 3, 2)], dtype, cuda_device,
                                                seed=3)
    geom = host.geom
    plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["narrow", "huge"])
    huge = plan.launch("huge")
    assert huge.own == (1024, layout.HUGE_RING_HOPS)
    cut = with_threads(plan, "huge", 512)
    assert cut.launch("huge").own == (1024, 0)
    launch, out = sk.prepare_fused_launch("uniform_forward", geom, lo, hi, fr, 0.5, dl, dh, cut)
    launch()
    torch.cuda.synchronize()
    assert_same_bits(out, twins_bucket_by_bucket(uf.bucket_forward_iteration, geom, lo, hi, fr,
                                                 0.5, dl, dh))
    short = dataclasses.replace(plan, sweeps=(plan.sweeps[0], dataclasses.replace(
        huge, smem_forward=huge.smem_forward - 16)))
    launch, _ = sk.prepare_fused_launch("uniform_forward", geom, lo, hi, fr, 0.5, dl, dh, short)
    with pytest.raises(RuntimeError, match="uniform_forward_huge_f.. launch failed .code -1"):
        launch()
    suffix = "f32" if precision == "float" else "f64"
    records = (sk._build.Launch * 2)(*sk._records(plan, False, None))
    records[1].threads = 512  # the ring form at 512 threads over 1,024 slots
    buffers = sk._build.Buffers(
        geom.arcs.data_ptr(), lo.data_ptr(), hi.data_ptr(), dl.data_ptr(), dh.data_ptr(),
        geom.alpha.data_ptr(), None, 0.5, fr.data_ptr(),
        *(torch.empty_like(x).data_ptr() for x in (lo, lo, lo, fr)))
    failed = ctypes.c_int(-1)
    rc = getattr(sk._build.load(), f"uniform_forward_{suffix}")(
        records, 2, ctypes.byref(buffers), torch.cuda.current_stream().cuda_stream,
        ctypes.byref(failed))
    assert (rc, failed.value) == (-2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("split", [None, 1, 2, 3, 7])
def test_l2_body_at_each_split_equals_twins_bit_for_bit(cuda_device, precision, split):
    """The L2 body at the plan's G and at forced G of 1 (a block a column),
    2 and odd ones, over two buckets of different H in one table (the hop
    barriers count per column), with rows that restart past hop 0: the
    forward, the backward and the run against the twins bit for bit, on
    random costs and on costs whose NaN and signed zeros reach a frontier."""
    dtype = torch.float32 if precision == "float" else torch.float64
    itemsize = 4 if precision == "float" else 8
    host, costs = synthetic_host(L2_SHAPES + [(250000, 3, 2)], dtype, cuda_device, seed=23)
    geom = host.geom
    plan = layout.build_plan(geom.plan.shapes, dtype, cuda_device, ["huge_l2"] * 2,
                             l2_split=split)
    resident = layout.block_occupancy(itemsize, sk.HUGE_L2, layout.HUGE_THREADS,
                                      cuda_device) * layout.sm_count(cuda_device)
    l2 = plan.launch("huge_l2")
    assert (l2.nr_buckets, l2.own[1]) == (2, 3)
    assert l2.own[0] == (split or layout.choose_l2_split(3, 320000, 1024, resident))
    assert l2.blocks == 3 * l2.own[0]
    assert any(bool(g.roots[1:].any()) for g in geom.buckets)  # restarts past hop 0
    for zero_costs in (None, False, True):
        lo, hi, fr, dl, dh = costs if zero_costs is None else nan_and_zero_costs(costs, zero_costs)
        seen_nan = False
        for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                             ("uniform_backward", uf.bucket_backward_iteration)):
            launch, out = sk.prepare_fused_launch(kernel, geom, lo, hi, fr, 0.5, dl, dh, plan)
            launch()
            torch.cuda.synchronize()
            ref = twins_bucket_by_bucket(twin, geom, lo, hi, fr, 0.5, dl, dh)
            assert_same_bits(out, ref)
            seen_nan = seen_nan or bool(torch.isnan(ref[3]).any())
        if zero_costs is not None:
            assert seen_nan  # the case is what it says: a NaN went through a frontier
        launch, out = sk.prepare_run_launch(geom, lo, hi, plan)
        launch()
        torch.cuda.synchronize()
        assert_same_bits([out], [run_ref(geom, lo, hi)])


def rootless_hosts(dtype, device, P=262144, H=4, B=2):
    """The same random bucket, unpacked and packed, with random costs,
    whose column 0 starts at a root row that holds no root: row 0 a valid
    layer of every column (so its records flag a root row, as an unpacked
    layout flags the valid layers of row 0) but column 0's slot 0 empty.
    No layout builds one (a BDD's first layer holds its root at slot 0);
    the records of both are the same bytes."""
    hosts = []
    for packed in (False, True):
        rng = np.random.RandomState(31)
        bucket = random_bucket(P, H, B, rng, packed)
        bucket["layer_valid"][0] = True
        bucket["layer_var"][0] = np.arange(B) % 4
        bucket["alpha"][0] = 0.5
        bucket["layer_bdd"][0] = 0
        bucket["node_valid"][0, 0] = True
        bucket["node_valid"][0, 0, 0] = False
        if packed:
            bucket["root_mask"] = layout.root_rows(bucket["layer_valid"], None)
        host = layout._build_host([bucket], np.ones(4, np.int64), 4, 4, 1, dtype, device)
        hosts.append((host, random_costs(host.geom, rng, device)))
    return hosts


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("split", [None, 1, 2, 3])
def test_l2_body_restarts_a_rootless_root_row_at_each_split(cuda_device, precision, split):
    """A root row that holds no root, at the plan's G and at G of 1, 2 and 3:
    the L2 body restarts the frontier there as every body does (0 at slot 0,
    the packed twins' restart), whatever the split. So the forward, the
    backward and the run equal the packed twins bit for bit, and the forward
    differs from the unpacked twins, whose first row is 0 at the valid slots
    of row 0 (here none), at that one slot alone."""
    dtype = torch.float32 if precision == "float" else torch.float64
    itemsize = 4 if precision == "float" else 8
    (plain, costs), (packed, same_costs) = rootless_hosts(dtype, cuda_device)
    lo, hi, fr, dl, dh = costs
    assert all(torch.equal(x, y) for x, y in zip(costs, same_costs))
    assert torch.equal(plain.geom.arcs, packed.geom.arcs)  # one bucket to the kernels
    assert not plain.geom.buckets[0].packed and packed.geom.buckets[0].packed
    plan = layout.build_plan(plain.geom.plan.shapes, dtype, cuda_device, ["huge_l2"],
                             l2_split=split)
    resident = layout.block_occupancy(itemsize, sk.HUGE_L2, layout.HUGE_THREADS,
                                      cuda_device) * layout.sm_count(cuda_device)
    assert counts(plan) == (0, 0, 0, 0, 1) and plan.launch("huge_l2").own[0] == (
        split or layout.choose_l2_split(2, 262144, layout.HUGE_THREADS, resident))
    for kernel, twin in (("uniform_forward", uf.bucket_forward_iteration),
                         ("uniform_backward", uf.bucket_backward_iteration)):
        launch, out = sk.prepare_fused_launch(kernel, plain.geom, lo, hi, fr, 0.5, dl, dh, plan)
        launch()
        torch.cuda.synchronize()
        assert_same_bits(out, twins_bucket_by_bucket(twin, packed.geom, lo, hi, fr, 0.5, dl, dh))
        ref = twins_bucket_by_bucket(twin, plain.geom, lo, hi, fr, 0.5, dl, dh)
        assert_same_bits(out[:3], ref[:3])
        got, want = (plain.geom.per_bucket_nodes(x)[0] for x in (out[3], ref[3]))
        bits = torch.int32 if precision == "float" else torch.int64
        differ = (got.view(bits) != want.view(bits)) & ~(torch.isnan(got) & torch.isnan(want))
        if kernel == "uniform_forward":
            assert differ.nonzero().tolist() == [[0, 0, 0]]
            assert (got[0, 0, 0].item(), want[0, 0, 0].item()) == (0.0, float("inf"))
            assert not torch.signbit(got[0, 0, 0])
        else:
            assert not differ.any()
    launch, out = sk.prepare_run_launch(plain.geom, lo, hi, plan)
    launch()
    torch.cuda.synchronize()
    assert_same_bits([out], [run_ref(plain.geom, lo, hi)])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_l2_split_past_the_cards_residency_raises(cuda_device, precision):
    """A G whose grid the card cannot place at once: the cooperative launch
    is refused and each entry raises, with no hang and no fallback (to G = 1,
    the twins or the CPU); the plan's own G launches right after it and
    equals the twins."""
    dtype = torch.float32 if precision == "float" else torch.float64
    itemsize = 4 if precision == "float" else 8
    host, (lo, hi, fr, dl, dh) = synthetic_host([(320000, 2, 2)], dtype, cuda_device, seed=29)
    geom = host.geom
    resident = layout.block_occupancy(itemsize, sk.HUGE_L2, layout.HUGE_THREADS,
                                      cuda_device) * layout.sm_count(cuda_device)
    too_many = resident // 2 + 1
    assert too_many <= layout.L2_MAX_SPLIT
    plan = routed_plan(geom.plan.shapes, dtype, cuda_device, l2_split=too_many)
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    for launch, _ in (sk.prepare_fused_launch("uniform_forward", geom, lo, hi, fr, 0.5, dl, dh,
                                              plan),
                      sk.prepare_fused_launch("uniform_backward", geom, lo, hi, fr, 0.5, dl, dh,
                                              plan),
                      sk.prepare_run_launch(geom, lo, hi, plan)):
        with pytest.raises(RuntimeError, match="launch failed"):
            launch()
    torch.cuda.synchronize()
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    assert geom.plan.launch("huge_l2").own[0] == min(resident // 2, layout.L2_MAX_SPLIT)
    out = sk.forward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    run = sk.backward_run_cuda(geom, lo, hi)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {**launches(), "uniform_forward" + sk.HUGE_L2: 1, sk.RUN + sk.HUGE_L2: 1}
    assert_same_bits(out, twins_bucket_by_bucket(
        uf.bucket_forward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits([run], [run_ref(geom, lo, hi)])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("columns,G", [(132, 1), (40, 3)])
def test_run_on_its_own_route_equals_the_twin(cuda_device, precision, columns, G):
    """A layout whose half-sweeps run on the cluster body (its columns too
    many for the L2 body's G to reach L2_FROM_SPLIT): the run-only entry
    takes the L2 body at its own table's G (1 a column at 132 columns, a
    cooperative launch of 3 at 40), through the fused and the one-bucket
    wrapper, and equals the plain run bit for bit; the half-sweeps launch
    the cluster body and equal the twins; no plain version on the card."""
    dtype = torch.float32 if precision == "float" else torch.float64
    P = 30000 if precision == "float" else 20001  # past a block's shared memory
    host, (lo, hi, fr, dl, dh) = synthetic_host([(P, 3, columns)], dtype, cuda_device, seed=31)
    geom = host.geom
    plan = geom.plan
    assert counts(plan) == (0, 0, 0, 1, 0) and counts(plan, run=True) == (0, 0, 0, 0, 1)
    run = plan.launch("huge_l2", run=True)
    assert (run.own, run.blocks) == ((G, columns), G * columns)
    assert geom.huge_scratch.numel() == plan.scratch_bytes[2]
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    run = sk.backward_run_cuda(geom, lo, hi)
    g = geom.buckets[0]
    one = sk.bucket_backward_run_cuda(g, lo.view(g.H, g.B), hi.view(g.H, g.B))
    out_f = sk.forward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    out_b = sk.backward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == launches(huge_cluster=1, run_huge_l2=2)
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    assert_same_bits([run], [run_ref(geom, lo, hi)])
    assert_same_bits([one], [uf.bucket_backward_run(g, lo.view(g.H, g.B), hi.view(g.H, g.B))])
    assert_same_bits(out_f, twins_bucket_by_bucket(
        uf.bucket_forward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits(out_b, twins_bucket_by_bucket(
        uf.bucket_backward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    # the cluster body's run where a plan is built so: the same bits
    forced = layout.build_plan(plan.shapes, dtype, cuda_device, ["huge_cluster"])
    launch, out = sk.prepare_run_launch(geom, lo, hi, forced)
    assert launch.counts == (sk.RUN + sk.HUGE_CLUSTER,)
    launch()
    torch.cuda.synchronize()
    assert_same_bits([out], [run])


@pytest.mark.cuda
def test_float32_solve_of_the_widest_row_launches_only_the_l2_body(cuda_device):
    """A default (float32) solve of one knapsack row of 262,144 slots
    through the user entry point: every sweep and run launches the L2 body
    (one column: G = the card's resident blocks), no plain version runs on
    the card, and the bound agrees with the native solver's after as many
    iterations within the float32 limit of the smoke test."""
    from bdd_tpu_torch.api import BddSolver
    from chip_smoke import DUAL_ONLY, L2_WIDEST_ROWS, LB_REL, fixed_iterations, knapsack_lp

    lp = knapsack_lp(**L2_WIDEST_ROWS)
    nh = NativeHost(lp, "input")
    host = layout.from_native_host(nh, torch.float32, cuda_device, pack=False)
    assert [(g.P, g.B) for g in host.geom.buckets] == [(262144, 1)]
    assert counts(host.geom.plan) == (0, 0, 0, 0, 1)
    del host
    n = 20
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    res = BddSolver({"precision": "float", **DUAL_ONLY, **fixed_iterations(n)},
                    device="cuda").read_ilp(lp_string=lp).solve(verbose=False)
    assert res["iterations"] == n
    assert {k: v for k, v in sk.LAUNCHES.items() if v} == {
        "uniform_forward" + sk.HUGE_L2: n, "uniform_backward" + sk.HUGE_L2: n,
        sk.RUN + sk.HUGE_L2: sk.LAUNCHES[sk.RUN + sk.HUGE_L2]}
    assert sk.LAUNCHES[sk.RUN + sk.HUGE_L2] > 0
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    cs = nh.cpu_solver()
    cs.iterations(n, 0.5)
    native = cs.lower_bound_with_deferred()
    assert abs(res["lower_bound"] - native) <= LB_REL["float"] * abs(native)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_mknap_t25_rows_launch_the_body_of_their_route(cuda_device, precision):
    """The benchmark's mknap.t25 instance (five knapsack rows of 100 items,
    tightness 0.25: 5 columns of 16,384 slots, which a block's shared memory
    holds; 100 hops packed in float32, 112 unpacked in float64): by the route
    the half-sweeps take the cluster body in float32 (clusters of 16, 80
    blocks) and the L2 body in float64 (G = 16, 80 blocks), the run the L2
    body at G = 16 in both. From a state after five twin iterations each
    entry equals its plain version bit for bit, one launch each; 20
    iterations through the kernels launch nothing else, run no plain
    version, and agree with the native solver's bound after as many
    iterations (chip_smoke's limits)."""
    from chip_smoke import LB_REL
    from portbench.generators import chu_beasley

    dtype = torch.float32 if precision == "float" else torch.float64
    nh = NativeHost(chu_beasley.make(dict(rows=5, items=100, tightness=0.25),
                                     3_000_000_001).lp_text(), "input")
    host = layout.from_native_host(nh, dtype, cuda_device)
    geom = host.geom
    plan = geom.plan
    assert plan.shapes == ((16384, 100 if precision == "float" else 112, 5),)
    body = sk.HUGE_CLUSTER if precision == "float" else sk.HUGE_L2
    (sweep,), (run,) = plan.sweeps, plan.runs
    assert (sweep.body, sweep.own[0], sweep.blocks) == (body, 16, 80)
    assert (run.body, run.own[0], run.blocks) == (sk.HUGE_L2, 16, 80)
    st = uf.iterations(geom, uf.init_uniform_state(host, nh.objective()), 5,
                       sweeps=uf.TWIN_SWEEPS)
    lo, hi, _, fr = st.flat
    dl, dh = uf.exchange_delta_flat(geom, st.flat[2])
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    out_f = sk.forward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    out_b = sk.backward_iteration_cuda(geom, out_f[0], out_f[1], out_f[3], 0.5, dl, dh)
    run = sk.backward_run_cuda(geom, lo, hi)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {**launches(run_huge_l2=1), "uniform_forward" + body: 1,
                           "uniform_backward" + body: 1}
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    ref_f = twins_bucket_by_bucket(uf.bucket_forward_iteration, geom, lo, hi, fr, 0.5, dl, dh)
    assert_same_bits(out_f, ref_f)
    assert_same_bits(out_b, twins_bucket_by_bucket(
        uf.bucket_backward_iteration, geom, ref_f[0], ref_f[1], ref_f[3], 0.5, dl, dh))
    assert_same_bits([run], [run_ref(geom, lo, hi)])
    n = 20
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    st = uf.iterations(geom, uf.init_uniform_state(host, nh.objective()), n, 0.5)
    lb = float(uf.lower_bound_with_deferred(geom, st))
    assert {k: v for k, v in sk.LAUNCHES.items() if v and k != sk.RUN + sk.HUGE_L2} == {
        "uniform_forward" + body: n, "uniform_backward" + body: n}
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    cs = nh.cpu_solver()
    cs.iterations(n, 0.5)
    native = cs.lower_bound_with_deferred()
    assert abs(lb - native) <= LB_REL[precision] * abs(native)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
def test_mixed_layout_counts_one_launch_per_body(cuda_device, precision):
    """Narrow, wide, routed, huge, cluster and L2 buckets in one layout: five
    launches per half-sweep, one per body, the routed and the huge bucket in
    one, and four per run (its route takes the cluster bucket, 131 columns,
    to the L2 body); against the twins bucket by bucket, and no plain
    version on the card. The 33 columns of 16,384 slots stay on the huge
    body: with them the L2 table's G would be 3."""
    dtype = torch.float32 if precision == "float" else torch.float64
    shapes = [(2, 9, 70), (layout.HUGE_FROM, 3, 5), (128, 5, 9), (16384, 2, 33), (30000, 2, 131),
              L2_SHAPES[0]]
    host, (lo, hi, fr, dl, dh) = synthetic_host(shapes, dtype, cuda_device, seed=5)
    geom = host.geom
    assert counts(geom.plan)[2:] == (2, 1, 1)
    # the L2 body's scratch: its key rows, and the partials and counter of
    # its one column, split over the plan's G blocks
    assert geom.plan.scratch_bytes[0] == 2 * L2_SHAPES[0][0] * 1 * lo.element_size()
    G, columns = geom.plan.launch("huge_l2").own
    assert columns == 1 and G > 1
    assert geom.plan.launch("huge_l2", run=True).own == (1, 132)
    assert geom.huge_scratch.numel() == geom.plan.scratch_bytes[2]
    sk.reset_launch_counts()
    calls = {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}
    out_f = sk.forward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    out_b = sk.backward_iteration_cuda(geom, lo, hi, fr, 0.5, dl, dh)
    run = sk.backward_run_cuda(geom, lo, hi)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == launches(narrow=1, wide=1, huge=1, huge_cluster=1, huge_l2=1, run=1,
                                   run_wide=1, run_huge=1, run_huge_l2=1)
    assert {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS} == calls
    assert_same_bits(out_f, twins_bucket_by_bucket(
        uf.bucket_forward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits(out_b, twins_bucket_by_bucket(
        uf.bucket_backward_iteration, geom, lo, hi, fr, 0.5, dl, dh))
    assert_same_bits([run], [geom.flatten_nodes([
        uf.bucket_backward_run(g, a, b)
        for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])])


@pytest.mark.cuda
def test_dense_card_equals_cpu(cuda_device):
    """The dense backend (solver/dense.py, torch ops) on the card: the
    float64 trajectory equals the CPU's (rel 1e-12), float32 reruns are
    bit-identical, and no sweep kernel or plain version runs."""
    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
    from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
    from bdd_tpu_torch.solver.flatten import flatten_collection

    ilp = grid_mrf(5, 5, 3, seed=3)
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    flat = flatten_collection(pre.collection, pre.total_nr_variables(), pre.nr_primal_variables)
    sk.reset_launch_counts()
    plain = dict(uf.TWIN_SWEEP_CALLS), dict(uf.PLAIN_RUN_CALLS)
    bounds = {}
    for device, dtype in (("cpu", torch.float64), (cuda_device, torch.float64),
                          (cuda_device, torch.float32), (cuda_device, torch.float32)):
        s = DenseSolver(flat, pre.objective_vector(), dtype=dtype, device=device)
        s.iteration_block(20)
        bounds.setdefault(dtype, []).append(s.lower_bound_with_deferred())
    assert bounds[torch.float64][1] == pytest.approx(bounds[torch.float64][0], rel=1e-12)
    assert bounds[torch.float32][0] == bounds[torch.float32][1]
    assert not any(sk.LAUNCHES.values())
    assert (dict(uf.TWIN_SWEEP_CALLS), dict(uf.PLAIN_RUN_CALLS)) == plain


@pytest.mark.cuda
def test_hybrid_card_equals_cpu(cuda_device):
    """The hybrid solve (solver/hybrid.py) with half the BDDs on the native
    solver's worker thread: the card's float64 trajectory equals the same
    solve on the CPU (rel 1e-9), every iteration one launch of each half-sweep
    and no plain version, and the worker thread gone after close()."""
    import threading

    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
    from bdd_tpu_torch.solver.hybrid import HybridSolver

    ilp = grid_mrf(5, 5, 3, seed=3)
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    force = list(range(0, pre.collection.nr_bdds(), 2))
    before = threading.active_count()
    bounds = {}
    for device in ("cpu", cuda_device):
        s = HybridSolver(pre.collection, pre.total_nr_variables(), pre.objective_vector(),
                         dtype=torch.float64, device=device, force_host_bdds=force)
        sk.reset_launch_counts()
        plain = dict(uf.TWIN_SWEEP_CALLS), dict(uf.PLAIN_RUN_CALLS)
        trail = []
        for _ in range(4):
            s.iteration_block(5)
            trail.append(s.lower_bound_with_deferred())
        bounds[str(device)] = trail
        if device != "cpu":
            counted = {k: n for k, n in sk.LAUNCHES.items() if not k.startswith(sk.RUN)}
            assert counted == {k: v for k, v in launches(narrow=20).items()
                               if not k.startswith(sk.RUN)}
            assert (dict(uf.TWIN_SWEEP_CALLS), dict(uf.PLAIN_RUN_CALLS)) == plain
        s.close()
    assert threading.active_count() == before
    for a, b in zip(bounds["cpu"], bounds[str(cuda_device)]):
        assert abs(a - b) <= 1e-9 * abs(a)


def learned_weights(geom, seed=0):
    """Random per-layer (alpha normalized per variable, omega) on the layout's
    device, made with numpy."""
    from bdd_tpu_torch.solver import learned as ln

    rng = np.random.RandomState(seed)
    E = geom.plan.E
    raw = torch.from_numpy(rng.rand(E) + 0.05).to(geom.device, geom.dtype)
    omega = torch.from_numpy(rng.uniform(0.1, 0.95, E)).to(geom.device, geom.dtype)
    return ln.normalize_alpha(geom, raw), omega


@pytest.mark.parametrize("name", list(INSTANCES))
def test_learned_weights_through_the_fused_wrappers_on_cpu_equal_the_twins(name):
    host, st, dl, dh = setup(name, torch.float64, "cpu")
    geom = host.geom
    alpha, omega = learned_weights(geom)
    lo, hi, _, cft = st.flat
    dl, dh = layout.flatten(dl), layout.flatten(dh)
    fwd = sk.forward_iteration_cuda(geom, lo, hi, cft, omega, dl, dh, alpha)
    ref = twins_bucket_by_bucket(uf.bucket_forward_iteration, geom, lo, hi, cft, omega, dl, dh,
                                 alpha)
    assert_identical(fwd, ref)
    # the weights reach the sweep: the isotropic ones give another result
    iso = sk.forward_iteration_cuda(geom, lo, hi, cft, omega, dl, dh)
    assert not torch.equal(torch.nan_to_num(iso[0]), torch.nan_to_num(fwd[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_learned_weights_through_the_fused_launch_equal_the_twins(cuda_device, name, precision):
    """The learned path's launches: per-layer alpha and omega arrays through
    one fused forward and one fused backward launch, and the run entry on the
    updated costs, bit for bit against the twins."""
    dtype = torch.float32 if precision == "float" else torch.float64
    host, st, dl, dh = setup(name, dtype, cuda_device)
    geom = host.geom
    alpha, omega = learned_weights(geom, seed=1)
    lo, hi, _, cft = st.flat
    dl, dh = layout.flatten(dl), layout.flatten(dh)
    sk.reset_launch_counts()
    fwd = sk.forward_iteration_cuda(geom, lo, hi, cft, omega, dl, dh, alpha)
    bwd = sk.backward_iteration_cuda(geom, fwd[0], fwd[1], fwd[3], omega, dl, dh, alpha)
    run = sk.backward_run_cuda(geom, bwd[0], bwd[1])
    torch.cuda.synchronize()
    assert_same_bits(fwd, twins_bucket_by_bucket(uf.bucket_forward_iteration, geom, lo, hi,
                                                 cft, omega, dl, dh, alpha))
    assert_same_bits(bwd, twins_bucket_by_bucket(uf.bucket_backward_iteration, geom, fwd[0],
                                                 fwd[1], fwd[3], omega, dl, dh, alpha))
    assert_same_bits([run], [geom.flatten_nodes([
        uf.bucket_backward_run(g, a, b)
        for g, a, b in zip(geom.buckets, geom.per_bucket(bwd[0]), geom.per_bucket(bwd[1]))])])
    narrow, wide = (int(n > 0) for n in counts(geom.plan)[:2])
    assert sk.LAUNCHES == launches(narrow=narrow, wide=wide, run=1, run_wide=wide)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INSTANCES))
def test_learned_gradients_on_the_card_equal_plain_autograd(cuda_device, name):
    """The dual loss's gradient with respect to alpha, omega and the costs:
    LearnedIteration / BackwardRun (kernels forward, twins recomputed
    backward) against plain autograd through the twins, on the card in
    float64; one launch of each half-sweep per learned iteration."""
    from bdd_tpu_torch.solver import learned as ln

    host, st, _, _ = setup(name, torch.float64, cuda_device)
    geom = host.geom
    alpha, omega = learned_weights(geom, seed=2)
    n = 3
    grads = []
    for sweeps in (None, uf.TWIN_SWEEPS):
        sk.reset_launch_counts()
        lo, hi = (t.clone().requires_grad_() for t in st.flat[:2])
        a, o = alpha.clone().requires_grad_(), omega.clone().requires_grad_()
        state = layout.state_from_flat(geom, lo, hi, st.flat[2], ln.backward_run(
            geom, lo, hi, sweeps))
        loss = ln.dual_loss(geom, state, a, o, n, sweeps)
        if sweeps is None:
            forward_launches = {k: v for k, v in sk.LAUNCHES.items() if not k.startswith(sk.RUN)}
        grads.append(torch.autograd.grad(loss, (a, o, lo, hi)))
    torch.cuda.synchronize()
    narrow, wide = (int(k > 0) for k in counts(geom.plan)[:2])
    want = {k: v for k, v in launches(narrow=n * narrow,
                                      wide=n * wide).items() if not k.startswith(sk.RUN)}
    assert forward_launches == want
    for x, y in zip(*grads):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14)


@pytest.mark.cuda
def test_doge_training_step_on_the_card(cuda_device):
    """Two training steps of the learned solver on the card (features, GNN,
    learned iterations on the kernels, twin recomputation backward): finite
    losses, parameters that move, one launch of each half-sweep per learned
    iteration, and a fused rollout equal to a streamed one."""
    from bdd_tpu_torch.learn.train import DogeTrainer, Instance, TrainConfig
    from bdd_tpu_torch.utils.problems import independent_set

    inst = Instance.from_ilp(independent_set(14, 0.3, seed=1), device=cuda_device)
    cfg = TrainConfig(dim=16, nr_rounds=2, iters_per_round=4, free_update=True,
                      history_features=True, layer_norm=True, smooth_temps=(0.1, 10.0))
    t = DogeTrainer(cfg)
    t.init(inst)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    sk.reset_launch_counts()
    losses = [t.train_step(inst)["loss"] for _ in range(2)]
    assert all(np.isfinite(losses))
    learned = 2 * cfg.nr_rounds * cfg.iters_per_round
    counted = {k: v for k, v in sk.LAUNCHES.items() if not k.startswith(sk.RUN)}
    assert counted == {k: v for k, v in launches(narrow=learned).items()
                       if not k.startswith(sk.RUN)}
    assert any(not torch.equal(v, t.model.state_dict()[k]) for k, v in before.items())
    assert t.run_learned_rounds(inst, 3) == t.run_learned_rounds(inst, 3, fused=False)
