"""bdd_tpu_torch layout builders vs the JAX package's host builders.

The port builds bucket arrays from the native host library without JAX
(``from_native_host``) and packs columns in numpy (``pack_uniform_host``);
both must give arrays equal to ``NativeHost.make_uniform_host`` and
``uniform.pack_uniform_host``.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.native import NativeHost
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch.native import NativeHost as PortNativeHost
from bdd_tpu_torch.solver import layout
from tests import fixtures


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers), restored afterwards: the CPU solver of native/ sizes its per-thread
    scratch by omp_get_max_threads() of the thread that creates it, so a
    count lowered for good would break other modules' solvers that run
    parallel regions from other threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LPS = {
    "matching": fixtures.MATCHING_3x3,
    "mrf_chain": fixtures.SHORT_MRF_CHAIN,
    "two_simplex": fixtures.TWO_SIMPLEX,
    "grid": grid_mrf(4, 4, 3, seed=0).write_lp(),
}


def assert_host_equal(port, ref, dtype):
    assert port.nr_vars == ref.nr_vars
    assert port.nr_primal_vars == ref.nr_primal_vars
    assert port.nr_bdds == ref.nr_bdds
    np.testing.assert_array_equal(
        port.geom.num_bdds_per_var.numpy(), np.asarray(ref.geom.num_bdds_per_var)
    )
    assert len(port.geom.buckets) == len(ref.geom.buckets)
    for k, (g, r) in enumerate(zip(port.geom.buckets, ref.geom.buckets)):
        for name in ("node_valid", "lo_kind", "lo_slot", "hi_kind", "hi_slot",
                     "layer_valid", "layer_var"):
            np.testing.assert_array_equal(
                getattr(g, name).numpy(), np.asarray(getattr(r, name)), err_msg=name
            )
        assert g.alpha.dtype == dtype
        np.testing.assert_array_equal(g.alpha.numpy(), np.asarray(r.alpha))
        if r.root_mask is None:
            assert g.root_mask is None
        else:
            np.testing.assert_array_equal(g.root_mask.numpy(), np.asarray(r.root_mask))
        np.testing.assert_array_equal(g.roots.numpy(), np.asarray(uf.root_rows(r)))
        np.testing.assert_array_equal(port.bdd_of_col[k], ref.bdd_of_col[k])
        np.testing.assert_array_equal(port.depths[k], ref.depths[k])
        np.testing.assert_array_equal(port.layer_bdd[k], ref.layer_bdd[k])


@pytest.mark.parametrize("name", list(LPS))
@pytest.mark.parametrize("precision", ["float", "double"])
def test_from_native_host_matches_make_uniform_host(name, precision):
    """float32 hosts are column-packed, float64 ones are not — both sides."""
    nh = NativeHost(LPS[name], "bfs")
    jdt, tdt = {"float": (jnp.float32, torch.float32),
                "double": (jnp.float64, torch.float64)}[precision]
    ref = nh.make_uniform_host(dtype=jdt)
    port = layout.from_native_host(PortNativeHost(LPS[name], "bfs"), dtype=tdt, device="cpu")
    assert (port.geom.buckets[0].root_mask is not None) == (precision == "float")
    assert_host_equal(port, ref, tdt)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_routed_wide_rows_keep_the_jax_layout(precision):
    """Knapsack rows of 32 variables with coefficients up to 1,000 (BDDs of
    8,192 slots, the widest two-byte record): the plan sends their bucket to
    the huge body, and the layout stays the JAX package's: two-byte records,
    the same arrays, columns padded as there (``lane_pad``; 132 rows would
    take 256 columns)."""
    from chip_smoke import knapsack_lp

    lp = knapsack_lp(nr_vars=256, nr_rows=8, row_len=32, coef_max=1000)
    jdt, tdt = {"float": (jnp.float32, torch.float32),
                "double": (jnp.float64, torch.float64)}[precision]
    ref = NativeHost(lp, "input").make_uniform_host(dtype=jdt)
    port = layout.from_native_host(PortNativeHost(lp, "input"), dtype=tdt, device="cpu")
    assert_host_equal(port, ref, tdt)
    assert [g.P for g in port.geom.buckets] == [layout.WIDE_P]
    g = port.geom.buckets[0]
    assert g.arcs.shape[2] == layout.record_bytes(layout.WIDE_P) == 4 * layout.WIDE_P
    plan = port.geom.plan
    assert [(r.body, r.nr_buckets, r.blocks) for r in plan.sweeps] == [("_huge", 1, g.B)]
    assert layout.arc_bytes(layout.WIDE_P) == 2 and layout.lane_pad(132, layout.WIDE_P) == 256


@pytest.mark.parametrize("name", list(LPS))
def test_pack_uniform_host_matches_jax(name):
    nh = NativeHost(LPS[name], "input")
    ref_unpacked = nh.make_uniform_host(dtype=jnp.float32, pack=False)
    ref_packed = uf.pack_uniform_host(ref_unpacked, dtype=jnp.float32)
    port_unpacked = layout.from_jax_arrays(ref_unpacked, dtype=torch.float32)
    assert_host_equal(port_unpacked, ref_unpacked, torch.float32)
    port_packed = layout.pack_uniform_host(port_unpacked)
    assert_host_equal(port_packed, ref_packed, torch.float32)


def test_pack_candidates_and_cost_model_match_jax():
    rng = np.random.RandomState(3)
    for max_d in (1, 5, 64, 100, 256, 300):
        assert layout._pack_candidates(max_d) == uf._pack_candidates(max_d)
    deps = rng.randint(1, 40, size=300).astype(np.int64)
    for cap, P in ((40, 2), (80, 32), (256, layout.WIDE_P)):  # the JAX package's at P <= WIDE_P
        a, b = layout._pack_eval(deps, cap, P), uf._pack_eval(deps, cap)
        assert a[0] == b[0] and a[3:] == b[3:]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert (layout.PACK_LAMBDA, layout.PACK_H_CAP) == (uf.PACK_LAMBDA, uf.PACK_H_CAP)


def test_from_jax_arrays_carries_state():
    nh = NativeHost(LPS["grid"], "bfs")
    host = nh.make_uniform_host(dtype=jnp.float64)
    state = uf.init_uniform_state(host, nh.objective(), dtype=jnp.float64)
    state = uf.iterations(host.geom, state, 2, 0.5)
    state_np = jax.tree.map(np.asarray, state)
    port_host, port_state = layout.from_jax_arrays(host, state_np, dtype=torch.float64)
    assert_host_equal(port_host, host, torch.float64)
    for field in ("lo", "hi", "def_mm", "cft"):
        for a, b in zip(getattr(port_state, field), getattr(state_np, field)):
            assert a.dtype == torch.float64
            np.testing.assert_array_equal(a.numpy(), b)


def test_from_jax_arrays_round_trips_a_wide_frontier():
    """A wide bucket (P > 32) stores its frontier [H, B, P] in the flat
    buffer; what ``from_jax_arrays`` carries over reads back through the
    [H, P, B] view as the JAX arrays, for narrow and wide buckets alike."""
    from tests.test_torch_wide import MIXED

    nh = NativeHost(MIXED, "input")
    host = nh.make_uniform_host(dtype=jnp.float64, pack=False)
    state = uf.init_uniform_state(host, nh.objective(), dtype=jnp.float64)
    state = uf.iterations(host.geom, state, 2, 0.5)
    state_np = jax.tree.map(np.asarray, state)
    port_host, port_state = layout.from_jax_arrays(host, state_np, dtype=torch.float64)
    geom = port_host.geom
    widths = [g.P for g in geom.buckets]
    assert min(widths) <= layout.NARROW_P < max(widths)
    off = 0
    for g, view, want in zip(geom.buckets, port_state.cft, state_np.cft):
        n = g.H * g.P * g.B
        np.testing.assert_array_equal(view.numpy(), want)
        stored = want if g.P <= layout.NARROW_P else want.transpose(0, 2, 1)
        np.testing.assert_array_equal(port_state.flat[3][off:off + n].numpy(), stored.reshape(-1))
        off += n
    rebuilt = layout.state_from_buckets(geom, port_state.lo, port_state.hi, port_state.def_mm,
                                        port_state.cft)
    assert torch.equal(rebuilt.flat[3], port_state.flat[3])


def test_exchange_index_groups_valid_slots_by_variable():
    nh = PortNativeHost(LPS["grid"], "bfs")
    host = layout.from_native_host(nh, dtype=torch.float32, device="cpu")
    ex = host.geom.exchange
    ids = ex.ids.numpy()
    valid = ex.valid.numpy()
    V = host.nr_vars
    assert ids.size == sum(host.geom.sizes)
    assert (ids[~valid] == V).all() and (ids[valid] < V).all()
    order = ex.order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.nonzero(valid)[0])
    assert (np.diff(ids[order]) >= 0).all()
    np.testing.assert_array_equal(ex.lengths.numpy(), np.bincount(ids[valid], minlength=V))
    np.testing.assert_array_equal(ex.lengths.numpy(), host.geom.num_bdds_per_var.numpy())


# ------------------------------------------------------------ byte geometry
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32])
def test_byte_geometry_round_trips_for_every_width(P):
    """Random arc arrays -> byte records -> the decoded int32 / bool arrays."""
    rng = np.random.RandomState(P)
    H, B = 5, 11
    arrays = dict(
        node_valid=rng.rand(H, P, B) < 0.7,
        lo_kind=rng.randint(0, 3, size=(H, P, B)).astype(np.int32),
        lo_slot=rng.randint(0, P, size=(H, P, B)).astype(np.int32),
        hi_kind=rng.randint(0, 3, size=(H, P, B)).astype(np.int32),
        hi_slot=rng.randint(0, P, size=(H, P, B)).astype(np.int32),
    )
    layer_valid, roots = rng.rand(H, B) < 0.8, rng.rand(H, B) < 0.3
    rec = layout.encode_arcs(*arrays.values(), layer_valid, roots)
    assert rec.dtype == np.uint8 and rec.shape == (H, B, max(4, 2 * P))
    g = layout.BucketGeom(P=P, arcs=torch.from_numpy(rec),
                          layer_var=torch.zeros((H, B), dtype=torch.int64),
                          alpha=torch.zeros((H, B)), packed=True)
    assert (g.H, g.P, g.B) == (H, P, B)
    for name, want in arrays.items():
        got = getattr(g, name)
        assert got.dtype == (torch.bool if name == "node_valid" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(g.layer_valid.numpy(), layer_valid)
    np.testing.assert_array_equal(g.roots.numpy(), roots)
    np.testing.assert_array_equal(g.root_mask.numpy(), roots)


@pytest.mark.parametrize("what", ["kind", "slot", "width"])
def test_byte_geometry_refuses_what_it_cannot_hold(what):
    """A kind outside 0..2, a slot past the one-byte record's 5 bits and, at
    a width past the wide body's (four-byte arcs), a slot past 28 bits."""
    P = 2 * layout.WIDE_P if what == "width" else 2
    z = np.zeros((1, P, 4), dtype=np.int64)
    bad = z.copy()
    bad[0, 0, 0] = {"kind": 3, "slot": 32, "width": 1 << 28}[what]
    args = dict(node_valid=z > 0, lo_kind=z, lo_slot=z, hi_kind=z, hi_slot=z)
    args["hi_" + ("kind" if what == "kind" else "slot")] = bad
    m = np.zeros((1, 4), dtype=bool)
    with pytest.raises(ValueError, match="arc kind"):
        layout.encode_arcs(*args.values(), m, m)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_wide_instance_geometry_matches_jax_for_every_width(precision):
    """Every kernel width P = 1..32 on one instance: the decoded bytes against
    the int32 arrays of bdd_tpu, raw (float64) and packed (float32)."""
    from tests.test_torch_kernels import wide_lp

    nh = NativeHost(wide_lp(), "input")
    jdt, tdt = {"float": (jnp.float32, torch.float32),
                "double": (jnp.float64, torch.float64)}[precision]
    ref = nh.make_uniform_host(dtype=jdt)
    port = layout.from_native_host(PortNativeHost(wide_lp(), "input"), dtype=tdt, device="cpu")
    assert sorted({g.P for g in port.geom.buckets}) == [1, 2, 4, 8, 16, 32]
    assert_host_equal(port, ref, tdt)


def test_launch_plan_table_and_flat_views():
    from tests.test_torch_kernels import wide_lp

    host = layout.from_native_host(PortNativeHost(wide_lp(), "input"), dtype=torch.float64,
                                   device="cpu")
    geom, plan = host.geom, host.geom.plan
    (narrow,) = plan.sweeps
    assert narrow.body == "" and plan.runs == plan.sweeps
    table = narrow.table.numpy()
    assert table.shape == (len(geom.buckets), layout.TABLE_COLUMNS)
    tile, pmax = narrow.own
    e = n = blocks = 0
    for row, g in zip(table, geom.buckets):
        P, H, B, first, row_off, node_off, arc_off, stages = (int(x) for x in row)
        assert (P, H, B) == (g.P, g.H, g.B) and first == blocks
        assert (row_off, node_off) == (e, n) and arc_off % layout.ARC_ALIGN == 0
        assert g.arcs.data_ptr() == geom.arcs.data_ptr() + arc_off
        assert g.alpha.data_ptr() == geom.alpha.data_ptr() + e * geom.alpha.element_size()
        assert 1 <= stages <= layout.MAX_STAGES
        assert (stages + 1) * layout.slot_bytes(P, 8, tile) <= narrow.smem_forward
        e, n, blocks = e + H * B, n + H * P * B, blocks + -(-B // tile)
    assert (plan.E, plan.N, narrow.blocks) == (e, n, blocks)
    assert narrow.smem_forward == narrow.smem_backward <= layout.SMEM_BUDGET
    assert narrow.threads == tile and pmax == 32
    assert layout.launch_plan(plan.shapes, torch.float64, "cpu") is plan  # built once


@pytest.mark.parametrize("P,itemsize,want", [(1, 4, 36), (2, 4, 36), (2, 8, 72), (4, 4, 56),
                                             (8, 4, 80), (32, 8, 368)])
def test_ring_cell_bytes(P, itemsize, want):
    """The cell sizes the kernel's ``Cell<T, P>::W`` computes."""
    assert layout.cell_bytes(P, itemsize) == want
