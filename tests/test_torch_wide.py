"""Buckets wider than 32 slots (two bytes an arc) in the port vs the JAX package.

``bdd_tpu`` has no width limit: ``flatten_uniform`` keys a bucket by the
width rounded up to a power of two and the XLA scan sweeps any P. The port
stores such buckets with a two-byte arc record and sweeps them with the wide
body of its kernels (on the card) or the twins (here), which gather and
scatter by index at every width, not by the JAX package's one-hot masks.

- float64, atol 1e-12: the twins against the XLA bucket functions of
  ``bdd_tpu.solver.uniform`` (never Pallas: it takes P <= 8), packed and
  unpacked, with forcing infinities injected.
- float32, rtol 1e-6 / atol 1e-5: same functions, same order of operations;
  the slack is XLA's freedom to contract a multiply-add.
- the one-row knapsack that the byte geometry used to refuse solves through
  both ``BddSolver``s on the default path with the same bound (float64 within
  1e-9, float32 within rel 1e-5: the exchanges sum in another order).
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu import api as jax_api
from bdd_tpu.solver import uniform as uf
from bdd_tpu_torch import api
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import uniform as tuf
from tests.test_torch_kernels import counts, random_bucket, synthetic_host
from tests.test_torch_sweep import assert_same, jax_setup


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def knapsack_row(n=30, rhs=120):
    return " + ".join(f"{(13 * i) % 17 + 3} x{i}" for i in range(n)) + f" >= {rhs}"


# the instance that bdd_tpu solved and the port refused: one bucket (P=128)
KNAPSACK = ("Minimize\n" + " + ".join(f"{(7 * i) % 5 + 1} x{i}" for i in range(30))
            + "\nSubject To\n" + knapsack_row() + "\nEnd")
# wide and narrow buckets side by side, coupled so that the deltas mix
MIXED = ("Minimize\n" + " ".join(f"{(5 * i) % 7 - 2:+d} x{i}" for i in range(30))
         + "\nSubject To\n" + knapsack_row() + "\n"
         + " + ".join(f"{(3 * i) % 9 + 1} x{i}" for i in range(4, 22)) + " <= 40\n"
         + "\n".join(f"x{j} + x{j + 1} + x{j + 2} >= 1" for j in range(0, 27, 3)) + "\nEnd")
LPS = {"knapsack": KNAPSACK, "mixed": MIXED}
TOL = {jnp.float64: dict(atol=1e-12), jnp.float32: dict(atol=1e-5, rtol=1e-6)}


def test_instances_have_wide_buckets():
    for name, widest in (("knapsack", 128), ("mixed", 128)):
        *_, port, _, _, _ = jax_setup(LPS[name], jnp.float64, False, iters=0, order="input")
        widths = sorted({g.P for g in port.geom.buckets})
        assert widths[-1] == widest and widest > layout.NARROW_P
        if name == "mixed":
            assert widths[0] <= layout.NARROW_P
            assert min(counts(port.geom.plan)[:2]) >= 1


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(LPS))
def test_wide_half_sweeps_match_jax(name, jdt, pack):
    host, state, dl, dh, port, ps, tl, th = jax_setup(LPS[name], jdt, pack, order="input")
    assert (port.geom.buckets[0].root_mask is not None) == pack
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        ref_f = uf.bucket_forward_iteration(
            g, state.lo[k], state.hi[k], state.cft[k], 0.5, dl[k], dh[k])
        out_f = tuf.bucket_forward_iteration(pg, ps.lo[k], ps.hi[k], ps.cft[k], 0.5, tl[k], th[k])
        assert_same(out_f, ref_f, **TOL[jdt])
        ref_b = uf.bucket_backward_iteration(g, ref_f[0], ref_f[1], ref_f[3], 0.5, dl[k], dh[k])
        out_b = tuf.bucket_backward_iteration(
            pg, out_f[0], out_f[1], out_f[3], 0.5, tl[k], th[k])
        assert_same(out_b, ref_b, **TOL[jdt])


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_wide_runs_and_min_marginals_match_jax_f64(pack):
    host, state, _, _, port, ps, _, _ = jax_setup(MIXED, jnp.float64, pack, order="input")
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        assert_same([tuf.bucket_backward_run(pg, ps.lo[k], ps.hi[k])],
                    [uf.bucket_backward_run(g, state.lo[k], state.hi[k])], atol=1e-12)
        assert_same([tuf.bucket_forward_run(pg, ps.lo[k], ps.hi[k])],
                    [uf.bucket_forward_run(g, state.lo[k], state.hi[k])], atol=1e-12)
        assert_same(tuf.bucket_min_marginals(pg, ps.lo[k], ps.hi[k], ps.cft[k]),
                    uf.bucket_min_marginals(g, state.lo[k], state.hi[k]), atol=1e-12)


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_wide_backward_run_wrapper_and_node_layout_match_jax_f64(pack):
    """The fused run wrapper on CPU tensors over narrow and wide buckets
    against the JAX package's run, and the storage of a wide frontier: the
    slot innermost, behind the same [H, P, B] view."""
    from bdd_tpu_torch.solver import sweep_kernels as sk

    host, state, _, _, port, ps, _, _ = jax_setup(MIXED, jnp.float64, pack, order="input")
    geom = port.geom
    want = [uf.bucket_backward_run(g, state.lo[k], state.hi[k])
            for k, g in enumerate(host.geom.buckets)]
    flat = sk.backward_run_cuda(geom, ps.flat[0], ps.flat[1])
    views = geom.per_bucket_nodes(flat)
    assert_same(views, want, atol=1e-12)
    off = 0
    for g, v, w in zip(geom.buckets, views, want):
        n = g.H * g.P * g.B
        assert v.shape == (g.H, g.P, g.B)
        stored = np.asarray(w) if g.P <= layout.NARROW_P else np.asarray(w).transpose(0, 2, 1)
        assert v.is_contiguous() == (g.P <= layout.NARROW_P)
        np.testing.assert_allclose(flat[off:off + n].numpy(), stored.reshape(-1), atol=1e-12)
        off += n
    assert torch.equal(geom.flatten_nodes(views), flat)
    assert torch.equal(geom.flatten_nodes([v.contiguous() for v in views]), flat)


def test_wide_iterations_match_jax_f64():
    host, state, _, _, port, ps, _, _ = jax_setup(MIXED, jnp.float64, False, order="input")
    ref = uf.iterations(host.geom, state, 10, 0.5)
    out = tuf.iterations(port.geom, ps, 10, 0.5)
    for f in ("lo", "hi", "def_mm", "cft"):
        assert_same(getattr(out, f), getattr(ref, f), atol=1e-11)
    assert float(tuf.lower_bound_with_deferred(port.geom, out)) == pytest.approx(
        float(uf.lower_bound_with_deferred(host.geom, ref)), abs=1e-11)


@pytest.mark.parametrize("precision,tol", [("double", dict(abs=1e-9)),
                                           ("float", dict(rel=1e-5, abs=1e-5))])
@pytest.mark.parametrize("name", list(LPS))
def test_knapsack_solves_like_jax_on_the_default_path(name, precision, tol):
    cfg = {"precision": precision, "perturbation rounding": False,
           "termination criteria": {"maximum iterations": 50}}
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=LPS[name])
    want = ref.solve(verbose=False)
    got = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=LPS[name]).solve(verbose=False)
    assert got["status"] == want["status"] == "solved"
    assert got["iterations"] == want["iterations"]
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], **tol)


@pytest.mark.parametrize("P", [33, 64, 512, layout.WIDE_P])
def test_two_byte_record_round_trip(P):
    rng = np.random.RandomState(P)
    H, B = 3, 5
    b = random_bucket(P, H, B, rng)
    roots = b["root_mask"]
    rec = layout.encode_arcs(*(b[k] for k in layout._NODE_KEYS), b["layer_valid"], roots)
    assert rec.dtype == np.uint8 and rec.shape == (H, B, 4 * P) == (H, B, layout.record_bytes(P))
    g = layout.BucketGeom(P=P, arcs=torch.from_numpy(rec), layer_var=torch.zeros((H, B)),
                          alpha=torch.zeros((H, B)), packed=True)
    for name in layout._NODE_KEYS:
        got = getattr(g, name)
        assert got.dtype == (torch.bool if name == "node_valid" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), b[name], err_msg=name)
    np.testing.assert_array_equal(g.layer_valid.numpy(), b["layer_valid"])
    np.testing.assert_array_equal(g.roots.numpy(), roots)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32])
def test_narrow_buckets_keep_their_one_byte_records(P):
    assert layout.arc_bytes(P) == 1 and layout.record_bytes(P) == max(4, 2 * P)
    plan = layout.launch_plan([(P, 4, 40)], torch.float32, "cpu")
    assert counts(plan) == (1, 0, 0, 0, 0)
    assert plan.arc_bytes == 4 * 40 * max(4, 2 * P)


def test_widest_bucket_builds_and_sweeps_and_wider_is_refused():
    """The widest bucket of the wide body sweeps, and a wider one is no longer
    refused: it builds with four-byte arcs into the L2 body's table (its 8
    columns: G = 16) or, where a plan is built so, the huge body's."""
    P = layout.WIDE_P
    host, (lo, hi, fr, dl, dh) = synthetic_host([(P, 2, 8)], torch.float64, "cpu")
    g = host.geom.buckets[0]
    args = (g, lo.view(2, 8), hi.view(2, 8), fr.view(2, P, 8), 0.5, dl.view(2, 8), dh.view(2, 8))
    out_f = tuf.bucket_forward_iteration(*args)
    out_b = tuf.bucket_backward_iteration(*args)
    assert out_f[3].shape == out_b[3].shape == (2, P, 8)
    assert not any(torch.isnan(x).any() for x in out_f + out_b)
    wider = random_bucket(2 * P, 1, 8, np.random.RandomState(0))
    host = layout._build_host([wider], np.ones(4, np.int64), 4, 4, 8, torch.float32, "cpu")
    assert host.geom.buckets[0].arcs.shape == (1, 8, 8 * 2 * P)
    plan = layout.launch_plan([(2 * P, 1, 8)], torch.float32, "cpu")
    assert counts(plan) == (0, 0, 0, 0, 1) and plan.launch("huge_l2").own[0] == 16
    plan = layout.build_plan([(2 * P, 1, 8)], torch.float32, "cpu", ["huge"])
    assert counts(plan) == (0, 0, 1, 0, 0) and plan.launch("huge").blocks == 8


@pytest.mark.parametrize("P", [layout.WIDE_P + 1, 16384])
def test_four_byte_record_round_trip(P):
    """Every kind, slots up to P - 1 and every flag (node_valid on the lo
    arcs, layer_valid on arc P, the root row on arc P + 1) through the
    four-byte record and back; bit 31 stays clear."""
    rng = np.random.RandomState(P)
    H, B = 3, 5
    b = random_bucket(P, H, B, rng)
    b["lo_slot"][0, 0, 0] = b["hi_slot"][1, 2, 3] = P - 1
    b["lo_kind"][0, 0, 0], b["hi_kind"][1, 2, 3] = layout.ARC_BOT, layout.ARC_TOP
    b["layer_valid"][:, 0] = True
    b["layer_valid"][:, 1] = False
    roots = b["root_mask"]
    rec = layout.encode_arcs(*(b[k] for k in layout._NODE_KEYS), b["layer_valid"], roots)
    assert rec.dtype == np.uint8 and rec.shape == (H, B, 8 * P) == (H, B, layout.record_bytes(P))
    assert (rec.view("<i4") >= 0).all()
    g = layout.BucketGeom(P=P, arcs=torch.from_numpy(rec), layer_var=torch.zeros((H, B)),
                          alpha=torch.zeros((H, B)), packed=True)
    for name in layout._NODE_KEYS:
        got = getattr(g, name)
        assert got.dtype == (torch.bool if name == "node_valid" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), b[name], err_msg=name)
    np.testing.assert_array_equal(g.layer_valid.numpy(), b["layer_valid"])
    np.testing.assert_array_equal(g.roots.numpy(), roots)
    assert g.node_valid.any() and (~g.node_valid).any() and g.roots.any() and (~g.roots).any()


def _jax_bucket(b):
    """A bdd_tpu ``BucketGeom`` of the numpy bucket dict ``b``."""
    return uf.BucketGeom(
        *(jnp.asarray(b[k]) for k in ("node_valid", "lo_kind", "lo_slot", "hi_kind", "hi_slot",
                                      "layer_valid", "layer_var")),
        jnp.asarray(b["alpha"]), None if b["root_mask"] is None else jnp.asarray(b["root_mask"]))


def _gathered_child_cft(kind, slot, cft_next, P):
    """``bdd_tpu.solver.uniform._child_cft`` with its one-hot [P, P, B] sum
    replaced by an index gather: the same values (a slot outside [0, P)
    reads 0, as no one-hot row matches it), up to the sign of a zero."""
    inside = (slot >= 0) & (slot < P)
    gathered = jnp.where(inside, jnp.take_along_axis(cft_next, jnp.where(inside, slot, 0),
                                                     axis=0), 0.0)
    return jnp.where(kind == uf.ARC_TOP, 0.0, jnp.where(kind == uf.ARC_BOT, uf.INF, gathered))


def _scattered_relax_next(vals, kind, slot, valid, P):
    """``bdd_tpu.solver.uniform._relax_next`` with its masked min over [P, P,
    B] replaced by a scatter-min into a dropped extra row: the same values."""
    into = (slot >= 0) & (slot < P) & (kind == uf.ARC_INTERNAL) & valid
    rows = jnp.where(into, slot, P)
    cols = jnp.broadcast_to(jnp.arange(slot.shape[1])[None, :], slot.shape)
    out = jnp.full((P + 1, slot.shape[1]), uf.INF, dtype=vals.dtype)
    return out.at[rows, cols].min(vals)[:P]


@pytest.mark.parametrize("P", [layout.WIDE_P + 1, layout.HUGE_FROM, 19317, 65536],
                         ids=["four-byte", "routed-two-byte", "cluster", "cluster-eight-byte"])
def test_huge_bucket_matches_jax_f64(P, monkeypatch):
    """A synthetic bucket a huge form takes (a random valid arc set: kinds,
    slots and flags, not a BDD), past the wide records' 8,192 slots, a wide
    one the plan routes there, or one past a block's shared memory that the
    cluster body holds (the narrowest in float64, and a power-of-two bucket
    of 65,536 slots, past what four-byte slot codes hold), carried across
    with ``from_jax_arrays`` and held to the JAX package's XLA bucket
    functions in float64 (atol 1e-12): forward and backward half-sweeps, the
    backward run and the min-marginals. H and B are small because the XLA
    functions gather with one-hot [P, P, B] masks (at 19,317 slots about 6 GB
    and 20 s on the CPU). At 65,536 slots those masks would take some 70 GB,
    so there the XLA functions run with their two mask helpers replaced by
    an index gather and a scatter-min (``_gathered_child_cft``,
    ``_scattered_relax_next``), which are first held to the masks on a
    bucket of 256 slots."""
    H, B = 2, 1
    if P > layout.CLUSTER_MAX_P:
        r = np.random.RandomState(3)
        n, b = 256, 3
        kind, slot = r.randint(0, 3, (n, b)), r.randint(-2, n + 3, (n, b))
        cft_next = np.where(r.rand(n, b) < 0.2, np.inf, r.randn(n, b))
        vals, valid = r.randn(n, b), r.rand(n, b) < 0.8
        j = [jnp.asarray(x) for x in (kind, slot, cft_next, vals, valid)]
        np.testing.assert_array_equal(_gathered_child_cft(j[0], j[1], j[2], n),
                                      uf._child_cft(j[0], j[1], j[2], n))
        np.testing.assert_array_equal(_scattered_relax_next(j[3], j[0], j[1], j[4], n),
                                      uf._relax_next(j[3], j[0], j[1], j[4], n))
        monkeypatch.setattr(uf, "_child_cft", _gathered_child_cft)
        monkeypatch.setattr(uf, "_relax_next", _scattered_relax_next)
    rng = np.random.RandomState(7 if P > layout.WIDE_P else 11)
    b = random_bucket(P, H, B, rng, packed=False)
    b["layer_valid"][:] = True
    b["node_valid"][0, 0] = True
    # the root's hi arc ends at the top terminal: a finite cost-to-terminal
    # whatever the other draws, so the comparison below is never all-inf
    b["hi_kind"][0, 0] = layout.ARC_TOP
    g = _jax_bucket(b)
    host = uf.UniformHost(uf.UniformGeom((g,), jnp.ones(4, jnp.int32)), (b["bdd_of_col"],),
                          (b["depths"],), 4, 4, 1, (b["layer_bdd"],))
    lo, hi = rng.randn(H, B), rng.randn(H, B)
    cft = np.where(rng.rand(H, P, B) < 0.2, np.inf, rng.randn(H, P, B))
    state = uf.UniformState((lo,), (hi,), (np.zeros((H, B)),), (cft,))
    port, ps = layout.from_jax_arrays(host, state, dtype=torch.float64)
    pg = port.geom.buckets[0]
    assert layout.arc_bytes(pg.P) == (4 if P > layout.WIDE_P else 2)
    plan = port.geom.plan
    # past WIDE_P one column takes the L2 body (its G is 9 and more), and the
    # body of its width where a plan is built so: the huge body where a
    # block holds the rows, else the cluster body
    body = "huge_l2" if P > layout.WIDE_P else "huge"
    assert layout.body_of(P, 8, B) == ("huge_cluster" if P > 19316 else "huge")  # the width's
    assert counts(plan) == ((0, 0, 1, 0, 0) if body == "huge" else (0, 0, 0, 0, 1))
    if layout.WIDE_P < P <= 19316:
        forced = layout.build_plan(plan.shapes, torch.float64, "cpu", ["huge"])
        assert counts(forced) == counts(forced, run=True) == (0, 0, 1, 0, 0)
    if P > 19316:  # the cluster launch's slot codes: four bytes below 65,533 slots
        forced = layout.build_plan(plan.shapes, torch.float64, "cpu", ["huge_cluster"])
        assert counts(forced) == (0, 0, 0, 1, 0)
        assert layout.cluster_code_bytes(forced.launch("huge_cluster").own[1]) == (
            8 if P > 65533 else 4)
    dl, dh = rng.randn(H, B), rng.randn(H, B)
    dl[0, 0] = np.inf
    tl, th = torch.from_numpy(dl), torch.from_numpy(dh)
    j = [jnp.asarray(x) for x in (lo, hi, cft, dl, dh)]
    ref_f = uf.bucket_forward_iteration(g, j[0], j[1], j[2], 0.5, j[3], j[4])
    out_f = tuf.bucket_forward_iteration(pg, ps.lo[0], ps.hi[0], ps.cft[0], 0.5, tl, th)
    assert_same(out_f, ref_f, atol=1e-12)
    ref_b = uf.bucket_backward_iteration(g, ref_f[0], ref_f[1], ref_f[3], 0.5, j[3], j[4])
    out_b = tuf.bucket_backward_iteration(pg, out_f[0], out_f[1], out_f[3], 0.5, tl, th)
    assert_same(out_b, ref_b, atol=1e-12)
    run = uf.bucket_backward_run(g, j[0], j[1])
    assert_same([tuf.bucket_backward_run(pg, ps.lo[0], ps.hi[0])], [run], atol=1e-12)
    assert_same(tuf.bucket_min_marginals(pg, ps.lo[0], ps.hi[0]),
                uf.bucket_min_marginals(g, j[0], j[1]), atol=1e-12)
    assert np.isfinite(np.asarray(ref_b[3])).any()


def _one_hot_child_cft(kind, slot, cft_next, P):
    """``tuf._child_cft`` as a one-hot mask over the slot axis, [P, P, B]."""
    iota = torch.arange(P, dtype=slot.dtype).view(P, 1, 1)
    gathered = torch.where(slot.unsqueeze(-3) == iota, cft_next.unsqueeze(-2), 0.0).sum(-3)
    return torch.where(kind == layout.ARC_TOP, 0.0,
                       torch.where(kind == layout.ARC_BOT, tuf.INF, gathered))


def _one_hot_relax_next(vals, kind, slot, valid, P):
    """``tuf._relax_next`` as a masked min-reduction over [P, P, B]."""
    iota = torch.arange(P, dtype=slot.dtype).view(P, 1, 1)
    mask = (slot[None] == iota) & (kind[None] == layout.ARC_INTERNAL) & valid[None]
    return torch.where(mask, vals[None], tuf.INF).amin(dim=1)


@pytest.mark.parametrize("P", [4, 64])
def test_wide_twins_equal_the_one_hot_formulation(monkeypatch, P):
    """The index gather / scatter of the twins gives what the one-hot masks
    of the JAX package's formulation give on the same bucket (bit for bit),
    below and above the narrow record's 32 slots."""
    from tests.test_torch_kernels import assert_identical

    host, (lo, hi, fr, dl, dh) = synthetic_host([(P, 6, 9)], torch.float64, "cpu", seed=5)
    g = host.geom.buckets[0]
    args = (g, lo.view(6, 9), hi.view(6, 9), fr.view(6, P, 9), 0.5, dl.view(6, 9), dh.view(6, 9))

    def run():
        return (tuf.bucket_forward_iteration(*args), tuf.bucket_backward_iteration(*args),
                (tuf.bucket_forward_run(g, args[1], args[2]),),
                tuf.bucket_min_marginals(g, args[1], args[2]))

    by_index = run()
    monkeypatch.setattr(tuf, "_child_cft", _one_hot_child_cft)
    monkeypatch.setattr(tuf, "_relax_next", _one_hot_relax_next)
    for a, b in zip(by_index, run()):
        assert_identical(a, b)


def test_relaxation_propagates_nan_and_meets_no_negative_zero():
    """What the wide kernel's atomic min is held to. A NaN among the arrivals
    at a slot stays a NaN (as ``torch.minimum``). And the sign of a zero
    minimum cannot depend on the order of the arrivals, because no arrival is
    -0.0: with -0.0 costs, deltas and cft everywhere, every zero of the
    forward frontier still comes out as +0.0."""
    P = 64
    vals = torch.zeros((P, 3), dtype=torch.float64)
    vals[5, 1] = float("nan")
    kind = torch.full((P, 3), layout.ARC_INTERNAL, dtype=torch.int32)
    slot = torch.full((P, 3), 7, dtype=torch.int32)
    nxt = tuf._relax_next(vals, kind, slot, torch.ones((P, 3), dtype=torch.bool), P)
    assert torch.isnan(nxt[7, 1]) and nxt[7, 0] == 0 and nxt[7, 2] == 0
    assert torch.isinf(nxt[:7]).all() and torch.isinf(nxt[8:]).all()

    host, (lo, hi, fr, dl, dh) = synthetic_host([(P, 6, 9)], torch.float64, "cpu", seed=11)
    g = host.geom.buckets[0]
    zeros = [torch.where(torch.isfinite(x), -0.0, x) for x in (lo, hi, fr, dl, dh)]
    lo, hi, fr, dl, dh = zeros
    assert torch.signbit(lo[torch.isfinite(lo)]).all()
    out = tuf.bucket_forward_iteration(g, lo.view(6, 9), hi.view(6, 9), fr.view(6, P, 9), 0.5,
                                       dl.view(6, 9), dh.view(6, 9))
    cfr = out[3]
    assert (cfr == 0).any()
    assert not torch.signbit(cfr[cfr == 0]).any()
    assert not torch.isnan(cfr).any()
