"""bdd_tpu_torch bucket sweeps: the torch twins vs the JAX package.

- float64, atol 1e-12: the twins of the two CUDA kernels and the XLA-op
  sweeps (backward run, forward run, min marginals) against
  ``bdd_tpu.solver.uniform`` on packed and unpacked layouts, with ±inf
  forcing deltas injected.
- float32: the twins against the Pallas kernels themselves
  (``pallas_uniform.bucket_*_iteration_pallas``, interpret mode on the CPU);
  the Pallas BIG=1e30 stand-in maps back to the same infinities, and finite
  values agree to float32 rounding (rtol 1e-6, atol 1e-5).

The CUDA kernels against the twins on the card: tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu.native import NativeHost
from bdd_tpu.solver import pallas_uniform as pu
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.problems import grid_mrf
from bdd_tpu_torch import _build
from bdd_tpu_torch.native import NativeHost as PortNativeHost
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import sweep_kernels as sk
from bdd_tpu_torch.solver import uniform as tuf
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


GRID = grid_mrf(4, 4, 3, seed=1).write_lp()
FORCING = """Minimize
-1 x + y + z + w
Subject To
x + y >= 1
x + z >= 1
x + w >= 1
2 x + y + z >= 4
End"""  # forces x = 1; x sits in 4 BDDs (alpha = 1/4)


def jax_setup(lp, jdt, pack, iters=3, order="bfs"):
    """A JAX host/state after a few iterations, the exchanged deltas with
    forcing infinities injected, and the same carried over to the port."""
    nh = NativeHost(lp, order)
    host = nh.make_uniform_host(dtype=jdt, pack=pack)
    state = uf.init_uniform_state(host, nh.objective(), dtype=jdt)
    state = uf.iterations(host.geom, state, iters, 0.5)
    din_lo, din_hi = uf.exchange_delta(host.geom, state.def_mm)
    din_lo = [np.asarray(d).copy() for d in din_lo]
    din_hi = [np.asarray(d).copy() for d in din_hi]
    for k, g in enumerate(host.geom.buckets):
        lv = np.nonzero(np.asarray(g.layer_valid))
        if lv[0].size:
            din_lo[k][lv[0][0], lv[1][0]] = np.inf
            din_hi[k][lv[0][-1], lv[1][-1]] = np.inf
    tdt = torch.float64 if jdt == jnp.float64 else torch.float32
    port, pstate = layout.from_jax_arrays(host, jax.tree.map(np.asarray, state), dtype=tdt)
    tl = [torch.from_numpy(d) for d in din_lo]
    th = [torch.from_numpy(d) for d in din_hi]
    return host, state, din_lo, din_hi, port, pstate, tl, th


def assert_same(port_vals, jax_vals, atol, rtol=0.0):
    for a, b in zip(port_vals, jax_vals):
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape
        fa, fb = np.isfinite(a), np.isfinite(b)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(a[~fa], b[~fb])  # same ±inf pattern
        np.testing.assert_allclose(a[fa], b[fb], atol=atol, rtol=rtol)


CASES = [
    ("grid", GRID, False),
    ("grid_packed", GRID, True),
    ("matching_packed", fixtures.MATCHING_3x3, True),
    ("forcing", FORCING, False),
]


@pytest.mark.parametrize("name,lp,pack", CASES, ids=[c[0] for c in CASES])
def test_half_sweeps_match_jax_f64(name, lp, pack):
    host, state, dl, dh, port, ps, tl, th = jax_setup(lp, jnp.float64, pack)
    assert (port.geom.buckets[0].root_mask is not None) == pack
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        ref_f = uf.bucket_forward_iteration(
            g, state.lo[k], state.hi[k], state.cft[k], 0.5, dl[k], dh[k]
        )
        out_f = tuf.bucket_forward_iteration(pg, ps.lo[k], ps.hi[k], ps.cft[k], 0.5, tl[k], th[k])
        assert_same(out_f, ref_f, atol=1e-12)
        ref_b = uf.bucket_backward_iteration(
            g, ref_f[0], ref_f[1], ref_f[3], 0.5, dl[k], dh[k]
        )
        out_b = tuf.bucket_backward_iteration(
            pg, out_f[0], out_f[1], out_f[3], 0.5, tl[k], th[k]
        )
        assert_same(out_b, ref_b, atol=1e-12)


@pytest.mark.parametrize("name,lp,pack", CASES, ids=[c[0] for c in CASES])
def test_runs_and_min_marginals_match_jax_f64(name, lp, pack):
    host, state, _, _, port, ps, _, _ = jax_setup(lp, jnp.float64, pack)
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        assert_same(
            [tuf.bucket_backward_run(pg, ps.lo[k], ps.hi[k])],
            [uf.bucket_backward_run(g, state.lo[k], state.hi[k])], atol=1e-12,
        )
        assert_same(
            [tuf.bucket_forward_run(pg, ps.lo[k], ps.hi[k])],
            [uf.bucket_forward_run(g, state.lo[k], state.hi[k])], atol=1e-12,
        )
        for cft in (None, ps.cft[k]):
            assert_same(
                tuf.bucket_min_marginals(pg, ps.lo[k], ps.hi[k], cft),
                uf.bucket_min_marginals(g, state.lo[k], state.hi[k]), atol=1e-12,
            )


@pytest.mark.parametrize("name,lp,pack", CASES, ids=[c[0] for c in CASES])
def test_backward_run_wrappers_on_cpu_match_jax_f64(name, lp, pack):
    """The run-only entry's wrappers on CPU tensors (the plain run): one call
    over all buckets on the flat costs, and bucket by bucket, against
    ``bucket_backward_run`` of the JAX package; the state's own cft is that
    run of its costs, and every state refresh goes through the wrapper."""
    host, state, _, _, port, ps, _, _ = jax_setup(lp, jnp.float64, pack)
    geom = port.geom
    want = [uf.bucket_backward_run(g, state.lo[k], state.hi[k])
            for k, g in enumerate(host.geom.buckets)]
    sk.reset_launch_counts()
    flat = sk.backward_run_cuda(geom, ps.flat[0], ps.flat[1])
    assert flat.shape == (geom.plan.N,)
    assert_same(geom.per_bucket_nodes(flat), want, atol=1e-12)
    assert_same([sk.bucket_backward_run_cuda(pg, ps.lo[k], ps.hi[k])
                 for k, pg in enumerate(geom.buckets)], want, atol=1e-12)
    assert_same(geom.per_bucket_nodes(tuf.backward_run(geom, ps.flat[0], ps.flat[1])), want,
                atol=1e-12)
    assert not any(sk.LAUNCHES.values())
    rng = np.random.RandomState(2)
    gs = [rng.randn(g.H, g.B) for g in geom.buckets]
    stepped = tuf.gradient_step(geom, ps, layout.flatten([torch.from_numpy(x) for x in gs]), 0.1)
    assert_same(stepped.cft, uf.gradient_step(
        host.geom, state, tuple(jnp.asarray(x) for x in gs), 0.1).cft, atol=1e-12)


def test_per_layer_omega_and_alpha_f64():
    """[H, B] omega/alpha arrays (the learned-solver contract) go through."""
    host, state, dl, dh, port, ps, tl, th = jax_setup(GRID, jnp.float64, True)
    rng = np.random.RandomState(0)
    g, pg = host.geom.buckets[0], port.geom.buckets[0]
    om = rng.uniform(0.2, 0.8, size=(g.H, g.B))
    al = np.asarray(g.alpha) * rng.uniform(0.5, 1.0, size=(g.H, g.B))
    ref = uf.bucket_forward_iteration(g, state.lo[0], state.hi[0], state.cft[0],
                                      jnp.asarray(om), dl[0], dh[0], alpha=jnp.asarray(al))
    out = tuf.bucket_forward_iteration(pg, ps.lo[0], ps.hi[0], ps.cft[0],
                                       torch.from_numpy(om), tl[0], th[0],
                                       alpha=torch.from_numpy(al))
    assert_same(out, ref, atol=1e-12)


@pytest.mark.parametrize("name,lp,pack", CASES, ids=[c[0] for c in CASES])
def test_twins_match_pallas_kernels_f32(name, lp, pack):
    """The Pallas kernels are really called here (interpret mode), not the
    XLA scan that ``uniform._sweep_fns`` picks on the CPU."""
    host, state, dl, dh, port, ps, tl, th = jax_setup(lp, jnp.float32, pack)
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        ref_f = pu.bucket_forward_iteration_pallas(
            g, state.lo[k], state.hi[k], state.cft[k], 0.5,
            jnp.asarray(dl[k]), jnp.asarray(dh[k]),
        )
        out_f = tuf.bucket_forward_iteration(pg, ps.lo[k], ps.hi[k], ps.cft[k], 0.5, tl[k], th[k])
        assert_same(out_f, ref_f, atol=1e-5, rtol=1e-6)
        ref_b = pu.bucket_backward_iteration_pallas(
            g, ref_f[0], ref_f[1], ref_f[3], 0.5, jnp.asarray(dl[k]), jnp.asarray(dh[k])
        )
        out_b = tuf.bucket_backward_iteration(
            pg, out_f[0], out_f[1], out_f[3], 0.5, tl[k], th[k]
        )
        assert_same(out_b, ref_b, atol=1e-5, rtol=1e-6)


def test_forcing_survives_alpha_quarter_f32():
    """Forcing (±inf) must propagate for a variable in 4 BDDs (alpha = 1/4):
    the regression the Pallas BIG arithmetic once had (pallas_uniform.py:71)."""
    nh = NativeHost(FORCING, "input")
    host = nh.make_uniform_host(dtype=jnp.float32)
    ref = uf.init_uniform_state(host, nh.objective(), dtype=jnp.float32)
    ref = uf.iterations(host.geom, ref, 30, 0.5)
    lb_ref = float(uf.lower_bound_with_deferred(host.geom, ref))
    pnh = PortNativeHost(FORCING, "input")
    port = layout.from_native_host(pnh, dtype=torch.float32, device="cpu")
    st = tuf.init_uniform_state(port, pnh.objective())
    st = tuf.iterations(port.geom, st, 30, 0.5)
    lb = float(tuf.lower_bound_with_deferred(port.geom, st))
    assert lb == pytest.approx(lb_ref, abs=1e-4)
    assert any(bool(torch.isinf(m).any()) for m in st.def_mm)
    ilp_opt = 1.0  # x = 1, y + z = 2, w = 0
    assert lb <= ilp_opt + 1e-4


def test_wrappers_run_twins_on_cpu_without_launching():
    host, state, dl, dh, port, ps, tl, th = jax_setup(GRID, jnp.float64, False)
    sk.reset_launch_counts()
    g = port.geom.buckets[0]
    out = sk.bucket_forward_iteration_cuda(g, ps.lo[0], ps.hi[0], ps.cft[0], 0.5, tl[0], th[0])
    ref = tuf.bucket_forward_iteration(g, ps.lo[0], ps.hi[0], ps.cft[0], 0.5, tl[0], th[0])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    out_b = sk.bucket_backward_iteration_cuda(g, out[0], out[1], out[3], 0.5, tl[0], th[0])
    ref_b = tuf.bucket_backward_iteration(g, out[0], out[1], out[3], 0.5, tl[0], th[0])
    for a, b in zip(out_b, ref_b):
        assert torch.equal(a, b)
    assert not any(sk.LAUNCHES.values())


def test_nvcc_command_targets_sm90a_without_fast_math():
    cmd = _build.nvcc_command("nvcc", "out.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    assert "-fmad=false" in cmd
    assert cmd[-1] == _build.SOURCE and cmd[-1].endswith("csrc/uniform_sweep.cu")
    assert _build.library_path().startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("pack", [False, True], ids=["raw", "packed"])
def test_half_sweeps_match_jax_f64_every_width(pack):
    """The twins on decoded bytes at every slot width P = 1..32."""
    from tests.test_torch_kernels import wide_lp

    host, state, dl, dh, port, ps, tl, th = jax_setup(wide_lp(), jnp.float64, pack, order="input")
    assert sorted({g.P for g in port.geom.buckets}) == [1, 2, 4, 8, 16, 32]
    for k, g in enumerate(host.geom.buckets):
        pg = port.geom.buckets[k]
        ref_f = uf.bucket_forward_iteration(
            g, state.lo[k], state.hi[k], state.cft[k], 0.5, dl[k], dh[k]
        )
        out_f = tuf.bucket_forward_iteration(pg, ps.lo[k], ps.hi[k], ps.cft[k], 0.5, tl[k], th[k])
        assert_same(out_f, ref_f, atol=1e-12)
        ref_b = uf.bucket_backward_iteration(g, ref_f[0], ref_f[1], ref_f[3], 0.5, dl[k], dh[k])
        out_b = tuf.bucket_backward_iteration(pg, out_f[0], out_f[1], out_f[3], 0.5, tl[k], th[k])
        assert_same(out_b, ref_b, atol=1e-12)


def test_host_library_build_command_and_paths():
    assert _build.host_library_path().startswith(_build.BUILD_DIR)
    assert _build.host_library_path() != _build.library_path()
    assert _build.HOST_SOURCE.endswith("csrc/bdd_host.cpp")
