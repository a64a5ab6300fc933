"""The learned solver's features, GNN, trainer and checkpoints
(``bdd_tpu_torch/learn/``) against the JAX package's ``bdd_tpu/learn/``.

Both packages build the same packed float64 layout of the same LP (the port's
Python pipeline is a copy); the JAX package's features need a packed layout
under ``jax.jit`` (an unpacked bucket's root rows are a traced concatenate
there, which ``features.per_bdd_lb_vector`` cannot read back), so the
comparisons use packed ones. Parameters are carried from flax with the port's
own checkpoint code. Features and the GNN in float64 within 1e-10 / 1e-12,
the GNN in float32 within 1e-5; a training step and a rollout from carried
parameters within rel 1e-8 in float64 (the JAX side's parameters cast to
float64 too: flax keeps float32 parameters, and Adam would round there).
Then the behaviour tests of ``tests/test_learn.py`` on the port alone.
"""
import dataclasses
import functools
import glob
import os
import pickle

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch
from flax import serialization

from bdd_tpu.bdd import BddPreprocessor as JaxPreprocessor
from bdd_tpu.ilp import parse_lp_string as j_parse_lp_string
from bdd_tpu.learn import features as jft
from bdd_tpu.learn import model as jmodel
from bdd_tpu.learn import train as jtr
from bdd_tpu.solver import learned as jln
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils.problems import independent_set
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
from bdd_tpu_torch.ilp import parse_lp_string
from bdd_tpu_torch.learn import checkpoint as ck
from bdd_tpu_torch.learn import config_ct, config_gm, config_mis
from bdd_tpu_torch.learn import features as ft
from bdd_tpu_torch.learn import train as tr
from bdd_tpu_torch.learn.model import DogePredictor
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import learned as ln
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.utils.problems import cell_tracking
from bdd_tpu_torch.utils.problems import independent_set as t_independent_set
from tests import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(ROOT, "benchmarks", "doge_*.ckpt")))
MIS = independent_set(10, 0.35, seed=3).write_lp()
FULL = dict(dim=8, free_update=True, layer_norm=True, history_features=True,
            smooth_temps=(0.1, 10.0), activation="celu", use_lstm_var=True)


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers; see tests/test_torch_sweep.py), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def instances(lp=MIS):
    """(JAX, port) float64 instances of the same LP on the same packed layout."""
    a, b = j_parse_lp_string(lp), parse_lp_string(lp)
    a.normalize()
    b.normalize()
    jp, tp = JaxPreprocessor(a), BddPreprocessor(b)
    jhost = juf.flatten_uniform(jp.collection, jp.total_nr_variables(), jp.nr_primal_variables,
                                dtype=jnp.float64, pack=True)
    thost = layout.flatten_uniform(tp.collection, tp.total_nr_variables(),
                                   tp.nr_primal_variables, dtype=torch.float64, device="cpu",
                                   pack=True)
    return (jtr.Instance(jhost, jp.objective_vector(), dtype=jnp.float64, pre=jp),
            tr.Instance(thost, tp.objective_vector(), pre=tp))


def jflat(xs):
    return np.concatenate([np.asarray(x).ravel() for x in xs])


def carried(jparams, dtype):
    """A flax parameter tree as a port state_dict of ``dtype``."""
    sd = ck.params_from_flax(jax.tree.map(np.asarray, jparams))
    return {k: v.to(dtype) for k, v in sd.items()}


def test_layouts_and_graphs_agree():
    ji, ti = instances()
    assert ji.spec.E == ti.spec.E and ti.spec.nr_vars == ji.spec.nr_vars
    np.testing.assert_array_equal(ti.spec.layer_var.numpy(), np.asarray(ji.spec.layer_var))
    np.testing.assert_array_equal(ti.spec.layer_bdd.numpy(), np.asarray(ji.spec.layer_bdd))
    np.testing.assert_array_equal(ti.spec.coeff.numpy(), np.asarray(ji.spec.coeff))
    np.testing.assert_array_equal(ti.spec.rhs.numpy(), np.asarray(ji.spec.rhs))
    np.testing.assert_array_equal(ti.spec.con_type.numpy(), np.asarray(ji.spec.con_type))
    assert any(g.packed for g in ti.host.geom.buckets)


@pytest.mark.parametrize("history", [False, True])
def test_compute_features_match_jax(history):
    """Features of a state after learned iterations, with the history of
    those iterations, smooth-solution temperatures and previous bounds."""
    ji, ti = instances()
    rng = np.random.RandomState(1)
    E = ti.spec.E
    raw, om = rng.rand(E) + 0.1, rng.uniform(0.2, 0.9, E)
    jsplit = ft.split_like(ti.host, torch.from_numpy(raw))
    ja = jln.normalize_alpha(ji.host.geom, tuple(jnp.asarray(x.numpy()) for x in jsplit))
    jo = tuple(jnp.asarray(x.numpy()) for x in ft.split_like(ti.host, torch.from_numpy(om)))
    ta = ln.normalize_alpha(ti.host.geom, torch.from_numpy(raw))
    jout = jln.learned_iterations_with_stats(ji.host.geom, ji.state0, ja, jo, 4, history_itr=3)
    tout = ln.learned_iterations_with_stats(ti.host.geom, ti.state0, ta, torch.from_numpy(om), 4,
                                            history_itr=3)
    jprev = jft.per_bdd_lb_vector(ji.host, ji.state0)
    tprev = ft.per_bdd_lb_vector(ti.host, ti.spec, ti.state0)
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), rtol=0, atol=1e-12)
    temps = (0.1, 1.0, 10.0)
    jf = jax.jit(lambda st, h, p: jft.compute_features(
        ji.host, ji.spec, st, ji.objective, 1.0, history=h, smooth_temps=temps,
        prev_lb_per_bdd=p))(jout[0], tuple(jout[1:]) if history else None, jprev)
    tf = ft.compute_features(ti.host, ti.spec, tout[0], ti.objective, 1.0,
                             history=tuple(tout[1:]) if history else None, smooth_temps=temps,
                             prev_lb_per_bdd=tprev)
    for a, b in zip(jf, tf):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-10)
    assert tf[2].shape[1] == 9 + len(temps) + int(history)


def random_features(spec, widths, dtype, seed=0):
    rng = np.random.RandomState(seed)
    rows = (spec.nr_vars + 1, spec.nr_bdds + 1, spec.E)
    return [rng.randn(n, w).astype(dtype) * 3 for n, w in zip(rows, widths)]


PREDICTORS = {
    "layer_norm": dict(layer_norm=True),
    "celu": dict(activation="celu"),
    "lstm": dict(use_lstm_var=True),
    "free_update": dict(free_update=True, layer_norm=True),
}


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", list(PREDICTORS))
def test_predictor_with_flax_parameters_matches_flax(kind, dtype, atol):
    ji, ti = instances()
    kw = dict(dim=16, **PREDICTORS[kind])
    widths = (5, 7, 11)
    feats = random_features(ti.spec, widths, dtype)
    fmodel = jmodel.DogePredictor(**kw)
    jspec = ji.spec
    lstm = None
    if kw.get("use_lstm_var"):
        rng = np.random.RandomState(2)
        lstm = tuple(rng.randn(ti.spec.nr_vars + 1, 16).astype(dtype) for _ in range(2))
    jparams = fmodel.init(jax.random.PRNGKey(3), jspec, *map(jnp.asarray, feats),
                          lstm_state=None if lstm is None else tuple(map(jnp.asarray, lstm)))
    jparams = jax.tree.map(lambda x: x.astype(dtype), jparams)
    jout = fmodel.apply(jparams, jspec, *map(jnp.asarray, feats),
                        lstm_state=None if lstm is None else tuple(map(jnp.asarray, lstm)))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tmodel = DogePredictor(*widths, **kw).to(tdt)
    tmodel.load_state_dict(carried(jparams, tdt))
    tspec = ti.spec
    tout = tmodel(tspec, *map(torch.from_numpy, feats),
                  lstm_state=None if lstm is None else tuple(map(torch.from_numpy, lstm)))
    flat_j = jax.tree_util.tree_leaves(jout)
    flat_t = [t for x in tout for t in (x if isinstance(x, tuple) else (x,))]
    nr_out = 2 + int("free_update" in kw) + 2 * int("use_lstm_var" in kw)
    assert len(flat_j) == len(flat_t) == nr_out
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=atol)


def test_state_dict_and_flax_tree_are_the_same_leaves():
    _, ti = instances()
    model = DogePredictor(5, 9, 14, dim=8, use_lstm_var=True, free_update=True, layer_norm=True)
    sd = model.state_dict()
    back = ck.params_from_flax(ck.params_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    tree = ck.params_to_flax(sd)["params"]
    assert set(tree["OptimizedLSTMCell_0"]) == {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    assert set(tree["OptimizedLSTMCell_0"]["if"]) == {"kernel"}
    assert tree["MLP_0"]["Dense_0"]["kernel"].shape == (8 * 4, 8)


@pytest.mark.parametrize("path", CHECKPOINTS, ids=[os.path.basename(p) for p in CHECKPOINTS])
def test_reader_and_writer_equal_flax_on_the_checkpoints(path):
    assert len(CHECKPOINTS) == 6
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    want = serialization.msgpack_restore(blob["params"])
    got = ck.msgpack_restore(blob["params"])

    def same(a, b):
        if isinstance(a, dict):
            assert isinstance(b, dict) and list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    same(want, got)
    assert ck.msgpack_serialize(got) == blob["params"]
    cfg, sd = ck.load(path)
    assert cfg == blob["config"] and len(sd) >= 34


def test_port_checkpoints_load_in_jax_and_back(tmp_path):
    ji, ti = instances()
    cfg = dict(dim=8, nr_rounds=2, iters_per_round=2, free_update=True, history_features=True)
    t = tr.DogeTrainer(tr.TrainConfig(**cfg))
    t.init(ti)
    path = str(tmp_path / "port.ckpt")
    t.save(path)
    j = jtr.DogeTrainer()
    j.load(path, ji)
    assert j.cfg == jtr.TrainConfig(**cfg)
    got = ck.params_from_flax(jax.tree.map(np.asarray, j.params))
    for k, v in t.model.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    path2 = str(tmp_path / "jax.ckpt")
    j.save(path2)
    t2 = tr.DogeTrainer()
    t2.load(path2, ti)
    for k, v in t.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v.to(torch.float64))


@pytest.mark.parametrize("name", ["doge_gm120"])
def test_trained_checkpoints_roll_out_like_jax(name):
    """A trained checkpoint loaded by both trainers on the same instance: the
    bounds of a short rollout agree (the checkpoints' own protocol: history,
    smooth temperatures, free update, layer norm)."""
    ji, ti = instances()
    path = os.path.join(ROOT, "benchmarks", name + ".ckpt")
    j, t = jtr.DogeTrainer(), tr.DogeTrainer()
    j.load(path, ji)
    t.load(path, ti)
    assert t.cfg == tr.TrainConfig(**dataclasses.asdict(j.cfg))
    j.params = jax.tree.map(lambda x: x.astype(jnp.float64), j.params)
    np.testing.assert_allclose(t.run_learned_rounds(ti, 3), j.run_learned_rounds(ji, 3),
                               rtol=1e-8)


@pytest.mark.parametrize("name", ["doge_gm120", "doge_qap", "doge_qap16"])
def test_trained_checkpoints_run_in_the_port(name):
    _, ti = instances()
    t = tr.DogeTrainer()
    t.load(os.path.join(ROOT, "benchmarks", name + ".ckpt"), ti)
    lbs = t.run_learned_rounds(ti, 2)
    assert len(lbs) == 2 and all(np.isfinite(lbs))


@pytest.mark.parametrize("name", ["doge_ct", "doge_gm", "doge_mis"])
def test_older_checkpoints_predate_the_feature_set(name):
    """The three older checkpoints were trained on 3 BDD and 5 edge features;
    today's features are wider, and neither package's trainer builds a model
    of their widths (the JAX package's load raises a ScopeParamShapeError)."""
    _, ti = instances()
    with pytest.raises(RuntimeError, match="size mismatch"):
        tr.DogeTrainer().load(os.path.join(ROOT, "benchmarks", name + ".ckpt"), ti)


def test_train_step_and_rollout_match_jax():
    """Two training steps (three rounds, the last two with gradients, so the
    gradient also runs through the features of a round) and a rollout, from
    the same parameters, in float64: loss, updated parameters, bounds."""
    ji, ti = instances()
    cfg = dict(FULL, nr_rounds=3, iters_per_round=3, grad_rounds=2)
    j = jtr.DogeTrainer(jtr.TrainConfig(**cfg))
    j.init(ji)
    j.params = jax.tree.map(lambda x: x.astype(jnp.float64), j.params)
    j.opt_state = j.opt.init(j.params)
    t = tr.DogeTrainer(tr.TrainConfig(**cfg))
    t.init(ti)
    t.model.load_state_dict(carried(j.params, torch.float64))
    for _ in range(2):
        jl, tl = j.train_step(ji)["loss"], t.train_step(ti)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=1e-10)
    # atol: parameters the loss does not depend on (a shift of the alpha
    # logits, which the per-variable normalization removes; the free update's
    # bias, which its zero-mean projection removes) get gradients of rounding
    # noise, which Adam scales to lr * noise / eps, about 1e-11 a step
    got = t.model.state_dict()
    for k, v in carried(j.params, torch.float64).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-8, atol=1e-10, err_msg=k)
    np.testing.assert_allclose(t.run_learned_rounds(ti, 3), j.run_learned_rounds(ji, 3),
                               rtol=1e-8)


# ---------------------------------------------------- behaviour (port alone)
def make(lp=None, ilp=None, dtype=torch.float32):
    return tr.Instance.from_ilp(ilp if ilp is not None else parse_lp_string(lp), dtype=dtype,
                                device="cpu")


def test_graph_spec_and_features_on_matching():
    inst = make(fixtures.MATCHING_3x3)
    spec = inst.spec
    assert (spec.nr_vars, spec.nr_bdds) == (9, 6)
    var_f, bdd_f, layer_f = ft.compute_features(inst.host, spec, inst.state0, inst.objective)
    assert var_f.shape[0] == 10 and bdd_f.shape[0] == 7 and layer_f.shape[0] == spec.E
    assert all(torch.isfinite(x).all() for x in (var_f, bdd_f, layer_f))
    assert torch.allclose(var_f[:9, 1], torch.full((9,), 2.0))


def test_learned_rounds_monotone_and_fused_equals_streamed():
    inst = make(fixtures.MATCHING_3x3)
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=4, iters_per_round=5))
    t.init(inst)
    lbs = t.run_learned_rounds(inst)
    assert len(lbs) == 4 and all(np.isfinite(lbs))
    assert all(b >= a - 1e-4 for a, b in zip(lbs, lbs[1:]))
    assert t.run_learned_rounds(inst, fused=False) == lbs
    assert t.best_bound(inst) == max(lbs)


def test_training_improves_over_epochs():
    inst = make(ilp=t_independent_set(12, edge_prob=0.4, seed=1))
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=2, iters_per_round=4))
    t.init(inst)
    losses = [t.train_step(inst)["loss"] for _ in range(8)]
    assert all(np.isfinite(losses))
    assert min(losses[4:]) <= losses[0] + 1e-6


def test_replay_buffer_training():
    inst = make(ilp=t_independent_set(12, edge_prob=0.3, seed=4))
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=2, iters_per_round=3, use_replay=True,
                                      seed=1))
    t.init(inst)
    assert all(np.isfinite([t.train_step(inst)["loss"] for _ in range(5)]))
    assert len(t.replay._store) == 1
    states = next(iter(t.replay._store.values()))
    assert len(states) >= 2 and not any(x.requires_grad for s in states for x in s.flat)


def test_history_and_lstm_reach_the_policy():
    inst = make(fixtures.MATCHING_3x3)
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=3, iters_per_round=4,
                                      history_features=True, use_lstm_var=True))
    t.init(inst)
    assert all(np.isfinite([t.train_step(inst)["loss"] for _ in range(2)]))
    lbs = t.run_learned_rounds(inst)
    assert all(b >= a - 1e-4 for a, b in zip(lbs, lbs[1:]))
    geom = inst.host.geom
    al = ln.isotropic_alpha(geom)
    _, sol_avg, fo, so = ln.learned_iterations_with_stats(geom, inst.state0, al,
                                                          torch.full_like(al, 0.5), 4, 4)
    with torch.no_grad():
        lstm0 = t._zero_lstm(inst)
        _, o0, _, lstm1 = t._predict(inst, inst.state0, lstm0, t._zero_history(inst))
        _, o1, _, _ = t._predict(inst, inst.state0, lstm0, (sol_avg, fo, so))
        _, o2, _, _ = t._predict(inst, inst.state0, lstm1, t._zero_history(inst))
    assert float(lstm1[1].abs().max()) > 0
    assert float((o0 - o1).abs().max()) > 0 and float((o0 - o2).abs().max()) > 0


def test_free_update_is_zero_sum_per_variable():
    inst = make(fixtures.MATCHING_3x3)
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=2, iters_per_round=3, free_update=True))
    t.init(inst)
    with torch.no_grad():
        _, _, update, _ = t._predict(inst, inst.state0)
    valid = inst.spec.layer_valid
    assert bool((update[~valid] == 0).all())
    sums = inst.spec.var_segments.sum(update)
    assert float(sums.abs().max()) < 1e-5
    after = t._apply_free_update(inst.host.geom, inst.state0, update)
    assert bool((after.flat[1] - inst.state0.flat[1])[~valid].eq(0).all())
    assert np.isfinite(t.train_step(inst)["loss"])


def test_training_with_forced_variables_stays_finite():
    lp = "Minimize\nx1 + x2 - 2 x3 + x4\nSubject To\nx1 + x2 = 2\nx1 + x3 + x4 <= 2\n" \
         "x3 + x4 >= 1\nEnd"
    inst = make(lp)
    s = uf.iterations(inst.host.geom, inst.state0, 3, 0.5)
    assert torch.isinf(s.flat[2]).any()
    t = tr.DogeTrainer(tr.TrainConfig(nr_rounds=3, iters_per_round=3, dim=8, free_update=True))
    t.init(inst)
    for _ in range(2):
        assert np.isfinite(t.train_step(inst)["loss"])
    assert all(torch.isfinite(p.grad).all() for p in t.model.parameters())
    assert all(np.isfinite(t.run_learned_rounds(inst, nr_rounds=2)))


def test_batched_instance_sums_its_members():
    ilps = [t_independent_set(12, 0.3, seed=s) for s in (0, 1)]
    singles = [make(i.write_lp()) for i in ilps]
    batched = tr.Instance.from_ilps([parse_lp_string(i.write_lp()) for i in ilps],
                                    device="cpu")

    def init_lb(inst):
        return float(uf.lower_bound_with_deferred(inst.host.geom, inst.state0))

    assert init_lb(batched) == pytest.approx(sum(init_lb(s) for s in singles), abs=1e-4)
    t = tr.DogeTrainer(tr.TrainConfig(dim=16, nr_rounds=2, iters_per_round=2))
    t.init(batched)
    assert np.isfinite(t.train_step(batched)["loss"])
    lbs = t.run_learned_rounds(batched)
    assert all(b >= a - 1e-4 for a, b in zip(lbs, lbs[1:]))


def test_presets_and_cell_tracking():
    ilp = cell_tracking(3, 4, seed=1)
    assert ilp.feasible([0] * ilp.nr_variables())
    cfg = config_ct(nr_rounds=3, dim=16)
    assert cfg.free_update and cfg.iters_per_round == 1
    assert config_mis().nr_rounds == 20 and config_gm().smooth_temps == (0.1, 1.0, 10.0, 100.0)
    inst = make(ilp=ilp)
    t = tr.DogeTrainer(cfg)
    t.init(inst)
    assert np.isfinite(t.train_step(inst)["loss"])


def test_dual_metrics():
    m = tr.dual_metrics([-10.0, -8.0, -7.5], reference_lb=-7.0)
    assert m["final_gap"] == pytest.approx(0.5 / 7.0) and m["best_gap"] == m["final_gap"]


def test_instances_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.Instance.from_ilp(parse_lp_string(fixtures.MATCHING_3x3))
