"""The port's Python pipeline (ILP -> BddPreprocessor -> BddCollection ->
flatten_uniform / flat arrays -> solver -> rounding) against ``bdd_tpu``'s.

- ``flatten_uniform``: array for array (``assert_host_equal``: integer arrays
  equal, alpha to float rounding) over every generator of ``utils/problems``,
  a wide instance and a split one, packed float32 and raw float64.
- every input type and export: the same text from both packages.
- ``sequential mma`` / ``parallel mma`` are numpy on both sides: bit-equal.
- uniform solves in float64 through the Python pipeline: bounds to 1e-8, the
  host rounding methods draw from numpy seeds on both sides and give the same
  solutions.
"""
import json
import math

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import torch

from bdd_tpu import api as jax_api
from bdd_tpu.bdd.preprocessor import BddPreprocessor as JaxPreprocessor
from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp as jax_gm_ilp
from bdd_tpu.ilp import __main__ as jax_ilp_cli
from bdd_tpu.solver import extras as jax_extras
from bdd_tpu.solver import uniform as juf
from bdd_tpu.utils import problems as jax_problems
from bdd_tpu_torch import api
from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor as PortPreprocessor
from bdd_tpu_torch.frontends.graph_matching import construct_graph_matching_ilp as port_gm_ilp
from bdd_tpu_torch.ilp import __main__ as port_ilp_cli
from bdd_tpu_torch.solver import extras as port_extras
from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.utils import problems as port_problems
from tests import fixtures
from tests.test_frontends import DD_SMALL, UAI_CHAIN
from tests.test_torch_layout import assert_host_equal
from tests.test_torch_wide import MIXED


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lp(text):
    return lambda m, parse: parse(text)


# name -> (problems module, LP parser) -> ILP; the same call on either package
GENERATORS = {
    "grid_mrf": lambda m, _: m.grid_mrf(4, 3, 3, seed=1),
    "assignment": lambda m, _: m.assignment(5, seed=2),
    "set_cover": lambda m, _: m.set_cover(12, 25, density=0.2, seed=3),
    "independent_set": lambda m, _: m.independent_set(20, edge_prob=0.2, seed=4),
    "quadratic_assignment": lambda m, _: m.quadratic_assignment(3, seed=5),
    "cell_tracking": lambda m, _: m.cell_tracking(3, 4, seed=6),
    "graph_matching": None,  # through the frontend, below
    "wide": _lp(MIXED),
}


def both_ilps(name):
    from bdd_tpu.ilp import parse_lp_string as jparse
    from bdd_tpu_torch.ilp import parse_lp_string as pparse

    if name == "graph_matching":
        kw = dict(seed=7, candidates=3, nr_quadratic=12)
        return (jax_gm_ilp(jax_problems.graph_matching(6, 7, **kw))[0],
                port_gm_ilp(port_problems.graph_matching(6, 7, **kw))[0])
    return GENERATORS[name](jax_problems, jparse), GENERATORS[name](port_problems, pparse)


FLATTEN_CASES = [(name, None) for name in GENERATORS] + [
    (name, 4) for name in ("grid_mrf", "set_cover", "wide")]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("name,split", FLATTEN_CASES,
                         ids=[f"{n}-{'split4' if s else 'whole'}" for n, s in FLATTEN_CASES])
def test_flatten_uniform_equals_jax_array_for_array(name, split, precision):
    jdt, tdt = {"float": (jnp.float32, torch.float32),
                "double": (jnp.float64, torch.float64)}[precision]
    jilp, pilp = both_ilps(name)
    jilp.normalize()
    pilp.normalize()
    jp = JaxPreprocessor(jilp, split_chunk_size=split)
    pp = PortPreprocessor(pilp, split_chunk_size=split)
    assert pp.total_nr_variables() == jp.total_nr_variables()
    np.testing.assert_array_equal(pp.objective_vector(), jp.objective_vector())
    ref = juf.flatten_uniform(jp.collection, jp.total_nr_variables(), jp.nr_primal_variables,
                              dtype=jdt)
    port = layout.flatten_uniform(pp.collection, pp.total_nr_variables(),
                                  pp.nr_primal_variables, dtype=tdt, device="cpu")
    assert port.geom.buckets[0].packed == (precision == "float")
    assert_host_equal(port, ref, tdt)


# ------------------------------------------------------- inputs and exports
def _mgm_text():
    def block(costs):
        lines, a = ["p 2 2 4 0"], 0
        for i in range(2):
            for j in range(2):
                lines.append(f"a {a} {i} {j} {costs[i][j]}")
                a += 1
        return "\n".join(lines)

    ident, swap = [[-1.0, 0.0], [0.0, -1.0]], [[0.0, -1.0], [-1.0, 0.0]]
    return "\n".join(["gm 0 1", block(ident), "gm 0 2", block(ident), "gm 1 2", block(swap)])


def _input_texts():
    from bdd_tpu.ilp import parse_lp_string

    ilp = parse_lp_string(fixtures.COVERING)
    return {
        "p.lp": fixtures.COVERING,
        "p.opb": ilp.write_opb(),
        "p.mps": ilp.write_mps(),
        "p.uai": UAI_CHAIN,
        "p.dd": DD_SMALL,
        "p.mgm": _mgm_text(),
    }


INPUTS = [("p.lp", {}), ("p.opb", {}), ("p.mps", {}), ("p.uai", {}), ("p.dd", {}),
          ("p.mgm", {}), ("p.dd", {"input type": "graph matching"}),
          ("p.uai", {"input type": "mrf"}), ("p.mgm", {"input type": "mgm"})]


@pytest.mark.parametrize("fname,cfg", INPUTS, ids=[f"{f}-{c.get('input type', 'ext')}"
                                                   for f, c in INPUTS])
def test_every_input_type_reads_the_same_ilp(tmp_path, fname, cfg):
    path = tmp_path / fname
    path.write_text(_input_texts()[fname])
    want = jax_api.BddSolver({"input": str(path), **cfg}).read_ilp()
    got = api.BddSolver({"input": str(path), **cfg}, device="cpu").read_ilp()
    assert got.ilp.write_lp() == want.ilp.write_lp()
    assert got.ilp.nr_variables() == want.ilp.nr_variables() > 0


HOST_CFG = {"relaxation solver": "parallel mma", "precision": "double",
            "termination criteria": {"maximum iterations": 40}}


def test_exports_write_the_same_text(tmp_path, capsys):
    lp = port_problems.grid_mrf(3, 2, 2, seed=1).write_lp()
    out = {}
    for side, cls, kw in (("jax", jax_api.BddSolver, {}), ("port", api.BddSolver,
                                                            {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        cfg = {**HOST_CFG, "variable order": "bfs", "export lp": str(d / "e.lp"),
               "export bdd lp": str(d / "bdd.lp"), "export bdd graph": str(d / "g.dot"),
               "print statistics": True, "export difficult core": str(d / "core.lp")}
        s = cls(cfg, **kw)
        s.read_ilp(lp_string=lp)
        capsys.readouterr()
        res = s.solve(verbose=False)
        log = [l for l in capsys.readouterr().out.splitlines() if "[print_statistics]" in l]
        files = {p.name: p.read_text() for p in sorted(d.iterdir())}
        out[side] = (res, log, files)
    (jres, jlog, jfiles), (pres, plog, pfiles) = out["jax"], out["port"]
    assert plog == jlog and len(plog) == 6
    assert sorted(pfiles) == sorted(jfiles) and "g_0.dot" in pfiles and "core.lp" in pfiles
    assert pfiles == jfiles
    assert pres["lower_bound"] == jres["lower_bound"] and pres["solution"] == jres["solution"]


@pytest.mark.parametrize("ext", ["lp", "opb", "mps", "txt"])
def test_export_lp_formats(tmp_path, ext):
    cfgs = [{**HOST_CFG, "export lp": str(tmp_path / f"{side}.{ext}")} for side in "jp"]
    solvers = [jax_api.BddSolver(cfgs[0]), api.BddSolver(cfgs[1], device="cpu")]
    for s in solvers:
        s.read_ilp(lp_string=fixtures.COVERING)
        if ext == "txt":
            with pytest.raises(ValueError, match="Cannot recognize file extension"):
                s.solve(verbose=False)
        else:
            s.solve(verbose=False)
    if ext != "txt":
        assert (tmp_path / f"p.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()


@pytest.mark.parametrize("mode,src", [("lp2opb", "p.lp"), ("lp2mps", "p.lp"),
                                      ("opb2lp", "p.opb"), ("mps2lp", "p.mps")])
def test_converter_cli_prints_the_same_text(tmp_path, capsys, mode, src):
    path = tmp_path / src
    path.write_text(_input_texts()[src])
    assert jax_ilp_cli.main([mode, str(path)]) == 0
    want = capsys.readouterr().out
    assert port_ilp_cli.main([mode, str(path)]) == 0
    assert capsys.readouterr().out == want != ""


# ------------------------------------------------------------ host solvers
SMALL = {
    "covering": fixtures.COVERING,
    "matching": fixtures.MATCHING_3x3,
    "grid": port_problems.grid_mrf(3, 3, 2, seed=5).write_lp(),
}


def solve_both(lp, cfg, **read):
    ref = jax_api.BddSolver(dict(cfg))
    ref.read_ilp(lp_string=lp)
    port = api.BddSolver(dict(cfg), device="cpu").read_ilp(lp_string=lp)
    return port, port.solve(verbose=False), ref, ref.solve(verbose=False)


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("solver", ["sequential mma", "parallel mma", "ref mma"])
@pytest.mark.parametrize("name", list(SMALL))
def test_host_solvers_are_bit_equal_to_jax_package(name, solver, precision):
    cfg = {"relaxation solver": solver, "precision": precision,
           "termination criteria": {"maximum iterations": 60}}
    _, got, _, want = solve_both(SMALL[name], cfg)
    assert got["status"] == want["status"] == "solved"
    for key in ("lower_bound", "initial_lower_bound", "iterations", "solution", "objective"):
        assert got[key] == want[key], key


def test_host_solver_infeasible_and_dual_only():
    cfg = {**HOST_CFG, "perturbation rounding": False}
    _, got, _, want = solve_both(fixtures.INFEASIBLE, cfg)
    assert got == want == {"status": "infeasible", "lower_bound": math.inf}
    _, got, _, want = solve_both(fixtures.COVERING, cfg)
    assert "solution" not in got and got["lower_bound"] == want["lower_bound"]


# ------------------------------------------------- uniform, python pipeline
PY64 = {"use native preprocessing": False, "precision": "double",
        "termination criteria": {"maximum iterations": 100}}
ROUNDING = {
    "incremental": {},
    "wedelin": {"rounding method": "wedelin"},
    "biased": {"perturbation rounding": {"method": "biased"}},
    "best": {"rounding method": "best"},
}


@pytest.mark.parametrize("method", list(ROUNDING))
def test_python_pipeline_uniform_rounding_methods_match_jax_f64(method):
    port, got, ref, want = solve_both(SMALL["grid"], {**PY64, **ROUNDING[method]})
    assert type(port.solver).__name__ == "UniformSolver" and port._native is None
    assert got["iterations"] == want["iterations"]
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)
    assert got["solution"] == want["solution"]
    assert got["objective"] == pytest.approx(want["objective"], abs=1e-9)


@pytest.mark.parametrize("cfg", [{"split chunk size": 3}, {"split chunk size": "auto"},
                                 {"split bdds": {"split length": 3, "implication bdd": True}},
                                 {"split bdds": {}}],
                         ids=["chunk3", "auto", "split_bdds_impl", "split_bdds_auto"])
def test_split_keys_match_jax_f64(cfg):
    port, got, ref, want = solve_both(SMALL["grid"], {**PY64, **cfg,
                                                      "perturbation rounding": False})
    assert port.config["split chunk size"] == ref.config["split chunk size"]
    assert port.config["split implication"] == ref.config["split implication"]
    assert port.pre.collection.nr_bdds() == ref.pre.collection.nr_bdds()
    assert got["lower_bound"] == pytest.approx(want["lower_bound"], abs=1e-8)


def test_queries_match_jax_f64(tmp_path):
    cfg = {**PY64, "variable order": "bfs", "perturbation rounding": False}
    port, got, ref, want = solve_both(SMALL["grid"], cfg)
    assert port.var_perm == ref.var_perm and port.var_perm is not None
    assert port.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-8)
    for original in (True, False):
        a, b = port.min_marginals(original), ref.min_marginals(original)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-8)
    (na, la, ha), (nb, lb, hb) = (port.min_marginals_with_variable_names(),
                                  ref.min_marginals_with_variable_names())
    assert na == nb
    np.testing.assert_allclose(la, lb, atol=1e-8)
    np.testing.assert_allclose(ha, hb, atol=1e-8)
    cores = [s.export_difficult_core(str(tmp_path / f"{i}.lp"), threshold=1e-3)
             for i, s in enumerate((port, ref))]
    assert cores[0].write_lp() == cores[1].write_lp()
    assert (tmp_path / "0.lp").read_text() == (tmp_path / "1.lp").read_text()
    name = port.ilp.get_var_name(0)
    for s in (port, ref):
        s.fix_variable(name, 1)
        s.fix_variable(3, 0)
    assert port.lower_bound() == pytest.approx(ref.lower_bound(), abs=1e-8)


def test_queries_on_the_native_pipeline_use_its_names():
    s = api.BddSolver({"precision": "double", "perturbation rounding": False,
                       "termination criteria": {"maximum iterations": 30}}, device="cpu")
    s.read_ilp(lp_string=fixtures.MATCHING_3x3).solve(verbose=False)
    assert s._native is not None
    names, lo, hi = s.min_marginals_with_variable_names()
    assert set(names) == set(s._native.var_names()) and len(lo) == len(hi) == len(names)
    before = s.lower_bound()
    s.fix_variable(s._native.var_names()[0], 0)
    assert s.lower_bound() >= before - 1e-9


def test_extras_match_jax_on_the_host_solver():
    port, _, ref, _ = solve_both(SMALL["grid"], {**HOST_CFG, "perturbation rounding": False})
    fa, ra = port_extras.solve_easy_variables(port.solver, port.ilp, margin=1e-3)
    fb, rb = jax_extras.solve_easy_variables(ref.solver, ref.ilp, margin=1e-3)
    assert fa == fb and ra.write_lp() == rb.write_lp()
    port_extras.fix_variables(port.solver, {0: 1, 2: 0})
    jax_extras.fix_variables(ref.solver, {0: 1, 2: 0})
    assert port.solver.lower_bound() == ref.solver.lower_bound()
    a = port_extras.wedelin_rounding(port.solver, verbose=False)
    b = jax_extras.wedelin_rounding(ref.solver, verbose=False)
    assert (a is None) == (b is None) and (a is None or list(a) == list(b))


# ------------------------------------------------- which pipeline, and why
@pytest.mark.parametrize("cfg,why", [
    ({}, "native preprocessing pipeline"),
    ({"use native preprocessing": False}, "'use native preprocessing' is off"),
    ({"print statistics": True}, "'print statistics' needs the python"),
    ({"relaxation solver": "parallel mma"}, "takes the flat BDD arrays"),
    ({"split chunk size": 4}, "BDD splitting"),
    ({"rounding method": "wedelin"}, "rounding method 'wedelin'"),
], ids=["native", "off", "export", "host_solver", "split", "wedelin"])
def test_one_log_line_says_which_pipeline_ran_and_why(capsys, cfg, why):
    s = api.BddSolver({"termination criteria": {"maximum iterations": 20}, **cfg}, device="cpu")
    s.read_ilp(lp_string=fixtures.COVERING).solve(verbose=False)
    lines = [l for l in capsys.readouterr().out.splitlines() if "preprocessing pipeline" in l]
    assert len(lines) == 1 and why in lines[0]
    assert (s._native is not None) == (not cfg)


def test_only_native_unsupported_selects_the_python_pipeline(monkeypatch, capsys):
    from bdd_tpu_torch.native import NativeUnsupported

    def refuse(*a):
        raise NativeUnsupported("native parse failed: test")

    def crash(*a):
        raise RuntimeError("host library crashed")

    monkeypatch.setattr(api, "NativeHost", refuse)
    s = api.BddSolver({"termination criteria": {"maximum iterations": 20}}, device="cpu")
    res = s.read_ilp(lp_string=fixtures.COVERING).solve(verbose=False)
    assert res["status"] == "solved" and "does not take this input" in capsys.readouterr().out
    monkeypatch.setattr(api, "NativeHost", crash)
    with pytest.raises(RuntimeError, match="crashed"):
        api.BddSolver({}, device="cpu").read_ilp(lp_string=fixtures.COVERING).solve(verbose=False)


@pytest.mark.parametrize("name", ["dense mma"])
def test_solvers_that_wait_name_their_roadmap_item(name):
    """No solver name waits any more: the last one that did ("dense mma",
    ROADMAP.md Queue 1 item 15) solves, and every relaxation solver name of
    the JAX package's ``construct_solver`` is taken by the port's."""
    import inspect
    import re

    names = set(re.findall(r'"([a-z ]*mma[a-z ]*|subgradient)"',
                           inspect.getsource(jax_api.BddSolver.construct_solver)))
    assert name in names and len(names) >= 20
    for other in sorted(names):
        api.BddSolver({"relaxation solver": other}, device="cpu")  # raises nothing
    res = api.BddSolver({"relaxation solver": name}, device="cpu").read_ilp(
        lp_string=fixtures.MATCHING_3x3).solve(verbose=False)
    assert res["status"] == "solved" and math.isfinite(res["lower_bound"])


def test_unknown_names_raise_value_errors():
    for cfg in ({"relaxation solver": "no such"}, {"variable order": "no such"},
                {"precision": "half"}):
        with pytest.raises(ValueError, match="unknown"):
            api.BddSolver(cfg, device="cpu")


def test_cli_solves_a_batch_of_inputs(tmp_path, capsys):
    paths = []
    for k, text in enumerate((fixtures.COVERING, fixtures.MATCHING_3x3)):
        p = tmp_path / f"{k}.lp"
        p.write_text(text)
        paths.append(str(p))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"inputs": paths, "precision": "double",
                               "termination criteria": {"maximum iterations": 100}}))
    assert api.main([str(cfg), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    results = json.loads(out[out.index("[\n"):])
    assert [r["status"] for r in results] == ["solved", "solved"]
