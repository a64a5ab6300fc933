"""The port's JSONL server against the protocol of ``bdd_tpu.serve``
(counterparts of tests/test_api_extra.py:216-288): the same request lines go
through both servers; statuses agree, bounds agree to rel 1e-4 (float32
default path; the two exchanges sum in another order), and a bad request
answers ``error`` while the loop lives.
"""
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

import jax

jax.config.update("jax_enable_x64", True)

import torch

from bdd_tpu import serve as jax_serve
from bdd_tpu_torch import serve as port_serve
from tests import fixtures

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two intra-op threads while this module runs, restored afterwards (the
    suite runs several workers; see tests/test_torch_sweep.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def requests(tmp_path):
    lp = tmp_path / "p.lp"
    lp.write_text(fixtures.COVERING)
    it = {"termination criteria": {"maximum iterations": 100}}
    return [
        json.dumps({"input": str(lp), "relaxation solver": "ref mma", **it}),
        "this is not json",
        json.dumps({"input": str(tmp_path / "missing.lp")}),
        json.dumps({"inputs": [str(lp), str(lp)], **it}),
        json.dumps({"input": str(lp), **it}),
        json.dumps({"shutdown": True}),
        json.dumps({"input": str(lp)}),  # after shutdown: not served
    ]


def run(server, reqs, **kw):
    out = io.StringIO()
    n = server.serve(reqs, out, **kw)
    return n, [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_jsonl_loop(tmp_path):
    n, lines = run(port_serve, requests(tmp_path), device="cpu")
    # the line that is no JSON is answered but not counted; the request after
    # shutdown is never served
    assert n == 5 and len(lines) == 6
    assert lines[0]["status"] == "solved" and "wall_s" in lines[0]
    assert lines[1]["status"] == "error" and "bad json" in lines[1]["message"]
    assert lines[2]["status"] == "error" and "missing.lp" in lines[2]["message"]
    assert isinstance(lines[3], list) and len(lines[3]) == 2
    assert all(r["status"] == "solved" and "solution" in r for r in lines[3])
    assert lines[4]["status"] == "solved" and "solution" in lines[4]
    assert lines[5] == {"status": "bye"}


def test_serve_answers_like_the_jax_server(tmp_path):
    reqs = requests(tmp_path)
    n_port, port = run(port_serve, reqs, device="cpu")
    n_jax, ref = run(jax_serve, reqs)
    assert n_port == n_jax and len(port) == len(ref)
    for a, b in zip(port, ref):
        if isinstance(b, list):
            assert [r["status"] for r in a] == [r["status"] for r in b]
            for x, y in zip(a, b):
                assert x["lower_bound"] == pytest.approx(y["lower_bound"], rel=1e-4, abs=1e-4)
        else:
            assert a["status"] == b["status"]
            if b["status"] == "solved":
                assert a["lower_bound"] == pytest.approx(b["lower_bound"], rel=1e-4, abs=1e-4)
                assert a["objective"] == pytest.approx(b["objective"], abs=1e-6)
    assert port[0]["lower_bound"] == ref[0]["lower_bound"]  # ref mma: numpy on both sides


def test_serve_non_object_request_isolated():
    n, lines = run(port_serve, ["42", "[1, 2]", json.dumps({"shutdown": True})], device="cpu")
    assert lines[0]["status"] == "error" and "object" in lines[0]["message"]
    assert lines[1]["status"] == "error"
    assert lines[2]["status"] == "bye"


def test_serve_key_that_waits_answers_error_and_goes_on(tmp_path):
    """A request the server cannot serve (an unknown relaxation solver name:
    no name of the JAX package waits any more) answers an error, and the
    server answers the next line."""
    lp = tmp_path / "p.lp"
    lp.write_text(fixtures.COVERING)
    n, lines = run(port_serve, [json.dumps({"input": str(lp), "relaxation solver": "bogus mma"}),
                                json.dumps({"input": str(lp), "precision": "double",
                                            "perturbation rounding": False})], device="cpu")
    assert n == 2
    assert lines[0]["status"] == "error" and "unknown relaxation solver" in lines[0]["message"]
    assert lines[1]["status"] == "solved" and "solution" not in lines[1]


def test_json_safe_encodes_non_finite_floats():
    res = port_serve._json_safe({"lower_bound": float("inf"), "x": [float("nan"), 1.5, -float("inf")]})
    assert res == jax_serve._json_safe({"lower_bound": float("inf"),
                                        "x": [float("nan"), 1.5, -float("inf")]})
    assert json.loads(json.dumps(res)) == {"lower_bound": "inf", "x": ["nan", 1.5, "-inf"]}
    n, lines = run(port_serve, [json.dumps({"shutdown": True})], device="cpu")
    assert n == 1 and lines == [{"status": "bye"}]


def test_server_process_keeps_stdout_for_results(tmp_path):
    """``python -m bdd_tpu_torch.serve --device cpu``: every stdout line is a
    JSON result; the log goes to stderr."""
    lp = tmp_path / "p.lp"
    lp.write_text(fixtures.COVERING)
    lines = [json.dumps({"input": str(lp), "use native preprocessing": False,
                         "termination criteria": {"maximum iterations": 50}}),
             json.dumps({"shutdown": True})]
    proc = subprocess.run([sys.executable, "-m", "bdd_tpu_torch.serve", "--device", "cpu"],
                          input="\n".join(lines) + "\n", capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["status"] for r in out] == ["solved", "bye"]
    assert "python preprocessing pipeline" in proc.stderr


def test_server_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(["--device", "cuda"])
