"""Persistent serving mode: one warm process, many solves (counterpart of
bdd_tpu/serve.py).

A one-shot CLI run pays process start, the CUDA context and the load of both
native libraries before its first iteration. This server keeps the process
warm: requests are JSON solver configs, the same schema as
``python -m bdd_tpu_torch.api``, read one per line from stdin; one JSON result
is written per line to stdout. What stays warm between requests is the CUDA
context, the two loaded libraries (host library and sweep kernels) and the
cache of launch plans (``layout.launch_plan``). The dtype of a solve is
explicit in its config, so no process-wide state changes between requests.

Protocol (JSONL):
    {"input": "a.lp", ...}            -> one result object
    {"inputs": ["a.lp", "b.lp"], ...} -> list of results (batched serving)
    {"shutdown": true}                -> {"status": "bye"} and exit

A request that cannot be served (not an object, a missing file, an unknown
solver name) answers {"status": "error", "message": ...} and the loop goes on:
that is the protocol, not a fallback. Nothing else is caught.

Usage: python -m bdd_tpu_torch.serve [--device cuda] [< requests.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def handle_request(config, device="cuda") -> "dict | list":
    """Solve one request (a JSON solver config) in-process on ``device``.
    Any failure, including a non-object request, returns an error result; the
    warm server must never die on a bad request."""
    t0 = time.time()
    try:
        if not isinstance(config, dict):
            raise TypeError(
                f"request must be a JSON object, got {type(config).__name__}")
        if config.get("shutdown"):
            return {"status": "bye"}
        from bdd_tpu_torch.api import BddSolver

        solver = BddSolver(config, device=device)
        verbose = bool(config.get("verbose", False))
        if "inputs" in config:
            result = solver.solve_batch(paths=config["inputs"], verbose=verbose)
        else:
            result = solver.solve(verbose=verbose)
    except Exception as exc:  # a bad request must not kill the server
        return {"status": "error", "message": f"{type(exc).__name__}: {exc}"}
    wall = time.time() - t0
    if isinstance(result, dict):
        result["wall_s"] = round(wall, 3)
    return result


def _json_safe(x):
    """RFC-8259-safe payload: json.dumps would emit the non-standard
    ``Infinity``/``NaN`` tokens for non-finite floats (infeasible solves have
    lower_bound = inf), which strict parsers reject; encode them as
    strings."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return repr(x)
    return x


def serve(lines, out, device="cuda") -> int:
    """Run the request loop over an iterable of JSONL lines; returns the
    number of requests served."""
    n = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            config = json.loads(line)
        except json.JSONDecodeError as exc:
            out.write(json.dumps(
                {"status": "error", "message": f"bad json: {exc}"}) + "\n")
            out.flush()
            continue
        result = handle_request(config, device)
        out.write(json.dumps(_json_safe(result), default=str) + "\n")
        out.flush()
        n += 1
        if isinstance(result, dict) and result.get("status") == "bye":
            break
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bdd_tpu_torch.serve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bdd_tpu_torch.solver.layout import resolve_device
    from bdd_tpu_torch.utils.logging import set_console

    resolve_device(args.device)  # no card where one is asked for: fail before serving
    print("# bdd_tpu_torch serve: one JSON config per line on stdin; "
          "results on stdout", file=sys.stderr, flush=True)
    set_console(sys.stderr)  # stdout carries the results and nothing else
    try:
        serve(sys.stdin, sys.stdout, args.device)
    finally:
        set_console(None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
