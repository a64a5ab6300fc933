"""Readings for the check's limits of a cell, over seeds, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1]

Per seed: the program set up as a run sets it up, one solve (the window's
solves are alike, so this is what a run's check sees), and the numbers of
:func:`portbench.harness.compare` against the float64 reference; with
``--control 1`` also the numbers of the control, the reference itself in
bfloat16, the precision below the configuration's float32. One JSON line a
seed on stdout. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CONTROL = {"float": "bfloat16", "double": "float32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from portbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        cell = harness.Cell(args.workload, seed, args.device)
        cell.set_up()
        cell.solve()
        t_setup = time.monotonic() - t
        t = time.monotonic()
        lb, _ = cell.solve()
        t_solve = time.monotonic() - t
        out = cell.outputs(lb)
        cell.release()
        t = time.monotonic()
        ref = cell.reference()
        t_ref = time.monotonic() - t
        layout = cell.layout()
        line = {"workload": args.workload, "seed": seed, "lower_bound": lb,
                "reference_bound": ref.lower_bound,
                "program": harness.compare(out, ref, layout),
                "setup_s": t_setup, "solve_s": t_solve, "reference_s": t_ref,
                "nodes": layout.nr_nodes, "slots": layout.nr_slots, "bdds": layout.nr_bdds}
        if args.control:
            dtype = getattr(torch, CONTROL[cell.config["solver"].get("precision", "float")])
            ctl = cell.reference(dtype)
            line["control"] = harness.compare(harness.reference_outputs(ctl, layout), ref, layout)
            line["control_dtype"] = str(dtype)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
