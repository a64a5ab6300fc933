"""Format converter CLIs (ref: src/ILP/convert_lp_to_opb.cpp, convert_opb_to_lp.cpp).

    python -m bdd_tpu.ilp lp2opb in.lp  > out.opb
    python -m bdd_tpu.ilp opb2lp in.opb > out.lp
    python -m bdd_tpu.ilp lp2mps in.lp  > out.mps
    python -m bdd_tpu.ilp mps2lp in.mps > out.lp
"""
import sys

from bdd_tpu_torch.ilp.lp_parser import parse_lp_file
from bdd_tpu_torch.ilp.mps_parser import parse_mps_file
from bdd_tpu_torch.ilp.opb_parser import parse_opb_file


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or argv[0] not in ("lp2opb", "opb2lp", "lp2mps", "mps2lp"):
        print(__doc__)
        return 1
    mode, path = argv
    if mode == "lp2opb":
        sys.stdout.write(parse_lp_file(path).write_opb())
    elif mode == "opb2lp":
        sys.stdout.write(parse_opb_file(path).write_lp())
    elif mode == "lp2mps":
        sys.stdout.write(parse_lp_file(path).write_mps())
    else:
        sys.stdout.write(parse_mps_file(path).write_lp())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
