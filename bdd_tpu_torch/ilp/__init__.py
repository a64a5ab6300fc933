from bdd_tpu_torch.ilp.model import ILPInput, Constraint, Ineq
from bdd_tpu_torch.ilp.lp_parser import parse_lp_string, parse_lp_file
from bdd_tpu_torch.ilp.mps_parser import parse_mps_string, parse_mps_file

__all__ = [
    "ILPInput",
    "Constraint",
    "Ineq",
    "parse_lp_string",
    "parse_lp_file",
    "parse_mps_string",
    "parse_mps_file",
]
