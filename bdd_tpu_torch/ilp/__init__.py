"""ILP model and LP parser (copies of bdd_tpu/ilp/model.py and lp_parser.py;
the MPS and OPB parsers are not ported yet)."""
from bdd_tpu_torch.ilp.model import ILPInput, Constraint, Ineq
from bdd_tpu_torch.ilp.lp_parser import parse_lp_string, parse_lp_file

__all__ = ["ILPInput", "Constraint", "Ineq", "parse_lp_string", "parse_lp_file"]
