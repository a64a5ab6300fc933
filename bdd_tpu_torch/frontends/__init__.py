"""Problem frontends (copy of bdd_tpu/frontends/graph_matching.py; the MRF
and multi-graph-matching frontends are not ported yet)."""
from bdd_tpu_torch.frontends.graph_matching import (
    GraphMatchingInstance,
    parse_dd_string,
    parse_dd_file,
    construct_graph_matching_ilp,
)

__all__ = [
    "GraphMatchingInstance",
    "parse_dd_string",
    "parse_dd_file",
    "construct_graph_matching_ilp",
]
