from bdd_tpu_torch.frontends.mrf_uai import MrfInput, parse_uai_string, parse_uai_file
from bdd_tpu_torch.frontends.graph_matching import (
    GraphMatchingInstance,
    parse_dd_string,
    parse_dd_file,
    construct_graph_matching_ilp,
)
from bdd_tpu_torch.frontends.multi_graph_matching import (
    parse_mgm_string,
    construct_multi_graph_matching_ilp,
)

__all__ = [
    "MrfInput",
    "parse_uai_string",
    "parse_uai_file",
    "GraphMatchingInstance",
    "parse_dd_string",
    "parse_dd_file",
    "construct_graph_matching_ilp",
    "parse_mgm_string",
    "construct_multi_graph_matching_ilp",
]
