from repro_torch.graph.csr import (CSRGraph, from_edges, to_edges, reverse,
                                   coalesce_ic, rows_dst_sorted, graph_digest,
                                   degrees)
from repro_torch.graph.weights import (wc_weights, uniform_weights,
                                       trivalency_weights)
from repro_torch.graph import generators

__all__ = [
    "CSRGraph", "from_edges", "to_edges", "reverse", "coalesce_ic",
    "rows_dst_sorted", "graph_digest", "degrees",
    "wc_weights", "uniform_weights", "trivalency_weights", "generators",
]
