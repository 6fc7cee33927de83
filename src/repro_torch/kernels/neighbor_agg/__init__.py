from .ops import gather_rows, neighbor_agg, neighbor_agg_bwd, segment_sum
from .ref import neighbor_agg_bwd_ref, neighbor_agg_ref, neighbor_mean_ref

__all__ = ["gather_rows", "neighbor_agg", "neighbor_agg_bwd", "segment_sum",
           "neighbor_agg_ref", "neighbor_agg_bwd_ref", "neighbor_mean_ref"]
