from .ops import neighbor_agg, neighbor_agg_bwd
from .ref import neighbor_agg_bwd_ref, neighbor_agg_ref, neighbor_mean_ref

__all__ = ["neighbor_agg", "neighbor_agg_bwd", "neighbor_agg_ref",
           "neighbor_agg_bwd_ref", "neighbor_mean_ref"]
