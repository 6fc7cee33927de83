from .ops import (gather_rows, neighbor_agg, neighbor_agg_bwd,
                  neighbor_agg_csr, segment_sum)
from .ref import (neighbor_agg_bwd_ref, neighbor_agg_csr_ref,
                  neighbor_agg_ref, neighbor_mean_csr_ref, neighbor_mean_ref)

__all__ = ["gather_rows", "neighbor_agg", "neighbor_agg_bwd",
           "neighbor_agg_csr", "segment_sum", "neighbor_agg_ref",
           "neighbor_agg_bwd_ref", "neighbor_agg_csr_ref",
           "neighbor_mean_csr_ref", "neighbor_mean_ref"]
