from .ops import embedding_bag, embedding_bag_bwd
from .ref import embedding_bag_bwd_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_bwd", "embedding_bag_bwd_ref",
           "embedding_bag_ref"]
