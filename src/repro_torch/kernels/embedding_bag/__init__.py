from .ops import embedding_bag
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]
