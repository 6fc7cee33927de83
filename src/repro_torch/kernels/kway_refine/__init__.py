from .ops import kway_gains
from .ref import kway_gains_ref

__all__ = ["kway_gains", "kway_gains_ref"]
