from .ops import kway_gains, kway_gains_csr
from .ref import kway_gains_csr_ref, kway_gains_ref

__all__ = ["kway_gains", "kway_gains_csr", "kway_gains_csr_ref",
           "kway_gains_ref"]
