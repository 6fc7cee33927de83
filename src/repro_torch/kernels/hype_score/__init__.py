from .ops import SELECT_PAD, hype_score_select
from .ref import hype_score_select_ref

__all__ = ["SELECT_PAD", "hype_score_select", "hype_score_select_ref"]
