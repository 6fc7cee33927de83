from .ops import SELECT_PAD, hype_score_select, hype_scores
from .ref import hype_score_select_ref, hype_scores_ref

__all__ = ["SELECT_PAD", "hype_score_select", "hype_score_select_ref",
           "hype_scores", "hype_scores_ref"]
