from .ops import (SELECT_PAD, hype_score_select, hype_score_select_shard,
                  hype_scores, stream_commit)
from .ref import (hype_score_select_ref, hype_score_select_shard_ref,
                  hype_scores_ref, stream_commit_ref)

__all__ = ["SELECT_PAD", "hype_score_select", "hype_score_select_ref",
           "hype_score_select_shard", "hype_score_select_shard_ref",
           "hype_scores", "hype_scores_ref", "stream_commit",
           "stream_commit_ref"]
