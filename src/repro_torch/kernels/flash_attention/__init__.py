from .ops import flash_attention, flash_attention_bwd
from .ref import (attention_bwd_abs_ref, attention_bwd_ref,
                  attention_lse_ref, attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "attention_ref",
           "attention_lse_ref", "attention_bwd_ref", "attention_bwd_abs_ref"]
