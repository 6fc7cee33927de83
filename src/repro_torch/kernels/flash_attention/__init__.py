from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
