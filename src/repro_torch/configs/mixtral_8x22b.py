"""mixtral-8x22b [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA — [arXiv:2401.04088; hf].
The numbers are those of ``src/repro/configs/mixtral_8x22b.py``."""
from ..models.moe import MoEConfig
from .lm_common import make_lm_arch

ARCH = make_lm_arch(
    "mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    window=4096,                       # sliding-window attention
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    accum_steps={"train_4k": 4},
    notes="SWA window 4096 -> rolling KV cache; runs long_500k",
)
