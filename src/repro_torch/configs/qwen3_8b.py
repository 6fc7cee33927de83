"""qwen3-8b [dense] 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
The numbers are those of ``src/repro/configs/qwen3_8b.py``."""
from .lm_common import make_lm_arch

ARCH = make_lm_arch(
    "qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0,
    accum_steps={"train_4k": 2},
    notes="GQA kv=8; qk-norm per head",
)
