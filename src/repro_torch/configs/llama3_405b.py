"""llama3-405b [dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA 128k vocab [arXiv:2407.21783; unverified].
The numbers are those of ``src/repro/configs/llama3_405b.py``."""
from .lm_common import make_lm_arch

ARCH = make_lm_arch(
    "llama3-405b",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256,
    rope_theta=500_000.0,
    accum_steps={"train_4k": 8},
    notes="largest assigned arch; bf16 optimizer moments (see DESIGN.md)",
)
