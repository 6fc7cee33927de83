"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 — [hf:stabilityai/stablelm-2-1_6b; unverified].
The numbers are those of ``src/repro/configs/stablelm_3b.py``."""
from .lm_common import make_lm_arch

ARCH = make_lm_arch(
    "stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    rope_theta=10_000.0,
    accum_steps={"train_4k": 2},
    notes="MHA (kv=32); SwiGLU",
)
