"""granite-moe-3b-a800m [moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 — [hf:ibm-granite/granite-3.0-1b-a400m-base;
hf]. (The assignment's structured field says 40e top-8; we follow it.)
The numbers are those of ``src/repro/configs/granite_moe_3b_a800m.py``."""
from ..models.moe import MoEConfig
from .lm_common import make_lm_arch

ARCH = make_lm_arch(
    "granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, capacity_factor=1.25),
    rope_theta=10_000.0,
    accum_steps={"train_4k": 2},
    notes="fine-grained MoE (40e top-8, tiny d_ff); 24 heads do not divide "
          "the 16-way model axis -> attention heads replicated (see "
          "DESIGN.md sharding fallbacks). Production deployment enables "
          "pad_vocab + moe_shard_c (EXPERIMENTS.md §Perf D: 3.8x less "
          "collective wire); the registry default stays paper-baseline "
          "so the §Roofline table remains the before picture.",
)
