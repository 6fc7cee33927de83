"""The per-arch optimizer settings of ``src/repro/launch/cells.py``.

Only the table is ported: the train launcher takes an arch's AdamW from
it. The cell builders (``build_cell`` and the sharded plans) stay
unported: the port's launchers build their steps directly (ROADMAP.md,
queue 1, "Not to port").
"""
from __future__ import annotations

import torch

from ..train.optimizer import AdamWConfig

# per-arch optimizer settings (moment dtype matters for memory at 405B)
_OPT = {
    "llama3-405b": AdamWConfig(lr=8e-5, moment_dtype=torch.bfloat16),
    "mixtral-8x22b": AdamWConfig(lr=1e-4),
}
_DEFAULT_OPT = AdamWConfig()


def opt_config(arch_id: str) -> AdamWConfig:
    """The AdamW config the JAX launcher trains ``arch_id`` with."""
    return _OPT.get(arch_id, _DEFAULT_OPT)
