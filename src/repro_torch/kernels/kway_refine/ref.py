"""Plain PyTorch version of the k-way move-gain kernel.

The same function as ``csrc/kway_gains.cu`` in tensor ops: the CPU path
of ``ops.kway_gains`` and the yardstick the card's kernel is compared
with. It counts with one scatter-add into a (B, k + 1) histogram (column
k collects every value outside ``[0, k)``), so no (B, k, L) compare
intermediate is built. Exact: every count is an integer below 2**24.
"""
from __future__ import annotations

import torch


def kway_gains_ref(parts: torch.Tensor, own: torch.Tensor,
                   k: int) -> torch.Tensor:
    """``gain[b, q] = #(parts[b] == q) - #(parts[b] == own[b] >= 0)``.

    parts (B, L) int32 neighbour partition ids, -1 padded; own (B,)
    int32 the row's own partition, -1 for a pad row. Returns (B, k)
    float32; column ``own[b]`` is 0 and a pad row (own = -1, parts all
    -1) is all zero, as in the JAX package's ``kway_refine``.
    """
    B = parts.shape[0]
    inside = (parts >= 0) & (parts < k)
    col = torch.where(inside, parts, k).long()
    cnt = torch.zeros((B, k + 1), dtype=torch.int32, device=parts.device)
    cnt.scatter_add_(1, col, torch.ones_like(parts))
    cnt_own = ((parts == own[:, None]) & (parts >= 0)).sum(
        dim=1, dtype=torch.int32)
    return (cnt[:, :k] - cnt_own[:, None]).to(torch.float32)
