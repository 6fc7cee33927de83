"""Plain PyTorch version of the EmbeddingBag kernel.

The same function as ``csrc/embedding_bag.cu`` in tensor ops: the CPU
path of ``ops.embedding_bag`` and the yardstick the card's kernel is
compared with. It walks the bag slots in order j = 0..bag-1 and adds
each valid row into a float32 accumulator, exactly as the TPU kernel's
body (``_bag_kernel``) and the CUDA kernel do, so the three agree bit
for bit: a fixed order of float32 additions, one division for ``mean``,
one rounding to the table's dtype. ``vecs.sum(dim=1)`` would leave the
order to the library. A float64 table (the CPU route only, for
``torch.autograd.gradcheck``) is summed in float64.

The table's gradient (``embedding_bag_bwd_ref``) has no TPU kernel: the
JAX model differentiates ``jnp.take``. It is the neighbour
aggregation's backward with the bags as rows and the table rows as ids
(``neighbor_agg.ref.neighbor_agg_bwd_ref``, whose chunk order the CUDA
kernel shares), the division by the bag's count left out for ``sum``.
"""
from __future__ import annotations

import torch

from ..neighbor_agg.ref import acc_dtype, neighbor_agg_bwd_ref

COMBINES = ("mean", "sum")


def check_combine(combine: str) -> None:
    """Raise unless ``combine`` is one of ``COMBINES``."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got "
                         f"{combine!r}")


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      combine: str = "mean") -> torch.Tensor:
    """Sum or mean of the valid rows of each bag.

    table (V, D) float; ids (B, bag) integer ids in [-1, V), -1 a pad
    slot. Returns (B, D) in ``table.dtype``: the float32 sum of the rows
    ``table[ids[b, j]]`` over the valid slots in slot order, for
    ``mean`` divided once by ``max(count, 1)``; an all-pad row is 0.
    """
    check_combine(combine)
    B, bag = ids.shape
    dt = acc_dtype(table.dtype)
    acc = torch.zeros((B, table.shape[1]), dtype=dt, device=table.device)
    cnt = torch.zeros((B, 1), dtype=torch.int32, device=table.device)
    for j in range(bag):
        valid = (ids[:, j] >= 0)[:, None]
        rows = table.index_select(0, ids[:, j].clamp_min(0).long())
        acc = torch.where(valid, acc + rows.to(dt), acc)
        cnt += valid
    if combine == "mean":
        acc = acc / cnt.clamp_min(1).to(dt)
    return acc.to(table.dtype)


def embedding_bag_bwd_ref(g: torch.Tensor, ids: torch.Tensor, V: int,
                          combine: str = "mean") -> torch.Tensor:
    """The table's gradient through ``embedding_bag_ref``: g (B, D)
    float32 (float64 for gradcheck), the output's gradient; ids (B, bag)
    with -1 pad. Returns (V, D) in ``g.dtype``: ``grad[r] = sum of g[b]
    / max(count_b, 1)`` over the valid slots (b, j) with ``ids[b, j] =
    r`` (no division for ``sum``), in the chunk order of
    ``neighbor_agg_bwd_ref``; 0 for a row no slot names."""
    check_combine(combine)
    return neighbor_agg_bwd_ref(g, ids, V, combine == "mean")
