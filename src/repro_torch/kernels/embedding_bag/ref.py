"""Plain PyTorch version of the EmbeddingBag kernel.

The same function as ``csrc/embedding_bag.cu`` in tensor ops: the CPU
path of ``ops.embedding_bag`` and the yardstick the card's kernel is
compared with. It walks the bag slots in order j = 0..bag-1 and adds
each valid row into a float32 accumulator, exactly as the TPU kernel's
body (``_bag_kernel``) and the CUDA kernel do, so the three agree bit
for bit: a fixed order of float32 additions, one division for ``mean``,
one rounding to the table's dtype. ``vecs.sum(dim=1)`` would leave the
order to the library.
"""
from __future__ import annotations

import torch

COMBINES = ("mean", "sum")


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      combine: str = "mean") -> torch.Tensor:
    """Sum or mean of the valid rows of each bag.

    table (V, D) float; ids (B, bag) integer ids in [-1, V), -1 a pad
    slot. Returns (B, D) in ``table.dtype``: the float32 sum of the rows
    ``table[ids[b, j]]`` over the valid slots in slot order, for
    ``mean`` divided once by ``max(count, 1)``; an all-pad row is 0.
    """
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got "
                         f"{combine!r}")
    B, bag = ids.shape
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    cnt = torch.zeros((B, 1), dtype=torch.int32, device=table.device)
    for j in range(bag):
        valid = (ids[:, j] >= 0)[:, None]
        rows = table.index_select(0, ids[:, j].clamp_min(0).long())
        acc = torch.where(valid, acc + rows.float(), acc)
        cnt += valid
    if combine == "mean":
        acc = acc / cnt.clamp_min(1).float()
    return acc.to(table.dtype)
