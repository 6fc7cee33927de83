"""Int8 gradient compression with error feedback, as
``src/repro/train/grad_compression.py``.

Each leaf of ``grads + err`` is quantized to int8 with one float32
scale (its largest magnitude over 127, at least 1e-12 / 127), then
dequantized; the quantization residual is kept in float32 and added to
the next step's gradient (error feedback, Karimireddy et al. 2019), so
the quantized sum stays unbiased. The same float32 operations in the
same order as JAX's, and ``torch.round`` rounds half to even as
``jnp.round`` does, so a leaf compresses to the same bits. On one card
there is no all-reduce to shrink: the step applies the quantize ->
dequantize pair where a data-parallel run would reduce the int8 tensor.
"""
from __future__ import annotations

import torch

from .tree import tree_map


def init_error_feedback(params):
    """A float32 zero residual shaped like each leaf, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize ``g + err`` to int8; returns ``(dequantized in g's dtype,
    the new float32 residual)``."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), g32 - deq


def compress_tree(grads, err_tree):
    """``compress_decompress`` over every leaf; returns ``(dequantized
    grads, new residuals)``, each shaped like ``grads``."""
    out = tree_map(compress_decompress, grads, err_tree)
    is_t = lambda t: isinstance(t, tuple)  # noqa: E731
    return (tree_map(lambda t: t[0], out, is_leaf=is_t),
            tree_map(lambda t: t[1], out, is_leaf=is_t))
