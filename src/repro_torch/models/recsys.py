"""Two-tower retrieval model (YouTube-style, RecSys'19).

The counterpart of ``src/repro/models/recsys.py``. Each tower averages
``n_fields`` multi-hot bags of ids (-1 pad) through the EmbeddingBag
kernel (``kernels/embedding_bag``: the hand-written CUDA kernel on the
card, its plain version on the CPU), concatenates the bags, runs the
tower MLP (1024-512-256 at the published width) and L2-normalises.
``score_batch`` scores user-item pairs; ``retrieve`` scores one query
against a candidate matrix and keeps the top k as ``jax.lax.top_k``
orders them. Serving runs under ``torch.inference_mode()``.

Training: ``twotower_loss`` is the in-batch sampled softmax with logQ
correction. The tables' gradients come from the EmbeddingBag's backward
(a deterministic kernel on the card); the loss's own backward is written
by hand (``_InBatchSoftmax``) so that the (B, B) float32 logits, 17.2 GB
at the published B = 65,536, are overwritten in place by their gradient
rather than copied three times by autograd.

The embedding tables are the HYPE placement target: rows co-accessed
by one query form a hyperedge, and ``placement/partitioned_embedding``
shards the rows with HYPE.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from ..kernels.embedding_bag.ops import embedding_bag as bag_kernel
from .common import embed_init, mlp_apply, mlp_init

PARAM_NAMES = ("user_table", "item_table", "user_tower", "item_tower")


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    embed_dim: int = 256
    tower_dims: tuple = (1024, 512, 256)
    n_fields: int = 4              # sparse feature fields per tower
    bag_size: int = 8              # multi-hot ids per field (padded, -1)
    user_vocab: int = 10_000_000
    item_vocab: int = 10_000_000
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32


def init_twotower_params(gen: torch.Generator, cfg: TwoTowerConfig,
                         device="cpu") -> dict:
    """Random params on ``device``, drawn from ``gen`` (a generator of
    that device) in the order of ``PARAM_NAMES``."""
    d_in = cfg.n_fields * cfg.embed_dim
    if d_in != cfg.tower_dims[0]:
        raise ValueError("field concat must match tower input: "
                         f"{cfg.n_fields} x {cfg.embed_dim} != "
                         f"{cfg.tower_dims[0]}")
    dims = (d_in,) + tuple(cfg.tower_dims[1:])
    return {
        "user_table": embed_init(gen, cfg.user_vocab, cfg.embed_dim,
                                 cfg.dtype, device),
        "item_table": embed_init(gen, cfg.item_vocab, cfg.embed_dim,
                                 cfg.dtype, device),
        "user_tower": mlp_init(gen, dims, cfg.dtype, device),
        "item_tower": mlp_init(gen, dims, cfg.dtype, device),
    }


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  cfg: TwoTowerConfig, combine: str = "mean"):
    """ids (..., bag) int32 with -1 padding -> (..., embed_dim)."""
    lead = ids.shape[:-1]
    flat = ids.reshape(-1, ids.shape[-1]).contiguous()
    out = bag_kernel(table, flat, combine=combine)
    return out.reshape(*lead, table.shape[1])


def tower(params_mlp: dict, table: torch.Tensor, ids: torch.Tensor,
          cfg: TwoTowerConfig) -> torch.Tensor:
    """ids (B, n_fields, bag) -> L2-normalised embeddings (B, out)."""
    bags = embedding_bag(table, ids, cfg)          # (B, n_fields, d)
    x = bags.reshape(ids.shape[0], cfg.n_fields * cfg.embed_dim)
    x = mlp_apply(params_mlp, x, len(cfg.tower_dims) - 1)
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-6)


class _InBatchSoftmax(torch.autograd.Function):
    """``mean_b(logsumexp_j(L[b]) - L[b, b])`` in float32, with ``L = u
    i^T / temperature - logq[None, :]``, as JAX's ``twotower_loss``
    computes it. The forward keeps L (B, B) float32 and its row
    logsumexp; the backward turns L in place into the softmax, subtracts
    1 on the diagonal and scales by ``grad / (B * temperature)``, then
    runs the two products. So at most two (B, B) tensors are alive at
    once (L and logsumexp's temporary in the forward, L and a product's
    operand in a bfloat16 backward), where autograd of the plain
    expression keeps about four. It computes the gradient autograd would,
    within float32 rounding; a second backward through one graph is not
    supported."""

    @staticmethod
    def forward(ctx, u, i, logq, temperature):
        logits = (u @ i.T).div_(temperature).float()
        logits.sub_(logq.float()[None, :])
        logz = torch.logsumexp(logits, dim=-1)
        loss = (logz - logits.diagonal()).mean()
        ctx.save_for_backward(u, i)
        ctx.logits, ctx.logz, ctx.temperature = logits, logz, temperature
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        u, i = ctx.saved_tensors
        d, ctx.logits = ctx.logits, None   # overwritten below
        B = d.shape[0]
        d.sub_(ctx.logz[:, None]).exp_()   # the softmax
        d.diagonal().sub_(1.0)             # minus the one-hot labels
        grad = grad.float()
        dlogq = None
        if ctx.needs_input_grad[2]:
            dlogq = d.sum(0).mul_(-grad / B)
        d = d.mul_(grad / (B * ctx.temperature)).to(u.dtype)
        du = d @ i if ctx.needs_input_grad[0] else None
        di = d.T @ u if ctx.needs_input_grad[1] else None
        return du, di, dlogq, None


def twotower_loss(params: dict, batch: dict,
                  cfg: TwoTowerConfig) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction: batch holds
    ``user_ids`` and ``item_ids`` (B, n_fields, bag) int32 and
    ``item_logq`` (B,) float32; row b's positive is item b."""
    u = tower(params["user_tower"], params["user_table"],
              batch["user_ids"], cfg)
    i = tower(params["item_tower"], params["item_table"],
              batch["item_ids"], cfg)
    return _InBatchSoftmax.apply(u, i, batch["item_logq"], cfg.temperature)


def score_batch(params: dict, batch: dict,
                cfg: TwoTowerConfig) -> torch.Tensor:
    """Online/bulk serving: dot(user emb, item emb) per row, (B,)."""
    u = tower(params["user_tower"], params["user_table"],
              batch["user_ids"], cfg)
    i = tower(params["item_tower"], params["item_table"],
              batch["item_ids"], cfg)
    return (u * i).sum(dim=-1)


def ordered_top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest of a 1-D ``scores`` as ``jax.lax.top_k`` orders
    them: value descending, ties by the lower index. ``torch.topk`` does
    not promise that tie order, so this is a stable descending sort.
    Returns ``(values, int32 indices)``."""
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"top_k needs 0 <= k <= {scores.shape[-1]}, got "
                         f"{k}")
    values, idx = torch.sort(scores, descending=True, stable=True)
    return values[:k], idx[:k].to(torch.int32)


def retrieve(params: dict, batch: dict, cfg: TwoTowerConfig,
             top_k: int = 100):
    """One query vs. a precomputed candidate matrix ``cand_embs``
    (n_cand, out_dim); returns the top-``top_k`` (values, indices)."""
    u = tower(params["user_tower"], params["user_table"],
              batch["user_ids"], cfg)                # (1, out)
    scores = (u @ batch["cand_embs"].T)[0]          # (n_cand,)
    return ordered_top_k(scores, top_k)
