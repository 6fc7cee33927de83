"""Two-tower retrieval model (YouTube-style, RecSys'19): the serving path.

The counterpart of ``src/repro/models/recsys.py``. Each tower averages
``n_fields`` multi-hot bags of ids (-1 pad) through the EmbeddingBag
kernel (``kernels/embedding_bag``: the hand-written CUDA kernel on the
card, its plain version on the CPU), concatenates the bags, runs the
tower MLP (1024-512-256 at the published width) and L2-normalises.
``score_batch`` scores user-item pairs; ``retrieve`` scores one query
against a candidate matrix and keeps the top k as ``jax.lax.top_k``
orders them. Serving runs under ``torch.inference_mode()``.

The embedding tables are the HYPE placement target: rows co-accessed
by one query form a hyperedge, and ``placement/partitioned_embedding``
shards the rows with HYPE. Training (``twotower_loss``) waits for an
``embedding_bag`` backward (ROADMAP.md, queue 1, item 15h).
"""
from __future__ import annotations

import dataclasses

import torch

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
