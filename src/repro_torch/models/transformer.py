"""Decoder-only transformer LM (GQA, RoPE, qk-norm, sliding window, MoE).

The counterpart of ``src/repro/models/transformer.py`` for the five LM
architectures (stablelm-3b, qwen3-8b, llama3-405b, mixtral-8x22b,
granite-moe-3b-a800m). Params keep the JAX
package's stacked layout: every layer leaf has a leading ``n_layers``
axis, so params converted from JAX (``convert.transformer_params_from_numpy``)
are a copy. Layers run in a Python loop over that axis, each taking its
leaves from one ``unbind`` a stacked leaf a pass (``layer_list``): the
backward of ``unbind`` stacks the layers' gradients once, where a select
``leaf[li]`` a layer would write a zero-filled copy of the whole stacked
leaf for each layer.

Prefill and training attention go through the flash-attention kernel
(``kernels/flash_attention``: the hand-written CUDA kernels on the card,
forward and backward, their plain versions on the CPU), which computes
the function of both of the JAX model's ``attention_impl`` paths. The
kernel keeps scores and probabilities in float32 where the JAX model's
einsum path rounds them to the compute dtype, so in bfloat16 the two
differ by rounding (ROADMAP.md, queue 3).
Decode attention stays plain torch, as the JAX package computes it
outside any kernel, and rounds where it rounds. MoE layers run
``models/moe.py``'s ``moe_ffn`` in place of the dense FFN, and each layer
returns its aux load-balancing loss.

Training: ``lm_loss`` is the JAX package's (float32 cross-entropy, the
padded vocabulary masked to -1e30, plus 0.01 aux); with ``cfg.remat``
each layer of ``forward`` runs under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint`` of the layer), so the backward recomputes the layer,
its attention kernel included. Serving runs under
``torch.inference_mode()``. ``serve_step`` writes the new token's K/V
into the cache's tensors in place, where JAX returns a new cache; it
ignores ``decode_paged``, as JAX's does. ``serve_step_paged`` reads the
cache only and returns the new token's K/V for the caller to append. The
cache position ``pos`` is a Python int.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention
from .common import (DEFAULT_DTYPE, apply_rope, dense_init, embed_init,
                     rms_norm, rotary_embedding, softmax_cross_entropy)
from .moe import MoEConfig, init_moe_layer, moe_ffn, moe_layer_shapes


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's fields that serving and training read, with
    ``remat`` defaulting to True as there. Its sharding and layout knobs
    (``scan_layers``, ``seq_shard``, ``constrain``, ``attention_impl``,
    ``attention_block`` and ``moe_shard_c``) are left out: the port has
    no such paths."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = DEFAULT_DTYPE
    decode_paged: bool = False
    pad_vocab: bool = False
    # round the MoE expert products to bf16 (JAX's preferred_element_type)
    moe_accum_bf16: bool = False
    moe_cf_override: Optional[float] = None
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        if self.pad_vocab:
            return ((self.vocab + 255) // 256) * 256
        return self.vocab

    @property
    def params_dense(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6*N*D)."""
        a = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        a += self.n_heads * self.d_head * self.d_model
        if self.moe is None:
            f = 3 * self.d_model * self.d_ff
        else:
            f = 3 * self.d_model * self.d_ff * self.moe.n_experts \
                + self.d_model * self.moe.n_experts
        per_layer = a + f + 2 * self.d_model
        return (self.n_layers * per_layer + 2 * self.vocab * self.d_model
                + self.d_model)

    @property
    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.params_dense
        a = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        a += self.n_heads * self.d_head * self.d_model
        f = 3 * self.d_model * self.d_ff * self.moe.top_k \
            + self.d_model * self.moe.n_experts
        per_layer = a + f + 2 * self.d_model
        return (self.n_layers * per_layer + 2 * self.vocab * self.d_model
                + self.d_model)


# ------------------------------------------------------------------ params

def layer_shapes(cfg: TransformerConfig) -> dict:
    """Name -> shape of one layer's leaves, in the JAX package's order."""
    d, dh = cfg.d_model, cfg.d_head
    shapes = {"ln1": (d,), "ln2": (d,),
              "wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
              "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        shapes.update(qnorm=(dh,), knorm=(dh,))
    if cfg.moe is None:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    else:
        shapes.update(moe_layer_shapes(d, cfg.d_ff, cfg.moe))
    return shapes


def leaf_dtype(cfg: TransformerConfig, name: str) -> torch.dtype:
    """A layer leaf's dtype: the MoE router is float32, as JAX draws it;
    every other leaf is ``cfg.dtype``."""
    return torch.float32 if name == "router" else cfg.dtype


def init_layer_params(gen: torch.Generator, cfg: TransformerConfig,
                      device="cpu") -> dict:
    """One layer's params: norms at 1, dense weights normal / sqrt(in);
    an MoE layer's router and experts from ``init_moe_layer``."""
    moe_names = () if cfg.moe is None else moe_layer_shapes(
        cfg.d_model, cfg.d_ff, cfg.moe)
    p = {name: (torch.ones(shape, dtype=cfg.dtype, device=device)
                if len(shape) == 1 else
                dense_init(gen, *shape, cfg.dtype, device))
         for name, shape in layer_shapes(cfg).items()
         if name not in moe_names}
    if cfg.moe is not None:
        p.update(init_moe_layer(gen, cfg.d_model, cfg.d_ff, cfg.moe,
                                cfg.dtype, device))
    return p


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device="cpu") -> dict:
    """Random params on ``device`` from ``gen`` (a generator of that
    device): embed, lm_head, then layer by layer into preallocated
    stacked tensors, so no float32 draw of a whole stacked leaf is made
    (a stacked ``w_gate`` of qwen3-8b would be a 7.2 GB transient)."""
    params = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype,
                            device),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_padded, cfg.dtype,
                              device),
        "ln_f": torch.ones(cfg.d_model, dtype=cfg.dtype, device=device),
    }
    layers = {name: torch.empty((cfg.n_layers,) + shape,
                                dtype=leaf_dtype(cfg, name), device=device)
              for name, shape in layer_shapes(cfg).items()}
    for li in range(cfg.n_layers):
        for name, leaf in init_layer_params(gen, cfg, device).items():
            layers[name][li].copy_(leaf)
    params["layers"] = layers
    return params


def layer_list(params: dict) -> list:
    """Every layer's params, views into the stacked leaves: one
    ``unbind`` per leaf."""
    per = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
    n = len(next(iter(per.values())))
    return [{name: views[li] for name, views in per.items()}
            for li in range(n)]


def _embed(params: dict, tokens: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    """The embedding rows of ``tokens``: ``F.embedding``, whose backward
    is PyTorch's embedding backward (the ids sorted, each row's gradients
    summed), where ``index_select``'s would add bf16 rows one by one into
    the table."""
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


# ----------------------------------------------------------------- attention

def _attention(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
               sin: torch.Tensor, cos: torch.Tensor):
    """Full (optionally windowed) prefill attention through the kernel.

    Returns (output, (k, v)) so prefill can collect the cache without
    recomputing projections. The causal and window mask is the kernel's
    ``causal`` and ``window`` arguments.
    """
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ lp["wq"]).reshape(B, S, Hq, Dh)
    k = (x @ lp["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ lp["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = flash_attention(q, k, v, causal=True, window=cfg.window)
    return out.reshape(B, S, Hq * Dh) @ lp["wo"], (k, v)


def _dense_ffn(cfg: TransformerConfig, lp: dict,
               x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h @ lp["w_down"]


def _ffn(cfg: TransformerConfig, lp: dict, x: torch.Tensor):
    """The layer's FFN and its aux loss (a float32 scalar, 0 for a dense
    layer)."""
    if cfg.moe is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _dense_ffn(cfg, lp, x), aux
    return moe_ffn(cfg, lp, x)


def _layer_fwd(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
               sin: torch.Tensor, cos: torch.Tensor):
    a, kv = _attention(cfg, lp, rms_norm(x, lp["ln1"]), sin, cos)
    x = x + a
    f, aux = _ffn(cfg, lp, rms_norm(x, lp["ln2"]))
    return x + f, aux, kv


def _layer_x(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
             sin: torch.Tensor, cos: torch.Tensor):
    """The layer's output and aux loss (what ``forward`` checkpoints)."""
    return _layer_fwd(cfg, lp, x, sin, cos)[:2]


def _rope_tables(S: int, cfg: TransformerConfig, device):
    positions = torch.arange(S, device=device)[None, :]
    return rotary_embedding(positions, cfg.d_head, cfg.rope_theta)


# ------------------------------------------------------------------ forward

def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) int -> final hidden states (B, S, d), the aux loss
    summed over the layers in order (0 for a dense model). With
    ``cfg.remat`` and autograd recording, each layer is checkpointed:
    only its input is kept, and the backward runs the layer again (the
    same ops, so the same bits)."""
    x = _embed(params, tokens, cfg)
    sin, cos = _rope_tables(tokens.shape[1], cfg, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(params):
        if remat:
            x, a = checkpoint(_layer_x, cfg, lp, x, sin, cos,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer_x(cfg, lp, x, sin, cos)
        aux = aux + a
    return rms_norm(x, params["ln_f"]), aux


def lm_loss(params: dict, batch: dict, cfg: TransformerConfig):
    """batch: {tokens (B, S), labels (B, S)} int; returns the scalar
    float32 loss: the mean token cross-entropy of the logits (their
    padded vocabulary columns set to -1e30 in the compute dtype), plus
    0.01 times the aux loss."""
    x, aux = forward(params, batch["tokens"], cfg)
    logits = x @ params["lm_head"]
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) \
            >= cfg.vocab
        neg = torch.tensor(-1e30, dtype=torch.float32,
                           device=logits.device).to(logits.dtype)
        logits = torch.where(pad, neg, logits)
    ce = softmax_cross_entropy(logits, batch["labels"])
    return ce + 0.01 * aux


# ------------------------------------------------------------------ serving

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cpu") -> dict:
    """KV cache. Sliding-window archs use a rolling buffer of size window."""
    Skv = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, Skv, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """Run the full prompt, return (cache, last-token logits).

    The cache holds each layer's K/V of the forward pass; for windowed
    attention only the last ``window`` positions are kept. It holds
    exactly that many slots, as in the JAX package: a caller that
    decodes on it without padding overwrites the oldest slots.
    """
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    sin, cos = _rope_tables(S, cfg, x.device)
    Skv = min(S, cfg.window) if cfg.window else S
    shape = (cfg.n_layers, B, Skv, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=cfg.dtype, device=x.device),
             "v": torch.empty(shape, dtype=cfg.dtype, device=x.device),
             "pos": S}
    for li, lp in enumerate(layer_list(params)):
        x, _, (k, v) = _layer_fwd(cfg, lp, x, sin, cos)
        cache["k"][li].copy_(k[:, S - Skv:])
        cache["v"][li].copy_(v[:, S - Skv:])
    x = rms_norm(x, params["ln_f"])
    return cache, x[:, -1] @ params["lm_head"]


@functools.cache
def _root(d_head: int, dtype: torch.dtype) -> float:
    """sqrt(d_head) rounded to ``dtype``, as ``jnp.sqrt(Dh).astype(dtype)``."""
    return float(torch.tensor(math.sqrt(d_head)).to(dtype))


def _decode_attention(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: int, sin: torch.Tensor,
                      cos: torch.Tensor) -> torch.Tensor:
    """One-token attention against one layer's cache, x: (B, 1, d); sin
    and cos are the RoPE tables of position ``pos`` (made once per step,
    where JAX makes them per layer). The new K/V go into slot
    ``pos % Skv`` of ``cache_k``/``cache_v`` in place. Plain torch,
    rounding where the JAX package rounds: scores and probabilities in
    the compute dtype, the softmax in float32."""
    B = x.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = Hq // Hkv
    Skv = cache_k.shape[1]
    q = (x @ lp["wq"]).reshape(B, 1, Hq, Dh)
    k = (x @ lp["wk"]).reshape(B, 1, Hkv, Dh)
    v = (x @ lp["wv"]).reshape(B, 1, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    # rolling-buffer write position (no-op modulo for full caches)
    slot = pos % Skv
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    q = q.reshape(B, Hkv, G, Dh)
    scores = torch.einsum("bhgd,bthd->bhgt", q, cache_k) / _root(Dh, x.dtype)
    # valid positions: the rolling buffer is full once pos >= Skv
    if pos < Skv:
        t = torch.arange(Skv, device=x.device)
        scores = torch.where(t <= pos, scores.float(), -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", probs, cache_v)
    return out.reshape(B, 1, Hq * Dh) @ lp["wo"]


def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
               cfg: TransformerConfig):
    """One decode step: tokens (B, 1) + cache -> logits (B, V), cache.

    The cache's ``k`` and ``v`` tensors are updated in place; the
    returned dict holds the same tensors and ``pos + 1``. It reads no
    ``decode_paged``, as the JAX package's does not: the paged step is
    ``serve_step_paged``.
    """
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]
    sin, cos = _step_rope(pos, cfg, x.device)
    for li, lp in enumerate(layer_list(params)):
        x = x + _decode_attention(cfg, lp, rms_norm(x, lp["ln1"]),
                                  cache["k"][li], cache["v"][li], pos, sin,
                                  cos)
        x = x + _ffn(cfg, lp, rms_norm(x, lp["ln2"]))[0]
    x = rms_norm(x, params["ln_f"])
    logits = x[:, 0] @ params["lm_head"]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _step_rope(pos: int, cfg: TransformerConfig, device):
    """The RoPE tables of position ``pos``, made once a decode step."""
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=device)
    return rotary_embedding(positions, cfg.d_head, cfg.rope_theta)


@functools.cache
def _inv_root(d_head: int) -> float:
    """``1.0 / jnp.sqrt(Dh).astype(jnp.float32)``: float32 throughout."""
    root = torch.tensor(math.sqrt(d_head), dtype=torch.float32)
    return float(torch.tensor(1.0, dtype=torch.float32) / root)


def _decode_attention_paged(cfg: TransformerConfig, lp: dict,
                            x: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, pos: int,
                            sin: torch.Tensor, cos: torch.Tensor):
    """Read-only-cache decode attention, x: (B, 1, d): a float32 online
    softmax over two blocks, the cache and the current token, merged
    analytically, as the JAX package's ``_decode_attention_paged``.
    Cache slot t is valid where ``t < pos`` until the buffer is full
    (``pos >= Skv``), then every slot is: on a full rolling buffer the
    step attends to Skv + 1 keys, the oldest one included, as JAX's
    does. Returns ``(out @ wo, k, v)``, k and v (B, 1, Hkv, Dh)."""
    B = x.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = Hq // Hkv
    Skv = cache_k.shape[1]
    q = (x @ lp["wq"]).reshape(B, 1, Hq, Dh)
    k = (x @ lp["wk"]).reshape(B, 1, Hkv, Dh)
    v = (x @ lp["wv"]).reshape(B, 1, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    qh = q.reshape(B, Hkv, G, Dh).float()
    scale = _inv_root(Dh)
    s_c = torch.einsum("bhgd,bthd->bhgt", qh, cache_k.float()) * scale
    if pos < Skv:
        t = torch.arange(Skv, device=x.device)
        s_c = torch.where(t < pos, s_c, -1e30)
    m_c = torch.amax(s_c, dim=-1)                          # (B, Hkv, G)
    p_c = torch.exp(s_c - m_c[..., None])
    l_c = torch.sum(p_c, dim=-1)
    acc_c = torch.einsum("bhgt,bthd->bhgd", p_c, cache_v.float())
    # the current token's term
    s_t = torch.einsum("bhgd,bhd->bhg", qh, k[:, 0].float()) * scale
    m = torch.maximum(m_c, s_t)
    w_c = torch.exp(m_c - m)
    w_t = torch.exp(s_t - m)
    l = l_c * w_c + w_t
    acc = acc_c * w_c[..., None] + w_t[..., None] \
        * v[:, 0][:, :, None, :].float()
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, 1, Hq * Dh).to(x.dtype)
    return out @ lp["wo"], k, v


def serve_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                     cfg: TransformerConfig):
    """Decode without touching the cache: tokens (B, 1) + cache ->
    ``(logits (B, V), k_new, v_new, pos + 1)``, k_new and v_new (L, B, 1,
    Hkv, Dh), the new token's K/V of every layer for the caller to append
    at slot ``pos % Skv`` (as the JAX package's ``serve_step_paged``)."""
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]
    sin, cos = _step_rope(pos, cfg, x.device)
    ks, vs = [], []
    for li, lp in enumerate(layer_list(params)):
        a, k, v = _decode_attention_paged(cfg, lp, rms_norm(x, lp["ln1"]),
                                          cache["k"][li], cache["v"][li],
                                          pos, sin, cos)
        x = x + a
        x = x + _ffn(cfg, lp, rms_norm(x, lp["ln2"]))[0]
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["ln_f"])
    logits = x[:, 0] @ params["lm_head"]
    return logits, torch.stack(ks), torch.stack(vs), pos + 1
