"""Carry state from the JAX package to the port, as plain numpy.

The port imports nothing of ``repro``, so a caller holding the JAX
package's objects hands over their arrays or fields instead:
``hypergraph_from_arrays(hg.n, hg.m, hg.v2e_indptr, hg.v2e_indices,
hg.e2v_indptr, hg.e2v_indices)``, ``superstep_params_from_dict(dataclasses.asdict(
params))``, ``device_params_from_dict(dataclasses.asdict(params))``,
``device_carry_from_numpy(carry, device)`` (the device loop's carry, as
``engines.device._device_export`` builds it),
``batched_params_from_dict(dataclasses.asdict(params))`` and
``twotower_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
device)``, ``transformer_params_from_numpy(jax.tree.map(np.asarray,
params), cfg, device)`` and ``gnn_params_from_numpy(jax.tree.map(
np.asarray, params), cfg, device)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.hypergraph import Hypergraph
from .core import device_loop
from .engines.batched import BatchedParams
from .engines.device import DeviceParams
from .engines.superstep import SuperstepParams
from .models.gnn import GNNConfig, gnn_param_shapes
from .models.recsys import PARAM_NAMES, TwoTowerConfig
from .models.transformer import TransformerConfig, layer_shapes


def hypergraph_from_arrays(n, m, v2e_indptr, v2e_indices, e2v_indptr,
                           e2v_indices) -> Hypergraph:
    """The port's ``Hypergraph`` over copies of the given CSR arrays."""
    hg = Hypergraph(n=int(n), m=int(m),
                    v2e_indptr=np.array(v2e_indptr),
                    v2e_indices=np.array(v2e_indices),
                    e2v_indptr=np.array(e2v_indptr),
                    e2v_indices=np.array(e2v_indices))
    hg.validate()
    return hg


def _params_from_dict(cls, d: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(d) - known)
    if extra:
        raise ValueError(f"unknown {cls.__name__} fields: {extra}")
    return cls(**d)


def superstep_params_from_dict(d: dict) -> SuperstepParams:
    """The port's ``SuperstepParams`` from a dict of the JAX fields."""
    return _params_from_dict(SuperstepParams, d)


def device_params_from_dict(d: dict) -> DeviceParams:
    """The port's ``DeviceParams`` from a dict of the JAX fields."""
    return _params_from_dict(DeviceParams, d)


def device_carry_from_numpy(carry: dict, device="cpu") -> dict:
    """The JAX device loop's carry (a dict of numpy arrays and scalars) as
    the port's tensors on ``device``, with their scratch slots
    (``core.device_loop.carry_to_device``)."""
    return device_loop.carry_to_device(carry, device)


def batched_params_from_dict(d: dict) -> BatchedParams:
    """The port's ``BatchedParams`` from a dict of the JAX fields."""
    return _params_from_dict(BatchedParams, d)


def twotower_params_from_numpy(tree: dict, cfg: TwoTowerConfig,
                               device="cpu") -> dict:
    """The port's two-tower params from the JAX package's, as nested
    dicts of numpy arrays. Both keep a dense weight as (in, out), so the
    arrays are copied as they are, cast to ``cfg.dtype``; every name and
    shape is checked against ``cfg``."""
    if set(tree) != set(PARAM_NAMES):
        raise ValueError(f"two-tower params are {PARAM_NAMES}, got "
                         f"{sorted(tree)}")

    def leaf(a, shape, where):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(f"{where} has shape {a.shape}, want {shape}")
        return torch.tensor(a, dtype=cfg.dtype, device=device)

    out = {name: leaf(tree[name], (vocab, cfg.embed_dim), name)
           for name, vocab in (("user_table", cfg.user_vocab),
                               ("item_table", cfg.item_vocab))}
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.tower_dims[1:])
    shapes = {f"w{i}": (dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
    shapes.update({f"b{i}": (dims[i + 1],) for i in range(len(dims) - 1)})
    for name in ("user_tower", "item_tower"):
        if set(tree[name]) != set(shapes):
            raise ValueError(f"{name} holds {sorted(tree[name])}, want "
                             f"{sorted(shapes)}")
        out[name] = {k: leaf(tree[name][k], shp, f"{name}.{k}")
                     for k, shp in shapes.items()}
    return out


def transformer_params_from_numpy(tree: dict, cfg: TransformerConfig,
                                  device="cpu") -> dict:
    """The port's LM params from the JAX package's (``scan_layers``:
    stacked layers), as nested dicts of numpy arrays. Both keep a dense
    weight as (in, out) and every layer leaf with a leading ``n_layers``
    axis, so the arrays are copied as they are, cast to ``cfg.dtype``
    (bfloat16 arrays widen exactly to float32 on the way); every name and
    shape is checked against ``cfg``."""
    top = {"embed": (cfg.vocab_padded, cfg.d_model),
           "lm_head": (cfg.d_model, cfg.vocab_padded),
           "ln_f": (cfg.d_model,)}
    if set(tree) != set(top) | {"layers"}:
        raise ValueError(f"LM params are {sorted(top) + ['layers']}, got "
                         f"{sorted(tree)}")
    shapes = {name: (cfg.n_layers,) + shape
              for name, shape in layer_shapes(cfg).items()}
    if set(tree["layers"]) != set(shapes):
        raise ValueError(f"layers hold {sorted(tree['layers'])}, want "
                         f"{sorted(shapes)}")

    def leaf(a, shape, where):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(f"{where} has shape {a.shape}, want {shape}")
        if a.dtype != np.float32:
            a = a.astype(np.float32)
        return torch.tensor(a, device=device).to(cfg.dtype)

    out = {name: leaf(tree[name], shape, name) for name, shape in top.items()}
    out["layers"] = {name: leaf(tree["layers"][name], shape,
                                f"layers.{name}")
                     for name, shape in shapes.items()}
    return out


def _float_tensor(a, dtype, device, where) -> torch.Tensor:
    """A float32 or bfloat16 numpy array (``ml_dtypes`` for bfloat16) as a
    tensor of ``dtype`` (None: its own), exactly."""
    if str(a.dtype) == "bfloat16":
        t = torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.float32:
        t = torch.tensor(a)
    else:
        raise ValueError(f"{where} is {a.dtype}; want float32 or bfloat16")
    return t.to(device=device, dtype=dtype or t.dtype)


def gnn_params_from_numpy(tree: dict, cfg: GNNConfig, device="cpu",
                          dtype=None) -> dict:
    """The port's GNN params from the JAX package's, as nested dicts (and
    the ``layers`` list) of numpy arrays. Both keep a dense weight as
    (in, out), so the arrays are copied as they are: bfloat16 (the JAX
    package's ``mlp_init``) stays bfloat16 bit for bit, float32 stays
    float32, unless ``dtype`` casts every leaf. Every name and shape is
    checked against ``cfg``; any other element type raises."""
    shapes = gnn_param_shapes(cfg)

    def walk(node, want, where):
        if isinstance(want, tuple):
            a = np.asarray(node)
            if a.shape != want:
                raise ValueError(f"{where} has shape {a.shape}, want {want}")
            return _float_tensor(a, dtype, device, where)
        if isinstance(want, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(want):
                raise ValueError(f"{where} must be a list of {len(want)}")
            return [walk(n, w, f"{where}[{i}]")
                    for i, (n, w) in enumerate(zip(node, want))]
        if not isinstance(node, dict) or set(node) != set(want):
            raise ValueError(f"{where or 'params'} holds "
                             f"{sorted(node) if isinstance(node, dict) else node!r}"
                             f", want {sorted(want)}")
        return {k: walk(node[k], w, f"{where}.{k}" if where else k)
                for k, w in want.items()}

    return walk(tree, shapes, "")
