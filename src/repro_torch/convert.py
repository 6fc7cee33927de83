"""Carry state from the JAX package to the port, as plain numpy.

The port imports nothing of ``repro``, so a caller holding the JAX
package's objects hands over their arrays or fields instead:
``hypergraph_from_arrays(hg.n, hg.m, hg.v2e_indptr, hg.v2e_indices,
hg.e2v_indptr, hg.e2v_indices)``, ``superstep_params_from_dict(dataclasses.asdict(
params))`` and ``batched_params_from_dict(dataclasses.asdict(params))``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.hypergraph import Hypergraph
from .engines.batched import BatchedParams
from .engines.superstep import SuperstepParams


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


def batched_params_from_dict(d: dict) -> BatchedParams:
    """The port's ``BatchedParams`` from a dict of the JAX fields."""
    return _params_from_dict(BatchedParams, d)
