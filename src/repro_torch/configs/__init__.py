"""Architecture registry: ``get_arch(arch_id)`` -> ArchDef.

It knows every architecture of the JAX package's registry
(``src/repro/configs/__init__.py``). ``PORTED`` maps the ones the port
serves to their module; ``get_arch`` on any other raises
``NotImplementedError`` naming its ROADMAP.md item. ``FAMILIES`` gives
every architecture's family without loading it. two-tower-retrieval is
ported (serving and training). Of the LMs, the dense ones are ported
(serving and training); the MoE ones (mixtral-8x22b,
granite-moe-3b-a800m) wait for MoE serving. Of the GNNs,
graphsage-reddit is ported (training); gatedgcn, meshgraphnet and schnet
wait for their layers. ``get_arch("hype_paper")`` returns the paper's
run grid (``hype_paper.ARCH``), not an ArchDef, as in the JAX package.
"""
from __future__ import annotations

import importlib

FAMILIES = {
    "stablelm-3b": "lm",
    "qwen3-8b": "lm",
    "llama3-405b": "lm",
    "mixtral-8x22b": "lm",
    "granite-moe-3b-a800m": "lm",
    "gatedgcn": "gnn",
    "meshgraphnet": "gnn",
    "schnet": "gnn",
    "graphsage-reddit": "gnn",
    "two-tower-retrieval": "recsys",
    "hype_paper": "partitioning",
}

PORTED = {"two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
          "stablelm-3b": "repro_torch.configs.stablelm_3b",
          "qwen3-8b": "repro_torch.configs.qwen3_8b",
          "llama3-405b": "repro_torch.configs.llama3_405b",
          "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
          "hype_paper": "repro_torch.configs.hype_paper"}

_ITEM = "ROADMAP.md, queue 1, item 15"
PENDING_MOE = f"{_ITEM}e: MoE LM serving (moe_ffn, models/moe.py)"
PENDING_PAGED = f"{_ITEM}f: paged decode (decode_paged, serve_step_paged)"
PENDING_GNN_ARCHS = (f"{_ITEM}g: the gatedgcn, meshgraphnet and schnet "
                     f"layers")
PENDING_FULL_BATCH = (f"{_ITEM}j: full-batch GraphSAGE past 2**31 "
                      f"neighbour slots")
PENDING_ITEMS = {
    "lm": PENDING_MOE,
    "gnn": PENDING_GNN_ARCHS,
}

ARCH_IDS = [a for a in FAMILIES if a != "hype_paper"]


def get_arch(arch_id: str):
    if arch_id not in FAMILIES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from "
                       f"{list(FAMILIES)}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to torch yet; see "
            f"{PENDING_ITEMS[FAMILIES[arch_id]]}")
    return importlib.import_module(PORTED[arch_id]).ARCH
