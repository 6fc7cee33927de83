"""Architecture registry: ``get_arch(arch_id)`` -> ArchDef.

It knows every architecture of the JAX package's registry
(``src/repro/configs/__init__.py``). ``PORTED`` maps the ones the port
serves to their module; ``get_arch`` on any other raises
``NotImplementedError`` naming its ROADMAP.md item. ``FAMILIES`` gives
every architecture's family without loading it. two-tower-retrieval is
ported (serving and training), and so are the five LMs (serving, paged
decode and training): the dense stablelm-3b, qwen3-8b and llama3-405b
and the MoE mixtral-8x22b and granite-moe-3b-a800m, and the four GNNs
(training): gatedgcn, meshgraphnet, schnet and graphsage-reddit. So all
ten architectures are ported and ``PENDING_ITEMS`` is empty.
``get_arch("hype_paper")`` returns the paper's run grid
(``hype_paper.ARCH``), not an ArchDef, as in the JAX package.
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
          "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
          "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
          "gatedgcn": "repro_torch.configs.gatedgcn",
          "meshgraphnet": "repro_torch.configs.meshgraphnet",
          "schnet": "repro_torch.configs.schnet",
          "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
          "hype_paper": "repro_torch.configs.hype_paper"}

# family -> the ROADMAP.md item an unported arch of it raises with
PENDING_ITEMS: dict = {}

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
