"""The paper's own workload: HYPE partitioning runs (not a neural arch).

A copy of ``src/repro/configs/hype_paper.py``: the benchmark
configurations of EXPERIMENTS.md, the datasets at the paper's Table II
scales and the algorithm parameter grid (k, s, r, caching) of Figures
3-10. ``get_arch("hype_paper")`` returns ``ARCH``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HypePaperConfig:
    datasets: tuple = ("github", "stackoverflow", "reddit")
    ks: tuple = (2, 4, 8, 16, 32, 64, 128)
    s: int = 10
    r: int = 2
    use_cache: bool = True
    methods: tuple = ("hype", "minmax_nb", "minmax_eb", "shp", "multilevel",
                      "random")


ARCH = HypePaperConfig()
