"""gatedgcn [gnn] n_layers=16 d_hidden=70 aggregator=gated --
[arXiv:2003.00982; paper]. The numbers are those of
``src/repro/configs/gatedgcn.py``."""
from .gnn_common import make_gnn_arch

ARCH = make_gnn_arch("gatedgcn", arch="gatedgcn", n_layers=16, d_hidden=70,
                     aggregator="gated",
                     notes="edge-gated aggregation; d=70 (benchmark config)")
