"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
-- [arXiv:2010.03409; unverified]. The numbers are those of
``src/repro/configs/meshgraphnet.py``."""
from .gnn_common import make_gnn_arch

ARCH = make_gnn_arch("meshgraphnet", arch="meshgraphnet", n_layers=15,
                     d_hidden=128, aggregator="sum", mlp_layers=2,
                     notes="encode-process-decode with edge+node MLPs")
