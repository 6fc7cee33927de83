"""schnet [gnn] n_interactions=3 d_hidden=64 rbf=300 cutoff=10 --
[arXiv:1706.08566; paper]. The numbers are those of
``src/repro/configs/schnet.py``."""
from .gnn_common import make_gnn_arch

ARCH = make_gnn_arch("schnet", arch="schnet", n_layers=3, d_hidden=64,
                     rbf=300, cutoff=10.0,
                     notes="continuous-filter convolutions over RBF(dist)")
