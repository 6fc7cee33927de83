"""graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 -- [arXiv:1706.02216; paper]. The numbers are those
of ``src/repro/configs/graphsage_reddit.py``.

(The assigned minibatch shape uses fanout 15-10; the arch's own paper
config samples 25-10 -- the sampler supports both, the assigned shape
wins.)"""
from .gnn_common import make_gnn_arch

ARCH = make_gnn_arch("graphsage-reddit", arch="graphsage", n_layers=2,
                     d_hidden=128, aggregator="mean",
                     notes="mean aggregator + l2-normalized layers")
