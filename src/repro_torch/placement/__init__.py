"""Distributed-placement consumers of the partitioners.

``partitioned_embedding`` turns a HYPE row assignment into the routing
table of a sharded embedding table (the two-tower model's tables are
its target). The JAX package's ``partitioned_gnn`` waits for the GNN
slice (ROADMAP.md, queue 1, item 15b).
"""
