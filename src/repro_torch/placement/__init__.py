"""Distributed-placement consumers of the partitioners.

``partitioned_embedding`` turns a HYPE row assignment into the routing
table of a sharded embedding table (the two-tower model's tables are
its target); ``partitioned_gnn`` measures the halo rows a vertex
assignment costs a sharded GNN's aggregation.
"""
