"""Model side of the port: the two-tower retrieval model (``recsys``),
the dense transformers (``transformer``), GraphSAGE (``gnn``) and the
building blocks they share (``common``)."""
