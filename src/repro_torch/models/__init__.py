"""Model side of the port: the two-tower retrieval model (``recsys``)
and the building blocks it needs (``common``)."""
