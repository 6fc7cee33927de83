"""Launchers of the port: ``serve`` (two-tower and LM serving) and
``train`` (GNN and dense-LM training)."""
