"""Launchers of the port: ``serve`` (the two-tower serving path)."""
