"""PyTorch/CUDA port of the HYPE partitioner (the JAX package is ``repro``).

The port mirrors ``src/repro``'s layout; it imports ``torch`` and
``numpy`` and nothing of JAX or of ``repro``.
``core.partition_api.partition`` is the entry point; it runs on the card
unless the caller passes ``device="cpu"``.
"""
