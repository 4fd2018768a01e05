"""Measurement and proof tools of the port: each runs on the card unless
``--device cpu`` is given (``loader_bench`` runs on the host alone)."""
