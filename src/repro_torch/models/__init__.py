"""Decoder models of the port (``moe`` and ``dense`` families)."""
