"""Serving: the batched decode engine (the port of ``repro.serving``)."""
