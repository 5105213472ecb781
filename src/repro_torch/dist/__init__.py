"""Sharding rules for the mesh (the port of ``repro.dist``)."""
