"""Synthetic datasets (numpy-seeded, identical to the reference's)."""
