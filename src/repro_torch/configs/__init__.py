"""Experiment configurations (the paper's DSO problems)."""
