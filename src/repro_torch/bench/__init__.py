"""Measurements of the port's kernels on the card, each a script of its own
(``python -m repro_torch.bench.<name>``)."""
