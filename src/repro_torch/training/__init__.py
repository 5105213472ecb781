"""Training: AdamW, the LM train step and loop, checkpoints (the port of
``repro.training``)."""
