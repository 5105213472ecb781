"""PyTorch/CUDA port of the DSO solver (``repro``'s JAX package is the
reference).

Module paths mirror ``src/repro/`` one to one, so each counterpart is
found by name.  The package imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``.  Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise ``RuntimeError`` when no
card is present (``repro_torch.device.resolve_device``); pass
``device="cpu"`` for the plain PyTorch path.
"""
