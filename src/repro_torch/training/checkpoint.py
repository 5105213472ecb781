"""Checkpointing: flat-path ``.npz`` snapshots of the ``TrainState``
(the port of ``repro.training.checkpoint``).

A thin layer over the port's one checkpoint codec
(``runtime.snapshot.save_pytree`` / ``load_pytree``: leaves copied to the
host and keyed by tree path, atomic writes, bf16 leaves as the
reference's raw 2-byte records); this module keeps the training loop's
conventions: ``ckpt_<step:08d>.npz`` names and the ``(state, step)``
restore contract.  A restored leaf takes its template's type and device.
"""

from __future__ import annotations

import os
import re

import numpy as np

from repro_torch.runtime.snapshot import load_pytree, save_pytree


def save(directory: str, state, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    return save_pytree(path, state, meta={"step": int(step)})


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore(directory: str, state_like, step: int | None = None):
    """Restore into the structure of ``state_like``. Returns (state, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    state, meta = load_pytree(path, state_like)
    if meta is None:
        # pre-codec file: the step travelled in a reserved array key (the
        # leaf paths are unchanged, so the state itself loaded fine)
        with np.load(path) as data:
            if "__step__" not in data:
                raise ValueError(f"{path} has neither checkpoint meta nor "
                                 f"a legacy __step__ key")
            return state, int(data["__step__"])
    return state, int(meta["step"])
