"""Checkpointing: flat-path ``.npz`` snapshots of the ``TrainState``
(the port of ``repro.training.checkpoint``).

A thin layer over the port's one checkpoint codec
(``runtime.snapshot.save_pytree`` / ``load_pytree``: leaves copied to the
host and keyed by tree path, atomic writes, bf16 leaves as the
reference's raw 2-byte records); this module keeps the training loop's
conventions: ``ckpt_<step:08d>.npz`` names and the ``(state, step)``
restore contract.  A restored leaf takes its template's type and device.

A tensor-parallel state (``dist.tensor_parallel``: each rank holds its
shards) is saved in the one-process layout: ``save(..., mesh=, specs=)``
gathers it, so the file's bytes are those of a one-process checkpoint of
the same state, and rank 0 writes it; ``restore(..., mesh=, specs=)``
loads the whole state on the host and keeps this rank's shards.  Every
rank makes both calls.
"""

from __future__ import annotations

import os
import re

import numpy as np

from repro_torch.dist import tensor_parallel as tpm
from repro_torch.runtime.snapshot import load_pytree, save_pytree


def save(directory: str, state, step: int, *, mesh=None,
         specs=None) -> str:
    """Write ``state`` at ``step``; with ``mesh`` and the fitted parameter
    ``specs`` (``state_shardings.params``), a tensor-parallel state,
    gathered first and written by rank 0."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if mesh is not None:
        import torch.distributed as dist
        state = tpm.gather_state(state, mesh, specs)
        if dist.get_rank() == 0:
            os.makedirs(directory, exist_ok=True)
            save_pytree(path, state, meta={"step": int(step)})
        dist.barrier()
        return path
    os.makedirs(directory, exist_ok=True)
    return save_pytree(path, state, meta={"step": int(step)})


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _to_like(tree, like):
    """``tree``'s leaves on the devices of ``like``'s (nested dicts and
    named tuples of the same structure)."""
    if isinstance(tree, dict):
        return {k: _to_like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to_like(a, b) for a, b in zip(tree, like)))
    return tree.to(like.device)


def restore(directory: str, state_like, step: int | None = None, *,
            mesh=None, specs=None):
    """Restore into the structure of ``state_like``. Returns (state, step).
    With ``mesh`` and ``specs`` (as ``save``'s), ``state_like`` is this
    rank's shards: the whole state is loaded on the host and cut to them."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if mesh is not None:
        import torch.distributed as dist
        whole, meta = load_pytree(
            path, tpm.whole_template(state_like, mesh, specs))
        state = _to_like(tpm.shard_state(whole, mesh, dist.get_rank()),
                         state_like)
    else:
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
