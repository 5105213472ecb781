"""The reference's parameters, optimizer state and decode caches as the
port's.

Both packages keep the same nested keys and stacked layer axes, so a
conversion is leaf for leaf: a nested dict of numpy arrays (the JAX
package's pytree after ``jax.tree.map(np.asarray, ...)``; bf16 arrays may
be ``ml_dtypes.bfloat16``) becomes the same nested dict of tensors on
``device``.  ``params_from_reference`` holds every leaf against
``model.param_specs(cfg)``: the same keys, shapes and types, or
``ValueError``; ``opt_state_from_reference`` holds the AdamW moments
against the same keys and shapes in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import param_specs


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # no numpy type in torch
        a = a.astype(np.float32)            # exact
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _torch_dtype_of(a) -> torch.dtype:
    name = np.asarray(a).dtype.name
    return torch.bfloat16 if name == "bfloat16" else \
        torch.from_numpy(np.zeros(0, dtype=name)).dtype


def _convert(tree, spec, device, path=""):
    if not isinstance(tree, dict) or set(tree) != set(spec):
        raise ValueError(f"{path or 'params'}: keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}"
                         f" differ from the port's {sorted(spec)}")
    out = {}
    for k, want in spec.items():
        where = f"{path}/{k}"
        if isinstance(want, dict):
            out[k] = _convert(tree[k], want, device, where)
            continue
        a = np.asarray(tree[k])
        if tuple(a.shape) != tuple(want.shape) or \
                _torch_dtype_of(a) != want.dtype:
            raise ValueError(f"{where}: {a.dtype}{list(a.shape)} where the "
                             f"port has {want.dtype}{list(want.shape)}")
        out[k] = _tensor(a, want.dtype, device)
    return out


def params_from_reference(tree, cfg: ModelConfig, *, device="cuda"):
    """The reference's parameter pytree (numpy leaves) as the port's
    parameters on ``device`` (default the card): the stacked ``layers``,
    the hybrid ``shared_attn``, the vlm ``cross_layers`` and the rest."""
    return _convert(tree, param_specs(cfg), resolve_device(device))


def decode_state_from_reference(tree, *, device="cuda"):
    """The reference's decode state (``init_decode_state`` or a state that
    ``decode_step`` returned, numpy leaves) as the port's, each leaf in its
    own type, on ``device`` (default the card)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, _torch_dtype_of(t), dev)
    return conv(tree)


def opt_state_from_reference(state, cfg: ModelConfig, *, device="cuda"):
    """The reference's ``OptState`` (mu, nu: float32 trees like the
    parameters; step: int32; numpy leaves) as the port's
    ``training.optimizer.OptState`` on ``device`` (default the card),
    keys and shapes held against ``model.param_specs(cfg)``."""
    from repro_torch.training.optimizer import OptState, tree_map
    dev = resolve_device(device)
    spec = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                          device="meta"), param_specs(cfg))
    step = np.asarray(state.step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: {step.dtype}{list(step.shape)} where the "
                         f"port has int32[]")
    return OptState(mu=_convert(state.mu, spec, dev, "mu"),
                    nu=_convert(state.nu, spec, dev, "nu"),
                    step=torch.tensor(int(step), dtype=torch.int32,
                                      device=dev))
