"""AdaGrad step sizes (Duchi et al.), as used by the paper (App. B).

Diagonal accumulator G += g^2; effective step = eta0 / sqrt(G + eps).
The primal accumulator travels with its w-shard through the DSO ring; the
dual accumulator stays resident with alpha.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

_EPS = 1e-8


def init(shape, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def step(g: torch.Tensor, acc: torch.Tensor,
         eta0: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (scaled update, new accumulator)."""
    acc = acc + g * g
    return eta0 * g * torch.rsqrt(acc + _EPS), acc
