"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` -> ``torch.device``, refusing what the port cannot run on.

    The default is the card.  When CUDA is requested and absent this
    raises ``RuntimeError`` instead of carrying on quietly on the CPU;
    only an explicit ``device="cpu"`` selects the plain PyTorch path.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path")
        # "cuda" -> "cuda:<current>", so it compares equal to tensor.device
        return dev if dev.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev
