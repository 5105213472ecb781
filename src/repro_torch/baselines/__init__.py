"""The paper's Sec.-5 baselines (SGD, PSGD, DCD, BMRM), the counterparts
of ``src/repro/baselines/``: same signatures plus a keyword ``device``
(default the card; ``RuntimeError`` when there is none), which must be
where the ``Problem`` lives.  The SGD and DCD epochs are one kernel
launch each on the card (``kernels.ops.sgd_epoch``, ``dcd_epoch``);
BMRM's full-batch products are ``torch`` matrix products."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def problem_device(prob, device) -> torch.device:
    """The resolved ``device``, which must be where ``prob`` lives."""
    dev = resolve_device(device)
    if prob.device != dev:
        raise ValueError(f"the Problem lives on {prob.device}, "
                         f"device={str(dev)!r} was asked for")
    return dev
