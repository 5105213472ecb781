"""Core DSO library: the paper's primary contribution.

- ``losses`` / ``regularizers``: Table 1 losses + Fenchel conjugates.
- ``saddle``: the saddle-point reformulation f(w, alpha), P(w), D(alpha), gap.
- ``dso``: paper-exact serial DSO + block-cyclic grid simulator (thin
  wrappers over :mod:`repro_torch.engine`); ``dso_async``: the random
  schedule.
- ``schedule``: the sigma_r block-cyclic schedule and ring permutation.
- ``adagrad``: App. B step-size adaptation.

The DSO runners are re-exported lazily (PEP 562): ``repro_torch.engine``
imports the loss/saddle submodules at module load, so an eager
``core.dso`` import here would close the ``core -> engine -> core`` cycle.
"""

from repro_torch.core.losses import LOSSES, get_loss
from repro_torch.core.regularizers import REGULARIZERS, get_regularizer
from repro_torch.core.saddle import (Problem, dual_objective, duality_gap,
                                     make_problem, primal_objective,
                                     saddle_objective)

__all__ = [
    "LOSSES", "REGULARIZERS", "get_loss", "get_regularizer", "Problem",
    "make_problem", "primal_objective", "dual_objective", "saddle_objective",
    "duality_gap", "run_dso_serial", "run_dso_grid",
]

_LAZY = ("run_dso_serial", "run_dso_grid")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.core import dso
        return getattr(dso, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
