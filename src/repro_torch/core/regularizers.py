"""Separable regularizers ``phi_j(w_j)`` (paper Eq. 1).

The paper's SVM / logistic experiments use ``phi(w) = w^2`` (lambda
absorbs constants), and LASSO uses ``phi(w) = |w|``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Regularizer:
    name: str
    value: Callable          # elementwise phi(w)
    grad: Callable           # elementwise (sub)gradient
    # min_w  lam * phi(w) - c * w, elementwise in c (dual objective)
    conjugate_min: Callable


def _l2_conj_min(c, lam):
    return -(c * c) / (4.0 * lam)


def _l1_conj_min(c, lam):
    return torch.where(torch.abs(c) <= lam, torch.zeros_like(c),
                       torch.full_like(c, -float("inf")))


L2 = Regularizer("l2", lambda w: w * w, lambda w: 2.0 * w, _l2_conj_min)
L1 = Regularizer("l1", torch.abs, torch.sign, _l1_conj_min)

REGULARIZERS: dict[str, Regularizer] = {"l2": L2, "l1": L1}


def get_regularizer(name: str) -> Regularizer:
    try:
        return REGULARIZERS[name]
    except KeyError:
        raise ValueError(f"unknown regularizer {name!r}; have "
                         f"{sorted(REGULARIZERS)}") from None
