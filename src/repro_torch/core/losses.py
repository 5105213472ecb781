"""Loss functions and their Fenchel-Legendre conjugates (paper Table 1).

Each loss ``l_i(u) = l(u, y_i)`` is convex in the margin ``u = <w, x_i>``.
The saddle objective uses the *negated conjugate at -alpha*::

    hinge     l(u) = max(1 - y*u, 0)          -l*(-a) = y*a          for y*a in [0, 1]
    logistic  l(u) = log(1 + exp(-y*u))       -l*(-a) = H(y*a)       for y*a in (0, 1)
    square    l(u) = (u - y)^2 / 2            -l*(-a) = y*a - a^2/2  for a in R

``dual_grad`` returns ``d/da [ l*(-a) ]``.  All functions are elementwise
on float32 tensors.  ``w_box`` returns the App.-B half-width as a Python
float rounded through float32, as the reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# App. B projects logistic alphas into (1e-14, 1 - 1e-14); 1 - 1e-14 is not
# representable in float32, so the float32-resolution analogue is used.
_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Loss:
    """A convex loss with its conjugate machinery (all elementwise)."""

    name: str
    value: Callable          # l(u, y)
    grad: Callable           # d/du l(u, y)
    neg_conjugate: Callable  # -l*(-alpha, y)
    dual_grad: Callable      # d/dalpha [ l*(-alpha, y) ]
    project_alpha: Callable  # projection onto the conjugate domain (App. B)
    w_box: Callable | None   # lam -> half-width of the w box; None = no box


def _hinge_value(u, y):
    return torch.clamp(1.0 - y * u, min=0.0)


def _hinge_grad(u, y):
    return torch.where(y * u < 1.0, -y, torch.zeros_like(y))


def _hinge_neg_conj(a, y):
    return y * a


def _hinge_dual_grad(a, y):
    return -y


def _hinge_project(a, y):
    return y * torch.clamp(y * a, 0.0, 1.0)


def _logistic_value(u, y):
    return F.softplus(-y * u)


def _logistic_grad(u, y):
    return -y * torch.sigmoid(-y * u)


def _logistic_neg_conj(a, y):
    b = torch.clamp(y * a, _EPS, 1.0 - _EPS)
    zero = torch.zeros_like(b)
    h = torch.where(b > 0, b * torch.log(b), zero)
    h = h + torch.where(b < 1, (1.0 - b) * torch.log1p(-b), zero)
    return -h


def _logistic_dual_grad(a, y):
    b = torch.clamp(y * a, _EPS, 1.0 - _EPS)
    return y * (torch.log(b) - torch.log1p(-b))


def _logistic_project(a, y):
    return y * torch.clamp(y * a, _EPS, 1.0 - _EPS)


def _square_value(u, y):
    return 0.5 * (u - y) ** 2


def _square_grad(u, y):
    return u - y


def _square_neg_conj(a, y):
    return y * a - 0.5 * a * a


def _square_dual_grad(a, y):
    return a - y


def _square_project(a, y):
    return a


HINGE = Loss("hinge", _hinge_value, _hinge_grad, _hinge_neg_conj,
             _hinge_dual_grad, _hinge_project,
             w_box=lambda lam: float(np.float32(1.0)
                                     / np.sqrt(np.float32(lam))))
LOGISTIC = Loss("logistic", _logistic_value, _logistic_grad,
                _logistic_neg_conj, _logistic_dual_grad, _logistic_project,
                w_box=lambda lam: float(np.sqrt(np.log(np.float32(2.0))
                                                / np.float32(lam))))
SQUARE = Loss("square", _square_value, _square_grad, _square_neg_conj,
              _square_dual_grad, _square_project, w_box=None)

LOSSES: dict[str, Loss] = {"hinge": HINGE, "logistic": LOGISTIC,
                           "square": SQUARE}


def get_loss(name: str) -> Loss:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; have {sorted(LOSSES)}") \
            from None


def w_bounds(loss_name: str, lam: float) -> tuple[float, float]:
    """(w_lo, w_hi) of the App.-B box; +-inf for the unboxed square loss."""
    box = get_loss(loss_name).w_box
    b = box(lam) if box is not None else float("inf")
    return -b, b
