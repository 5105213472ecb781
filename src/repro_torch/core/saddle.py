"""The saddle-point reformulation of the regularized risk (paper Sec. 2).

    P(w)       = lam * sum_j phi_j(w_j) + (1/m) sum_i l_i(<w, x_i>)
    f(w,alpha) = lam * sum_j phi_j(w_j) - (1/m) sum_i alpha_i <w, x_i>
                 - (1/m) sum_i l*_i(-alpha_i)
    D(alpha)   = min_w f(w, alpha)      (closed form for separable phi)
    gap(w, alpha) = P(w) - D(alpha)  >= 0, -> 0 at the saddle point.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.regularizers import Regularizer, get_regularizer
from repro_torch.device import resolve_device


class Problem(NamedTuple):
    """A regularized-risk instance, stored block-dense on one device.

    ``X`` is the (m, d) float32 design matrix (zeros mark absent entries);
    ``row_nnz``/``col_nnz`` are the paper's |Omega_i| / |Omega-bar_j|
    counts, clamped >= 1.
    """

    X: torch.Tensor
    y: torch.Tensor
    lam: float
    row_nnz: torch.Tensor
    col_nnz: torch.Tensor
    nnz: float
    loss_name: str = "hinge"
    reg_name: str = "l2"

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def loss(self) -> Loss:
        return get_loss(self.loss_name)

    @property
    def reg(self) -> Regularizer:
        return get_regularizer(self.reg_name)


def make_problem(X, y, lam: float, loss: str = "hinge", reg: str = "l2", *,
                 device="cuda") -> Problem:
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    nz = (X != 0).to(torch.float32)
    return Problem(X=X, y=y, lam=float(lam),
                   row_nnz=torch.clamp(nz.sum(dim=1), min=1.0),
                   col_nnz=torch.clamp(nz.sum(dim=0), min=1.0),
                   nnz=float(nz.sum()), loss_name=loss, reg_name=reg)


def primal_objective(prob: Problem, w) -> torch.Tensor:
    """P(w) of Eq. (1)."""
    u = prob.X @ w
    risk = torch.mean(prob.loss.value(u, prob.y))
    return prob.lam * torch.sum(prob.reg.value(w)) + risk


def saddle_objective(prob: Problem, w, alpha) -> torch.Tensor:
    """f(w, alpha) of Sec. 2."""
    m = prob.m
    reg = prob.lam * torch.sum(prob.reg.value(w))
    coupling = -torch.dot(alpha, prob.X @ w) / m
    dual_payoff = torch.sum(prob.loss.neg_conjugate(alpha, prob.y)) / m
    return reg + coupling + dual_payoff


def dual_objective(prob: Problem, alpha) -> torch.Tensor:
    """D(alpha) = min_w f(w, alpha), closed form via the separable phi."""
    m = prob.m
    c = (prob.X.T @ alpha) / m
    wmin = torch.sum(prob.reg.conjugate_min(c, prob.lam))
    dual_payoff = torch.sum(prob.loss.neg_conjugate(alpha, prob.y)) / m
    return wmin + dual_payoff


def duality_gap(prob: Problem, w, alpha) -> torch.Tensor:
    """P(w) - D(alpha)."""
    return primal_objective(prob, w) - dual_objective(prob, alpha)


def project_w(prob: Problem, w) -> torch.Tensor:
    """App. B box projection on w (loss-dependent)."""
    box = prob.loss.w_box
    if box is None:
        return w
    b = box(prob.lam)
    return torch.clamp(w, -b, b)


def project_alpha(prob: Problem, alpha) -> torch.Tensor:
    return prob.loss.project_alpha(alpha, prob.y)
