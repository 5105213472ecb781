"""The Eq.-(8) update tail shared by the sparse block-step kernels' plain
versions (the torch counterpart of the reference's ``kernels/dso_update.py``
lines 116-162).  ``csrc/dso_sparse.cu`` writes the same arithmetic in CUDA,
in the same order of operations.

    g_w = lam * phi'(w) * n_j / |Omega-bar_j| - X^T alpha / m      (primal)
    g_a = -l*'(-alpha) * n_i / (m |Omega_i|)  - X w / m            (dual)

then AdaGrad-scale, step, and project (App. B).  Scalars arrive as Python
floats (float32 values); tensors are float32 on any device.
"""

from __future__ import annotations

import torch

_ADA_EPS = 1e-8


def _reg_grad(reg_name: str, w):
    if reg_name == "l2":
        return 2.0 * w
    if reg_name == "l1":
        return torch.sign(w)
    raise ValueError(reg_name)


def _dual_grad(loss_name: str, a, y):
    if loss_name == "hinge":
        return -y
    if loss_name == "logistic":
        b = torch.clamp(y * a, 1e-6, 1.0 - 1e-6)
        return y * (torch.log(b) - torch.log1p(-b))
    if loss_name == "square":
        return a - y
    raise ValueError(loss_name)


def _project_alpha(loss_name: str, a, y):
    if loss_name == "hinge":
        return y * torch.clamp(y * a, 0.0, 1.0)
    if loss_name == "logistic":
        return y * torch.clamp(y * a, 1e-6, 1.0 - 1e-6)
    return a


def _primal_update(reg_name: str, w, gw, acc, tcn, cn, scal):
    """Eq. (8) primal side + AdaGrad + App. B box projection.
    ``scal`` = (eta, lam, m, w_lo, w_hi)."""
    eta, lam, m, w_lo, w_hi = scal
    g_w = lam * _reg_grad(reg_name, w) * tcn / cn - acc / m
    gw_new = gw + g_w * g_w
    dw = eta * g_w * torch.rsqrt(gw_new + _ADA_EPS)
    return torch.clamp(w - dw, w_lo, w_hi), gw_new


def _dual_update(loss_name: str, a, ga, y, acc, trn, rn, scal):
    """Eq. (8) dual side + AdaGrad + App. B domain projection."""
    eta, m = scal[0], scal[2]
    g_a = -_dual_grad(loss_name, a, y) * trn / (m * rn) - acc / m
    ga_new = ga + g_a * g_a
    da = eta * g_a * torch.rsqrt(ga_new + _ADA_EPS)
    return _project_alpha(loss_name, a + da, y), ga_new
