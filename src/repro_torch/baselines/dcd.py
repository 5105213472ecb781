"""Dual coordinate descent (LIBLINEAR [6]) — used by the paper (App. B) to
warm-start w and alpha on each machine before the parallel DSO run.

For hinge loss with phi(w)=w^2 (primal lam ||w||^2 + (1/m) sum max(0,1-y u)):
the dual is  max_{0<=beta_i<=1}  sum beta_i - (1/(4 lam m^2))||sum beta_i y_i x_i||^2
with w = (1/(2 lam m)) sum beta_i y_i x_i.  Coordinate update:

    beta_i <- clip(beta_i + (1 - y_i <w, x_i>) * 2*lam*m / ||x_i||^2, 0, 1)

On the card an epoch is one launch of ``csrc/baselines.cu``'s DCD kernel
(``ops.dcd_epoch``).  Each epoch's permutation is one ``torch.randperm``
of a ``torch.Generator`` seeded with ``seed`` (``_draw_perm``); the tests
replay the reference's ``jax.random`` orders.
"""

from __future__ import annotations

import torch

from repro_torch.baselines import problem_device
from repro_torch.core.saddle import Problem, primal_objective
from repro_torch.kernels import ops

_NORM_ROWS = 1 << 13      # rows per chunk of the squared row norms


def _draw_perm(key: torch.Generator, m: int) -> torch.Tensor:
    """The next epoch's visit order: a permutation of 0..m-1 (host)."""
    return torch.randperm(m, generator=key)


def _row_norms2(X) -> torch.Tensor:
    """sum(X * X, axis=1), a chunk of rows at a time (no (m, d)
    temporary)."""
    return torch.cat([torch.sum(c * c, dim=1)
                      for c in X.split(_NORM_ROWS)])


def _dcd_epoch(X, y, perm, w, beta, lam, xnorm2, *, m):
    """One epoch over ``perm``, in place on ``w`` (d,) and ``beta``
    (m,), which it returns."""
    if m != X.shape[0]:
        raise ValueError(f"m={m} is not X's row count {X.shape[0]}")
    perm = torch.as_tensor(perm).to(device=X.device, dtype=torch.int32)
    ops.dcd_epoch(X, y, perm.contiguous(), w, beta, lam, xnorm2)
    return w, beta


def run_dcd(prob: Problem, epochs: int = 5, seed: int = 0,
            eval_every: int = 1, *, device="cuda"):
    """Hinge-loss dual coordinate descent. Returns (w, alpha, history).

    alpha is returned in the saddle-problem convention (alpha_i = y_i beta_i
    up to sign matching Table 1's domain [0, y_i])."""
    if prob.loss_name != "hinge":
        raise ValueError("DCD warm start implemented for hinge loss")
    dev = problem_device(prob, device)
    w = torch.zeros(prob.d, dtype=torch.float32, device=dev)
    beta = torch.zeros(prob.m, dtype=torch.float32, device=dev)
    xnorm2 = _row_norms2(prob.X)
    key = torch.Generator().manual_seed(int(seed))
    history = []
    for t in range(1, epochs + 1):
        perm = _draw_perm(key, prob.m)
        _dcd_epoch(prob.X, prob.y, perm, w, beta, prob.lam, xnorm2,
                   m=prob.m)
        if t % eval_every == 0 or t == epochs:
            history.append(dict(epoch=t,
                                primal=float(primal_objective(prob, w))))
    alpha = prob.y * beta  # Table 1 domain: y_i alpha_i in [0, 1]
    return w, alpha, history
