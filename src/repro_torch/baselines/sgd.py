"""Primal stochastic (sub)gradient descent with AdaGrad — the paper's 'SGD'.

Update (paper Eq. 3-4): sample i, then
    g_i = lam * phi'(w) + l'_i(<w, x_i>) * x_i
    w  <- w - eta * g_i            (AdaGrad-scaled, per App. B)

Minibatched (batch=1 recovers the paper exactly).  On the card an epoch
is one launch of ``csrc/baselines.cu``'s SGD kernel (``ops.sgd_epoch``).
Each epoch's permutation is one ``torch.randperm`` of a ``torch.Generator``
seeded with ``seed`` (``_draw_perm``); the reference draws from
``jax.random``, so its orders differ, and the tests replay them.
"""

from __future__ import annotations

import torch

from repro_torch.baselines import problem_device
from repro_torch.core.saddle import Problem, primal_objective
from repro_torch.kernels import ops


def _draw_perm(key: torch.Generator, m: int) -> torch.Tensor:
    """The next epoch's visit order: a permutation of 0..m-1 (host)."""
    return torch.randperm(m, generator=key)


def _sgd_epoch(X, y, perm, w, acc, eta0, lam, *, loss_name, reg_name, m,
               batch):
    """One epoch over ``perm`` in steps of ``batch`` rows (the trailing
    ``m % batch`` dropped), in place on ``w`` and ``acc`` (d,), which it
    returns."""
    nsteps = m // batch
    rows = torch.as_tensor(perm)[:nsteps * batch].to(
        device=X.device, dtype=torch.int32).reshape(1, -1)
    ops.sgd_epoch(X, y, rows, w.view(1, -1), acc.view(1, -1), eta0, lam,
                  loss_name=loss_name, reg_name=reg_name, batch=batch)
    return w, acc


def run_sgd(prob: Problem, epochs: int = 10, eta0: float = 0.1,
            batch: int = 1, seed: int = 0, eval_every: int = 1, *,
            device="cuda"):
    """Returns (w, history)."""
    dev = problem_device(prob, device)
    w = torch.zeros(prob.d, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(w)
    key = torch.Generator().manual_seed(int(seed))
    history = []
    for t in range(1, epochs + 1):
        perm = _draw_perm(key, prob.m)
        _sgd_epoch(prob.X, prob.y, perm, w, acc, eta0, prob.lam,
                   loss_name=prob.loss_name, reg_name=prob.reg_name,
                   m=prob.m, batch=batch)
        if t % eval_every == 0 or t == epochs:
            history.append(dict(epoch=t,
                                primal=float(primal_objective(prob, w))))
    return w, history
